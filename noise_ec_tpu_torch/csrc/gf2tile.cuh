// The GF(2) product core shared by K5 (csrc/fused.cu) and K7 (csrc/panel.cu):
// an (R x C) bit matrix times C input planes into R output planes, with the
// matrix as data (ops/gf2tile.py builds it), so one build serves every
// matrix.
//
// - Output planes in registers. A block covers `ncol` plane-word columns
//   and `rgr` output rows. Its warps form a WR x WC grid: warp (wr, wc)
//   owns the kRowBlock rows wr*kRowBlock.. of the block's row group and, in
//   each of its lanes, kCols columns 32 apart; it keeps kCols x kRowBlock
//   accumulators in registers for the whole K loop.
// - The matrix as warp-uniform operands. It is stored as int32 select
//   masks (-1 where bit (row, plane) is set, else 0), tiled (row group,
//   K tile, plane, row) so that one tile of one row group is contiguous.
//   Every lane of a warp reads the same four masks at once (a 16-byte
//   shared-memory broadcast), and one LOP3, acc ^= mask & plane, applies a
//   (row, plane) pair to a column: 1 + 1/(4 kCols) instructions a pair.
//   Packed bits need a bit test and a predicated XOR, two a pair, and ran
//   43-55% slower on K7 (PERF.md).
// - The input in a shared-memory ring of kStages K tiles filled with
//   cp.async: the copy of tile t+1 is in flight while tile t's product
//   runs, and the block's warps all read the one staged copy, so each input
//   word leaves device memory once per block, not once per row block.
//
// Requires every row pointer and the masks 16-byte aligned and `ncol` a
// multiple of 4 (checked by the wrappers); rows and columns past the
// block's edge are masked by their callers.
#pragma once

#include "common.cuh"

namespace noise_ec {
namespace tile {

constexpr int kRowBlock = 32;  // output planes a warp keeps per column
constexpr int kStages = 2;     // ring depth: one tile computing, one copying
constexpr int kMaxThreads = 512;
constexpr int kCols = 2;       // plane-word columns a lane, 32 apart

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until no copy group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Shape of one block's work, the same for every block of a launch.
struct Shape {
  int KT;    // planes a K tile
  int WR;    // warps along the rows: rgr = WR * kRowBlock
  int WC;    // warps along the columns: ncol = 32 * kCols * WC
  int ncol;
  int rgr;

  __host__ __device__ int tile_words() const { return KT * ncol; }
  __host__ __device__ int mask_words() const { return KT * rgr; }
  __host__ __device__ int stage_words() const { return KT * (ncol + rgr); }
};

// Copy one K tile's masks of one row group (KT * rgr contiguous words).
__device__ __forceinline__ void stage_masks(uint32_t* dst,
                                            const uint32_t* src, int words) {
  for (int e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x) {
    cp_async16(dst + e, src + e);
  }
}

// acc[i][r] ^= masks[c][row0 + r] & planes[c][col + 32 i] over the KT
// planes of one staged tile (planes [KT][ncol], masks [KT][rgr]).
__device__ __forceinline__ void product(uint32_t (&acc)[kCols][kRowBlock],
                                        const uint32_t* planes,
                                        const uint32_t* masks,
                                        const Shape& s, int col, int row0) {
  const uint32_t* p_col = planes + col;
  const uint4* m_row = reinterpret_cast<const uint4*>(masks + row0);
  const int m_stride = s.rgr / 4;
#pragma unroll 2
  for (int c = 0; c < s.KT; ++c) {
    uint32_t p[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) p[i] = p_col[c * s.ncol + 32 * i];
    const uint4* m = m_row + c * m_stride;
#pragma unroll
    for (int q = 0; q < kRowBlock / 4; ++q) {
      const uint4 v = m[q];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        acc[i][4 * q] ^= v.x & p[i];
        acc[i][4 * q + 1] ^= v.y & p[i];
        acc[i][4 * q + 2] ^= v.z & p[i];
        acc[i][4 * q + 3] ^= v.w & p[i];
      }
    }
  }
}

// The tiles [t0, t1) of a block's K range: an even split of [lo, hi) into
// `parts` blocks (the K split), part `part`.
__device__ __forceinline__ void k_range(int lo, int hi, int parts, int part,
                                        int* t0, int* t1) {
  const long long n = hi - lo;
  *t0 = lo + (int)(n * part / parts);
  *t1 = lo + (int)(n * (part + 1) / parts);
}

// How an output word is written: stored, XORed into what is there (the
// accumulating launch, one block per word), or XORed atomically (a K split:
// several blocks add to one word, the output zeroed or holding `acc`
// before the launch; XOR is associative, so the order does not matter).
enum Mode { kStore = 0, kXor = 1, kAtomicXor = 2 };

__device__ __forceinline__ void emit(uint32_t* dst, uint32_t v, int mode) {
  if (mode == kStore) {
    *dst = v;
  } else if (mode == kXor) {
    *dst ^= v;
  } else {
    atomicXor(dst, v);
  }
}

}  // namespace tile
}  // namespace noise_ec
