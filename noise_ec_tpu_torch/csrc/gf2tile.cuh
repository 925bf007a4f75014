// The GF(2) product core shared by K5 (csrc/fused.cu), K7 (csrc/panel.cu)
// and K11/K12 (csrc/dense.cu): an (R x C) matrix of mask words times C
// input planes into R output planes, out[r] = XOR over c of mask[r][c] &
// plane[c], with the matrix as data, so one build serves every matrix.
//
// - Output planes in registers. A block covers `ncol` plane-word columns
//   and `rgr` output rows. Its warps form a WR x WC grid: warp (wr, wc)
//   owns the kRowBlock rows wr*kRowBlock.. of the block's row group and, in
//   each of its lanes, kCols columns 32 apart; it keeps kCols x kRowBlock
//   accumulators in registers for the whole K loop.
// - The matrix as warp-uniform operands. Every lane of a warp reads the
//   same four mask words of a staged tile at once (a 16-byte shared-memory
//   broadcast), and one LOP3, acc ^= mask & plane, applies a (row, plane)
//   pair to a column: 1 + 1/(4 kCols) instructions a pair. K5 and K7 take
//   the bit expansion as int32 select masks (-1 where bit (row, plane) is
//   set, else 0), tiled (row group, K tile, plane, row) on the host
//   (ops/gf2tile.py) so that one tile of one row group is one contiguous
//   16-byte copy. Packed bits need a bit test and a predicated XOR, two a
//   pair, and ran 43-55% slower on K7 (PERF.md).
// - K11/K12's masks are arbitrary words in a runtime (R, C) row-major
//   matrix, new on every call, so nothing is tiled on the host: the kernel
//   stages each tile itself (RowMajorMasks), element [c][r] of tile t of
//   row group g from masks[(g rgr + r) ldm + t KT + c], with 4-byte
//   zero-filling copies (0 past R or C). A warp copies a 4-row x 8-plane
//   patch (four 32-byte reads), and the staged rows are kMaskPad words
//   longer than rgr, so the patch's 32 words land in 32 banks.
// - The input in a shared-memory ring of K tiles filled with cp.async
//   (ring(), kStages = 2 deep for K5 and K7, 3 for K11/K12): the copies of
//   the next tiles' planes and masks are in flight while tile t's product
//   runs, and the block's warps all read the one staged copy, so each input
//   word leaves device memory once per block, not once per row block.
//   Planes are copied 16 bytes at a time, or 4 where a row's width or start
//   is not 16-byte aligned (masked_kernel's kVec = 1: any W, any offset);
//   columns past the edge are never stored.
// - Where the rows are few (RS(10,4)'s 32: one warp a 64-column tile), a
//   K11/K12 block also splits each tile's planes over WK warps, which XOR
//   their sums through shared memory at the end: more warps an SM to hide
//   the product's latency, with no zeroed output and no atomics.
#pragma once

#include "common.cuh"

namespace noise_ec {
namespace tile {

constexpr int kRowBlock = 32;  // output planes a warp keeps per column
constexpr int kStages = 2;     // K5's and K7's ring: one tile computing,
                               // one copying
constexpr int kMaxThreads = 512;
constexpr int kCols = 2;       // plane-word columns a lane, 32 apart
constexpr int kMaskPad = 4;    // words after each staged row-major mask row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One word; with `ok` false nothing is read and the word is zeroed.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shape of one block's work, the same for every block of a launch.
struct Shape {
  int KT;    // planes a K tile
  int WR;    // warps along the rows: rgr = WR * kRowBlock
  int WC;    // warps along the columns: ncol = 32 * kCols * WC
  int WK;    // warps along K, each on KT / WK planes of every tile
  int ncol;
  int rgr;
  int mld;   // words a staged mask row: rgr, or rgr + kMaskPad

  __host__ __device__ static Shape make(int KT, int WR, int WC, int WK,
                                        int pad) {
    return Shape{KT, WR, WC, WK, 32 * kCols * WC, kRowBlock * WR,
                 kRowBlock * WR + pad};
  }
  __host__ __device__ int tile_words() const { return KT * ncol; }
  __host__ __device__ int mask_words() const { return KT * rgr; }
  __host__ __device__ int stage_words() const { return KT * (ncol + mld); }
  // Words the warps along K > 0 park their sums in after the last tile.
  __host__ __device__ int reduce_words() const {
    return (WK - 1) * WR * WC * kCols * kRowBlock * 32;
  }
  // Dynamic shared memory of a block: a ring of `stages` tiles, reused for
  // the sums of the warps along K.
  __host__ __device__ size_t smem_bytes(int stages) const {
    const int ring = stages * stage_words();
    return (size_t)(ring > reduce_words() ? ring : reduce_words()) *
           sizeof(uint32_t);
  }
};

// Copy one K tile's masks of one row group (KT * rgr contiguous words).
__device__ __forceinline__ void stage_masks(uint32_t* dst,
                                            const uint32_t* src, int words) {
  for (int e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x) {
    cp_async16(dst + e, src + e);
  }
}

// acc[i][r] ^= masks[c][row0 + r] & planes[c][col + 32 i] over `kn`
// planes of a staged tile (planes [KT][ncol], masks [KT][mld]), from the
// plane that `planes` and `masks` point at.
__device__ __forceinline__ void product(uint32_t (&acc)[kCols][kRowBlock],
                                        const uint32_t* planes,
                                        const uint32_t* masks,
                                        const Shape& s, int col, int row0,
                                        int kn) {
  const uint32_t* p_col = planes + col;
  const uint4* m_row = reinterpret_cast<const uint4*>(masks + row0);
  const int m_stride = s.mld / 4;
#pragma unroll 2
  for (int c = 0; c < kn; ++c) {
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

// The ring of kS stages over the K tiles [t0, t1): `load(t, stage)`
// issues tile t's copies into a stage of s.stage_words() words (planes,
// then masks at s.tile_words()), kS - 1 tiles ahead of the product; once a
// tile has landed, `landed(stage)` runs on it (K5 transposes its words
// into planes there) and the core accumulates the product of its planes
// [k0, k0 + kn) into `acc`, which starts at 0.
template <int kS, class Load, class Landed>
__device__ __forceinline__ void ring(uint32_t (&acc)[kCols][kRowBlock],
                                     uint32_t* smem, const Shape& s, int t0,
                                     int t1, int col, int row0, Load load,
                                     Landed landed, int k0, int kn) {
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) acc[i][r] = 0;
  }
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (t0 + i < t1) load(t0 + i, smem + i * s.stage_words());
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) % kS;
    cp_async_wait<kS - 2>();
    __syncthreads();  // tile t landed; tile t-1's stage is free
    const int next = t + kS - 1;
    if (next < t1) load(next, smem + (next - t0) % kS * s.stage_words());
    cp_async_commit();
    uint32_t* st = smem + stage * s.stage_words();
    landed(st);
    product(acc, st + k0 * s.ncol, st + s.tile_words() + k0 * s.mld, s, col,
            row0, kn);
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

// One launch of masked_kernel: (batch, C, ldi) planes, columns [0, P) read,
// -> (batch, R, P) output rows over the K tiles [lo, hi).
struct Operands {
  const uint32_t* in;
  uint32_t* out;
  const uint32_t* masks;
  long long P;
  long long ldi;  // words from one input plane to the next
  long long ldm;  // words from one mask row to the next (RowMajorMasks)
  int C;
  int R;
  int NT;  // K tiles of the operand
  int lo;
  int hi;
  int ksplit;
  int mode;
};

// K7's masks: the tiled operand (MaskTiles), one contiguous copy a tile.
struct TiledMasks {
  static constexpr int kPad = 0;
  static constexpr int kRing = kStages;
  static constexpr bool kWarpsK = false;
  __device__ __forceinline__ void operator()(uint32_t* dst,
                                             const Operands& a,
                                             const Shape& s, int rg,
                                             int t) const {
    stage_masks(dst, a.masks + ((long long)rg * a.NT + t) * s.mask_words(),
                s.mask_words());
  }
};

// K11/K12's masks: (R, C) words, row stride ldm, staged transposed into
// [KT][mld]. Warp w copies the 4-row groups w, w + warps, .. of the row
// group; lane l the word of row 4 (group) + l / 8 and plane 8 j + l % 8 of
// each 8-plane step j (KT is a multiple of 8). A deeper ring than K7's,
// and warps along K where the rows are few (PERF.md).
struct RowMajorMasks {
  static constexpr int kPad = kMaskPad;
  static constexpr int kRing = 3;
  static constexpr bool kWarpsK = true;
  __device__ __forceinline__ void operator()(uint32_t* dst,
                                             const Operands& a,
                                             const Shape& s, int rg,
                                             int t) const {
    const int lane = threadIdx.x % 32;
    const int c_lo = lane % 8;
    const int c0 = t * s.KT + c_lo;
    for (int r4 = threadIdx.x / 32; r4 < s.rgr / 4; r4 += blockDim.x / 32) {
      const int r = 4 * r4 + lane / 8;
      const int row = rg * s.rgr + r;
      const uint32_t* src = a.masks + (long long)row * a.ldm + c0;
      for (int c8 = 0; c8 < s.KT; c8 += 8) {
        const bool ok = row < a.R && c0 + c8 < a.C;
        cp_async4(dst + (c8 + c_lo) * s.mld + r, ok ? src + c8 : a.masks, ok);
      }
    }
  }
};

// Plane copies of kVec words (4: 16-byte chunks; 1: single words).
template <int kVec>
__device__ __forceinline__ void copy_planes(uint32_t* dst,
                                            const uint32_t* src) {
  if constexpr (kVec == 4) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src, true);
  }
}

// Work masked_kernel leaves out for the timing probes of
// csrc/dense_probe.cu (kDrop, 0 in the kernels): the product, the plane
// copies, the mask copies.
constexpr int kDropProduct = 1, kDropPlanes = 2, kDropMasks = 4;

// The masked product of K7 and K11/K12: grid (column tiles, row groups,
// batch * ksplit), a block of 32 WR WC WK threads with
// s.smem_bytes(Masks::kRing) of dynamic shared memory. Warp (wr, wc, wk)
// takes planes [wk KT / WK, (wk + 1) KT / WK) of every tile; after the
// last tile the warps wk > 0 park their sums in shared memory and warp
// (wr, wc, 0) XORs them into its own and stores the result.
template <int kVec, class Masks, int kDrop = 0>
__global__ void __launch_bounds__(kMaxThreads)
    masked_kernel(Operands a, Shape s) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x % 32;
  const int nrc = s.WR * s.WC;
  const int wrc = Masks::kWarpsK ? threadIdx.x / 32 % nrc : threadIdx.x / 32;
  const int wk = Masks::kWarpsK ? threadIdx.x / 32 / nrc : 0;
  const int wr = wrc % s.WR;
  const int wc = wrc / s.WR;
  const long long col0 = (long long)blockIdx.x * s.ncol;
  const int rg = blockIdx.y;
  const long long b = blockIdx.z / a.ksplit;
  int t0, t1;
  k_range(a.lo, a.hi, a.ksplit, blockIdx.z % a.ksplit, &t0, &t1);
  const uint32_t* src = a.in + b * a.C * a.ldi;
  const int chunks = s.ncol / kVec;

  auto load = [&](int t, uint32_t* st) {
    // Planes past C have zero masks and columns past P are never stored,
    // so their stale words are never read into a result.
    for (int e = threadIdx.x; e < s.KT * chunks; e += blockDim.x) {
      const int c = e / chunks;
      const int x = kVec * (e - c * chunks);
      const long long plane = (long long)t * s.KT + c;
      if (!(kDrop & kDropPlanes) && plane < a.C && col0 + x < a.P) {
        copy_planes<kVec>(st + c * s.ncol + x, src + plane * a.ldi + col0 + x);
      }
    }
    if (!(kDrop & kDropMasks)) Masks()(st + s.tile_words(), a, s, rg, t);
  };

  uint32_t acc[kCols][kRowBlock];
  const int kn = Masks::kWarpsK ? s.KT / s.WK : s.KT;
  ring<Masks::kRing>(acc, smem, s, t0, t1, wc * 32 * kCols + lane,
                     wr * kRowBlock, load, [](uint32_t*) {}, wk * kn,
                     (kDrop & kDropProduct) ? 0 : kn);
  if (Masks::kWarpsK && s.WK > 1) {
    // Every copy has landed (the ring waited for the last tile), so the
    // stages are free once every warp is past its last product.
    // Warp (wrc, k > 0) parks its sums at words ((k - 1) nrc + wrc) x
    // kCols kRowBlock 32 on, lane-minor: each store fills 32 banks.
    constexpr int kPark = kCols * kRowBlock * 32;
    __syncthreads();
    if (wk > 0) {
      uint32_t* park = smem + ((wk - 1) * nrc + wrc) * kPark;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r)
          park[(i * kRowBlock + r) * 32 + lane] = acc[i][r];
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int k = 1; k < s.WK; ++k) {
      const uint32_t* sum = smem + ((k - 1) * nrc + wrc) * kPark;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r)
          acc[i][r] ^= sum[(i * kRowBlock + r) * 32 + lane];
      }
    }
  }
  const int row0 = rg * s.rgr + wr * kRowBlock;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const long long col = col0 + wc * 32 * kCols + lane + 32 * i;
    if (col >= a.P) continue;
    uint32_t* dst = a.out + (b * a.R + row0) * a.P + col;
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) {
      if (row0 + r < a.R) emit(dst + r * a.P, acc[i][r], a.mode);
    }
  }
}

// Launch masked_kernel<kVec, Masks, kDrop> over `batch` items and NRG row
// groups.
template <int kVec, class Masks, int kDrop = 0>
int launch_masked(const Operands& a, int KT, int NRG, int WR, int WC, int WK,
                  int batch, void* stream) {
  if (a.ksplit < 1 || WR < 1 || WC < 1 || WK < 1 || KT % WK ||
      32 * WR * WC * WK > kMaxThreads || (WK > 1 && !Masks::kWarpsK))
    return (int)cudaErrorInvalidValue;
  const Shape s = Shape::make(KT, WR, WC, WK, Masks::kPad);
  const size_t smem = s.smem_bytes(Masks::kRing);
  cudaError_t err =
      noise_ec::allow_smem(masked_kernel<kVec, Masks, kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = (a.P + s.ncol - 1) / s.ncol;
  if (cols > 0x7fffffffLL || (long long)batch * a.ksplit > 65535 ||
      NRG > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)cols, (unsigned)NRG,
                  (unsigned)(batch * a.ksplit));
  masked_kernel<kVec, Masks, kDrop>
      <<<grid, 32 * WR * WC * WK, smem, (cudaStream_t)stream>>>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace tile
}  // namespace noise_ec
