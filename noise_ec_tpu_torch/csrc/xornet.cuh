// The executor of the factored XOR network, shared by K1 (csrc/fused.cu)
// and K4 (csrc/gf2mm.cu): it runs an XorSchedule (ops/network.py), the
// level-scheduled, packed form of an XorProgram, over one tile of columns
// held in shared-memory slots.
//
// - A block holds TILE columns (8, 16, 32 or 64: groups of m words for K1,
//   plane words for K4) and every value of the network for them in slots
//   laid out [slot][column], so a block costs 4 n_slots TILE bytes however
//   many warps it has. All its warps work on the one tile.
// - Levels. No op reads a value written in its own level, so the warps of
//   the block share each level's ops and a barrier ends the level. A warp
//   step runs one op pair a lane: with TILE >= 32 the whole warp takes one
//   pair (lane = column, TILE / 32 columns 32 apart), with TILE < 32 it
//   takes 32 / TILE pairs of TILE lanes each. A lane reads its pair as one
//   16-byte shared-memory broadcast, then both ops' operands, then stores
//   both results; the next pair's words are read before this pair runs.
// - The packed program. Two ops a 16-byte row, 16-bit fields: x = dst | a
//   << 16, y = b | kind << 16. A block stages the program into shared
//   memory with one bulk copy completing on an mbarrier, issued before the
//   caller's stage-in; a program that does not fit beside the slots comes
//   in chunks of whole levels through a two-buffer ring, chunk c+1's copy
//   in flight while chunk c runs.
// - Loads (K4 only): a load op copies the tile's words of an input plane
//   into a slot with cp.async, 16 bytes a lane, one level before the first
//   level that reads it; the level's barrier waits for the copies. So the
//   schedule reads only slots, and device memory is never on an op's
//   critical path.
//
// Bound on the H100: shared memory. Each XOR is two 128-byte reads and one
// write a warp, at 128 bytes a clock an SM, against a byte bound set by the
// k + r rows moved; the level barriers and the program's broadcasts add
// about one wavefront an op pair.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace noise_ec {
namespace xornet {

constexpr uint32_t kXor = 0;
constexpr uint32_t kLoad = 1;  // kind 2 pads a level: nothing to do
constexpr int kMaxThreads = 1024;

// The packed program of an XorSchedule.
struct Net {
  const uint4* pairs;      // two ops a row
  const int* level_ptr;    // first row of each level, n_levels + 1
  const int* chunk_level;  // first level of each ring chunk, n_chunks + 1
  int n_chunks;
  int chunk_pairs;  // rows a ring buffer holds
  int n_slots;
};

// A block's shared memory: two mbarriers, the ring (one buffer a chunk, at
// most two), the slots.
struct Smem {
  uint64_t* bars;
  uint4* ring;
  uint32_t* slots;
};

inline size_t smem_bytes(const Net& net, int tile) {
  return 16 + 16 * (size_t)net.chunk_pairs * std::min(net.n_chunks, 2) +
         4 * (size_t)net.n_slots * tile;
}

__device__ __forceinline__ Smem carve(unsigned char* smem, const Net& net) {
  const size_t ring = 16 * (size_t)net.chunk_pairs * min(net.n_chunks, 2);
  return Smem{reinterpret_cast<uint64_t*>(smem),
              reinterpret_cast<uint4*>(smem + 16),
              reinterpret_cast<uint32_t*>(smem + 16 + ring)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes (four columns) from device memory into a slot, or zeros where
// `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t* smem,
                                           const uint32_t* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// Thread 0: copy ring chunk c into buffer c % 2, completing on bars[c % 2].
__device__ __forceinline__ void issue_chunk(const Net& net, const Smem& s,
                                            int c) {
  const int p0 = __ldg(net.level_ptr + __ldg(net.chunk_level + c));
  const int p1 = __ldg(net.level_ptr + __ldg(net.chunk_level + c + 1));
  const uint32_t bar = smem_u32(s.bars + (c & 1));
  const uint32_t bytes = 16u * (uint32_t)(p1 - p0);
  // The buffer's last chunk was read through the generic proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(s.ring + (c & 1) * net.chunk_pairs)),
      "l"(net.pairs + p0), "r"(bytes), "r"(bar)
      : "memory");
}

// Thread 0 sets up the ring's barriers and starts chunk 0's copy; the
// caller's next __syncthreads publishes the barriers to the block.
__device__ __forceinline__ void begin(const Net& net, const Smem& s) {
  if (threadIdx.x != 0 || net.n_chunks == 0) return;
  for (int i = 0; i < 2; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(s.bars + i))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  issue_chunk(net, s, 0);
}

// Where a lane works: TILE columns over kPerOp lanes an op pair, kPairs op
// pairs a warp step, kCols columns a lane (kPerOp apart).
template <int TILE>
struct Lanes {
  static_assert(TILE == 8 || TILE == 16 || TILE == 32 || TILE == 64,
                "tiles of 8, 16, 32 or 64 columns");
  static constexpr int kPerOp = TILE < 32 ? TILE : 32;
  static constexpr int kPairs = 32 / kPerOp;
  static constexpr int kCols = TILE / kPerOp;
};

// Where load ops read: the block's first column of plane 0, the plane
// stride, and the columns that exist (a multiple of 8: a ragged last tile
// reads zeros past them).
struct Loader {
  const uint32_t* src;
  long long P;
  int ncols;
};

// The operands of the op at words (x, y) on this lane's columns from `col`
// (zero unless it is an XOR).
template <int TILE>
__device__ __forceinline__ void operands(uint32_t x, uint32_t y,
                                         const uint32_t* slots, int col,
                                         uint32_t* v) {
  using L = Lanes<TILE>;
  const bool is_xor = (y >> 16) == kXor;  // a load's a is a plane, not a slot
  const uint32_t* a = slots + (is_xor ? x >> 16 : 0u) * TILE + col;
  const uint32_t* b = slots + (y & 0xFFFFu) * TILE + col;
#pragma unroll
  for (int j = 0; j < L::kCols; ++j) {
    v[j] = is_xor ? a[j * L::kPerOp] ^ b[j * L::kPerOp] : 0u;
  }
}

// Finish the op at words (x, y): store an XOR's result, or start a load's
// copy (16 bytes a lane, the tile's columns over its first TILE / 4 lanes
// of the op).
template <int TILE, bool kLoads>
__device__ __forceinline__ void finish(uint32_t x, uint32_t y,
                                       uint32_t* slots, int col,
                                       const uint32_t* v, const Loader& ld) {
  using L = Lanes<TILE>;
  const uint32_t kind = y >> 16;
  uint32_t* d = slots + (x & 0xFFFFu) * TILE;
  if (kind == kXor) {
#pragma unroll
    for (int j = 0; j < L::kCols; ++j) d[col + j * L::kPerOp] = v[j];
  } else if (kLoads && kind == kLoad) {
    const uint32_t* g = ld.src + (long long)(x >> 16) * ld.P;
    for (int c = 4 * col; c < TILE; c += 4 * L::kPerOp) {
      cp_async16(d + c, c < ld.ncols ? g + c : g, c < ld.ncols);
    }
  }
}

// Run every level of the schedule on the block's slots (begin() and a
// __syncthreads first). A lane reads both ops' operands of a pair before it
// stores either result (ops of a level write no slot the level reads), and
// reads its next pair's words before it runs this one. Ends with a
// barrier, so the slots hold the outputs.
template <int TILE, bool kLoads>
__device__ __forceinline__ void run(const Net& net, const Smem& s,
                                    const Loader& ld) {
  using L = Lanes<TILE>;
  const int lane = threadIdx.x % 32;
  const int first = (threadIdx.x / 32) * L::kPairs + lane / L::kPerOp;
  const int stride = (blockDim.x / 32) * L::kPairs;
  const int col = lane % L::kPerOp;
  for (int c = 0; c < net.n_chunks; ++c) {
    if (threadIdx.x == 0 && c + 1 < net.n_chunks) issue_chunk(net, s, c + 1);
    mbar_wait(smem_u32(s.bars + (c & 1)), (c >> 1) & 1);
    const int l0 = __ldg(net.chunk_level + c);
    const int l1 = __ldg(net.chunk_level + c + 1);
    const uint4* buf = s.ring + (c & 1) * net.chunk_pairs;
    const int base = __ldg(net.level_ptr + l0);
    for (int l = l0; l < l1; ++l) {
      const int end = __ldg(net.level_ptr + l + 1) - base;
      int p = __ldg(net.level_ptr + l) - base + first;
      uint4 op = p < end ? buf[p] : make_uint4(0, 0, 0, 0);
      for (; p < end; p += stride) {
        const uint4 next = p + stride < end ? buf[p + stride] : op;
        uint32_t v[2][L::kCols];
        operands<TILE>(op.x, op.y, s.slots, col, v[0]);
        operands<TILE>(op.z, op.w, s.slots, col, v[1]);
        finish<TILE, kLoads>(op.x, op.y, s.slots, col, v[0], ld);
        finish<TILE, kLoads>(op.z, op.w, s.slots, col, v[1], ld);
        op = next;
      }
      if (kLoads) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
  }
}

}  // namespace xornet

// Launch `launch<TILE>()` for a runtime tile of 8, 16, 32 or 64 columns.
template <typename F>
inline int with_tile(int tile, F&& launch) {
  switch (tile) {
    case 8:
      return launch(std::integral_constant<int, 8>{});
    case 16:
      return launch(std::integral_constant<int, 16>{});
    case 32:
      return launch(std::integral_constant<int, 32>{});
    case 64:
      return launch(std::integral_constant<int, 64>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace noise_ec
