// Device helpers shared by the port's kernels: the 8x8 and 16x16 bit
// transposes that turn words into bit-planes (and back), and the opt-in to
// more than 48 KB of dynamic shared memory.
//
// Words travel as int32 on the Python side (torch cannot shift uint32 on
// the CPU); the kernels reinterpret the same bytes as uint32 so that every
// shift here is a logical one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace noise_ec {

// One delta-swap round over the pairs (i, i + d), i & d == 0, of N words.
// The pairs are disjoint, so updating in place equals the simultaneous
// update of the reference's _delta_swap (ops/pallas_pack.py).
template <int N>
__device__ __forceinline__ void swap_round(uint32_t* w, int d, uint32_t mask) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if ((i & d) == 0) {
      uint32_t t = ((w[i] >> d) ^ w[i + d]) & mask;
      w[i] ^= t << d;
      w[i + d] ^= t;
    }
  }
}

// 8x8 bit transpose across eight words: out[i] bit (8b + j) == in[j] bit
// (8b + i). An involution, so pack and unpack share it.
__device__ __forceinline__ void transpose8(uint32_t* w) {
  swap_round<8>(w, 1, 0x55555555u);
  swap_round<8>(w, 2, 0x33333333u);
  swap_round<8>(w, 4, 0x0F0F0F0Fu);
}

// 16x16 bit transpose across sixteen words, one per 16-bit half h:
// out[i] bit (16h + j) == in[j] bit (16h + i) (the reference's _ROUNDS16:
// transpose8's rounds and d = 8 with mask 0x00FF00FF, whose exchanged bits
// never cross a half). An involution.
__device__ __forceinline__ void transpose16(uint32_t* w) {
  swap_round<16>(w, 1, 0x55555555u);
  swap_round<16>(w, 2, 0x33333333u);
  swap_round<16>(w, 4, 0x0F0F0F0Fu);
  swap_round<16>(w, 8, 0x00FF00FFu);
}

// The bit transpose of a group of N = 8 or 16 words (m bit-planes a
// symbol): transpose8 or transpose16.
template <int N>
__device__ __forceinline__ void transpose_group(uint32_t* w) {
  static_assert(N == 8 || N == 16, "groups of 8 or 16 words");
  if constexpr (N == 8) {
    transpose8(w);
  } else {
    transpose16(w);
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory (the H100
// allows 227 KB a block); a no-op below that.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace noise_ec
