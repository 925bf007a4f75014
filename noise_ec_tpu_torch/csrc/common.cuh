// Device helpers shared by the port's kernels: the 8x8 and 16x16 bit
// transposes that turn words into bit-planes (and back), and the interpreter
// that runs an XorProgram (noise_ec_tpu_torch/ops/network.py) over values
// held in shared-memory slots.
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

// Operand of an XorProgram: a shared-memory slot (code >= 0, laid out
// [slot][thread] so a warp's 32 reads hit 32 banks) or input plane
// -1 - code read from device memory at plane stride P.
__device__ __forceinline__ uint32_t operand(int code, const uint32_t* slots,
                                            int T, int tid,
                                            const uint32_t* in, long long P) {
  return code >= 0 ? slots[code * T + tid]
                   : __ldg(in + (long long)(-1 - code) * P);
}

// slots[dst] = a ^ b for every op, in order. Every thread of a block reads
// the same op, so the program loads are warp-uniform broadcasts.
__device__ __forceinline__ void run_ops(const int* __restrict__ ops, int n_ops,
                                        uint32_t* slots, int T, int tid,
                                        const uint32_t* in, long long P) {
  for (int i = 0; i < n_ops; ++i) {
    const int t = __ldg(ops + 3 * i);
    const int a = __ldg(ops + 3 * i + 1);
    const int b = __ldg(ops + 3 * i + 2);
    const uint32_t va = operand(a, slots, T, tid, in, P);
    const uint32_t vb = operand(b, slots, T, tid, in, P);
    slots[t * T + tid] = va ^ vb;
  }
}

// XOR of output row r's terms (0 for an empty row).
__device__ __forceinline__ uint32_t eval_row(const int* __restrict__ row_ptr,
                                             const int* __restrict__ row_terms,
                                             int r, const uint32_t* slots,
                                             int T, int tid,
                                             const uint32_t* in, long long P) {
  uint32_t acc = 0;
  const int end = __ldg(row_ptr + r + 1);
  for (int e = __ldg(row_ptr + r); e < end; ++e) {
    acc ^= operand(__ldg(row_terms + e), slots, T, tid, in, P);
  }
  return acc;
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
