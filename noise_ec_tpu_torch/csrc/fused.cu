// K1: fused encode — lane pack, XOR network, unpack in one launch.
//
// Replaces noise_ec_tpu/ops/pallas_fused.py _fused_kernel (the main-path
// kernel of encode and reconstruct). (B, k, TW) words -> (B, r, TW) words
// for the GF(2^8) matrix whose factored bit network is the XorProgram
// operand (noise_ec_tpu_torch/ops/network.py).
//
// Bound on the H100: bytes at the roofline (k + r words moved per word
// position, 14 MiB for RS(10,4) at 1 MiB shards against 42 MiB for the
// pack -> matmul -> unpack pipeline), but in practice the interpreted XOR
// network (RS(10,4): 532 XORs, each two shared-memory reads and a write,
// per 8-word group) and the low occupancy that its shared-memory slots
// allow. Design: one thread per 8-word group. It packs the group of every
// input row into bit-planes in registers with the delta-swap transpose
// (the same indexing as the lane pack at tile TL, so loads and stores are
// coalesced and the planes match K2's), parks the planes in its
// shared-memory slots ([slot][thread], bank-conflict free), runs the
// program, and transposes each output row's eight planes back into words.
// The planner (ops/fused.py) sizes the block so that slots fit in 227 KB.
#include "common.cuh"

using noise_ec::transpose8;

namespace {

__global__ void fused_kernel(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out, int k, int r,
                             long long TW, int tl_shift,
                             const int* __restrict__ ops, int n_ops,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ row_terms,
                             const int* __restrict__ in_slot) {
  extern __shared__ uint32_t slots[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long g = (long long)blockIdx.x * T + tid;  // 8-word group
  if (g >= TW / 8) return;
  const long long b = blockIdx.y;
  const long long TL = 1LL << tl_shift;
  const long long l = g & (TL - 1);
  const long long sigma = (g >> tl_shift) & 7;
  const long long c = g >> (tl_shift + 3);
  const long long base = c * 64 * TL + sigma * 8 * TL + l;
  const uint32_t* src = in + b * k * TW + base;
  uint32_t* dst = out + b * r * TW + base;
  uint32_t w[8];
  for (int j = 0; j < k; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = src[j * TW + i * TL];
    transpose8(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = __ldg(in_slot + j * 8 + i);
      if (s >= 0) slots[s * T + tid] = w[i];
    }
  }
  // A program built for this kernel names no input plane directly, so the
  // device-memory operand is never read.
  noise_ec::run_ops(ops, n_ops, slots, T, tid, nullptr, 0);
  for (int j = 0; j < r; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = noise_ec::eval_row(row_ptr, row_terms, j * 8 + i, slots, T, tid,
                                nullptr, 0);
    }
    transpose8(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[j * TW + i * TL] = w[i];
  }
}

}  // namespace

extern "C" int ec_fused(const void* in, void* out, int batch, int k, int r,
                        long long TW, int tl_shift, const void* ops, int n_ops,
                        const void* row_ptr, const void* row_terms,
                        const void* in_slot, int n_slots, int threads,
                        void* stream) {
  const long long groups = TW / 8;
  if (batch == 0 || groups == 0) return cudaSuccess;
  const size_t smem = (size_t)n_slots * threads * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)batch);
  fused_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, k, r, TW, tl_shift,
      (const int*)ops, n_ops, (const int*)row_ptr, (const int*)row_terms,
      (const int*)in_slot);
  return (int)cudaGetLastError();
}

// K5: the K-sliced fused encode, for matrices whose whole network K1 cannot
// park in shared memory.
//
// Replaces noise_ec_tpu/ops/pallas_fused.py _dma_split_kernel (the "dma"
// plan of the reference's verified fused planner). (B, k, TW) words ->
// (B, r, TW) words for the network cut into P phases of ksl input rows
// (SplitProgram, noise_ec_tpu_torch/ops/network.py).
//
// Bound on the H100: bytes at the roofline (k + r words moved per word
// position, 70 MiB for RS(50,20) at 1 MiB shards), but in practice the
// interpreted network (RS(50,20): ~12,100 XORs a group with the
// accumulates) and the occupancy its slots allow. Design: K1's thread per
// 8-word group and K1's indexing, so loads and stores are coalesced and the
// planes are K2's. Shared memory holds [8r accumulator slots][one phase's
// slots] per thread, [slot][thread]. Per phase the thread packs only the
// rows of its slice below k (the reference zero-pads the input to P*ksl rows
// for its DMA alignment; nothing here needs it), runs the phase's ops and
// stores (phase 0) or XORs (later phases) each output plane into its
// accumulator. After the last phase it transposes each output row's eight
// accumulators back into words. Only the slice's planes and temporaries are
// live at once, which is what lets RS(50,20) run at 64 threads a block.
// Copy and compute overlap through occupancy; the reference's manual DMA
// double buffer has no counterpart yet.
namespace {

__global__ void fused_split_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out, int k, int r,
                                   long long TW, int tl_shift, int ksl, int P,
                                   const int* __restrict__ ops,
                                   const int* __restrict__ op_ptr,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ row_terms,
                                   const int* __restrict__ in_slot) {
  extern __shared__ uint32_t slots[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long g = (long long)blockIdx.x * T + tid;  // 8-word group
  if (g >= TW / 8) return;
  const long long b = blockIdx.y;
  const long long TL = 1LL << tl_shift;
  const long long l = g & (TL - 1);
  const long long sigma = (g >> tl_shift) & 7;
  const long long c = g >> (tl_shift + 3);
  const long long base = c * 64 * TL + sigma * 8 * TL + l;
  const uint32_t* src = in + b * k * TW + base;
  uint32_t* dst = out + b * r * TW + base;
  const int R8 = 8 * r;
  uint32_t w[8];
  for (int p = 0; p < P; ++p) {
    const int j0 = p * ksl;
    const int j1 = min(j0 + ksl, k);
    const int* slot_of = in_slot + p * 8 * ksl;
    for (int j = j0; j < j1; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = src[j * TW + i * TL];
      transpose8(w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = __ldg(slot_of + (j - j0) * 8 + i);
        if (s >= 0) slots[s * T + tid] = w[i];
      }
    }
    const int op0 = __ldg(op_ptr + p);
    noise_ec::run_ops(ops + 3 * op0, __ldg(op_ptr + p + 1) - op0, slots, T,
                      tid, nullptr, 0);
    // A phase's codes start at slot 8r, so its rows never read an
    // accumulator that this loop has already updated.
    for (int q = 0; q < R8; ++q) {
      const uint32_t v = noise_ec::eval_row(row_ptr, row_terms, p * R8 + q,
                                            slots, T, tid, nullptr, 0);
      slots[q * T + tid] = p == 0 ? v : slots[q * T + tid] ^ v;
    }
  }
  for (int j = 0; j < r; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = slots[(j * 8 + i) * T + tid];
    transpose8(w);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[j * TW + i * TL] = w[i];
  }
}

}  // namespace

extern "C" int ec_fused_split(const void* in, void* out, int batch, int k,
                              int r, long long TW, int tl_shift, int ksl,
                              int P, const void* ops, const void* op_ptr,
                              const void* row_ptr, const void* row_terms,
                              const void* in_slot, int n_slots, int threads,
                              void* stream) {
  const long long groups = TW / 8;
  if (batch == 0 || groups == 0) return cudaSuccess;
  const size_t smem = (size_t)n_slots * threads * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(fused_split_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)batch);
  fused_split_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, k, r, TW, tl_shift, ksl, P,
      (const int*)ops, (const int*)op_ptr, (const int*)row_ptr,
      (const int*)row_terms, (const int*)in_slot);
  return (int)cudaGetLastError();
}
