// K4: sparse GF(2) matmul — a Paar-factored XOR network over tiled planes.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _make_sparse_kernel, which bakes
// one matrix's network into each compiled program. Here the network is an
// operand (an XorProgram, noise_ec_tpu_torch/ops/network.py), so one build
// serves every geometry. (B, C, 8, W8) planes -> (B, R, 8, W8) planes; the
// function is positionwise, so one thread owns one plane-word position p.
//
// Bound on the H100: bytes (C + R planes moved once; RS(10,4)'s 532 XORs
// per 112 words moved stay under the logic-op roofline), though in practice
// the interpreted network's dependent loads hold it back (PERF.md). Design:
// inputs stay in device memory and are read where the program names them
// (neighbouring threads read neighbouring words, and repeated reads of a
// plane hit L1/L2); only the temporaries take shared-memory slots,
// [slot][thread], so a temp cap bounds shared memory for any input width and
// this kernel serves every matrix the fused kernel cannot hold.
//
// K11/K12: the dense-mask GF(2) product with the mask matrix as an operand,
// out[r, w] = XOR over c of (masks[r, c] & planes[c, w]), (R, C) masks x
// (C, W) planes -> (R, W), all 32-bit words. Replaces
// noise_ec_tpu/ops/pallas_gf2mm.py _kernel (gf2_matmul_pallas) and
// _tiled_dense_kernel (gf2_matmul_pallas_tiled): the tiled product is
// positionwise over (sublane, lane), so it is this kernel on the contiguous
// (C, 8 * W8) view. Masks are arbitrary words, not only select masks: the
// AND takes whatever they hold. Bound on the H100: operations (one LOP3,
// acc ^= m & p, per mask word and plane word: RS(10,4)'s 32 x 80 masks do
// 2560 a plane column against 448 bytes moved). Design: the grid tiles W and R; a block
// stages a chunk of mask columns for its 32 rows in shared memory, [c][r],
// so every thread reads the same words (broadcasts, four at a time); each
// thread owns one word column and keeps its 32 row accumulators in
// registers, reading each plane word of the chunk once, coalesced.
#include "common.cuh"

namespace {

constexpr int kDenseRows = 32;    // row accumulators a thread holds
constexpr int kDenseChunk = 64;   // mask columns a block stages at a time
constexpr int kDenseThreads = 256;

__global__ void gf2mm_dense_kernel(const uint32_t* __restrict__ masks,
                                   const uint32_t* __restrict__ planes,
                                   uint32_t* __restrict__ out, int R, int C,
                                   long long W) {
  __shared__ uint4 smask[kDenseChunk][kDenseRows / 4];
  uint32_t* flat = reinterpret_cast<uint32_t*>(smask);
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kDenseRows;
  const int nr = min(kDenseRows, R - r0);
  uint32_t acc[kDenseRows];
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) acc[r] = 0;
  for (int c0 = 0; c0 < C; c0 += kDenseChunk) {
    const int nc = min(kDenseChunk, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < kDenseChunk * kDenseRows; e += blockDim.x) {
      const int c = e / kDenseRows;
      const int r = e - c * kDenseRows;
      flat[e] = (c < nc && r < nr)
                    ? __ldg(masks + (long long)(r0 + r) * C + c0 + c)
                    : 0u;
    }
    __syncthreads();
    if (w < W) {
      const uint32_t* col = planes + (long long)c0 * W + w;
      for (int c = 0; c < nc; ++c) {
        const uint32_t p = __ldg(col + (long long)c * W);
#pragma unroll
        for (int q = 0; q < kDenseRows / 4; ++q) {
          const uint4 m = smask[c][q];
          acc[4 * q] ^= m.x & p;
          acc[4 * q + 1] ^= m.y & p;
          acc[4 * q + 2] ^= m.z & p;
          acc[4 * q + 3] ^= m.w & p;
        }
      }
    }
  }
  if (w >= W) return;
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    if (r < nr) out[(long long)(r0 + r) * W + w] = acc[r];
  }
}

__global__ void gf2mm_kernel(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out, long long P, int C,
                             int R, const int* __restrict__ ops, int n_ops,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ row_terms) {
  extern __shared__ uint32_t slots[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const long long p = (long long)blockIdx.x * T + tid;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const uint32_t* src = in + b * C * P + p;
  uint32_t* dst = out + b * R * P + p;
  noise_ec::run_ops(ops, n_ops, slots, T, tid, src, P);
  for (int r = 0; r < R; ++r) {
    dst[(long long)r * P] =
        noise_ec::eval_row(row_ptr, row_terms, r, slots, T, tid, src, P);
  }
}

}  // namespace

extern "C" int ec_gf2mm(const void* in, void* out, int batch, long long P,
                        int C, int R, const void* ops, int n_ops,
                        const void* row_ptr, const void* row_terms,
                        int n_slots, int threads, void* stream) {
  if (batch == 0 || P == 0) return cudaSuccess;
  const size_t smem = (size_t)n_slots * threads * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(gf2mm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((P + threads - 1) / threads), (unsigned)batch);
  gf2mm_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, P, C, R, (const int*)ops, n_ops,
      (const int*)row_ptr, (const int*)row_terms);
  return (int)cudaGetLastError();
}

extern "C" int ec_gf2mm_dense(const void* masks, const void* planes, void* out,
                              int R, int C, long long W, void* stream) {
  if (R == 0 || W == 0) return cudaSuccess;
  const dim3 grid((unsigned)((W + kDenseThreads - 1) / kDenseThreads),
                  (unsigned)((R + kDenseRows - 1) / kDenseRows));
  gf2mm_dense_kernel<<<grid, kDenseThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)planes, (uint32_t*)out, R, C,
      W);
  return (int)cudaGetLastError();
}
