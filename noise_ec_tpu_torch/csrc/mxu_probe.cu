// Timing probes for K8 (csrc/mxu.cu), built on their own for
// chip_smoke.py --mxu-sweep and never part of the kernel library: they size
// what holds K8 below the int8 tensor-core peak (PERF.md).
// - ec_mxu_probe: K8 itself (probe 0) or with work taken away: 1 holds the
//   A fragments constant, 2 copies no M2 pieces, 3 both. Its output is
//   meaningless unless probe is 0.
// - ec_wgmma_peak: `iters` x four back-to-back m64nNk32 s8 wgmmas per
//   consumer warpgroup, NC warpgroups a block as K8 runs them, on a B
//   operand that stays in shared memory and constant A registers: the rate
//   the card's tensor cores give this instruction with nothing else to do.
#include "mxu.cu"

namespace {

template <int N>
__global__ void __launch_bounds__(128 * Shape<N>::NC, 1)
    wgmma_peak(int* sink, int iters) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  for (int i = threadIdx.x; i < N * kChunkBytes; i += blockDim.x) smem[i] = 1;
  __syncthreads();
  const uint64_t desc = desc_sw128(smem_u32(smem));
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  uint32_t a[4] = {threadIdx.x, threadIdx.x, threadIdx.x, threadIdx.x};
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_s8<N>(acc, a, desc + 2 * j);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int x = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x ^= acc[i];
  if (x == 0x7FFFFFFF) sink[0] = x;  // keeps the products live
}

}  // namespace

extern "C" int ec_mxu_probe(const void* tiles, const void* words, void* out,
                            int batch, int R, int K, long long TW, int N,
                            int T, int NCH, int ctas, int probe,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define EC_PROBE_CASE(n, p)                                                  \
  if (N == n && probe == p)                                                  \
    return launch<n, p>(tiles, words, out, batch, R, K, TW, T, NCH, ctas, st);
  EC_PROBE_CASE(128, 0)
  EC_PROBE_CASE(128, 1)
  EC_PROBE_CASE(128, 2)
  EC_PROBE_CASE(128, 3)
  EC_PROBE_CASE(224, 0)
  EC_PROBE_CASE(224, 1)
  EC_PROBE_CASE(224, 2)
  EC_PROBE_CASE(224, 3)
#undef EC_PROBE_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int ec_wgmma_peak(int N, int blocks, int iters, void* sink,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define EC_PEAK_CASE(n)                                                      \
  if (N == n) {                                                              \
    const int smem = n * kChunkBytes + 1024;                                 \
    wgmma_peak<n><<<blocks, 128 * Shape<n>::NC, smem, st>>>((int*)sink,      \
                                                            iters);          \
    return (int)cudaGetLastError();                                          \
  }
  EC_PEAK_CASE(128)
  EC_PEAK_CASE(224)
#undef EC_PEAK_CASE
  return (int)cudaErrorInvalidValue;
}
