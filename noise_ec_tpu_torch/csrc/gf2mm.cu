// K4: sparse GF(2) matmul — a Paar-factored XOR network over tiled planes.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _make_sparse_kernel, which bakes
// one matrix's network into each compiled program. Here the network is an
// operand (an XorSchedule, noise_ec_tpu_torch/ops/network.py), so one build
// serves every geometry. (B, C, 8, W8) planes -> (B, R, 8, W8) planes; the
// function is positionwise, so a block owns a tile of plane-word columns.
//
// Bound on the H100: bytes (C + R planes moved once; RS(10,4)'s 532 XORs
// per 112 words moved stay under the logic-op roofline); in practice shared
// memory, three wavefronts a warp an XOR. Design: the network executor
// (xornet.cuh). The schedule's load ops copy each input plane's tile into
// a slot with cp.async one level before the level that first reads it, so
// every op reads slots only (the reference's kernel likewise reads each
// input plane once a grid step); where the inputs would not fit beside the
// temporaries the schedule loads a plane again before each level that reads
// it. After the last level the block's threads store the output rows' slots
// to device memory, neighbouring threads on neighbouring words.
#include "xornet.cuh"

namespace {

template <int TILE>
__global__ void __launch_bounds__(noise_ec::xornet::kMaxThreads)
    gf2mm_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 long long P, int C, int R, noise_ec::xornet::Net net,
                 const int* __restrict__ out_slot) {
  namespace xn = noise_ec::xornet;
  extern __shared__ __align__(16) unsigned char net_smem[];
  const xn::Smem s = xn::carve(net_smem, net);
  xn::begin(net, s);
  const long long p0 = (long long)blockIdx.x * TILE;
  const long long b = blockIdx.y;
  const int ncols = (int)min((long long)TILE, P - p0);
  __syncthreads();
  xn::run<TILE, true>(net, s, xn::Loader{in + b * C * P + p0, P, ncols});
  uint32_t* dst = out + b * R * P + p0;
  for (int e = threadIdx.x; e < R * TILE; e += blockDim.x) {
    const int row = e / TILE;
    const int c = e % TILE;
    if (c >= ncols) continue;
    const int sl = __ldg(out_slot + row);
    dst[(long long)row * P + c] = sl >= 0 ? s.slots[sl * TILE + c] : 0u;
  }
}

}  // namespace

// The schedule's arguments (ops/network.py schedule_args): the packed
// pairs, level and chunk tables, chunk count, chunk size, slot count,
// output slots, tile and threads.
extern "C" int ec_gf2mm(const void* in, void* out, int batch, long long P,
                        int C, int R, const void* pairs,
                        const void* level_ptr, const void* chunk_level,
                        int n_chunks, int chunk_pairs, int n_slots,
                        const void* out_slot, int tile, int threads,
                        void* stream) {
  if (batch == 0 || P == 0 || R == 0) return cudaSuccess;
  if (threads % 32 || threads > noise_ec::xornet::kMaxThreads ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const noise_ec::xornet::Net net{(const uint4*)pairs, (const int*)level_ptr,
                                  (const int*)chunk_level, n_chunks,
                                  chunk_pairs, n_slots};
  return noise_ec::with_tile(tile, [&](auto t) {
    constexpr int TILE = decltype(t)::value;
    const size_t smem = noise_ec::xornet::smem_bytes(net, TILE);
    cudaError_t err = noise_ec::allow_smem(gf2mm_kernel<TILE>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((P + TILE - 1) / TILE), (unsigned)batch);
    gf2mm_kernel<TILE><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, P, C, R, net,
        (const int*)out_slot);
    return (int)cudaGetLastError();
  });
}
