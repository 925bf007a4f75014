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
#include "xornet.cuh"

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
