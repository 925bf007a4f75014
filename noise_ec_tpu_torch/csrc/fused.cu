// K1: fused encode — lane pack, XOR network, unpack in one launch.
//
// Replaces noise_ec_tpu/ops/pallas_fused.py _fused_kernel (the main-path
// kernel of encode and reconstruct) at m = 8 and m = 16 bit-planes a
// symbol. (B, k, TW) words -> (B, r, TW) words for the GF(2^8) or
// GF(2^16) matrix whose factored (m r x m k) bit network is the
// XorSchedule operand (noise_ec_tpu_torch/ops/network.py); plane m j + i is
// bit i of symbol row j.
//
// Bound on the H100: bytes at the roofline (k + r words moved per word
// position, 14 MiB for RS(10,4) at 1 MiB shards against 42 MiB for the
// pack -> matmul -> unpack pipeline); in practice shared memory, three
// wavefronts a warp an XOR (RS(10,4): 532 XORs per 8-word group).
//
// Design: the network executor (xornet.cuh), templated on the group N = m
// and the tile of TILE groups a block. The block's threads split the tile's
// k input rows x TILE groups: each loads the N words of one group of one
// row (the lane pack's indexing at tile TL, so neighbouring groups are
// neighbouring words and the loads coalesce), packs them into N bit-planes
// in registers with the delta-swap transpose (the planes of K2), and parks
// them in their slots, while the program's bulk copy is in flight. All the
// block's warps then run the schedule's levels, and split the r output rows
// x TILE groups to transpose each row's N planes back into words.
#include "gf2tile.cuh"
#include "xornet.cuh"

using noise_ec::transpose_group;

namespace {

// Offset of N-word group g's word 0 in a row at TL = 1 << tl_shift (K2's
// bijection at m = N; word i of the group is i * TL further on).
template <int N>
__device__ __forceinline__ long long group_base(long long g, int tl_shift) {
  const long long TL = 1LL << tl_shift;
  return (g >> (tl_shift + 3)) * 8 * N * TL + ((g >> tl_shift) & 7) * N * TL +
         (g & (TL - 1));
}

template <int N, int TILE>
__global__ void __launch_bounds__(noise_ec::xornet::kMaxThreads)
    fused_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int k, int r, long long TW, int tl_shift,
                 const int* __restrict__ in_slot, noise_ec::xornet::Net net,
                 const int* __restrict__ out_slot) {
  namespace xn = noise_ec::xornet;
  extern __shared__ __align__(16) unsigned char net_smem[];
  const xn::Smem s = xn::carve(net_smem, net);
  xn::begin(net, s);
  const long long groups = TW / N;
  const long long g0 = (long long)blockIdx.x * TILE;
  const long long b = blockIdx.y;
  const long long TL = 1LL << tl_shift;
  uint32_t w[N];
  for (int e = threadIdx.x; e < k * TILE; e += blockDim.x) {
    const int j = e / TILE;
    const int g = e % TILE;
    if (g0 + g >= groups) continue;
    const uint32_t* src =
        in + (b * k + j) * TW + group_base<N>(g0 + g, tl_shift);
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = src[i * TL];
    transpose_group<N>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int sl = __ldg(in_slot + j * N + i);
      if (sl >= 0) s.slots[sl * TILE + g] = w[i];
    }
  }
  __syncthreads();
  xn::run<TILE, false>(net, s, xn::Loader{});
  for (int e = threadIdx.x; e < r * TILE; e += blockDim.x) {
    const int j = e / TILE;
    const int g = e % TILE;
    if (g0 + g >= groups) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int sl = __ldg(out_slot + j * N + i);
      w[i] = sl >= 0 ? s.slots[sl * TILE + g] : 0u;
    }
    transpose_group<N>(w);
    uint32_t* dst = out + (b * r + j) * TW + group_base<N>(g0 + g, tl_shift);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i * TL] = w[i];
  }
}

template <int N>
int launch_fused(const void* in, void* out, int batch, int k, int r,
                 long long TW, int tl_shift, const void* in_slot,
                 const noise_ec::xornet::Net& net, const void* out_slot,
                 int tile, int threads, void* stream) {
  return noise_ec::with_tile(tile, [&](auto t) {
    constexpr int TILE = decltype(t)::value;
    const size_t smem = noise_ec::xornet::smem_bytes(net, TILE);
    cudaError_t err = noise_ec::allow_smem(fused_kernel<N, TILE>, smem);
    if (err != cudaSuccess) return (int)err;
    const long long groups = TW / N;
    const dim3 grid((unsigned)((groups + TILE - 1) / TILE), (unsigned)batch);
    fused_kernel<N, TILE><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, k, r, TW, tl_shift,
        (const int*)in_slot, net, (const int*)out_slot);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// m (8 or 16) bit-planes a symbol; TL = 1 << tl_shift must divide
// TW / (8m). The schedule's arguments follow in_slot (ops/network.py
// schedule_args): the packed pairs, level and chunk tables, chunk count,
// chunk size, slot count, output slots, tile and threads.
extern "C" int ec_fused(const void* in, void* out, int batch, int k, int r,
                        long long TW, int tl_shift, int m,
                        const void* in_slot, const void* pairs,
                        const void* level_ptr, const void* chunk_level,
                        int n_chunks, int chunk_pairs, int n_slots,
                        const void* out_slot, int tile, int threads,
                        void* stream) {
  if (batch == 0 || TW < m) return cudaSuccess;
  if (threads % 32 || threads > noise_ec::xornet::kMaxThreads ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const noise_ec::xornet::Net net{(const uint4*)pairs, (const int*)level_ptr,
                                  (const int*)chunk_level, n_chunks,
                                  chunk_pairs, n_slots};
  if (m == 8)
    return launch_fused<8>(in, out, batch, k, r, TW, tl_shift, in_slot, net,
                           out_slot, tile, threads, stream);
  if (m == 16)
    return launch_fused<16>(in, out, batch, k, r, TW, tl_shift, in_slot, net,
                            out_slot, tile, threads, stream);
  return (int)cudaErrorInvalidValue;
}


// K5: the K-sliced fused encode, for matrices whose factored network K1
// cannot park in shared memory.
//
// Replaces noise_ec_tpu/ops/pallas_fused.py _dma_split_kernel (the "dma"
// plan of the reference's verified fused planner) at m = 8 and m = 16 bit-
// planes a symbol. (B, k, TW) words -> (B, r, TW) words, on K2's lane
// indexing at TL, for the GF(2^8) or GF(2^16) matrix whose (m r x m k) bit
// expansion is the mask operand (ops/gf2tile.py).
//
// Bound on the H100: operations. RS(50,20) at 1 MiB shards moves 70 MiB
// (0.022 ms at 3.35 TB/s) and its factored network is ~12,100 XORs an
// 8-word group (0.0297 ms); the dense product run here is 160 x 400 LOP3s
// a plane word (0.126 ms at 16.7e12 LOP3/s) plus the transposes. The
// kernel it replaces interpreted the factored network from shared-memory
// slots at 64 threads a block and took 3.99 ms.
//
// Design: the reference's structure on the product core (gf2tile.cuh),
// templated on the group N = m. The K axis runs in phases of ksl input
// rows (KT = N ksl planes). The ring stages phase p+1's raw words (ksl
// rows x N words x the block's ncol groups, each run of a group's word i
// contiguous in device memory) and its mask tile with cp.async while phase
// p computes: the counterpart of the reference's DMA double buffer
// (`copy(ph, slot)`). Once a phase has landed, the block transposes each
// staged N-word group into its N bit-planes in place (transpose8 or
// transpose16: word i of row j at [Nj + i][g] becomes plane Nj + b at
// [Nj + b][g]), and the core accumulates the phase into registers. After
// the last phase each lane transposes the N accumulators of each output
// row it holds (kRowBlock / N rows: two at m = 16, the second masked when
// r is odd) back into words and stores them as K1 does. A grid too narrow
// for the card splits the phases over `ksplit` blocks a column tile, which
// XOR into the zeroed output atomically (ops/fused.py).
//
// Row maps (kMapped): input row j of batch b is read at in + b * in_bstride
// + in_rows[j] * TW and output row q stored at out + b * out_bstride +
// out_rows[q] * TW (a null table is the identity), so a rebuild reads its
// basis rows where they lie and stores the lost rows into the codeword
// (parallel/batch.py). The contiguous instantiation is the unmapped
// kernel's own text: with the maps' arithmetic woven into the shared
// statements it took 128 registers against 126 and ran 1% slower on the
// write cells (PERF.md §6).
namespace {

using namespace noise_ec::tile;

struct RowMaps {
  long long in_bstride;   // words from one batch's input rows to the next
  long long out_bstride;  // the same for the output rows
  const int* in_rows;     // k input rows, or null
  const int* out_rows;    // r output rows, or null
};

template <int N, bool kMapped>
__global__ void __launch_bounds__(kMaxThreads)
    split_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                 const uint32_t* __restrict__ masks, int k, int r,
                 long long TW, int tl_shift, int ksl, Shape s, int NT,
                 int ksplit, int mode, RowMaps maps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp % s.WR;
  const int wc = warp / s.WR;
  const long long groups = TW / N;
  const long long g0 = (long long)blockIdx.x * s.ncol;
  const int rg = blockIdx.y;
  const long long b = blockIdx.z / ksplit;
  int t0, t1;
  k_range(0, NT, ksplit, blockIdx.z % ksplit, &t0, &t1);
  const long long TL = 1LL << tl_shift;
  const uint32_t* src = in + b * k * TW;
  if constexpr (kMapped) src = in + b * maps.in_bstride;
  const uint32_t* msrc = masks + (long long)rg * NT * s.mask_words();
  const int chunks = s.ncol / 4;

  auto load = [&](int t, uint32_t* st) {
    // Four neighbouring groups lie in one TL run, so their word i is one
    // 16-byte chunk. Rows past k (a short last phase) have zero masks.
    for (int e = threadIdx.x; e < s.KT * chunks; e += blockDim.x) {
      const int ji = e / chunks;  // N * j + i
      const int x = 4 * (e - ji * chunks);
      const int row = t * ksl + ji / N;
      const long long g = g0 + x;
      if (row < k && g < groups) {
        if constexpr (kMapped) {
          const long long jr =
              maps.in_rows != nullptr ? __ldg(maps.in_rows + row) : row;
          cp_async16(st + ji * s.ncol + x,
                     src + jr * TW + group_base<N>(g, tl_shift) +
                         (ji % N) * TL);
        } else {
          cp_async16(st + ji * s.ncol + x,
                     src + row * TW + group_base<N>(g, tl_shift) +
                         (ji % N) * TL);
        }
      }
    }
    stage_masks(st + s.tile_words(),
                msrc + (long long)t * s.mask_words(), s.mask_words());
  };

  // Once a phase has landed, each N-word group becomes N bit-planes.
  auto transpose = [&](uint32_t* st) {
    uint32_t v[N];
    for (int e = threadIdx.x; e < ksl * s.ncol; e += blockDim.x) {
      const int j = e / s.ncol;
      uint32_t* grp = st + N * j * s.ncol + (e - j * s.ncol);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = grp[i * s.ncol];
      transpose_group<N>(v);
#pragma unroll
      for (int i = 0; i < N; ++i) grp[i * s.ncol] = v[i];
    }
    __syncthreads();
  };

  uint32_t acc[kCols][kRowBlock];
  ring<kStages>(acc, smem, s, t0, t1, wc * 32 * kCols + lane,
                wr * kRowBlock, load, transpose, 0, s.KT);
  uint32_t w[N];
  // The output symbol row of the warp's first N accumulators.
  const int row0 = (rg * s.rgr + wr * kRowBlock) / N;
  if constexpr (kMapped) {
    // Where each of the warp's output rows starts in its batch.
    long long orow[kRowBlock / N];
#pragma unroll
    for (int q = 0; q < kRowBlock / N; ++q) {
      const int row = min(row0 + q, r - 1);
      orow[q] = (maps.out_rows != nullptr ? __ldg(maps.out_rows + row) : row) *
                TW;
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const long long g = g0 + wc * 32 * kCols + lane + 32 * i;
      if (g >= groups) continue;
      uint32_t* dst = out + b * maps.out_bstride + group_base<N>(g, tl_shift);
#pragma unroll
      for (int q = 0; q < kRowBlock / N; ++q) {
        if (row0 + q >= r) break;
#pragma unroll
        for (int v = 0; v < N; ++v) w[v] = acc[i][N * q + v];
        transpose_group<N>(w);
#pragma unroll
        for (int v = 0; v < N; ++v) emit(dst + orow[q] + v * TL, w[v], mode);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const long long g = g0 + wc * 32 * kCols + lane + 32 * i;
    if (g >= groups) continue;
    uint32_t* dst = out + b * r * TW + group_base<N>(g, tl_shift);
#pragma unroll
    for (int q = 0; q < kRowBlock / N; ++q) {
      if (row0 + q >= r) break;
#pragma unroll
      for (int v = 0; v < N; ++v) w[v] = acc[i][N * q + v];
      transpose_group<N>(w);
#pragma unroll
      for (int v = 0; v < N; ++v) {
        emit(dst + (row0 + q) * TW + v * TL, w[v], mode);
      }
    }
  }
}

}  // namespace

namespace {

template <int N, bool kMapped>
int launch_split_as(const void* in, void* out, const void* masks, int batch,
                    int k, int r, long long TW, int tl_shift, int ksl, int NT,
                    int NRG, int WR, int WC, int ksplit, const RowMaps& maps,
                    void* stream) {
  const Shape s = Shape::make(N * ksl, WR, WC, 1, 0);
  const size_t smem = s.smem_bytes(kStages);
  cudaError_t err = noise_ec::allow_smem(split_kernel<N, kMapped>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = (TW / N + s.ncol - 1) / s.ncol;
  if (cols > 0x7fffffffLL || (long long)batch * ksplit > 65535 || NRG > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)cols, (unsigned)NRG, (unsigned)(batch * ksplit));
  split_kernel<N, kMapped><<<grid, 32 * WR * WC, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)masks, k, r, TW,
      tl_shift, ksl, s, NT, ksplit, ksplit > 1 ? kAtomicXor : kStore, maps);
  return (int)cudaGetLastError();
}

template <int N>
int launch_split(const void* in, void* out, const void* masks, int batch,
                 int k, int r, long long TW, int tl_shift, int ksl, int NT,
                 int NRG, int WR, int WC, int ksplit, const RowMaps& maps,
                 void* stream) {
  if (maps.in_rows != nullptr || maps.out_rows != nullptr ||
      maps.in_bstride != k * TW || maps.out_bstride != r * TW)
    return launch_split_as<N, true>(in, out, masks, batch, k, r, TW, tl_shift,
                                    ksl, NT, NRG, WR, WC, ksplit, maps, stream);
  return launch_split_as<N, false>(in, out, masks, batch, k, r, TW, tl_shift,
                                   ksl, NT, NRG, WR, WC, ksplit, maps, stream);
}

}  // namespace

// m (8 or 16) bit-planes a symbol, ksl input rows (m ksl planes) a phase.
// With ksplit > 1 the caller has zeroed the output rows. TL = 1 << tl_shift
// must be at least 4: the ring copies four neighbouring groups' word i as
// one aligned 16-byte chunk, so in_bstride must be a multiple of 4 words.
// Row maps as split_kernel has them: null tables with strides k TW and r TW
// are the contiguous (B, k, TW) -> (B, r, TW) product.
extern "C" int ec_fused_split(const void* in, void* out, const void* masks,
                              int batch, int k, int r, long long TW,
                              int tl_shift, int m, int ksl, int NT, int NRG,
                              int WR, int WC, int ksplit, long long in_bstride,
                              const void* in_rows, long long out_bstride,
                              const void* out_rows, void* stream) {
  if (batch == 0 || TW < m || r == 0) return cudaSuccess;
  if (tl_shift < 2 || ksplit < 1 || 32 * WR * WC > kMaxThreads ||
      in_bstride % 4)
    return (int)cudaErrorInvalidValue;
  const RowMaps maps{in_bstride, out_bstride, (const int*)in_rows,
                     (const int*)out_rows};
  if (m == 8)
    return launch_split<8>(in, out, masks, batch, k, r, TW, tl_shift, ksl,
                           NT, NRG, WR, WC, ksplit, maps, stream);
  if (m == 16)
    return launch_split<16>(in, out, masks, batch, k, r, TW, tl_shift, ksl,
                            NT, NRG, WR, WC, ksplit, maps, stream);
  return (int)cudaErrorInvalidValue;
}
