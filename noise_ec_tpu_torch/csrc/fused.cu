// K1: fused encode — lane pack, XOR network, unpack in one launch.
//
// Replaces noise_ec_tpu/ops/pallas_fused.py _fused_kernel (the main-path
// kernel of encode and reconstruct) at m = 8 and m = 16 bit-planes a
// symbol. (B, k, TW) words -> (B, r, TW) words for the GF(2^8) or
// GF(2^16) matrix whose factored (m r x m k) bit network is the XorProgram
// operand (noise_ec_tpu_torch/ops/network.py); plane m j + i is bit i of
// symbol row j.
//
// Bound on the H100: bytes at the roofline (k + r words moved per word
// position, 14 MiB for RS(10,4) at 1 MiB shards against 42 MiB for the
// pack -> matmul -> unpack pipeline), but in practice the interpreted XOR
// network (RS(10,4): 532 XORs, each two shared-memory reads and a write,
// per 8-word group) and the low occupancy that its shared-memory slots
// allow. Design: one thread per m-word group, templated on N = m. It
// packs the group of every input row into bit-planes in registers with the
// delta-swap transpose (the same indexing as the lane pack at tile TL, so
// loads and stores are coalesced and the planes match K2's), parks the
// planes in its shared-memory slots ([slot][thread], bank-conflict free),
// runs the program, and transposes each output row's N planes back into
// words. The planner (ops/fused.py) sizes the block so that slots fit in
// 227 KB.
#include "gf2tile.cuh"

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

template <int N>
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
  const long long g = (long long)blockIdx.x * T + tid;  // N-word group
  if (g >= TW / N) return;
  const long long b = blockIdx.y;
  const long long TL = 1LL << tl_shift;
  const long long base = group_base<N>(g, tl_shift);
  const uint32_t* src = in + b * k * TW + base;
  uint32_t* dst = out + b * r * TW + base;
  uint32_t w[N];
  for (int j = 0; j < k; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = src[j * TW + i * TL];
    transpose_group<N>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int s = __ldg(in_slot + j * N + i);
      if (s >= 0) slots[s * T + tid] = w[i];
    }
  }
  // A program built for this kernel names no input plane directly, so the
  // device-memory operand is never read.
  noise_ec::run_ops(ops, n_ops, slots, T, tid, nullptr, 0);
  for (int j = 0; j < r; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[i] = noise_ec::eval_row(row_ptr, row_terms, j * N + i, slots, T, tid,
                                nullptr, 0);
    }
    transpose_group<N>(w);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[j * TW + i * TL] = w[i];
  }
}

template <int N>
int launch_fused(const void* in, void* out, int batch, int k, int r,
                 long long TW, int tl_shift, const void* ops, int n_ops,
                 const void* row_ptr, const void* row_terms,
                 const void* in_slot, int n_slots, int threads,
                 void* stream) {
  const long long groups = TW / N;
  if (batch == 0 || groups == 0) return cudaSuccess;
  const size_t smem = (size_t)n_slots * threads * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(fused_kernel<N>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((groups + threads - 1) / threads), (unsigned)batch);
  fused_kernel<N><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, k, r, TW, tl_shift,
      (const int*)ops, n_ops, (const int*)row_ptr, (const int*)row_terms,
      (const int*)in_slot);
  return (int)cudaGetLastError();
}

}  // namespace

// m (8 or 16) bit-planes a symbol; TL = 1 << tl_shift must divide
// TW / (8m).
extern "C" int ec_fused(const void* in, void* out, int batch, int k, int r,
                        long long TW, int tl_shift, int m, const void* ops,
                        int n_ops, const void* row_ptr, const void* row_terms,
                        const void* in_slot, int n_slots, int threads,
                        void* stream) {
  if (m == 8)
    return launch_fused<8>(in, out, batch, k, r, TW, tl_shift, ops, n_ops,
                           row_ptr, row_terms, in_slot, n_slots, threads,
                           stream);
  if (m == 16)
    return launch_fused<16>(in, out, batch, k, r, TW, tl_shift, ops, n_ops,
                            row_ptr, row_terms, in_slot, n_slots, threads,
                            stream);
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
namespace {

using namespace noise_ec::tile;

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
    split_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                 const uint32_t* __restrict__ masks, int k, int r,
                 long long TW, int tl_shift, int ksl, Shape s, int NT,
                 int ksplit, int mode) {
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
  const uint32_t* msrc = masks + (long long)rg * NT * s.mask_words();
  const int chunks = s.ncol / 4;

  auto load = [&](int t, int stage) {
    uint32_t* st = smem + stage * s.stage_words();
    // Four neighbouring groups lie in one TL run, so their word i is one
    // 16-byte chunk. Rows past k (a short last phase) have zero masks.
    for (int e = threadIdx.x; e < s.KT * chunks; e += blockDim.x) {
      const int ji = e / chunks;  // N * j + i
      const int x = 4 * (e - ji * chunks);
      const int row = t * ksl + ji / N;
      const long long g = g0 + x;
      if (row < k && g < groups) {
        cp_async16(st + ji * s.ncol + x,
                   src + row * TW + group_base<N>(g, tl_shift) +
                       (ji % N) * TL);
      }
    }
    stage_masks(st + s.tile_words(),
                msrc + (long long)t * s.mask_words(), s.mask_words());
  };

  uint32_t acc[kCols][kRowBlock];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int q = 0; q < kRowBlock; ++q) acc[i][q] = 0;
  }
  uint32_t w[N];
  if (t0 < t1) load(t0, 0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) % kStages;
    cp_async_wait_all();
    __syncthreads();  // phase t landed; phase t-1's stage is free
    if (t + 1 < t1) load(t + 1, (stage + 1) % kStages);
    cp_async_commit();
    uint32_t* st = smem + stage * s.stage_words();
    for (int e = threadIdx.x; e < ksl * s.ncol; e += blockDim.x) {
      const int j = e / s.ncol;
      uint32_t* grp = st + N * j * s.ncol + (e - j * s.ncol);
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = grp[i * s.ncol];
      transpose_group<N>(w);
#pragma unroll
      for (int i = 0; i < N; ++i) grp[i * s.ncol] = w[i];
    }
    __syncthreads();
    product(acc, st, st + s.tile_words(), s, wc * 32 * kCols + lane,
            wr * kRowBlock);
  }
  // The output symbol row of the warp's first N accumulators.
  const int row0 = (rg * s.rgr + wr * kRowBlock) / N;
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

template <int N>
int launch_split(const void* in, void* out, const void* masks, int batch,
                 int k, int r, long long TW, int tl_shift, int ksl, int NT,
                 int NRG, int WR, int WC, int ksplit, void* stream) {
  const Shape s{N * ksl, WR, WC, 32 * kCols * WC, kRowBlock * WR};
  const size_t smem = (size_t)kStages * s.stage_words() * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(split_kernel<N>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = (TW / N + s.ncol - 1) / s.ncol;
  if (cols > 0x7fffffffLL || (long long)batch * ksplit > 65535 || NRG > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)cols, (unsigned)NRG, (unsigned)(batch * ksplit));
  split_kernel<N><<<grid, 32 * WR * WC, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)masks, k, r, TW,
      tl_shift, ksl, s, NT, ksplit, ksplit > 1 ? kAtomicXor : kStore);
  return (int)cudaGetLastError();
}

}  // namespace

// m (8 or 16) bit-planes a symbol, ksl input rows (m ksl planes) a phase.
// With ksplit > 1 the caller has zeroed `out`. TL = 1 << tl_shift must be
// at least 4: the ring copies four neighbouring groups' word i as one
// aligned 16-byte chunk.
extern "C" int ec_fused_split(const void* in, void* out, const void* masks,
                              int batch, int k, int r, long long TW,
                              int tl_shift, int m, int ksl, int NT, int NRG,
                              int WR, int WC, int ksplit, void* stream) {
  if (batch == 0 || TW < m || r == 0) return cudaSuccess;
  if (tl_shift < 2 || ksplit < 1 || 32 * WR * WC > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (m == 8)
    return launch_split<8>(in, out, masks, batch, k, r, TW, tl_shift, ksl,
                           NT, NRG, WR, WC, ksplit, stream);
  if (m == 16)
    return launch_split<16>(in, out, masks, batch, k, r, TW, tl_shift, ksl,
                            NT, NRG, WR, WC, ksplit, stream);
  return (int)cudaErrorInvalidValue;
}
