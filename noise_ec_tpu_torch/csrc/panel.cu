// K7: the block-panel K-tiled GF(2) matmul for wide geometries.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _make_panel_kernel and
// _make_panel_acc_kernel (one kernel here: `accumulate` selects the
// second). (B, C, 8, W8) planes -> (B, R, 8, W8) planes over the K tiles
// [lo, hi) of KT planes: out[r] = XOR over those planes c of bit (r, c) of
// the matrix times plane c. With `accumulate` the sum is XORed into `out`,
// which holds the earlier sub-launches' sum (the reference donates its
// accumulator to the output instead).
//
// Bound on the H100: operations. RS(200,56) at 1 MiB shards moves 256 MiB
// (0.08 ms at 3.35 TB/s); its factored network is ~150k XORs a plane word
// (0.29 ms), and the dense product this kernel runs is 448 x 1600 LOP3s a
// plane word (1.41 ms at 16.7e12 LOP3/s), so the logic pipes bound it. The
// kernel it replaces interpreted the factored network from shared-memory
// slots, three memory operations an XOR, at few resident threads (11.4 ms).
//
// Design: the product core (gf2tile.cuh). A block owns `ncol` plane-word
// columns and one row group (up to 16 warps of 32 rows); its warps keep
// their rows' accumulators in registers and read the masks as broadcasts,
// so the logic pipes, not memory operations, set the pace. The ring stages
// K tile t+1's planes and masks with cp.async while tile t's product runs,
// and every warp of the block reads the one staged copy of the planes.
// Where the columns do not fill the card (RS(229,6) at 64 KiB shards:
// 2,048 words a plane), the launch splits the K tiles over `ksplit` blocks
// a column tile, which XOR their partial sums into the output atomically.
#include "gf2tile.cuh"

namespace {

using namespace noise_ec::tile;

__global__ void __launch_bounds__(kMaxThreads)
    panel_kernel(const uint32_t* __restrict__ in, uint32_t* out,
                 const uint32_t* __restrict__ masks, long long P, int C, int R,
                 Shape s, int NT, int lo, int hi, int ksplit, int mode) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp % s.WR;
  const int wc = warp / s.WR;
  const long long col0 = (long long)blockIdx.x * s.ncol;
  const int rg = blockIdx.y;
  const long long b = blockIdx.z / ksplit;
  int t0, t1;
  k_range(lo, hi, ksplit, blockIdx.z % ksplit, &t0, &t1);
  const uint32_t* src = in + b * C * P;
  const uint32_t* msrc = masks + (long long)rg * NT * s.mask_words();
  const int chunks = s.ncol / 4;

  auto load = [&](int t, int stage) {
    uint32_t* st = smem + stage * s.stage_words();
    // Planes past C have zero masks and columns past P are never stored,
    // so their stale words are never read into a result.
    for (int e = threadIdx.x; e < s.KT * chunks; e += blockDim.x) {
      const int c = e / chunks;
      const int x = 4 * (e - c * chunks);
      const long long plane = (long long)t * s.KT + c;
      if (plane < C && col0 + x < P) {
        cp_async16(st + c * s.ncol + x, src + plane * P + col0 + x);
      }
    }
    stage_masks(st + s.tile_words(),
                msrc + (long long)t * s.mask_words(), s.mask_words());
  };

  uint32_t acc[kCols][kRowBlock];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) acc[i][r] = 0;
  }
  if (t0 < t1) load(t0, 0);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) % kStages;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; tile t-1's stage is free
    if (t + 1 < t1) load(t + 1, (stage + 1) % kStages);
    cp_async_commit();
    const uint32_t* st = smem + stage * s.stage_words();
    product(acc, st, st + s.tile_words(), s, wc * 32 * kCols + lane,
            wr * kRowBlock);
  }
  const int row0 = rg * s.rgr + wr * kRowBlock;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const long long col = col0 + wc * 32 * kCols + lane + 32 * i;
    if (col >= P) continue;
    uint32_t* dst = out + (b * R + row0) * P + col;
#pragma unroll
    for (int r = 0; r < kRowBlock; ++r) {
      if (row0 + r < R) emit(dst + r * P, acc[i][r], mode);
    }
  }
}

}  // namespace

// `accumulate`: out already holds a sum to XOR into. With ksplit > 1 the
// caller has zeroed out (or it holds that sum) and the blocks XOR into it
// atomically.
extern "C" int ec_panel(const void* in, void* out, const void* masks,
                        int batch, long long P, int C, int R, int KT, int NT,
                        int NRG, int WR, int WC, int lo, int hi, int ksplit,
                        int accumulate, void* stream) {
  if (batch == 0 || P == 0 || R == 0 || hi <= lo) return cudaSuccess;
  if (P % 4 != 0 || ksplit < 1 || 32 * WR * WC > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const Shape s{KT, WR, WC, 32 * kCols * WC, kRowBlock * WR};
  const size_t smem = (size_t)kStages * s.stage_words() * sizeof(uint32_t);
  cudaError_t err = noise_ec::allow_smem(panel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = (P + s.ncol - 1) / s.ncol;
  if (cols > 0x7fffffffLL || (long long)batch * ksplit > 65535 || NRG > 65535)
    return (int)cudaErrorInvalidValue;
  const int mode = ksplit > 1 ? kAtomicXor : (accumulate ? kXor : kStore);
  const dim3 grid((unsigned)cols, (unsigned)NRG, (unsigned)(batch * ksplit));
  panel_kernel<<<grid, 32 * WR * WC, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)masks, P, C, R, s,
      NT, lo, hi, ksplit, mode);
  return (int)cudaGetLastError();
}
