// K8: the dense GF(2) product on Hopper's tensor cores (wgmma).
//
// Replaces noise_ec_tpu/ops/mxu_gf2.py _mxu_kernel (the "mxu" route: every
// matrix past the XOR-network budgets, which is where GF(2^16)'s wide codes
// go). For the (8R, 8K) 0/1 int8 bit matrix M2 and K byte rows of data words
// (B, K, TW), it computes over each byte column n
//   out bit (8i + b) of column n = (sum_t M2[8i + b, t] * bit t of column n) & 1
// where bit t of column n is bit t % 8 of byte n of row t / 8, and packs the
// eight bits of output byte row i into one byte: (B, R, TW) words.
//
// Bound on the H100: operations. 2 * 8R * 8K int8 operations per byte
// column (RS(200,56) over GF(2^16), 1 MiB shards: 3.0e12, 1.52 ms at the
// 1,979e12/s dense int8 rate) against (K + R) bytes per column moved (0.08 ms
// at 3.35 TB/s).
//
// Design. The product runs transposed, out^T = bits^T . M2^T, on
// wgmma.mma_async.m64nNk32.s32.s8.s8:
// - M (64 a warpgroup) is data byte columns; N is output bit rows, one row
//   tile of M2 (N from ops/mxu.py N_MENU, the tiler's choice); K walks 8K in
//   chunks of 128 bits (16 byte rows), four k32 steps a chunk.
// - B is M2 in shared memory. The tiler (ops/mxu.py) lays M2 out once per
//   matrix as (row tile, chunk) pieces of N rows x 128 bytes, each already in
//   wgmma's 128-byte-swizzled K-major image and zero past 8R and 8K, so one
//   cp.async.bulk moves a piece and odd K needs no edge test.
// - A is the data bits in registers. Fragment register e of lane (g, tig)
//   of warp w holds four K elements of one column; for k32 step j those are
//   one nibble of one data byte: byte row 4j + tig/2 (+2 for e >= 2), column
//   16w + g (+8 for odd e), nibble tig & 1, spread to four int8 0/1 values
//   (spread4). The 8x bit blow-up touches neither device nor shared memory.
// - A ring of S stages in shared memory holds, per chunk, the M2 piece and
//   the 16 data byte rows of the block's columns (one bulk copy a row). One
//   producer warp keeps the copies in flight on `full` mbarriers (complete_tx
//   byte counts); consumer warps release a stage on `empty` once the wgmma
//   groups that read it have retired. Consumers build step j+1's fragments
//   while step j's wgmma runs (wait_group 1, two fragment sets). The
//   producer is a whole warpgroup so that setmaxnreg can move its registers
//   to the consumers.
// - NC consumer warpgroups share each M2 piece: a block covers 64 NC data
//   columns, and M2 is read from L2 once per 64 NC columns. ptxas must fit
//   one wgmma's N/2 accumulators in the registers a thread gets at launch
//   (96 at NC = 4, 168 at NC = 2), so NC = 4 up to N = 128 and NC = 2 at
//   N = 224 (RS(200,56) over GF(2^16) runs 4 row tiles of 224: 11.7 GB of
//   M2 from L2 a call). A cluster of 2 blocks multicasting each piece
//   halves that traffic but ran 1.7-2.1x slower, as did N = 128 on two
//   warpgroups (1.6x); six stages gained under 3% (PERF.md).
// - The grid is persistent: at most one block an SM walks the work items
//   (batch entry, column block, row tile; the row tile fastest, so the
//   blocks running together share data rows in L2), and the producer fills
//   the next item's stages while the consumers run the epilogue (6-15%
//   faster than one block an item).
// - Epilogue: the eight bits of output byte (i, n) are accumulator columns
//   8i..8i+7 of row n, held two each by the four lanes that share g; a lane
//   ORs its parities into a 16-bit pair (columns g and g + 8) and two
//   shuffles gather the byte. Bytes are parked in shared memory and stored as
//   whole int32 words; rows past R and words past TW are masked here, so a
//   ragged width needs no padding beyond the word tile.
// int32 sums cannot overflow (at most 8K terms of 0/1). The TPU kernel's four
// dots per byte lane work around a Mosaic reshape limit and have no
// counterpart here.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunkBytes = 128;  // K bytes of M2 a stage (one swizzle atom)
constexpr int kChunkRows = 16;    // data byte rows a stage (128 bits)

// wgmma.mma_async m64nNk32 s32 += s8 x s8, A from registers, B by descriptor.
// The accumulator list of width N is the first N/2 operands.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a,
                                         uint64_t desc);

#define WG_L0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_L1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define WG_L2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define WG_L3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_L4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define WG_L5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define WG_L6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define WG_L7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define WG_L8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define WG_L9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define WG_L10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define WG_L11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define WG_L12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define WG_L13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define WG_D8(o)                                                    \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),       \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// One width: ACC lists its N/2 accumulator operands (WG_L*), A, DESC and
// SCALE the operand numbers after them (the four A registers, the B
// descriptor, and the scale-d flag, always 1: the accumulators start at 0),
// and the rest the accumulators' constraints (WG_D8).
#define WGMMA_S8(NN, ACC, A, DESC, SCALE, ...)                               \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_s8<NN>(int* d, const uint32_t* a,    \
                                               uint64_t desc) {              \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                   \
        "wgmma.mma_async.sync.aligned.m64n" #NN "k32.s32.s8.s8 {" ACC        \
        "}, {" A "}, " DESC ", p;\n}\n"                                      \
        : __VA_ARGS__                                                        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));    \
  }

WGMMA_S8(32, WG_L0 ", " WG_L1, "%16, %17, %18, %19", "%20", "%21", WG_D8(0),
         WG_D8(8))
WGMMA_S8(128, WG_L0 ", " WG_L1 ", " WG_L2 ", " WG_L3 ", " WG_L4 ", " WG_L5
         ", " WG_L6 ", " WG_L7, "%64, %65, %66, %67", "%68", "%69", WG_D8(0),
         WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48),
         WG_D8(56))
WGMMA_S8(224,
         WG_L0 ", " WG_L1 ", " WG_L2 ", " WG_L3 ", "
         WG_L4 ", " WG_L5 ", " WG_L6 ", " WG_L7 ", "
         WG_L8 ", " WG_L9 ", " WG_L10 ", " WG_L11 ", "
         WG_L12 ", " WG_L13,
         "%112, %113, %114, %115", "%116", "%117",
         WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32),
         WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72),
         WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104))

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}
// Keeps the compiler from moving an accumulator across the asynchronous
// region (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory descriptor of a 128-byte-swizzled K-major operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset); the
// leading byte offset is unused in this mode. The piece is 1024-aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from device memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The four low bits of x as four int8 0/1 values, bit i in byte i.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

constexpr int kStages = 4;  // the ring's depth

template <int N>
struct Shape {
  // Consumer warpgroups: four up to N = 128; two above, where ptxas could
  // not fit the accumulators of four (module note).
  static constexpr int NC = N > 128 ? 2 : 4;
  static constexpr int kWords = 16 * NC;         // data words a block
  static constexpr int kCols = 4 * kWords;       // byte columns a block
  static constexpr int kRowStride = 4 * kWords + 16;  // +16: rows 4 banks apart
  static constexpr int kPiece = N * kChunkBytes;  // M2 bytes a stage
  static constexpr int kData = kChunkRows * kRowStride;
  static constexpr int kThreads = 128 * (NC + 1);  // + the producer group
  // setmaxnreg: a launch gives every thread kLaunchRegs (the most the
  // launch bound allows; ptxas takes all of it once setmaxnreg is in the
  // kernel). The producer group drops to kProducerRegs, and the consumers
  // grow by what it hands back and no more (a multiple of 8, at most 240):
  // setmaxnreg.inc waits until the block's pool holds the registers.
  static constexpr int kLaunchRegs = (65536 / kThreads) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kGrown =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / NC) / 8 * 8;
  static constexpr int kConsumerRegs = kGrown > 240 ? 240 : kGrown;
  // M2 stages (1024-aligned), data stages, the output bytes, the barriers.
  static constexpr int kDataOff = kStages * kPiece;
  static constexpr int kOutOff = kDataOff + kStages * kData;
  static constexpr int kBarOff = kOutOff + (N / 8) * kCols;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
};

// Probe takes work away for the timing probes of csrc/mxu_probe.cu (the
// library builds Probe = 0 only): bit 1 holds the A fragments constant (no
// data bytes read or spread), bit 2 copies no M2 pieces (the wgmmas read
// whatever the stage holds).
constexpr int kProbeConstA = 1, kProbeNoM2 = 2;

template <int N, int Probe = 0>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    mxu_kernel(const int8_t* __restrict__ tiles,
               const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
               int batch, int R, int K, long long TW, int T, int NCH) {
  using Sh = Shape<N>;
  constexpr int S = kStages, NC = Sh::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + Sh::kBarOff;
  const uint32_t empty0 = full0 + 8 * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // Work item = (batch entry, column block, row tile), the row tile varying
  // fastest so that the blocks running side by side share their data rows
  // in L2. Block b walks items b, b + gridDim.x, ...
  const long long blocks = (TW + Sh::kWords - 1) / Sh::kWords;
  const long long per_batch = (long long)T * blocks;
  const long long n_items = (long long)batch * per_batch;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // Producer: its first warp loads each chunk into its stage once the
    // stage's last reader released it; the group's other warps only hand
    // back their registers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Sh::kProducerRegs));
    if (warp != 4 * NC) return;
    long long gc = 0;
    for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
      const long long b = item / per_batch, rem = item % per_batch;
      const int rt = (int)(rem % T);
      const long long word0 = (rem / T) * Sh::kWords;
      const long long wl = TW - word0;
      const uint32_t row_bytes = 4u * (uint32_t)(wl < Sh::kWords ? wl : Sh::kWords);
      const uint32_t* src = words + b * K * TW + word0;
      const int8_t* piece0 = tiles + (long long)rt * NCH * Sh::kPiece;
      constexpr uint32_t m2_bytes = (Probe & kProbeNoM2) ? 0 : Sh::kPiece;
      for (int c = 0; c < NCH; ++c, ++gc) {
        const int s = (int)(gc % S);
        if (gc >= S) mbar_wait(empty0 + 8 * s, ((gc / S) & 1) ^ 1);
        const int rows = min(kChunkRows, K - kChunkRows * c);
        if (lane == 0) {
          mbar_expect_tx(full0 + 8 * s, m2_bytes + rows * row_bytes);
        }
        __syncwarp();
        if (lane < rows) {
          bulk_load(
              base + Sh::kDataOff + s * Sh::kData + lane * Sh::kRowStride,
              src + (long long)(kChunkRows * c + lane) * TW, row_bytes,
              full0 + 8 * s);
        } else if (lane == 31 && m2_bytes > 0) {
          bulk_load(base + s * Sh::kPiece, piece0 + (long long)c * Sh::kPiece,
                    Sh::kPiece, full0 + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Sh::kConsumerRegs));
  // Consumers: warpgroup wg owns byte columns 64 wg .. 64 wg + 63 of the
  // block; lane (g, tig) of warp w builds columns c0 = 64 wg + 16 w + g and
  // c0 + 8.
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int c0 = 64 * wg + 16 * w + g;
  const int sh = 4 * (tig & 1);
  const uint8_t* data0 = smem + Sh::kDataOff + (tig >> 1) * Sh::kRowStride + c0;
  uint8_t* obytes = smem + Sh::kOutOff;
  const uint32_t* owords = reinterpret_cast<const uint32_t*>(obytes);

  // Chunk gc's stage is free once the wgmma groups that read it retired.
  // The producer waits only for stages that a later chunk of this block
  // reuses, so the block's last S chunks are not released.
  const long long my_items =
      blockIdx.x < n_items
          ? (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x
          : 0;
  const long long my_chunks = my_items * NCH;
  auto release = [&](long long gc) {
    if (gc + S >= my_chunks || lane != 0) return;
    mbar_arrive(empty0 + 8 * (int)(gc % S));
  };

  int acc[N / 2];
  uint32_t a[2][4];
  long long gc = 0;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long b = item / per_batch, rem = item % per_batch;
    const int rt = (int)(rem % T);
    const long long word0 = (rem / T) * Sh::kWords;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
    for (int c = 0; c < NCH; ++c, ++gc) {
      const int s = (int)(gc % S);
      mbar_wait(full0 + 8 * s, (gc / S) & 1);
      const uint8_t* d = data0 + s * Sh::kData;
      const uint64_t desc = desc_sw128(base + s * Sh::kPiece);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t* f = a[j & 1];
        if (Probe & kProbeConstA) {
          f[0] = f[1] = f[2] = f[3] = 0x01010101u;
        } else {
          const uint8_t* q0 = d + (4 * j) * Sh::kRowStride;
          const uint8_t* q1 = q0 + 2 * Sh::kRowStride;
          f[0] = spread4((uint32_t)q0[0] >> sh);
          f[1] = spread4((uint32_t)q0[8] >> sh);
          f[2] = spread4((uint32_t)q1[0] >> sh);
          f[3] = spread4((uint32_t)q1[8] >> sh);
        }
        wgmma_fence();
        // k32 step j is 32 bytes into each swizzled 128-byte row.
        wgmma_s8<N>(acc, f, desc + 2 * j);
        wgmma_commit();
        wgmma_wait<1>();
        // Chunk c - 1's last group has retired.
        if (j == 0 && c > 0) release(gc - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[i]);
    release(gc - 1);  // the producer loads the next item during the epilogue

    // Accumulator 4j + e sits at data column c0 (+8 for e >= 2) and bit row
    // 8j + 2 tig + (e & 1) of the tile: output byte row j.
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t v =
          ((uint32_t)(acc[4 * j] & 1) | (uint32_t)(acc[4 * j + 1] & 1) << 1)
              << (2 * tig) |
          ((uint32_t)(acc[4 * j + 2] & 1) | (uint32_t)(acc[4 * j + 3] & 1) << 1)
              << (2 * tig + 8);
      v |= __shfl_xor_sync(0xFFFFFFFFu, v, 1);
      v |= __shfl_xor_sync(0xFFFFFFFFu, v, 2);
      if (tig == (j & 3)) {
        obytes[j * Sh::kCols + c0] = (uint8_t)(v & 0xFFu);
        obytes[j * Sh::kCols + c0 + 8] = (uint8_t)(v >> 8);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
    uint32_t* dst = out + b * R * TW;
    const int row0 = rt * (N / 8);
    for (int p = tid; p < (N / 8) * Sh::kWords; p += 128 * NC) {
      const int j = p / Sh::kWords, wv = p % Sh::kWords;
      if (row0 + j < R && word0 + wv < TW) {
        dst[(long long)(row0 + j) * TW + word0 + wv] = owords[p];
      }
    }
    // The next item's epilogue writes the same bytes.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
  }
}

// At most `ctas` blocks (one an SM) walking every work item.
template <int N, int Probe = 0>
int launch(const void* tiles, const void* words, void* out, int batch, int R,
           int K, long long TW, int T, int NCH, int ctas,
           cudaStream_t stream) {
  using Sh = Shape<N>;
  auto kernel = mxu_kernel<N, Probe>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = noise_ec::allow_smem(kernel, Sh::kSmem);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg.inc would wait forever if the producer group handed back
    // fewer registers than the consumers take: refuse such a build.
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    if (Sh::NC * (Sh::kConsumerRegs - fa.numRegs) >
        fa.numRegs - Sh::kProducerRegs) {
      return (int)cudaErrorLaunchOutOfResources;
    }
    ready = true;
  }
  const long long items =
      (long long)batch * T * ((TW + Sh::kWords - 1) / Sh::kWords);
  const int grid = (int)(items < ctas ? items : ctas);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      (const int8_t*)tiles, (const uint32_t*)words, (uint32_t*)out, batch, R,
      K, TW, T, NCH);
  return (int)cudaGetLastError();
}

}  // namespace

// The builds (ops/mxu.py N_MENU): one a wgmma width.
extern "C" int ec_mxu(const void* tiles, const void* words, void* out,
                      int batch, int R, int K, long long TW, int N, int T,
                      int NCH, int ctas, void* stream) {
  if (batch == 0 || R == 0 || TW == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define EC_MXU_CASE(n)                                                   \
  if (N == n)                                                            \
    return launch<n>(tiles, words, out, batch, R, K, TW, T, NCH, ctas, st);
  EC_MXU_CASE(32)
  EC_MXU_CASE(128)
  EC_MXU_CASE(224)
#undef EC_MXU_CASE
  return (int)cudaErrorInvalidValue;
}
