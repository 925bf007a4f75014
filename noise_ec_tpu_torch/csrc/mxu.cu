// K8: the dense GF(2) product on the tensor cores.
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
// Design: a block owns a 128 (bit rows) x 128 (byte columns) output tile and
// walks the K axis in chunks of 128 bits (16 byte rows). Per chunk it stages
// its 128 x 128 slice of M2 and, from the 16 x 32 data words of the chunk,
// the same columns' bits as int8 0/1 in shared memory ([column][bit], the
// layout the B operand of mma wants), so the 8x bit blow-up never reaches
// device memory. Eight warps, each a 32 x 64 tile, run
// mma.sync.m16n8k32.s8.s8.s32 over the chunk; int32 sums cannot overflow
// (at most 8K terms). The epilogue takes each sum's low bit, ORs the eight
// bits of a byte across the eight lanes that hold them (warp shuffles),
// parks the bytes in shared memory and stores whole words. Rows past 8R and
// bits past 8K are zero in shared memory and inert. The TPU kernel's four
// dots per byte lane work around a Mosaic reshape limit and have no
// counterpart here.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;  // bit rows of M2 per block
constexpr int BN = 128;  // byte columns per block (BN / 4 words)
constexpr int BK = 128;  // bits of the K axis per chunk (16 byte rows)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int WM = 32;  // warp tile: WM bit rows x WN columns
constexpr int WN = 64;
constexpr int MT = WM / 16;  // m16 tiles a warp
constexpr int NT = WN / 8;   // n8 tiles a warp
// Shared rows padded by 16 bytes: the 32 lanes of a fragment load (rows g,
// 4-byte column tig) then fall on 32 different banks.
constexpr int LDS = BK + 16;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four low bits of x as four int8 0/1 values, bit i in byte i.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
    mxu_kernel(const int8_t* __restrict__ m2, const uint32_t* __restrict__ words,
               uint32_t* __restrict__ out, int R, int K, long long TW,
               int m_tiles) {
  __shared__ __align__(16) uint8_t As[BM * LDS];
  __shared__ __align__(16) uint8_t Bs[BN * LDS];
  __shared__ __align__(16) uint8_t Os[(BM / 8) * BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // The M tile varies fastest, so the blocks that read the same data
  // columns run side by side and meet in L2.
  const int mt = blockIdx.x % m_tiles;
  const long long nt = blockIdx.x / m_tiles;
  const int row0 = mt * BM;
  const long long word0 = nt * (BN / 4);
  const int rows = 8 * R, cols = 8 * K;
  const uint32_t* src = words + (long long)blockIdx.y * K * TW;
  uint32_t* dst = out + (long long)blockIdx.y * R * TW;
  const int wm = (warp % (BM / WM)) * WM;
  const int wn = (warp / (BM / WM)) * WN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < cols; k0 += BK) {
    // M2's BM x BK slice, 8 bytes a thread and step (8K is a multiple of
    // 8, so a piece is wholly inside the matrix or wholly past it).
#pragma unroll
    for (int s = 0; s < BM * BK / 8 / kThreads; ++s) {
      const int p = tid + s * kThreads;
      const int r = p / (BK / 8), c = (p % (BK / 8)) * 8;
      uint2 v = make_uint2(0u, 0u);
      if (row0 + r < rows && k0 + c < cols) {
        v = __ldg(reinterpret_cast<const uint2*>(
            m2 + (long long)(row0 + r) * cols + k0 + c));
      }
      *reinterpret_cast<uint2*>(As + r * LDS + c) = v;
    }
    // The chunk's bits: thread p takes column n of byte row q; the four
    // lanes of one word share its load.
#pragma unroll
    for (int s = 0; s < BN * (BK / 8) / kThreads; ++s) {
      const int p = tid + s * kThreads;
      const int n = p % BN, q = p / BN;
      const int row = k0 / 8 + q;
      uint32_t v = 0;
      if (row < K) v = __ldg(src + (long long)row * TW + word0 + n / 4);
      const uint32_t byte = (v >> (8 * (n & 3))) & 0xFFu;
      *reinterpret_cast<uint2*>(Bs + n * LDS + 8 * q) =
          make_uint2(spread4(byte), spread4(byte >> 4));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* base = As + (wm + 16 * i + g) * LDS + kk + 4 * tig;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* base = Bs + (wn + 8 * j + g) * LDS + kk + 4 * tig;
        b[j][0] = *reinterpret_cast<const uint32_t*>(base);
        b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Sum (i, j, e) sits at bit row wm + 16i + g (+8 for e >= 2), column
  // wn + 8j + 2 tig + (e & 1): the eight bits of an output byte are the
  // eight lanes g = 0..7 that share tig. OR them together, one byte per e.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) v |= (uint32_t)(acc[i][j][e] & 1) << (8 * e + g);
      v |= __shfl_xor_sync(0xFFFFFFFFu, v, 4);
      v |= __shfl_xor_sync(0xFFFFFFFFu, v, 8);
      v |= __shfl_xor_sync(0xFFFFFFFFu, v, 16);
      if (g == 0) {
        const int br = (wm + 16 * i) / 8;
        const int col = wn + 8 * j + 2 * tig;
        *reinterpret_cast<uint16_t*>(Os + br * BN + col) = (uint16_t)(v & 0xFFFFu);
        *reinterpret_cast<uint16_t*>(Os + (br + 1) * BN + col) = (uint16_t)(v >> 16);
      }
    }
  }
  __syncthreads();
  const int out_row0 = row0 / 8;
#pragma unroll
  for (int s = 0; s < (BM / 8) * (BN / 4) / kThreads; ++s) {
    const int p = tid + s * kThreads;
    const int br = p / (BN / 4), w = p % (BN / 4);
    if (out_row0 + br < R) {
      dst[(long long)(out_row0 + br) * TW + word0 + w] =
          *reinterpret_cast<const uint32_t*>(Os + br * BN + 4 * w);
    }
  }
}

}  // namespace

extern "C" int ec_mxu(const void* m2, const void* words, void* out, int batch,
                      int R, int K, long long TW, void* stream) {
  if (batch == 0 || R == 0 || TW == 0) return cudaSuccess;
  const int m_tiles = (8 * R + BM - 1) / BM;
  const long long blocks = (long long)m_tiles * (TW / (BN / 4));
  const dim3 grid((unsigned)blocks, (unsigned)batch);
  mxu_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)m2, (const uint32_t*)words, (uint32_t*)out, R, K, TW,
      m_tiles);
  return (int)cudaGetLastError();
}
