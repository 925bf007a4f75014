// K2/K3: lane pack and unpack between words and tiled bit-planes; K10: the
// GF(2^16) 16-plane pack and unpack.
//
// Replaces noise_ec_tpu/ops/pallas_pack.py _pack_lanes_kernel and
// _unpack_lanes_kernel. Layout contract (the reference's TL-dependent
// bijection): words (rows, TW) <-> planes (rows, 8, 8, W8), W8 = TW / 64;
// plane i of row j holds, at (sigma, c*TL + l), bit i of the 32 symbols in
// the words j, c*64*TL + (sigma*8 + i')*TL + l for i' = 0..7.
//
// Bound on the H100: bytes (each word read once and written once; three
// delta-swap rounds are ~15 integer ops per 8 words). Design: one thread per
// (row, tile c, window sigma, lane l) group; neighbouring threads take
// neighbouring lanes, so every load and store of a warp is one contiguous
// 128-byte line, and the transpose runs in registers.
//
// K10 replaces noise_ec_tpu/ops/pallas_pack.py _pack16_kernel and
// _unpack16_kernel. Layout contract (the reference's sublane bijection):
// words (rows, TW), two little-endian u16 symbols a word, viewed as
// (rows, G16, 16, TL) groups <-> planes (rows, 16, G16 * TL); plane i of row
// j holds at g*TL + l the 16x16 transpose of the words j, g*16*TL + i'*TL + l
// for i' = 0..15, i.e. bit i of those 32 symbols. Bound: bytes, as K2/K3
// (four delta-swap rounds are ~12 integer ops a word). One thread per
// 16-word group, neighbouring lanes on neighbouring threads, so each load
// and store of a warp is a contiguous 128-byte line; TL comes as a value,
// since the reference's TL need not be a power of two.
#include "common.cuh"

using noise_ec::transpose16;
using noise_ec::transpose8;

namespace {

__global__ void pack_lanes_kernel(const uint32_t* __restrict__ in,
                                  uint32_t* __restrict__ out, long long rows,
                                  long long TW, int tl_shift) {
  const long long per_row = TW / 8;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * per_row) return;
  const long long j = g / per_row;
  const long long q = g - j * per_row;  // (c * 8 + sigma) * TL + l
  const long long TL = 1LL << tl_shift;
  const long long l = q & (TL - 1);
  const long long sigma = (q >> tl_shift) & 7;
  const long long c = q >> (tl_shift + 3);
  const long long W8 = TW / 64;
  const uint32_t* src = in + j * TW + c * 64 * TL + sigma * 8 * TL + l;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = src[i * TL];
  transpose8(w);
  uint32_t* dst = out + j * TW + sigma * W8 + c * TL + l;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i * 8 * W8] = w[i];
}

__global__ void unpack_lanes_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, long long rows,
                                    long long TW, int tl_shift) {
  const long long per_row = TW / 8;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * per_row) return;
  const long long j = g / per_row;
  const long long q = g - j * per_row;
  const long long TL = 1LL << tl_shift;
  const long long l = q & (TL - 1);
  const long long sigma = (q >> tl_shift) & 7;
  const long long c = q >> (tl_shift + 3);
  const long long W8 = TW / 64;
  const uint32_t* src = in + j * TW + sigma * W8 + c * TL + l;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = src[i * 8 * W8];
  transpose8(w);
  uint32_t* dst = out + j * TW + c * 64 * TL + sigma * 8 * TL + l;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i * TL] = w[i];
}

__global__ void pack16_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, long long rows,
                              long long TW, long long TL) {
  const long long per_row = TW / 16;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * per_row) return;
  const long long j = t / per_row;
  const long long q = t - j * per_row;  // g * TL + l
  const long long g = q / TL;
  const long long l = q - g * TL;
  const uint32_t* src = in + j * TW + g * 16 * TL + l;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = src[i * TL];
  transpose16(w);
  uint32_t* dst = out + j * TW + q;
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i * per_row] = w[i];
}

__global__ void unpack16_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out, long long rows,
                                long long TW, long long TL) {
  const long long per_row = TW / 16;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * per_row) return;
  const long long j = t / per_row;
  const long long q = t - j * per_row;
  const long long g = q / TL;
  const long long l = q - g * TL;
  const uint32_t* src = in + j * TW + q;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = src[i * per_row];
  transpose16(w);
  uint32_t* dst = out + j * TW + g * 16 * TL + l;
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i * TL] = w[i];
}

constexpr int kThreads = 256;

int launch(bool pack, const void* in, void* out, long long rows, long long TW,
           int tl_shift, void* stream) {
  const long long n = rows * (TW / 8);
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto kernel = pack ? pack_lanes_kernel : unpack_lanes_kernel;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, rows, TW, tl_shift);
  return (int)cudaGetLastError();
}

int launch16(bool pack, const void* in, void* out, long long rows,
             long long TW, long long TL, void* stream) {
  const long long n = rows * (TW / 16);
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto kernel = pack ? pack16_kernel : unpack16_kernel;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, rows, TW, TL);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* ec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int ec_pack_lanes(const void* in, void* out, long long rows,
                             long long TW, int tl_shift, void* stream) {
  return launch(true, in, out, rows, TW, tl_shift, stream);
}

extern "C" int ec_unpack_lanes(const void* in, void* out, long long rows,
                               long long TW, int tl_shift, void* stream) {
  return launch(false, in, out, rows, TW, tl_shift, stream);
}

extern "C" int ec_pack_words16(const void* in, void* out, long long rows,
                               long long TW, long long TL, void* stream) {
  return launch16(true, in, out, rows, TW, TL, stream);
}

extern "C" int ec_unpack_words16(const void* in, void* out, long long rows,
                                 long long TW, long long TL, void* stream) {
  return launch16(false, in, out, rows, TW, TL, stream);
}
