// K2/K3: lane pack and unpack between words and tiled bit-planes, at 8 or
// 16 planes a symbol; K9 and K10: the sublane-group pack and unpack at 8
// and 16 planes.
//
// Replaces noise_ec_tpu/ops/pallas_pack.py _pack_lanes_kernel and
// _unpack_lanes_kernel (and, at the blocked TL, _pack_lanes_blocked_call /
// _unpack_lanes_blocked_call, K6), at m = 8 and m = 16: one kernel
// templated on the group N = m. Layout contract (the reference's
// TL-dependent bijection): words (rows, TW) <-> planes (rows, N, 8, W8),
// W8 = TW / (8N); plane i of row j holds, at (sigma, c*TL + l), bit i of
// the symbols in the words j, c*8*N*TL + (sigma*N + i')*TL + l for
// i' = 0..N-1 (GF(2^8) bytes for N = 8, interleaved u16 halves for N = 16).
//
// Bound on the H100: bytes (each word read once and written once; three or
// four delta-swap rounds are ~9-12 integer ops a word). Design: one thread
// per (row, tile c, window sigma, lane l) group of N words; neighbouring
// threads take neighbouring lanes, so every load and store of a warp is
// one contiguous 128-byte line, and the transpose runs in registers.
//
// K9 and K10 replace noise_ec_tpu/ops/pallas_pack.py _pack_kernel /
// _unpack_kernel (the sublane-group pack, the reference's tier 3) and
// _pack16_kernel / _unpack16_kernel (the GF(2^16) 16-plane pack): one
// kernel templated on the group N = 8 or 16. Layout contract (the
// reference's sublane bijection): words (rows, TW) viewed as
// (rows, TW / (N*TL), N, TL) groups <-> planes (rows, N, TW / N); plane i of
// row j holds at g*TL + l the NxN transpose of the words j, g*N*TL + i'*TL + l
// for i' = 0..N-1, i.e. bit i of those symbols (GF(2^8) bytes for N = 8,
// interleaved u16 halves for N = 16). Bound: bytes, as K2/K3. One thread
// per group, neighbouring lanes on neighbouring threads, so each load and
// store of a warp is a contiguous 128-byte line; TL comes as a value, since
// the reference's TL need not be a power of two (384 at TW = 3072 for
// N = 8).
#include "common.cuh"

using noise_ec::transpose_group;

namespace {

template <int N>
__global__ void pack_lanes_kernel(const uint32_t* __restrict__ in,
                                  uint32_t* __restrict__ out, long long rows,
                                  long long TW, int tl_shift) {
  const long long per_row = TW / N;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * per_row) return;
  const long long j = g / per_row;
  const long long q = g - j * per_row;  // (c * 8 + sigma) * TL + l
  const long long TL = 1LL << tl_shift;
  const long long l = q & (TL - 1);
  const long long sigma = (q >> tl_shift) & 7;
  const long long c = q >> (tl_shift + 3);
  const long long W8 = TW / (8 * N);
  const uint32_t* src = in + j * TW + c * 8 * N * TL + sigma * N * TL + l;
  uint32_t w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = src[i * TL];
  transpose_group<N>(w);
  uint32_t* dst = out + j * TW + sigma * W8 + c * TL + l;
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * 8 * W8] = w[i];
}

template <int N>
__global__ void unpack_lanes_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out, long long rows,
                                    long long TW, int tl_shift) {
  const long long per_row = TW / N;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * per_row) return;
  const long long j = g / per_row;
  const long long q = g - j * per_row;
  const long long TL = 1LL << tl_shift;
  const long long l = q & (TL - 1);
  const long long sigma = (q >> tl_shift) & 7;
  const long long c = q >> (tl_shift + 3);
  const long long W8 = TW / (8 * N);
  const uint32_t* src = in + j * TW + sigma * W8 + c * TL + l;
  uint32_t w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = src[i * 8 * W8];
  transpose_group<N>(w);
  uint32_t* dst = out + j * TW + c * 8 * N * TL + sigma * N * TL + l;
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * TL] = w[i];
}

template <int N>
__global__ void pack_groups_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out, long long rows,
                                   long long TW, long long TL) {
  const long long per_row = TW / N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * per_row) return;
  const long long j = t / per_row;
  const long long q = t - j * per_row;  // g * TL + l
  const long long g = q / TL;
  const long long l = q - g * TL;
  const uint32_t* src = in + j * TW + g * N * TL + l;
  uint32_t w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = src[i * TL];
  transpose_group<N>(w);
  uint32_t* dst = out + j * TW + q;
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * per_row] = w[i];
}

template <int N>
__global__ void unpack_groups_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out,
                                     long long rows, long long TW,
                                     long long TL) {
  const long long per_row = TW / N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * per_row) return;
  const long long j = t / per_row;
  const long long q = t - j * per_row;
  const long long g = q / TL;
  const long long l = q - g * TL;
  const uint32_t* src = in + j * TW + q;
  uint32_t w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = src[i * per_row];
  transpose_group<N>(w);
  uint32_t* dst = out + j * TW + g * N * TL + l;
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i * TL] = w[i];
}

constexpr int kThreads = 256;

template <int N>
int launch_lanes(bool pack, const void* in, void* out, long long rows,
                 long long TW, int tl_shift, void* stream) {
  const long long n = rows * (TW / N);
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto kernel = pack ? &pack_lanes_kernel<N> : &unpack_lanes_kernel<N>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, rows, TW, tl_shift);
  return (int)cudaGetLastError();
}

int launch(bool pack, const void* in, void* out, long long rows, long long TW,
           int tl_shift, int m, void* stream) {
  if (m == 8) return launch_lanes<8>(pack, in, out, rows, TW, tl_shift, stream);
  if (m == 16)
    return launch_lanes<16>(pack, in, out, rows, TW, tl_shift, stream);
  return (int)cudaErrorInvalidValue;
}

template <int N>
int launch_groups(bool pack, const void* in, void* out, long long rows,
                  long long TW, long long TL, void* stream) {
  const long long n = rows * (TW / N);
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto kernel = pack ? &pack_groups_kernel<N> : &unpack_groups_kernel<N>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, rows, TW, TL);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* ec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// m (8 or 16) bit-planes a symbol; TL = 1 << tl_shift must divide
// TW / (8m).
extern "C" int ec_pack_lanes(const void* in, void* out, long long rows,
                             long long TW, int tl_shift, int m,
                             void* stream) {
  return launch(true, in, out, rows, TW, tl_shift, m, stream);
}

extern "C" int ec_unpack_lanes(const void* in, void* out, long long rows,
                               long long TW, int tl_shift, int m,
                               void* stream) {
  return launch(false, in, out, rows, TW, tl_shift, m, stream);
}

extern "C" int ec_pack_groups8(const void* in, void* out, long long rows,
                               long long TW, long long TL, void* stream) {
  return launch_groups<8>(true, in, out, rows, TW, TL, stream);
}

extern "C" int ec_unpack_groups8(const void* in, void* out, long long rows,
                                 long long TW, long long TL, void* stream) {
  return launch_groups<8>(false, in, out, rows, TW, TL, stream);
}

extern "C" int ec_pack_groups16(const void* in, void* out, long long rows,
                                long long TW, long long TL, void* stream) {
  return launch_groups<16>(true, in, out, rows, TW, TL, stream);
}

extern "C" int ec_unpack_groups16(const void* in, void* out, long long rows,
                                  long long TW, long long TL, void* stream) {
  return launch_groups<16>(false, in, out, rows, TW, TL, stream);
}
