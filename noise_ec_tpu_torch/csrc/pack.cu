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
// interleaved u16 halves for N = 16). TL comes as a value: the reference's
// TL need not be a power of two, nor even (384 at TW = 3072, 130 at
// TW = 1040, 129 at TW = 1032 for N = 8).
//
// Bound on the H100: bytes, each word read once and written once (the
// delta-swap is 9-12 integer ops a word), so the practical floor is a copy
// of the same bytes. Design: a thread takes V = 4, 2 or 1 adjacent lanes
// l..l+V-1 of one group (the largest V that divides TL and to whose 4V
// bytes both tensors are aligned) and moves them as N loads and N stores of
// V words (16 bytes at V = 4: a warp request covers 512 contiguous bytes),
// running V transposes in registers between them. Index math is 32-bit:
// rows on blockIdx.y with a row-stride loop, one 64-bit multiply for a
// row's offset, and the group index q / TL as a multiply by a magic
// constant from the host (ops/pack.py lane_divider). The grid comes from
// ops/pack.py groups_launch: 256-, 128- or 64-thread blocks, whichever
// first gives every SM a block, capped at one wave of resident threads
// with a grid-stride loop beyond it.
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

// Group index math: q / TL == (umulhi(q, magic) + q) >> shift for
// q < 2^31 (shift = ceil(log2 TL), magic = 2^32 (2^shift - TL) / TL + 1).
__device__ __forceinline__ uint32_t div_lanes(uint32_t q, uint32_t magic,
                                              int shift) {
  return (__umulhi(q, magic) + q) >> shift;
}

// V adjacent words in one load or store (16, 8 or 4 bytes), as column v of
// w[v][i] for one i; loads through the read-only path (inputs are read
// once).
template <int V, int N>
__device__ __forceinline__ void load_lanes(const uint32_t* p,
                                           uint32_t (&w)[V][N], int i) {
  if constexpr (V == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0][i] = x.x, w[1][i] = x.y, w[2][i] = x.z, w[3][i] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0][i] = x.x, w[1][i] = x.y;
  } else {
    w[0][i] = __ldg(p);
  }
}

template <int V, int N>
__device__ __forceinline__ void store_lanes(uint32_t* p,
                                            const uint32_t (&w)[V][N],
                                            int i) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0][i], w[1][i], w[2][i],
                                              w[3][i]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0][i], w[1][i]);
  } else {
    *p = w[0][i];
  }
}

constexpr int kMaxThreads = 256;

// K9 (N = 8) and K10 (N = 16), pack (words -> planes) or unpack. Thread t
// of a row takes q = V t = g TL + l: the words g N TL + i TL + l .. + V - 1
// and the plane words i TW/N + q .. + V - 1, i = 0..N-1.
template <int N, int V, bool kPack>
__global__ void __launch_bounds__(kMaxThreads)
    groups_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  int rows, uint32_t TW, uint32_t TL, uint32_t magic,
                  int shift) {
  const uint32_t per_row = TW / N;
  const uint32_t items = per_row / V;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.y; j < rows; j += gridDim.y) {
    const uint32_t* src = in + (size_t)j * TW;
    uint32_t* dst = out + (size_t)j * TW;
    for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < items;
         t += stride) {
      const uint32_t q = t * V;
      const uint32_t g = div_lanes(q, magic, shift);
      const uint32_t grouped = g * (N - 1) * TL + q;  // g N TL + l
      uint32_t w[V][N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        load_lanes<V, N>(kPack ? src + grouped + i * TL
                               : src + i * per_row + q, w, i);
#pragma unroll
      for (int v = 0; v < V; ++v) transpose_group<N>(w[v]);
#pragma unroll
      for (int i = 0; i < N; ++i)
        store_lanes<V, N>(kPack ? dst + i * per_row + q
                                : dst + grouped + i * TL, w, i);
    }
  }
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

template <int N, int V>
int launch_vec(bool pack, const void* in, void* out, int rows, int TW,
               int TL, unsigned magic, int shift, int threads, int bx, int by,
               cudaStream_t stream) {
  auto kernel = pack ? &groups_kernel<N, V, true> : &groups_kernel<N, V, false>;
  kernel<<<dim3(bx, by), threads, 0, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, rows, (uint32_t)TW, (uint32_t)TL,
      magic, shift);
  return (int)cudaGetLastError();
}

template <int N>
int launch_groups(bool pack, const void* in, void* out, int rows, int TW,
                  int TL, unsigned magic, int shift, int V, int threads,
                  int bx, int by, cudaStream_t stream) {
  if (V == 4)
    return launch_vec<N, 4>(pack, in, out, rows, TW, TL, magic, shift,
                            threads, bx, by, stream);
  if (V == 2)
    return launch_vec<N, 2>(pack, in, out, rows, TW, TL, magic, shift,
                            threads, bx, by, stream);
  return launch_vec<N, 1>(pack, in, out, rows, TW, TL, magic, shift,
                          threads, bx, by, stream);
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

// K9 (group = 8) and K10 (group = 16): pack (words -> planes) or unpack,
// V lanes a thread (1, 2 or 4; TL % V == 0, both pointers 4V-byte
// aligned), on a (bx, by) grid of 64-, 128- or 256-thread blocks;
// TW < 2^31; (magic, shift) divide by TL (ops/pack.py lane_divider).
extern "C" int ec_groups(int pack, const void* in, void* out, int rows,
                         int TW, int TL, unsigned magic, int shift, int group,
                         int V, int threads, int bx, int by, void* stream) {
  const bool shape_ok = (group == 8 || group == 16) &&
                        (V == 1 || V == 2 || V == 4) && TL % V == 0 &&
                        (threads == 64 || threads == 128 ||
                         threads == kMaxThreads) &&
                        rows > 0 && TW > 0 && bx > 0 && by > 0;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (group == 8)
    return launch_groups<8>(pack != 0, in, out, rows, TW, TL, magic, shift,
                            V, threads, bx, by, s);
  return launch_groups<16>(pack != 0, in, out, rows, TW, TL, magic, shift, V,
                           threads, bx, by, s);
}
