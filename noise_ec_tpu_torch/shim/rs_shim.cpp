// rs_shim: GF(2^8) Reed-Solomon erasure codec behind a plain C ABI.
//
// This is the framework's native host-side codec (SURVEY.md §2.2: the one
// native component, and §7.1 "shim/"): a C-ABI boundary shaped after the
// klauspost/reedsolomon Encoder interface (Encode / Verify / Reconstruct)
// so a Go host can `cgo`-link it as a drop-in backend, exactly where the
// reference links vivint/infectious (main.go:248-266).
//
// A copy of the JAX package's shim (noise_ec_tpu/shim/rs_shim.cpp) for the
// port. Bit-compatible with the port's device path by construction: the
// same primitive polynomial 0x11D (noise_ec_tpu_torch/gf/field.py) and the
// same systematic Cauchy / Vandermonde generators
// (noise_ec_tpu_torch/matrix/generators.py) — shards encoded here
// reconstruct there and vice versa.
//
// The hot loop is table-driven: each coefficient c expands to two 16-entry
// nibble tables so one byte product is two loads and a XOR, with the rows
// XOR-accumulated in place (the klauspost AVX2 kernels are the same split-
// nibble scheme in SIMD registers; -O3 autovectorizes the inner loop).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>
#include <vector>

#include "rs_shim.h"  // keeps the exported ABI and the header in sync

#if defined(__AVX2__) || defined(__SSSE3__)
#include <immintrin.h>
#endif

namespace {

constexpr int kPoly = 0x11D;  // x^8 + x^4 + x^3 + x^2 + 1
constexpr int kOrder = 256;

struct Tables {
  uint8_t exp[2 * (kOrder - 1)];
  int log[kOrder];
  Tables() {
    int x = 1;
    for (int i = 0; i < kOrder - 1; ++i) {
      exp[i] = static_cast<uint8_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & kOrder) x ^= kPoly;
    }
    log[0] = 0;  // never used: mul() guards zero operands
    for (int i = 0; i < kOrder - 1; ++i) exp[kOrder - 1 + i] = exp[i];
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t gf_mul(uint8_t a, uint8_t b) {
  if (a == 0 || b == 0) return 0;
  const Tables& t = tables();
  return t.exp[t.log[a] + t.log[b]];
}

inline uint8_t gf_inv(uint8_t a) {
  const Tables& t = tables();
  return t.exp[kOrder - 1 - t.log[a]];
}

inline uint8_t gf_pow(uint8_t a, int e) {
  if (e == 0) return 1;
  if (a == 0) return 0;
  const Tables& t = tables();
  return t.exp[(t.log[a] * e) % (kOrder - 1)];
}

// Dense k x k inversion by Gauss-Jordan; returns false when singular.
bool invert(std::vector<uint8_t>& m, int k) {
  std::vector<uint8_t> aug(static_cast<size_t>(k) * 2 * k, 0);
  for (int r = 0; r < k; ++r) {
    std::memcpy(&aug[static_cast<size_t>(r) * 2 * k], &m[static_cast<size_t>(r) * k], k);
    aug[static_cast<size_t>(r) * 2 * k + k + r] = 1;
  }
  for (int col = 0; col < k; ++col) {
    int piv = -1;
    for (int r = col; r < k; ++r) {
      if (aug[static_cast<size_t>(r) * 2 * k + col]) { piv = r; break; }
    }
    if (piv < 0) return false;
    if (piv != col) {
      for (int c = 0; c < 2 * k; ++c)
        std::swap(aug[static_cast<size_t>(piv) * 2 * k + c],
                  aug[static_cast<size_t>(col) * 2 * k + c]);
    }
    uint8_t inv_p = gf_inv(aug[static_cast<size_t>(col) * 2 * k + col]);
    for (int c = 0; c < 2 * k; ++c)
      aug[static_cast<size_t>(col) * 2 * k + c] =
          gf_mul(aug[static_cast<size_t>(col) * 2 * k + c], inv_p);
    for (int r = 0; r < k; ++r) {
      if (r == col) continue;
      uint8_t f = aug[static_cast<size_t>(r) * 2 * k + col];
      if (!f) continue;
      for (int c = 0; c < 2 * k; ++c)
        aug[static_cast<size_t>(r) * 2 * k + c] ^=
            gf_mul(f, aug[static_cast<size_t>(col) * 2 * k + c]);
    }
  }
  for (int r = 0; r < k; ++r)
    std::memcpy(&m[static_cast<size_t>(r) * k],
                &aug[static_cast<size_t>(r) * 2 * k + k], k);
  return true;
}

// out[len] ^= c * in[len], split-nibble tables: the product of c with any
// byte b is lo[b & 15] ^ hi[b >> 4]. On x86 the two 16-entry tables live in
// vector registers and pshufb does 32 (AVX2) or 16 (SSSE3) byte lookups per
// instruction — the same scheme as klauspost/reedsolomon's assembly kernels.
void mul_add_row(uint8_t* out, const uint8_t* in, uint8_t c, size_t len) {
  if (c == 0) return;
  if (c == 1) {
    size_t i = 0;
    for (; i + 8 <= len; i += 8) {
      uint64_t a, b;
      std::memcpy(&a, out + i, 8);
      std::memcpy(&b, in + i, 8);
      a ^= b;
      std::memcpy(out + i, &a, 8);
    }
    for (; i < len; ++i) out[i] ^= in[i];
    return;
  }
  alignas(32) uint8_t lo[16], hi[16];
  for (int v = 0; v < 16; ++v) {
    lo[v] = gf_mul(c, static_cast<uint8_t>(v));
    hi[v] = gf_mul(c, static_cast<uint8_t>(v << 4));
  }
  size_t i = 0;
#if defined(__GFNI__) && defined(__AVX512BW__)
  // GFNI: mul-by-c is GF(2)-linear, i.e. an 8x8 bit-matrix (the same
  // bitsliced formulation as the CUDA kernels — gf/bitmatrix.py);
  // gf2p8affineqb applies it to 64 bytes per instruction for ANY
  // polynomial, unlike gf2p8mulb which hardwires AES's 0x11B.
  {
    uint64_t aff = 0;
    uint8_t col[8];
    for (int k = 0; k < 8; ++k) col[k] = gf_mul(c, static_cast<uint8_t>(1 << k));
    for (int j = 0; j < 8; ++j) {  // A.byte[7-j] = row for output bit j
      uint64_t row = 0;
      for (int k = 0; k < 8; ++k) row |= static_cast<uint64_t>((col[k] >> j) & 1) << k;
      aff |= row << (8 * (7 - j));
    }
    const __m512i A = _mm512_set1_epi64(static_cast<long long>(aff));
    for (; i + 64 <= len; i += 64) {
      __m512i x = _mm512_loadu_si512(reinterpret_cast<const void*>(in + i));
      __m512i y = _mm512_loadu_si512(reinterpret_cast<const void*>(out + i));
      y = _mm512_xor_si512(y, _mm512_gf2p8affine_epi64_epi8(x, A, 0));
      _mm512_storeu_si512(reinterpret_cast<void*>(out + i), y);
    }
  }
#endif
#if defined(__AVX2__)
  {
    const __m256i vlo = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(lo)));
    const __m256i vhi = _mm256_broadcastsi128_si256(
        _mm_load_si128(reinterpret_cast<const __m128i*>(hi)));
    const __m256i mask = _mm256_set1_epi8(0x0F);
    for (; i + 32 <= len; i += 32) {
      __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
      __m256i y = _mm256_loadu_si256(reinterpret_cast<__m256i*>(out + i));
      __m256i pl = _mm256_shuffle_epi8(vlo, _mm256_and_si256(x, mask));
      __m256i ph = _mm256_shuffle_epi8(
          vhi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
      y = _mm256_xor_si256(y, _mm256_xor_si256(pl, ph));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i), y);
    }
  }
#elif defined(__SSSE3__)
  {
    const __m128i vlo = _mm_load_si128(reinterpret_cast<const __m128i*>(lo));
    const __m128i vhi = _mm_load_si128(reinterpret_cast<const __m128i*>(hi));
    const __m128i mask = _mm_set1_epi8(0x0F);
    for (; i + 16 <= len; i += 16) {
      __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + i));
      __m128i y = _mm_loadu_si128(reinterpret_cast<__m128i*>(out + i));
      __m128i pl = _mm_shuffle_epi8(vlo, _mm_and_si128(x, mask));
      __m128i ph =
          _mm_shuffle_epi8(vhi, _mm_and_si128(_mm_srli_epi64(x, 4), mask));
      y = _mm_xor_si128(y, _mm_xor_si128(pl, ph));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i), y);
    }
  }
#endif
  for (; i < len; ++i)
    out[i] = static_cast<uint8_t>(out[i] ^ lo[in[i] & 0x0F] ^ hi[in[i] >> 4]);
}

// ---------------------------------------------------------------------------
// GF(2^16) tier (poly 0x1100B — gf/field.py POLY_GF65536). Mirrors the
// GF(2^8) hot kernels on uint16 symbols so the wide field's host decode
// (syndrome scan, magnitude solves, fused single-row decode) runs native
// instead of NumPy table gathers (~12-16x slower measured at equal bytes).
// The mul-by-constant kernel is the nibble-shuffle scheme (klauspost
// galois16-style): c * x = T0[x&15] ^ T1[x>>4&15] ^ T2[x>>8&15] ^
// T3[x>>12], four 16-entry uint16 tables built per coefficient; on AVX2
// each table runs as two pshufb byte-lookups (lo/hi result bytes) with
// the nibble index duplicated into both bytes of each 16-bit lane.

constexpr int kPoly16 = 0x1100B;
constexpr int kOrder16 = 1 << 16;

struct Tables16 {
  std::vector<uint16_t> exp;
  std::vector<int32_t> log;
  Tables16() : exp(2 * (kOrder16 - 1)), log(kOrder16) {
    int x = 1;
    for (int i = 0; i < kOrder16 - 1; ++i) {
      exp[i] = static_cast<uint16_t>(x);
      log[x] = i;
      x <<= 1;
      if (x & kOrder16) x ^= kPoly16;
    }
    log[0] = 0;  // never used: mul16 guards zero operands
    for (int i = 0; i < kOrder16 - 1; ++i) exp[kOrder16 - 1 + i] = exp[i];
  }
};

const Tables16& tables16() {
  static const Tables16 t;
  return t;
}

inline uint16_t gf16_mul(uint16_t a, uint16_t b) {
  if (a == 0 || b == 0) return 0;
  const Tables16& t = tables16();
  return t.exp[t.log[a] + t.log[b]];
}

inline uint16_t gf16_inv_sym(uint16_t a) {
  const Tables16& t = tables16();
  return t.exp[kOrder16 - 1 - t.log[a]];
}

// out[len] ^= c * in[len] over GF(2^16); len in SYMBOLS.
void mul_add_row16(uint16_t* out, const uint16_t* in, uint16_t c, size_t len) {
  if (c == 0) return;
  if (c == 1) {
    size_t i = 0;
    for (; i + 4 <= len; i += 4) {
      uint64_t a, b;
      std::memcpy(&a, out + i, 8);
      std::memcpy(&b, in + i, 8);
      a ^= b;
      std::memcpy(out + i, &a, 8);
    }
    for (; i < len; ++i) out[i] ^= in[i];
    return;
  }
  alignas(32) uint16_t tab[4][16];
  for (int n = 0; n < 4; ++n)
    for (int v = 0; v < 16; ++v)
      tab[n][v] = gf16_mul(c, static_cast<uint16_t>(v << (4 * n)));
  size_t i = 0;
#if defined(__GFNI__) && defined(__AVX512BW__)
  // Multiplication by c over GF(2^16) is GF(2)-linear: a 16x16 bit
  // matrix, i.e. four 8x8 blocks over the (lo, hi) bytes of each symbol
  // (out_lo = A00*lo ^ A01*hi; out_hi = A10*lo ^ A11*hi). gf2p8affineqb
  // applies an 8x8 block to every byte lane, so no deinterleave is
  // needed: u16 shifts place the wanted source byte in the wanted lane
  // and byte masks keep the half each block contributes — ~12 vector ops
  // per 64 bytes vs ~140 for the nibble-shuffle path below.
  {
    auto block_aff = [&](int outhalf, int inhalf) -> __m512i {
      uint64_t aff = 0;
      for (int j = 0; j < 8; ++j) {  // output bit j of the out byte
        uint64_t row = 0;
        for (int b = 0; b < 8; ++b) {  // input bit b of the in byte
          uint16_t col = gf16_mul(c, static_cast<uint16_t>(1u << (b + 8 * inhalf)));
          row |= static_cast<uint64_t>((col >> (j + 8 * outhalf)) & 1) << b;
        }
        aff |= row << (8 * (7 - j));
      }
      return _mm512_set1_epi64(static_cast<long long>(aff));
    };
    const __m512i a00 = block_aff(0, 0), a01 = block_aff(0, 1);
    const __m512i a10 = block_aff(1, 0), a11 = block_aff(1, 1);
    const __m512i m00ff = _mm512_set1_epi16(0x00FF);
    for (; i + 32 <= len; i += 32) {  // 32 u16 symbols = 64 bytes
      __m512i x = _mm512_loadu_si512(reinterpret_cast<const void*>(in + i));
      __m512i hi_even = _mm512_srli_epi16(x, 8);  // hi byte -> even lane
      __m512i lo_odd = _mm512_slli_epi16(x, 8);   // lo byte -> odd lane
      __m512i lo_out = _mm512_xor_si512(
          _mm512_gf2p8affine_epi64_epi8(x, a00, 0),
          _mm512_gf2p8affine_epi64_epi8(hi_even, a01, 0));
      __m512i hi_out = _mm512_xor_si512(
          _mm512_gf2p8affine_epi64_epi8(lo_odd, a10, 0),
          _mm512_gf2p8affine_epi64_epi8(x, a11, 0));
      __m512i term = _mm512_or_si512(_mm512_and_si512(lo_out, m00ff),
                                     _mm512_andnot_si512(m00ff, hi_out));
      __m512i y = _mm512_loadu_si512(reinterpret_cast<void*>(out + i));
      _mm512_storeu_si512(reinterpret_cast<void*>(out + i),
                          _mm512_xor_si512(y, term));
    }
  }
#endif
#if defined(__AVX2__)
  {
    __m256i tl[4], th[4];
    for (int n = 0; n < 4; ++n) {
      alignas(32) uint8_t lo[16], hi[16];
      for (int v = 0; v < 16; ++v) {
        lo[v] = static_cast<uint8_t>(tab[n][v] & 0xFF);
        hi[v] = static_cast<uint8_t>(tab[n][v] >> 8);
      }
      tl[n] = _mm256_broadcastsi128_si256(
          _mm_load_si128(reinterpret_cast<const __m128i*>(lo)));
      th[n] = _mm256_broadcastsi128_si256(
          _mm_load_si128(reinterpret_cast<const __m128i*>(hi)));
    }
    const __m256i m4 = _mm256_set1_epi16(0x000F);
    const __m256i m00ff = _mm256_set1_epi16(0x00FF);
    for (; i + 16 <= len; i += 16) {
      __m256i x = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
      __m256i acc = _mm256_setzero_si256();
      for (int n = 0; n < 4; ++n) {
        __m256i idx = _mm256_and_si256(_mm256_srli_epi16(x, 4 * n), m4);
        // Duplicate the nibble index into both bytes of each u16 lane so
        // one pshufb serves the lo-byte table and one the hi-byte table.
        __m256i dup = _mm256_or_si256(idx, _mm256_slli_epi16(idx, 8));
        __m256i lo = _mm256_shuffle_epi8(tl[n], dup);
        __m256i hi = _mm256_shuffle_epi8(th[n], dup);
        __m256i term = _mm256_or_si256(_mm256_and_si256(lo, m00ff),
                                       _mm256_andnot_si256(m00ff, hi));
        acc = _mm256_xor_si256(acc, term);
      }
      __m256i y = _mm256_loadu_si256(reinterpret_cast<__m256i*>(out + i));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                          _mm256_xor_si256(y, acc));
    }
  }
#endif
  for (; i < len; ++i) {
    uint16_t x = in[i];
    out[i] = static_cast<uint16_t>(
        out[i] ^ tab[0][x & 15] ^ tab[1][(x >> 4) & 15] ^
        tab[2][(x >> 8) & 15] ^ tab[3][x >> 12]);
  }
}

struct Encoder {
  int k;
  int r;
  std::vector<uint8_t> gen;  // (k + r, k) systematic generator, row-major
};

// Systematic Cauchy generator — matches matrix/generators.py:cauchy_parity:
// top block identity, parity P[i][j] = inv((k + i) ^ j).
bool build_cauchy(Encoder* e) {
  if (e->k + e->r > kOrder) return false;
  e->gen.assign(static_cast<size_t>(e->k + e->r) * e->k, 0);
  for (int i = 0; i < e->k; ++i) e->gen[static_cast<size_t>(i) * e->k + i] = 1;
  for (int i = 0; i < e->r; ++i)
    for (int j = 0; j < e->k; ++j)
      e->gen[static_cast<size_t>(e->k + i) * e->k + j] =
          gf_inv(static_cast<uint8_t>((e->k + i) ^ j));
  return true;
}

// Systematic Vandermonde — matches generators.py:vandermonde_systematic:
// raw V[row][col] = row^col, then right-multiplied by inv(V[:k]).
bool build_vandermonde(Encoder* e) {
  int n = e->k + e->r;
  if (n > kOrder) return false;
  std::vector<uint8_t> V(static_cast<size_t>(n) * e->k);
  for (int row = 0; row < n; ++row)
    for (int col = 0; col < e->k; ++col)
      V[static_cast<size_t>(row) * e->k + col] =
          gf_pow(static_cast<uint8_t>(row), col);
  std::vector<uint8_t> top(V.begin(), V.begin() + static_cast<size_t>(e->k) * e->k);
  if (!invert(top, e->k)) return false;
  e->gen.assign(static_cast<size_t>(n) * e->k, 0);
  for (int row = 0; row < n; ++row)
    for (int col = 0; col < e->k; ++col) {
      uint8_t acc = 0;
      for (int t = 0; t < e->k; ++t)
        acc ^= gf_mul(V[static_cast<size_t>(row) * e->k + t],
                      top[static_cast<size_t>(t) * e->k + col]);
      e->gen[static_cast<size_t>(row) * e->k + col] = acc;
    }
  return true;
}

// parity/verify core: out rows = M (rows x k) applied to k input rows.
// Blocked over the stripe axis so each output tile stays cache-resident
// across all k accumulations — the unblocked loop re-streams every output
// row from DRAM k times and saturates memory bandwidth long before ALUs.
void matmul_rows(const uint8_t* M, int rows, int k, const uint8_t* const* in,
                 uint8_t* const* out, size_t len) {
  constexpr size_t kTile = 32 << 10;  // fits L1d alongside one input tile
  for (size_t off = 0; off < len || off == 0; off += kTile) {
    size_t t = len - off < kTile ? len - off : kTile;
    for (int i = 0; i < rows; ++i) {
      std::memset(out[i] + off, 0, t);
      for (int j = 0; j < k; ++j)
        mul_add_row(out[i] + off, in[j] + off,
                    M[static_cast<size_t>(i) * k + j], t);
    }
    if (len == 0) break;
  }
}

}  // namespace

extern "C" {

const char* rs_shim_version() { return "noise-ec-tpu-shim/1 gf256 poly=0x11D"; }

// Generic GF(2^8) product out (r x len) = M (r x k) @ in (k x len), all
// buffers contiguous row-major. The framework's host-side decode paths
// (submatrix-inverse multiplies, Berlekamp-Welch interpolation and
// re-encode) are arbitrary-matrix products on multi-megabyte stripes; this
// runs them on the same split-nibble/GFNI kernels as rs_encode instead of
// NumPy table gathers. Returns 0 on success.
int rs_matmul(const uint8_t* M, int r, int k, const uint8_t* in, uint8_t* out,
              size_t len) {
  if (!M || !in || !out || r < 1 || k < 1) return -1;
  std::vector<const uint8_t*> ip(static_cast<size_t>(k));
  std::vector<uint8_t*> op(static_cast<size_t>(r));
  for (int j = 0; j < k; ++j) ip[j] = in + static_cast<size_t>(j) * len;
  for (int i = 0; i < r; ++i) op[i] = out + static_cast<size_t>(i) * len;
  matmul_rows(M, r, k, ip.data(), op.data(), len);
  return 0;
}

// Pointer-based variant of rs_matmul: each input/output row is its own
// buffer, so callers holding non-contiguous rows (e.g. byte views of
// separately received shards) pay zero stacking copies. Same tiled kernel.
int rs_matmul_rows(const uint8_t* M, int r, int k, const uint8_t* const* in,
                   uint8_t* const* out, size_t len) {
  if (!M || !in || !out || r < 1 || k < 1) return -1;
  matmul_rows(M, r, k, in, out, len);
  return 0;
}

// Fused syndrome kernel for the error-correcting decode (matrix/bw.py):
//   s_i = (sum_j A[i][j] * basis[j]) ^ extra[i]        i in [0, r2)
//   counts[col] = number of rows i with s_i[col] != 0
// in ONE cache-tiled pass over the inputs — the decode's bad-column scan
// costs one read of the received rows instead of matmul + XOR + compare +
// reduce round-trips through memory. s_out may be NULL (counts only) and
// counts may be NULL (syndrome only); rows are independent pointers so
// received shard buffers are consumed in place. Returns 0 on success.
int rs_syndrome_rows(const uint8_t* A, int r2, int k,
                     const uint8_t* const* basis, const uint8_t* const* extra,
                     uint8_t* const* s_out, uint8_t* counts, size_t len) {
  if (!A || !basis || !extra || r2 < 1 || k < 1) return -1;
  if (!s_out && !counts) return -1;
  constexpr size_t kTile = 32 << 10;
  std::vector<uint8_t> tmp(kTile);
  if (counts) std::memset(counts, 0, len);
  for (size_t off = 0; off < len; off += kTile) {
    size_t t = len - off < kTile ? len - off : kTile;
    for (int i = 0; i < r2; ++i) {
      std::memcpy(tmp.data(), extra[i] + off, t);
      for (int j = 0; j < k; ++j)
        mul_add_row(tmp.data(), basis[j] + off, A[static_cast<size_t>(i) * k + j], t);
      if (counts) {
        uint8_t* cnt = counts + off;
        for (size_t c = 0; c < t; ++c) cnt[c] += tmp[c] != 0;
      }
      if (s_out) std::memcpy(s_out[i] + off, tmp.data(), t);
    }
  }
  return 0;
}

// Speculative single-corrupt-row decode, fully fused (matrix/bw.py's
// whole-share fast path): ONE tiled pass over the m = k + r2 received rows
// computes the parity-check syndrome, solves the single-support error
// magnitude, verifies every check row, and applies the correction — the
// syndrome is never materialized in memory, so whole-share corruption
// costs one read of the received rows plus one written row instead of
// syndrome + solve + verify + apply round trips. Per column:
//
//   s_i  = (sum_c A[i][c] * basis[c]) ^ extra[i]       i in [0, r2)
//   z    = s_p0 * inv(A[p0][j])     (p0 = first row with A[p0][j] != 0)
//   bad  = OR_i (s_i ^ A[i][j] * z)     — zero iff rank-1 consistent
//   out_row = basis[j] ^ ((bad == 0) ? z : 0)
//   state   = 0 clean (s == 0 everywhere), 1 corrected, 2 inconsistent
//
// No per-column COUNT is needed: when bad == 0 the syndrome is exactly
// A[:, j] * z, so its nonzero-row count is nnz(A[:, j]) whenever z != 0
// — a compile-time scalar the kernel checks ONCE (> e required, true for
// every MDS check: any column of A has >= r2 - k + 1 ... in practice all
// entries nonzero for Cauchy). bad == 0 && z != 0 therefore implies
// count = nnz > e (bad column, corrected: the fixed word agrees with
// m - 1 >= m - e rows — the unique radius decode); bad == 0 && z == 0 is
// a clean column; bad != 0 goes to the general path (state 2), which
// recomputes exact counts — including columns whose <= e extra-row-only
// errors the old count test classified clean; sending those to the
// gathered re-decode costs a few columns of exact work and keeps this
// hot loop at r2 syndrome passes + 1 consistency pass with no byte-wise
// counting. state == 2 columns are gathered and re-decoded exactly by
// the Python caller. Requires 0 <= j < k, e >= 1. Returns 0 on success,
// -2 when check column j is identically zero, -3 when nnz(A[:, j]) <= e
// (the z-implies-bad-column shortcut would be unsound; never true for
// MDS checks with e = floor(r2/2) < r2 <= nnz).
int rs_decode1_fused(const uint8_t* A, int r2, int k,
                     const uint8_t* const* basis, const uint8_t* const* extra,
                     int j, int e, uint8_t* out_row, uint8_t* state,
                     size_t len) {
  if (!A || !basis || !extra || !out_row || !state) return -1;
  if (r2 < 1 || k < 1 || j < 0 || j >= k || e < 1) return -1;
  int p0 = -1, nnz = 0;
  for (int i = 0; i < r2; ++i)
    if (A[static_cast<size_t>(i) * k + j]) {
      if (p0 < 0) p0 = i;
      ++nnz;
    }
  if (p0 < 0) return -2;
  if (nnz <= e) return -3;
  const uint8_t inv_p0 = gf_inv(A[static_cast<size_t>(p0) * k + j]);
  // 16K tiles: tmp + z + bad stay cache-resident while the basis/extra
  // streams pass through (they re-stream from L2 per check row, same as
  // rs_syndrome_rows); dropping the count array let the tile double vs
  // the first version and removed four byte-wise passes per tile.
  constexpr size_t kTile = 16 << 10;
  std::vector<uint8_t> tmp(kTile), z(kTile), bad(kTile);
  for (size_t off = 0; off < len; off += kTile) {
    const size_t t = len - off < kTile ? len - off : kTile;
    // Check row p0 first: its syndrome defines the candidate magnitude z
    // (and is consistent with column j by construction).
    std::memcpy(tmp.data(), extra[p0] + off, t);
    for (int c = 0; c < k; ++c)
      mul_add_row(tmp.data(), basis[c] + off,
                  A[static_cast<size_t>(p0) * k + c], t);
    std::memset(z.data(), 0, t);
    mul_add_row(z.data(), tmp.data(), inv_p0, t);
    std::memset(bad.data(), 0, t);
    for (int i = 0; i < r2; ++i) {
      if (i == p0) continue;
      std::memcpy(tmp.data(), extra[i] + off, t);
      for (int c = 0; c < k; ++c)
        mul_add_row(tmp.data(), basis[c] + off,
                    A[static_cast<size_t>(i) * k + c], t);
      // tmp ^= A[i][j] * z: zero exactly where row i is consistent with
      // the single-support hypothesis, so OR-folding flags violations.
      mul_add_row(tmp.data(), z.data(), A[static_cast<size_t>(i) * k + j], t);
      for (size_t q = 0; q < t; ++q) bad[q] |= tmp[q];
    }
    const uint8_t* bj = basis[j] + off;
    uint8_t* oj = out_row + off;
    uint8_t* st = state + off;
    for (size_t q = 0; q < t; ++q) {
      const uint8_t zq = z[q];
      const bool consistent = bad[q] == 0;
      oj[q] = static_cast<uint8_t>(bj[q] ^ (consistent ? zq : 0));
      st[q] = static_cast<uint8_t>(
          consistent ? (zq ? 1 : 0) : 2);
    }
  }
  return 0;
}

// GF(2^16) tier of rs_matmul_rows: out[i] = sum_j M[i][j] * in[j] over
// uint16 symbols; M row-major (r x k) uint16, len in SYMBOLS.
int rs16_matmul_rows(const uint16_t* M, int r, int k,
                     const uint16_t* const* in, uint16_t* const* out,
                     size_t len) {
  if (!M || !in || !out || r < 1 || k < 1) return -1;
  if (len == 0) return 0;  // zero-length rows: nothing to write
  constexpr size_t kTile = 16 << 10;  // symbols: 32 KiB per row tile
  for (size_t off = 0; off < len; off += kTile) {
    size_t t = len - off < kTile ? len - off : kTile;
    for (int i = 0; i < r; ++i) {
      std::memset(out[i] + off, 0, 2 * t);
      for (int j = 0; j < k; ++j)
        mul_add_row16(out[i] + off, in[j] + off,
                      M[static_cast<size_t>(i) * k + j], t);
    }
  }
  return 0;
}

// GF(2^16) tier of rs_syndrome_rows; counts is uint16 per column (the
// wide field admits r2 > 255 — total shards bound is the field order).
int rs16_syndrome_rows(const uint16_t* A, int r2, int k,
                       const uint16_t* const* basis,
                       const uint16_t* const* extra,
                       uint16_t* const* s_out, uint16_t* counts, size_t len) {
  if (!A || !basis || !extra || r2 < 1 || k < 1) return -1;
  if (!s_out && !counts) return -1;
  constexpr size_t kTile = 16 << 10;
  std::vector<uint16_t> tmp(kTile);
  if (counts) std::memset(counts, 0, 2 * len);
  for (size_t off = 0; off < len; off += kTile) {
    size_t t = len - off < kTile ? len - off : kTile;
    for (int i = 0; i < r2; ++i) {
      std::memcpy(tmp.data(), extra[i] + off, 2 * t);
      for (int j = 0; j < k; ++j)
        mul_add_row16(tmp.data(), basis[j] + off,
                      A[static_cast<size_t>(i) * k + j], t);
      if (counts) {
        uint16_t* cnt = counts + off;
        for (size_t c = 0; c < t; ++c) cnt[c] += tmp[c] != 0;
      }
      if (s_out) std::memcpy(s_out[i] + off, tmp.data(), 2 * t);
    }
  }
  return 0;
}

// GF(2^16) tier of rs_decode1_fused (same count-free per-column state
// machine — see the gf256 kernel's comment; lengths in SYMBOLS, state
// stays one byte per column).
int rs16_decode1_fused(const uint16_t* A, int r2, int k,
                       const uint16_t* const* basis,
                       const uint16_t* const* extra,
                       int j, int e, uint16_t* out_row, uint8_t* state,
                       size_t len) {
  if (!A || !basis || !extra || !out_row || !state) return -1;
  if (r2 < 1 || k < 1 || j < 0 || j >= k || e < 1) return -1;
  int p0 = -1, nnz = 0;
  for (int i = 0; i < r2; ++i)
    if (A[static_cast<size_t>(i) * k + j]) {
      if (p0 < 0) p0 = i;
      ++nnz;
    }
  if (p0 < 0) return -2;
  if (nnz <= e) return -3;
  const uint16_t inv_p0 = gf16_inv_sym(A[static_cast<size_t>(p0) * k + j]);
  constexpr size_t kTile = 8 << 10;  // symbols: 16 KiB tiles like gf256
  std::vector<uint16_t> tmp(kTile), z(kTile), bad(kTile);
  for (size_t off = 0; off < len; off += kTile) {
    const size_t t = len - off < kTile ? len - off : kTile;
    std::memcpy(tmp.data(), extra[p0] + off, 2 * t);
    for (int c = 0; c < k; ++c)
      mul_add_row16(tmp.data(), basis[c] + off,
                    A[static_cast<size_t>(p0) * k + c], t);
    std::memset(z.data(), 0, 2 * t);
    mul_add_row16(z.data(), tmp.data(), inv_p0, t);
    std::memset(bad.data(), 0, 2 * t);
    for (int i = 0; i < r2; ++i) {
      if (i == p0) continue;
      std::memcpy(tmp.data(), extra[i] + off, 2 * t);
      for (int c = 0; c < k; ++c)
        mul_add_row16(tmp.data(), basis[c] + off,
                      A[static_cast<size_t>(i) * k + c], t);
      mul_add_row16(tmp.data(), z.data(),
                    A[static_cast<size_t>(i) * k + j], t);
      for (size_t q = 0; q < t; ++q) bad[q] |= tmp[q];
    }
    const uint16_t* bj = basis[j] + off;
    uint16_t* oj = out_row + off;
    uint8_t* st = state + off;
    for (size_t q = 0; q < t; ++q) {
      const uint16_t zq = z[q];
      const bool consistent = bad[q] == 0;
      oj[q] = static_cast<uint16_t>(bj[q] ^ (consistent ? zq : 0));
      st[q] = static_cast<uint8_t>(consistent ? (zq ? 1 : 0) : 2);
    }
  }
  return 0;
}

// In-place per-row scale: buf row i *= consts[i] (rows x len, contiguous).
int rs_scale_rows(const uint8_t* consts, uint8_t* buf, int rows, size_t len) {
  if (!consts || !buf || rows < 1) return -1;
  std::vector<uint8_t> tmp(len);
  for (int i = 0; i < rows; ++i) {
    uint8_t c = consts[i];
    if (c == 1) continue;
    uint8_t* row = buf + static_cast<size_t>(i) * len;
    if (c == 0) {
      std::memset(row, 0, len);
      continue;
    }
    std::memcpy(tmp.data(), row, len);
    std::memset(row, 0, len);
    mul_add_row(row, tmp.data(), c, len);
  }
  return 0;
}

// matrix_kind: 0 = cauchy (default), 1 = systematic vandermonde.
// Returns nullptr on invalid geometry.
void* rs_encoder_new(int data_shards, int parity_shards, int matrix_kind) {
  if (data_shards < 1 || parity_shards < 0 ||
      data_shards + parity_shards > kOrder)
    return nullptr;
  Encoder* e = new (std::nothrow) Encoder{data_shards, parity_shards, {}};
  if (!e) return nullptr;
  bool ok = matrix_kind == 1 ? build_vandermonde(e) : build_cauchy(e);
  if (!ok) { delete e; return nullptr; }
  return e;
}

void rs_encoder_free(void* enc) { delete static_cast<Encoder*>(enc); }

// shards: contiguous (k + r) x shard_len buffer, data rows first.
// Fills the parity rows. Returns 0 on success.
int rs_encode(void* enc, uint8_t* shards, size_t shard_len) {
  Encoder* e = static_cast<Encoder*>(enc);
  if (!e || !shards) return -1;
  std::vector<const uint8_t*> in(e->k);
  std::vector<uint8_t*> out(e->r);
  for (int j = 0; j < e->k; ++j) in[j] = shards + static_cast<size_t>(j) * shard_len;
  for (int i = 0; i < e->r; ++i)
    out[i] = shards + static_cast<size_t>(e->k + i) * shard_len;
  matmul_rows(&e->gen[static_cast<size_t>(e->k) * e->k], e->r, e->k, in.data(),
              out.data(), shard_len);
  return 0;
}

// Returns 1 when parity rows match the data rows, 0 on mismatch, <0 error.
int rs_verify(void* enc, const uint8_t* shards, size_t shard_len) {
  Encoder* e = static_cast<Encoder*>(enc);
  if (!e || !shards) return -1;
  std::vector<uint8_t> expect(static_cast<size_t>(e->r) * shard_len);
  std::vector<const uint8_t*> in(e->k);
  std::vector<uint8_t*> out(e->r);
  for (int j = 0; j < e->k; ++j) in[j] = shards + static_cast<size_t>(j) * shard_len;
  for (int i = 0; i < e->r; ++i) out[i] = &expect[static_cast<size_t>(i) * shard_len];
  matmul_rows(&e->gen[static_cast<size_t>(e->k) * e->k], e->r, e->k, in.data(),
              out.data(), shard_len);
  return std::memcmp(expect.data(), shards + static_cast<size_t>(e->k) * shard_len,
                     expect.size()) == 0
             ? 1
             : 0;
}

// present: n flags (nonzero = shard row holds valid bytes). Missing rows of
// `shards` are overwritten with the reconstructed bytes. data_only != 0
// restores only the first k rows (ReconstructData). Returns 0 on success,
// -2 with fewer than k present shards, -3 on a singular submatrix.
int rs_reconstruct(void* enc, uint8_t* shards, size_t shard_len,
                   const uint8_t* present, int data_only) {
  Encoder* e = static_cast<Encoder*>(enc);
  if (!e || !shards || !present) return -1;
  int n = e->k + e->r;
  std::vector<int> have;
  for (int i = 0; i < n && static_cast<int>(have.size()) < e->k; ++i)
    if (present[i]) have.push_back(i);
  if (static_cast<int>(have.size()) < e->k) return -2;

  // A = generator rows of the k survivors; data = inv(A) @ survivors.
  std::vector<uint8_t> A(static_cast<size_t>(e->k) * e->k);
  for (int i = 0; i < e->k; ++i)
    std::memcpy(&A[static_cast<size_t>(i) * e->k],
                &e->gen[static_cast<size_t>(have[i]) * e->k], e->k);
  if (!invert(A, e->k)) return -3;

  std::vector<const uint8_t*> surv(e->k);
  for (int i = 0; i < e->k; ++i)
    surv[i] = shards + static_cast<size_t>(have[i]) * shard_len;

  // For each missing row m: coeffs = G[m] @ inv(A), then row = coeffs @ surv.
  for (int m = 0; m < n; ++m) {
    if (present[m]) continue;
    if (data_only && m >= e->k) continue;
    std::vector<uint8_t> coeffs(e->k, 0);
    for (int c = 0; c < e->k; ++c) {
      uint8_t acc = 0;
      for (int t = 0; t < e->k; ++t)
        acc ^= gf_mul(e->gen[static_cast<size_t>(m) * e->k + t],
                      A[static_cast<size_t>(t) * e->k + c]);
      coeffs[c] = acc;
    }
    uint8_t* dst = shards + static_cast<size_t>(m) * shard_len;
    std::memset(dst, 0, shard_len);
    for (int c = 0; c < e->k; ++c) mul_add_row(dst, surv[c], coeffs[c], shard_len);
  }
  return 0;
}

}  // extern "C"
