// blake2b.cpp: BLAKE2b (RFC 7693) behind the shim's C ABI.
//
// Why it lives in the native shim: the host node signs and verifies every
// object over BLAKE2b-256 (the reference's hash policy, noise/crypto/blake2b
// at main.go:38-41), and on large-object streams the TWO
// whole-object hashes (sender sign + receiver verify) dominate the host
// path. This is a from-the-RFC implementation with an AVX2 compression
// function (the four-lane row formulation: each 256-bit register holds one
// row of the 4x4 state, diagonalization by lane rotation), faster than
// CPython's _blake2. Output is bit-identical to hashlib.blake2b by construction
// and cross-checked against it in tests/test_torch_shim.py.
//
// Unkeyed, sequential BLAKE2b only — exactly the reference's usage
// (digest_size 32; no key, salt, personal, or tree mode).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

struct B2Ctx {
  uint64_t h[8];
  uint64_t t0, t1;
  uint8_t buf[128];
  size_t buflen;
  int outlen;
};

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // x86 is little-endian, matching the spec's word order
}

#if defined(__AVX2__)

#if defined(__AVX512VL__)
// AVX512VL: native 64-bit lane rotates (vprorq) — one uop, shortest
// dependency chain (the G function is chain-bound, not throughput-bound).
inline __m256i ror32v(__m256i x) { return _mm256_ror_epi64(x, 32); }
inline __m256i ror24v(__m256i x) { return _mm256_ror_epi64(x, 24); }
inline __m256i ror16v(__m256i x) { return _mm256_ror_epi64(x, 16); }
inline __m256i ror63v(__m256i x) { return _mm256_ror_epi64(x, 63); }
#else
inline __m256i ror32v(__m256i x) {
  return _mm256_shuffle_epi32(x, _MM_SHUFFLE(2, 3, 0, 1));
}

inline __m256i ror24v(__m256i x) {
  const __m256i m = _mm256_setr_epi8(
      3, 4, 5, 6, 7, 0, 1, 2, 11, 12, 13, 14, 15, 8, 9, 10,
      3, 4, 5, 6, 7, 0, 1, 2, 11, 12, 13, 14, 15, 8, 9, 10);
  return _mm256_shuffle_epi8(x, m);
}

inline __m256i ror16v(__m256i x) {
  const __m256i m = _mm256_setr_epi8(
      2, 3, 4, 5, 6, 7, 0, 1, 10, 11, 12, 13, 14, 15, 8, 9,
      2, 3, 4, 5, 6, 7, 0, 1, 10, 11, 12, 13, 14, 15, 8, 9);
  return _mm256_shuffle_epi8(x, m);
}

inline __m256i ror63v(__m256i x) {
  return _mm256_or_si256(_mm256_add_epi64(x, x), _mm256_srli_epi64(x, 63));
}
#endif

void compress(B2Ctx* S, const uint8_t* block, bool last) {
  uint64_t m[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);

  __m256i a = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(S->h));
  __m256i b = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(S->h + 4));
  __m256i c = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(kIV));
  __m256i d = _mm256_xor_si256(
      _mm256_loadu_si256(reinterpret_cast<const __m256i*>(kIV + 4)),
      _mm256_setr_epi64x(static_cast<long long>(S->t0),
                         static_cast<long long>(S->t1),
                         last ? -1LL : 0LL, 0LL));
  const __m256i a0 = a, b0 = b;

  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r];
    // Column step: G over (v0,v4,v8,v12) .. (v3,v7,v11,v15).
    __m256i mx = _mm256_setr_epi64x(
        static_cast<long long>(m[s[0]]), static_cast<long long>(m[s[2]]),
        static_cast<long long>(m[s[4]]), static_cast<long long>(m[s[6]]));
    __m256i my = _mm256_setr_epi64x(
        static_cast<long long>(m[s[1]]), static_cast<long long>(m[s[3]]),
        static_cast<long long>(m[s[5]]), static_cast<long long>(m[s[7]]));
    a = _mm256_add_epi64(a, _mm256_add_epi64(b, mx));
    d = ror32v(_mm256_xor_si256(d, a));
    c = _mm256_add_epi64(c, d);
    b = ror24v(_mm256_xor_si256(b, c));
    a = _mm256_add_epi64(a, _mm256_add_epi64(b, my));
    d = ror16v(_mm256_xor_si256(d, a));
    c = _mm256_add_epi64(c, d);
    b = ror63v(_mm256_xor_si256(b, c));
    // Diagonalize: lanes rotate so columns become the diagonals
    // (v0,v5,v10,v15), (v1,v6,v11,v12), (v2,v7,v8,v13), (v3,v4,v9,v14).
    b = _mm256_permute4x64_epi64(b, 0x39);  // left 1
    c = _mm256_permute4x64_epi64(c, 0x4E);  // left 2
    d = _mm256_permute4x64_epi64(d, 0x93);  // left 3
    mx = _mm256_setr_epi64x(
        static_cast<long long>(m[s[8]]), static_cast<long long>(m[s[10]]),
        static_cast<long long>(m[s[12]]), static_cast<long long>(m[s[14]]));
    my = _mm256_setr_epi64x(
        static_cast<long long>(m[s[9]]), static_cast<long long>(m[s[11]]),
        static_cast<long long>(m[s[13]]), static_cast<long long>(m[s[15]]));
    a = _mm256_add_epi64(a, _mm256_add_epi64(b, mx));
    d = ror32v(_mm256_xor_si256(d, a));
    c = _mm256_add_epi64(c, d);
    b = ror24v(_mm256_xor_si256(b, c));
    a = _mm256_add_epi64(a, _mm256_add_epi64(b, my));
    d = ror16v(_mm256_xor_si256(d, a));
    c = _mm256_add_epi64(c, d);
    b = ror63v(_mm256_xor_si256(b, c));
    // Undiagonalize.
    b = _mm256_permute4x64_epi64(b, 0x93);
    c = _mm256_permute4x64_epi64(c, 0x4E);
    d = _mm256_permute4x64_epi64(d, 0x39);
  }

  a = _mm256_xor_si256(a0, _mm256_xor_si256(a, c));
  b = _mm256_xor_si256(b0, _mm256_xor_si256(b, d));
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(S->h), a);
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(S->h + 4), b);
}

#else  // portable fallback

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

void compress(B2Ctx* S, const uint8_t* block, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
  for (int i = 0; i < 8; ++i) v[i] = S->h[i];
  for (int i = 0; i < 8; ++i) v[8 + i] = kIV[i];
  v[12] ^= S->t0;
  v[13] ^= S->t1;
  if (last) v[14] = ~v[14];
#define B2G(A, B, C, D, X, Y)            \
  v[A] += v[B] + (X);                    \
  v[D] = rotr64(v[D] ^ v[A], 32);        \
  v[C] += v[D];                          \
  v[B] = rotr64(v[B] ^ v[C], 24);        \
  v[A] += v[B] + (Y);                    \
  v[D] = rotr64(v[D] ^ v[A], 16);        \
  v[C] += v[D];                          \
  v[B] = rotr64(v[B] ^ v[C], 63)
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r];
    B2G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    B2G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    B2G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    B2G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    B2G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    B2G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    B2G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    B2G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef B2G
  for (int i = 0; i < 8; ++i) S->h[i] ^= v[i] ^ v[8 + i];
}

#endif

inline void bump_counter(B2Ctx* S, uint64_t inc) {
  S->t0 += inc;
  if (S->t0 < inc) S->t1 += 1;
}

}  // namespace

extern "C" {

// Unkeyed sequential BLAKE2b context. digest_size in [1, 64]; NULL on a
// bad size or allocation failure.
void* b2b_new(int digest_size) {
  if (digest_size < 1 || digest_size > 64) return nullptr;
  B2Ctx* S = new (std::nothrow) B2Ctx();
  if (!S) return nullptr;
  for (int i = 0; i < 8; ++i) S->h[i] = kIV[i];
  // Parameter block word 0: depth=1, fanout=1, key length 0, digest size.
  S->h[0] ^= 0x01010000ULL ^ static_cast<uint64_t>(digest_size);
  S->t0 = S->t1 = 0;
  S->buflen = 0;
  S->outlen = digest_size;
  return S;
}

int b2b_update(void* ctx, const uint8_t* data, size_t len) {
  B2Ctx* S = static_cast<B2Ctx*>(ctx);
  if (!S || (!data && len)) return -1;
  while (len > 0) {
    if (S->buflen == 128) {
      // More input exists, so the buffered block is not the last one.
      bump_counter(S, 128);
      compress(S, S->buf, false);
      S->buflen = 0;
      // Bulk path: compress directly from the input while more than one
      // block remains (the final block must stay buffered for the
      // last-block flag).
      while (len > 128) {
        bump_counter(S, 128);
        compress(S, data, false);
        data += 128;
        len -= 128;
      }
    }
    size_t take = 128 - S->buflen;
    if (take > len) take = len;
    std::memcpy(S->buf + S->buflen, data, take);
    S->buflen += take;
    data += take;
    len -= take;
  }
  return 0;
}

int b2b_final(void* ctx, uint8_t* out) {
  B2Ctx* S = static_cast<B2Ctx*>(ctx);
  if (!S || !out) return -1;
  bump_counter(S, S->buflen);
  std::memset(S->buf + S->buflen, 0, 128 - S->buflen);
  compress(S, S->buf, true);
  std::memcpy(out, S->h, static_cast<size_t>(S->outlen));
  return 0;
}

void b2b_free(void* ctx) { delete static_cast<B2Ctx*>(ctx); }

// Independent copy of a context (hashlib allows digest() mid-stream and
// further update()s after; finalization is destructive, so the binding
// finalizes a clone). NULL on allocation failure.
void* b2b_copy(const void* ctx) {
  const B2Ctx* src = static_cast<const B2Ctx*>(ctx);
  if (!src) return nullptr;
  B2Ctx* dup = new (std::nothrow) B2Ctx();
  if (!dup) return nullptr;
  *dup = *src;
  return dup;
}

// One-shot convenience for C consumers.
int b2b_hash(const uint8_t* data, size_t len, uint8_t* out, int digest_size) {
  void* S = b2b_new(digest_size);
  if (!S) return -1;
  int rc = b2b_update(S, data, len);
  if (rc == 0) rc = b2b_final(S, out);
  b2b_free(S);
  return rc;
}

}  // extern "C"
