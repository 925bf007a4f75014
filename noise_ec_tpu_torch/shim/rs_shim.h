/* rs_shim.h: C ABI of the native GF(2^8) Reed-Solomon erasure codec.
 *
 * The boundary a Go host cgo-links (see noise_ec_tpu/shim/example/main.go)
 * exactly where the reference links vivint/infectious (main.go:248-266),
 * and the contract the Python ctypes binding (binding.py) consumes. Shaped
 * after klauspost/reedsolomon's Encoder interface: Encode / Verify /
 * Reconstruct over a contiguous (k + r) x shard_len buffer, data rows
 * first.
 *
 * Bit-compatible with the port's device path: primitive polynomial 0x11D
 * and the same systematic Cauchy / Vandermonde generators as
 * noise_ec_tpu_torch/{gf,matrix} — shards encoded here reconstruct there
 * and vice versa.
 */
#ifndef NOISE_EC_TPU_RS_SHIM_H_
#define NOISE_EC_TPU_RS_SHIM_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Version / field identification string (static storage, do not free). */
const char* rs_shim_version(void);

/* Create an encoder. matrix_kind: 0 = Cauchy (default), 1 = systematic
 * Vandermonde. Returns NULL on invalid geometry (need k >= 1, r >= 0,
 * k + r <= 256). */
void* rs_encoder_new(int data_shards, int parity_shards, int matrix_kind);

void rs_encoder_free(void* enc);

/* shards: contiguous (k + r) x shard_len buffer, data rows first.
 * Fills the parity rows from the data rows. Returns 0 on success. */
int rs_encode(void* enc, uint8_t* shards, size_t shard_len);

/* Returns 1 when the parity rows match the data rows, 0 on mismatch,
 * < 0 on error. */
int rs_verify(void* enc, const uint8_t* shards, size_t shard_len);

/* present: k + r flags (nonzero = that shard row holds valid bytes).
 * Missing rows of `shards` are overwritten with reconstructed bytes.
 * data_only != 0 restores only the first k rows (ReconstructData).
 * Returns 0 on success, -2 with fewer than k present shards, -3 on a
 * singular submatrix. */
int rs_reconstruct(void* enc, uint8_t* shards, size_t shard_len,
                   const uint8_t* present, int data_only);

/* Generic GF(2^8) product: out (r x len) = M (r x k) @ in (k x len),
 * all contiguous row-major. Returns 0 on success. */
int rs_matmul(const uint8_t* M, int r, int k, const uint8_t* in,
              uint8_t* out, size_t len);

/* In-place per-row scale: buf row i *= consts[i] ((rows x len)
 * contiguous). Returns 0 on success. */
int rs_scale_rows(const uint8_t* consts, uint8_t* buf, int rows, size_t len);

/* rs_matmul over independent row buffers (no stacking copies): out[i] =
 * sum_j M[i][j] * in[j], cache-tiled. Returns 0 on success. */
int rs_matmul_rows(const uint8_t* M, int r, int k, const uint8_t* const* in,
                   uint8_t* const* out, size_t len);

/* Fused decode syndrome: s[i] = (M-product of basis rows) ^ extra[i], and
 * counts[col] = number of nonzero rows of s at that column, one tiled
 * pass. s_out may be NULL (counts only); counts may be NULL (syndrome
 * only). Returns 0 on success. */
int rs_syndrome_rows(const uint8_t* A, int r2, int k,
                     const uint8_t* const* basis, const uint8_t* const* extra,
                     uint8_t* const* s_out, uint8_t* counts, size_t len);

/* GF(2^16) tier (poly 0x1100B), mirroring the three decode hot kernels
 * on uint16 symbols; all lengths are in SYMBOLS, matrices row-major
 * uint16. counts is uint16 per column (the wide field admits more than
 * 255 extra rows). Same return conventions as the GF(2^8) versions. */
int rs16_matmul_rows(const uint16_t* M, int r, int k,
                     const uint16_t* const* in, uint16_t* const* out,
                     size_t len);
int rs16_syndrome_rows(const uint16_t* A, int r2, int k,
                       const uint16_t* const* basis,
                       const uint16_t* const* extra,
                       uint16_t* const* s_out, uint16_t* counts,
                       size_t len);
int rs16_decode1_fused(const uint16_t* A, int r2, int k,
                       const uint16_t* const* basis,
                       const uint16_t* const* extra,
                       int j, int e, uint16_t* out_row, uint8_t* state,
                       size_t len);

/* Fused speculative single-corrupt-row decode: one tiled pass computes
 * the syndrome, verifies the single-support hypothesis {basis row j}
 * column-wise, and writes the corrected row j into out_row. state[col]:
 * 0 = clean (count <= e), 1 = corrected, 2 = unexplained (caller must
 * re-decode those columns generally). Requires 0 <= j < k, e >= 1.
 * Returns 0 on success, -2 when check column j is identically zero. */
int rs_decode1_fused(const uint8_t* A, int r2, int k,
                     const uint8_t* const* basis, const uint8_t* const* extra,
                     int j, int e, uint8_t* out_row, uint8_t* state,
                     size_t len);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* NOISE_EC_TPU_RS_SHIM_H_ */
