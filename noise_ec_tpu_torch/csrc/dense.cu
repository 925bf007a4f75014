// K11/K12: the dense-mask GF(2) product with the mask matrix as a runtime
// operand, out[r, w] = XOR over c of (masks[r, c] & planes[c, w]): (R, C)
// masks x (C, W) planes -> (R, W), all 32-bit words.
//
// Replaces noise_ec_tpu/ops/pallas_gf2mm.py _kernel (gf2_matmul_pallas,
// line 67) and _tiled_dense_kernel (gf2_matmul_pallas_tiled, line 192): the
// tiled product is positionwise over its (8, W8) positions, so it is this
// kernel on the contiguous (C, 8 * W8) view. Masks are arbitrary words, not
// only select masks: the AND takes whatever they hold.
//
// Bound on the H100: operations, one LOP3 (acc ^= m & p) per mask word and
// plane word. RS(10,4)'s (32, 80) masks over 32,768-word planes do 83.9M
// (5.0 us at 16.7e12 LOP3/s) against 14.7 MB moved (4.4 us at 3.35 TB/s),
// so the product has to run under the plane copies, not after them.
//
// Design: the product core (gf2tile.cuh, masked_kernel), as K7 runs it,
// with the masks staged by the kernel (RowMajorMasks) from the caller's
// (R, C) matrix: the matrix changes on every call, so there is no tiled
// operand to cache, and relaying it out on the device would cost more
// launches than the product. Each tile's masks travel in the same
// cp.async group as its planes, two tiles ahead of the product (a ring of
// three stages). The planes are copied 16 bytes at a time where W and the
// row stride are multiples of 4 words and the planes start 16-byte
// aligned, else one word at a time (kVec = 1); both take any mask stride
// and alignment. The wrapper picks the block shape (ops/gf2tile.py
// dense_shape): the column warps, two warps along K where the launch would
// leave the SMs under 8 warps each, and a K split over blocks (with `out`
// zeroed, the blocks XOR into it atomically) where the columns leave SMs
// without a block.
#include <stdint.h>

#include "gf2tile.cuh"

using namespace noise_ec::tile;

// (R, C) masks with row stride ldm x (C, W) planes with row stride ldp ->
// contiguous (R, W) out, at K tiles of KT planes (a multiple of 8), WR x WC
// x WK warps a block, the K tiles split over `ksplit` blocks a column tile;
// `vec` words a plane copy (4 or 1). kDrop leaves work out for the timing
// probes (csrc/dense_probe.cu).
template <int kDrop>
int dense_launch(const void* masks, const void* planes, void* out, int R,
                 int C, long long W, long long ldm, long long ldp, int KT,
                 int WR, int WC, int WK, int ksplit, int vec, void* stream) {
  if (R == 0 || W == 0 || C == 0) return cudaSuccess;
  if (KT < 8 || KT % 8 || WR < 1) return (int)cudaErrorInvalidValue;
  const int NT = (C + KT - 1) / KT;
  const int NRG = (R + kRowBlock * WR - 1) / (kRowBlock * WR);
  if (ksplit > NT) return (int)cudaErrorInvalidValue;
  const Operands a{(const uint32_t*)planes, (uint32_t*)out,
                   (const uint32_t*)masks, W, ldp, ldm, C, R, NT, 0, NT,
                   ksplit, ksplit > 1 ? kAtomicXor : kStore};
  if (vec == 4) {
    if (W % 4 || ldp % 4 || (uintptr_t)planes % 16)
      return (int)cudaErrorInvalidValue;
    return launch_masked<4, RowMajorMasks, kDrop>(a, KT, NRG, WR, WC, WK, 1,
                                                  stream);
  }
  if (vec == 1)
    return launch_masked<1, RowMajorMasks, kDrop>(a, KT, NRG, WR, WC, WK, 1,
                                                  stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ec_gf2mm_dense(const void* masks, const void* planes,
                              void* out, int R, int C, long long W,
                              long long ldm, long long ldp, int KT, int WR,
                              int WC, int WK, int ksplit, int vec,
                              void* stream) {
  return dense_launch<0>(masks, planes, out, R, C, W, ldm, ldp, KT, WR, WC,
                         WK, ksplit, vec, stream);
}
