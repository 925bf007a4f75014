// Timing probes for K11/K12 (csrc/dense.cu), built on their own for
// chip_smoke.py --dense-sweep and never part of the kernel library: they
// split K11's time between its copies and its product (PERF.md).
// ec_dense_probe takes ec_gf2mm_dense's arguments and `drop`, a mask of
// csrc/gf2tile.cuh's kDropProduct, kDropPlanes and kDropMasks: the work the
// kernel leaves out. Its output is meaningless unless drop is 0.
#include "dense.cu"

extern "C" int ec_dense_probe(const void* masks, const void* planes,
                              void* out, int R, int C, long long W,
                              long long ldm, long long ldp, int KT, int WR,
                              int WC, int WK, int ksplit, int vec, int drop,
                              void* stream) {
#define EC_DROP_CASE(d)                                                      \
  if (drop == (d))                                                           \
    return dense_launch<(d)>(masks, planes, out, R, C, W, ldm, ldp, KT, WR,   \
                             WC, WK, ksplit, vec, stream);
  EC_DROP_CASE(0)
  EC_DROP_CASE(kDropProduct)
  EC_DROP_CASE(kDropPlanes | kDropMasks)
  EC_DROP_CASE(kDropProduct | kDropMasks)
  EC_DROP_CASE(kDropPlanes)
#undef EC_DROP_CASE
  return (int)cudaErrorInvalidValue;
}
