"""Native C-ABI codec shim (SURVEY.md §7.1 ``shim/``): the port's host
codec.

A copy of ``noise_ec_tpu.shim``. ``rs_shim.cpp`` implements the GF(2^8)
(and, for the decode kernels, GF(2^16)) RS codec behind a C ABI shaped
after klauspost/reedsolomon's Encoder, so a Go host can cgo-link the same
library the Python binding loads; ``blake2b.cpp`` is the node's object
hash. :mod:`noise_ec_tpu_torch.shim.binding` builds the library at first
use into ``noise_ec_tpu_torch/_build/`` and loads it; a failed build or
load raises :class:`ShimBuildError`.
"""

from noise_ec_tpu_torch.shim.binding import (
    CppReedSolomon,
    NativeBlake2b,
    ShimBuildError,
    native_blake2b,
    build_shim,
    gf16_decode1_fused,
    gf16_matmul_rows,
    gf16_syndrome_rows,
    gf_decode1_fused,
    gf_matmul_rows,
    gf_matmul_stripes,
    gf_scale_rows,
    gf_syndrome_rows,
    shim_available,
)

__all__ = [
    "CppReedSolomon",
    "NativeBlake2b",
    "ShimBuildError",
    "native_blake2b",
    "build_shim",
    "gf16_decode1_fused",
    "gf16_matmul_rows",
    "gf16_syndrome_rows",
    "gf_decode1_fused",
    "gf_matmul_rows",
    "gf_matmul_stripes",
    "gf_scale_rows",
    "gf_syndrome_rows",
    "shim_available",
]
