"""Host-side GF products.

:func:`host_matvec` is the NumPy ground truth, ``GF.matvec_stripes``:
the port's checks hold the kernels and the shim against it.
:func:`native_matvec` is what the JAX package's ``host_matvec`` is: the
``backend="numpy"`` codec's product on the native shim
(:mod:`noise_ec_tpu_torch.shim`: split-nibble/GFNI kernels over GF(2^8),
nibble-shuffle ones over GF(2^16)), byte-identical to the ground truth. A
shim that cannot be built or loaded raises ``ShimBuildError``; the JAX
package's drops to NumPy instead. Both run NumPy for a product with no
rows, which the shim refuses.
"""

from __future__ import annotations

import numpy as np

from noise_ec_tpu_torch.gf.field import GF


def host_matvec(gf: GF, M: np.ndarray, D: np.ndarray) -> np.ndarray:
    """M (r, k) @ D (k, S) over the field, in NumPy."""
    return gf.matvec_stripes(M, D)


def native_matvec(gf: GF, M: np.ndarray, D: np.ndarray) -> np.ndarray:
    """M (r, k) @ D (k, S) over the field on the native shim (NumPy for a
    field or a shape the shim does not carry: r = 0 has no row for it to
    write, as in the JAX package's ``host_matvec``)."""
    if np.shape(M)[0] == 0:
        return gf.matvec_stripes(M, D)
    if gf.degree == 8:
        from noise_ec_tpu_torch.shim import gf_matmul_stripes

        return gf_matmul_stripes(np.asarray(M), np.asarray(D))
    if gf.degree == 16:
        from noise_ec_tpu_torch.shim import gf16_matmul_rows

        D16 = np.ascontiguousarray(D, dtype=np.uint16)
        return gf16_matmul_rows(np.asarray(M), list(D16), D16.shape[1])
    return gf.matvec_stripes(M, D)
