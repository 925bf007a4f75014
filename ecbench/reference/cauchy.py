"""The systematic Cauchy generator, worked out from its definition: the
identity over P[i, j] = 1 / ((k + i) xor j), ISA-L's
``gf_gen_cauchy1_matrix``, which configurations name as ``cauchy``."""

from __future__ import annotations

import numpy as np


def generator(field, k: int, r: int) -> np.ndarray:
    """(k + r, k) systematic generator over ``field``."""
    if k < 1 or r < 0 or k + r > field.order:
        raise ValueError(f"no Cauchy code with k={k}, r={r} over "
                         f"{field.order} elements")
    G = np.zeros((k + r, k), dtype=np.uint8)
    G[:k] = np.eye(k, dtype=np.uint8)
    x = (k + np.arange(r))[:, None]
    y = np.arange(k)[None, :]
    G[k:] = field.inv(x ^ y)
    return G
