"""Dense linear algebra over GF(2^m): inversion and reconstruction solves.

Reconstruction (reference call site main.go:77, inside ``infectious.Decode``)
is: take the k surviving shard rows of the generator matrix, invert that k x k
submatrix, and multiply by the survivor stripes. The inverse here is tiny
(k <= 256) and computed on the host; the big survivor multiply runs on-device.
"""

from __future__ import annotations

import numpy as np

from noise_ec_tpu_torch.gf.field import GF


def gf_inv(gf: GF, A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square GF matrix. Raises on singular."""
    A = np.asarray(A, dtype=np.int64)
    k = A.shape[0]
    if A.shape != (k, k):
        raise ValueError(f"matrix must be square, got {A.shape}")
    aug = np.concatenate([A, np.eye(k, dtype=np.int64)], axis=1)
    for col in range(k):
        pivot = None
        for row in range(col, k):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError(f"singular GF matrix (column {col})")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = gf.div(aug[col], aug[col, col]).astype(np.int64)
        # Eliminate this column from every other row (vectorized).
        factors = aug[:, col].copy()
        factors[col] = 0
        aug ^= gf.mul(factors[:, None], aug[col][None, :]).astype(np.int64)
    return aug[:, k:].astype(gf.dtype)


def independent_rows(gf: GF, G: np.ndarray, rows, k: int) -> list[int]:
    """The first k of ``rows``, in their order, whose rows of the (n, k)
    generator ``G`` raise the rank over ``gf``: a decoding basis where the
    code is not MDS (for an MDS code, the first k). Raises ValueError
    where they have rank below k."""
    basis: list[int] = []
    pivots: list[tuple[int, np.ndarray]] = []  # (column, row with 1 there)
    for i in rows:
        v = np.asarray(G[i], dtype=np.int64)
        for col, row in pivots:
            if v[col]:
                v = v ^ gf.mul(v[col], row).astype(np.int64)
        nz = np.flatnonzero(v)
        if nz.size == 0:
            continue
        pivots.append((int(nz[0]), gf.div(v, v[nz[0]]).astype(np.int64)))
        basis.append(int(i))
        if len(basis) == k:
            return basis
    raise ValueError(f"rows {list(rows)} have rank {len(basis)}, {k} "
                     "needed: the erasure pattern is undecodable")


def gf_solve(gf: GF, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A @ X = B over GF (A square)."""
    return gf.matmul(gf_inv(gf, A), B)


def reconstruction_matrix(
    gf: GF, G: np.ndarray, present_rows: list[int], wanted_rows: list[int]
) -> np.ndarray:
    """Matrix R with wanted_shards = R @ present_shards.

    ``G`` is the (n, k) generator; ``present_rows`` the k shard numbers we
    have; ``wanted_rows`` the shard numbers to (re)compute. Works for data
    *and* parity targets: data = inv(G[present]) @ survivors, then any wanted
    row is G[row] @ data, so R = G[wanted] @ inv(G[present]).
    """
    if len(present_rows) != G.shape[1]:
        raise ValueError(
            f"need exactly k={G.shape[1]} present rows, got {len(present_rows)}"
        )
    inv = gf_inv(gf, np.asarray(G)[present_rows])
    return gf.matmul(np.asarray(G)[wanted_rows], inv)
