"""Plain GF(2^8) arithmetic in NumPy, worked out from the definitions.

GF(2^8) is the polynomials over GF(2) of degree below 8, multiplied modulo
an irreducible polynomial of degree 8, which a configuration states as
``field_poly`` (0x11D, x^8 + x^4 + x^3 + x^2 + 1, is ISA-L's and HDFS's
field); the control (``ecbench/control.py``) builds the same code over
0x11B, the AES field.

The full 256 x 256 product table is computed by carry-less multiplication
and reduction; inverses are read from it. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

from ecbench.reference.words import matmul_words

POLY = 0x11D


class Field:
    """GF(2^8) modulo ``poly`` (9 bits, the x^8 term included)."""

    order = 256

    def __init__(self, poly: int = POLY):
        if not 0x100 <= poly < 0x200:
            raise ValueError(f"poly {poly:#x} is not of degree 8")
        self.poly = poly
        a = np.arange(256, dtype=np.int64)[:, None]
        b = np.arange(256, dtype=np.int64)[None, :]
        table = np.zeros((256, 256), dtype=np.int64)
        shifted = np.broadcast_to(a, (256, 256)).copy()
        for bit in range(8):
            table ^= np.where((b >> bit) & 1, shifted, 0)
            shifted <<= 1
            shifted = np.where(shifted & 0x100, shifted ^ poly, shifted)
        self.mul_table = table.astype(np.uint8)
        ones = self.mul_table[1:, 1:] == 1
        if not np.array_equal(ones.sum(axis=1), np.ones(255)):
            raise ValueError(f"poly {poly:#x} is not irreducible")
        self.inv_table = np.zeros(256, dtype=np.uint8)
        self.inv_table[1:] = 1 + ones.argmax(axis=1)

    def mul(self, a, b) -> np.ndarray:
        """Elementwise product of two arrays of field elements."""
        return self.mul_table[np.asarray(a, np.int64), np.asarray(b, np.int64)]

    def inv(self, a) -> np.ndarray:
        a = np.asarray(a, np.int64)
        if np.any(a == 0):
            raise ZeroDivisionError("0 has no inverse")
        return self.inv_table[a]

    def matmul_words(self, M, words, block: int = 32):
        """(R, K) matrix x (B, K, TW) int32 words of four elements each."""
        return matmul_words(self.poly, M, words, block)

    def matmul(self, A, B) -> np.ndarray:
        """(m, l) x (l, p) matrix product over the field."""
        A = np.asarray(A, np.int64)
        B = np.asarray(B, np.int64)
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"shapes {A.shape} and {B.shape} do not chain")
        prods = self.mul_table[A[:, :, None], B[None, :, :]]
        return np.bitwise_xor.reduce(prods, axis=1).astype(np.uint8)

    def inverse(self, A) -> np.ndarray:
        """Gauss-Jordan inverse of a square matrix; raises when singular."""
        A = np.asarray(A, np.int64)
        k = A.shape[0]
        if A.shape != (k, k):
            raise ValueError(f"matrix must be square, got {A.shape}")
        aug = np.concatenate([A, np.eye(k, dtype=np.int64)], axis=1)
        for col in range(k):
            rows = np.nonzero(aug[col:, col])[0]
            if rows.size == 0:
                raise np.linalg.LinAlgError(f"singular matrix (column {col})")
            pivot = col + int(rows[0])
            aug[[col, pivot]] = aug[[pivot, col]]
            aug[col] = self.mul(aug[col], self.inv(aug[col, col]))
            for row in range(k):
                if row != col and aug[row, col]:
                    aug[row] ^= self.mul(aug[row, col], aug[col]).astype(
                        np.int64)
        return aug[:, k:].astype(np.uint8)

