"""Pure-NumPy Reed-Solomon codec over GF(2^8)/GF(2^16) — ground truth.

A copy of ``noise_ec_tpu.golden.codec``: the port imports nothing of the JAX
package, so it keeps its own. Capabilities mirrored from the reference's
codec contract (call sites main.go:57-61, 73-77, 248-266):

- ``NewFEC(required, total)``-style construction with validation,
- systematic encode (shares 0..k-1 are the data split),
- decode from any >= k shares, with *error detection and correction* when
  extra shares are present (infectious performs Berlekamp-Welch; here the
  golden codec uses exhaustive consistent-subset search, which has the same
  unique-decoding guarantee floor((m - k)/2) for m received shares and is
  obviously correct — the property the ground truth is for),
- erasure reconstruction of any missing shard rows.

Everything is small-scale NumPy; the fast paths live in
``noise_ec_tpu_torch.ops``.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np

from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.matrix.generators import generator_matrix
from noise_ec_tpu_torch.matrix.linalg import gf_inv, reconstruction_matrix


class NotEnoughShardsError(ValueError):
    pass


class TooManyErrorsError(ValueError):
    pass


_FIELDS = {"gf256": GF256, "gf65536": GF65536}


class GoldenCodec:
    """Reference RS(k, n) codec.

    Parameters
    ----------
    k: minimum shards needed to reconstruct (``minimumNeededShards``,
       reference main.go:35 default 4).
    n: total shards (``totalShards``, main.go:34 default 6).
    field: "gf256" (default) or "gf65536".
    matrix: "cauchy" (default), "vandermonde", or "par1".
    """

    def __init__(self, k: int, n: int, field: str = "gf256", matrix: str = "cauchy"):
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r}")
        self.gf: GF = _FIELDS[field]()
        self.k = int(k)
        self.n = int(n)
        self.field = field
        self.matrix_kind = matrix
        self.G = generator_matrix(self.gf, self.k, self.n, matrix)
        self.systematic = bool(
            np.array_equal(self.G[: self.k], np.eye(self.k, dtype=self.gf.dtype))
        )

    # -- array-level API ---------------------------------------------------

    def encode(self, data_shards: np.ndarray) -> np.ndarray:
        """(k, S) data -> (n-k, S) parity rows (systematic constructions)."""
        data_shards = self._check_data(data_shards)
        if not self.systematic:
            raise ValueError("encode() requires a systematic matrix; use encode_all()")
        return self.gf.matvec_stripes(self.G[self.k :], data_shards)

    def encode_all(self, data_shards: np.ndarray) -> np.ndarray:
        """(k, S) data -> full (n, S) codeword (works for any construction)."""
        data_shards = self._check_data(data_shards)
        return self.gf.matvec_stripes(self.G, data_shards)

    def verify(self, shards: np.ndarray) -> bool:
        """True iff the (n, S) codeword is consistent with its data rows."""
        shards = np.asarray(shards, dtype=self.gf.dtype)
        if shards.shape[0] != self.n:
            raise ValueError(f"verify needs all {self.n} rows, got {shards.shape[0]}")
        if not self.systematic:
            try:
                dec = self.decode_shares(list(enumerate(shards)), error_correction=False)
            except TooManyErrorsError:
                return False
            return bool(np.array_equal(self.encode_all(dec), shards))
        expect = self.encode(shards[: self.k])
        return bool(np.array_equal(expect, shards[self.k :]))

    def reconstruct(
        self,
        shards: Sequence[Optional[np.ndarray]],
        data_only: bool = False,
        max_subsets: int = 20000,
    ) -> list[np.ndarray]:
        """Fill in missing rows (None entries) from any k present rows.

        Mirrors klauspost ``Reconstruct``/``ReconstructData`` (the BASELINE
        metric's second config). Erasure-only: present rows are trusted.
        """
        shards = list(shards)
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} entries, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise NotEnoughShardsError(
                f"have {len(present)} shards, need {self.k}"
            )
        limit = self.k if data_only else self.n
        missing = [i for i in range(limit) if shards[i] is None]
        if not missing:
            return shards
        # Prefer the first k present rows, but fall back to other k-subsets:
        # non-MDS constructions (par1) can have singular submatrices for
        # recoverable patterns.
        R = None
        for count, basis in enumerate(itertools.combinations(present, self.k)):
            if count >= max_subsets:
                break
            try:
                R = reconstruction_matrix(self.gf, self.G, list(basis), missing)
                break
            except np.linalg.LinAlgError:
                continue
        if R is None:
            raise TooManyErrorsError(
                "no invertible k-subset of present shards (non-MDS matrix?)"
            )
        stack = np.stack([np.asarray(shards[i], dtype=self.gf.dtype) for i in basis])
        filled = self.gf.matvec_stripes(R, stack)
        for row, i in enumerate(missing):
            shards[i] = filled[row]
        return shards

    def decode_shares_bw(
        self, shares: Sequence[tuple[int, np.ndarray]]
    ) -> np.ndarray:
        """(number, stripe) pairs -> (k, S) data via Berlekamp-Welch.

        The polynomial-time error-correcting decode (the algorithm
        infectious actually runs at the reference's main.go:77 call site):
        corrects up to floor((m - k)/2) wrong symbols *per byte column* —
        strictly stronger than the subset search, which models whole-share
        corruption only. MDS GRS constructions only (cauchy, vandermonde,
        vandermonde_raw); par1 has no GRS representation and must use
        :meth:`decode_shares`.
        """
        from noise_ec_tpu_torch.matrix.bw import bw_decode_stripes

        nums, stripes = self._dedup_shares(shares)
        data = bw_decode_stripes(
            self.gf, self.matrix_kind, self.k, self.n, nums,
            np.stack([stripes[i] for i in nums]),
        )
        if data is None:
            m = len(nums)
            raise TooManyErrorsError(
                f"some column has more than {(m - self.k) // 2} errors "
                f"(m={m}, k={self.k})"
            )
        return data

    def _dedup_shares(
        self, shares: Sequence[tuple[int, np.ndarray]]
    ) -> tuple[list[int], dict[int, np.ndarray]]:
        dedup: dict[int, np.ndarray] = {}
        for num, data in shares:
            num = int(num)
            if not 0 <= num < self.n:
                raise ValueError(f"share number {num} out of range [0, {self.n})")
            arr = np.asarray(data, dtype=self.gf.dtype)
            if num in dedup:
                if not np.array_equal(dedup[num], arr):
                    raise ValueError(f"conflicting copies of share {num}")
                continue
            dedup[num] = arr
        if len(dedup) < self.k:
            raise NotEnoughShardsError(f"have {len(dedup)} shares, need {self.k}")
        return sorted(dedup), dedup

    def decode_shares(
        self,
        shares: Sequence[tuple[int, np.ndarray]],
        error_correction: bool = True,
        max_subsets: int = 20000,
    ) -> np.ndarray:
        """(number, stripe) pairs -> (k, S) original data rows.

        With more than k shares and ``error_correction=True``, performs
        consistent-subset search: finds a decoding that agrees with at least
        m - floor((m - k)/2) of the m distinct received shares — the same
        unique-decoding radius as Berlekamp-Welch (which infectious's
        ``Decode`` implements). Raises TooManyErrorsError
        if no such decoding exists within ``max_subsets`` candidate subsets.
        """
        nums, stripes = self._dedup_shares(shares)
        m = len(nums)

        def try_basis(basis: tuple[int, ...]) -> tuple[Optional[np.ndarray], int]:
            # data = inv(G[basis]) @ survivors. (Not reconstruction_matrix:
            # for non-systematic G the data is a pre-image, not codeword rows.)
            try:
                inv = gf_inv(self.gf, self.G[list(basis)])
            except np.linalg.LinAlgError:
                return None, -1  # singular basis (non-MDS matrix): skip
            data = self.gf.matvec_stripes(
                inv, np.stack([stripes[i] for i in basis])
            )
            # Count agreement across all received shares.
            codeword = self.gf.matvec_stripes(self.G[nums], data)
            agree = sum(
                1 for row, i in enumerate(nums) if np.array_equal(codeword[row], stripes[i])
            )
            return data, agree

        # Unique-decoding acceptance threshold: agreement with at least
        # m - floor((m-k)/2) of the m received shares.
        needed = m - (m - self.k) // 2

        def judge(data, agree):
            """Returns data to accept, or None to keep searching."""
            if agree == m:
                return data
            if not error_correction:
                raise TooManyErrorsError("received shares are inconsistent")
            return data if agree >= needed else None

        first = tuple(nums[: self.k])
        data, agree = try_basis(first)
        if data is not None:
            accepted = judge(data, agree)
            if accepted is not None:
                return accepted
        # One bounded scan handles both jobs: find an invertible basis when
        # the first k-subset is singular (non-MDS matrices, e.g. par1), and
        # search for a decoding within the unique-decoding radius.
        for count, basis in enumerate(itertools.combinations(nums, self.k)):
            if count >= max_subsets:
                break
            if basis == first:  # already evaluated above
                continue
            d2, a2 = try_basis(basis)
            if d2 is None:
                continue
            accepted = judge(d2, a2)
            if accepted is not None:
                return accepted
            data = d2  # remember that an invertible basis exists
        if data is None:
            raise TooManyErrorsError("no invertible share subset (non-MDS matrix?)")
        raise TooManyErrorsError(
            f"no decoding agrees with >= {needed}/{m} shares"
        )

    # -- byte-level helpers ------------------------------------------------

    def split(self, data: bytes) -> np.ndarray:
        """Zero-pad bytes to a (k, S) symbol matrix (klauspost Split)."""
        buf = np.frombuffer(data, dtype=np.uint8)
        sym_bytes = self.gf.degree // 8
        row_bytes = -(-len(buf) // (self.k * sym_bytes)) * sym_bytes
        padded = np.zeros(self.k * row_bytes, dtype=np.uint8)
        padded[: len(buf)] = buf
        rows = padded.reshape(self.k, row_bytes)
        if sym_bytes == 1:
            return rows
        return rows.view("<u2")

    def join(self, data_shards: np.ndarray, out_len: int) -> bytes:
        """Inverse of split: concatenate data rows, trim padding."""
        arr = np.asarray(data_shards, dtype=self.gf.dtype)
        return arr.tobytes()[:out_len]

    def _check_data(self, data_shards: np.ndarray) -> np.ndarray:
        arr = np.atleast_2d(np.asarray(data_shards, dtype=self.gf.dtype))
        if arr.shape[0] != self.k:
            raise ValueError(f"expected {self.k} data rows, got {arr.shape[0]}")
        return arr
