"""infectious-style FEC interface — the API shape the reference programs to.

Port of ``noise_ec_tpu.codec.fec`` over the port's ``ReedSolomon``, with
the reference's signature plus ``device`` ("cuda" unless the caller asks
for "cpu"). Contract reproduced from the reference's call sites
(main.go:248-266, 73-77):

- ``FEC(required, total)`` validates 1 <= required <= total <= field order
  (``infectious.NewFEC``, main.go:248);
- ``encode(data, output)`` requires ``len(data) % required == 0`` (the
  reference guarantees this upstream by adjusting k to the largest prime
  factor of the length — main.go:185-191, never by padding), emits ``total``
  shares of ``len(data)/required`` bytes, **systematic** (shares 0..k-1
  concatenate to the data), and calls ``output`` once per share
  (main.go:255-258). Unlike infectious, the Share buffers handed to the
  callback are NOT reused — ``deep_copy()`` exists for API parity but is
  never required for correctness;
- ``decode(shares)`` needs >= required distinct share numbers and performs
  error detection/correction when extra shares are present (infectious runs
  Berlekamp-Welch; so do we, per byte column — matrix/bw.py — for the MDS
  GRS constructions; par1 corrects through support-enumeration syndrome
  decoding with the golden consistent-subset search kept only as its
  fallback);
- ``rebuild(shares, output)`` regenerates the missing shares (erasure-only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from noise_ec_tpu_torch.codec.rs import ReedSolomon
from noise_ec_tpu_torch.golden.codec import (
    GoldenCodec,
    NotEnoughShardsError,
    TooManyErrorsError,
)
from noise_ec_tpu_torch.matrix.bw import (
    grs_normalizers,
    syndrome_decode_rows,
    syndrome_decode_rows_any,
)
from noise_ec_tpu_torch.matrix.linalg import gf_inv

__all__ = ["FEC", "Share", "NotEnoughShardsError", "TooManyErrorsError"]


@dataclass
class Share:
    """One erasure-coded share: its index in the codeword and its bytes."""

    number: int
    data: bytes

    def deep_copy(self) -> "Share":
        """API parity with infectious.Share.DeepCopy (the reference must
        deep-copy because infectious reuses the callback buffer —
        main.go:255-258). Our buffers are immutable bytes; this is a
        plain copy."""
        return Share(self.number, bytes(self.data))


class FEC:
    """Forward-error-correction codec with the infectious API shape."""

    def __init__(
        self,
        required: int,
        total: int,
        *,
        field: str = "gf256",
        matrix: str = "cauchy",
        backend: str = "device",
        bw_route: str = "host",
        device: str = "cuda",
    ):
        if required < 1:
            raise ValueError(f"required must be >= 1, got {required}")
        if total < required:
            raise ValueError(f"total {total} < required {required}")
        if bw_route not in ("host", "device"):
            raise ValueError(f"unknown bw_route {bw_route!r}")
        if bw_route == "device" and backend != "device":
            raise ValueError("bw_route='device' requires backend='device'")
        # Where the decode's syndrome/solve matmuls run. "host" (default)
        # keeps them in NumPy — right when shares arrive as host bytes
        # over the wire, since a device round-trip would re-ship every
        # received byte. "device" routes them through
        # DeviceCodec.syndrome_stripes and the decode1 fold — right when
        # the host<->device link is wide. Encode and the erasure products
        # run on ``backend`` either way.
        self.bw_route = bw_route
        self.k = required
        self.n = total
        self._rs = ReedSolomon(
            required, total - required, field=field, matrix=matrix,
            backend=backend, device=device,
        )
        # Error-correcting decode path (consistent-subset search) runs on the
        # golden codec with the same generator matrix.
        self._golden = GoldenCodec(required, total, field=field, matrix=matrix)
        # Decode-path instrumentation: "fast" = submatrix-inverse multiply on
        # the configured backend (the main.go:77 hot loop on the device
        # codec); "bw" = Berlekamp-Welch error correction; "subset" = golden
        # consistent-subset search (par1's only option).
        self.stats = {"fast_decodes": 0, "bw_decodes": 0, "subset_decodes": 0}
        # One source of truth for which constructions BW can decode:
        # grs_normalizers raises for kinds with no GRS representation.
        try:
            grs_normalizers(self._golden.gf, matrix, required, total)
            self._mds_grs = True
        except ValueError:
            self._mds_grs = False
        self._systematic = bool(
            np.array_equal(
                self._golden.G[:required],
                np.eye(required, dtype=self._golden.G.dtype),
            )
        )

    @property
    def required(self) -> int:
        return self.k

    @property
    def total(self) -> int:
        return self.n

    def _stripes(self, data: bytes) -> np.ndarray:
        """Validate ``data`` and split it into (k, S) symbol stripes.

        One owner for the encode-side contract: non-empty, length a
        multiple of ``required`` (infectious contract; reference comment
        main.go:260-261), and whole symbols per stripe (gf65536 needs an
        even stride — enforced by _to_sym for EVERY path, so no share can
        be emitted that decode() would later choke on).
        """
        if len(data) == 0:
            raise ValueError("cannot encode empty data")
        if len(data) % self.k:
            raise ValueError(
                f"data length {len(data)} is not a multiple of required={self.k}"
            )
        stride = len(data) // self.k
        arr = np.frombuffer(data, dtype=np.uint8).reshape(self.k, stride)
        return np.stack([self._rs._to_sym(r, "data stripe") for r in arr])

    def encode(self, data: bytes, output: Callable[[Share], None]) -> None:
        """Systematically encode ``data`` into ``total`` shares."""
        full = self._rs.encode(list(self._stripes(data)))
        for i, row in enumerate(full):
            output(Share(i, row.tobytes()))

    def encode_shares(self, data: bytes) -> list[Share]:
        """Convenience wrapper collecting the callback results."""
        out: list[Share] = []
        self.encode(data, out.append)
        return out

    def encode_single(self, data: bytes, num: int) -> Share:
        """Produce only share ``num`` (infectious ``EncodeSingle``): a data
        share is a slice of the input; a parity share is one generator row
        times the data stripes — O(k*S) instead of the full O(n*k*S)."""
        if not 0 <= num < self.n:
            raise ValueError(f"share number {num} out of range [0, {self.n})")
        D = self._stripes(data)
        stride = len(data) // self.k
        if num < self.k:
            return Share(num, data[num * stride : (num + 1) * stride])
        row = self._rs._mul(self._rs.G[num : num + 1], D)
        return Share(num, self._rs._as_bytes_arr(row[0]).tobytes())

    def decode(self, shares: Iterable[Share]) -> bytes:
        """Reassemble the original data from >= required shares.

        With more than ``required`` distinct shares, corrupted shares within
        the unique-decoding radius floor((m-k)/2) are detected and corrected
        (the guarantee infectious's Berlekamp-Welch decode gives the
        reference at main.go:77).

        The common case — k distinct consistent shares, or more that all
        agree — runs on the configured backend: the k x k submatrix inverse
        is computed on the host (tiny, O(k^3)) and the inverse x survivors
        multiply plus the consistency re-encode run on the device codec.
        Inconsistent share sets (corruption within the decoding radius)
        drop to per-column Berlekamp-Welch (matrix/bw.py) on the MDS GRS
        constructions; only par1 uses the golden consistent-subset search.
        """
        dedup_raw: dict[int, bytes] = {}
        for s in shares:
            num = int(s.number)
            if not 0 <= num < self.n:
                raise ValueError(
                    f"share number {num} out of range [0, {self.n})"
                )
            raw = bytes(s.data)
            if num in dedup_raw:
                if dedup_raw[num] != raw:
                    raise ValueError(f"conflicting copies of share {num}")
                continue
            dedup_raw[num] = raw
        if len(dedup_raw) < self.k:
            raise NotEnoughShardsError(
                f"have {len(dedup_raw)} shares, need {self.k}"
            )
        nums = sorted(dedup_raw)
        if (
            len(nums) == self.k
            and nums == list(range(self.k))
            and self._systematic
            and len({len(b) for b in dedup_raw.values()}) == 1
            and len(dedup_raw[0]) % (self._golden.gf.degree // 8) == 0
        ):
            # Systematic in-order shortcut with exactly k shares: the
            # shares ARE the data split and there is no redundancy to
            # check against (main.go:77 case) — one join, zero field ops
            # and zero numpy round-trips (the stream receive hot path).
            self.stats["fast_decodes"] += 1
            return b"".join(dedup_raw[i] for i in range(self.k))
        dedup = {
            num: self._sym(np.frombuffer(raw, dtype=np.uint8))
            for num, raw in dedup_raw.items()
        }
        if self._mds_grs:
            # MDS constructions: the syndrome decoder IS both the fast
            # path and the error-correcting path (matrix/bw.py) — one
            # (m-k) x k parity-check product flags bad columns, clean
            # systematic rows are emitted zero-copy, and corrections are
            # row XORs solved from the syndrome (the infectious Decode
            # guarantee, main.go:77).
            res = syndrome_decode_rows(
                self._golden.gf,
                self._golden.matrix_kind,
                self.k,
                self.n,
                nums,
                [dedup[i] for i in nums],
                G=self._golden.G,
                # The device route needs a closed codec breaker
                # (ops/dispatch.py): while it is open, the decode raises
                # CodecUnavailableError rather than move to the host.
                device=(
                    self._rs.device_route()
                    if self.bw_route == "device" else None
                ),
            )
            if res is None:
                m = len(nums)
                raise TooManyErrorsError(
                    f"some column has more than {(m - self.k) // 2} errors "
                    f"(m={m}, k={self.k})"
                )
            rows, touched, corrected = res
            self.stats["bw_decodes" if corrected else "fast_decodes"] += 1
            # One-copy join: untouched systematic rows ARE the received
            # bytes; only corrected rows go through a buffer view.
            return b"".join(
                dedup_raw[j]
                if not touched[j]
                else memoryview(np.ascontiguousarray(rows[j]).view(np.uint8))
                for j in range(self.k)
            )
        fast = self._decode_fast(nums, dedup)
        if fast is not None:
            self.stats["fast_decodes"] += 1
            return np.ascontiguousarray(fast).tobytes()
        # Non-MDS (par1): support-enumeration syndrome decode — the same
        # agreement guarantee as the consistent-subset search (>= m - e
        # received rows per column) in polynomial time; the exponential
        # subset search remains only as the fallback for columns no small
        # support explains (or a singular first-k basis).
        res = syndrome_decode_rows_any(
            self._golden.gf, self._golden.G, self.k, nums,
            [dedup[i] for i in nums],
        )
        if res is not None:
            rows, touched, corrected = res
            self.stats["bw_decodes" if corrected else "fast_decodes"] += 1
            return b"".join(
                dedup_raw[j]
                if not touched[j]
                else memoryview(np.ascontiguousarray(rows[j]).view(np.uint8))
                for j in range(self.k)
            )
        pairs = [(i, dedup[i]) for i in nums]
        self.stats["subset_decodes"] += 1
        data = self._golden.decode_shares(pairs)  # (k, S) symbol rows
        return np.ascontiguousarray(data).tobytes()

    def _decode_fast(
        self, nums: list[int], stripes: dict[int, np.ndarray]
    ) -> Optional[np.ndarray]:
        """Backend-accelerated decode of the first k distinct shares,
        accepted only if every received share agrees with the result.
        Returns None (caller falls back to Berlekamp-Welch, or subset
        search for par1) on a singular basis (non-MDS matrices) or any
        disagreement."""
        G = self._golden.G
        basis = nums[: self.k]
        if basis == list(range(self.k)) and self._systematic:
            # Systematic shortcut: the first k shares ARE the data rows
            # (G[:k] == I), so the inverse is the identity and the multiply
            # is a stack — the common in-order delivery case costs zero
            # field ops before the consistency check.
            data = np.stack([stripes[i] for i in basis])
        else:
            try:
                inv = gf_inv(self._golden.gf, G[basis])
            except np.linalg.LinAlgError:
                return None
            data = self._rs._mul(inv, np.stack([stripes[i] for i in basis]))
        if len(nums) == self.k:
            return data  # no redundancy to check against (main.go:77 case)
        codeword = self._rs._mul(G[nums], data)
        for row, i in enumerate(nums):
            if not np.array_equal(codeword[row], stripes[i]):
                return None
        return data

    def rebuild(
        self,
        shares: Iterable[Share],
        output: Optional[Callable[[Share], None]] = None,
    ) -> list[Share]:
        """Regenerate missing shares from any ``required`` present ones
        (erasure-only; the share numbers present are trusted)."""
        have: dict[int, np.ndarray] = {}
        size: Optional[int] = None
        for s in shares:
            if not 0 <= s.number < self.n:
                raise ValueError(f"share number {s.number} out of range [0, {self.n})")
            arr = np.frombuffer(bytes(s.data), dtype=np.uint8)
            if size is None:
                size = arr.size
            elif arr.size != size:
                raise ValueError("share lengths differ")
            if s.number in have and not np.array_equal(have[s.number], arr):
                raise ValueError(f"conflicting copies of share {s.number}")
            have[s.number] = arr
        slots: list[Optional[np.ndarray]] = [have.get(i) for i in range(self.n)]
        full = self._rs.reconstruct(slots)
        rebuilt = [
            Share(i, full[i].tobytes()) for i in range(self.n) if i not in have
        ]
        if output is not None:
            for s in rebuilt:
                output(s)
        return rebuilt

    def _sym(self, arr: np.ndarray) -> np.ndarray:
        if self._golden.gf.degree == 16:
            return arr.view("<u2")
        return arr
