"""klauspost/reedsolomon-style Encoder API over the CUDA/NumPy backends.

Port of ``noise_ec_tpu.codec.rs``: Encode fills parity shards from data
shards, Verify checks consistency, Reconstruct/ReconstructData fill erased
shards, Split/Join move between a byte stream and shard lists.

Semantics mirrored from klauspost (and matching the reference's observable
behavior where they overlap):

- shards are equal-length byte buffers; the first k are data, the last n-k
  parity (systematic — infectious contract, SURVEY.md §2.3 D1);
- Reconstruct is erasure-only (present shards are trusted — corruption
  detection is the signature layer's job in the reference, main.go:82-99);
- Split zero-pads the tail shard; Join takes the output length.

Backends:
- "device" (default): the geometry-cached kernels of
  ``noise_ec_tpu_torch.ops.dispatch`` on ``device`` — "cuda" unless the
  caller asks for "cpu", where the kernels' plain PyTorch versions run.
- "numpy": pure host path, its products on the native shim
  (``matrix/hostmath.py`` ``native_matvec``), as in the reference.

Behind the device backend sits the process-wide codec breaker
(ops/dispatch.py): a failed batched product is retried once, and a second
failure trips the breaker and raises ``CodecUnavailableError``, as does
every product while the breaker is open; each refusal is counted, logged
and emitted as an event, and a background canary re-closes the breaker.
Unlike the reference, which serves a tripped product from the host
arithmetic, a device codec never moves a product to the host. Only a
``RuntimeError`` the card may get over counts against the breaker; any
other error (a wrapper or planner refusing its input, a kernel that
cannot build or launch, an unported route's ``NotImplementedError``, a
lost CUDA context) propagates as it is and leaves the breaker alone.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Optional, Sequence, Union

import numpy as np

from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.matrix.generators import generator_matrix
from noise_ec_tpu_torch.matrix.hostmath import native_matvec
from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]

_rslog = logging.getLogger("noise_ec_tpu_torch.codec")

# GF(2^16) holds up to 65536 shards; its symbols are little-endian u16
# pairs of shard bytes.
_FIELDS = {"gf256": GF256, "gf65536": GF65536}

# Invertible-subset search cap for non-MDS (par1) reconstruction. The
# default constructions never search (Cauchy submatrices are always
# invertible, first candidate wins); only degenerate par1 geometries with
# many singular submatrices can walk the combination space.
SUBSET_SEARCH_CAP = 20_000


class SubsetSearchTruncated(ValueError):
    """The invertible-subset search hit :data:`SUBSET_SEARCH_CAP` before
    finding a basis.

    Distinct from the exhausted-search failure so callers can tell "this
    shard set is genuinely unreconstructable" apart from "the search was
    cut short" (klauspost's Reconstruct reports a typed error too). Retry
    with fewer present shards, or a different matrix kind.
    """


class ReedSolomon:
    """RS(k = data_shards, n = data_shards + parity_shards) erasure codec.

    The reference's defaults are data_shards=4, parity_shards=2
    (totalShards=6, minimumNeededShards=4 — main.go:34-35).
    """

    def __init__(
        self,
        data_shards: int,
        parity_shards: int,
        *,
        field: str = "gf256",
        matrix: str = "cauchy",
        backend: str = "device",
        device: str = "cuda",
    ):
        if data_shards < 1:
            raise ValueError("data_shards must be >= 1")
        if parity_shards < 0:
            raise ValueError("parity_shards must be >= 0")
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r}")
        self.gf: GF = _FIELDS[field]()
        self.k = data_shards
        self.r = parity_shards
        self.n = data_shards + parity_shards
        if self.n > self.gf.order:
            raise ValueError(f"total shards {self.n} exceeds field order {self.gf.order}")
        self.field = field
        self.matrix_kind = matrix
        self.backend = backend
        self.G = generator_matrix(self.gf, self.k, self.n, matrix)
        if not np.array_equal(self.G[: self.k], np.eye(self.k, dtype=self.gf.dtype)):
            raise ValueError(
                f"matrix kind {matrix!r} is not systematic; ReedSolomon requires "
                "systematic layout"
            )
        if backend == "device":
            from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

            self._dev: Optional["DeviceCodec"] = DeviceCodec(
                field=field, device=device
            )
        elif backend == "numpy":
            self._dev = None
        else:
            raise ValueError(f"unknown backend {backend!r}")

    @property
    def _breaker(self):
        """The process-wide device-route breaker (ops/dispatch.py), read
        at each call so a replaced breaker takes effect; None on the
        numpy backend."""
        if self._dev is None:
            return None
        from noise_ec_tpu_torch.ops.dispatch import codec_breaker

        return codec_breaker()

    # -- internals ---------------------------------------------------------

    def _mul(self, M: np.ndarray, D: np.ndarray) -> np.ndarray:
        """One matrix x stripes product, routed THROUGH the live-path
        coalescer (ops/coalesce.py): concurrent same-(matrix, shape)
        requests batch into a single device dispatch and fan back out. An
        uncontended call flushes immediately (the coalescer never taxes
        the solo path)."""
        from noise_ec_tpu_torch.ops.coalesce import (
            coalesce_cutoff_bytes,
            coalescer,
        )

        D = np.asarray(D)
        empty = self._empty_product(M, D.shape)
        if empty is not None:
            return empty
        cutoff_device = self._dev.device if self._dev is not None else "cpu"
        if D.nbytes > coalesce_cutoff_bytes(cutoff_device):
            # Compute-bound regime (ops/coalesce.py cutoff): batching a
            # payload this large amortizes nothing — dispatch directly.
            return self._mul_batch(M, [D])[0]
        return coalescer().submit(
            self._mul_key(M, D.shape, D.dtype), self._batch_fn(M), D
        )

    def matmul_many(self, M: np.ndarray, Ds: Sequence[np.ndarray]) -> list:
        """Explicit batched ``_mul``: B same-shape products through one
        coalesced dispatch (the repair engine's group reconstruct rides
        this, sharing the coalescer's queue with live traffic)."""
        from noise_ec_tpu_torch.ops.coalesce import coalescer

        Ds = [np.asarray(D) for D in Ds]
        if not Ds:
            return []
        empty = self._empty_product(M, Ds[0].shape)
        if empty is not None:
            return [empty.copy() for _ in Ds]
        return coalescer().submit_many(
            self._mul_key(M, Ds[0].shape, Ds[0].dtype),
            self._batch_fn(M), Ds,
        )

    def _empty_product(self, M: np.ndarray, shape: tuple):
        """The (r, S) zeros of a product with no rows or no width, or None.

        Such a product is the reference's empty array on either backend.
        It runs nowhere, so it never reaches the coalescer, the device
        gate or the breaker: a caller's empty product is no device
        failure."""
        r, k = np.shape(M)
        if r and k and shape[-1]:
            return None
        return np.zeros((r, shape[-1]), self.gf.dtype)

    def _mul_key(self, M: np.ndarray, shape: tuple, dtype) -> tuple:
        """Coalescer bucket key: everything that must match for two
        requests to legally share one batched dispatch."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        digest = hashlib.blake2b(M.tobytes(), digest_size=12).digest()
        where = str(self._dev.device) if self._dev is not None else "host"
        return (
            "mul", self.field, self.backend, where, M.shape, digest,
            tuple(shape), np.dtype(dtype).str,
        )

    def _batch_fn(self, M: np.ndarray):
        def run(Ds: list) -> list:
            return self._mul_batch(M, Ds)

        return run

    def _mul_batch(self, M: np.ndarray, Ds: list) -> list:
        """The coalesced batch body (runs on the bucket leader's thread;
        every instance sharing the bucket key produces identical bytes,
        and an error reaches every member of the batch)."""
        if self._dev is None:
            return [native_matvec(self.gf, M, D) for D in Ds]
        breaker = self._breaker
        if not breaker.allow():
            self._refuse_open()
        return self._mul_device_many(breaker, M, Ds)

    @staticmethod
    def _refuse_open():
        """Count a product refused while the breaker is not closed, and
        raise ``CodecUnavailableError``."""
        from noise_ec_tpu_torch.ops.dispatch import (
            CodecUnavailableError,
            record_codec_refusal,
        )

        record_codec_refusal("open")
        raise CodecUnavailableError(
            "the device codec's breaker is open after repeated dispatch "
            "failures; the product was not run"
        )

    def _mul_device_many(self, breaker, M: np.ndarray, Ds: list) -> list:
        """One batched device dispatch under ``breaker``: retry a failure
        once in the call, and on the second trip the breaker and raise
        ``CodecUnavailableError`` from it; the outcome is always reported,
        so a half-open probe slot is released. An error on the raise list
        (``ops.dispatch.device_error_raises``) propagates at once, leaves
        the breaker's state and the counters as they were, and gives back
        the probe slot if this call held it."""
        from noise_ec_tpu_torch.ops.dispatch import (
            CodecUnavailableError,
            device_error_raises,
            ensure_codec_prober,
            record_codec_refusal,
        )

        last_exc = None
        for _ in range(2):
            try:
                out = self._dev.matmul_stripes_many(M, Ds)
            except Exception as exc:  # noqa: BLE001 — sorted just below
                if device_error_raises(exc, self._dev.device):
                    breaker.release_probe()
                    raise
                last_exc = exc
                continue
            breaker.record_success()
            return out
        breaker.record_failure()
        ensure_codec_prober(self._dev.device)
        record_codec_refusal("error")
        _rslog.warning(
            "device codec dispatch failed twice (%s); breaker %s — "
            "refusing device products until the canary re-closes it",
            last_exc, breaker.state(),
        )
        raise CodecUnavailableError(
            f"device codec dispatch failed twice: {last_exc}"
        ) from last_exc

    def device_route(self):
        """The device codec for a caller that runs its own products on it
        (FEC's ``bw_route="device"``), checked up front: while the breaker
        is not closed, counts the refusal and raises
        ``CodecUnavailableError``; never consumes the half-open probe
        slot. None on the numpy backend."""
        if self._dev is not None and not self._breaker.closed:
            self._refuse_open()
        return self._dev

    def _to_sym(self, buf: Buffer, name: str) -> np.ndarray:
        arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
        if arr.dtype == np.uint8 and self.gf.degree == 16:
            if arr.size % 2:
                raise ValueError(f"{name}: gf65536 shards need even byte length")
            arr = arr.view("<u2")
        # No-copy fast path: every shard on the live receive path lands
        # here, and an aligned, C-contiguous buffer of the right dtype IS
        # already in symbol form — skip the generic np.array machinery
        # (which re-checks and may copy) and return the view itself
        # (tests/test_dispatch_path.py pins shares_memory).
        if (
            arr.dtype == self.gf.dtype
            and arr.flags.c_contiguous
            and arr.flags.aligned
        ):
            return arr
        return np.ascontiguousarray(arr, dtype=self.gf.dtype)

    def _gather(self, shards: Sequence[Optional[Buffer]], need_all: bool):
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shards, got {len(shards)}")
        out: list[Optional[np.ndarray]] = []
        size: Optional[int] = None
        for i, s in enumerate(shards):
            if s is None or (hasattr(s, "__len__") and len(s) == 0):
                if need_all:
                    raise ValueError(f"shard {i} missing")
                out.append(None)
                continue
            arr = self._to_sym(s, f"shard {i}")
            if size is None:
                size = arr.size
            elif arr.size != size:
                raise ValueError(
                    f"shard {i} length {arr.size} != {size} (all shards must match)"
                )
            out.append(arr)
        if size is None:
            raise ValueError("all shards missing")
        return out, size

    # -- the Encoder interface --------------------------------------------

    def encode(self, shards: Sequence[Buffer]) -> list[np.ndarray]:
        """Compute parity from the k data shards.

        Accepts either k data shards or n shards (parity entries are
        overwritten — klauspost Encode semantics). Returns the full n-shard
        list as uint8 arrays.
        """
        if len(shards) not in (self.k, self.n):
            raise ValueError(
                f"encode takes {self.k} data shards or all {self.n} shards, "
                f"got {len(shards)}"
            )
        data, _ = self._gather(
            [s for s in shards[: self.k]] + [None] * self.r, need_all=False
        )
        if any(d is None for d in data[: self.k]):
            raise ValueError("all data shards required for encode")
        D = np.stack(data[: self.k])
        parity = self._mul(self.G[self.k :], D) if self.r else np.empty((0, D.shape[1]), self.gf.dtype)
        return [self._as_bytes_arr(row) for row in D] + [
            self._as_bytes_arr(row) for row in parity
        ]

    def verify(self, shards: Sequence[Buffer]) -> bool:
        """True iff parity shards match the data shards."""
        arrs, _ = self._gather(shards, need_all=True)
        D = np.stack(arrs[: self.k])
        want = self._mul(self.G[self.k :], D) if self.r else np.empty((0, D.shape[1]), self.gf.dtype)
        have = np.stack(arrs[self.k :]) if self.r else want
        return bool(np.array_equal(want, have))

    def reconstruct(
        self, shards: Sequence[Optional[Buffer]], data_only: bool = False
    ) -> list[np.ndarray]:
        """Fill missing (None/empty) shards from any k present ones.

        Erasure-only, like klauspost Reconstruct (BASELINE config 2); the
        reference's corruption story is the signature check one layer up
        (main.go:82-99).
        """
        limit = self.k if data_only else self.n
        return self._reconstruct(shards, range(limit))

    def reconstruct_some(
        self, shards: Sequence[Optional[Buffer]], required: Sequence[bool]
    ) -> list[np.ndarray]:
        """Rebuild only the shards flagged in ``required`` (klauspost
        ``ReconstructSome``): missing shards not flagged stay None, and the
        inverse-submatrix multiply computes only the requested rows."""
        if len(required) != self.n:
            raise ValueError(
                f"required must flag all {self.n} shards, got {len(required)}"
            )
        return self._reconstruct(
            shards, [i for i, want in enumerate(required) if want]
        )

    def _reconstruct(
        self, shards: Sequence[Optional[Buffer]], wanted
    ) -> list[np.ndarray]:
        arrs, _ = self._gather(shards, need_all=False)
        present = [i for i, a in enumerate(arrs) if a is not None]
        if len(present) < self.k:
            raise ValueError(
                f"too few shards to reconstruct: have {len(present)}, need {self.k}"
            )
        missing = [i for i in wanted if arrs[i] is None]
        if missing:
            # Prefer the first k present rows; fall back over other subsets
            # for non-MDS constructions (par1) with singular submatrices.
            import itertools

            R = basis = None
            truncated = False
            candidates = itertools.combinations(present, self.k)
            for count, cand in enumerate(candidates):
                if count >= SUBSET_SEARCH_CAP:
                    truncated = True
                    break
                try:
                    R = reconstruction_matrix(self.gf, self.G, list(cand), missing)
                    basis = cand
                    break
                except np.linalg.LinAlgError:
                    continue
            if R is None:
                if truncated:
                    raise SubsetSearchTruncated(
                        f"invertible-subset search truncated at "
                        f"{SUBSET_SEARCH_CAP} of C({len(present)},{self.k}) "
                        f"candidate subsets without finding a basis "
                        f"(non-MDS matrix); the shard set may still be "
                        f"reconstructable"
                    )
                raise ValueError(
                    "no invertible subset of present shards (non-MDS matrix?)"
                )
            filled = self._mul(R, np.stack([arrs[i] for i in basis]))
            for row, i in enumerate(missing):
                arrs[i] = filled[row]
        return [self._as_bytes_arr(a) if a is not None else None for a in arrs]

    def update(
        self,
        shards: Sequence[Buffer],
        new_data: Sequence[Optional[Buffer]],
    ) -> list[np.ndarray]:
        """Incrementally recompute parity after changing some data shards
        (klauspost ``Update``). ``shards``: all n current shards;
        ``new_data``: length-k, None for unchanged entries. Returns the new
        full shard list.

        Linearity of the code makes this exact: for changed shard j with
        delta = new_j ^ old_j, parity ^= G[k:, j] x delta — O(c*r*S) for c
        changed shards instead of the full O(k*r*S) re-encode. The delta
        multiply runs on the configured backend like every other hot loop.
        """
        arrs, size = self._gather(shards, need_all=True)
        if len(new_data) != self.k:
            raise ValueError(
                f"new_data must list all {self.k} data shards (None = unchanged), "
                f"got {len(new_data)}"
            )
        changed: list[tuple[int, np.ndarray]] = []
        for j, nd in enumerate(new_data):
            if nd is None:
                continue
            arr = self._to_sym(nd, f"new data shard {j}")
            if arr.size != size:
                raise ValueError(
                    f"new data shard {j} length {arr.size} != {size}"
                )
            changed.append((j, arr))
        if changed and self.r:
            parity = np.stack(arrs[self.k:])
            if self._dev is not None:
                # Device backend: scatter the deltas into a full-width
                # zero block and reuse the ALREADY-PLANNED full parity
                # program (linearity: G[k:, cols] @ deltas ==
                # G[k:] @ scatter(deltas)). A per-subset submatrix would
                # factor and plan a fresh XOR network on the host for
                # every distinct changed-column set, against a few extra
                # zero rows through the kernel.
                delta_full = np.zeros(
                    (self.k, size), dtype=self.gf.dtype
                )
                for j, arr in changed:
                    delta_full[j] = arrs[j] ^ arr
                parity ^= self._mul(self.G[self.k:], delta_full)
            else:
                # numpy backend: the true O(c*r*S) incremental multiply
                # (the host runs arbitrary submatrices, no planning step).
                cols = [j for j, _ in changed]
                deltas = np.stack([arrs[j] ^ arr for j, arr in changed])
                parity ^= self._mul(self.G[self.k:, cols], deltas)
            for row, i in enumerate(range(self.k, self.n)):
                arrs[i] = parity[row]
        for j, arr in changed:
            arrs[j] = arr
        return [self._as_bytes_arr(a) for a in arrs]

    def reconstruct_data(self, shards: Sequence[Optional[Buffer]]) -> list[np.ndarray]:
        """Like reconstruct, but only guarantees the k data shards."""
        return self.reconstruct(shards, data_only=True)

    def split(self, data: Buffer) -> list[np.ndarray]:
        """Split a byte stream into k equal data shards (zero-padded)."""
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
        if buf.size == 0:
            raise ValueError("cannot split empty data")
        sym = self.gf.degree // 8
        shard_bytes = -(-buf.size // (self.k * sym)) * sym
        padded = np.zeros(self.k * shard_bytes, dtype=np.uint8)
        padded[: buf.size] = buf
        return list(padded.reshape(self.k, shard_bytes))

    def join(self, shards: Sequence[Buffer], out_size: int) -> bytes:
        """Concatenate the k data shards and trim to out_size bytes."""
        if len(shards) < self.k:
            raise ValueError(f"join needs the {self.k} data shards")
        parts = []
        for i in range(self.k):
            a = shards[i]
            if a is None:
                raise ValueError(f"data shard {i} missing; reconstruct first")
            parts.append(
                np.frombuffer(a, dtype=np.uint8) if not isinstance(a, np.ndarray) else a.view(np.uint8)
            )
        return np.concatenate(parts).tobytes()[:out_size]

    def _as_bytes_arr(self, row: np.ndarray) -> np.ndarray:
        return row.view(np.uint8) if self.gf.degree == 16 else row
