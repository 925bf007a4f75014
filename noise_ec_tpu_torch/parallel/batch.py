"""Batched multi-object codec on one device (BASELINE config 3's batch).

Port of the single-device part of ``noise_ec_tpu.parallel.batch``
(``BatchCodec``). Encode (parity rows of G — main.go:262) and reconstruct
(inverted submatrix rows — main.go:77) are one primitive with a different
matrix, a GF(2^8) or GF(2^16) product over a batch of same-shape objects:

- the symbol entries (``matmul_batch``, ``encode_batch``,
  ``reconstruct_batch``) take host arrays ``(B, k, S)``. The reference
  folds the batch into one XLA mask product; here the batch rides the
  card's words path through one ``DeviceCodec.matmul_stripes_many``
  dispatch (the same kernels as the words entries, after a relayout into
  staging). It is never computed on the host;
- the words entries (``encode_batch_words``, ``reconstruct_batch_words``)
  take int32 word tensors ``(B, k, TW)`` already on the codec's device and
  run ``DeviceCodec.matmul_words_batch``: K1, K5 or the pipeline for a
  baked matrix, the panel or MXU kernels past it.

The reference's ``kernel=`` argument becomes ``device=`` ("cuda" unless
the caller asks for "cpu", where each kernel's plain version runs). The
mesh entries (``make_sharded_*``) and the mesh router raise
``NotImplementedError``: multi-device dispatch is ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.matrix.generators import generator_matrix
from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

_FIELDS = {"gf256": GF256, "gf65536": GF65536}

# Erasure patterns whose recovery matrix and row order a codec keeps, per
# device (a stream's chunks share one).
_PATTERNS = 64

_MESH_TODO = ("multi-device dispatch is not ported yet (ROADMAP queue 1 "
              "item 7: batch-axis sharding and the TP split over NCCL)")


def mesh_router():
    """The reference's mesh dispatch tier: not ported (``_MESH_TODO``)."""
    raise NotImplementedError(_MESH_TODO)


class BatchCodec:
    """Multi-object RS codec on one device (module doc).

    Geometry matches ``codec.ReedSolomon`` (systematic, Cauchy default);
    this class adds the batch dimension.
    """

    def __init__(self, data_shards: int, parity_shards: int, *,
                 field: str = "gf256", matrix: str = "cauchy",
                 device: str = "cuda"):
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r}")
        self.gf: GF = _FIELDS[field]()
        self.field_name = field
        self.device = device
        self._dev = None  # the DeviceCodec, built at first use
        self._patterns: dict[tuple, tuple] = {}
        self.k = data_shards
        self.r = parity_shards
        self.n = data_shards + parity_shards
        self.G = generator_matrix(self.gf, self.k, self.n, matrix)
        if not np.array_equal(self.G[: self.k],
                              np.eye(self.k, dtype=self.gf.dtype)):
            raise ValueError(
                f"matrix kind {matrix!r} is not systematic; BatchCodec "
                "requires systematic layout (same contract as "
                "codec.ReedSolomon)"
            )

    @property
    def parity_matrix(self) -> np.ndarray:
        return self.G[self.k:]

    def device_codec(self):
        """The words-path ``DeviceCodec`` on this codec's device (built
        once, so its plans are cached across calls)."""
        from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

        if self._dev is None:
            self._dev = DeviceCodec(field=self.field_name, device=self.device)
        return self._dev

    # -- symbol entries (host arrays) --------------------------------------

    def matmul_batch(self, M: np.ndarray, batch) -> np.ndarray:
        """(R, k) GF matrix x (B, k, S) symbols -> (B, R, S), one batched
        dispatch on the codec's device."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        batch = np.asarray(batch, dtype=self.gf.dtype)
        if batch.ndim != 3 or batch.shape[1] != M.shape[1]:
            raise ValueError(
                f"expected (B, {M.shape[1]}, S) symbols, got "
                f"{batch.shape}"
            )
        if batch.shape[0] == 0:
            return np.zeros((0, M.shape[0], batch.shape[2]), self.gf.dtype)
        return np.stack(self.device_codec().matmul_stripes_many(M, list(batch)))

    def encode_batch(self, batch) -> np.ndarray:
        """(B, k, S) data shards -> (B, n, S) full codewords."""
        batch = np.asarray(batch, dtype=self.gf.dtype)
        parity = self.matmul_batch(self.parity_matrix, batch)
        return np.concatenate([batch, parity], axis=1)

    def reconstruct_batch(self, batch_present,
                          present: list[int]) -> np.ndarray:
        """Rebuild all missing shards for a batch sharing one erasure
        pattern.

        ``batch_present``: (B, len(present), S) — rows of each codeword
        that survived, in ``present`` index order (>= k of them; the first
        k of sorted ``present`` form the basis). Returns (B, n, S) full
        codewords.
        """
        bp = np.asarray(batch_present, dtype=self.gf.dtype)
        sel, R, order = self._pattern(present)
        if R is None:
            return bp[:, order]
        filled = self.matmul_batch(R, bp[:, sel])
        return np.concatenate([bp, filled], axis=1)[:, order]

    # -- words entries (device-resident) -----------------------------------

    def encode_batch_words(self, words: torch.Tensor) -> torch.Tensor:
        """(B, k, TW) int32 words on the codec's device -> (B, n, TW) full
        codewords as words (the data rows, then the parity rows)."""
        parity = self.device_codec().matmul_words_batch(
            self.parity_matrix, words)
        return torch.cat([words, parity], dim=1)

    def reconstruct_batch_words(self, words_present: torch.Tensor,
                                present: list[int]) -> torch.Tensor:
        """Words-path batch rebuild: (B, len(present), TW) int32 words on
        the codec's device -> (B, n, TW), with :meth:`reconstruct_batch`'s
        row semantics. One plan per erasure pattern, cached by the
        ``DeviceCodec`` like every other matrix."""
        sel, R, order = self._pattern(present, words_present.device)
        if R is None:
            return words_present.index_select(1, order)
        sub = words_present.index_select(1, sel)
        filled = self.device_codec().matmul_words_batch(R, sub)
        return torch.cat([words_present, filled], dim=1).index_select(
            1, order)

    def _pattern(self, present: list[int], device=None) -> tuple:
        """(sel, R, order) for an erasure pattern, cached per device: the
        first k of sorted ``present`` form the basis, at positions ``sel``
        of the present rows; R (None when nothing is missing) rebuilds the
        missing rows from them; codeword row i is row ``order[i]`` of the
        present rows followed by the rebuilt ones. ``sel`` and ``order``
        are tuples, or with ``device`` index tensors on it, uploaded once:
        a copy from pageable host memory would wait for the device's
        stream."""
        key = (tuple(present), None if device is None else str(device))
        hit = self._patterns.get(key)
        if hit is not None:
            return hit
        if len(present) < self.k:
            raise ValueError(
                f"need >= {self.k} present shards, got {len(present)}")
        if len(set(present)) != len(present) or not all(
                0 <= i < self.n for i in present):
            raise ValueError(f"present rows {present} are not distinct "
                             f"shard indices below {self.n}")
        pos = {p: i for i, p in enumerate(present)}
        basis = sorted(present)[: self.k]
        missing = [i for i in range(self.n) if i not in pos]
        pos.update((i, len(present) + j) for j, i in enumerate(missing))
        R = (reconstruction_matrix(self.gf, self.G, basis, missing)
             if missing else None)
        sel = tuple(pos[i] for i in basis)
        order = tuple(pos[i] for i in range(self.n))
        if device is not None:
            sel, order = (torch.tensor(x, device=device) for x in (sel, order))
        hit = (sel, R, order)
        if len(self._patterns) >= _PATTERNS:
            self._patterns.clear()
        self._patterns[key] = hit
        return hit

    # -- mesh entries -------------------------------------------------------

    def make_sharded_matmul(self, mesh, M, *, batch_axis: str = "batch",
                            row_axis: Optional[str] = None):
        raise NotImplementedError(_MESH_TODO)

    def make_sharded_encoder(self, mesh, *, batch_axis: str = "batch",
                             row_axis: Optional[str] = None):
        raise NotImplementedError(_MESH_TODO)

    def make_sharded_decode1(self, mesh, j: int, *,
                             batch_axis: str = "batch",
                             row_axis: Optional[str] = None):
        raise NotImplementedError(_MESH_TODO)

    def make_sharded_matmul_words(self, mesh, M, *,
                                  batch_axis: str = "batch",
                                  row_axis: Optional[str] = None):
        raise NotImplementedError(_MESH_TODO)

    def make_sharded_encoder_words(self, mesh, *, batch_axis: str = "batch",
                                   row_axis: Optional[str] = None):
        raise NotImplementedError(_MESH_TODO)
