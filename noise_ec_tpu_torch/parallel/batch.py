"""Batched multi-object codec on one device or a device mesh (BASELINE
config 5).

Port of ``noise_ec_tpu.parallel.batch`` (``BatchCodec``). Encode (parity
rows of G — main.go:262) and reconstruct (inverted submatrix rows —
main.go:77) are one primitive with a different matrix, a GF(2^8) or
GF(2^16) product over a batch of same-shape objects:

- the symbol entries (``matmul_batch``, ``encode_batch``,
  ``reconstruct_batch``) take host arrays ``(B, k, S)``. The reference
  folds the batch into one XLA mask product; here the batch rides the
  card's words path through one ``DeviceCodec.matmul_stripes_many``
  dispatch (the same kernels as the words entries, after a relayout into
  staging), which shards it over the mesh router when that is enabled
  (parallel/mesh.py). It is never computed on the host;
- the words entries (``encode_batch_words``, ``reconstruct_batch_words``)
  take int32 word tensors ``(B, k, TW)`` already on the codec's device and
  run ``DeviceCodec.matmul_words_batch``: K1, K5 or the pipeline for a
  baked matrix, the panel or MXU kernels past it;
- a rebuild's basis is the first k present rows, in index order, that
  raise the generator's rank (for an MDS code the first k present). An
  ``lrc:<g>`` codec (codec/lrc.py, docs/lrc.md) also has a local tier:
  where every lost row is a data or local-parity row and the only loss of
  its group, each lost row is the XOR of its group's other k/g rows, so
  the basis is those groups' rows and R their all-ones rows;
- the mesh builders (``make_sharded_*``) run one product over a
  :class:`~noise_ec_tpu_torch.parallel.mesh.Mesh`: ``batch_axis`` is data
  parallelism over objects and ``row_axis`` tensor parallelism over the
  matrix's rows. Each position computes its objects' row slice on its own
  device and stream through the single-device path for its slice, and the
  slices are assembled in order (the reference's tiled ``all_gather``;
  across processes a ``torch.distributed`` all-gather over the group,
  parallel/multihost.py). A position that repeats another along any other
  axis computes nothing: its block is the same. What a builder returns is
  whole on every process.

The reference's ``kernel=`` argument becomes ``device=`` ("cuda" unless
the caller asks for "cpu", where each kernel's plain version runs); a
builder's devices are its mesh's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.matrix.generators import (
    generator_matrix,
    parse_lrc_kind,
)
from noise_ec_tpu_torch.matrix.linalg import (
    independent_rows,
    reconstruction_matrix,
)
from noise_ec_tpu_torch.obs.device import entry_scope
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import device_span
from noise_ec_tpu_torch.ops.pack import (
    pack_u16_bytesliced,
    unpack_u16_bytesliced,
)
from noise_ec_tpu_torch.parallel.mesh import (  # noqa: F401 (re-exported)
    Mesh,
    join_stream,
    launch_on,
    mesh_router,
)

_FIELDS = {"gf256": GF256, "gf65536": GF65536}

# Erasure patterns whose recovery matrix and row order a codec keeps, per
# device (a stream's chunks share one).
_PATTERNS = 64

# make_sharded_matmul_words' route gate, as the reference has it
# (noise_ec_tpu/parallel/batch.py:361-385 with that package's
# _BAKED_XOR_BUDGET and _BAKED_MAX_ROWS): past either bound a GF(2^8)
# matrix runs K8 per row slice, and a GF(2^16) one is refused. This is
# the reference's choice for the mesh builder and differs from
# DeviceCodec.route_for, which sends RS(200,56) to the panel route.
_MESH_XOR_BUDGET = 60_000
_MESH_MAX_ROWS = 96


class _Pattern(NamedTuple):
    """An erasure pattern's plan (:meth:`BatchCodec._pattern`)."""

    sel: tuple       # the basis rows' positions among the present rows
    R: Optional[np.ndarray]  # rebuilds the lost rows; None: none is lost
    order: tuple     # codeword row i is row order[i] of present + rebuilt
    lost: tuple      # the lost rows, in codeword order
    runs: tuple      # (src0, dst0, length): present rows -> codeword rows
    tier: Optional[str]  # "local", "global"; None: none is lost


def _runs(present: list[int]) -> tuple:
    """The present rows as runs (src0, dst0, length) of rows whose
    positions and codeword rows both rise by one: at most e + 1 runs where
    ``present`` is sorted."""
    runs: list[list[int]] = []
    for src, dst in enumerate(present):
        if runs and dst == runs[-1][1] + runs[-1][2]:
            runs[-1][2] += 1
        else:
            runs.append([src, dst, 1])
    return tuple(map(tuple, runs))


def _copy_runs(out: torch.Tensor, words: torch.Tensor, runs: tuple) -> None:
    """Copy rows of (B, P, TW) ``words`` into (B, N, TW) ``out`` by runs
    (:func:`_runs`), one slice copy each: as 8-byte elements where both
    tensors allow it, since PyTorch's strided copy moves those at about
    3.0 TB/s on an H100 and 4-byte ones at about 2.5 (PERF.md §6)."""
    wide = [x.view(torch.int64) for x in (out, words)
            if x.shape[-1] % 2 == 0 and x.stride(-1) == 1
            and x.storage_offset() % 2 == 0
            and all(st % 2 == 0 for st in x.stride()[:-1])]
    if len(wide) == 2:
        out, words = wide
    for src, dst, length in runs:
        out[:, dst:dst + length].copy_(words[:, src:src + length])


def _all_gather(out: torch.Tensor, x: torch.Tensor) -> None:
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None)
    (gather or dist.all_gather_into_tensor)(out, x)


def _as_words(x) -> torch.Tensor:
    """(B, K, TW) words as an int32 tensor (a uint32 array is viewed)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _assemble(mesh: Mesh, owners: dict, local: dict, shape: tuple,
              Bb: int, Rb: int) -> torch.Tensor:
    """The whole (B, rows, TW) product on ``mesh.home`` from the blocks
    (ib, ir) -> (tensor, stream) this process computed. Where the mesh
    spans processes, every rank contributes its blocks to one all-gather
    over the group (padded to the most any rank owns), so every process
    ends with every block."""
    import torch.distributed as dist

    home = mesh.home
    full = torch.empty(shape, dtype=torch.int32, device=home)

    def put(blk, x):
        ib, ir = blk
        full[ib * Bb:(ib + 1) * Bb, ir * Rb:(ir + 1) * Rb] = x.to(home)

    if mesh.processes is None or not (dist.is_available()
                                      and dist.is_initialized()):
        for blk, (x, stream) in local.items():
            put(blk, join_stream(x, stream))
        return full
    by_rank: dict[int, list] = {}
    for blk, (pos, _) in sorted(owners.items()):
        by_rank.setdefault(mesh.process_of(pos), []).append(blk)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = max(len(v) for v in by_rank.values())
    where = home if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.zeros((n, Bb, Rb, shape[2]), dtype=torch.int32,
                       device=where)
    for j, blk in enumerate(by_rank.get(rank, [])):
        x, stream = local[blk]
        mine[j] = join_stream(x, stream).to(where)
    gathered = torch.empty((world * n,) + tuple(mine.shape[1:]),
                           dtype=torch.int32, device=where)
    _all_gather(gathered, mine)
    for r in range(world):
        for j, blk in enumerate(by_rank.get(r, [])):
            put(blk, gathered[r * n + j])
    return full


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
        # DeviceCodecs of the mesh builders' other devices, by device.
        self._codecs: dict[str, object] = {}
        self._patterns: dict[tuple, tuple] = {}
        self.k = data_shards
        self.r = parity_shards
        self.n = data_shards + parity_shards
        # The local groups of an "lrc:<g>" kind (the local tier), else None.
        self.groups = parse_lrc_kind(matrix, self.k, self.n)
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
        dispatch on the codec's device. When the mesh dispatch tier is
        active (parallel/mesh.py), the batch axis shards over its
        "stripes" axis inside that dispatch (``matmul_stripes_many``
        consults the router), so ``encode_batch`` and ``reconstruct_batch``
        ride every device it spans."""
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
        that survived, in ``present`` index order (>= k of them; the basis
        is :meth:`_pattern`'s). Returns (B, n, S) full codewords.
        """
        bp = np.asarray(batch_present, dtype=self.gf.dtype)
        pat = self._pattern(present)
        if pat.R is None:
            return bp[:, pat.order]
        filled = self.matmul_batch(pat.R, bp[:, pat.sel])
        return np.concatenate([bp, filled], axis=1)[:, pat.order]

    # -- words entries (device-resident) -----------------------------------

    def encode_batch_words(self, words: torch.Tensor) -> torch.Tensor:
        """(B, k, TW) int32 words on the codec's device -> (B, n, TW) full
        codewords as words (the data rows, then the parity rows). During a
        ``torch.profiler`` capture the call opens its spans and times its
        device work (obs/trace.py)."""
        with entry_scope("batch.encode_words", "encode_batch_words",
                         words.device):
            parity = self.device_codec().matmul_words_batch(
                self.parity_matrix, words)
            with device_span("batch.cat"):
                return torch.cat([words, parity], dim=1)

    def reconstruct_batch_words(self, words_present: torch.Tensor,
                                present: list[int]) -> torch.Tensor:
        """Words-path batch rebuild: (B, len(present), TW) int32 words on
        the codec's device -> (B, n, TW), with :meth:`reconstruct_batch`'s
        row semantics. One plan per erasure pattern, cached by the
        ``DeviceCodec`` like every other matrix.

        The codeword is written once where the product runs on K5
        (``DeviceCodec.writes_in_place``): each run of present rows is one
        slice copy into its codeword rows (``batch.assemble``), and K5
        reads the basis rows where they lie and stores the lost rows in
        place. Elsewhere the basis rows are gathered (``batch.select``)
        and the codeword is the product concatenated to the present rows
        and put in order (``batch.cat``). Either counts in
        ``noise_ec_batch_assembly_total{path}``. An ``lrc:<g>`` codec
        counts its rebuilt and basis rows by tier (:meth:`_count_tier`),
        and a local heal's product opens ``batch.heal_local``. Spans and
        device time as :meth:`encode_batch_words`."""
        with entry_scope("batch.reconstruct_words",
                         "reconstruct_batch_words", words_present.device):
            with device_span("batch.pattern"):
                pat = self._pattern(present, words_present.device)
            B, _, TW = words_present.shape
            self._count_tier(pat, B)
            dev = self.device_codec()
            if pat.R is not None and not dev.writes_in_place(pat.R,
                                                             words_present):
                self._count_assembly("gathered")
                with device_span("batch.select"):
                    sub = words_present.index_select(1, pat.sel)
                filled = self._product(dev, pat, sub)
                with device_span("batch.cat"):
                    return torch.cat([words_present, filled],
                                     dim=1).index_select(1, pat.order)
            self._count_assembly("in_place")
            out = torch.empty((B, self.n, TW), dtype=torch.int32,
                              device=words_present.device)
            if pat.R is not None:
                out = self._product(dev, pat, words_present, rows=pat.sel,
                                    out=out, out_rows=pat.lost)
            with device_span("batch.assemble"):
                _copy_runs(out, words_present, pat.runs)
            return out

    @staticmethod
    def _product(dev, pat: _Pattern, words: torch.Tensor, **maps):
        """The rebuild's product R x basis rows; a local tier's opens
        ``batch.heal_local`` while a capture records."""
        with (device_span("batch.heal_local") if pat.tier == "local"
              else contextlib.nullcontext()):
            return dev.matmul_words_batch(pat.R, words, **maps)

    @staticmethod
    def _count_assembly(path: str) -> None:
        default_registry().counter("noise_ec_batch_assembly_total").labels(
            entry="reconstruct_batch_words", path=path).add(1)

    def _count_tier(self, pat: _Pattern, stripes: int) -> None:
        """An ``lrc:<g>`` codec's rebuild of ``stripes`` stripes: their
        lost rows in ``noise_ec_lrc_repairs_total{tier}`` and their basis
        rows in ``noise_ec_lrc_repair_shards_read_total{tier}``."""
        if self.groups is None or pat.tier is None:
            return
        reg = default_registry()
        reg.counter("noise_ec_lrc_repairs_total").labels(
            tier=pat.tier).add(stripes * len(pat.lost))
        reg.counter("noise_ec_lrc_repair_shards_read_total").labels(
            tier=pat.tier).add(stripes * len(pat.sel))

    def _pattern(self, present: list[int], device=None) -> _Pattern:
        """The :class:`_Pattern` of an erasure pattern, cached per device.
        Its basis is the local tier's where it applies (:meth:`_local`),
        else the first k present rows, in index order, whose generator
        rows raise the rank (ValueError where the present rows have rank
        below k); it lies at positions ``sel`` of the present rows, and R
        (None when nothing is missing) rebuilds the ``lost`` rows from it;
        codeword row i is row ``order[i]`` of the present rows followed by
        the rebuilt ones. ``sel``, ``order`` and ``lost`` are tuples, or
        with ``device`` int32 index tensors on it, views of one upload: a
        copy from pageable host memory would wait for the device's stream.
        A miss counts in ``noise_ec_batch_pattern_misses_total`` under the
        entry that asked: ``reconstruct_batch_words`` with a ``device``,
        else ``reconstruct_batch``."""
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
        missing = [i for i in range(self.n) if i not in pos]
        local = self._local(missing)
        if local is not None:
            (basis, R), tier = local, "local"
        else:
            basis = independent_rows(self.gf, self.G, sorted(present),
                                     self.k)
            R, tier = None, None
            if missing:
                R = reconstruction_matrix(self.gf, self.G, basis, missing)
                tier = "global"
        pos.update((i, len(present) + j) for j, i in enumerate(missing))
        sel = tuple(pos[i] for i in basis)
        order = tuple(pos[i] for i in range(self.n))
        lost = tuple(missing)
        if device is not None:
            rows = torch.tensor(sel + lost + order, dtype=torch.int32,
                                device=device)
            k, e = len(sel), len(lost)
            sel, lost, order = rows[:k], rows[k:k + e], rows[k + e:]
        hit = _Pattern(sel, R, order, lost, _runs(list(present)), tier)
        default_registry().counter(
            "noise_ec_batch_pattern_misses_total").labels(
            entry="reconstruct_batch" if device is None
            else "reconstruct_batch_words").add(1)
        if len(self._patterns) >= _PATTERNS:
            self._patterns.clear()
        self._patterns[key] = hit
        return hit

    def _local(self, missing: list[int]):
        """The local tier of an ``lrc:<g>`` codec: where every missing row
        is a data or local-parity row and the only loss of its group
        (data rows j k/g .. (j + 1) k/g - 1 and local parity k + j), the
        basis (each missing row's group's other k/g rows, missing row by
        missing row) and R (each missing row's all-ones row over its own
        group's, block-diagonal); else None."""
        g = self.groups
        if g is None or not missing or max(missing) >= self.k + g:
            return None
        size = self.k // g
        groups = [i // size if i < self.k else i - self.k for i in missing]
        if len(set(groups)) < len(groups):
            return None
        basis: list[int] = []
        R = np.zeros((len(missing), size * len(missing)), self.gf.dtype)
        for row, (i, j) in enumerate(zip(missing, groups)):
            R[row, len(basis):len(basis) + size] = 1
            basis += [c for c in range(j * size, (j + 1) * size)
                      if c != i] + ([self.k + j] if i < self.k else [])
        return basis, R

    # -- mesh builders ------------------------------------------------------

    def _codec_on(self, device: torch.device):
        """The words-path ``DeviceCodec`` on ``device`` (this codec's own
        where it is that device): plans are uploaded per device."""
        key = str(device)
        dev = self._codecs.get(key)
        if dev is None:
            from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

            if self._dev is not None and self._dev.device == device:
                dev = self._dev
            else:
                dev = DeviceCodec(field=self.field_name, device=device)
            self._codecs[key] = dev
        return dev

    def _sharded(self, mesh: Mesh, R: int, batch_axis: str,
                 row_axis: Optional[str],
                 product: Callable, units: int) -> Callable:
        """``run((B, K, TW) words) -> (B, units * R, TW)`` int32 on
        ``mesh.home``: block (ib, ir) — objects ``ib`` of the batch axis,
        row slice ``ir`` of the row axis — is ``product(ir, device,
        words)`` -> (B / nb, units * R / nr, TW), computed by the position
        at index 0 along every other axis (module doc)."""
        names = mesh.axis_names
        for axis in (batch_axis, row_axis):
            if axis is not None and axis not in names:
                raise ValueError(f"mesh has no axis {axis!r} ({names})")
        nb = mesh.shape[batch_axis]
        nr = 1 if row_axis is None else mesh.shape[row_axis]
        if R % nr:
            raise ValueError(
                f"matrix rows {R} not divisible by mesh axis "
                f"{row_axis!r} size {nr}"
            )
        bi = names.index(batch_axis)
        ri = None if row_axis is None else names.index(row_axis)
        owners: dict[tuple, tuple] = {}
        for flat, pos in enumerate(np.ndindex(mesh.devices.shape)):
            if any(p for a, p in enumerate(pos) if a not in (bi, ri)):
                continue
            owners[(pos[bi], 0 if ri is None else pos[ri])] = (pos, flat)
        Rb = units * (R // nr)

        def run(words) -> torch.Tensor:
            words = _as_words(words)
            B, _, TW = words.shape
            if B % nb:
                raise ValueError(f"batch {B} not divisible by mesh axis "
                                 f"{batch_axis!r} size {nb}")
            Bb = B // nb
            local = {}
            for (ib, ir), (pos, flat) in owners.items():
                if not mesh.is_local(pos):
                    continue
                stream = mesh.stream(flat)
                out = launch_on(
                    mesh.devices[pos], stream,
                    lambda w, ir=ir, d=mesh.devices[pos]: product(
                        ir, d, w.contiguous()),
                    words[ib * Bb:(ib + 1) * Bb])
                local[(ib, ir)] = (out, stream)
            return _assemble(mesh, owners, local, (B, units * R, TW), Bb, Rb)

        return run

    @staticmethod
    def _row_slices(M: np.ndarray, mesh: Mesh,
                    row_axis: Optional[str]) -> list:
        nr = 1 if row_axis is None else mesh.shape.get(row_axis, 1)
        Rl = M.shape[0] // nr
        return [M[i * Rl:(i + 1) * Rl] for i in range(nr)]

    def make_sharded_matmul(self, mesh: Mesh, M: np.ndarray, *,
                            batch_axis: str = "batch",
                            row_axis: Optional[str] = None) -> Callable:
        """(B, k, S) symbols -> (B, R, S) host array over ``mesh``.

        Objects are sharded over ``batch_axis``; with ``row_axis`` the
        output rows of ``M`` are too, each position computing its row
        slice, and the slices are assembled in order (module doc). The
        symbols are staged as byte rows (GF(2^16) byte-sliced), as
        ``DeviceCodec.matmul_stripes`` stages them."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        s = self.gf.degree // 8
        slices = self._row_slices(M, mesh, row_axis)
        run = self._sharded(
            mesh, M.shape[0], batch_axis, row_axis,
            lambda ir, device, w: self._codec_on(device)._byte_rows(
                slices[ir], w, None),
            s)

        def fn(batch) -> np.ndarray:
            if isinstance(batch, torch.Tensor):
                batch = batch.cpu().numpy()
            sym = np.asarray(batch, dtype=self.gf.dtype)
            if sym.ndim != 3 or sym.shape[1] != M.shape[1]:
                raise ValueError(f"expected (B, {M.shape[1]}, S) symbols, "
                                 f"got {sym.shape}")
            B, k, S = sym.shape
            host = np.zeros((B, s * k, 4 * -(-S // 4)), dtype=np.uint8)
            for b in range(B):
                if s == 2:
                    pack_u16_bytesliced(sym[b], out=host[b])
                else:
                    host[b, :, :S] = sym[b]
            out = run(torch.from_numpy(host.view(np.int32)))
            res = out.cpu().numpy().view(np.uint8)
            if s == 2:
                return np.stack([unpack_u16_bytesliced(res[b, :, :S])
                                 for b in range(B)])
            return np.ascontiguousarray(res[:, :, :S])

        return fn

    def make_sharded_encoder(self, mesh: Mesh, *, batch_axis: str = "batch",
                             row_axis: Optional[str] = None) -> Callable:
        """Batched parity encode over the mesh: (B, k, S) -> (B, r, S)."""
        return self.make_sharded_matmul(
            mesh, self.parity_matrix, batch_axis=batch_axis,
            row_axis=row_axis)

    def make_sharded_decode1(self, mesh: Mesh, j: int, *,
                             batch_axis: str = "batch",
                             row_axis: Optional[str] = None) -> Callable:
        """Batched single-corrupt-row decode step over the mesh.

        (B, n, S) received codewords (all n shares, systematic order) ->
        (B, n - k, S): row 0 is received row ``j`` with the single-support
        correction applied, rows 1.. the rank-1 consistency checks, zero
        exactly where the hypothesis "only row j is in error" holds (the
        decode1 fold, ``ops.dispatch.decode1_fold_matrix``)."""
        from noise_ec_tpu_torch.ops.dispatch import decode1_fold_matrix

        D = decode1_fold_matrix(self.gf, self.parity_matrix, j)
        return self.make_sharded_matmul(
            mesh, D, batch_axis=batch_axis, row_axis=row_axis)

    def make_sharded_matmul_words(self, mesh: Mesh, M: np.ndarray, *,
                                  batch_axis: str = "batch",
                                  row_axis: Optional[str] = None
                                  ) -> Callable:
        """(B, k, TW) words (int32 tensor, or a uint32 / int32 array) ->
        (B, R, TW) int32 over ``mesh``, whole on every process.

        Words are the shard bytes (4 GF(2^8) or 2 interleaved GF(2^16)
        symbols a word). Each position runs its row slice through the
        single-device words path (GF(2^16) at 16 planes a symbol), except
        past the reference's route gate (``_MESH_XOR_BUDGET``,
        ``_MESH_MAX_ROWS`` over the whole matrix): a near-limit GF(2^8)
        matrix such as RS(200,56) runs K8 per row slice, and a GF(2^16)
        one raises ``NotImplementedError``."""
        from noise_ec_tpu_torch.ops.mxu import (
            MXU_TILE_WORDS,
            build_mxu_tiles,
            mxu_encode_tiles,
        )

        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        m = self.gf.degree
        bits = expand_generator_bits(self.gf, M)
        cost = int(np.count_nonzero(bits)) - bits.shape[0]
        rows_eff = max(M.shape) * (2 if m == 16 else 1)
        mxu_route = cost > _MESH_XOR_BUDGET or rows_eff > _MESH_MAX_ROWS
        if mxu_route and m != 8:
            raise NotImplementedError(
                "near-field-limit GF(2^16) has no mesh words kernel; "
                "use the stripes path (make_sharded_matmul) or GF(2^8)"
            )
        slices = self._row_slices(M, mesh, row_axis)
        if mxu_route:
            tiles: dict[tuple, object] = {}

            def product(ir, device, w):
                key = (ir, str(device))
                op = tiles.get(key)
                if op is None:
                    Ml = slices[ir]
                    m2 = expand_generator_bits(self.gf, Ml).astype(np.int8)
                    op = tiles[key] = build_mxu_tiles(
                        torch.from_numpy(m2), *Ml.shape).to(device)
                TW = w.shape[-1]
                TWp = -(-TW // MXU_TILE_WORDS) * MXU_TILE_WORDS
                if TWp != TW:
                    w = F.pad(w, (0, TWp - TW))
                return mxu_encode_tiles(op, w.contiguous())[..., :TW]
        elif m == 8:
            def product(ir, device, w):
                return self._codec_on(device)._byte_rows(slices[ir], w, None)
        else:
            def product(ir, device, w):
                return self._codec_on(device)._words16(slices[ir], w, None)
        return self._sharded(mesh, M.shape[0], batch_axis, row_axis,
                             product, 1)

    def make_sharded_encoder_words(self, mesh: Mesh, *,
                                   batch_axis: str = "batch",
                                   row_axis: Optional[str] = None
                                   ) -> Callable:
        """Batched parity encode on words: (B, k, TW) -> (B, r, TW)."""
        return self.make_sharded_matmul_words(
            mesh, self.parity_matrix, batch_axis=batch_axis,
            row_axis=row_axis)
