"""Device meshes and the mesh dispatch tier for batched codec products.

Port of ``noise_ec_tpu.parallel.mesh``. Two layers:

- **Mesh constructors** (:func:`make_mesh`, :func:`default_2d_mesh`): a
  :class:`Mesh` is an array of ``torch.device``s with named axes, the
  reference's ``jax.sharding.Mesh``: ``"batch"`` data parallelism over
  independent objects, ``"row"`` tensor parallelism over parity rows.
  ``parallel/batch.py``'s ``make_sharded_*`` builders take one. A device
  may be listed more than once (``[torch.device("cuda", 0)] * 4``): each
  position of a mesh runs its work on its own CUDA stream, so the
  positions of one card overlap as the devices of several would.

- **The** :class:`MeshRouter` **dispatch tier**: the process router
  (:func:`mesh_router`) that ``DeviceCodec.matmul_stripes_many`` and
  ``matmul_words_batch`` consult (and through them the coalescer, the
  repair engine's group reconstructs and ``BatchCodec``'s batch entries).
  When it is enabled and a batch clears ``min_shard_batch``, the batch is
  ladder-padded (:func:`ladder_pad`) and split along axis 0 over a 1-D
  ``"stripes"`` mesh of ``n_dev_for(B_pad)`` positions; each position runs
  its shard's product on its device and stream through the codec's
  single-device words path for the matrix's route (K5, K1 or the pipeline
  when baked; K6 -> K7 -> K6 on the panel route), and the shards come back
  as a :class:`ShardedBatch`. GF symbols are positionwise, so no shard
  needs another's data: the matrix is replicated (its plan uploaded once
  per device) and nothing is exchanged. Pad members are garbage rows that
  are dropped.

  The reference picks ``shard_map`` for its Pallas kernels and ``pjit``
  for its XLA kernel. The port has no XLA kernel: every sharded product,
  the symbol entries (:meth:`MeshRouter.matmul_sym_many`,
  :meth:`~MeshRouter.matmul_sym_batch`,
  :meth:`~MeshRouter.encode_sym_program`) included, rides the words tier
  and records ``noise_ec_mesh_sharded_dispatches_total{mode="shard_map"}``.

  Chained stages never move data: a stage that takes the
  :class:`ShardedBatch` of the one before it over the same mesh runs on
  its shards where they are. ``noise_ec_mesh_reshard_total`` counts a
  device input that does not already sit on the program's shards: a plain
  tensor, or a :class:`ShardedBatch` over another mesh (the reference's
  ``_note_input``). ``donate=True`` hands the caller's tensor to the tier
  (recorded exactly once, ``StagingPool.donate``): it is marked in use on
  every shard's stream, so the caller may drop it at once and the
  allocator reuses its memory once the products are done; a buffer the
  tier staged itself (from host bytes, or a padded member) is freed the
  same way.

  Default: enabled only where ``torch.cuda.device_count() >= 2``;
  disabled on the CPU and on a one-card host unless configured
  (:func:`configure_mesh_router`), as the reference disables its router on
  the CPU. The router shards within this process; a mesh across processes
  is the builders' (``parallel/multihost.py``).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from noise_ec_tpu_torch.obs.registry import default_registry

__all__ = [
    "Mesh",
    "MeshRouter",
    "STRIPES_AXIS",
    "ShardedBatch",
    "configure_mesh_router",
    "default_2d_mesh",
    "default_devices",
    "ladder_pad",
    "make_mesh",
    "mesh_router",
    "reset_mesh_router",
]

# The 1-D mesh axis the dispatch tier shards batches over: independent
# stripes (objects, coalesced requests).
STRIPES_AXIS = "stripes"


def default_devices() -> list[torch.device]:
    """Every CUDA device of this process, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-d array of devices with named axes (module doc).

    ``processes`` (the same shape, or None) names the rank of the process
    that owns each position; None means every position is this process's.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None,
                 processes: Optional[Sequence[int]] = None):
        flat = [_as_device(d) for d in devices]
        shape = (len(flat),) if shape is None else tuple(shape)
        if math.prod(shape) != len(flat) or len(shape) != len(axis_names):
            raise ValueError(f"axis sizes {list(shape)} != device count "
                             f"{len(flat)}")
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = d
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.processes = (None if processes is None else
                          np.asarray(processes, dtype=np.int64).reshape(shape))
        self._streams: dict[int, object] = {}
        self._lock = threading.Lock()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))

    def process_of(self, pos: tuple) -> Optional[int]:
        return None if self.processes is None else int(self.processes[pos])

    def is_local(self, pos: tuple) -> bool:
        """True when this process owns position ``pos``."""
        owner = self.process_of(pos)
        return owner is None or owner == _rank()

    @property
    def home(self) -> torch.device:
        """The first device of this process in the mesh: where a builder
        puts what it assembles."""
        for pos in np.ndindex(self.devices.shape):
            if self.is_local(pos):
                return self.devices[pos]
        raise ValueError("no position of this mesh belongs to this process")

    def stream(self, index: int):
        """Position ``index``'s (flat, row-major) CUDA stream, made at first
        use; None for a CPU position."""
        device = self.device_list[index]
        if device.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(index)
            if s is None:
                s = self._streams[index] = torch.cuda.Stream(device=device)
            return s

    def _key(self) -> tuple:
        procs = None if self.processes is None else tuple(
            self.processes.reshape(-1).tolist())
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.device_list), procs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.device_list]})")


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_mesh(
    axis_names: Sequence[str] = ("batch",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    processes: Optional[Sequence[int]] = None,
) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: :func:`default_devices`).

    If ``axis_sizes`` is omitted, all devices go to the first axis and the
    rest get size 1. ``processes`` gives each device's owning rank
    (``parallel/multihost.py`` ``global_mesh``)."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if math.prod(axis_sizes) != n:
        raise ValueError(f"axis sizes {list(axis_sizes)} != device count {n}")
    return Mesh(devices, axis_names, axis_sizes, processes)


def default_2d_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """("batch", "row") mesh: widest batch axis, row axis of 2 when even."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    row = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh(("batch", "row"), (n // row, row), devices)


def ladder_pad(B: int) -> int:
    """The power-of-two batch ladder: next power of two >= B."""
    return 1 << (max(1, B) - 1).bit_length()


# ----------------------------------------------------- running a position


def launch_on(device: torch.device, stream, fn: Callable, *inputs):
    """``fn(*inputs)`` with every input moved to ``device``, on ``stream``
    (None on the CPU) after the work that made the inputs: the stream
    waits for the inputs' current streams, and an input already on
    ``device`` is marked in use on the stream (``record_stream``), so its
    owner may drop it at once. What ``fn`` allocates belongs to the
    stream until a reader joins it (:func:`join_stream`)."""
    if stream is None:
        return fn(*[x.to(device) for x in inputs])
    with torch.cuda.device(device):
        stream.wait_stream(torch.cuda.current_stream(device))
        for x in inputs:
            if x.device.type == "cuda" and x.device != device:
                stream.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(stream):
            moved = []
            for x in inputs:
                if x.device == device:
                    x.record_stream(stream)
                moved.append(x.to(device, non_blocking=True))
            return fn(*moved)


def join_stream(x: torch.Tensor, stream) -> torch.Tensor:
    """Make ``x``'s device's current stream wait for ``stream``, which
    wrote ``x``, and mark ``x`` in use there; returns ``x``."""
    if stream is not None:
        cur = torch.cuda.current_stream(x.device)
        cur.wait_stream(stream)
        x.record_stream(cur)
    return x


class ShardedBatch:
    """A batch split along axis 0 over a 1-D mesh (module doc).

    ``shards[i]`` holds members ``i * per`` to ``(i + 1) * per`` on the
    mesh's position i, written on ``streams[i]`` (None on the CPU). The
    members from ``B`` on are ladder padding, garbage. :meth:`to_tensor`
    is the whole batch: the shards concatenated, padding dropped.
    """

    def __init__(self, shards: list, mesh: Mesh, B: int, per: int,
                 streams: list):
        self.shards = shards
        self.mesh = mesh
        self.B = B
        self.per = per
        self.streams = streams

    @property
    def shape(self) -> tuple:
        return (self.B,) + tuple(self.shards[0].shape[1:])

    def to_tensor(self, device=None) -> torch.Tensor:
        """The whole batch on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else _as_device(
            device)
        parts = [join_stream(x, s).to(device)
                 for x, s in zip(self.shards, self.streams)]
        return torch.cat(parts)[:self.B]

    def map(self, fn: Callable, *others: "ShardedBatch") -> "ShardedBatch":
        """``fn(shard, *other_shards) -> tensor`` on every position, on its
        device and stream: a new batch on the same mesh, nothing moved.
        ``others`` must be split the same way over an equal mesh."""
        for o in others:
            if o.mesh != self.mesh or o.per != self.per or o.B != self.B:
                raise ValueError("map needs batches split the same way")
        outs = []
        for i, (x, s) in enumerate(zip(self.shards, self.streams)):
            ys = [o.shards[i] for o in others]
            for o, y in zip(others, ys):
                if o.streams[i] is not s:
                    join_stream(y, o.streams[i])
            outs.append(launch_on(self.mesh.device_list[i], s, fn, x, *ys))
        return ShardedBatch(outs, self.mesh, self.B, self.per, self.streams)

    def __array__(self, dtype=None, copy=None):
        out = self.to_tensor("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


# ------------------------------------------------------------- the router


class MeshRouter:
    """Routes batched codec dispatches over a device mesh (module doc).

    One process-wide instance (:func:`mesh_router`) fronts the
    ``DeviceCodec`` batch entries; tests and ``chip_smoke.py`` build their
    own over device lists with :func:`configure_mesh_router`.
    """

    def __init__(self, devices: Optional[Sequence] = None, *,
                 min_shard_batch: int = 2, enable: Optional[bool] = None):
        self.devices = [_as_device(d) for d in (
            devices if devices is not None else default_devices())]
        n = max(1, len(self.devices))
        # Power-of-two floor: the widest axis that always divides a
        # ladder-padded batch (both are powers of two).
        self.n_pow2 = 1 << (n.bit_length() - 1)
        self.min_shard_batch = min_shard_batch
        if enable is None:
            enable = (torch.cuda.is_available()
                      and torch.cuda.device_count() >= 2
                      and all(d.type == "cuda" for d in self.devices))
        self.enabled = bool(enable) and self.n_pow2 >= 2
        self._lock = threading.Lock()
        self._meshes: dict[int, Mesh] = {}
        # One DeviceCodec a (field, device) for positions on another
        # device than the caller's codec: plans are uploaded per device.
        self._codecs: dict[tuple, object] = {}
        reg = default_registry()
        self._dispatches = reg.counter(
            "noise_ec_mesh_sharded_dispatches_total").labels(mode="shard_map")
        self._shard_bytes = reg.histogram("noise_ec_mesh_shard_bytes").labels()
        self._reshard = reg.counter("noise_ec_mesh_reshard_total").labels()
        reg.gauge("noise_ec_mesh_devices").set_callback(_mesh_devices_gauge)

    # ------------------------------------------------------------ planning

    def should_shard(self, B: int) -> bool:
        """The routing predicate the dispatch entries consult."""
        return self.enabled and B >= max(2, self.min_shard_batch)

    def n_dev_for(self, B_pad: int) -> int:
        """Positions used for a ladder-padded batch (divides it exactly)."""
        return min(self.n_pow2, ladder_pad(B_pad))

    def mesh_for(self, n_dev: int) -> Mesh:
        with self._lock:
            mesh = self._meshes.get(n_dev)
            if mesh is None:
                mesh = self._meshes[n_dev] = Mesh(self.devices[:n_dev],
                                                  (STRIPES_AXIS,))
            return mesh

    def sharding_for(self, n_dev: int) -> Mesh:
        """The layout every program of the tier pins: the batch axis over
        ``mesh_for(n_dev)``. A stage's output is a :class:`ShardedBatch`
        on it, which the next stage on the same mesh takes as it is."""
        return self.mesh_for(n_dev)

    # ------------------------------------------------------------- metrics

    def _note_input(self, x, expected: Mesh) -> None:
        """Count a device input that does not already sit on the
        program's shards: a plain tensor, or a :class:`ShardedBatch` over
        another mesh."""
        if isinstance(x, torch.Tensor) or (
                isinstance(x, ShardedBatch) and x.mesh != expected):
            self._reshard.add(1)

    # ------------------------------------------------------- the words tier

    def _codec_on(self, codec, device: torch.device):
        if device == codec.device:
            return codec
        from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

        key = (codec.field, str(device))
        with self._lock:
            dev = self._codecs.get(key)
            if dev is None:
                dev = self._codecs[key] = DeviceCodec(field=codec.field,
                                                      device=device)
            return dev

    def _split(self, words, fn: Callable, *, staged: bool = False,
               n_dev: Optional[int] = None, record: bool = True) -> tuple:
        """The body every entry of the tier shares: ladder-pad the batch,
        split it along axis 0, run ``fn(device, shard) -> tuple of
        tensors`` on every position (its device, its stream), and return
        one :class:`ShardedBatch` a tensor of the tuple.

        ``words``: (B, K, TW) int32 words as a tensor (``staged`` when the
        tier made it from host bytes: no reshard), a numpy array (staged
        here) or a :class:`ShardedBatch`, whose shards are taken as they
        are when they sit on this program's mesh. ``n_dev`` forces the
        positions (default :meth:`n_dev_for`); ``record`` counts a sharded
        dispatch."""
        if isinstance(words, np.ndarray):
            words = torch.from_numpy(
                np.ascontiguousarray(words).view(np.int32))
            staged = True
        B = words.shape[0]
        if n_dev is None:
            B_pad = ladder_pad(B)
            n_dev = self.n_dev_for(B_pad)
            per = B_pad // n_dev
        else:
            if not 1 <= n_dev <= len(self.devices):
                raise ValueError(f"n_dev {n_dev} not within the router's "
                                 f"{len(self.devices)} devices")
            per = -(-B // n_dev)
        mesh = self.mesh_for(n_dev)
        self._note_input(None if staged else words, mesh)
        shards = None
        if isinstance(words, ShardedBatch):
            if words.mesh == mesh and words.per == per:
                shards = words
            else:
                words = words.to_tensor()
        K, TW = words.shape[1], words.shape[-1]
        outs = []
        for i, device in enumerate(mesh.device_list):
            lo, hi = i * per, (i + 1) * per
            stream = mesh.stream(i)
            if shards is not None:
                x = shards.shards[i]
                if shards.streams[i] is not stream:
                    join_stream(x, shards.streams[i])
            else:
                x = words[min(lo, B):min(hi, B)]

            def run(w, lo=lo, hi=hi, device=device):
                if hi > B and shards is None:
                    pad = torch.empty((hi - max(lo, B), K, TW),
                                      dtype=w.dtype, device=device)
                    w = torch.cat([w, pad]) if w.shape[0] else pad
                return fn(device, w.contiguous())

            outs.append(launch_on(device, stream, run, x))
        if record:
            self._dispatches.add(1)
            self._shard_bytes.observe(max(1, 4 * B * K * TW // n_dev))
        streams = [mesh.stream(i) for i in range(n_dev)]
        return tuple(ShardedBatch([o[j] for o in outs], mesh, B, per, streams)
                     for j in range(len(outs[0])))

    def shard(self, words, n_dev: Optional[int] = None) -> ShardedBatch:
        """Place a (B, K, TW) batch on the tier's layout for its size (the
        reference's ``device_put`` with :meth:`sharding_for`), as the next
        stage will take it: its shards, ladder-padded, on their positions.
        A placement, not a program's input: it counts no reshard and no
        dispatch."""
        (out,) = self._split(words, lambda device, w: (w,), staged=True,
                             n_dev=n_dev, record=False)
        return out

    def matmul_words_batch(self, codec, M: np.ndarray, words, *,
                           donate: bool = False,
                           tier: Optional[str] = None) -> ShardedBatch:
        """Mesh-sharded GF(2^8) words product: (B, k, TW) int32 words (a
        tensor, a numpy array or a :class:`ShardedBatch`) -> a
        :class:`ShardedBatch` of (B, r, TW), byte-identical to the
        single-device route. ``DeviceCodec.matmul_words_batch`` runs the
        same tier under its gate slot and returns one tensor."""
        if codec.sym_bytes != 1:
            raise ValueError(
                "the words tier runs GF(2^8) words; GF(2^16) batches ride "
                "the byte-sliced stripes entry (matmul_bytesliced_many)")
        M = np.asarray(M)
        if donate and isinstance(words, torch.Tensor):
            codec._pool.donate(words)
        return self.words_product(codec, M, words, tier=tier)

    def words_product(self, codec, M: np.ndarray, words, *,
                      tier: Optional[str] = None, staged: bool = False,
                      n_dev: Optional[int] = None) -> ShardedBatch:
        """The tier's product over byte rows, each shard through the
        codec's single-device path (``DeviceCodec._byte_rows``), recording
        the panel route's sub-launches as the reference does."""
        (out,) = self._split(
            words, lambda device, w: (
                self._codec_on(codec, device)._byte_rows(M, w, tier),),
            staged=staged, n_dev=n_dev)
        kind, _, _, G = codec.plan_for(M, tier)
        if kind == "panel":
            from noise_ec_tpu_torch.ops.dispatch import (
                record_sublaunch_dispatch,
            )

            record_sublaunch_dispatch("mesh_words", G)
        return out

    def decode1_words_batch(self, codec, A: np.ndarray, j: int,
                            words) -> tuple:
        """Mesh-sharded corrupted-share decode: (B, m, TW) int32 words of
        the received codewords -> (corrected row j, the OR of the
        consistency rows), each a :class:`ShardedBatch` of (B, TW). A
        :class:`ShardedBatch` input over this tier's mesh (an encode's
        output with its data rows) runs where it is: a chained encode ->
        decode never reshards."""
        from noise_ec_tpu_torch.ops.dispatch import (
            _or_rows,
            decode1_fold_matrix,
            record_sublaunch_dispatch,
        )

        if codec.gf.degree != 8:
            raise NotImplementedError(
                "mesh decode1 runs the GF(2^8) words tier; wide-field "
                "batches ride the byte-sliced stripes entry")
        D = decode1_fold_matrix(codec.gf, np.asarray(A), j)

        def fold(device, w):
            out = self._codec_on(codec, device)._byte_rows(D, w, None)
            return out[:, 0], _or_rows(out[:, 1:].transpose(0, 1))

        corrected, bad = self._split(words, fold)
        kind, _, _, G = codec.plan_for(D)
        if kind == "panel":
            record_sublaunch_dispatch("mesh_decode1", G)
        return corrected, bad

    def encode_words_program(self, codec, M: np.ndarray,
                             n_dev: int) -> Callable:
        """A sharded words encode over ``n_dev`` positions for tests and
        timing: ``fn((B, k, TW) words) -> ShardedBatch`` (no donation:
        a timing loop reuses its input)."""
        M = np.asarray(M)
        return lambda words: self.words_product(codec, M, words, n_dev=n_dev)

    # ----------------------------------------------- the symbol entries

    def matmul_sym_many(self, codec, M: np.ndarray, Ds: list,
                        B_pad: Optional[int] = None) -> list:
        """B same-shape (k, S) symbol stripes through the words tier (the
        codec's staging, then :meth:`words_product`): B host arrays,
        byte-identical to B single products. ``B_pad`` is accepted for the
        reference's signature; the tier pads to the ladder itself."""
        return codec._stripes(np.asarray(M), Ds, None, router=self)

    def matmul_bytesliced_many(self, codec, M: np.ndarray, Ds: list,
                               B_pad: Optional[int] = None) -> list:
        """GF(2^16) batch: each u16 member as its (lo, hi) byte rows over
        the m = 8 words tier with 2k/2r rows (the unpermuted expansion).
        Returns B (r, S) u16 arrays."""
        if codec.sym_bytes != 2:
            raise ValueError("matmul_bytesliced_many is gf65536-only")
        return self.matmul_sym_many(codec, M, Ds, B_pad)

    def matmul_sym_batch(self, codec, M: np.ndarray, batch) -> np.ndarray:
        """(B, k, S) symbols -> (B, r, S) through the words tier (the
        reference's ``pjit`` tier has no port: no XLA kernel)."""
        batch = np.asarray(batch, dtype=codec.gf.dtype)
        return np.stack(self.matmul_sym_many(codec, M, list(batch)))

    def encode_sym_program(self, codec, M: np.ndarray,
                           n_dev: int) -> Callable:
        """A sharded symbol encode over ``n_dev`` positions for tests and
        timing: ``fn((B, k, S) symbols) -> (B, r, S)``."""
        M = np.asarray(M)

        def fn(batch):
            batch = np.asarray(batch, dtype=codec.gf.dtype)
            return np.stack(codec._stripes(M, list(batch), None,
                                           router=self, n_dev=n_dev))

        return fn


def _mesh_devices_gauge() -> int:
    """Positions the active codec mesh spans (1 = single-device tier)."""
    r = _router
    return r.n_pow2 if r is not None and r.enabled else 1


_router: Optional[MeshRouter] = None
_router_lock = threading.Lock()


def mesh_router() -> MeshRouter:
    """The process-wide mesh dispatch router (lazy singleton)."""
    global _router
    with _router_lock:
        if _router is None:
            _router = MeshRouter()
        return _router


def configure_mesh_router(**kwargs) -> MeshRouter:
    """Replace the process router (tests and ``chip_smoke.py`` force
    ``enable`` or pin a device list). Returns the new router."""
    global _router
    with _router_lock:
        _router = MeshRouter(**kwargs)
        return _router


def reset_mesh_router() -> None:
    """Drop the router so the next use rebuilds over the current device
    list (``multihost.initialize`` calls this after joining a group)."""
    global _router
    with _router_lock:
        _router = None
