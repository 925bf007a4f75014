"""Geometry-cached device codec: the bridge from GF matrices to the kernels.

Port of ``noise_ec_tpu.ops.dispatch.DeviceCodec`` for GF(2^8) and
GF(2^16). One primitive carries both reference hot loops: encode is
``parity_rows @ data`` (main.go:262), reconstruct is
``inverted_submatrix_rows @ survivors`` (main.go:77). Per matrix the codec
caches its plan, with the operand uploaded to the card once, on one of
three routes (:meth:`DeviceCodec.route_for`):

- "baked": the K-sliced fused kernel K5 (ops/fused.py) when its ring
  fits shared memory, else the fused kernel K1 (ops/fused.py) when its
  slots fit, else the K2 -> K4 -> K3 pipeline (ops/pack.py, ops/gf2mm.py).
  The reference tries K1 first; K5 runs each measured matrix faster on
  the H100 (PERF.md), so the port tries it first, and the default plan
  factors no network;
- "panel" (wide codes): the row-blocked pack K6 -> the block-panel matmul
  K7 (ops/panel.py) -> the row-blocked unpack;
- "mxu" (past every XOR-network budget): the dense int8 product K8
  (ops/mxu.py).

GF(2^16) runs byte-sliced: each u16 symbol row splits into adjacent lo/hi
byte rows, and the m=8 routes above run over 2k byte rows with the
matrix's unpermuted (16r, 16k) bit expansion (flat plane index
16j + b == (2j + b//8)*8 + b%8). The interleaved-u16 words entry
(:meth:`DeviceCodec.matmul_words` on a GF(2^16) codec) runs the same bits,
and the same plan, over 16 planes a shard instead, routed as the
reference's ``_fused_words16_fn`` and ``_panel_words_fn(r, 16, ...)``:
baked, K5 or K1 at m = 16, else the lane pipeline at m = 16 (K2 -> K4 ->
K3), or the sublane one (K10 -> K4 -> K10, the reference's tier 3) where
the reference's lane tile would not fit its rows (max(k, r) > 48); panel,
K6 at m = 16 -> K7 -> K6.

The codec runs on ``device`` ("cuda" unless the caller asks for "cpu").
On the CPU every wrapper takes its kernel's plain PyTorch version; on the
card it launches the kernel or raises. ``DeviceCodec(device="cuda")``
loads the kernel library when it is built, so a build failure raises
from the constructor. Within a call nothing falls back: a build or launch
error raises, and so does the one route the reference has no kernel for
either, an "mxu" matrix on the interleaved GF(2^16) words entry.

The error-correcting decode (matrix/bw.py, codec/fec.py) reaches the card
through :meth:`DeviceCodec.syndrome_stripes` and the decode1 fold
(:func:`decode1_fold_matrix`, :meth:`DeviceCodec.decode1_words` and its
byte-sliced GF(2^16) twin): each is one generator-shaped product on the
routes above.

Around the codec, as in the reference:

- the **codec breaker** (:func:`codec_breaker`), which the codecs
  (codec/rs.py) consult around each batched product: a failure is retried
  once in the call, a second trips the breaker and the call raises
  :class:`CodecUnavailableError`, as does every call while it is open,
  each counted (``noise_ec_codec_refused_total{reason}``) and logged as a
  ``codec.refused`` event; a background prober re-closes it with a canary
  product on the device that tripped it. Unlike the reference, no product
  ever moves to the host arithmetic: a failed product raises, so a shape
  the kernels refuse can never run on the host unseen. Only a
  ``RuntimeError`` the card may get over counts against the breaker;
  every other error (:func:`device_error_raises`: a refused input, a
  build or launch error, an unported route, a lost CUDA context)
  propagates as it is and leaves the breaker alone;
- the **device gate** (:class:`DeviceGate`): bounded admission with QoS
  lanes, acquired once by every public entry of :class:`DeviceCodec`;
- **telemetry**: each public entry runs inside ``device_op`` (obs/device.py)
  after ``record_kernel`` (obs/profiling.py). As in the reference, the
  entries that are one product of another entry take that entry's gate
  slot and telemetry window: ``matmul_words`` and ``decode1_words``
  through ``matmul_words_batch`` ("matmul_words"), ``syndrome_stripes``
  through ``matmul_stripes``, ``decode1_words_bytesliced`` through
  ``matmul_words_bytesliced``.

- the **mesh tier** (parallel/mesh.py): ``matmul_stripes_many`` (both
  fields, through the byte rows) and ``matmul_words_batch`` (GF(2^8))
  consult :func:`~noise_ec_tpu_torch.parallel.mesh.mesh_router` where the
  reference does, and a batch of B > 1 that is not on the "mxu" route runs
  as one sharded dispatch inside the entry's one gate slot and
  ``device_op`` window; each shard runs the internal route below, never a
  public entry, and a shard's error reaches the caller (and the codecs'
  breaker) as any dispatch error does;
- **staging and donation**: :class:`StagingPool` counts its reuse
  (``noise_ec_device_buffer_pool_{hits,misses}_total``) and keeps the
  exactly-once donation record of ``matmul_words_batch(donate=True)``;
- **tile attribution**: a dispatch on the panel route names its K7 plan
  (:func:`tile_label`) in its ``device_op`` window and counts its K
  sub-launches (:func:`record_sublaunch_dispatch`).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536
from noise_ec_tpu_torch.obs.device import device_op, maybe_analyze_program
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.profiling import record_kernel
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import device_span
from noise_ec_tpu_torch.ops._build import (
    KernelBuildError,
    KernelLaunchError,
    library,
)
from noise_ec_tpu_torch.ops.coalesce import QOS_LANES, current_qos
from noise_ec_tpu_torch.ops.fused import (
    fused_encode_words,
    fused_plan,
    fused_split_encode_words,
    fused_split_plan,
)
from noise_ec_tpu_torch.ops.gf2mm import (
    bits_to_rows,
    gf2_matmul_sparse,
    sparse_plan,
)
from noise_ec_tpu_torch.ops.mxu import (
    MXU_TILE_WORDS,
    build_mxu_tiles,
    mxu_encode_tiles,
)
from noise_ec_tpu_torch.ops.network import SMEM_BYTES
from noise_ec_tpu_torch.ops.pack import (
    lane_quantum,
    lane_tl,
    pack_u16_bytesliced,
    pack_words16,
    pack_words_lanes,
    pack_words_lanes_blocked,
    reference_lane_tl,
    unpack_u16_bytesliced,
    unpack_words16,
    unpack_words_lanes,
    unpack_words_lanes_blocked,
)
from noise_ec_tpu_torch.ops.panel import gf2_matmul_panel_chain, panel_plan

_FIELDS = {"gf256": GF256, "gf65536": GF65536}

log = logging.getLogger("noise_ec_tpu_torch.ops")


# ---------------------------------------------------------- codec breaker
#
# The card is ONE process-wide resource: when a dispatch fails (an
# allocator out of memory, an injected fault), every codec sharing it will
# fail the same way — so the circuit breaker guarding the device route is
# process-wide too. The codecs (codec/rs.py _mul_batch) consult it around
# each batched product: a failure is retried once in the call, a second
# trips the breaker and raises CodecUnavailableError, and every call while
# it is open raises the same at once instead of queueing more work on a
# failing card (noise_ec_codec_refused_total{reason}). A background prober
# re-tries a canary product on the breaker's widening half-open schedule
# and closes it when the device answers correctly again
# (noise_ec_codec_circuit_state 1 -> 2 -> 0).
#
# The reference serves a tripped product from the host arithmetic
# instead. The port never does: a product on the card runs its kernels or
# raises, so a matrix or shape the kernels refuse cannot slide onto the
# host for good while the canary keeps re-closing the breaker.
#
# Only a RuntimeError the card may get over (an allocator out of memory,
# a fault injected by a test) is retried and counted as a breaker failure.
# Everything else bypasses the breaker (device_error_raises): an error
# that is not a RuntimeError is a refusal the same call would meet again
# (a wrapper or planner rejecting its input, such as a plan that does not
# fit or an index past 32 bits); a kernel that cannot be built or whose
# launch was refused is a bug; an unported route raises by the port's
# rule; and a CUDA error that leaves the context unusable would keep the
# half-open probe from ever closing the breaker. Those propagate as they
# are, leave the breaker as they found it, and give back a half-open probe
# slot the caller held.

_codec_breaker = None
_codec_breaker_lock = threading.Lock()
_refused_children: dict[str, object] = {}
_prober_thread: Optional[threading.Thread] = None
# The device the canary runs on: the one whose failure last tripped the
# breaker. One canary codec per device.
_probe_target: Optional[torch.device] = None
_probe_codecs: dict[str, "DeviceCodec"] = {}

# RuntimeErrors never retried, never a breaker failure (module comment).
RAISES = (KernelBuildError, KernelLaunchError, NotImplementedError)


class CodecUnavailableError(RuntimeError):
    """A product the device codec refused: its dispatch failed twice and
    tripped the codec breaker (chained to the last failure), or the
    breaker was open. Nothing ran in its place; retry once the breaker
    closes (``codec_breaker().closed``)."""


def _new_codec_breaker(**kwargs):
    global _codec_breaker
    from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker

    _codec_breaker = CircuitBreaker(
        failure_threshold=kwargs.pop("failure_threshold", 1), **kwargs
    )
    default_registry().gauge("noise_ec_codec_circuit_state").set_callback(
        lambda: _codec_breaker.state_code()
    )
    return _codec_breaker


def codec_breaker():
    """The process-wide device-route breaker (lazy singleton). A failure
    threshold of 1: the in-call retry already absorbed one failure, so a
    second is a tripped route."""
    with _codec_breaker_lock:
        if _codec_breaker is None:
            _new_codec_breaker(reset_timeout=5.0, max_reset_timeout=60.0)
        return _codec_breaker


def configure_codec_breaker(**kwargs):
    """Replace the process breaker (tests shrink the timeouts; a fresh
    instance also resets state). Returns the new breaker."""
    with _codec_breaker_lock:
        return _new_codec_breaker(**kwargs)


def record_codec_refusal(reason: str) -> None:
    """Count one product the device codec refused (``reason``: "error"
    for the call that tripped the breaker, "open" for a call refused
    while it is not closed) and emit the ``codec.refused`` warn event."""
    child = _refused_children.get(reason)
    if child is None:
        child = _refused_children[reason] = default_registry().counter(
            "noise_ec_codec_refused_total"
        ).labels(reason=reason)
    child.add(1)
    event("codec.refused", "warn", reason=reason)


def device_error_raises(exc: BaseException, device: torch.device) -> bool:
    """True when ``exc``, raised by a product on ``device``, must
    propagate as it is, bypassing the retry and the breaker: anything but
    a ``RuntimeError`` (a refused input: ``ValueError`` from a wrapper or
    a planner, an ``AssertionError``), a :data:`RAISES` type, or any
    error after which the CUDA context is unusable — a
    ``torch.cuda.synchronize()`` that raises again (an illegal address,
    an unspecified launch failure, a misaligned address: sticky errors)."""
    if not isinstance(exc, RuntimeError) or isinstance(exc, RAISES):
        return True
    if device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(device)
    except Exception:  # noqa: BLE001 — any error here means the context is gone
        return True
    return False


def _probe_device(device: torch.device) -> None:
    """Canary: RS(4,2)'s parity product on a 4 x 64-byte stripe through
    ``matmul_stripes_many`` (the route an RS(4,2) encode takes), checked
    against the host arithmetic. Raises while the device route is still
    broken. Runs only on the prober's thread."""
    from noise_ec_tpu_torch.matrix.generators import generator_matrix
    from noise_ec_tpu_torch.matrix.hostmath import host_matvec

    codec = _probe_codecs.get(str(device))
    if codec is None:
        codec = _probe_codecs[str(device)] = DeviceCodec(device=device)
    M = generator_matrix(codec.gf, 4, 6, "cauchy")[4:]
    D = (np.arange(4 * 64) % 251).astype(np.uint8).reshape(4, 64)
    out = codec.matmul_stripes_many(M, [D])[0]
    if not np.array_equal(out, host_matvec(codec.gf, M, D)):
        raise RuntimeError("codec probe produced wrong bytes")


def ensure_codec_prober(device) -> None:
    """Run the background half-open prober on ``device`` while the breaker
    is not closed (idempotent; the thread exits once it closes)."""
    global _prober_thread, _probe_target
    with _codec_breaker_lock:
        _probe_target = torch.device(device)
        if _prober_thread is not None and _prober_thread.is_alive():
            return
        _prober_thread = threading.Thread(
            target=_probe_loop, name="noise-ec-codec-probe", daemon=True
        )
        _prober_thread.start()


def _probe_loop() -> None:
    while True:
        br = codec_breaker()
        if br.closed:
            return
        remaining = br.open_remaining()
        if remaining > 0:
            time.sleep(min(remaining, 0.05))
            continue
        if not br.allow():  # another caller holds the half-open probe
            time.sleep(0.02)
            continue
        try:
            _probe_device(_probe_target)
        except Exception as exc:  # noqa: BLE001 — any failure keeps it open
            br.record_failure()
            log.warning("codec device probe failed: %s (breaker re-opened "
                        "for %.1fs)", exc, br.open_remaining())
        else:
            br.record_success()
            log.info("codec device probe succeeded; device route restored")
            event("codec.restore", route="device")
            return


# --------------------------------------------------- device dispatch gate
#
# The card is one shared resource fed from many producer threads (the
# coalescer's leaders, the streaming encoder, the FEC decode, and later the
# host layers). Unbounded, a burst of concurrent dispatches queues
# arbitrarily deep work while every producer keeps allocating host and
# device buffers for payloads that cannot run yet. The gate is the bounded
# DEVICE QUEUE: at most ``capacity`` dispatches are in flight; further
# callers BLOCK until a slot frees. Waits are visible as the
# noise_ec_backpressure_* family (layer="device"); a wait past
# ``wait_timeout`` proceeds anyway — the gate is a governor, not a
# deadlock. A slot is held while a public entry queues its work and is
# released when the entry returns: the words entries return before the
# card finishes, and no synchronise is added to hold the slot longer.
#
# QoS lanes: a contended gate does not drain FIFO. Waiters queue per
# (lane, tenant) — from the ambient ``qos_lane`` context the admitting
# layer set (ops/coalesce.py) — and freed slots are HANDED to a queued
# ticket in release() rather than raced for, so the pick order below is
# the actual service order:
#
# - live beats background: a repair/scrub burst queued in the background
#   lane cannot delay interactive work behind it;
# - starvation floor: background still gets >= 1 of every
#   ``background_floor`` contended grants, so a saturating live tenant
#   cannot park background work forever;
# - inside a lane, tenants share by smooth weighted round-robin on their
#   ``weight``.
#
# The gate is acquired only at entry points that never nest: a public
# DeviceCodec entry calls only the private helpers below it (_stripes,
# _byte_rows, _words_batch, _words16), never another public entry, so a
# capacity-1 gate cannot deadlock on itself.


class _Ticket:
    """One queued waiter; ``granted`` flips under the gate lock when
    release() hands it the freed slot (in_flight already charged)."""

    __slots__ = ("granted",)

    def __init__(self):
        self.granted = False


class _TenantQueue:
    """One tenant's FIFO inside a lane + its smooth-WRR credit."""

    __slots__ = ("weight", "current", "tickets")

    def __init__(self, weight: int):
        self.weight = max(1, int(weight))
        self.current = 0
        self.tickets: "deque[_Ticket]" = deque()


class DeviceGate:
    """Bounded admission to the device dispatch path (module comment).

    ``with gate:`` around a dispatch; reentrant nesting is NOT supported
    (DeviceCodec acquires only at its public entry points, which never
    nest). Tests shrink ``capacity`` to pin the blocking behavior and
    ``background_floor`` to pin the lane arbitration.
    """

    def __init__(
        self,
        capacity: int = 8,
        wait_timeout: float = 120.0,
        background_floor: int = 8,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if background_floor < 2:
            raise ValueError(
                f"background_floor must be >= 2, got {background_floor}"
            )
        self.capacity = capacity
        self.wait_timeout = wait_timeout
        self.background_floor = background_floor
        self._cv = threading.Condition()
        self.in_flight = 0
        self.waiters = 0
        self.waits = 0  # local mirror of the counter (tests, reports)
        # lane -> tenant -> _TenantQueue; lanes fixed, tenant queues are
        # created on first wait and deleted when drained (bounds memory
        # and resets a departed tenant's WRR credit).
        self._queues: dict[str, dict[str, _TenantQueue]] = {
            lane: {} for lane in QOS_LANES
        }
        self._lane_waiters = {lane: 0 for lane in QOS_LANES}
        # Contended live grants since the last background grant (or
        # since background stopped waiting) — the starvation-floor odometer.
        self._live_streak = 0
        reg = default_registry()
        self._waits_total = reg.counter(
            "noise_ec_backpressure_waits_total"
        ).labels(layer="device")
        self._wait_hist = reg.histogram(
            "noise_ec_backpressure_wait_seconds"
        ).labels(layer="device")
        reg.gauge("noise_ec_backpressure_queue_depth").set_callback(
            lambda: self.in_flight + self.waiters, layer="device"
        )
        depth_gauge = reg.gauge("noise_ec_lane_queue_depth")
        for lane in QOS_LANES:
            depth_gauge.set_callback(
                lambda lane=lane: self._lane_waiters[lane], lane=lane
            )
        self._grants = {
            lane: reg.counter("noise_ec_lane_grants_total").labels(lane=lane)
            for lane in QOS_LANES
        }

    def acquire(self) -> None:
        lane, tenant, weight = current_qos()
        with self._cv:
            if self.in_flight < self.capacity and not self._queued():
                self.in_flight += 1
                self._grants[lane].add(1)
                return
            ticket = _Ticket()
            q = self._queues[lane].get(tenant)
            if q is None:
                q = self._queues[lane][tenant] = _TenantQueue(weight)
            else:
                q.weight = max(1, int(weight))  # latest policy wins
            q.tickets.append(ticket)
            self._lane_waiters[lane] += 1
            self.waits += 1
            self._waits_total.add(1)
            t0 = time.monotonic()
            deadline = t0 + self.wait_timeout
            self.waiters += 1
            try:
                while not ticket.granted:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break  # governor, not a deadlock: proceed
                    self._cv.wait(min(remaining, 0.5))
            finally:
                self.waiters -= 1
                if not ticket.granted:
                    # Governor escape: leave the queue and barge. The
                    # ungranted ticket is still queued (grants happen
                    # under this same lock), so discard is exact.
                    self._discard(lane, tenant, ticket)
                    self.in_flight += 1
                    self._grants[lane].add(1)
            self._wait_hist.observe(time.monotonic() - t0)

    def release(self) -> None:
        with self._cv:
            self.in_flight -= 1
            self._grant_free_slots()
            self._cv.notify_all()

    # ------------------------------------------------ queue internals

    def _queued(self) -> bool:
        return any(self._lane_waiters[lane] for lane in QOS_LANES)

    def _discard(self, lane: str, tenant: str, ticket: _Ticket) -> None:
        q = self._queues[lane].get(tenant)
        if q is None:
            return
        try:
            q.tickets.remove(ticket)
        except ValueError:
            return
        self._lane_waiters[lane] -= 1
        if not q.tickets:
            del self._queues[lane][tenant]

    def _grant_free_slots(self) -> None:
        """Hand every free slot to the next queued ticket (lock held)."""
        while self.in_flight < self.capacity:
            picked = self._pick()
            if picked is None:
                return
            lane, ticket = picked
            ticket.granted = True
            self.in_flight += 1
            self._grants[lane].add(1)
            if lane == "background":
                self._live_streak = 0
            elif self._lane_waiters["background"]:
                self._live_streak += 1
                # Rate-limited by the event log's per-name bucket; the
                # streak odometer says how starved background is.
                event("qos.preempt", lane=lane, streak=self._live_streak,
                      background_waiting=self._lane_waiters["background"])
            else:
                self._live_streak = 0

    def _pick(self) -> Optional[tuple[str, _Ticket]]:
        live = self._queues["live"]
        background = self._queues["background"]
        if background and (
            not live or self._live_streak >= self.background_floor - 1
        ):
            lane = "background"
        elif live:
            lane = "live"
        else:
            return None
        queues = self._queues[lane]
        # Smooth weighted round-robin (each queue's credit grows by its
        # weight; the max-credit queue serves and repays the total), so
        # grants interleave proportionally instead of bursting.
        total = sum(q.weight for q in queues.values())
        best_name = best = None
        for name, q in queues.items():
            q.current += q.weight
            if best is None or q.current > best.current:
                best_name, best = name, q
        best.current -= total
        ticket = best.tickets.popleft()
        self._lane_waiters[lane] -= 1
        if not best.tickets:
            del queues[best_name]
        return lane, ticket

    def __enter__(self) -> "DeviceGate":
        with device_span("codec.gate"):
            self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False


_device_gate: Optional[DeviceGate] = None
_device_gate_lock = threading.Lock()


def device_gate() -> DeviceGate:
    """The process-wide device dispatch gate (lazy singleton)."""
    global _device_gate
    with _device_gate_lock:
        if _device_gate is None:
            _device_gate = DeviceGate()
        return _device_gate


def configure_device_gate(**kwargs) -> DeviceGate:
    """Replace the process gate (tests shrink capacity; a fresh instance
    also resets occupancy). Returns the new gate."""
    global _device_gate
    with _device_gate_lock:
        _device_gate = DeviceGate(**kwargs)
        return _device_gate

# Whole-network factoring is super-linear in the network's terms and runs
# on the host once per matrix (RS(50,20), ~32k raw XORs, takes seconds in
# Python). Past this raw-XOR budget a matrix leaves the baked
# route, as in the reference; the budget bounds host planning time and
# does not depend on the card.
_BAKED_XOR_BUDGET = 60_000

# The fused kernel parks all 8K input planes of its column tile in shared
# memory before its network runs, so a warp's 32-column tile needs
# 8 * K * 32 * 4 B <= 227 KB over K byte rows: K <= 227 (k for GF(2^8), 2k
# for GF(2^16)). Output rows take no slots, and the pipeline's kernels hold
# no whole rows at all. The reference's bound (96, on max(k, r) byte rows)
# models its TPU pack stage's VMEM tiles instead.
_BAKED_MAX_ROWS = SMEM_BYTES // (8 * 32 * 4)

# Past this raw-XOR budget the reference leaves the XOR-network kernels for
# the dense MXU product (pallas_gf2mm.PANEL_XOR_BUDGET), and so does the
# port, for K8. No RS parity matrix with k + r <= 256 reaches it over
# GF(2^8) (RS(128,128)'s, the widest, has 533,504 raw XORs); a denser
# GF(2^8) matrix can, and so do GF(2^16)'s wide codes, from RS(200,56) on.
PANEL_XOR_BUDGET = 600_000

# Pad-to multiples of the words entries: the lane-pack grouping unit at
# TL = 128 (8*8*128 words, 32 KiB per GF(2^8) shard), and the reference's
# interleaved-u16 unit (64 KiB per GF(2^16) shard), as in the reference.
# K8 pads only to its own tile.
WORD_QUANTUM = lane_quantum(8)
WORD_QUANTUM16 = lane_quantum(16)

_TIERS = (None, "fused", "split", "pipeline")

# Expansions kept per codec: a GF(2^16) RS(200,56) parity matrix's is
# 2.9 MB; what each plan needs is cached beside it.
_BITS_CACHE = 16


def decode1_fold_matrix(gf: GF, A: np.ndarray, j: int) -> np.ndarray:
    """(r2, m) matrix folding the single-corrupt-row decode into ONE
    generator-shaped product (same per-column guarantee as matrix/bw.py).

    With aug = [A | I] the parity check over the m received rows and
    p0 the first check row seeing basis column j:

    - row 0 = e_j ^ inv(A[p0,j]) * aug[p0]  — applied to the received
      rows this is rows[j] ^ inv(A[p0,j]) * s_p0, i.e. row j with the
      single-support correction applied (the e_j and aug terms cancel
      at column j, so the corrupted row is reconstructed from the
      others — correcting a fully-corrupt row IS reconstruction);
    - rows 1.. = aug[q] ^ (A[q,j]/A[p0,j]) * aug[p0] for q != p0 —
      each is s_q ^ c_q * s_p0, zero exactly where check row q is
      consistent with the hypothesis "only row j is in error". A
      column with ANY nonzero verify symbol must be re-decoded by the
      general host path; columns that verify (including clean columns,
      where s_p0 = 0 makes the correction a no-op) are exact.

    Raises ValueError for fewer than two check rows (one parity row leaves
    no consistency rows, so a mask would claim every column verified with
    nothing behind it), a ``j`` outside the basis, or an all-zero check
    column.
    """
    A = np.asarray(A, dtype=gf.dtype)
    r2, k = A.shape
    if r2 < 2:
        raise ValueError(
            f"single-support decode needs >= 2 check rows, got {r2}"
        )
    if not 0 <= j < k:
        raise ValueError(f"j must index a basis row, got {j}")
    nz = np.flatnonzero(A[:, j])
    if nz.size == 0:
        raise ValueError(f"check column {j} is identically zero")
    p0 = int(nz[0])
    aug = np.concatenate([A, np.eye(r2, dtype=gf.dtype)], axis=1)
    inv_c = int(gf.inv(int(A[p0, j])))
    D = np.zeros((r2, k + r2), dtype=gf.dtype)
    D[0, j] = 1
    D[0] ^= gf.mul(inv_c, aug[p0].astype(np.int64)).astype(gf.dtype)
    out_i = 1
    for q in range(r2):
        if q == p0:
            continue
        c_q = int(gf.mul(int(A[q, j]), inv_c))
        D[out_i] = aug[q] ^ gf.mul(
            c_q, aug[p0].astype(np.int64)
        ).astype(gf.dtype)
        out_i += 1
    return D


def _or_rows(rows: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the leading axis of a (n >= 1, ...) int tensor."""
    out = rows[0].clone()
    for q in range(1, rows.shape[0]):
        out |= rows[q]
    return out


def pad_words(TW: int, quantum: int = WORD_QUANTUM) -> int:
    return -(-TW // quantum) * quantum


def _quantum(kind: str) -> int:
    return MXU_TILE_WORDS if kind == "mxu" else WORD_QUANTUM


def tile_label(tiles, G: int) -> str:
    """A K7 plan (its :class:`~noise_ec_tpu_torch.ops.gf2tile.MaskTiles`
    and G) as the ``tile`` label of the ``noise_ec_kernel_tile_*``
    families: the K tile, the row groups and their warps, the column warps
    and the K sub-launches (the reference's ``kb{KB}_rb{RB}_tl{TL}``
    names its own plan's shape)."""
    return (f"kt{tiles.KT}_rg{tiles.NRG}_wr{tiles.WR}_wc{tiles.WC}"
            f"_g{G}")


_sublaunch_children: dict[str, object] = {}


def record_sublaunch_dispatch(entry: str, g: int) -> None:
    """Count a panel-routed dispatch's G K sub-launches against
    ``noise_ec_kernel_sublaunch_dispatches_total{entry}``, as the
    reference does on every panel dispatch (G is 1 where the plan splits
    no K axis)."""
    child = _sublaunch_children.get(entry)
    if child is None:
        child = _sublaunch_children[entry] = default_registry().counter(
            "noise_ec_kernel_sublaunch_dispatches_total"
        ).labels(entry=entry)
    child.add(g)


class StagingPool:
    """Reusable host staging buffers per shape, pinned when the codec runs
    on the card (the counterpart of the reference's ``DeviceBufferPool``),
    so a call pays the payload copy and not a pinned allocation, and the
    donation record of the tensors callers hand to the words entries.

    The pad columns past a payload are not zeroed: the product is
    positionwise, and their output columns are dropped. A buffer backs an
    asynchronous host-to-device copy, so release it only after that
    dispatch's output has come back. ``noise_ec_device_buffer_pool_
    {hits,misses}_total`` count the reuse: a buffer from the pool is a
    hit, a fresh allocation a miss.
    """

    def __init__(self, pin: bool, max_per_key: int = 8):
        self.pin = pin
        self.max_per_key = max_per_key
        self._lock = threading.Lock()
        self._free: dict[tuple[int, int], list[torch.Tensor]] = {}
        # id(tensor) -> weakref: present means the tensor was donated.
        self._donated: dict[int, weakref.ref] = {}
        reg = default_registry()
        self._hits = reg.counter(
            "noise_ec_device_buffer_pool_hits_total").labels()
        self._misses = reg.counter(
            "noise_ec_device_buffer_pool_misses_total").labels()

    def acquire(self, rows: int, cols: int) -> torch.Tensor:
        with self._lock:
            stack = self._free.get((rows, cols))
            buf = stack.pop() if stack else None
        if buf is not None:
            self._hits.add(1)
            return buf
        self._misses.add(1)
        return torch.empty((rows, cols), dtype=torch.uint8,
                           pin_memory=self.pin)

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            stack = self._free.setdefault(tuple(buf.shape), [])
            if len(stack) < self.max_per_key:
                stack.append(buf)

    def donate(self, x) -> None:
        """Record that a caller handed ``x`` over (``donate=True``). A
        tensor may be donated exactly once: a second donation of the same
        live tensor is a use after free in waiting, and raises."""
        key = id(x)
        with self._lock:
            prior = self._donated.get(key)
            if prior is not None and prior() is x:
                raise RuntimeError(
                    "device buffer donated twice (donation hands the "
                    "input over exactly once)")
            self._donated[key] = weakref.ref(
                x, lambda _, k=key: self._donated.pop(k, None))

    def was_donated(self, x) -> bool:
        with self._lock:
            prior = self._donated.get(id(x))
        return prior is not None and prior() is x


class DeviceCodec:
    """Runs GF(2^8) or GF(2^16) matrix x stripes products on ``device``
    (module doc)."""

    def __init__(self, field: str = "gf256", device: str = "cuda"):
        if field not in _FIELDS:
            raise ValueError(f"unknown field {field!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceCodec(device='cuda') needs a CUDA device and none "
                    "is available; pass device='cpu' to run on the host"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # Build (or find) and load the kernels now: a build failure
            # raises here, before any breaker is consulted.
            library()
            from noise_ec_tpu_torch.ops import expose_launch_counts

            expose_launch_counts()
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {device!r}")
        self.field = field
        self.gf: GF = _FIELDS[field]()
        # Byte rows a symbol row spans: the byte-sliced GF(2^16) route runs
        # the m=8 kernels over two per shard.
        self.sym_bytes = self.gf.degree // 8
        self._bits_cache: dict[bytes, np.ndarray] = {}
        self._rows_cache: dict[bytes, tuple] = {}
        self._cost_cache: dict[bytes, int] = {}
        self._plan_cache: dict[tuple, tuple] = {}
        self._pool = StagingPool(pin=self.device.type == "cuda")

    def _key(self, M: np.ndarray) -> bytes:
        return M.tobytes() + M.shape[1].to_bytes(4, "little")

    def _bits_for(self, M: np.ndarray) -> np.ndarray:
        """M's (m*r, m*k) GF(2) expansion, cached: the one expansion the
        XOR cost, the network's terms and K8's operand all derive from."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._bits_cache.get(key)
        if hit is None:
            hit = expand_generator_bits(self.gf, M)
            if len(self._bits_cache) >= _BITS_CACHE:
                self._bits_cache.clear()
            self._bits_cache[key] = hit
        return hit

    def bits_rows_for(self, M: np.ndarray) -> tuple:
        """(r, k) GF matrix -> hashable per-row term tuples of its (m*r,
        m*k) bit matrix (cached). A network past the panel tier's XOR
        budget never reaches factoring: the stripes and byte-rows entries
        run it on K8 instead."""
        if self._xor_cost_for(M) > PANEL_XOR_BUDGET:
            raise NotImplementedError(
                "matrix exceeds the panel-tier XOR budget: its route is "
                "'mxu' (K8), which takes no XOR network"
            )
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._rows_cache.get(key)
        if hit is None:
            hit = bits_to_rows(self._bits_for(M))
            if len(self._rows_cache) > 4096:
                self._rows_cache.clear()
            self._rows_cache[key] = hit
        return hit

    def _xor_cost_for(self, M: np.ndarray) -> int:
        """Raw two-input XOR count of M's GF(2) bit network (set bits minus
        output rows), cached — the route_for decision input."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = self._key(M)
        hit = self._cost_cache.get(key)
        if hit is None:
            bits = self._bits_for(M)
            hit = int(np.count_nonzero(bits)) - bits.shape[0]
            if len(self._cost_cache) > 4096:
                self._cost_cache.clear()
            self._cost_cache[key] = hit
        return hit

    def route_for(self, M: np.ndarray) -> str:
        """Which kernel family runs this matrix: "baked" (K1, K5, or K2 ->
        K4 -> K3), "panel" (wide geometries: K6 -> K7) or "mxu" (past every
        XOR-network budget: K8) — the reference's three-way answer, with
        the port's thresholds (module constants). The row bound counts
        input byte rows: k for GF(2^8), 2k for GF(2^16)."""
        rows = self.sym_bytes * np.asarray(M).shape[1]
        cost = self._xor_cost_for(M)
        if cost > PANEL_XOR_BUDGET:
            return "mxu"
        if rows > _BAKED_MAX_ROWS or cost > _BAKED_XOR_BUDGET:
            return "panel"
        return "baked"

    def plan_for(self, M: np.ndarray, tier: Optional[str] = None) -> tuple:
        """(kind, threads, operand on the codec's device, G) for ``M``,
        cached per matrix, over C = 8 * (input byte rows) bit planes: G is
        the number of launches the product's K axis is split into.

        On the baked route, ``tier`` None takes the planner's choice:
        "split" when K5's ring fits (its operand a :class:`~noise_ec_tpu_
        torch.ops.gf2tile.MaskTiles`), else "fused" when K1's slots do
        (ops/fused.py), else "pipeline"; G is 1. Passing "fused", "split"
        or "pipeline" forces one, as the reference's plan override does;
        forcing "fused" or "split" on a matrix its kernel cannot hold
        raises. A panel-routed matrix plans kind "panel" with a
        :class:`~noise_ec_tpu_torch.ops.gf2tile.MaskTiles` and the
        planner's G (ops/panel.py :func:`panel_plan`); an "mxu" matrix
        plans kind "mxu" with K8's tiled bit matrix (an
        :class:`~noise_ec_tpu_torch.ops.mxu.MxuTiles`; threads None, G 1).
        Neither takes a tier."""
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        key = (self._key(M), tier)
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit  # planned before, so ``tier`` suited its route
        with device_span("codec.plan"):
            return self._plan(M, tier, key)

    def _plan(self, M: np.ndarray, tier: Optional[str], key: tuple) -> tuple:
        """Plan ``M`` on a miss in the plan cache (:meth:`plan_for`)."""
        route = self.route_for(M)
        if route != "baked" and tier is not None:
            raise ValueError(
                f"tier {tier!r} forces a baked-route kernel; this matrix "
                f"routes {route!r}"
            )
        if route == "mxu":
            bits = torch.from_numpy(self._bits_for(M).view(np.int8))
            hit = ("mxu", None, build_mxu_tiles(
                bits, self.sym_bytes * M.shape[0],
                self.sym_bytes * M.shape[1]), 1)
        else:
            bits_rows = self.bits_rows_for(M)
            C = 8 * self.sym_bytes * M.shape[1]
            if route == "panel":
                threads, prog, G = panel_plan(bits_rows, C)
                hit = ("panel", threads, prog, G)
            else:
                hit = self._baked_plan(bits_rows, C, tier,
                                       8 * self.sym_bytes)
        hit = hit[:2] + (hit[2].to(self.device), hit[3])
        if len(self._plan_cache) > 1024:
            self._plan_cache.clear()
        self._plan_cache[key] = hit
        return hit

    @staticmethod
    def _baked_plan(bits_rows: tuple, C: int, tier: Optional[str],
                    m: int) -> tuple:
        """The baked route's (kind, threads, operand, 1) on the CPU: the
        first of K5, K1 and the pipeline that ``tier`` allows and whose
        plan fits (:meth:`plan_for`). K5's phases are whole symbol rows of
        m planes, so one GF(2^16) plan serves K5 at m = 8 over byte rows
        and at m = 16 over the interleaved words."""
        if tier in (None, "split"):
            plan = DeviceCodec._split_plan(bits_rows, C, m)
            if plan is not None:
                threads, _, tiles = plan
                return ("split", threads, tiles, 1)
            if tier == "split":
                raise ValueError("no split-kernel plan fits this matrix")
        if tier in (None, "fused"):
            plan = fused_plan(bits_rows, C)
            if plan is not None:
                return ("fused",) + plan + (1,)
            if tier == "fused":
                raise ValueError("no fused-kernel plan fits this matrix")
        return ("pipeline",) + sparse_plan(bits_rows, C) + (1,)

    @staticmethod
    def _split_plan(bits_rows: tuple, C: int, m: int) -> Optional[tuple]:
        """K5's plan (``fused_split_plan``) over C planes at m planes a
        symbol, or None where its ring does not fit: the baked planner's
        first choice (:meth:`_baked_plan`), which :meth:`writes_in_place`
        foresees with it."""
        return fused_split_plan(bits_rows, C // m, len(bits_rows) // m, m)

    # -- words entries (device-resident) ----------------------------------

    def _check_words(self, words: torch.Tensor, rows: int) -> None:
        if (words.dtype != torch.int32 or words.dim() != 3
                or words.shape[1] != rows):
            raise ValueError(
                f"expected int32 (B, {rows}, TW) words, got {words.dtype} "
                f"{tuple(words.shape)}"
            )
        if words.device != self.device:
            raise ValueError(
                f"words on {words.device}, codec on {self.device}"
            )

    def _route(self, M: np.ndarray, tier: Optional[str]) -> str:
        """The ``device_op`` route of a call on ``M``: "compile" when it
        will plan ``M`` (a miss in the plan cache), else "execute"."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        planned = (self._key(M), tier) in self._plan_cache
        return "execute" if planned else "compile"

    def _admit(self, entry: str, M: np.ndarray, tier: Optional[str],
               nbytes: int) -> str:
        """Count one public-entry call (obs/profiling.py) and return its
        ``device_op`` route (:meth:`_route`)."""
        record_kernel(entry, nbytes)
        return self._route(M, tier)

    def _analyze(self, dt, M: np.ndarray, rows_in: int, rows_out: int,
                 words: int) -> None:
        """On a key's first call, export the product's plan-derived cost
        (obs/device.py analyze_program) over byte rows of ``words``."""
        if dt.route == "compile":
            maybe_analyze_program(dt.entry, self._xor_cost_for(M),
                                  rows_in, rows_out, words)

    def matmul_words(self, M: np.ndarray, words: torch.Tensor, *,
                     tier: Optional[str] = None) -> torch.Tensor:
        """(k, TW) int32 words on the codec's device -> (r, TW) int32.

        The words ARE the shard bytes (little-endian int32 view: 4 GF(2^8)
        or 2 GF(2^16) symbols a word). Any TW is accepted: it is
        zero-padded on the device to the route's quantum and the product
        sliced back (symbols are positionwise, so padding is inert)."""
        return self.matmul_words_batch(M, words[None], tier=tier)[0]

    def matmul_words_batch(self, M: np.ndarray, words: torch.Tensor, *,
                           tier: Optional[str] = None,
                           donate: bool = False,
                           rows: Optional[torch.Tensor] = None,
                           out: Optional[torch.Tensor] = None,
                           out_rows: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """(B, k, TW) int32 words -> (B, r, TW): one launch per kernel for
        the whole batch (the kernels take the batch as a grid axis).

        On a GF(2^16) codec the words hold interleaved u16 symbols and run
        the kernels at 16 planes a symbol (module doc), ``tier`` as on byte
        rows; an "mxu" matrix raises NotImplementedError there, as in the
        reference: K8 takes byte rows (:meth:`matmul_words_bytesliced`).

        A GF(2^8) batch of B > 1 that is not on the "mxu" route shards over
        the mesh router when it is enabled (parallel/mesh.py) and comes back
        as one tensor on the codec's device. ``donate=True`` hands ``words``
        over: recorded once (:meth:`StagingPool.donate`; a second donation
        of the same tensor raises), and on the mesh marked in use on every
        shard's stream, so the caller may drop it at once. Nothing is
        written into it.

        Row maps, where :meth:`writes_in_place` holds: ``rows`` (k int32
        indices on the codec's device) picks M's input rows of the (B, P,
        TW) ``words``, and ``out``, a (B, N, TW) int32 tensor, takes the
        product at its rows ``out_rows`` (r indices) and is returned
        (without ``out``, a new (B, r, TW) product is). K5
        reads and stores through the maps (ops/fused.py), on the codec's
        card: nothing is gathered and no other row of ``out`` is written.
        A plan that is not K5 raises ValueError.

        Returns once the work is queued on the card: the ``device_op``
        time of this entry is the submit time. During a ``torch.profiler``
        capture the call opens the spans ``codec.plan`` (the route and
        plan lookups), ``codec.gate`` and ``codec.launch`` (obs/trace.py).
        A product with no rows or no width returns its zeros and launches
        nothing, outside the gate (as :meth:`_stripes_entry`)."""
        M = np.asarray(M)
        r, k = M.shape
        self._check_words(words, k if rows is None else words.shape[1])
        mapped = rows is not None or out is not None
        if out is not None:
            self._check_words(out, out.shape[1])
        if M.size == 0 or words.shape[2] == 0:
            if mapped:
                raise ValueError("an empty product has no rows to store")
            return words.new_zeros((words.shape[0], r, words.shape[2]))
        if donate:
            self._pool.donate(words)
        B, _, TW = words.shape
        nbytes = 4 * B * k * TW
        with device_span("codec.plan"):
            route = self._admit("matmul_words", M, tier, nbytes)
        with device_gate(), device_op("matmul_words", route, nbytes,
                                      synced=False) as dt:
            with device_span("codec.launch"):
                router = (self._mesh(B, M)
                          if self.sym_bytes == 1 and not mapped else None)
                if mapped:
                    out = self._mapped(M, words, rows, out, out_rows, tier)
                elif router is not None:
                    out = router.words_product(self, M, words, tier=tier)
                    out = out.to_tensor(self.device)
                elif self.sym_bytes == 1:
                    out = self._byte_rows(M, words, tier)
                else:
                    out = self._words16(M, words, tier)
            self._label_tile(dt, M, tier, sharded=router is not None)
            s = self.sym_bytes
            self._analyze(dt, M, B * s * k, B * s * r, TW // s)
            return out

    def _mapped(self, M: np.ndarray, words: torch.Tensor,
                rows: Optional[torch.Tensor], out: torch.Tensor,
                out_rows: Optional[torch.Tensor],
                tier: Optional[str]) -> torch.Tensor:
        """K5 through its row maps (:meth:`matmul_words_batch`'s ``rows``,
        ``out`` and ``out_rows``)."""
        kind, threads, tiles, _ = self.plan_for(M, tier)
        if kind != "split":
            raise ValueError(f"a {kind!r} plan cannot store through row "
                             f"maps; gather the rows (writes_in_place)")
        m = 8 * self.sym_bytes
        return fused_split_encode_words(
            tiles, words, M.shape[0], threads, lane_tl(words.shape[2], m),
            m=m, in_rows=rows, out=out, out_rows=out_rows)

    def writes_in_place(self, M: np.ndarray, words: torch.Tensor) -> bool:
        """Whether :meth:`matmul_words_batch` can run ``M`` on the (B, P,
        TW) int32 ``words`` through row maps: M's plan is K5 ("split": the
        plan cache's, else :meth:`_split_plan`, found without planning),
        the mesh router would not shard the batch, TW needs no padding to
        the route's quantum, and the words' rows are TW-word runs whose
        batches start 16 bytes apart. Where it cannot, the caller gathers
        the rows."""
        M = np.ascontiguousarray(np.asarray(M, dtype=self.gf.dtype))
        if (words.dim() != 3 or words.dtype != torch.int32
                or words.device != self.device):
            return False
        B, _, TW = words.shape
        s = self.sym_bytes
        quantum = WORD_QUANTUM if s == 1 else WORD_QUANTUM16
        if (M.size == 0 or TW == 0 or pad_words(TW, quantum) != TW
                or words.stride(2) != 1 or words.stride(1) != TW
                or (B > 1 and words.stride(0) % 4)
                or words.data_ptr() % 16):
            return False
        if s == 1 and self._mesh(B, M) is not None:
            return False
        hit = self._plan_cache.get((self._key(M), None))
        if hit is not None:
            return hit[0] == "split"
        return (self.route_for(M) == "baked"
                and self._split_plan(self.bits_rows_for(M),
                                     8 * s * M.shape[1], 8 * s) is not None)

    def _mesh(self, B: int, M: np.ndarray, *, padded: bool = False):
        """The mesh router when a batch of B products of ``M`` shards over
        it, else None: "mxu" matrices do not shard, as in the reference,
        and the stripes entry asks with its batch ladder-padded
        (``padded``), as the reference's does."""
        if B < 2:
            return None
        from noise_ec_tpu_torch.parallel.mesh import ladder_pad, mesh_router

        router = mesh_router()
        if not router.should_shard(ladder_pad(B) if padded else B):
            return None
        return None if self.route_for(M) == "mxu" else router

    def _label_tile(self, dt, M: np.ndarray, tier: Optional[str], *,
                    sharded: bool = False) -> None:
        """On the panel route, name the dispatch's K7 plan in its
        ``device_op`` window (:func:`tile_label`) and count its K
        sub-launches; a sharded dispatch's are the mesh tier's
        ("mesh_words", as in the reference)."""
        if self.route_for(M) != "panel":
            return
        _, _, prog, G = self.plan_for(M, tier)
        dt.tile = tile_label(prog, G)
        if not sharded:
            record_sublaunch_dispatch(dt.entry, G)

    def matmul_words_bytesliced(self, M: np.ndarray,
                                words: torch.Tensor) -> torch.Tensor:
        """GF(2^16) only: (2k, TW) int32 words over byte rows (shard j's lo
        bytes at row 2j, its hi bytes at 2j+1: the device-resident form of
        the byte-sliced route, ``words16_to_bytesliced``) -> (2r, TW), on
        whichever route the matrix takes."""
        if self.sym_bytes != 2:
            raise ValueError("matmul_words_bytesliced is gf65536-only")
        M = np.asarray(M)
        if words.dim() != 2:
            raise ValueError(f"expected (2k, TW) words, got "
                             f"{tuple(words.shape)}")
        self._check_words(words[None], 2 * M.shape[1])
        if M.size == 0 or words.shape[1] == 0:
            return words.new_zeros((2 * M.shape[0], words.shape[1]))
        nbytes = 4 * words.numel()
        route = self._admit("matmul_words_bytesliced", M, None, nbytes)
        with device_gate(), device_op("matmul_words_bytesliced", route,
                                      nbytes, synced=False) as dt:
            out = self._byte_rows(M, words[None], None)[0]
            self._label_tile(dt, M, None)
            self._analyze(dt, M, words.shape[0], 2 * M.shape[0],
                          words.shape[1])
            return out

    def _byte_rows(self, M: np.ndarray, words: torch.Tensor,
                   tier: Optional[str]) -> torch.Tensor:
        """(B, K, TW) int32 words over K = sym_bytes * k byte rows -> (B,
        R, TW), R = sym_bytes * r, through M's plan."""
        kind, threads, prog, G = self.plan_for(M, tier)
        R = self.sym_bytes * M.shape[0]
        B, K, TW = words.shape
        TWp = pad_words(TW, _quantum(kind))
        if TWp != TW:
            words = F.pad(words, (0, TWp - TW))
        words = words.contiguous()
        if kind == "mxu":
            out = mxu_encode_tiles(prog, words)
        elif kind == "fused":
            out = fused_encode_words(prog, words, R, threads, lane_tl(TWp))
        elif kind == "split":
            out = fused_split_encode_words(prog, words, R, threads,
                                           lane_tl(TWp))
        elif kind == "panel":
            # Pack and unpack share the blocked TL by construction.
            W8 = TWp // 64
            planes = pack_words_lanes_blocked(words.reshape(B * K, TWp))
            out = gf2_matmul_panel_chain(
                prog, planes.reshape(B, 8 * K, 8, W8), threads, G)
            out = unpack_words_lanes_blocked(out.reshape(B * R, 8, 8, W8))
            out = out.reshape(B, R, TWp)
        else:
            W8 = TWp // 64
            tl = lane_tl(TWp)
            planes = pack_words_lanes(words.reshape(B * K, TWp), tl)
            out = gf2_matmul_sparse(prog, planes.reshape(B, 8 * K, 8, W8),
                                    threads)
            out = unpack_words_lanes(out.reshape(B * R, 8, 8, W8), tl)
            out = out.reshape(B, R, TWp)
        return out[:, :, :TW] if TWp != TW else out

    def _words16(self, M: np.ndarray, words: torch.Tensor,
                 tier: Optional[str]) -> torch.Tensor:
        """Interleaved-u16 (B, k, TW) words -> (B, r, TW) over 16 planes a
        shard, through M's plan (:meth:`plan_for`, the byte-sliced entry's
        plan: its operands are the same planes) on the m = 16 kernels."""
        if self.route_for(M) == "mxu":
            raise NotImplementedError(
                "over-budget GF(2^16) matrices run K8 on the byte-sliced "
                "entries (matmul_words_bytesliced / matmul_stripes), not "
                "the interleaved words entry"
            )
        kind, threads, prog, G = self.plan_for(M, tier)
        r, k = M.shape
        B, _, TW = words.shape
        TWp = pad_words(TW, WORD_QUANTUM16)
        if TWp != TW:
            words = F.pad(words, (0, TWp - TW))
        words = words.contiguous()
        W8 = TWp // 128
        if kind == "split":
            out = fused_split_encode_words(prog, words, r, threads,
                                           lane_tl(TWp, 16), m=16)
        elif kind == "fused":
            out = fused_encode_words(prog, words, r, threads,
                                     lane_tl(TWp, 16), m=16)
        elif kind == "panel":
            planes = pack_words_lanes_blocked(words.reshape(B * k, TWp), 16)
            out = gf2_matmul_panel_chain(
                prog, planes.reshape(B, 16 * k, 8, W8), threads, G)
            out = unpack_words_lanes_blocked(out.reshape(B * r, 16, 8, W8))
            out = out.reshape(B, r, TWp)
        elif reference_lane_tl(TWp, 16, max(k, r)) is not None:
            tl = lane_tl(TWp, 16)
            planes = pack_words_lanes(words.reshape(B * k, TWp), tl, 16)
            out = gf2_matmul_sparse(prog, planes.reshape(B, 16 * k, 8, W8),
                                    threads)
            out = unpack_words_lanes(out.reshape(B * r, 16, 8, W8), tl)
            out = out.reshape(B, r, TWp)
        else:
            planes = pack_words16(words.reshape(B * k, TWp))
            out = gf2_matmul_sparse(prog, planes.reshape(B, 16 * k, 8, W8),
                                    threads)
            out = unpack_words16(out.reshape(B * r, 16, TWp // 16))
            out = out.reshape(B, r, TWp)
        return out[:, :, :TW] if TWp != TW else out

    # -- the error-correcting decode's entries (matrix/bw.py) -------------

    def syndrome_stripes(
        self, A: np.ndarray, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Decode syndrome on the card: s = A @ rows[:k] ^ rows[k:].

        ``A`` is the (m-k, k) basis-prediction matrix of the
        error-correcting decode (matrix/bw.py); ``rows`` the full (m, S)
        received stripes. XOR is addition in the field, so this is ONE
        generator-shaped product with the augmented matrix [A | I] over
        all m rows, on the same kernels as encode, through
        :meth:`matmul_stripes` (whose gate slot and ``device_op`` window it
        takes, as in the reference). Returns (s, per-column nonzero-row
        counts); the counts are taken on the host."""
        A = np.asarray(A, dtype=self.gf.dtype)
        r2, k = A.shape
        rows = np.asarray(rows, dtype=self.gf.dtype)
        if rows.shape[0] != k + r2:
            raise ValueError(f"expected {k + r2} rows, got {rows.shape[0]}")
        aug = np.concatenate([A, np.eye(r2, dtype=self.gf.dtype)], axis=1)
        s = self.matmul_stripes(aug, rows)
        return s, np.count_nonzero(s, axis=0)

    def decode1_words(self, A: np.ndarray, j: int,
                      rows_words: torch.Tensor) -> tuple:
        """Device-resident single-corrupt-row decode step (GF(2^8)).

        ``rows_words``: (m, TW) int32 words of all m received stripes on
        the codec's device, any TW. Returns (corrected row j (TW,), the
        OR-fold of the consistency rows (TW,)): a nonzero byte of the
        second means that byte column defeated the single-support
        hypothesis and must go through the general path. One
        generator-shaped product (:meth:`matmul_words`, whose gate slot
        and ``device_op`` window it takes) and an OR."""
        D = decode1_fold_matrix(self.gf, A, j)  # raises for r2 < 2
        out = self.matmul_words(D, rows_words)
        return out[0], _or_rows(out[1:])

    def decode1_words_bytesliced(self, A: np.ndarray, j: int,
                                 rows_words: torch.Tensor) -> tuple:
        """The GF(2^16) twin of :meth:`decode1_words` on byte-sliced words.

        ``rows_words``: (2m, TW) int32 byte-sliced words of all m received
        stripes (share i's lo-byte row at 2i, its hi-byte row at 2i + 1:
        ``ops.pack.words16_to_bytesliced``). Returns (the corrected row j
        as its two byte rows (2, TW), the OR-fold of every consistency
        byte row (TW,)): a u16 column is bad where either of its byte
        columns is nonzero. One byte-sliced product
        (:meth:`matmul_words_bytesliced`, whose gate slot and
        ``device_op`` window it takes)."""
        D = decode1_fold_matrix(self.gf, A, j)  # raises for r2 < 2
        out = self.matmul_words_bytesliced(D, rows_words)
        return out[:2], _or_rows(out[2:])

    # -- stripes entries (host arrays) -------------------------------------

    def matmul_stripes(self, M: np.ndarray, D, *,
                       tier: Optional[str] = None) -> np.ndarray:
        """(r, k) GF matrix x (k, S) symbol stripes (uint8 for GF(2^8),
        uint16 for GF(2^16)) -> (r, S), computed on the codec's device and
        returned as a host array (so its ``device_op`` time covers the
        device round trip)."""
        M = np.asarray(M)
        D = np.asarray(D, dtype=self.gf.dtype)
        if D.shape[0] != M.shape[1]:
            raise ValueError(
                f"matrix cols {M.shape[1]} != stripe rows {D.shape[0]}"
            )
        return self._stripes_entry(M, [D], tier)[0]

    def matmul_stripes_many(self, M: np.ndarray, Ds: list) -> list:
        """B same-shape stripes products through one batched dispatch (the
        CoalescingDispatcher's batch entry), byte-identical to B
        :meth:`matmul_stripes` calls. The reference rounds B up a
        power-of-two ladder to bound JAX recompiles; these kernels are
        shape-generic, so the batch runs at its own size."""
        Ds = [np.asarray(D, dtype=self.gf.dtype) for D in Ds]
        if not Ds:
            return []
        M = np.asarray(M)
        k = M.shape[1]
        S = Ds[0].shape[1]
        for D in Ds:
            if D.shape != (k, S):
                raise ValueError(
                    "matmul_stripes_many requires same-shape stripes "
                    f"(got {D.shape} vs {(k, S)})"
                )
        return self._stripes_entry(M, Ds, None)

    def _stripes_entry(self, M: np.ndarray, Ds: list,
                       tier: Optional[str]) -> list:
        """The gated, timed body of both stripes entries (one entry name,
        "matmul_stripes", as in the reference). A product with no rows or
        no width returns its empty (r, S) result here: it launches
        nothing, so it takes no gate slot and is no device call."""
        if M.size == 0 or Ds[0].shape[1] == 0:
            return [np.zeros((M.shape[0], D.shape[1]), self.gf.dtype)
                    for D in Ds]
        nbytes = sum(D.nbytes for D in Ds)
        route = self._admit("matmul_stripes", M, tier, nbytes)
        with device_gate(), device_op("matmul_stripes", route,
                                      nbytes) as dt:
            router = self._mesh(len(Ds), M, padded=True)
            out = self._stripes(M, Ds, tier, router=router)
            self._label_tile(dt, M, tier, sharded=router is not None)
            s = self.sym_bytes
            B = len(Ds)
            self._analyze(dt, M, B * s * M.shape[1], B * s * M.shape[0],
                          -(-Ds[0].nbytes // (4 * s * M.shape[1])))
            return out

    def _stripes(self, M: np.ndarray, Ds: list, tier: Optional[str], *,
                 router=None, n_dev: Optional[int] = None) -> list:
        """Stage B same-shape (k, S) stripes as byte-row words (GF(2^16)
        byte-sliced) in a pooled page and run their product: on the
        codec's device, or with ``router`` sharded over its mesh (each
        shard copied from the page to its own device; ``n_dev`` forces the
        positions). Returns B host arrays."""
        kind = self.plan_for(M, tier)[0]
        B = len(Ds)
        k, S = Ds[0].shape
        K = self.sym_bytes * k  # byte rows a member, S bytes each
        TWp = pad_words(-(-S // 4), _quantum(kind))
        buf = self._pool.acquire(B * K, 4 * TWp)
        host = buf.numpy()
        for b, D in enumerate(Ds):
            rows = host[b * K:(b + 1) * K]
            if self.sym_bytes == 2:
                pack_u16_bytesliced(D, out=rows)
            else:
                rows[:, :S] = D
        words = buf.view(torch.int32).reshape(B, K, TWp)
        if router is not None:
            out = router.words_product(self, M, words, tier=tier, staged=True,
                                       n_dev=n_dev).to_tensor("cpu")
        else:
            words = words.to(self.device, non_blocking=True)
            out = self._byte_rows(M, words, tier).cpu()
        # The product is on the host, so the copies out of the staging page
        # have finished: the page may go to the next dispatch.
        self._pool.release(buf)
        res = out.numpy().view(np.uint8)  # (B, R, 4 * TWp) byte rows
        if self.sym_bytes == 2:
            return [unpack_u16_bytesliced(res[b, :, :S]) for b in range(B)]
        return [np.ascontiguousarray(res[b, :, :S]) for b in range(B)]


def prewarm_ladder(codec: DeviceCodec, G: np.ndarray, k: int,
                   stripe_bytes: int = 4096, max_batch: int = 8) -> int:
    """Plan an RS(k, n) geometry before traffic arrives, so its first live
    calls find their plans cached: the parity matrix ``G[k:]`` and the
    recovery matrix of each single lost data share (the first k present
    rows as basis, as ``ReedSolomon.reconstruct`` picks it) through
    :meth:`DeviceCodec.plan_for`, then one batched parity product at each
    power-of-two batch size up to ``max_batch``. The reference's hook of
    the same name compiles its batch-ladder programs; these kernels are
    shape-generic, so a plan serves every batch size and the ladder runs
    each size once. Returns the number of ladder rungs run."""
    from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

    G = np.asarray(G, dtype=codec.gf.dtype)
    n = G.shape[0]
    if n == k:
        return 0  # no parity: nothing to plan
    parity = G[k:]
    codec.plan_for(parity)
    for j in range(k):
        basis = [i for i in range(k + 1) if i != j]
        codec.plan_for(reconstruction_matrix(codec.gf, G, basis, [j]))
    warmed = 0
    B = 1
    while B <= max_batch:
        codec.matmul_stripes_many(
            parity, [np.zeros((k, stripe_bytes), dtype=codec.gf.dtype)
                     for _ in range(B)])
        warmed += 1
        B *= 2
    return warmed
