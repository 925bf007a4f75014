"""Device telemetry: dispatch latency, compile tracking, roofline, memory.

Port of ``noise_ec_tpu.obs.device`` for the CUDA card. Its surfaces:

- **Dispatch latency with a compile/execute split** —
  :func:`device_op` wraps every public ``DeviceCodec`` entry. The codec
  names the route: a call that has to plan its matrix (a miss in the
  codec's plan cache; the kernel library is already loaded by the codec's
  constructor) records as ``route="compile"`` into
  ``noise_ec_device_op_seconds{kernel,route}`` and feeds
  ``noise_ec_jit_compiles_total{kernel}`` plus the compile-seconds
  histogram (the names are the reference's: :data:`~noise_ec_tpu_torch.
  obs.registry.METRICS` is a copy). A call that finds its plan records as
  ``route="execute"`` on the device-scale (half-octave, µs-range) buckets.
  The clock is the host's, as in the reference: an entry that returns
  host arrays (``matmul_stripes``) times the device round trip, while the
  words entries return before the card finishes, so their "execute" time
  is the submit time. No synchronise is added to time them.
- **Words entries' device time** — during a ``torch.profiler`` capture
  (``GET /xprof``), :func:`entry_scope` roots each ``BatchCodec`` words
  entry: its span (obs/trace.py) and, on a card, a pair of CUDA timing
  events whose interval lands in ``noise_ec_batch_device_seconds{entry}``
  once a later entry finds it done (:func:`resolve_entry_events`).
- **Roofline** — :func:`analyze_program` takes the plan's own counts
  (no compiler cost analysis exists for a hand-written kernel): bytes
  moved ``4 x (input rows + output rows) x words`` and operations ``raw
  XOR terms x the words one term XORs`` (a bit plane of a TW-word row is
  TW / 8 words), and exports per-kernel program-cost and
  operational-intensity gauges. ``noise_ec_roofline_utilization{kernel}``
  reads achieved payload bandwidth (cumulative execute bytes / execute
  seconds) over :func:`peak_hbm_gbps` at collect time, only for entries
  whose host time covers the device's work (``synced``): a submit time
  says nothing of the card's bandwidth, so the words entries export none.
- **Per-tile attribution** — a dispatch on the panel route names its
  K7 plan in :attr:`DeviceOpTimer.tile` (``ops/dispatch.py``
  ``tile_label``), and the exit path feeds
  ``noise_ec_kernel_tile_{dispatches,bytes}_total{entry,tile}`` and, on
  the execute route of a synced entry, the
  ``noise_ec_kernel_tile_utilization`` gauge (:func:`record_tile_dispatch`,
  :func:`tile_summary`).
- **Device memory** — :func:`hbm_snapshot` reads
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
  ``mem_get_info``, exported as callback gauges; :func:`roofline_summary`
  folds it into one flat report with the achieved bandwidths.

Hot-path budget: a warm dispatch pays one perf_counter pair and one
cached-child histogram observe.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.trace import _NOOP, default_tracer, profiling

__all__ = [
    "DeviceOpTimer",
    "analyze_program",
    "achieved_gbps",
    "device_op",
    "entry_scope",
    "hbm_snapshot",
    "install_hbm_gauges",
    "maybe_analyze_program",
    "peak_hbm_gbps",
    "record_tile_dispatch",
    "reset_dispatch_tracking",
    "resolve_entry_events",
    "roofline_summary",
    "set_analysis_interval",
    "set_peak_hbm_gbps",
    "tile_achieved_gbps",
    "tile_summary",
]

log = logging.getLogger("noise_ec_tpu_torch.obs")

_lock = threading.Lock()
# (kernel, route) -> histogram child; kernel -> (counter, hist) children.
# Default-registry only: a transient Registry must
# not pin stale children.
_op_children: dict[tuple[str, str], object] = {}
_compile_children: dict[str, tuple] = {}
# kernel -> [execute_bytes_total, execute_seconds_total] for the achieved-
# bandwidth side of the roofline gauges.
_op_stats: dict[str, list] = {}
_gauges_installed = False

# Peak HBM bandwidth of the card the port targets, GB/s: the H100 SXM's
# 3.35 TB/s, the figure the kernels' bounds use. Override with
# set_peak_hbm_gbps for another card.
_PEAK_GBPS = 3350.0
_peak_override: Optional[float] = None


def set_peak_hbm_gbps(gbps: Optional[float]) -> None:
    """Pin the roofline's peak-bandwidth denominator (None restores the
    H100 SXM figure)."""
    global _peak_override
    _peak_override = gbps


def peak_hbm_gbps() -> float:
    if _peak_override is not None:
        return _peak_override
    return _PEAK_GBPS


def reset_dispatch_tracking() -> None:
    """Forget the per-kernel and per-tile bandwidth stats and the analysis
    clock (tests)."""
    with _lock:
        _op_stats.clear()
        _tile_stats.clear()
        _last_analysis.clear()


class DeviceOpTimer:
    """Times one dispatch and records it under its route on exit; a
    dispatch that raises records nothing.

    A class-based context manager: the generator machinery costs ~3x on
    a path measured in microseconds.

    ``tile`` is the per-dispatch tile attribution: a dispatch that runs
    the block-panel kernel K7 sets it to its plan's ``tile_label`` before
    the window closes, and the exit path feeds the
    ``noise_ec_kernel_tile_*`` families (:func:`record_tile_dispatch`).
    """

    __slots__ = ("entry", "route", "nbytes", "registry", "synced",
                 "elapsed", "tile", "_t0")

    def __init__(self, entry: str, route: str, nbytes: int,
                 registry: Optional[Registry], synced: bool):
        if route not in ("compile", "execute"):
            raise ValueError(f"unknown route {route!r}")
        self.entry = entry
        self.route = route
        self.nbytes = nbytes
        self.registry = registry
        self.synced = synced
        self.elapsed = 0.0
        self.tile = ""

    def __enter__(self) -> "DeviceOpTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        if exc is not None:
            return False
        reg = self.registry
        if reg is None:
            op = _op_children.get((self.entry, self.route))
            if op is None:
                op = _op_children[(self.entry, self.route)] = (
                    default_registry().histogram(
                        "noise_ec_device_op_seconds"
                    ).labels(kernel=self.entry, route=self.route)
                )
        else:
            op = reg.histogram("noise_ec_device_op_seconds").labels(
                kernel=self.entry, route=self.route
            )
        op.observe(self.elapsed)
        if self.route == "compile":
            self._record_compile(reg)
        elif self.synced:
            with _lock:
                st = _op_stats.get(self.entry)
                if st is None:
                    st = _op_stats[self.entry] = [0.0, 0.0]
                    _install_utilization_gauge(self.entry, reg)
                st[0] += self.nbytes
                st[1] += self.elapsed
        if self.tile:
            record_tile_dispatch(
                self.entry, self.tile, self.nbytes, self.elapsed,
                route=self.route, synced=self.synced, registry=reg,
            )
        return False

    def _record_compile(self, reg: Optional[Registry]) -> None:
        if reg is None:
            pair = _compile_children.get(self.entry)
            if pair is None:
                r = default_registry()
                pair = _compile_children[self.entry] = (
                    r.counter("noise_ec_jit_compiles_total").labels(
                        kernel=self.entry
                    ),
                    r.histogram("noise_ec_jit_compile_seconds").labels(
                        kernel=self.entry
                    ),
                )
        else:
            pair = (
                reg.counter("noise_ec_jit_compiles_total").labels(
                    kernel=self.entry
                ),
                reg.histogram("noise_ec_jit_compile_seconds").labels(
                    kernel=self.entry
                ),
            )
        pair[0].add(1)
        pair[1].observe(self.elapsed)


def device_op(entry: str, route: str, nbytes: int = 0,
              registry: Optional[Registry] = None, *,
              synced: bool = True) -> DeviceOpTimer:
    """``with device_op("matmul_stripes", route, nbytes):`` around one
    DeviceCodec dispatch; ``route`` is "compile" for a call that plans
    its matrix, else "execute". ``synced=False`` marks an entry that
    returns before the card finishes: it is timed like any other, but
    feeds no roofline gauge. Also installs the HBM gauges on first use so
    any process that dispatches exports memory headroom."""
    install_hbm_gauges(registry)
    return DeviceOpTimer(entry, route, nbytes, registry, synced)


# ------------------------------------------------------------------ roofline


def achieved_gbps(entry: str) -> float:
    """Cumulative execute-route payload bandwidth for one synced kernel
    entry (0.0 until a warm dispatch lands)."""
    with _lock:
        st = _op_stats.get(entry)
    if not st or st[1] <= 0:
        return 0.0
    return st[0] / st[1] / 1e9


def _install_utilization_gauge(entry: str,
                               registry: Optional[Registry]) -> None:
    reg = registry if registry is not None else default_registry()
    try:
        reg.gauge("noise_ec_roofline_utilization").set_callback(
            lambda e=entry: achieved_gbps(e) / max(peak_hbm_gbps(), 1e-9),
            kernel=entry,
        )
    except Exception:  # noqa: BLE001 — a gauge must not fail a dispatch
        log.debug("roofline gauge install failed for %s", entry)


# -------------------------------------------------- per-tile attribution
#
# K7's planner picks a block shape per matrix (ops/panel.py panel_plan:
# the K tile, the row groups and their warps, the column warps, and the G
# launches its K axis is split into). These families make the chosen
# shape a LABEL, so whether a plan delivers is answerable per shape:
# dispatch and byte counters, and an achieved-bandwidth-over-peak gauge
# per (entry, tile) for the entries whose host time covers the card's work.

# (entry, tile) -> [execute_bytes_total, execute_seconds_total]
_tile_stats: dict[tuple[str, str], list] = {}
_tile_children: dict[tuple[str, str], tuple] = {}


def tile_achieved_gbps(entry: str, tile: str) -> float:
    """Cumulative execute-route payload bandwidth for one (kernel entry,
    tile) pair of a synced entry (0.0 until a warm dispatch lands)."""
    with _lock:
        st = _tile_stats.get((entry, tile))
    if not st or st[1] <= 0:
        return 0.0
    return st[0] / st[1] / 1e9


def record_tile_dispatch(entry: str, tile: str, nbytes: int,
                         seconds: float, *, route: str = "execute",
                         synced: bool = True,
                         registry: Optional[Registry] = None) -> None:
    """Attribute one dispatch to its tile (module comment). Every
    dispatch counts its call and bytes; only an execute-route dispatch of
    a synced entry feeds the bandwidth stats: a call that plans is not
    kernel time, and a submit time says nothing of the card's bandwidth."""
    if registry is None:
        pair = _tile_children.get((entry, tile))
        if pair is None:
            r = default_registry()
            pair = _tile_children[(entry, tile)] = (
                r.counter("noise_ec_kernel_tile_dispatches_total").labels(
                    entry=entry, tile=tile
                ),
                r.counter("noise_ec_kernel_tile_bytes_total").labels(
                    entry=entry, tile=tile
                ),
            )
    else:
        pair = (
            registry.counter(
                "noise_ec_kernel_tile_dispatches_total"
            ).labels(entry=entry, tile=tile),
            registry.counter(
                "noise_ec_kernel_tile_bytes_total"
            ).labels(entry=entry, tile=tile),
        )
    pair[0].add(1)
    pair[1].add(nbytes)
    if route != "execute" or not synced:
        return
    reg = registry if registry is not None else default_registry()
    with _lock:
        st = _tile_stats.get((entry, tile))
        fresh = st is None
        if fresh:
            st = _tile_stats[(entry, tile)] = [0.0, 0.0]
        st[0] += nbytes
        st[1] += seconds
    if fresh:
        try:
            reg.gauge("noise_ec_kernel_tile_utilization").set_callback(
                lambda e=entry, t=tile: (
                    tile_achieved_gbps(e, t) / max(peak_hbm_gbps(), 1e-9)
                ),
                entry=entry, tile=tile,
            )
        except Exception:  # noqa: BLE001 — telemetry must not raise
            log.debug("tile gauge install failed for %s/%s", entry, tile)


def tile_summary() -> dict:
    """Flat per-(entry, tile) achieved GB/s for report output."""
    out: dict = {}
    with _lock:
        keys = list(_tile_stats)
    for entry, tile in keys:
        a = tile_achieved_gbps(entry, tile)
        if a > 0:
            out[f"device_tile_{entry}_{tile}_gbps"] = round(a, 2)
    return out


# Dispatch-time analysis rate limit: one analysis per kernel entry per
# window keeps the gauges fresh without riding geometry churn.
_ANALYSIS_INTERVAL_S = 60.0
_last_analysis: dict[str, float] = {}


def set_analysis_interval(seconds: float) -> None:
    """Min seconds between dispatch-time cost analyses per kernel entry
    (tests shrink it; 0 analyzes every compile)."""
    global _ANALYSIS_INTERVAL_S
    _ANALYSIS_INTERVAL_S = seconds


def maybe_analyze_program(entry: str, xor_terms: int, in_rows: int,
                          out_rows: int, words: int,
                          registry: Optional[Registry] = None
                          ) -> Optional[dict]:
    """Rate-limited :func:`analyze_program` — the dispatch-path entry.
    Returns None when skipped by the per-entry interval."""
    now = time.monotonic()
    with _lock:
        last = _last_analysis.get(entry)
        if last is not None and now - last < _ANALYSIS_INTERVAL_S:
            return None
        _last_analysis[entry] = now
    return analyze_program(entry, xor_terms, in_rows, out_rows, words,
                           registry=registry)


def analyze_program(entry: str, xor_terms: int, in_rows: int,
                    out_rows: int, words: int,
                    registry: Optional[Registry] = None) -> Optional[dict]:
    """The plan's own cost counts for one product, exported as per-kernel
    program-cost gauges (the reference reads XLA's ``cost_analysis``; a
    hand-written kernel has none).

    ``xor_terms`` is the matrix's raw two-input XOR count over its GF(2)
    bit network (``DeviceCodec._xor_cost_for``); ``in_rows`` / ``out_rows``
    the byte rows in and out and ``words`` the int32 words a byte row
    holds. Bytes: ``4 x (in_rows + out_rows) x words``, each input read
    once and each output written once. Operations: ``xor_terms x words /
    8`` 32-bit XORs (one term XORs a bit plane, and a bit plane of a
    ``words``-word row is ``words / 8`` words). Returns ``{"flops",
    "bytes", "intensity"}``, or None when the counts are unusable; never
    raises — this is telemetry."""
    try:
        flops = float(xor_terms) * float(words) / 8.0
        nbytes = 4.0 * (int(in_rows) + int(out_rows)) * float(words)
        intensity = flops / nbytes if nbytes > 0 else 0.0
        reg = registry if registry is not None else default_registry()
        reg.gauge("noise_ec_device_program_flops").labels(
            kernel=entry
        ).set(flops)
        reg.gauge("noise_ec_device_program_bytes").labels(
            kernel=entry
        ).set(nbytes)
        reg.gauge("noise_ec_roofline_intensity").labels(
            kernel=entry
        ).set(intensity)
    except Exception as exc:  # noqa: BLE001 — telemetry must not raise
        log.debug("program analysis failed for %s: %s", entry, exc)
        return None
    return {"flops": flops, "bytes": nbytes, "intensity": intensity}


# ------------------------------------------- words entries' device time
#
# While a torch.profiler capture records, each words entry on a CUDA
# device (parallel/batch.py) records a timing event on the current stream
# as it starts and another as it ends. The pairs wait in a bounded deque;
# each later entry call moves those whose end event is done into
# noise_ec_batch_device_seconds{entry}, oldest first, without blocking.
# Nothing synchronises. On the CPU nothing is recorded.

_ENTRY_PENDING = 1024
_entry_lock = threading.Lock()
_entry_pending: deque = deque()
# Resolved events by device index, recorded again (an event stays on the
# device it was first recorded on).
_entry_spare: dict[int, list] = {}
_entry_children: dict[str, object] = {}


def _timing_event(index: int):
    try:
        return _entry_spare.get(index, []).pop()
    except IndexError:
        pass
    import torch

    return torch.cuda.Event(enable_timing=True)


class _EntryScope:
    """The root of one words entry during a capture: its span and, on a
    CUDA device, its pair of timing events. Pending pairs resolve inside
    the span, so the host time they take is the entry's."""

    __slots__ = ("span", "entry", "device", "stream", "start")

    def __init__(self, span, entry: str, device):
        self.span = span
        self.entry = entry
        self.device = device
        self.start = None

    def __enter__(self) -> "_EntryScope":
        self.span.__enter__()
        if _entry_pending:
            resolve_entry_events()
        if self.device.type == "cuda":
            import torch

            self.stream = torch.cuda.current_stream(self.device)
            self.start = _timing_event(self.device.index)
            self.start.record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.start is not None and exc is None:
            end = _timing_event(self.device.index)
            end.record(self.stream)
            with _entry_lock:
                if len(_entry_pending) >= _ENTRY_PENDING:
                    _entry_pending.popleft()
                _entry_pending.append((self.entry, self.device.index,
                                       self.start, end))
        return self.span.__exit__(exc_type, exc, tb)


def entry_scope(span_name: str, entry: str, device):
    """``with entry_scope("batch.encode_words", "encode_batch_words",
    words.device):`` around one words entry. While a ``torch.profiler``
    capture records, opens the entry's root span (obs/trace.py), moves
    the finished pending pairs into the histogram
    (:func:`resolve_entry_events`) and, on a CUDA device, records the
    entry's start event; else resolves what is pending and returns the
    shared no-op."""
    if not profiling():
        if _entry_pending:
            resolve_entry_events()
        return _NOOP
    return _EntryScope(default_tracer().device_span(span_name, root=True),
                       entry, device)


def resolve_entry_events() -> None:
    """Observe the device seconds of every pending entry whose end event
    is done, oldest first, up to the first that is not; never waits (a
    call that finds another resolving returns)."""
    if not _entry_lock.acquire(blocking=False):
        return
    try:
        while _entry_pending:
            entry, index, start, end = _entry_pending[0]
            if not end.query():
                return
            _entry_pending.popleft()
            child = _entry_children.get(entry)
            if child is None:
                child = _entry_children[entry] = default_registry().histogram(
                    "noise_ec_batch_device_seconds").labels(entry=entry)
            child.observe(start.elapsed_time(end) * 1e-3)
            spare = _entry_spare.setdefault(index, [])
            if len(spare) < 64:
                spare.extend((start, end))
    finally:
        _entry_lock.release()


# ------------------------------------------------------------------- HBM


def hbm_snapshot() -> dict:
    """Device memory of the current CUDA device, in bytes:
    ``live_bytes`` (``torch.cuda.memory_allocated``: what live tensors
    hold), ``peak_bytes`` (``max_memory_allocated``), ``limit_bytes``
    (the card's total, ``mem_get_info``) and ``bytes_in_use`` (total less
    free: every process's use of the card). Empty dict without a CUDA
    device, as the reference returns one without jax; never raises."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {}
        live = int(torch.cuda.memory_allocated())
        peak = int(torch.cuda.max_memory_allocated())
        free, total = torch.cuda.mem_get_info()
    except Exception:  # noqa: BLE001 — telemetry must not raise
        return {}
    return {"live_bytes": live, "peak_bytes": peak,
            "limit_bytes": int(total), "bytes_in_use": int(total - free)}


def install_hbm_gauges(registry: Optional[Registry] = None) -> None:
    """Install the collect-time HBM callback gauges (idempotent for the
    default registry; explicit registries always install)."""
    global _gauges_installed
    if registry is None:
        with _lock:
            if _gauges_installed:
                return
            _gauges_installed = True
    reg = registry if registry is not None else default_registry()
    try:
        reg.gauge("noise_ec_hbm_live_bytes").set_callback(
            lambda: hbm_snapshot().get("live_bytes", 0)
        )
        reg.gauge("noise_ec_hbm_peak_bytes").set_callback(
            lambda: hbm_snapshot().get("peak_bytes", 0)
        )
        reg.gauge("noise_ec_hbm_limit_bytes").set_callback(
            lambda: hbm_snapshot().get("limit_bytes", 0)
        )
    except Exception:  # noqa: BLE001 — gauge install must not fail callers
        log.debug("hbm gauge install failed")


def roofline_summary() -> dict:
    """Flat dict for report output: per-kernel achieved GB/s and
    utilization of the synced entries, plus the device memory snapshot
    (MiB) where there is a card."""
    out: dict = {}
    with _lock:
        entries = list(_op_stats)
    for entry in entries:
        a = achieved_gbps(entry)
        if a > 0:
            out[f"device_{entry}_achieved_gbps"] = round(a, 2)
            out[f"device_{entry}_utilization"] = round(
                a / max(peak_hbm_gbps(), 1e-9), 4
            )
    hbm = hbm_snapshot()
    if hbm:
        out["hbm_live_mib"] = round(hbm.get("live_bytes", 0) / 2**20, 1)
        out["hbm_peak_mib"] = round(hbm.get("peak_bytes", 0) / 2**20, 1)
    return out
