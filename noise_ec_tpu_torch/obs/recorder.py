"""Flight recorder: an always-on ring of per-second deltas, frozen into
an incident bundle when the SLO verdict flips.

A 503 on ``/healthz`` is a point-in-time verdict; by the time an
operator looks, the window has slid and the evidence is gone. The
:class:`FlightRecorder` keeps the recent past cheaply: a daemon thread
ticks once a second, diffs the metric registry against the previous
tick (counters and histogram ``_count``/``_sum`` move as deltas, gauges
as changes — which covers backpressure queue depths, breaker states and
lockgraph event counters, all registry families), attaches the current
SLO verdict and the tracer's seq high-water mark, and appends the entry
to a byte-bounded ring (oldest entries evicted past ``max_bytes`` — the
steady-state memory cost is the cap, not the uptime).

On the SLO healthy -> degraded flip (via
:meth:`~noise_ec_tpu_torch.obs.health.SLOEvaluator.add_flip_listener`) or on
demand (``GET /incident``), :meth:`capture` freezes the ring into an
*incident bundle*: a JSON document with the delta timeline, the flip
verdict, recorder self-stats and the spans that finished inside the
ring's window — plus a sibling Perfetto trace of those spans
(obs/perfetto.py) when an ``incident_dir`` is configured. Disk writes
are rate-limited (``min_bundle_interval``) so a flapping SLO cannot
fill a disk; ``noise_ec_incident_bundles_total{trigger}`` counts only
bundles actually written.

Overhead: one registry walk + one JSON dump per second, self-measured
as the tick thread's CPU time (``stats()["tick_seconds"]``) — the
chaos-soak test asserts the steady-state cost stays under 1% of wall
time.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.perfetto import write_chrome_trace
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.trace import Tracer, default_tracer

__all__ = [
    "BUNDLE_VERSION", "FlightRecorder", "flatten_registry",
    "group_request_traces",
]

log = logging.getLogger("noise_ec_tpu_torch.obs")

BUNDLE_VERSION = 1


def flatten_registry(registry: Registry) -> dict[str, float]:
    """One flat ``name{l1=v1,...} -> value`` view of every registry
    family: counter values, gauge reads, histogram ``_count``/``_sum``
    (full bucket vectors would dominate the ring for no diagnostic
    gain — the live buckets are always on ``/metrics``)."""
    out: dict[str, float] = {}
    for fam in registry.collect():
        for values, child in fam.children():
            lbl = ",".join(
                f"{k}={v}" for k, v in zip(fam.label_names, values)
            )
            key = f"{fam.name}{{{lbl}}}" if lbl else fam.name
            if fam.type == "counter":
                out[key] = float(child.value)
            elif fam.type == "gauge":
                out[key] = float(child.read())
            else:
                snap = child.snapshot()
                out[f"{key}#count"] = float(snap["count"])
                out[f"{key}#sum"] = float(snap["sum"])
    return out


def group_request_traces(spans) -> dict[str, list[dict]]:
    """Group spans into request-rooted traces (``req-...`` ids). A span
    carrying a ``request_trace`` attribute groups under that id — same
    merge rule as :meth:`TraceCollector.traces` — so an incident bundle
    shows whole sampled requests from the degraded window, pipeline
    legs included, not loose spans. Spans belonging to no request
    (signature-keyed work with no request ancestor) are left out; they
    are still in the bundle's flat ``spans`` list."""
    out: dict[str, list[dict]] = {}
    for s in spans:
        attrs = s.get("attrs") or {}
        tid = attrs.get("request_trace") or s.get("trace_id")
        if isinstance(tid, str) and tid.startswith("req-"):
            out.setdefault(tid, []).append(s)
    return out


class FlightRecorder:
    """Always-on per-second delta ring + incident bundle writer.

    ``slo`` (when given) is both polled each tick for the verdict on
    the timeline entry and subscribed to via ``add_flip_listener`` so a
    healthy -> degraded flip captures a bundle automatically. With no
    ``incident_dir``, :meth:`capture` still returns the bundle (the
    ``GET /incident`` response) — it just writes nothing.
    """

    def __init__(
        self,
        *,
        registry: Optional[Registry] = None,
        slo: Optional[SLOEvaluator] = None,
        tracer: Optional[Tracer] = None,
        interval: float = 1.0,
        max_bytes: int = 512 * 1024,
        incident_dir: Optional[str] = None,
        min_bundle_interval: float = 60.0,
        top_deltas: int = 64,
    ):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.slo = slo
        self.tracer = tracer if tracer is not None else default_tracer()
        self.interval = interval
        self.max_bytes = max_bytes
        self.incident_dir = incident_dir
        self.min_bundle_interval = min_bundle_interval
        self.top_deltas = top_deltas
        self._ring: deque = deque()  # (entry_dict, serialized_bytes)
        self._ring_bytes = 0
        self._lock = threading.Lock()
        self._prev: Optional[dict[str, float]] = None
        self._prev_seq = 0
        self._ticks = 0
        self._tick_seconds = 0.0
        self._truncated_total = 0
        self._last_write = float("-inf")
        self._bundle_n = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Duck-typed diagnosis hooks, set by DiagnosisEngine (this
        # module never imports obs.events/obs.diagnose): ``events`` is
        # an EventLog whose window lands in every bundle; ``diagnoser``
        # is a zero-arg callable returning a ranked-verdict document.
        self.events = None
        self.diagnoser = None
        self._bundles = self.registry.counter(
            "noise_ec_incident_bundles_total"
        )
        self.registry.gauge("noise_ec_incident_ring_bytes").set_callback(
            self.ring_bytes
        )
        if slo is not None:
            slo.add_flip_listener(self._on_flip)

    # ------------------------------------------------------------- ticking

    def tick(self, now: Optional[float] = None) -> dict:
        """Record one timeline entry (normally called by the background
        thread; tests call it directly). Returns the entry."""
        # Thread CPU time, not wall: on a saturated box a preempted
        # tick would bill scheduler wait as recorder overhead.
        t0 = time.clock_gettime(time.CLOCK_THREAD_CPUTIME_ID)
        wall = time.time() if now is None else now
        snap = flatten_registry(self.registry)
        deltas: dict[str, float] = {}
        truncated = 0
        if self._prev is not None:
            changed = [
                (key, value - self._prev.get(key, 0.0))
                for key, value in snap.items()
                if value != self._prev.get(key, 0.0)
                # The recorder's own ring-bytes gauge moves on every
                # tick by construction — pure self-noise that would
                # burn a top-deltas slot in every entry.
                and key != "noise_ec_incident_ring_bytes"
            ]
            if len(changed) > self.top_deltas:
                changed.sort(key=lambda kv: -abs(kv[1]))
                truncated = len(changed) - self.top_deltas
                changed = changed[:self.top_deltas]
            deltas = dict(sorted(changed))
        self._prev = snap
        last_seq = self.tracer.last_seq()
        entry: dict = {
            "t": wall,
            "deltas": deltas,
            "last_seq": last_seq,
            "new_spans": max(0, last_seq - self._prev_seq),
        }
        if truncated:
            entry["deltas_truncated"] = truncated
            self._truncated_total += truncated
        self._prev_seq = last_seq
        if self.slo is not None:
            verdict = self.slo.verdict()
            entry["healthy"] = verdict["healthy"]
            if not verdict["healthy"]:
                entry["reason"] = verdict["reason"]
        nbytes = len(json.dumps(entry, separators=(",", ":")))
        with self._lock:
            self._ring.append((entry, nbytes))
            self._ring_bytes += nbytes
            while self._ring_bytes > self.max_bytes and len(self._ring) > 1:
                _, old = self._ring.popleft()
                self._ring_bytes -= old
        self._ticks += 1
        self._tick_seconds += (
            time.clock_gettime(time.CLOCK_THREAD_CPUTIME_ID) - t0
        )
        return entry

    def ring_bytes(self) -> int:
        """Serialized bytes currently held in the ring (<= max_bytes
        whenever it holds more than one entry)."""
        with self._lock:
            return self._ring_bytes

    def stats(self) -> dict:
        with self._lock:
            entries = len(self._ring)
            ring_bytes = self._ring_bytes
        return {
            "ticks": self._ticks,
            "tick_seconds": self._tick_seconds,
            "entries": entries,
            "ring_bytes": ring_bytes,
            "deltas_truncated_total": self._truncated_total,
        }

    # ------------------------------------------------------------ capturing

    def _on_flip(self, verdict: dict) -> None:
        try:
            self.capture("flip", verdict=verdict)
        except Exception as exc:  # noqa: BLE001 — a capture failure must
            # not break the health probe that fired the listener
            log.error("incident capture on SLO flip failed: %s", exc)

    def capture(self, trigger: str,
                verdict: Optional[dict] = None) -> dict:
        """Freeze the ring into an incident bundle; write it (plus the
        Perfetto trace of spans in the window) under ``incident_dir``
        unless the rate limit suppresses the write. Returns the bundle
        either way."""
        wall = time.time()
        with self._lock:
            timeline = [entry for entry, _ in self._ring]
        if verdict is None and self.slo is not None:
            verdict = self.slo.verdict()
        window_start = timeline[0]["t"] if timeline else wall
        spans = [
            s for s in self.tracer.dump()
            if float(s.get("start", 0.0)) + float(s.get("seconds", 0.0))
            >= window_start
        ]
        bundle: dict = {
            "version": BUNDLE_VERSION,
            "trigger": trigger,
            "written_at": wall,
            "node": self.tracer.node_label(),
            "verdict": verdict,
            "timeline": timeline,
            "spans": spans,
            # The tail-sampled requests that completed inside the
            # window: only traces the sampler KEPT are in the ring, so
            # these are exactly the error/slow/sampled requests an
            # operator wants next to the verdict flip.
            "traces": group_request_traces(spans),
            "recorder": self.stats(),
            "trace_file": None,
        }
        if self.events is not None:
            # The wide-event tail of the same window the timeline
            # covers: the decisions (demotions, sheds, hedges) made in
            # the seconds the deltas describe.
            bundle["events"] = [
                e for e in self.events.dump()
                if e["ts"] >= window_start
            ]
        if self.diagnoser is not None:
            try:
                bundle["diagnosis"] = self.diagnoser()
            except Exception as exc:  # noqa: BLE001 — a diagnosis
                # failure must not lose the bundle it annotates
                log.warning("bundle diagnosis failed: %s", exc)
        if self.incident_dir is None:
            return bundle
        with self._lock:
            if wall - self._last_write < self.min_bundle_interval:
                log.info(
                    "incident capture (%s) suppressed by rate limit "
                    "(%.0fs since last bundle)",
                    trigger, wall - self._last_write,
                )
                return bundle
            self._last_write = wall
            self._bundle_n += 1
            n = self._bundle_n
        os.makedirs(self.incident_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(wall))
        base = f"incident-{stamp}-{n:03d}-{trigger}"
        trace_path = os.path.join(self.incident_dir, f"{base}.trace.json")
        if spans:
            write_chrome_trace(trace_path, spans)
            bundle["trace_file"] = os.path.basename(trace_path)
        path = os.path.join(self.incident_dir, f"{base}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, indent=1)
        self._bundles.labels(trigger=trigger).add(1)
        log.warning(
            "incident bundle (%s) written to %s: %d timeline entries, "
            "%d spans", trigger, path, len(timeline), len(spans),
        )
        return bundle

    # ------------------------------------------------------------- serving

    def attach(self, server) -> None:
        """Mount ``GET /incident`` on a stats server: capture on demand
        and return the bundle JSON (written to ``incident_dir`` too,
        rate limits permitting)."""
        server.mount("GET", "/incident", self._route_incident)

    def _route_incident(self, req: dict) -> tuple:
        bundle = self.capture("request")
        return (200, "application/json",
                json.dumps(bundle, indent=1).encode())

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Tick every ``interval`` seconds on a daemon thread."""
        if self._thread is not None:
            return

        def run() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 — the recorder
                    # must outlive any one bad tick
                    log.warning("flight recorder tick failed: %s", exc)

        self._thread = threading.Thread(
            target=run, name="noise-ec-recorder", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5)
