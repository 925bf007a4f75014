"""SLO-aware health: end-to-end outcome recording + a rolling evaluator.

Port of ``noise_ec_tpu.obs.health``, whole.

The practice is Ford et al.'s (OSDI 2010) availability telemetry turned
into an actionable signal: every completed (or failed) object on the
receive path records an *outcome event* — into the
``noise_ec_e2e_latency_seconds{outcome=...}`` histogram family for
scrape-time percentiles, and into a rolling :class:`SLOEvaluator` whose
verdict drives ``/healthz`` (obs/server.py): 200 while the window meets
its success-rate and p99 objectives, 503 with a JSON reason once the
error budget is burned, back to 200 when the window slides past the bad
minute. Orchestrators get a liveness signal that means "this node is
actually delivering objects", not merely "the process answers HTTP".

Outcomes (the bounded ``outcome`` label set):

- ``ok`` — object verified and delivered;
- ``verify_failed`` — a reassembled object failed its signature verify
  (may later repair and also record ``ok``);
- ``corrupt`` — unrecoverable (`CorruptionError`): every shard arrived
  and the object still cannot decode/verify;
- ``incomplete`` — a pool stuck below k shards exhausted the NACK
  repair budget (host/plugin.py) without completing; the object may
  still arrive later (announce / late shards) and then also record
  ``ok``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from noise_ec_tpu_torch.obs.registry import Registry, default_registry

__all__ = ["SLOEvaluator", "default_slo", "record_e2e"]

E2E_OUTCOMES: tuple[str, ...] = ("ok", "verify_failed", "corrupt",
                                 "incomplete")


class SLOEvaluator:
    """Rolling-window service-level objective check.

    Two objectives over the last ``window_seconds`` of outcome events:
    success rate >= ``success_rate_target``, and (when
    ``p99_target_seconds`` > 0) the p99 of *successful* end-to-end
    latencies <= the target. Fewer than ``min_events`` events in the
    window is *insufficient data* and reads healthy — a freshly started
    (or idle) node must not flap its orchestrator.

    ``record`` is one lock + deque append; ``verdict`` sorts the window
    (bounded by ``max_events``) — collect-time cost, not hot-path cost.
    """

    def __init__(
        self,
        window_seconds: float = 60.0,
        *,
        success_rate_target: float = 0.99,
        p99_target_seconds: float = 0.0,
        min_events: int = 10,
        max_events: int = 65536,
    ):
        if window_seconds <= 0:
            raise ValueError(f"window must be positive, got {window_seconds}")
        self.window_seconds = window_seconds
        self.success_rate_target = success_rate_target
        self.p99_target_seconds = p99_target_seconds
        self.min_events = min_events
        self._events: deque = deque(maxlen=max_events)  # (t, ok, seconds)
        self._lock = threading.Lock()
        # Verdict-flip listeners (the flight recorder's capture trigger):
        # fired on the healthy -> degraded transition as observed by
        # verdict() calls, outside the lock.
        self._flip_listeners: list = []
        self._last_healthy = True

    def add_flip_listener(self, fn) -> None:
        """Register ``fn(verdict_dict)`` to fire when :meth:`verdict`
        observes the healthy -> degraded transition (not on every
        degraded verdict, and not on recovery). Listener errors are
        swallowed — telemetry must not break the health probe."""
        self._flip_listeners.append(fn)

    def record(self, outcome: str, seconds: float,
               now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((t, outcome == "ok", seconds))

    def _window(self, now: float) -> list:
        cutoff = now - self.window_seconds
        with self._lock:
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()
            return list(self._events)

    def verdict(self, now: Optional[float] = None) -> dict:
        """The current health verdict: ``{"healthy": bool, "reason":
        str | None, ...}`` with the measured window stats alongside the
        targets, so a 503 body tells the operator *which* objective was
        missed and by how much."""
        t = time.monotonic() if now is None else now
        events = self._window(t)
        n = len(events)
        out = {
            "healthy": True,
            "reason": None,
            "window_seconds": self.window_seconds,
            "events": n,
            "success_rate": None,
            "p99_seconds": None,
            "targets": {
                "success_rate": self.success_rate_target,
                "p99_seconds": self.p99_target_seconds or None,
            },
        }
        if n < self.min_events:
            return self._observe(out)  # insufficient data reads healthy
        ok_lat = sorted(s for _, ok, s in events if ok)
        rate = len(ok_lat) / n
        out["success_rate"] = round(rate, 6)
        if ok_lat:
            out["p99_seconds"] = ok_lat[min(
                len(ok_lat) - 1, int(0.99 * len(ok_lat))
            )]
        if rate < self.success_rate_target:
            out["healthy"] = False
            out["reason"] = (
                f"success rate {rate:.4f} below target "
                f"{self.success_rate_target} over the last "
                f"{self.window_seconds:g}s ({n} events)"
            )
        elif (
            self.p99_target_seconds > 0
            and out["p99_seconds"] is not None
            and out["p99_seconds"] > self.p99_target_seconds
        ):
            out["healthy"] = False
            out["reason"] = (
                f"e2e p99 {out['p99_seconds']:.4f}s above target "
                f"{self.p99_target_seconds:g}s over the last "
                f"{self.window_seconds:g}s ({n} events)"
            )
        return self._observe(out)

    def _observe(self, out: dict) -> dict:
        """Track the healthy/degraded edge and fire flip listeners on
        healthy -> degraded; the transition is claimed under the lock so
        concurrent verdict() callers (healthz + recorder tick) fire the
        listeners exactly once per flip."""
        healthy = bool(out["healthy"])
        with self._lock:
            fire = self._last_healthy and not healthy
            self._last_healthy = healthy
        if fire:
            for fn in list(self._flip_listeners):
                try:
                    fn(out)
                except Exception:  # noqa: BLE001 — listener bugs must
                    # not break the health probe
                    pass
        return out

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._last_healthy = True


_default_slo = SLOEvaluator()


def default_slo() -> SLOEvaluator:
    """The process-wide evaluator the receive path records into (and the
    CLI wires to ``/healthz``)."""
    return _default_slo


# Cached histogram children per outcome (default registry only — a
# transient Registry must not pin stale children via an id()-keyed map).
_hist_children: dict[str, object] = {}


def record_e2e(
    outcome: str,
    seconds: float,
    *,
    registry: Optional[Registry] = None,
    slo: Optional[SLOEvaluator] = None,
) -> None:
    """Record one end-to-end outcome event into BOTH surfaces: the
    ``noise_ec_e2e_latency_seconds`` histogram (scrape percentiles) and
    the SLO evaluator (health verdict). The receive path's one-liner."""
    if registry is None:
        child = _hist_children.get(outcome)
        if child is None:
            child = _hist_children[outcome] = default_registry().histogram(
                "noise_ec_e2e_latency_seconds"
            ).labels(outcome=outcome)
    else:
        child = registry.histogram(
            "noise_ec_e2e_latency_seconds"
        ).labels(outcome=outcome)
    child.observe(seconds)
    (slo if slo is not None else _default_slo).record(outcome, seconds)
