"""Circuit breakers: closed → open → half-open, with jittered backoff.

Port of ``noise_ec_tpu.resilience.breakers``. One implementation serves
the codec breaker (ops/dispatch.py): a device-dispatch failure (after one
in-call retry) opens it, the codec refuses products with
``CodecUnavailableError`` while it is open, and a background half-open
probe re-closes it when the device route recovers. The per-peer breaker
of the node's peer supervisor (resilience/peers.py) is the same class.

State machine (the standard Nygard shape):

- ``closed`` — traffic flows; failures count toward ``failure_threshold``.
- ``open`` — traffic short-circuits for ``reset_timeout`` seconds.
- ``half_open`` — the timeout expired: exactly ONE probe is admitted;
  success closes, failure re-opens with the timeout doubled (capped at
  ``max_reset_timeout``).

All transitions are driven by ``allow`` / ``record_success`` /
``record_failure`` against an injectable clock, so tests pin the cycle
without sleeping. ``backoff_delay`` is the companion full-jitter schedule
(AWS-style: ``uniform(0, min(cap, base * 2**attempt))``) used by the peer
supervisor between re-dials.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["CircuitBreaker"]

_STATE_CODES = {"closed": 0, "open": 1, "half_open": 2}


class CircuitBreaker:
    """Thread-safe circuit breaker (module docstring for the state map)."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        reset_timeout: float = 1.0,
        max_reset_timeout: float = 60.0,
        backoff_base: float = 0.25,
        backoff_cap: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        seed: Optional[int] = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout <= 0 or max_reset_timeout < reset_timeout:
            raise ValueError(
                f"need 0 < reset_timeout <= max_reset_timeout, got "
                f"{reset_timeout} / {max_reset_timeout}"
            )
        self.failure_threshold = failure_threshold
        self.base_reset_timeout = reset_timeout
        self.max_reset_timeout = max_reset_timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._clock = clock
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._open_until = 0.0
        self._current_timeout = reset_timeout
        self._probing = False  # a half-open probe is in flight
        self._probe_owner: Optional[int] = None  # the thread holding it

    # ------------------------------------------------------------- queries

    def state(self, now: Optional[float] = None) -> str:
        """Current state; an expired ``open`` reads as ``half_open``."""
        t = self._clock() if now is None else now
        with self._lock:
            return self._state_locked(t)

    def _state_locked(self, t: float) -> str:
        if self._state == "open" and t >= self._open_until:
            self._state = "half_open"
            self._probing = False
        return self._state

    def state_code(self, now: Optional[float] = None) -> int:
        """Gauge encoding: closed=0, open=1, half_open=2."""
        return _STATE_CODES[self.state(now)]

    @property
    def closed(self) -> bool:
        """Cheap route check (used on hot paths that must not consume the
        half-open probe slot — e.g. the FEC decode device-route gate)."""
        return self.state() == "closed"

    # ----------------------------------------------------------- decisions

    def allow(self, now: Optional[float] = None) -> bool:
        """May traffic proceed right now?

        ``closed``: always. ``open``: never (until the timeout expires).
        ``half_open``: exactly one caller gets True — it becomes the
        probe, and MUST report back via record_success/record_failure.
        """
        t = self._clock() if now is None else now
        with self._lock:
            state = self._state_locked(t)
            if state == "closed":
                return True
            if state == "open":
                return False
            if self._probing:
                return False
            self._probing = True
            self._probe_owner = threading.get_ident()
            return True

    def release_probe(self) -> None:
        """Give back the half-open probe slot without a verdict.

        For a caller that :meth:`allow` admitted but whose work ended in
        an error that says nothing about the route's health (the codec
        breaker's raise list, ops/dispatch.py): the state is left as it
        was, and the next caller may probe. Only the thread that holds
        the slot releases it; from any other thread, or with no probe in
        flight, this does nothing."""
        with self._lock:
            if self._probing and self._probe_owner == threading.get_ident():
                self._probing = False
                self._probe_owner = None

    def record_success(self, now: Optional[float] = None) -> None:
        """A unit of work (or the half-open probe) succeeded: close."""
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != "closed":
                self._state = "closed"
                self._current_timeout = self.base_reset_timeout

    def record_failure(self, now: Optional[float] = None) -> None:
        """A unit of work failed. In ``closed``, counts toward the
        threshold; at the threshold (or on a failed half-open probe) the
        breaker opens — each re-open from half-open doubles the timeout
        up to ``max_reset_timeout``."""
        t = self._clock() if now is None else now
        with self._lock:
            state = self._state_locked(t)
            if state == "half_open":
                self._current_timeout = min(
                    self._current_timeout * 2, self.max_reset_timeout
                )
            elif state == "closed":
                self._failures += 1
                if self._failures < self.failure_threshold:
                    return
            else:  # already open: a straggling report keeps it open
                pass
            self._state = "open"
            self._probing = False
            self._failures = 0
            self._open_until = t + self._current_timeout

    def open_remaining(self, now: Optional[float] = None) -> float:
        """Seconds until an ``open`` breaker admits its half-open probe
        (0.0 when not open) — what a scheduler sleeps before retrying."""
        t = self._clock() if now is None else now
        with self._lock:
            if self._state_locked(t) != "open":
                return 0.0
            return max(0.0, self._open_until - t)

    # ------------------------------------------------------------- backoff

    def backoff_delay(self, attempt: int) -> float:
        """Full-jitter exponential backoff for retry ``attempt`` (0-based):
        ``uniform(0, min(backoff_cap, backoff_base * 2**attempt))``. Full
        jitter (not equal/decorrelated) so a fleet of peers dropped by the
        same partition does not re-dial in lockstep."""
        ceiling = min(self.backoff_cap, self.backoff_base * (2 ** max(attempt, 0)))
        return float(self._rng.uniform(0.0, ceiling))

    def snapshot(self) -> dict:
        """State summary for health/debug surfaces."""
        t = self._clock()
        with self._lock:
            state = self._state_locked(t)
            return {
                "state": state,
                "failures": self._failures,
                "reset_timeout": self._current_timeout,
                "open_remaining": (
                    max(0.0, self._open_until - t) if state == "open" else 0.0
                ),
            }
