"""Live-path coalescing: batch concurrent same-shape matmul requests.

Port of ``noise_ec_tpu.ops.coalesce``. Concurrent requests for the same
(backend, field, matrix, stripe-shape) bucket are batched into a single
dispatch (``DeviceCodec.matmul_stripes_many``, one launch per kernel for
the whole batch) and the results fanned back out to the waiting callers.

Flush policy (admission and batching share one queue):

- a lone request on an idle dispatcher flushes IMMEDIATELY — coalescing
  must never tax the uncontended path;
- when other coalesced work is already in flight (or another thread
  submitted within the hot window), the bucket leader lingers up to
  :meth:`CoalescingDispatcher._linger_budget` collecting followers;
- a full bucket (``max_batch``) flushes at once;
- explicit batches (:meth:`CoalescingDispatcher.submit_many`) merge into
  any open bucket for their key and flush without linger;
- idempotent reads (:meth:`CoalescingDispatcher.submit_shared`) ride a
  single-flight tier: same-key callers share one in-flight call's result.

The batch function runs on the leader's thread; an exception propagates
to every member. Counters are plain attributes (``batches``,
``flush_reasons``, ``batch_sizes``); the reference's
``noise_ec_coalesce_*`` families are not recorded.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

__all__ = [
    "CoalescingDispatcher",
    "QOS_LANES",
    "coalesce_cutoff_bytes",
    "coalescer",
    "configure_coalescer",
    "current_qos",
    "qos_lane",
    "set_coalesce_cutoff",
]

# A follower must never wait forever on a leader that died violently
# (thread killed between append and flush); after this many seconds it
# raises instead of hanging the receive path.
_FOLLOWER_TIMEOUT_S = 120.0

# ------------------------------------------------------------ QoS lanes
#
# The thread-local (lane, tenant, weight) tag set by the layer that knows
# the traffic class (the object service tags per-tenant live work; repair,
# scrub and convert loops tag themselves background), read by the
# admission points: the device gate's weighted lane queues and this
# dispatcher's linger budget. A coalesced batch runs on its leader's
# thread and rides the leader's lane.

QOS_LANES = ("live", "background")

_qos_local = threading.local()


def current_qos() -> tuple[str, str, int]:
    """The calling thread's ``(lane, tenant, weight)`` QoS tag —
    ``("live", "", 1)`` outside any :func:`qos_lane` scope."""
    return getattr(_qos_local, "ctx", ("live", "", 1))


@contextmanager
def qos_lane(lane: str, tenant: str = "", weight: int = 1):
    """Tag the calling thread's admissions with a QoS class for the
    duration of the scope. Nests: the previous tag is restored on exit."""
    if lane not in QOS_LANES:
        raise ValueError(
            f"unknown QoS lane {lane!r} (lanes: {', '.join(QOS_LANES)})"
        )
    prev = getattr(_qos_local, "ctx", None)
    _qos_local.ctx = (lane, tenant, max(1, int(weight)))
    try:
        yield
    finally:
        if prev is None:
            del _qos_local.ctx
        else:
            _qos_local.ctx = prev


class _Bucket:
    __slots__ = ("key", "fn", "payloads", "results", "error", "done",
                 "closed")

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn
        self.payloads: list = []
        self.results: Optional[list] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.closed = False


class _Flight:
    __slots__ = ("done", "result", "error", "members")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.members = 1


class CoalescingDispatcher:
    """Batches concurrent same-key requests into single dispatches
    (module docstring). One process-wide instance fronts every codec
    ``_mul``; tests build their own with shrunk knobs."""

    def __init__(self, *, linger_seconds: float = 0.0005,
                 max_batch: int = 32, hot_window_seconds: float = 0.005,
                 background_linger_x: float = 4.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if background_linger_x < 1.0:
            raise ValueError(
                f"background_linger_x must be >= 1, got {background_linger_x}"
            )
        self.linger_seconds = linger_seconds
        self.max_batch = max_batch
        self.hot_window_seconds = hot_window_seconds
        self.background_linger_x = background_linger_x
        self._lock = threading.Lock()
        self._buckets: dict = {}
        self._flights: dict = {}  # single-flight tier (submit_shared)
        self._inflight = 0  # batch dispatches currently running
        self._last_submit_t = 0.0
        self._last_submit_thread: Optional[int] = None
        self.batches = 0
        self.flush_reasons = {
            reason: 0 for reason in ("solo", "linger", "full", "bulk", "shared")
        }
        # batch size -> member requests that rode a batch of that size
        self.batch_sizes: Counter = Counter()

    # ------------------------------------------------------------- submit

    def submit(self, key, batch_fn: Callable[[list], list], payload):
        """One request: returns its result once a batch containing it has
        dispatched. ``batch_fn(payloads) -> results`` must be equivalent
        for every caller sharing ``key`` (it runs on the leader's
        thread)."""
        now = time.monotonic()
        me = threading.get_ident()
        with self._lock:
            hot = (
                self._inflight > 0
                or (
                    now - self._last_submit_t < self.hot_window_seconds
                    and self._last_submit_thread != me
                )
            )
            self._last_submit_t = now
            self._last_submit_thread = me
            bucket = self._buckets.get(key)
            if bucket is not None and not bucket.closed and len(
                bucket.payloads
            ) < self.max_batch:
                idx = len(bucket.payloads)
                bucket.payloads.append(payload)
                follower = True
            else:
                bucket = _Bucket(key, batch_fn)
                bucket.payloads.append(payload)
                self._buckets[key] = bucket
                idx = 0
                follower = False
        if follower:
            return self._await(bucket, idx)
        self._lead(bucket, linger=self._linger_budget() if hot else 0.0)
        return self._result(bucket, idx)

    def submit_shared(self, key, fn: Callable[[], object]):
        """Single-flight tier: concurrent same-``key`` callers share ONE
        ``fn()`` call and all receive its result; followers may join while
        the call is already running. Returns ``(result, shared)`` —
        ``shared`` is True when this caller rode another caller's call.
        An exception from ``fn`` propagates to every member."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                flight.members += 1
                follower = True
            else:
                flight = self._flights[key] = _Flight()
                follower = False
        if follower:
            if not flight.done.wait(_FOLLOWER_TIMEOUT_S):
                raise RuntimeError(
                    "shared dispatch never completed (leader lost)"
                )
            if flight.error is not None:
                raise flight.error
            return flight.result, True
        try:
            flight.result = fn()
        except BaseException as exc:  # noqa: BLE001 — fan the error out
            flight.error = exc
        finally:
            with self._lock:
                del self._flights[key]
                members = flight.members
                self._count("shared", members)
            flight.done.set()
        if flight.error is not None:
            raise flight.error
        return flight.result, False

    def submit_many(self, key, batch_fn: Callable[[list], list],
                    payloads: Sequence) -> list:
        """Explicit batch (the repair engine's group dispatch): joins any
        open bucket for ``key`` and flushes without linger."""
        payloads = list(payloads)
        if not payloads:
            return []
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is not None and not bucket.closed:
                base = len(bucket.payloads)
                bucket.payloads.extend(payloads)
                follower = True
            else:
                bucket = _Bucket(key, batch_fn)
                bucket.payloads.extend(payloads)
                self._buckets[key] = bucket
                base = 0
                follower = False
        if follower:
            self._await(bucket, base)  # leader flushes; wait for results
            return [self._result(bucket, base + i)
                    for i in range(len(payloads))]
        self._lead(bucket, linger=0.0, reason="bulk")
        return [self._result(bucket, base + i) for i in range(len(payloads))]

    # -------------------------------------------------------------- flush

    def _count(self, reason: str, size: int) -> None:
        """Record one flush (lock held)."""
        self.batches += 1
        self.flush_reasons[reason] += 1
        self.batch_sizes[size] += size

    def _linger_budget(self) -> float:
        """The bounded latency budget: the base linger, scaled by the
        device-gate queue depth (a deep gate queue means the batch would
        block at admission anyway, so a longer linger costs nothing).
        Background-lane leaders under pressure linger
        ``background_linger_x`` longer still — background batches YIELD
        the contended gate to live work (collecting bigger batches while
        they wait), and say so with a ``qos.linger`` event."""
        if self.linger_seconds <= 0:
            return 0.0
        from noise_ec_tpu_torch.ops.dispatch import device_gate

        gate = device_gate()
        depth = gate.in_flight + gate.waiters
        budget = max(self.linger_seconds, self.linger_seconds * depth)
        if depth > 0 and current_qos()[0] == "background":
            budget *= self.background_linger_x
            from noise_ec_tpu_torch.obs.events import event

            event("qos.linger", lane="background", depth=depth,
                  budget_ms=round(budget * 1e3, 3))
        return budget

    def _lead(self, bucket: _Bucket, linger: float,
              reason: Optional[str] = None) -> None:
        if linger > 0:
            deadline = time.monotonic() + linger
            while time.monotonic() < deadline:
                with self._lock:
                    if len(bucket.payloads) >= self.max_batch:
                        break
                time.sleep(min(0.0002, linger))
        with self._lock:
            bucket.closed = True
            if self._buckets.get(bucket.key) is bucket:
                del self._buckets[bucket.key]
            size = len(bucket.payloads)
            self._inflight += 1
        if reason is None:
            reason = (
                "full" if size >= self.max_batch
                else ("linger" if linger > 0 else "solo")
            )
        try:
            results = bucket.fn(list(bucket.payloads))
            if len(results) != size:
                raise RuntimeError(
                    f"coalesced batch_fn returned {len(results)} results "
                    f"for {size} payloads"
                )
            bucket.results = list(results)
        except BaseException as exc:  # noqa: BLE001 — fan the error out
            bucket.error = exc
        finally:
            with self._lock:
                self._inflight -= 1
                self._count(reason, size)
            bucket.done.set()
        if bucket.error is not None:
            raise bucket.error

    def _await(self, bucket: _Bucket, idx: int):
        if not bucket.done.wait(_FOLLOWER_TIMEOUT_S):
            raise RuntimeError(
                "coalesced dispatch never completed (leader lost)"
            )
        return self._result(bucket, idx)

    def _result(self, bucket: _Bucket, idx: int):
        if bucket.error is not None:
            raise bucket.error
        return bucket.results[idx]


# Implicit-coalescing payload cutoff: batching amortizes PER-DISPATCH
# overhead, so it pays while that overhead dominates — up to mid-size
# payloads on the card (the reference's accelerator value), only small
# ones on the host, where a wide batch is compute-bound and adds a copy.
# Requests above the cutoff dispatch directly; explicit submit_many
# batches are caller-opted and always batch.
_cutoff_override: Optional[int] = None


def set_coalesce_cutoff(nbytes: Optional[int]) -> None:
    """Pin the implicit-coalescing payload cutoff (None restores the
    per-device default; tests use this to force either regime)."""
    global _cutoff_override
    _cutoff_override = nbytes


def coalesce_cutoff_bytes(device) -> int:
    """The cutoff for a codec running on ``device`` (a torch device or
    its name): 8 MiB on CUDA, 128 KiB elsewhere."""
    if _cutoff_override is not None:
        return _cutoff_override
    import torch

    return (8 << 20) if torch.device(device).type == "cuda" else (128 << 10)


_coalescer: Optional[CoalescingDispatcher] = None
_coalescer_lock = threading.Lock()


def coalescer() -> CoalescingDispatcher:
    """The process-wide coalescing dispatcher (lazy singleton)."""
    global _coalescer
    with _coalescer_lock:
        if _coalescer is None:
            _coalescer = CoalescingDispatcher()
        return _coalescer


def configure_coalescer(**kwargs) -> CoalescingDispatcher:
    """Replace the process dispatcher (tests shrink/grow the linger; a
    fresh instance also drops any open buckets). Returns the new one."""
    global _coalescer
    with _coalescer_lock:
        _coalescer = CoalescingDispatcher(**kwargs)
        return _coalescer
