"""Core metric primitives: counters, fixed-bucket histograms, timers.

Port of ``noise_ec_tpu.obs.metrics``, with the same bucket edges. A flat
sum of latencies is lossy — a p99 regression hides completely inside a
sum — so the dispatch hot paths feed fixed-bucket histograms
(:class:`Histogram`) whose p50/p90/p99 are extractable at report time.

Hot-path budget: ``Counters.add`` is one lock + one dict add;
``Histogram.observe`` is one lock + a bisect + three adds. Both match the
"two lock-free-ish counter adds" cost class ``record_kernel`` promises.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Optional, Sequence

__all__ = [
    "Counters",
    "Histogram",
    "Timer",
    "DEVICE_LATENCY_BUCKETS",
    "LATENCY_BUCKETS",
    "SIZE_BUCKETS",
    "percentile_from",
]

# Default latency buckets: 1 us .. ~16.8 s, geometric (x2). Wide enough to
# hold both a sub-ms numpy decode and a multi-second first-geometry jit.
LATENCY_BUCKETS: tuple[float, ...] = tuple(1e-6 * 2**i for i in range(25))

# Device-scale latency buckets: 1 us .. ~1 s, geometric (x sqrt(2)) — twice
# the resolution of LATENCY_BUCKETS where device dispatches actually land.
# The x2 host buckets put a 14 us reconstruct and a 20 us one in the same
# bin (16..32 us); the device hot path's regressions are exactly that
# scale, so its histograms get half-octave steps. The top (~1 s) still
# catches a first-call jit that slipped past the compile split.
DEVICE_LATENCY_BUCKETS: tuple[float, ...] = tuple(
    1e-6 * 2 ** (i / 2) for i in range(41)
)

# Default size buckets: 64 B .. 1 GiB, geometric (x4) — shard payloads at
# the low end, whole stream objects at the top.
SIZE_BUCKETS: tuple[float, ...] = tuple(64.0 * 4**i for i in range(13))


def percentile_from(
    bounds: Sequence[float], counts: Sequence[float], q: float
) -> float:
    """The bucket-interpolated ``q``-quantile of raw (non-cumulative)
    bucket counts — :meth:`Histogram.percentile` factored out so callers
    holding MERGED counts (several children of one family summed, the
    tail sampler's per-op p95 feed) share one interpolation."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = (
                bounds[i] if i < len(bounds)
                else bounds[-1]  # +Inf bucket: clamp
            )
            frac = (target - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return bounds[-1]


class Counters:
    """A named bag of monotonically increasing counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def add(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0.0) + delta

    def get(self, name: str) -> float:
        with self._lock:
            return self._values.get(name, 0.0)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._values)

    def __repr__(self) -> str:
        return f"Counters({self.snapshot()!r})"


class Histogram:
    """Fixed-bucket histogram with percentile extraction.

    ``buckets`` are upper bounds (ascending); an implicit +Inf bucket
    catches the overflow. Observations are counted into the first bucket
    whose bound is >= the value — Prometheus ``le`` semantics, so the
    exporter can emit cumulative bucket lines without re-binning.

    An observation may carry an *exemplar*: a trace-id string, or a
    zero-arg callable resolving to one (or None). Callables defer the
    tail-sampling decision — a latency observes BEFORE its trace's
    keep/drop verdict exists, so resolution happens at snapshot time,
    when it does. Per bucket the last few exemplar refs are retained
    (newest resolvable one wins), bounding memory to O(buckets).
    """

    # Unresolved exemplar refs retained per bucket: enough that a few
    # dropped-trace observations do not erase a kept one, small enough
    # that exemplar memory stays O(buckets).
    EXEMPLAR_DEPTH = 4

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError("buckets must be non-empty and ascending")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        # bucket index -> [(value, str|callable), ...] newest last.
        self._exemplars: dict[int, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar=None) -> None:
        i = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar is not None:
                refs = self._exemplars.setdefault(i, [])
                refs.append((value, exemplar))
                if len(refs) > self.EXEMPLAR_DEPTH:
                    del refs[0]

    @staticmethod
    def _resolve_exemplars(raw: dict) -> dict:
        """Newest resolvable exemplar per bucket index ->
        ``{"trace_id", "value"}`` (callables invoked here, at snapshot
        time — after the tail-sampling decision exists)."""
        out: dict[int, dict] = {}
        for i, refs in raw.items():
            for value, ref in reversed(refs):
                trace_id = ref() if callable(ref) else ref
                if trace_id:
                    out[i] = {"trace_id": str(trace_id), "value": value}
                    break
        return out

    def reset(self) -> None:
        """Zero counts/sum and drop retained exemplar refs in place —
        child identity (and any caller-cached references) survive, so
        instrumented layers keep recording into the same object. The
        test-isolation boundary (a per-test fixture) resets the default
        registry through this."""
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self.sum = 0.0
            self.count = 0
            self._exemplars.clear()

    def snapshot(self) -> dict:
        """(bounds, per-bucket counts, sum, count[, exemplars]) — a
        consistent copy; ``exemplars`` (bucket index -> trace ref) only
        when any observation carried one."""
        with self._lock:
            counts = tuple(self._counts)
            total, count = self.sum, self.count
            raw = {i: list(refs) for i, refs in self._exemplars.items()}
        snap = {
            "bounds": self.bounds,
            "counts": counts,
            "sum": total,
            "count": count,
        }
        if raw:
            resolved = self._resolve_exemplars(raw)
            if resolved:
                snap["exemplars"] = resolved
        return snap

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (q in [0, 1]) by linear
        interpolation inside the containing bucket.

        Values in the +Inf bucket clamp to the top finite bound — the
        honest answer a fixed-bucket sketch can give. Returns 0.0 for an
        empty histogram.
        """
        snap = self.snapshot()
        return percentile_from(self.bounds, snap["counts"], q)

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p90(self) -> float:
        return self.percentile(0.90)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def __repr__(self) -> str:
        return (
            f"Histogram(count={self.count}, p50={self.p50:.3g}, "
            f"p99={self.p99:.3g})"
        )


class Timer:
    """Context-manager stopwatch; feeds a throughput counter and/or a
    latency :class:`Histogram`."""

    def __init__(
        self,
        counters: Optional[Counters] = None,
        name: str = "elapsed_s",
        nbytes: Optional[int] = None,
        histogram: Optional[Histogram] = None,
    ):
        self.counters = counters
        self.name = name
        self.nbytes = nbytes
        self.histogram = histogram
        self.elapsed: float = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        if self.counters is not None:
            self.counters.add(self.name, self.elapsed)
            # Bytes are recorded unconditionally: gating on elapsed > 0
            # silently dropped byte accounting for timings below the
            # clock resolution (the old metrics.py:62 defect), skewing
            # every derived GB/s figure upward on fast paths.
            if self.nbytes is not None:
                self.counters.add(f"{self.name}_bytes", self.nbytes)
        if self.histogram is not None:
            self.histogram.observe(self.elapsed)

    @property
    def gbps(self) -> float:
        if self.nbytes is None or self.elapsed == 0:
            return 0.0
        return self.nbytes / self.elapsed / 1e9
