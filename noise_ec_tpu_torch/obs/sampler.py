"""Always-on sampling profiler: folded Python stacks at ~50 Hz.

Port of ``noise_ec_tpu.obs.sampler``, whole.

The span layer answers "which pipeline stage is slow"; this module
answers "what is this process actually *doing* right now" — including
the paths nobody instrumented (allocator stalls inside numpy, a
transport thread spinning, jit tracing on a surprise geometry). A
daemon thread samples every live thread's Python stack via
``sys._current_frames()`` and folds each into the collapsed
``root;child;leaf count`` form flamegraph tooling eats directly
(inferno / speedscope / Brendan Gregg's ``flamegraph.pl``).

Samples land in per-second buckets on a bounded window, so
``collapsed(seconds=N)`` serves the *last N seconds* without the
endpoint having to block for a capture — the profiler is cheap enough
to leave on (50 Hz x a handful of threads x ~20 frames is well under
0.5% of one core; the Google continuous-profiling line of work runs
exactly this always-on shape fleet-wide).

Served by the stats endpoint as ``GET /profile?seconds=N``
(obs/server.py) and started eagerly by the CLI ``-profile`` flag.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, deque
from typing import Optional

from noise_ec_tpu_torch.obs.registry import Registry, default_registry

__all__ = ["StackSampler", "default_sampler"]


def _fold(frame, thread_name: str, max_depth: int = 64) -> str:
    """One frame chain -> 'thread;mod.func;mod.func' (root first)."""
    parts = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        mod = f.f_globals.get("__name__", "?")
        parts.append(f"{mod}.{code.co_name}")
        f = f.f_back
    parts.append(thread_name)
    parts.reverse()
    return ";".join(parts)


class StackSampler:
    """Background folded-stack sampler over a rolling window.

    ``hz`` is the sampling rate (50 by default — 20 ms resolution, the
    classic always-on price point); ``window_seconds`` bounds retention.
    ``start()``/``close()`` manage the daemon thread; ``collapsed()``
    renders the window. The sampler's own thread is excluded from the
    samples (it would otherwise dominate every profile with its sleep).
    """

    def __init__(self, hz: float = 50.0, window_seconds: float = 120.0,
                 registry: Optional[Registry] = None):
        if hz <= 0 or window_seconds <= 0:
            raise ValueError("hz and window_seconds must be positive")
        self.hz = hz
        self.window_seconds = window_seconds
        self._interval = 1.0 / hz
        # (epoch_second, Counter of folded stacks) — appended in time
        # order by the single sampler thread.
        self._buckets: deque = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_at: Optional[float] = None
        reg = registry if registry is not None else default_registry()
        self._samples_ctr = reg.counter(
            "noise_ec_profile_samples_total"
        ).labels()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "StackSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, name="noise-ec-sampler", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def uptime(self) -> float:
        return time.time() - self.started_at if self.started_at else 0.0

    # ------------------------------------------------------------- sampling

    def _run(self) -> None:
        own_id = threading.get_ident()
        while not self._stop.wait(self._interval):
            now = int(time.time())
            names = {t.ident: t.name for t in threading.enumerate()}
            frames = sys._current_frames()
            folded = [
                _fold(frame, names.get(tid, f"thread-{tid}"))
                for tid, frame in frames.items()
                if tid != own_id
            ]
            if not folded:
                continue
            with self._lock:
                if self._buckets and self._buckets[-1][0] == now:
                    self._buckets[-1][1].update(folded)
                else:
                    self._buckets.append((now, Counter(folded)))
                cutoff = now - self.window_seconds
                while self._buckets and self._buckets[0][0] < cutoff:
                    self._buckets.popleft()
            self._samples_ctr.add(len(folded))

    # -------------------------------------------------------------- reading

    def counts(self, seconds: Optional[float] = None) -> Counter:
        """Merged stack counts over the last ``seconds`` (whole window
        when None)."""
        cutoff = (
            time.time() - seconds if seconds is not None else float("-inf")
        )
        total: Counter = Counter()
        with self._lock:
            for epoch, ctr in self._buckets:
                # Bucket epochs are whole seconds; a bucket straddling
                # the cutoff is included (over- rather than under-serve).
                if epoch >= cutoff - 1:
                    total.update(ctr)
        return total

    def collapsed(self, seconds: Optional[float] = None) -> str:
        """The window as collapsed-stack text: one ``stack count`` line
        per distinct stack, heaviest first — feed straight to
        flamegraph.pl / inferno / speedscope."""
        total = self.counts(seconds)
        return "\n".join(
            f"{stack} {n}"
            for stack, n in sorted(
                total.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )


_default: Optional[StackSampler] = None
_default_lock = threading.Lock()


def default_sampler(start: bool = True) -> StackSampler:
    """The process-wide sampler (created on first use; started unless
    ``start=False``). The stats endpoint and the CLI share it so a
    ``/profile`` scrape and the ``-profile`` flag see one window."""
    global _default
    with _default_lock:
        if _default is None:
            _default = StackSampler()
    if start:
        _default.start()
    return _default
