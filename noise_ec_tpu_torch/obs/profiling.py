"""Device traces and per-kernel throughput counters.

Port of ``noise_ec_tpu.obs.profiling``:

- **Device traces**: :func:`device_trace` captures a region with
  ``torch.profiler`` (host and, where there is a card, CUDA activity) and
  writes it as a Chrome trace (``chrome://tracing`` or Perfetto), so any
  region can be captured without the callers importing profiler plumbing.
- **Per-kernel counters**: :data:`kernel_counters` accumulates call
  counts and payload bytes per device entry point; ``DeviceCodec`` feeds
  it on every public entry.

Counters are process-global on purpose: the hot path records four counter
adds per device call (no sync, no device round trip). The same event
lands on two surfaces: the plain :data:`kernel_counters` bag and the
registry families ``noise_ec_kernel_{calls,bytes}_total{entry}``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from noise_ec_tpu_torch.obs.metrics import Counters

__all__ = [
    "device_trace",
    "kernel_counters",
    "record_kernel",
]

# Global per-kernel stats: "<entry>_calls" and "<entry>_bytes" pairs, e.g.
# matmul_words_calls / matmul_words_bytes.
kernel_counters = Counters()

# Cached registry children per entry (default registry only): the hot path
# pays a dict get + two adds, not a labels() resolution.
_registry_children: dict[str, tuple] = {}


def record_kernel(entry: str, nbytes: int) -> None:
    """One device-kernel invocation moving ``nbytes`` of payload."""
    kernel_counters.add(f"{entry}_calls", 1)
    kernel_counters.add(f"{entry}_bytes", nbytes)
    pair = _registry_children.get(entry)
    if pair is None:
        from noise_ec_tpu_torch.obs.registry import default_registry

        reg = default_registry()
        pair = _registry_children[entry] = (
            reg.counter("noise_ec_kernel_calls_total").labels(entry=entry),
            reg.counter("noise_ec_kernel_bytes_total").labels(entry=entry),
        )
    pair[0].add(1)
    pair[1].add(nbytes)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region into ``logdir``
    as ``trace-<pid>-<ns>.json`` (Chrome trace format).

    No-op when ``logdir`` is falsy, so call sites can thread a CLI flag
    straight through. CUDA activity is recorded where a card is present;
    the profiler is imported only here."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.monotonic_ns()}.json"))
