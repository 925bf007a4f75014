"""Compatibility shim: profiling moved to ``obs.profiling``.

``kernel_counters`` here IS the same object as
``noise_ec_tpu_torch.obs.profiling.kernel_counters`` — callers snapshotting
through either path see the same stats.
"""

from noise_ec_tpu_torch.obs.profiling import (
    device_trace,
    kernel_counters,
    kernel_gbps,
    record_kernel,
    timed_window,
)

__all__ = [
    "device_trace",
    "kernel_counters",
    "kernel_gbps",
    "record_kernel",
    "timed_window",
]
