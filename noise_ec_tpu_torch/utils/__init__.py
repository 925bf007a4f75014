"""Shared host utilities: logging setup plus compatibility re-exports.

The metrics/profiling primitives live in :mod:`noise_ec_tpu_torch.obs`;
the names below stay importable from here, as in ``noise_ec_tpu.utils``.
"""

from noise_ec_tpu_torch.obs.metrics import Counters, Timer
from noise_ec_tpu_torch.obs.profiling import (
    device_trace,
    kernel_counters,
    kernel_gbps,
    timed_window,
)
from noise_ec_tpu_torch.utils.logging import setup_logging

__all__ = [
    "Counters",
    "Timer",
    "device_trace",
    "kernel_counters",
    "kernel_gbps",
    "setup_logging",
    "timed_window",
]
