"""The device trace of a ``--trace 1`` run and the reductions of it.

``torch.profiler`` with CPU and CUDA activities runs from the start of the
window for :data:`SLICE_SECONDS` at most (the whole window when it is
shorter), which the harness marks with a ``record_function`` of its own
(:data:`WINDOW`): a longer trace would take longer to read than a run may.
The trace is exported as Chrome JSON into a temporary directory, read back
and deleted. Device operations are the kernels,
copies and fills the card ran; PyTorch's own are its copies and fills and
the kernels in its namespaces (``at::``, ``c10::``, ``cub::``,
``thrust::``), and every other kernel is the program's.
"""

from __future__ import annotations

import json
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

WINDOW = "ecbench.window"
SLICE_SECONDS = 10.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TORCH_NAMESPACES = ("at::", "c10::", "cub::", "thrust::")
TOP = 10
LABELLED_GAPS = 1000


def is_torch_op(name: str, cat: str) -> bool:
    return cat != "kernel" or any(ns in name for ns in TORCH_NAMESPACES)


class Slice:
    """Traces the window's first :data:`SLICE_SECONDS`: ``begin()`` as the
    window starts, ``tick()`` as it runs, ``end()`` when it closes. Does
    nothing when tracing is off."""

    def __init__(self, enabled: bool, device: str):
        self.prof = None
        self.live = False
        self.t0 = self.t1 = 0.0
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def begin(self, clock) -> None:
        if self.prof is not None:
            self._mark = torch.profiler.record_function(WINDOW)
            self._mark.__enter__()
            self.clock = clock
            self.t0 = clock()
            self.live = True

    def tick(self) -> None:
        if self.live and self.clock() - self.t0 >= SLICE_SECONDS:
            self.end()

    def end(self) -> None:
        if self.live:
            self.t1 = self.clock()
            self._mark.__exit__(None, None, None)
            self.prof.stop()
            self.live = False


@dataclass
class Trace:
    t0: float                 # window, microseconds on the trace's clock
    t1: float
    device: list              # (name, cat, ts, dur) overlapping the window
    host: list                # (name, ts, dur)

    def add_host(self, spans: list, t_window: float) -> None:
        """Add host spans timed on the harness's clock, ``(name, t0, t1)``
        in seconds, placed on the trace's clock by the window's start."""
        for name, a, b in spans:
            self.host.append((name, self.t0 + (a - t_window) * 1e6,
                              (b - a) * 1e6))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self, keep=lambda name, cat: True) -> np.ndarray:
        iv = [(max(ts, self.t0), min(ts + dur, self.t1))
              for name, cat, ts, dur in self.device if keep(name, cat)]
        iv = np.array([x for x in iv if x[1] > x[0]], dtype=np.float64)
        return iv.reshape(-1, 2)

    def seconds(self, torch_own: bool) -> float:
        """Device seconds in PyTorch's own operations, or the program's."""
        iv = self._clipped(lambda n, c: is_torch_op(n, c) == torch_own)
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6

    def _busy(self) -> np.ndarray:
        """The union of every device operation's interval, merged."""
        iv = self._clipped()
        if not len(iv):
            return iv
        iv = iv[np.argsort(iv[:, 0])]
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged)

    def busy_s(self) -> float:
        busy = self._busy()
        return float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host was doing at each gap's middle (the innermost host
        span there), summed over the longest gaps."""
        per_op: dict[str, float] = {}
        for name, cat, ts, dur in self.device:
            lo, hi = max(ts, self.t0), min(ts + dur, self.t1)
            if hi > lo:
                per_op[name[:160]] = per_op.get(name[:160], 0.0) + (hi - lo)
        ops = sorted(per_op.items(), key=lambda x: -x[1])[:TOP]
        busy = self._busy()
        edges = np.concatenate([[self.t0], busy.reshape(-1), [self.t1]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:LABELLED_GAPS]
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        hd = np.array([h[2] for h in self.host], dtype=np.float64)
        idle: dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (hs + hd >= mid))[0]
            label = (names[inside[np.argmin(hd[inside])]] if len(inside)
                     else "no host span")
            idle[label] = idle.get(label, 0.0) + (e - s)
        gaps_out = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
        return {
            "device_ops": [[n, v * 1e-6] for n, v in ops],
            "idle_gaps": [[n, v * 1e-6] for n, v in gaps_out],
        }


def read(prof) -> Trace | None:
    """The window's trace from a finished profiler, or None when the trace
    holds no window mark."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    window = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW]
    if not window:
        return None
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS and ts < t1 and ts + dur > t0:
            device.append((e.get("name", ""), cat, ts, dur))
        elif cat in HOST_CATS:
            host.append((e.get("name", ""), ts, dur))
    return Trace(t0, t1, device, host)
