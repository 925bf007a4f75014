"""Reductions that the metric readers (``ecbench/metrics/*.py``) share.
Each takes the :class:`ecbench.harness.Run` of one run and the kind of
request it reads (the mix's ``request``)."""

from __future__ import annotations

import numpy as np


def rate_gbps(run, op: str):
    """Useful bytes of every ``op`` request of the window over the whole
    window, GB/s."""
    done = [d.useful_bytes for d in run.done if d.op == op]
    if not done or run.window_s <= 0:
        return None
    return sum(done) / run.window_s / 1e9


def latency_ms(run, op: str, percent: float):
    """A percentile of the latency of every ``op`` request of the window,
    ms."""
    done = [d.t1 - d.t0 for d in run.done if d.op == op]
    if not done:
        return None
    return float(np.percentile(done, percent)) * 1e3
