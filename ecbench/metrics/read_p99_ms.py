"""read_p99_ms: the 99th percentile of every degraded read of the
window, from the gather to the moment its completion is seen."""

from ecbench.readers import latency_ms


def read(run):
    return latency_ms(run, "read", 99)
