"""repair_GBps: lost-cell bytes rebuilt by every repair of the window
over the whole window."""

from ecbench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "repair")
