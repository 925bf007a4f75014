"""encode_GBps: data bytes of every encode call over the whole window,
which ends once the card has finished the last call."""

from ecbench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "encode")
