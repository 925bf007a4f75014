"""gf_roofline.<cell's traffic>: the least product bytes of the requests
that came back in the traced window (ecbench/roofline.py) at the published
bandwidth, over the device time there of every kernel that is not
PyTorch's own, percent."""

from ecbench.roofline import roofline_share


def read(run):
    if run.trace is None or not run.traced:
        return None
    least = sum(d.least_bytes for d in run.traced)
    return roofline_share(least, run.trace.seconds(torch_own=False),
                          run.device_kind)
