"""torch_copy_ms.<cell's traffic>: device ms a request in PyTorch's own
kernels, copies and fills (the gathers, concatenations and index selects)
in the traced window, over the requests that came back in it."""


def read(run):
    if run.trace is None or not run.trace.device or not run.traced:
        return None
    return run.trace.seconds(torch_own=True) / len(run.traced) * 1e3
