"""device_idle.<cell's traffic>: percent of the traced window in which
the card ran no kernel, copy or fill."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
