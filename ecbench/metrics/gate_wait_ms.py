"""gate_wait_ms.<cell's traffic>: seconds the device gate made callers
wait in the window (its wait histogram's sum), in ms a request."""

COUNTERS = {
    "gate_wait_s": ("histogram", "noise_ec_backpressure_wait_seconds",
                    {"layer": "device"}, "sum"),
}


def read(run):
    if not run.done:
        return None
    return run.counters["gate_wait_s"] / len(run.done) * 1e3
