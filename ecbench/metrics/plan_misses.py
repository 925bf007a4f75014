"""plan_misses.<cell's traffic>: words-entry calls in the window that
missed the plan cache and planned their matrix (device_op's compile
route)."""

COUNTERS = {
    "plan_compiles": ("counter", "noise_ec_jit_compiles_total",
                      {"kernel": "matmul_words"}, "value"),
}


def read(run):
    return run.counters["plan_compiles"]
