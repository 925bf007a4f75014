"""pattern_misses.<cell's traffic>: erasure patterns the words entry
planned in the window because the codec's pattern cache did not hold them
(``noise_ec_batch_pattern_misses_total{entry="reconstruct_batch_words"}``);
None where the program does not count them."""

from ecbench.program import declared

COUNTERS = declared({
    "pattern_misses": ("counter", "noise_ec_batch_pattern_misses_total",
                       {"entry": "reconstruct_batch_words"}, "value"),
})


def read(run):
    return run.counters.get("pattern_misses")
