"""inplace_share.<cell's traffic>: the share of the window's words
rebuilds that wrote their codeword in place, percent
(``noise_ec_batch_assembly_total{entry="reconstruct_batch_words"}``,
``path="in_place"`` over both paths); None where the program does not
count them or no rebuild ran."""

from ecbench.program import declared

COUNTERS = declared({
    path: ("counter", "noise_ec_batch_assembly_total",
           {"entry": "reconstruct_batch_words", "path": path}, "value")
    for path in ("in_place", "gathered")
})


def read(run):
    in_place = run.counters.get("in_place")
    if in_place is None:
        return None
    total = in_place + run.counters["gathered"]
    return 100.0 * in_place / total if total else None
