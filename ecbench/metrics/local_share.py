"""local_share.<suffix>: the share of the window's lost cells that an
LRC's local tier rebuilt, percent (``noise_ec_lrc_repairs_total{tier}``,
``tier="local"`` over both tiers); None where the program counts neither
tier."""

from ecbench.program import declared

COUNTERS = declared({
    f"lrc_{tier}": ("counter", "noise_ec_lrc_repairs_total",
                    {"tier": tier}, "value")
    for tier in ("local", "global")
})


def read(run):
    local = run.counters.get("lrc_local")
    if local is None:
        return None
    total = local + run.counters["lrc_global"]
    return 100.0 * local / total if total else None
