"""entry_device_ms.<cell's traffic>: device ms of one words entry, from
the CUDA timing events the program records at each entry's start and end
on its stream during a trace (``noise_ec_batch_device_seconds{entry}``,
its sum over its count in the window), for the entry that recorded any;
None where none did or the program does not record them."""

from ecbench.program import declared

ENTRIES = ("encode_batch_words", "reconstruct_batch_words")
COUNTERS = declared({
    f"{entry}.{attr}": ("histogram", "noise_ec_batch_device_seconds",
                        {"entry": entry}, attr)
    for entry in ENTRIES for attr in ("sum", "count")
})


def read(run):
    for entry in ENTRIES:
        n = run.counters.get(f"{entry}.count")
        if n:
            return run.counters[f"{entry}.sum"] / n * 1e3
    return None
