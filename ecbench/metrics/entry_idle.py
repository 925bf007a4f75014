"""entry_idle.<cell's traffic>: percent of the traced window in which the
card ran no kernel, copy or fill while a words entry's span
(``batch.encode_words``, ``batch.reconstruct_words``) was open on the
host: the idle time the entries themselves leave. None where the trace
holds no device operation or no such span."""

import numpy as np

ROOTS = ("batch.encode_words", "batch.reconstruct_words")


def _merged(iv: np.ndarray) -> np.ndarray:
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            total += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.t1 <= tr.t0:
        return None
    roots = np.array([(max(ts, tr.t0), min(ts + dur, tr.t1))
                      for name, ts, dur in tr.host if name in ROOTS],
                     dtype=np.float64).reshape(-1, 2)
    roots = roots[roots[:, 1] > roots[:, 0]]
    if not len(roots):
        return None
    roots = _merged(roots)
    busy = tr._busy()
    open_s = float((roots[:, 1] - roots[:, 0]).sum())
    covered = _overlap(roots, busy) if len(busy) else 0.0
    return 100.0 * (open_s - covered) / (tr.t1 - tr.t0)
