"""The benchmark's yardstick for device work: the table of peaks and the
least bytes an erasure-code product has to move.

A GF(2^8) product reads every input row once and writes every output row
once, whatever kernel computes it, so the least bytes of a call are (rows
in + rows out) x cell bytes x stripes. An encode reads k data cells and
writes r parity cells; a rebuild reads the code's least read set of
surviving cells (``reference.Code.least_read``: k for an MDS code, k/g a
lost cell for an LRC's local heals) and writes the e lost ones. The count
comes from the geometry and not from any plan, so it reads the same work
whatever implements it. Operations are not counted: the least XOR count of
a GF(2^8) product depends on the factoring an implementation picks.
"""

from __future__ import annotations

# Published HBM bandwidth, bytes/s, by torch.cuda.get_device_name(): the
# NVIDIA H100 SXM data sheet (80 GB HBM3, 3.35 TB/s at the 700 W limit).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def encode_least_bytes(k: int, r: int, cell_bytes: int, stripes: int) -> int:
    """Least bytes of encoding ``stripes`` stripes: k cells in, r out."""
    return (k + r) * cell_bytes * stripes


def rebuild_least_bytes(read: int, lost: int, cell_bytes: int,
                        stripes: int) -> int:
    """Least bytes of rebuilding ``lost`` cells of each of ``stripes``
    stripes: ``read`` surviving cells in, the lost ones out."""
    return (read + lost) * cell_bytes * stripes


def roofline_share(least_bytes: float, device_seconds: float,
                   device_kind: str):
    """Percent of the published bandwidth that ``least_bytes`` in
    ``device_seconds`` of kernel time reach; None where the device has no
    entry in the table or nothing ran."""
    peak = PEAK_HBM_BYTES_PER_S.get(device_kind)
    if peak is None or device_seconds <= 0 or least_bytes <= 0:
        return None
    return 100.0 * least_bytes / peak / device_seconds
