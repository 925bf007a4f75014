"""The device hot path: GF(2^8) and GF(2^16) matrix x stripes as a GF(2)
product over bit-planes (an XOR network, or a dense int8 product past its
budgets), in hand-written CUDA kernels for the H100 (``csrc/``).

- ``pack``     — K2/K3, lane pack and unpack between words and bit-planes
  (8 or 16 planes a symbol), and their row-blocked use K6 on the panel
  route; K9 and K10, the
  sublane-group pack and unpack at 8 and 16 planes (the reference's tier 3
  and GF(2^16) words), and the byte-sliced GF(2^16) layouts
- ``gf2mm``    — K4, the sparse GF(2) matmul over tiled planes; K11/K12,
  the dense-mask GF(2) matmul with the mask matrix as an operand
- ``fused``    — K1, pack + network + unpack in one launch, and K5, pack
  + product + unpack in K slices on the GF(2) product core, each at 8 or
  16 planes a symbol, with their planners
- ``panel``    — K7, the block-panel K-tiled matmul for wide geometries on
  the same core, and its planner
- ``gf2tile``  — the product core's operand (the matrix's bit expansion as
  tiled select masks), its shared-memory fit and its plain product
- ``mxu``      — K8, the dense GF(2) product on the tensor cores (the
  "mxu" route)
- ``network``  — the factored XOR network (whole or cut into panels) as a
  kernel operand
- ``dispatch`` — ``DeviceCodec``: per-matrix plans, the words/stripes
  entry points, and the error-correcting decode's syndrome and decode1
  entries; the device gate every entry is admitted through, and the codec
  breaker the codecs consult around each product
- ``coalesce`` — batching of concurrent same-shape requests

Each kernel module keeps a ``LAUNCHES`` count of its kernel launches.
"""

from noise_ec_tpu_torch.ops import fused, gf2mm, mxu, pack, panel

_COUNTS = (pack.LAUNCHES, gf2mm.LAUNCHES, fused.LAUNCHES, panel.LAUNCHES,
           mxu.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: n for counts in _COUNTS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0
