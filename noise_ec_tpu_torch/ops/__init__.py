"""The device hot path: GF(2^8) and GF(2^16) matrix x stripes as a GF(2)
product over bit-planes (an XOR network, or a dense int8 product past its
budgets), in hand-written CUDA kernels for the H100 (``csrc/``).

- ``pack``     — K2/K3, lane pack and unpack between words and bit-planes,
  and their row-blocked use K6 on the panel route; K10, the GF(2^16)
  16-plane pack and unpack, and the byte-sliced GF(2^16) layouts
- ``gf2mm``    — K4, the sparse GF(2) matmul over tiled planes
- ``fused``    — K1, pack + network + unpack in one launch, and K5, the
  same in K slices for networks K1 cannot hold, with their planners
- ``panel``    — K7, the block-panel K-tiled matmul for wide geometries,
  and its planner
- ``mxu``      — K8, the dense GF(2) product on the tensor cores (the
  "mxu" route)
- ``network``  — the factored XOR network (whole or cut into panels) as a
  kernel operand
- ``dispatch`` — ``DeviceCodec``: per-matrix plans and the words/stripes
  entry points
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
