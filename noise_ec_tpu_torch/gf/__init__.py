"""Finite-field arithmetic for the erasure codec (copies of the JAX package's
jax-free ``gf`` modules).

``field``     — GF(2^8) / GF(2^16) log/exp-table arithmetic (NumPy, host side).
``bitmatrix`` — the bitsliced view: every GF(2^m) constant is an m x m matrix
                over GF(2), so a generator-matrix multiply becomes an XOR
                network over bit-planes — the formulation the kernels use.
"""

from noise_ec_tpu_torch.gf.bitmatrix import (  # noqa: F401
    constant_bitmatrix,
    expand_generator_bits,
    expand_generator_masks,
)
from noise_ec_tpu_torch.gf.field import GF, GF256, GF65536  # noqa: F401
