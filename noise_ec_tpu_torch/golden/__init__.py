"""Slow, obviously-correct NumPy reference codec — the ground-truth anchor
(a copy of the JAX package's jax-free ``golden`` module). Every faster path
of the port, and the hardware check (tools/hwcheck.py), is held bit-exactly
against it."""

from noise_ec_tpu_torch.golden.codec import (  # noqa: F401
    GoldenCodec,
    NotEnoughShardsError,
    TooManyErrorsError,
)
