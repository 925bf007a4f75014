"""PyTorch and CUDA port of ``noise_ec_tpu`` for the NVIDIA H100.

The JAX package stays beside it as the reference; this package imports
neither it nor jax. It covers the Reed-Solomon codec over GF(2^8) and
GF(2^16) (``codec.ReedSolomon``), the infectious-style ``codec.FEC`` with
Berlekamp-Welch correction of corrupted shares (``matrix.bw``), batched
and streaming encode and decode on one device (``parallel``), the
locally-repairable code (``codec.LocalReconstructionCode``), the hardware
check (``tools.hwcheck``), observability (``obs``), the codec breaker and
the peer supervisor (``resilience``), the native host codec (``shim``,
built with ``g++`` at first use) and the node (``host``: wire, crypto,
mempool, transport, the shard plugin and the CLI,
``python -m noise_ec_tpu_torch.host.cli``), down to hand-written CUDA
kernels (``ops``, ``csrc``). Entry points run on the card unless the
caller passes ``device="cpu"``, where each kernel's plain PyTorch version
runs instead.
"""

__version__ = "0.1.0"
