"""Public codec API of the port: ``rs.ReedSolomon`` (klauspost-style
Encode/Verify/Reconstruct/ReconstructData/Split/Join over shard buffers),
on the CUDA kernels ("device") or the host ("numpy"), and ``fec.FEC`` /
``fec.Share`` (the infectious-style API, with Berlekamp-Welch correction of
corrupted shares on the host or on the card)."""

from noise_ec_tpu_torch.codec.fec import (  # noqa: F401
    FEC,
    NotEnoughShardsError,
    Share,
    TooManyErrorsError,
)
from noise_ec_tpu_torch.codec.rs import (  # noqa: F401
    ReedSolomon,
    SubsetSearchTruncated,
)
