"""Public codec API of the port: ``rs.ReedSolomon`` (klauspost-style
Encode/Verify/Reconstruct/ReconstructData/Split/Join over shard buffers),
on the CUDA kernels ("device") or the host ("numpy"); ``fec.FEC`` /
``fec.Share`` (the infectious-style API, with Berlekamp-Welch correction of
corrupted shares on the host or on the card); and, layered on both,
``lrc.LocalReconstructionCode`` (Azure-style local parity groups that heal
a single loss from k/g group members, the global parities past the
budget), with ``codec_for_code`` / ``parse_code`` for ``"rs"`` and
``"lrc:<g>"`` code strings."""

from noise_ec_tpu_torch.codec.fec import (  # noqa: F401
    FEC,
    NotEnoughShardsError,
    Share,
    TooManyErrorsError,
)
from noise_ec_tpu_torch.codec.lrc import (  # noqa: F401
    LocalReconstructionCode,
    codec_for_code,
    parse_code,
)
from noise_ec_tpu_torch.codec.rs import (  # noqa: F401
    ReedSolomon,
    SubsetSearchTruncated,
)
