"""Batched and streaming encode/reconstruct on one device.

- ``batch``     — BatchCodec: multi-object encode/reconstruct through one
  batched dispatch (the reference's mesh entries raise: ROADMAP queue 1
  item 7)
- ``streaming`` — the chunked, double-buffered pipeline for wide and long
  codes (RS(17,3), RS(50,20))
"""

from noise_ec_tpu_torch.parallel.batch import BatchCodec  # noqa: F401
from noise_ec_tpu_torch.parallel.streaming import (  # noqa: F401
    StreamChunk,
    StreamingDecoder,
    StreamingEncoder,
    decode_stream,
)
