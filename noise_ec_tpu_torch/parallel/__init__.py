"""Batched, mesh-parallel and streaming encode/reconstruct.

- ``mesh``      — device meshes (``make_mesh``, ``default_2d_mesh``) and
  the mesh dispatch tier (``mesh_router``) that shards batched codec
  dispatches over several devices, or several streams of one
- ``batch``     — BatchCodec: multi-object encode/reconstruct through one
  batched dispatch, and its mesh builders (``make_sharded_*``: data
  parallelism over objects, tensor parallelism over parity rows)
- ``streaming`` — the chunked, double-buffered pipeline for wide and long
  codes (RS(17,3), RS(50,20))
- ``multihost`` — one mesh across processes over ``torch.distributed``
  (import the module directly: ``initialize`` joins a process group)
"""

from noise_ec_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from noise_ec_tpu_torch.parallel.batch import BatchCodec  # noqa: F401
from noise_ec_tpu_torch.parallel.streaming import (  # noqa: F401
    StreamChunk,
    StreamingDecoder,
    StreamingEncoder,
    decode_stream,
)
