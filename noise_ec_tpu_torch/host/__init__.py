"""Host-side plugin runtime: the node.

Port of ``noise_ec_tpu.host``: the reference's layers L0-L5 above the
codec (SURVEY.md §1): wire format, signing/identity, shard-reassembly
mempool, plugin dispatch, transports, and the CLI REPL
(``python -m noise_ec_tpu_torch.host.cli``). All host code — the device
work lives in ``ops``/``parallel``; this package is the boundary that
feeds it.
"""

from noise_ec_tpu_torch.host.wire import Shard, WireError
from noise_ec_tpu_torch.host.crypto import (
    Blake2bPolicy,
    Ed25519Policy,
    ED25519_BACKEND,
    KeyPair,
    PeerID,
    serialize_message,
    verify,
)
from noise_ec_tpu_torch.host.plugin import ShardPlugin, largest_prime_factor
from noise_ec_tpu_torch.host.mempool import ShardPool

__all__ = [
    "Shard",
    "WireError",
    "Blake2bPolicy",
    "ED25519_BACKEND",
    "Ed25519Policy",
    "KeyPair",
    "PeerID",
    "serialize_message",
    "verify",
    "ShardPlugin",
    "ShardPool",
    "largest_prime_factor",
]
