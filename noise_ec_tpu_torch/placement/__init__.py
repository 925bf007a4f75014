"""Failure-domain-aware shard placement (docs/placement.md).

The layer between codec and wire that knows *where* shards live:

- :mod:`~noise_ec_tpu_torch.placement.ring` — the seeded consistent-hashing
  ring mapping each stripe's n shards onto n distinct failure domains
  declared in a :class:`~noise_ec_tpu_torch.placement.ring.Topology`;
- :mod:`~noise_ec_tpu_torch.placement.deliver` — targeted shard delivery
  (one signed SHARD_BATCH cohort per destination peer instead of a
  full broadcast) plus the owner-side gather path for reads;
- :mod:`~noise_ec_tpu_torch.placement.rebalance` — the membership-diff
  rebalancer that moves only the ownership delta, token-bucket
  bounded, with convert-style crash-safe manifest migration.
"""

from noise_ec_tpu_torch.placement.ring import PlacementRing, Topology
from noise_ec_tpu_torch.placement.deliver import TargetedDelivery
from noise_ec_tpu_torch.placement.rebalance import Rebalancer, TokenBucket

__all__ = [
    "PlacementRing",
    "Rebalancer",
    "TargetedDelivery",
    "TokenBucket",
    "Topology",
]
