"""Fleet lab: thousand-peer in-process load/chaos harness.

The scale tier of the test story (docs/fleet.md): spin up hundreds to
thousands of lightweight in-process peers — each a real
:class:`~noise_ec_tpu_torch.host.plugin.ShardPlugin` — drive them with a
declarative traffic-mix grammar (:class:`FleetProfile`), compose a
named chaos profile plus churn per link, and score the run honestly
(delivered / shed-with-Retry-After / churned / lost are four different
things). CLI: ``-fleet-profile`` / ``-fleet-size`` / ``-fleet-report``.
"""

from noise_ec_tpu_torch.fleet.profile import NAMED_CHAOS, FleetProfile
from noise_ec_tpu_torch.fleet.runner import FleetLab, FleetPeer
from noise_ec_tpu_torch.fleet.score import FleetScorer

__all__ = [
    "NAMED_CHAOS",
    "FleetLab",
    "FleetPeer",
    "FleetProfile",
    "FleetScorer",
]
