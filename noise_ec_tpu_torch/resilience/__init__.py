"""Resilience: chaos injection and the self-healing machinery it proves.

Port of ``noise_ec_tpu.resilience``:

- :mod:`noise_ec_tpu_torch.resilience.chaos` — a seeded in-process TCP
  proxy applying the :class:`~noise_ec_tpu_torch.host.transport.FaultInjector`
  fault model plus link-level faults (delay, bandwidth caps, resets,
  directional partitions with scheduled heals, peer kill/restart);
- :mod:`noise_ec_tpu_torch.resilience.breakers` — the circuit breaker
  shared by the per-peer transport lifecycle and the codec device route
  (ops/dispatch.py);
- :mod:`noise_ec_tpu_torch.resilience.peers` — the self-healing peer
  supervisor: re-dial with exponential backoff and full jitter, gated per
  peer by a breaker.

See docs/resilience.md for the fault model, chaos profiles, breaker
states and the NACK shard-repair flow.
"""

from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker
from noise_ec_tpu_torch.resilience.chaos import ChaosLink, ChaosProfile, ChaosProxy
from noise_ec_tpu_torch.resilience.peers import PeerSupervisor

__all__ = [
    "ChaosLink",
    "ChaosProfile",
    "ChaosProxy",
    "CircuitBreaker",
    "PeerSupervisor",
]
