"""Resilience: the circuit breaker the codec device route runs behind
(ops/dispatch.py) and the node's peer supervisor (re-dial behind a
per-peer breaker). Port of ``noise_ec_tpu.resilience``'s breaker and
peer supervisor; the chaos proxy comes later."""

from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker
from noise_ec_tpu_torch.resilience.peers import PeerSupervisor

__all__ = ["CircuitBreaker", "PeerSupervisor"]
