"""Resilience: the circuit breaker the codec device route runs behind
(ops/dispatch.py). Port of ``noise_ec_tpu.resilience``'s breaker; the
chaos proxy and the peer supervisor come with the host layers."""

from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker

__all__ = ["CircuitBreaker"]
