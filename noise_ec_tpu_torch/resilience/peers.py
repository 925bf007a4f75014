"""Self-healing peer lifecycle: supervised re-dial behind circuit breakers.

Port of ``noise_ec_tpu.resilience.peers``, whole: the node's TCP transport
(host/transport.py, ``reconnect=True`` by default) runs it.

The transport's discovery layer already retried *failed discovery dials*
with per-address backoff (``TCPNetwork._dial_backoff``); an ESTABLISHED
connection that died was never re-dialed — the peer stayed gone until
gossip happened to re-introduce it, and with discovery disabled (or a
two-node deployment) it stayed gone forever. This supervisor generalizes
that backoff to the full peer lifecycle:

- when a registered connection WE dialed is lost (peer crash, chaos
  reset, write-timeout disconnect), the supervisor schedules a re-dial
  of the address we originally dialed, with exponential backoff + full
  jitter (:meth:`CircuitBreaker.backoff_delay`);
- every address is gated by a per-peer :class:`CircuitBreaker` fed by
  dial failures AND write-timeout disconnects: a flapping or dead peer
  walks the breaker open and is probed on the breaker's widening
  schedule instead of being hammered every backoff tick;
- breaker state exports as ``noise_ec_peer_circuit_state{peer=...}``
  (0 closed / 1 open / 2 half-open, a live callback gauge), re-dial
  outcomes as ``noise_ec_reconnect_total{result=ok|failed}``, and
  :meth:`health_summary` folds the non-closed breakers into the
  ``/healthz`` JSON body (obs/server.py ``health_details``).

All scheduling runs on the owning network's event loop; entry points are
thread-safe. The supervisor never dials an address the network already
holds a registered connection to (the dial itself is idempotent too).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker

__all__ = ["PeerSupervisor"]

log = logging.getLogger("noise_ec_tpu_torch.resilience")


class PeerSupervisor:
    """Re-dial scheduler for one :class:`TCPNetwork` (module docstring)."""

    # Bound on tracked addresses: addresses are peer-claimed, so the
    # breaker table (and its gauge children) must not grow without bound.
    MAX_TRACKED = 256

    def __init__(
        self,
        network,
        *,
        backoff_base: float = 0.25,
        backoff_cap: float = 30.0,
        failure_threshold: int = 3,
        reset_timeout: float = 2.0,
        max_reset_timeout: float = 60.0,
        seed: Optional[int] = None,
    ):
        self.network = network
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.max_reset_timeout = max_reset_timeout
        self.seed = seed
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._attempts: dict[str, int] = {}
        self._pending: set[str] = set()  # addresses with a scheduled dial
        self._closed = False
        reg = default_registry()
        self._gauge = reg.gauge("noise_ec_peer_circuit_state")
        fam = reg.counter("noise_ec_reconnect_total")
        self._reconnect_ok = fam.labels(result="ok")
        self._reconnect_failed = fam.labels(result="failed")
        # Membership listeners: fn(address, up) fired on every observed
        # peer transition (connection lost -> down, re-dial success ->
        # up). The placement rebalancer rides this to diff ring
        # ownership on churn (docs/placement.md); advisory — a listener
        # exception never breaks supervision.
        self._membership_listeners: list = []

    def add_membership_listener(self, fn) -> None:
        """Register ``fn(address: str, up: bool)`` for peer up/down
        transitions this supervisor observes."""
        with self._lock:
            self._membership_listeners.append(fn)

    def _notify_membership(self, address: str, up: bool) -> None:
        with self._lock:
            listeners = list(self._membership_listeners)
        for fn in listeners:
            try:
                fn(address, up)
            except Exception as exc:  # noqa: BLE001 — advisory hook
                log.warning("membership listener failed for %s: %s",
                            address, exc)

    # ------------------------------------------------------------ breakers

    def breaker(self, address: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(address)
            if br is None:
                if len(self._breakers) >= self.MAX_TRACKED:
                    # Evict an arbitrary closed breaker; refuse to grow past
                    # the cap otherwise (hostile address churn).
                    victim = next(
                        (a for a, b in self._breakers.items() if b.closed),
                        next(iter(self._breakers)),
                    )
                    del self._breakers[victim]
                    self._attempts.pop(victim, None)
                br = self._breakers[address] = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    reset_timeout=self.reset_timeout,
                    max_reset_timeout=self.max_reset_timeout,
                    backoff_base=self.backoff_base,
                    backoff_cap=self.backoff_cap,
                    seed=self.seed,
                )
                # Live-state gauge child: read at scrape time, no
                # transition bookkeeping to forget.
                self._gauge.set_callback(
                    lambda b=br: b.state_code(), peer=address
                )
            return br

    # ------------------------------------------------------- entry points

    def on_connection_lost(self, address: str, reason: str = "") -> None:
        """A registered connection we dialed is gone: feed the breaker
        (write timeouts are peer-health evidence; a clean remote close is
        not) and schedule the supervised re-dial."""
        if self._closed or getattr(self.network, "_closing", False):
            return
        if reason == "write_timeout":
            self.breaker(address).record_failure()
        log.info("peer %s lost (%s); supervising re-dial",
                 address, reason or "connection closed")
        event("peer.down", "warn", peer=address,
              reason=reason or "connection closed",
              breaker=self.breaker(address).state())
        self._notify_membership(address, False)
        self._schedule(address)

    def close(self) -> None:
        self._closed = True

    # ----------------------------------------------------------- schedule

    def _schedule(self, address: str) -> None:
        with self._lock:
            if self._closed or address in self._pending:
                return
            self._pending.add(address)
        br = self.breaker(address)
        remaining = br.open_remaining()
        if remaining > 0:
            # The breaker is open: sleep out the window, then probe
            # half-open. A touch of jitter so healed partitions do not
            # re-dial a fleet in lockstep.
            delay = remaining + br.backoff_delay(0)
        else:
            delay = br.backoff_delay(self._attempts.get(address, 0))
        loop = self.network._loop

        def _fire():
            task = loop.create_task(self._try_dial(address))
            tasks = getattr(self.network, "_tasks", None)
            if tasks is not None:
                tasks.add(task)
                task.add_done_callback(tasks.discard)

        loop.call_soon_threadsafe(lambda: loop.call_later(delay, _fire))

    async def _try_dial(self, address: str) -> None:
        with self._lock:
            self._pending.discard(address)
        if self._closed or getattr(self.network, "_closing", False):
            return
        net = self.network
        with net._lock:
            alive = any(
                p.pid.address == address or p.dial_address == address
                for p in net.peers.values()
            )
        br = self.breaker(address)
        if alive:
            br.record_success()
            with self._lock:
                self._attempts.pop(address, None)
            return
        if not br.allow():
            self._schedule(address)  # open (or probe already in flight)
            return
        try:
            await net._dial(address)
        except Exception as exc:  # noqa: BLE001 — any dial failure
            br.record_failure()
            self._reconnect_failed.add(1)
            with self._lock:
                self._attempts[address] = self._attempts.get(address, 0) + 1
            net._record_error(exc)
            log.info("re-dial of %s failed: %s (breaker %s)",
                     address, exc, br.state())
            self._schedule(address)
        else:
            br.record_success()
            self._reconnect_ok.add(1)
            with self._lock:
                attempts = self._attempts.pop(address, 0)
            log.info("re-dial of %s succeeded", address)
            event("peer.up", peer=address, attempts=attempts)
            self._notify_membership(address, True)

    # --------------------------------------------------------------- health

    def health_summary(self) -> dict:
        """Non-closed peer breakers + reconnect counts, folded into the
        ``/healthz`` JSON body by the stats server."""
        with self._lock:
            breakers = dict(self._breakers)
            pending = len(self._pending)
        circuits = {
            addr: br.snapshot() for addr, br in breakers.items()
            if not br.closed
        }
        return {
            "peer_circuits": circuits,
            "redials_pending": pending,
            "reconnects_ok": int(self._reconnect_ok.value),
            "reconnects_failed": int(self._reconnect_failed.value),
        }
