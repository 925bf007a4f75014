"""The churn rebalancer: move only the ownership delta, crash-safely.

Membership events (PeerSupervisor up/down on the TCP path, churn
flips in the fleet lab) change which peer the ring names for a slot.
``run_cycle`` walks the local store, recomputes owners under the
current alive set, and pushes exactly the shards whose owner changed
to their new homes (``noise_ec_placement_moves_total``) — sends are
idempotent store absorbs on the receive side, so a crashed cycle
simply re-runs. Wire amplification is bounded by a token bucket: a
cycle that exhausts its byte budget defers the remainder
(``reason="deferred"``) to the next cycle instead of flooding a
recovering fleet.

Whole-object re-homing (a topology epoch change) rides
``store/convert.py``'s crash contract verbatim: stripe signatures
derive deterministically from (address, code, capacity, index, epoch)
so a re-run after a crash reproduces the SAME keys; the manifest swap
is ONE atomic ``put_manifest`` carrying a ``prev_stripes`` marker; and
the shared convergent GC (:func:`~noise_ec_tpu_torch.store.convert.
finish_prev_stripes_gc`) evicts unreferenced source stripes on the
next cycle — a crash anywhere in the window leaves a marker, never an
orphan.

Per-domain ``noise_ec_placement_shards`` gauges report how many held
shards sit IN their ring-assigned domain — the number that settles to
ring ownership as rebalance converges (the fleet acceptance bar).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from noise_ec_tpu_torch.host.wire import Shard
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import span
from noise_ec_tpu_torch.store.convert import derive_stripe_sig, finish_prev_stripes_gc

__all__ = ["Rebalancer", "TokenBucket", "domain_census",
           "register_domain_gauges"]

log = logging.getLogger("noise_ec_tpu_torch.placement")

_REBALANCE_NS = b"noise-ec-rebalance\0"


class TokenBucket:
    """Byte-rate bound on rebalance wire traffic. ``take`` is
    non-blocking: a dry bucket defers the move to a later cycle."""

    def __init__(self, rate_bytes_per_s: float, burst_bytes: int,
                 clock: Callable[[], float] = time.monotonic):
        if rate_bytes_per_s <= 0 or burst_bytes <= 0:
            raise ValueError("token bucket rate and burst must be > 0")
        self.rate = float(rate_bytes_per_s)
        self.burst = int(burst_bytes)
        self.clock = clock
        self._tokens = float(burst_bytes)
        self._last = clock()
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> bool:
        with self._lock:
            now = self.clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= nbytes:
                self._tokens -= nbytes
                return True
            return False


def domain_census(ring, holdings) -> dict:
    """``{domain: in-place shard count}`` across ``holdings`` — an
    iterable of ``(token, store)`` pairs. A held (stripe, slot) counts
    toward its ring-ASSIGNED domain iff the holder lives in that
    domain; the counts equal the assignment exactly when rebalance has
    converged."""
    counts = {name: 0 for name in ring.topology.names()}
    for token, store in holdings:
        my_domain = ring.topology.domain_of(token)
        if my_domain is None or store is None:
            continue
        for key in store.keys():
            try:
                meta, shards, _ = store.snapshot(key)
            # noise-ec: allow(event-on-swallow) — stripe evicted mid-walk — expected churn, next cycle reconverges
            except Exception:  # noqa: BLE001 — evicted mid-walk
                continue
            try:
                domains = ring.owner_domains(
                    key, meta.n, k=meta.k, code=meta.code
                )
            except ValueError:
                continue
            for slot, blob in enumerate(shards):
                if blob is not None and domains[slot] == my_domain:
                    counts[my_domain] += 1
    return counts


def register_domain_gauges(census_fn: Callable[[str], float],
                           domains) -> None:
    """One ``noise_ec_placement_shards{domain=...}`` gauge child per
    declared domain, read through ``census_fn(domain)`` at scrape
    time."""
    reg = default_registry()
    fam = reg.gauge("noise_ec_placement_shards")
    for name in domains:
        fam.set_callback(lambda d=name: census_fn(d), domain=name)


class Rebalancer:
    """Ownership-delta mover for one node (module docstring).

    ``send(token, shards) -> bool`` is the directed transport the
    caller wires in (the lab's hub path, or ``send_many_to`` through a
    topology directory on TCP). ``self_public_key`` enables the
    origin check guarding local drops — without it nothing is ever
    dropped."""

    def __init__(
        self,
        store,
        ring,
        *,
        self_token: str,
        send: Callable,
        rate_bytes_per_s: float = 4 << 20,
        burst_bytes: int = 8 << 20,
        clock: Callable[[], float] = time.monotonic,
        drop_unowned: bool = False,
        self_public_key: Optional[bytes] = None,
        repair=None,
    ):
        self.store = store
        self.ring = ring
        self.self_token = self_token
        self.send = send
        self.repair = repair
        self.drop_unowned = drop_unowned
        self.self_public_key = (
            bytes(self_public_key) if self_public_key else None
        )
        self.bucket = TokenBucket(rate_bytes_per_s, burst_bytes, clock)
        self._lock = threading.Lock()
        self._alive: set = set(ring.topology.all_peers())
        self._dirty = True
        self._wake = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # (key, slot, owner) -> cycle the push happened in. In-memory
        # only: a restart forgets and re-pushes — absorbs are
        # idempotent, so convergence survives the crash (no-orphans
        # contract); the memo only bounds steady-state re-sends.
        self._sent: dict = {}
        self._cycle = 0
        self.bytes_moved = 0
        # Crash-injection hooks (convert.py's fault_* shape).
        self.fault_mid_move: Optional[Callable] = None
        self.fault_before_swap: Optional[Callable] = None
        self.fault_after_swap: Optional[Callable] = None
        reg = default_registry()
        fam = reg.counter("noise_ec_placement_moves_total")
        self._m_moves = {
            reason: fam.labels(reason=reason)
            for reason in ("delta", "deferred", "dropped", "migrate")
        }

    # -------------------------------------------------------- membership

    def note_up(self, token: str) -> None:
        with self._lock:
            if token not in self._alive:
                self._alive.add(token)
                self._dirty = True
        self._wake.set()

    def note_down(self, token: str) -> None:
        with self._lock:
            if token in self._alive:
                self._alive.discard(token)
                self._dirty = True
        self._wake.set()

    def set_alive(self, tokens) -> None:
        """Replace the whole alive set (the fleet lab syncs its
        authoritative up/down view before each cycle)."""
        with self._lock:
            self._alive = set(tokens)
            self._dirty = True

    def alive(self) -> set:
        with self._lock:
            return set(self._alive)

    # --------------------------------------------------------- background

    def start(self, interval_seconds: float = 30.0) -> "Rebalancer":
        """Run cycles on a daemon thread: promptly after a membership
        wake (``note_up``/``note_down``/``notify``), and on the periodic
        tick while a deferred remainder (or any dirt) is outstanding —
        the token bucket refills between ticks, so a bounded cycle
        budget converges across them."""
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run_loop, args=(float(interval_seconds),),
            name="placement-rebalance", daemon=True,
        )
        self._thread.start()
        self._wake.set()  # born dirty: drain without waiting a tick
        return self

    def notify(self) -> None:
        """Request a prompt cycle from the background thread."""
        with self._lock:
            self._dirty = True
        self._wake.set()

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def _run_loop(self, interval: float) -> None:
        from noise_ec_tpu_torch.ops.coalesce import qos_lane

        # Rebalance re-sends ride the device gate's background lane:
        # churn convergence yields to live traffic at a contended gate.
        with qos_lane("background", tenant="rebalance"):
            while not self._closed:
                self._wake.wait(interval)
                if self._closed:
                    return
                self._wake.clear()
                with self._lock:
                    dirty = self._dirty
                if not dirty:
                    continue
                try:
                    self.run_cycle()
                except Exception as exc:  # noqa: BLE001 — keep loop alive
                    log.warning("rebalance cycle failed: %s", exc)

    # ------------------------------------------------------------- cycles

    def run_cycle(self, max_keys: Optional[int] = None) -> dict:
        """One delta pass over the local store (module docstring).
        Returns its stats; ``deferred > 0`` means the token bucket dried
        up and another cycle is needed to converge."""
        alive = self.alive()
        stats = {"examined": 0, "moved": 0, "deferred": 0, "dropped": 0}
        my_domain = self.ring.topology.domain_of(self.self_token)
        with span("rebalance", node=self.self_token):
            keys = self.store.keys()
            if max_keys is not None:
                keys = keys[:max_keys]
            for key in keys:
                try:
                    meta, shards, _ = self.store.snapshot(key)
                # noise-ec: allow(event-on-swallow) — stripe evicted mid-walk — expected churn, next cycle reconverges
                except Exception:  # noqa: BLE001 — evicted mid-walk
                    continue
                stats["examined"] += 1
                try:
                    owners = self.ring.owners(
                        key, meta.n, k=meta.k, code=meta.code, alive=alive
                    )
                    domains = self.ring.owner_domains(
                        key, meta.n, k=meta.k, code=meta.code
                    )
                except ValueError:
                    continue  # geometry the topology cannot place
                for slot, blob in enumerate(shards):
                    if blob is None:
                        continue
                    owner = owners[slot]
                    if owner is None or owner == self.self_token:
                        continue
                    memo = (key, slot, owner)
                    sent_cycle = self._sent.get(memo)
                    if sent_cycle is None:
                        if not self.bucket.take(len(blob)):
                            stats["deferred"] += 1
                            self._m_moves["deferred"].add(1)
                            event(
                                "rebalance.defer",
                                examined=stats["examined"],
                                moved=stats["moved"],
                                want_bytes=len(blob),
                            )
                            return stats  # dry: resume next cycle
                        if self.fault_mid_move is not None:
                            self.fault_mid_move()
                        msg = Shard(
                            file_signature=meta.file_signature,
                            shard_data=blob,
                            shard_number=slot,
                            total_shards=meta.n,
                            minimum_needed_shards=meta.k,
                        )
                        if self.send(owner, [msg]):
                            self._sent[memo] = self._cycle
                            self.bytes_moved += len(blob)
                            stats["moved"] += 1
                            self._m_moves["delta"].add(1)
                        continue
                    # Pushed in an EARLIER cycle: the new owner has had
                    # a full cycle to absorb, so a non-origin holder
                    # outside the slot's assigned domain may reclaim the
                    # space (never the origin — its full stripe is the
                    # fleet's ground-truth copy).
                    if (
                        self.drop_unowned
                        and sent_cycle < self._cycle
                        and domains[slot] != my_domain
                        and not self._is_origin(meta)
                    ):
                        if self.store.drop_shard(key, slot):
                            stats["dropped"] += 1
                            self._m_moves["dropped"].add(1)
            self._cycle += 1
        if stats["moved"] or stats["dropped"]:
            event(
                "rebalance.diff",
                examined=stats["examined"],
                moved=stats["moved"],
                dropped=stats["dropped"],
                bytes_moved=self.bytes_moved,
            )
        with self._lock:
            if not stats["deferred"]:
                self._dirty = False
        return stats

    def _is_origin(self, meta) -> bool:
        if self.self_public_key is None:
            return True  # unknown identity: treat as origin, never drop
        return bytes(meta.sender_public_key) == self.self_public_key

    def census(self) -> int:
        """This node's in-place shard count (its contribution to the
        per-domain gauge)."""
        my_domain = self.ring.topology.domain_of(self.self_token)
        if my_domain is None:
            return 0
        return domain_census(
            self.ring, [(self.self_token, self.store)]
        ).get(my_domain, 0)

    # ------------------------------------------- whole-object migration

    def migrate_manifest(self, address: str, *, epoch: int) -> bool:
        """Re-home one locally-held object under placement ``epoch``
        (module docstring: convert.py's deterministic sigs + atomic
        swap + convergent prev_stripes GC). Idempotent and re-runnable:
        a crash before the swap reproduces identical stripe keys, a
        crash after it leaves the ``prev_stripes`` marker the next call
        converges on. Returns True when the object is at ``epoch`` with
        no marker outstanding."""
        doc = self.store.get_manifest(address)
        if doc is None:
            return False
        if doc.get("prev_stripes"):
            # Crashed in the swap..GC window: converge the marker first.
            finish_prev_stripes_gc(
                self.store, address, doc, repair=self.repair
            )
            doc = self.store.get_manifest(address) or doc
        if int(doc.get("placement_epoch", -1)) == int(epoch):
            return True
        keys = [str(s) for s in doc.get("stripes") or ()]
        size = int(doc["size"])
        capacity = int(doc["stripe_bytes"])
        k, n = int(doc["k"]), int(doc["n"])
        field = str(doc.get("field", "gf256"))
        code = str(doc.get("code", "rs"))
        parts = []
        for idx, key in enumerate(keys):
            blob = self.store.read(key)  # raises below k: caller's call
            logical = min(capacity, size - idx * capacity)
            parts.append(blob[:logical])
        whole = b"".join(parts)
        new_keys = []
        for idx in range(max(1, -(-len(whole) // capacity))):
            chunk = whole[idx * capacity : (idx + 1) * capacity]
            pad = (-len(chunk)) % k
            sig = derive_stripe_sig(
                _REBALANCE_NS, address, code, capacity, idx,
                salt=int(epoch),
            )
            new_keys.append(self.store.put_object(
                sig, chunk + bytes(pad), k, n, field=field, code=code,
            ))
            self._m_moves["migrate"].add(1)
        if self.fault_before_swap is not None:
            self.fault_before_swap()
        new_doc = dict(doc)
        new_doc.update(
            stripes=new_keys,
            placement_epoch=int(epoch),
            prev_stripes=keys,
        )
        # THE swap (convert.py's contract): one atomic manifest write.
        self.store.put_manifest(address, new_doc)
        if self.fault_after_swap is not None:
            self.fault_after_swap()
        finish_prev_stripes_gc(
            self.store, address, new_doc, repair=self.repair
        )
        return True
