"""Shard-reassembly mempool.

The reference keeps per-object reassembly state in a ``sync.Map`` keyed by
the hex file signature (main.go:49, 55-71). Its pool logic has four
documented defects (SURVEY.md §3.2 quirks 1-4): decode fires on the
(k+1)-th arrival, the triggering share is dropped, duplicate share numbers
inflate the pool, and Load/Delete/Store is racy. This pool fixes all four
**by construction** — the observable contract (wire format, geometry read
from each arriving message, signature-keyed pools) is unchanged, and each
divergence is called out at the relevant line.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional

from noise_ec_tpu_torch.codec.fec import Share
from noise_ec_tpu_torch.obs.registry import default_registry

__all__ = [
    "ShardPool",
    "PoolEntry",
    "PoolTooLargeError",
    "GeometryMismatchError",
    "PoolLimitError",
]


class PoolLimitError(ValueError):
    """The pool's global resource budget (pool count or pinned bytes) is
    exhausted; the arriving share is rejected. Forged first-arrival shards
    could otherwise pin unbounded memory for a full TTL — the reference has
    no cap at all (``sync.Map``, main.go:49)."""


class PoolTooLargeError(RuntimeError):
    """More distinct shares than the geometry's total — the reference's
    CASE D error ("mempool larger than the maximum amount of shards",
    main.go:100-102). With geometry pinned per pool entry and share numbers
    range-checked upstream this is unreachable; it survives as a defensive
    invariant."""


class GeometryMismatchError(ValueError):
    """A share arrived advertising a different (k, n) than the geometry
    pinned when this pool was opened. The reference trusts every arriving
    message's geometry (main.go:65,72-73), which lets a single forged
    message evict or misjudge a legitimate pool; we pin instead and drop
    the disagreeing share."""


@dataclass
class PoolEntry:
    """Reassembly state for one object (one file signature).

    Geometry (k, n) and the share length are pinned by the first accepted
    share; later shares must agree or are rejected. Pinning means a forged
    message can no longer destroy an in-progress reassembly — though a
    forged share that arrives *first* can still open a poisoned pool
    (shares are not individually authenticated, in the reference either —
    only the whole message is signed). The TTL bounds that damage."""

    shares: dict[int, Share] = field(default_factory=dict)  # number -> share
    k: int = 0
    n: int = 0
    share_len: int = -1
    created_at: float = field(default_factory=time.monotonic)

    def distinct(self) -> int:
        return len(self.shares)


class ShardPool:
    """Thread-safe reassembly pool.

    Divergences from the reference, all deliberate (SURVEY.md §7.4
    "faithfulness vs correctness"):

    - one lock guards every pool transition, replacing the non-atomic
      Load/Delete/Store on ``sync.Map`` (quirk 4, main.go:64-71);
    - shares are dict-keyed by share number, so duplicate delivery is
      idempotent (quirk 3);
    - the arriving share is always recorded before any decode decision, so
      decode fires on the k-th *distinct* share, not the (k+1)-th arrival,
      and the triggering share participates (quirks 1-2, main.go:65-72).
    """

    DEFAULT_TTL_SECONDS = 600.0
    DEFAULT_MAX_POOLS = 65536
    DEFAULT_MAX_TOTAL_BYTES = 1 << 30  # 1 GiB of pinned share data

    # Live pools for the aggregate occupancy gauges (same shape as the
    # dispatcher queue-depth gauge: callback gauges over a WeakSet, so a
    # dropped plugin's pool cannot pin itself through the registry).
    _instances: "weakref.WeakSet[ShardPool]" = weakref.WeakSet()
    _gauges_registered = False
    _eviction_counters: dict = {}

    def __init__(
        self,
        ttl_seconds: Optional[float] = DEFAULT_TTL_SECONDS,
        max_pools: int = DEFAULT_MAX_POOLS,
        max_total_bytes: int = DEFAULT_MAX_TOTAL_BYTES,
    ):
        self._lock = threading.Lock()
        self._pools: dict[str, PoolEntry] = {}
        self._ttl = ttl_seconds
        self._max_pools = max_pools
        self._max_total_bytes = max_total_bytes
        self._total_bytes = 0
        cls = type(self)
        cls._instances.add(self)
        # Re-registered on every construction (idempotent — the closures
        # read the CLASS WeakSet): the test-isolation registry reset
        # drops callback children, and a once-guard would leave the
        # gauges dead for the rest of the process.
        reg = default_registry()
        reg.gauge("noise_ec_mempool_pools").set_callback(
            lambda: sum(len(p) for p in list(ShardPool._instances))
        )
        reg.gauge("noise_ec_mempool_pinned_bytes").set_callback(
            lambda: sum(
                p.pinned_bytes for p in list(ShardPool._instances)
            )
        )
        if not ShardPool._gauges_registered:
            ShardPool._gauges_registered = True
            fam = reg.counter("noise_ec_mempool_evictions_total")
            ShardPool._eviction_counters = {
                reason: fam.labels(reason=reason)
                for reason in ("ttl", "explicit", "overflow")
            }

    def add(
        self, key: str, share: Share, k: int, n: int
    ) -> tuple[list[Share], int, bool]:
        """Record ``share`` under ``key``; returns (snapshot, distinct count,
        was_new).

        The first accepted share pins (k, n) and the share length for the
        pool; later shares that disagree are rejected
        (:class:`GeometryMismatchError` / ValueError) without touching the
        pooled shares — mixed lengths can never decode, and trusting each
        message's geometry would let one forged shard evict a legitimate
        pool. ``was_new`` is False for duplicate share numbers (the
        duplicate is ignored), letting the caller skip re-decoding on
        replays. The snapshot is ordered by share number and safe to hand
        to a decoder without further locking."""
        with self._lock:
            self._expire_locked()
            entry = self._pools.get(key)
            if entry is None:
                if len(self._pools) >= self._max_pools:
                    raise PoolLimitError(
                        f"pool count limit {self._max_pools} reached"
                    )
                entry = self._pools[key] = PoolEntry(
                    k=k, n=n, share_len=len(share.data)
                )
            elif (k, n) != (entry.k, entry.n):
                raise GeometryMismatchError(
                    f"share advertises geometry ({k}, {n}) but pool "
                    f"{key[:16]}… is pinned to ({entry.k}, {entry.n})"
                )
            was_new = share.number not in entry.shares
            if was_new:
                if len(share.data) != entry.share_len:
                    raise ValueError(
                        f"share #{share.number} length {len(share.data)} "
                        f"!= pooled share length {entry.share_len}"
                    )
                if self._total_bytes + len(share.data) > self._max_total_bytes:
                    if not entry.shares:  # don't keep an empty pool around
                        del self._pools[key]
                    raise PoolLimitError(
                        f"pinned-bytes limit {self._max_total_bytes} reached"
                    )
                entry.shares[share.number] = share
                self._total_bytes += len(share.data)
            if entry.distinct() > entry.n:
                self._drop_locked(key, reason="overflow")
                raise PoolTooLargeError(
                    f"mempool for {key[:16]}… holds {entry.distinct()} distinct "
                    f"shares, more than total_shards={entry.n}"
                )
            snapshot = [entry.shares[i] for i in sorted(entry.shares)]
            return snapshot, len(snapshot), was_new

    def _drop_locked(self, key: str, reason: str = "explicit") -> None:
        entry = self._pools.pop(key, None)
        if entry is not None:
            # every pooled share was length-checked against share_len
            self._total_bytes -= entry.share_len * len(entry.shares)
            counter = ShardPool._eviction_counters.get(reason)
            if counter is not None:
                counter.add(1)

    def evict(self, key: str) -> None:
        with self._lock:
            self._drop_locked(key)

    @property
    def pinned_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def get(self, key: str) -> Optional[PoolEntry]:
        with self._lock:
            return self._pools.get(key)

    def snapshot(self, key: str) -> tuple[list[Share], int]:
        """(ordered share list copy, distinct count) under the pool lock —
        safe to hand to a decoder while other threads keep adding
        (iterating a live ``entry.shares`` outside the lock races with
        ``add``)."""
        with self._lock:
            entry = self._pools.get(key)
            if entry is None:
                return [], 0
            shares = [entry.shares[i] for i in sorted(entry.shares)]
            return shares, len(shares)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pools)

    def _expire_locked(self) -> None:
        """Drop pools older than the TTL. The reference keeps partial pools
        forever (in-memory ``sync.Map``, no expiry — SURVEY.md §5
        checkpoint/resume row); a TTL bounds memory under shard loss.

        Pools are only ever inserted with ``created_at = now`` and dicts
        preserve insertion order, so the stale pools are exactly a prefix of
        iteration order: this scans stale entries plus one, not all 65k
        pools per arriving shard."""
        if self._ttl is None:
            return
        cutoff = time.monotonic() - self._ttl
        while self._pools:
            key = next(iter(self._pools))
            if self._pools[key].created_at >= cutoff:
                break
            self._drop_locked(key, reason="ttl")
