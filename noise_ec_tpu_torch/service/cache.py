"""Tiered decoded-object cache and the warm-peer directory.

The GET hot path (docs/object-service.md "Read path") used to decode
every read from shards — the same hot object a thousand times over — so
read throughput was pinned to codec + fetch speed. This module is the
amortizing tier:

- :class:`DecodedObjectCache` — a bounded host-RAM LRU of decoded
  stripe payloads keyed by ``(content address, stripe index)``.
  Per-stripe granularity means range-GETs hit without materializing
  whole objects. The content address is the manifest address (a
  blake2b-128 of ``tenant\\0name\\0content``), so **invalidation is
  free**: an overwrite-PUT mints a new address and the object layer
  simply evicts the old one (:meth:`evict_address`); nothing cached
  under an address can ever be stale. Size is bounded two ways: the
  configured ``max_bytes`` ceiling (LRU eviction, ``reason="lru"``),
  and a **pressure watermark** — while the device-memory gauges
  (:func:`~noise_ec_tpu_torch.obs.device.hbm_snapshot`) report device memory
  above ``hbm_watermark`` of its limit, the effective ceiling shrinks
  to ``low_fraction * max_bytes`` (``reason="pressure"``), so the host
  cache yields RAM exactly when the node is already memory-stressed.

- :class:`PeerCacheDirectory` — which peers hold which addresses warm.
  Fed by warm-set adverts (:data:`WARMSET_MAGIC` objects piggybacked on
  the repair engine's announce loop — docs/object-service.md), each
  entry maps an HTTP endpoint to its advertised address set with a TTL
  plus a ``load`` hint (the advertiser's in-flight reads), so routing
  picks the LEAST-LOADED warm peer instead of the freshest advert.
  A per-endpoint :class:`~noise_ec_tpu_torch.resilience.breakers.
  CircuitBreaker` guards the routing decision: a dead cache peer opens
  its breaker and the read degrades to the local decode path instead of
  stalling on timeouts.

Metrics: ``noise_ec_object_cache_{hits,misses,evictions,bytes}`` and
(recorded by the object layer) ``noise_ec_object_read_route_total``.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Iterable, Optional

from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import current_trace_id, span

__all__ = [
    "DecodedObjectCache",
    "PeerCacheDirectory",
    "WARMSET_MAGIC",
    "parse_warmset",
    "warmset_blob",
]

# Wire/stored prefix of a warm-set advert object; versioned like the
# manifest magic so future advert schemas can coexist on one fleet.
WARMSET_MAGIC = b"noise-ec-warmset/1\n"


def warmset_blob(
    endpoint: str, addresses: Iterable[str], load: float = 0.0
) -> bytes:
    """One warm-set advert payload: which addresses ``endpoint`` can
    serve from its decoded cache, plus the advertiser's ``load`` hint
    (in-flight reads at advert time) so routing can pick the
    LEAST-LOADED warm peer rather than the freshest advert. ``t`` (wall
    time) makes consecutive adverts distinct objects — identical
    payloads would sign to the identical stripe key and peers would
    absorb them as duplicates without refreshing their directory TTL."""
    return WARMSET_MAGIC + json.dumps({
        "version": 1,
        "endpoint": endpoint,
        "addresses": list(addresses),
        "load": float(load),
        "t": time.time(),
    }).encode()


def parse_warmset(data: bytes) -> Optional[dict]:
    """The advert document, or None when malformed (adverts arrive from
    peers; a bad one is dropped, never raised)."""
    if not data.startswith(WARMSET_MAGIC):
        return None
    try:
        doc = json.loads(data[len(WARMSET_MAGIC):].decode().rstrip("\n"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != 1:
        return None
    endpoint = doc.get("endpoint")
    addresses = doc.get("addresses")
    if not isinstance(endpoint, str) or not endpoint.startswith("http"):
        return None
    if not isinstance(addresses, list) or not all(
        isinstance(a, str) for a in addresses
    ):
        return None
    # Load hint: absent in v1 adverts from older
    # peers — coerce to 0.0 so mixed fleets keep routing.
    load = doc.get("load", 0.0)
    if not isinstance(load, (int, float)) or load < 0:
        load = 0.0
    doc["load"] = float(load)
    return doc


class _CacheMetrics:
    _instances: "weakref.WeakSet[DecodedObjectCache]" = weakref.WeakSet()

    def __init__(self):
        reg = default_registry()
        self.hits = reg.counter("noise_ec_object_cache_hits_total").labels()
        self.misses = reg.counter(
            "noise_ec_object_cache_misses_total"
        ).labels()
        self._evictions = reg.counter(
            "noise_ec_object_cache_evictions_total"
        )
        cls = _CacheMetrics
        # Re-registered on every construction (idempotent — the closure
        # reads the CLASS WeakSet): the test-isolation registry reset
        # drops callback children, and a once-guard would leave the
        # gauge dead for the rest of the process.
        reg.gauge("noise_ec_object_cache_bytes").set_callback(
            lambda: sum(c.bytes_used for c in list(cls._instances))
        )

    def evicted(self, reason: str, count: int) -> None:
        if count:
            self._evictions.labels(reason=reason).add(count)


class DecodedObjectCache:
    """Bounded LRU of decoded stripe payloads (module docstring).

    Entries are the *logical* (unpadded) stripe bytes, so a cached
    stripe serves any sub-range by slicing. ``stripe_key`` (the store
    key of the backing stripe) is tracked per entry so a store-level
    eviction invalidates the cached copy through the store's delete
    listener (:meth:`evict_stripe`)."""

    def __init__(
        self,
        max_bytes: int = 256 << 20,
        *,
        low_fraction: float = 0.5,
        hbm_watermark: float = 0.85,
        pressure_interval_seconds: float = 1.0,
    ):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if not 0.0 < low_fraction <= 1.0:
            raise ValueError(f"low_fraction outside (0, 1]: {low_fraction}")
        self.max_bytes = max_bytes
        self.low_fraction = low_fraction
        self.hbm_watermark = hbm_watermark
        self.pressure_interval_seconds = pressure_interval_seconds
        # A single entry may not monopolize the cache: stripes larger
        # than a quarter of the ceiling are served but never cached.
        self.entry_cap = max(1, max_bytes // 4)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple[str, int], bytes]" = OrderedDict()
        self._by_addr: dict[str, set[int]] = {}
        # Last touch (monotonic) per address: the conversion engine's
        # temperature signal. Residency alone is NOT warmth — an LRU
        # under no pressure never expires, so a write-through entry
        # would otherwise pin its object hot forever.
        self._addr_touched: dict[str, float] = {}
        self._by_stripe: dict[str, tuple[str, int]] = {}
        self._stripe_of: dict[tuple[str, int], str] = {}
        self.bytes_used = 0
        self._pressured = False
        self._last_pressure_check = 0.0
        # Injectable for tests; the default reads the card's memory
        # (torch.cuda; {} without CUDA, which never pressures).
        from noise_ec_tpu_torch.obs.device import hbm_snapshot

        self._hbm = hbm_snapshot
        self._metrics = _CacheMetrics()
        _CacheMetrics._instances.add(self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -------------------------------------------------------------- reads

    def get(self, address: str, idx: int) -> Optional[bytes]:
        """The cached stripe payload (bumping LRU recency) or None;
        records the hit/miss counters — one call per logical lookup.
        Inside a request scope the probe records a ``cache_probe`` span
        (outcome + bytes); outside one — bench warm sweeps, background
        work — the lookup stays span-free."""
        if current_trace_id() is None:
            return self._probe(address, idx)
        with span("cache_probe", stripe=idx) as sp:
            blob = self._probe(address, idx)
            sp.set_attr(
                outcome="hit" if blob is not None else "miss",
                bytes=len(blob) if blob is not None else 0,
            )
            return blob

    def _probe(self, address: str, idx: int) -> Optional[bytes]:
        with self._lock:
            blob = self._entries.get((address, idx))
            if blob is not None:
                self._entries.move_to_end((address, idx))
                self._addr_touched[address] = time.monotonic()
        if blob is None:
            self._metrics.misses.add(1)
        else:
            self._metrics.hits.add(1)
        return blob

    def peek(self, address: str, idx: int) -> Optional[bytes]:
        """Like :meth:`get` but with no recency bump and no counters —
        for re-checks inside an in-flight fetch (the logical request
        already recorded its miss)."""
        with self._lock:
            return self._entries.get((address, idx))

    def contains(self, address: str, idx: int) -> bool:
        with self._lock:
            return (address, idx) in self._entries

    def warm(
        self, address: str, within_seconds: Optional[float] = None
    ) -> bool:
        """True while a stripe of the address sits in the cache AND the
        address was touched within ``within_seconds`` (None = any
        resident entry counts) — the conversion engine's temperature
        signal. Recency matters: an idle LRU never expires entries, so
        residency alone would pin a write-through object hot forever."""
        with self._lock:
            if address not in self._by_addr:
                return False
            if within_seconds is None:
                return True
            touched = self._addr_touched.get(address, 0.0)
            return time.monotonic() - touched <= within_seconds

    def addresses(self, limit: int = 256) -> list[str]:
        """Warm addresses, most recently used first — the node's
        warm-set advert payload."""
        out: list[str] = []
        seen: set[str] = set()
        with self._lock:
            for addr, _ in reversed(self._entries):
                if addr not in seen:
                    seen.add(addr)
                    out.append(addr)
                    if len(out) >= limit:
                        break
        return out

    # ------------------------------------------------------------- writes

    def put(
        self, address: str, idx: int, blob: bytes,
        stripe_key: Optional[str] = None,
    ) -> bool:
        """Insert one decoded stripe payload (write-through from PUT and
        from GET decode results). Returns False when the entry is over
        the per-entry cap and was not cached."""
        blob = bytes(blob)
        if len(blob) > self.entry_cap:
            return False
        limit = self._effective_max()
        with self._lock:
            key = (address, idx)
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_used -= len(old)
            self._entries[key] = blob
            self.bytes_used += len(blob)
            self._by_addr.setdefault(address, set()).add(idx)
            self._addr_touched[address] = time.monotonic()
            if stripe_key is not None:
                self._by_stripe[stripe_key] = key
                self._stripe_of[key] = stripe_key
            lru = self._shrink_locked(self.max_bytes)
            pressured = self._shrink_locked(limit)
        self._metrics.evicted("lru", lru)
        self._metrics.evicted("pressure", pressured)
        if pressured:
            # The HBM-watermark shrink, not routine LRU turnover: the
            # cache yielding RAM to device pressure is a diagnosis
            # signal (hbm-pressure rule) the eviction counter alone
            # cannot date.
            event("cache.shrink", "warn", evicted=pressured,
                  limit_bytes=limit)
        return True

    def evict_address(self, address: str) -> int:
        """Drop every cached stripe of one content address (DELETE /
        overwrite-PUT invalidation — the address IS the content, so this
        is the whole consistency story). Returns entries dropped."""
        with self._lock:
            idxs = self._by_addr.pop(address, None)
            if not idxs:
                return 0
            count = 0
            for idx in idxs:
                if self._drop_locked((address, idx)):
                    count += 1
        self._metrics.evicted("invalidate", count)
        return count

    def evict_stripe(self, stripe_key: str) -> bool:
        """Drop the entry backed by one store stripe key (the store's
        delete-listener hook: a stripe evicted under an address must not
        keep serving from RAM)."""
        with self._lock:
            key = self._by_stripe.get(stripe_key)
            dropped = key is not None and self._drop_locked(key)
        if dropped:
            self._metrics.evicted("invalidate", 1)
        return dropped

    def clear(self) -> int:
        """Invalidate everything (tests, bench cold-start segments)."""
        with self._lock:
            count = len(self._entries)
            self._entries.clear()
            self._by_addr.clear()
            self._addr_touched.clear()
            self._by_stripe.clear()
            self._stripe_of.clear()
            self.bytes_used = 0
        self._metrics.evicted("invalidate", count)
        return count

    # ----------------------------------------------------------- internal

    def _drop_locked(self, key: tuple[str, int]) -> bool:
        blob = self._entries.pop(key, None)
        if blob is None:
            return False
        self.bytes_used -= len(blob)
        address, idx = key
        idxs = self._by_addr.get(address)
        if idxs is not None:
            idxs.discard(idx)
            if not idxs:
                self._by_addr.pop(address, None)
                self._addr_touched.pop(address, None)
        skey = self._stripe_of.pop(key, None)
        if skey is not None:
            self._by_stripe.pop(skey, None)
        return True

    def _shrink_locked(self, limit: int) -> int:
        count = 0
        while self.bytes_used > limit and self._entries:
            key = next(iter(self._entries))  # LRU head
            self._drop_locked(key)
            count += 1
        return count

    def _effective_max(self) -> int:
        """The live ceiling: ``max_bytes``, shrunk to ``low_fraction``
        of it while device memory sits above the watermark. The gauge
        read is rate-limited — the hot path must not pay a device scan
        per insert."""
        now = time.monotonic()
        with self._lock:
            fresh = (
                now - self._last_pressure_check
                < self.pressure_interval_seconds
            )
            if fresh:
                pressured = self._pressured
        if not fresh:
            pressured = False
            try:
                hbm = self._hbm()
                limit = hbm.get("limit_bytes") or 0
                used = hbm.get("bytes_in_use", hbm.get("live_bytes", 0))
                pressured = bool(limit) and used >= self.hbm_watermark * limit
            # noise-ec: allow(event-on-swallow) — telemetry probe — the put proceeds; cache.shrink fires on the eviction path
            except Exception:  # noqa: BLE001 — telemetry must not break puts
                pressured = False
            with self._lock:
                self._pressured = pressured
                self._last_pressure_check = now
        if pressured:
            return max(1, int(self.max_bytes * self.low_fraction))
        return self.max_bytes


class PeerCacheDirectory:
    """Warm-address directory over peer adverts (module docstring).

    ``observe`` ingests one advert; ``peers_for`` answers "who can serve
    this address from RAM right now" — fresh (within TTL) entries only,
    least-loaded first (the advert's ``load`` hint; freshest advert
    breaks ties). Breakers are per endpoint and owned here so the
    routing layer's failure handling has one home."""

    def __init__(
        self,
        ttl_seconds: float = 90.0,
        max_endpoints: int = 256,
        breaker_factory: Optional[Callable[[], object]] = None,
    ):
        self.ttl_seconds = ttl_seconds
        self.max_endpoints = max_endpoints
        self._lock = threading.Lock()
        # endpoint -> (frozenset(addresses), observed_at, load hint)
        self._peers: "OrderedDict[str, tuple[frozenset, float, float]]" = (
            OrderedDict()
        )
        self._breakers: dict[str, object] = {}
        if breaker_factory is None:
            from noise_ec_tpu_torch.resilience.breakers import CircuitBreaker

            def breaker_factory():
                return CircuitBreaker(
                    failure_threshold=2, reset_timeout=2.0,
                    max_reset_timeout=30.0,
                )
        self._breaker_factory = breaker_factory

    def observe(
        self, endpoint: str, addresses: Iterable[str], load: float = 0.0
    ) -> None:
        now = time.monotonic()
        with self._lock:
            self._peers.pop(endpoint, None)
            self._peers[endpoint] = (
                frozenset(addresses), now, max(0.0, float(load))
            )
            while len(self._peers) > self.max_endpoints:
                stale, _ = self._peers.popitem(last=False)
                self._breakers.pop(stale, None)

    def forget(self, endpoint: str) -> None:
        with self._lock:
            self._peers.pop(endpoint, None)
            self._breakers.pop(endpoint, None)

    def peers_for(self, address: str) -> list[str]:
        """Fresh warm peers for the address, LEAST-LOADED first (a
        stampede of cold-stripe fetches would otherwise pile onto
        whichever peer advertised most recently; the load hint spreads
        them). Ties break toward the freshest advert."""
        cutoff = time.monotonic() - self.ttl_seconds
        with self._lock:
            fresh = [
                (load, -t, ep)
                for ep, (addrs, t, load) in self._peers.items()
                if t >= cutoff and address in addrs
            ]
        fresh.sort()
        return [ep for _, _, ep in fresh]

    def load_of(self, endpoint: str) -> Optional[float]:
        """The endpoint's last advertised load hint (None = unknown)."""
        with self._lock:
            entry = self._peers.get(endpoint)
            return entry[2] if entry is not None else None

    def endpoints(self) -> list[str]:
        with self._lock:
            return list(self._peers)

    def breaker(self, endpoint: str):
        with self._lock:
            br = self._breakers.get(endpoint)
            if br is None:
                br = self._breakers[endpoint] = self._breaker_factory()
            return br
