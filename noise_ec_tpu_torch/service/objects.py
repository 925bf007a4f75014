"""The object layer: chunked erasure-coded puts, manifests, and ranged
degraded reads over the stripe store.

This is the promotion of the stripe store into a user-facing
storage surface (docs/object-service.md): an *object* of arbitrary size
is chunked into fixed-capacity stripes, each stripe signed and
erasure-encoded **through the existing plugin send path**
(``ShardPlugin.shard_and_broadcast`` with an explicit per-namespace
geometry) — so every stripe is simultaneously

- stored locally as a trusted stripe (the origin copy, ground truth for
  anti-entropy), and
- broadcast to peers as ordinary signed SHARD traffic, which each peer
  verifies end-to-end and lands in its own store (replication rides the
  transport path that already exists, chaos hardening included).

A *manifest* (content address -> ordered stripe keys + geometry + size
+ tenant/name) is itself broadcast as one more signed object with a
magic prefix; every node's store put-listener recognizes the prefix and
indexes it, so any surviving peer can resolve and serve the object —
the origin node is not special. Reads map a byte range onto the minimal
stripe set and stream decoded bytes, reading degraded (any k of n
trusted shards, ``StripeStore.read``); a stripe below k locally is
enqueued for the repair engine's anti-entropy fetch and the read waits
a bounded time for peers to heal it.

Admission control (the ROADMAP backpressure gap): PUTs are refused
*before any stripe is encoded* when

- the tenant's byte/object quota would be breached
  (:class:`~noise_ec_tpu_torch.service.tenants.QuotaExceededError`), or
- the node is degrading — the wired ``SLOEvaluator`` verdict is
  unhealthy, or device HBM in use crosses the watermark fraction of its
  limit (:class:`ShedError`, surfaced as 503 + ``Retry-After`` by
  service/http.py) — shedding at the door instead of queueing work onto
  a device that is already behind.

Trust and consistency model: manifests arrive only through
signature-verified objects, so indexing one is as trusted as any
delivery; the ``address`` field is the uploader's content hash of the
object (recomputed only on full reads by callers that want it —
stripe-level integrity is already anchored per-stripe by the Ed25519
signature each stripe carries). Re-putting a name replaces it
(last-write-wins per node); DELETE is local — replicas converge by
operator policy, not tombstones (v1 scope, documented).

The GET hot path is TIERED (docs/object-service.md "Read path"): each
stripe of a request is served from the cheapest surviving copy —

1. the local decoded-stripe cache (service/cache.py; content-addressed,
   so invalidation is the address change itself),
2. the local k-data-shard join when every data slot is trusted (a
   memcpy, cheaper than any network hop),
3. a warm peer's ``/objects`` endpoint (the peer advertised the address
   in its warm set; a per-peer breaker degrades a dead cache peer to
   the next tier),
4. the local degraded reconstruct / anti-entropy fetch (the pre-cache
   path, unchanged).

Cache misses ride the coalescer's single-flight tier
(``submit_shared``): concurrent readers of one cold (address, stripe)
share ONE fetch, so a zipfian stampede costs one dispatch. Admission:
a degraded node (SLO verdict / HBM watermark) serves its warm cache
but SHEDS reads that would enqueue new decode work — the same 503 +
Retry-After contract PUTs already have.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import re
import threading
import time
import weakref
from typing import Iterable, Iterator, Optional

from noise_ec_tpu_torch.obs.device import hbm_snapshot
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.metrics import percentile_from
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import (
    current_trace_id,
    default_tracer,
    request,
    span,
    trace_key,
)
from noise_ec_tpu_torch.ops.coalesce import coalescer, qos_lane
from noise_ec_tpu_torch.service.cache import (
    WARMSET_MAGIC,
    DecodedObjectCache,
    PeerCacheDirectory,
    parse_warmset,
    warmset_blob,
)
from noise_ec_tpu_torch.service.tenants import (
    QuotaExceededError,
    TenantRegistry,
    UnknownTenantError,
)
from noise_ec_tpu_torch.store.stripe import (
    DegradedReadError,
    StripeStore,
    UnknownStripeError,
)

__all__ = [
    "MANIFEST_MAGIC",
    "ObjectStore",
    "ObjectUnavailableError",
    "ShedError",
    "UnknownObjectError",
]

log = logging.getLogger("noise_ec_tpu_torch.service")

# Wire/stored prefix of a manifest object; the version rides in the
# magic so a future manifest schema can coexist on the same fleet.
MANIFEST_MAGIC = b"noise-ec-manifest/1\n"

OBJECT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")

DEFAULT_STRIPE_BYTES = 1 << 20


class UnknownObjectError(KeyError):
    """No manifest for this tenant/name (or address)."""


class ObjectUnavailableError(RuntimeError):
    """A stripe is below k trusted shards locally and the anti-entropy
    fetch did not heal it within the read's wait budget (or the stripe
    is entirely absent from this node)."""


class ShedError(RuntimeError):
    """PUT admission refused by load-shedding (SLO degraded / HBM
    watermark); ``reason`` is the bounded shed-counter label and
    ``retry_after`` the seconds a client should back off."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(f"put shed: {reason}")
        self.reason = reason
        self.retry_after = retry_after


# GET serving tiers by cost (docs/object-service.md): a request's route
# label is the most expensive tier any of its stripes touched.
_ROUTE_RANK = {"cache": 0, "local": 1, "peer": 2, "gather": 3, "decode": 4}

# Null request scope for hedge workers running outside any trace.
_NULL_SCOPE = contextlib.nullcontext()


class _HedgeCancelled(Exception):
    """Internal: a hedged fetch attempt observed its cancel flag."""


class _ObjectMetrics:
    """Cached registry children for the noise_ec_object_* family."""

    _instances: "weakref.WeakSet[ObjectStore]" = weakref.WeakSet()

    # Distinct tenant label values recorded before collapsing to
    # "other": a tenant sweep must not explode registry cardinality
    # (mirrors the transport's per-peer bound).
    TENANT_LABEL_CAP = 64

    def __init__(self):
        reg = default_registry()
        self._puts = reg.counter("noise_ec_object_puts_total")
        self._put_bytes = reg.counter("noise_ec_object_put_bytes_total")
        self._deletes = reg.counter("noise_ec_object_deletes_total")
        self._gets = reg.counter("noise_ec_object_gets_total")
        self._rejects = reg.counter("noise_ec_object_rejects_total")
        self._sheds = reg.counter("noise_ec_object_shed_total")
        self._tenant_bytes = reg.gauge("noise_ec_object_tenant_bytes")
        self.get_bytes = reg.counter(
            "noise_ec_object_get_bytes_total"
        ).labels()
        self.put_seconds = reg.histogram(
            "noise_ec_object_put_seconds"
        ).labels()
        self.get_seconds = reg.histogram(
            "noise_ec_object_get_seconds"
        ).labels()
        self.routes = {
            route: reg.counter(
                "noise_ec_object_read_route_total"
            ).labels(route=route)
            for route in ("cache", "local", "peer", "gather", "decode")
        }
        self._op_seconds = reg.histogram("noise_ec_object_op_seconds")
        self._tenant_sheds = reg.counter(
            "noise_ec_object_tenant_shed_total"
        )
        self._op_children: dict[tuple[str, str, str], object] = {}
        self._p95_cache: dict[str, tuple[float, Optional[float]]] = {}
        self._tenant_labels: set[str] = set()
        # Hedged-fetch accounting (docs/object-service.md "Read path"):
        # requests that entered the hedged engine, hedge attempts that
        # won, in-flight losers cancelled, and completions that arrived
        # after a winner was already decided (accounted, never leaked).
        self.hedge_requests = reg.counter(
            "noise_ec_hedge_requests_total"
        ).labels()
        self.hedge_wins = reg.counter("noise_ec_hedge_wins_total").labels()
        self.hedge_cancelled = reg.counter(
            "noise_ec_hedge_cancelled_total"
        ).labels()
        self.hedge_late = reg.counter("noise_ec_hedge_late_total").labels()
        # Per-peer fetch latency: the distribution whose clamped p95
        # arms the hedge trigger for that peer.
        self._peer_seconds = reg.histogram("noise_ec_peer_fetch_seconds")
        self._peer_children: dict[str, object] = {}
        self._peer_p95_cache: dict[str, tuple[float, Optional[float]]] = {}
        self._peer_labels: set[str] = set()
        cls = _ObjectMetrics
        # Re-registered on every construction (idempotent — the closure
        # reads the CLASS WeakSet): the test-isolation registry reset
        # drops callback children, and a once-guard would leave the
        # gauge dead for the rest of the process.
        reg.gauge("noise_ec_object_manifests").set_callback(
            lambda: sum(
                store.manifest_count()
                for store in {
                    id(o.store): o.store for o in list(cls._instances)
                }.values()
            )
        )

    def put(self, tenant: str, nbytes: int) -> None:
        self._puts.labels(tenant=tenant).add(1)
        self._put_bytes.labels(tenant=tenant).add(nbytes)

    def delete(self, tenant: str) -> None:
        self._deletes.labels(tenant=tenant).add(1)

    def get(self, result: str) -> None:
        self._gets.labels(result=result).add(1)

    def reject(self, reason: str) -> None:
        self._rejects.labels(reason=reason).add(1)

    def shed(self, reason: str, tenant: Optional[str] = None) -> None:
        self._sheds.labels(reason=reason).add(1)
        if tenant is not None:
            self._tenant_sheds.labels(
                tenant=self._tenant_label(tenant), reason=reason
            ).add(1)
        event("object.shed", "warn", tenant=tenant, reason=reason)

    def tenant_bytes(self, tenant: str, value: int) -> None:
        self._tenant_bytes.labels(tenant=tenant).set(value)

    def _tenant_label(self, tenant: str) -> str:
        """The tenant label value, collapsed to "other" past the
        cardinality cap (first-come keeps its own series)."""
        if tenant in self._tenant_labels:
            return tenant
        if len(self._tenant_labels) >= self.TENANT_LABEL_CAP:
            return "other"
        self._tenant_labels.add(tenant)
        return tenant

    def op_seconds(self, tenant: str, op: str, route: str,
                   seconds: float, exemplar=None) -> None:
        """Observe one op into the per-tenant attribution histogram
        (children cached — this lands once per request, not per
        stripe). ``exemplar`` is the request scope's deferred trace-id
        resolver: /metrics renders the bucket's ``# {trace_id=...}``
        exemplar from it once the tail sampler has kept the trace."""
        key = (self._tenant_label(tenant), op, route)
        child = self._op_children.get(key)
        if child is None:
            child = self._op_children[key] = self._op_seconds.labels(
                tenant=key[0], op=op, route=route
            )
        child.observe(seconds, exemplar=exemplar)

    # Minimum op-histogram observations before the rolling p95 is
    # trusted as a tail-sampling keep signal; below it every clean
    # trace rides the seeded 1-in-N sample alone.
    P95_MIN_COUNT = 32
    # The tail sampler consults the p95 on EVERY request commit, but
    # the merge below walks (and lock-snapshots) every child of the
    # shared family — per-request cost that scales with tenant/node
    # cardinality (a 50-node lab shares one registry). A threshold a
    # quarter-second stale is indistinguishable for sampling, so the
    # sweep runs at most once per TTL per op.
    P95_CACHE_SECONDS = 0.25

    def op_p95(self, op: str) -> Optional[float]:
        """Rolling per-op p95 merged across every child of the
        op-latency family (all tenants and routes, all ObjectStore
        instances — the family is shared through the registry), or None
        while the histogram is too thin. The tail sampler's
        slower-than-p95 keep rule reads this; results are cached for
        ``P95_CACHE_SECONDS`` (a benign data race: losers recompute)."""
        now = time.monotonic()
        hit = self._p95_cache.get(op)
        if hit is not None and now - hit[0] < self.P95_CACHE_SECONDS:
            return hit[1]
        bounds = None
        counts: Optional[list[float]] = None
        total = 0
        for values, child in self._op_seconds.children():
            if values[1] != op:
                continue
            snap = child.snapshot()
            if bounds is None:
                bounds = snap["bounds"]
                counts = [0.0] * len(snap["counts"])
            for i, c in enumerate(snap["counts"]):
                counts[i] += c
            total += snap["count"]
        if counts is None or total < self.P95_MIN_COUNT:
            p95 = None
        else:
            p95 = percentile_from(bounds, counts, 0.95)
        self._p95_cache[op] = (now, p95)
        return p95

    # Minimum completed fetches from one peer before its p95 arms the
    # hedge trigger (below it the engine uses the ceiling — hedge LATE
    # on an unknown peer rather than double every cold-start fetch).
    HEDGE_MIN_COUNT = 8

    def _peer_label(self, endpoint: str) -> str:
        """Peer label value, collapsed past the cardinality cap (same
        bound as tenants — a churning fleet must not grow the family)."""
        if endpoint in self._peer_labels:
            return endpoint
        if len(self._peer_labels) >= self.TENANT_LABEL_CAP:
            return "other"
        self._peer_labels.add(endpoint)
        return endpoint

    def peer_fetch_seconds(self, endpoint: str, seconds: float) -> None:
        """Observe one COMPLETED fetch from ``endpoint`` (errors and
        cancellations stay out — they would poison the p95 trigger)."""
        label = self._peer_label(endpoint)
        child = self._peer_children.get(label)
        if child is None:
            child = self._peer_children[label] = self._peer_seconds.labels(
                peer=label
            )
        child.observe(seconds)

    def peer_p95(self, endpoint: str) -> Optional[float]:
        """Rolling p95 of completed fetches from ``endpoint``, or None
        while that peer's distribution is thinner than
        ``HEDGE_MIN_COUNT`` (TTL-cached like :meth:`op_p95`)."""
        label = self._peer_label(endpoint)
        now = time.monotonic()
        hit = self._peer_p95_cache.get(label)
        if hit is not None and now - hit[0] < self.P95_CACHE_SECONDS:
            return hit[1]
        child = self._peer_children.get(label)
        p95 = None
        if child is not None:
            snap = child.snapshot()
            if snap["count"] >= self.HEDGE_MIN_COUNT:
                p95 = percentile_from(
                    snap["bounds"], snap["counts"], 0.95
                )
        self._peer_p95_cache[label] = (now, p95)
        return p95


class ObjectStore:
    """Tenant-scoped object API over one :class:`StripeStore` (module
    docstring). The plugin must be wired to the SAME store — verified
    receives (replicated stripes and manifests) land there, and the
    put-listener absorb hook is how this layer learns about them."""

    def __init__(
        self,
        store: StripeStore,
        plugin,
        network,
        *,
        tenants: Optional[TenantRegistry] = None,
        engine=None,
        slo=None,
        stripe_bytes: int = DEFAULT_STRIPE_BYTES,
        k: int = 4,
        n: int = 6,
        hbm_watermark: float = 0.90,
        fetch_timeout_seconds: float = 8.0,
        retry_after_seconds: float = 2.0,
        max_object_bytes: int = 1 << 30,
        cache: Optional[DecodedObjectCache] = None,
        peer_timeout_seconds: float = 2.0,
        hedge_enabled: bool = True,
        hedge_floor_seconds: float = 0.02,
        hedge_ceiling_seconds: float = 1.0,
    ):
        if plugin.store is not store:
            raise ValueError(
                "plugin.store must be the same StripeStore (verified "
                "receives and manifests land there)"
            )
        if not 1 <= k <= n:
            raise ValueError(f"invalid default geometry k={k} n={n}")
        if stripe_bytes < k:
            raise ValueError(f"stripe_bytes {stripe_bytes} below k={k}")
        if not 0 < hedge_floor_seconds <= hedge_ceiling_seconds:
            raise ValueError(
                "hedge clamp must satisfy 0 < floor <= ceiling, got "
                f"{hedge_floor_seconds} / {hedge_ceiling_seconds}"
            )
        self.store = store
        self.plugin = plugin
        self.network = network
        self.tenants = tenants if tenants is not None else TenantRegistry()
        self.engine = engine
        self.slo = slo
        self.stripe_bytes = stripe_bytes
        self.default_k = k
        self.default_n = n
        self.hbm_watermark = hbm_watermark
        self.fetch_timeout_seconds = fetch_timeout_seconds
        self.retry_after_seconds = retry_after_seconds
        self.max_object_bytes = max_object_bytes
        self._lock = threading.Lock()
        self._index: dict[tuple[str, str], str] = {}  # (tenant, name) -> addr
        self._usage: dict[str, list] = {}  # tenant -> [bytes, objects]
        self._known: set[str] = set()  # addresses counted into usage
        # Tiered read path (module docstring): decoded-stripe cache,
        # warm-peer directory, and the advert bookkeeping (one stored
        # advert stripe per peer endpoint — the newest replaces the
        # previous so adverts never accumulate in the store).
        self.cache = cache
        self.peer_timeout_seconds = peer_timeout_seconds
        # Hedged peer fetches (module docstring): with >= 2 allowed warm
        # sources, a straggling primary is raced by the next-ranked peer
        # after that primary's clamped p95, and the loser is CANCELLED.
        self.hedge_enabled = hedge_enabled
        self.hedge_floor_seconds = hedge_floor_seconds
        self.hedge_ceiling_seconds = hedge_ceiling_seconds
        self.directory = PeerCacheDirectory()
        self.advertise_url: Optional[str] = None
        self._advert_stripes: dict[str, str] = {}
        # In-flight GET count: the warm-set advert's load hint, so warm
        # peers route cold-stripe fetches to the LEAST-LOADED holder
        # (docs/object-service.md "Read path").
        self._live_reads = 0
        # PUT write-through stays bounded: objects bigger than this do
        # not pin their whole stripe set into the cache at once.
        self._write_through_cap = (
            cache.max_bytes // 4 if cache is not None else 0
        )
        self._metrics = _ObjectMetrics()
        _ObjectMetrics._instances.add(self)
        # The tail sampler's slower-than-p95 keep rule feeds from the
        # op-latency histograms this layer already records (op_p95
        # reads the SHARED registry family, so any instance's provider
        # sees every instance's observations).
        default_tracer().set_p95_provider(self._metrics.op_p95)
        store.add_put_listener(self._on_store_put)
        store.add_delete_listener(self._on_store_evict)
        self._reindex()

    # --------------------------------------------------------- admission

    def _qos(self, tenant_name: str):
        """The tenant's QoS-lane context for one request: every device
        dispatch and coalesced batch under it queues at the gate in the
        tenant's lane at the tenant's weight (ops/coalesce.py,
        docs/object-service.md "QoS lanes"). Policy problems degrade to
        the live/1 default — QoS must never refuse a request."""
        lane, weight = "live", 1
        try:
            tenant = self.tenants.get(tenant_name)
            lane, weight = tenant.lane, tenant.weight
        # noise-ec: allow(event-on-swallow) — unknown tenant raises from the op body later; pre-count only
        except Exception:  # noqa: BLE001 — unknown tenant raises later
            pass
        return qos_lane(lane, tenant=tenant_name, weight=weight)

    def shed_reason(self) -> Optional[str]:
        """The load-shed signal for PUT admission: ``"slo"`` while the
        wired evaluator's verdict is degraded, ``"hbm"`` when device
        memory in use crosses the watermark fraction of the reported
        limit, ``None`` to admit. Cheap enough per request (one verdict
        sort over a bounded window + one allocator stat read)."""
        if self.slo is not None and not self.slo.verdict()["healthy"]:
            return "slo"
        try:
            hbm = hbm_snapshot()
        # noise-ec: allow(event-on-swallow) — telemetry fast-path — the PUT itself proceeds and raises on real faults
        except Exception:  # noqa: BLE001 — telemetry must not refuse PUTs
            return None
        limit = hbm.get("limit_bytes") or 0
        used = hbm.get("bytes_in_use", hbm.get("live_bytes", 0))
        if limit and used >= self.hbm_watermark * limit:
            return "hbm"
        return None

    def usage(self, tenant: str) -> dict:
        with self._lock:
            used = self._usage.get(tenant, [0, 0])
            return {"bytes": used[0], "objects": used[1]}

    # ----------------------------------------------------- cache routing

    def enable_peer_routing(self, url: str) -> None:
        """Advertise this node's warm addresses and accept warm-peer
        routing. ``url`` is the HTTP endpoint serving this node's
        ``/objects`` tree (the StatsServer the API is mounted on); the
        warm-set advert piggybacks on the repair engine's announce loop
        (``RepairEngine.add_announce_hook``)."""
        self.advertise_url = url.rstrip("/")
        if self.engine is not None and self.cache is not None:
            self.engine.add_announce_hook(self._announce_warm)

    def _announce_warm(self) -> None:
        """Broadcast one warm-set advert (the announce-loop piggyback).
        Rides the ordinary signed-object path, so every peer's store
        put-listener absorbs it exactly like a manifest."""
        if self.cache is None or self.advertise_url is None:
            return
        addresses = self.cache.addresses(limit=256)
        if not addresses:
            return
        with self._lock:
            load = self._live_reads
        blob = warmset_blob(self.advertise_url, addresses, load=load)
        k, n = self.default_k, self.default_n
        blob += b"\n" * ((-len(blob)) % k)
        self.plugin.shard_and_broadcast(self.network, blob, geometry=(k, n))

    def _absorb_warmset(self, key: str, data: bytes) -> None:
        doc = parse_warmset(data)
        if doc is None:
            log.warning("ignoring malformed warm-set advert in stripe %s",
                        key)
            return
        endpoint = doc["endpoint"].rstrip("/")
        prev = self._advert_stripes.get(endpoint)
        self._advert_stripes[endpoint] = key
        if prev is not None and prev != key:
            # One stored advert stripe per peer: adverts refresh every
            # announce interval and would otherwise accumulate forever.
            self.store.evict(prev)
        if endpoint != self.advertise_url:
            self.directory.observe(
                endpoint, doc["addresses"], load=doc.get("load", 0.0)
            )

    def _on_store_evict(self, key: str) -> None:
        """Store delete listener: a stripe evicted out from under an
        address must not keep serving from RAM."""
        if self.cache is not None:
            self.cache.evict_stripe(key)

    # -------------------------------------------------------------- puts

    def put(self, tenant: str, name: str, data: bytes) -> dict:
        """Store one in-memory object; see :meth:`put_stream`."""
        return self.put_stream(tenant, name, iter((data,)), len(data))

    def put_stream(
        self, tenant_name: str, name: str,
        chunks: Iterable[bytes], size: int,
    ) -> dict:
        """Admit, chunk, encode, broadcast and manifest one object of
        ``size`` bytes arriving as a chunk iterator (memory stays
        O(stripe)); returns the manifest document. Admission (quota,
        then shed) runs BEFORE the first chunk is consumed, so a refused
        PUT costs no encode and queues nothing toward the device.

        The whole PUT runs inside a request-scoped trace (joining the
        HTTP layer's when one is active): quota/shed refusals raise
        through the scope and are kept as error traces; each stripe's
        encode+delivery is a ``stripe_put`` child span."""
        with request("put", tenant=tenant_name) as rscope:
            with self._qos(tenant_name):
                return self._put_stream(
                    rscope, tenant_name, name, chunks, size
                )

    def _put_stream(
        self, rscope, tenant_name: str, name: str,
        chunks: Iterable[bytes], size: int,
    ) -> dict:
        t0 = time.monotonic()
        try:
            tenant = self.tenants.get(tenant_name)
        except UnknownTenantError:
            self._metrics.reject("unknown_tenant")
            raise
        if not OBJECT_NAME_RE.match(name):
            raise ValueError(f"bad object name {name!r}")
        if size <= 0:
            raise ValueError("cannot store an empty object")
        if size > self.max_object_bytes:
            raise ValueError(
                f"object of {size} bytes exceeds the "
                f"{self.max_object_bytes}-byte cap"
            )
        with self._lock:
            used_bytes, used_objects = self._usage.get(tenant.name, [0, 0])
        try:
            self.tenants.admit(tenant, used_bytes, used_objects, size)
        except QuotaExceededError as exc:
            self._metrics.reject(exc.reason)
            raise
        reason = self.shed_reason()
        if reason is not None:
            self._metrics.shed(reason, tenant.name)
            raise ShedError(reason, self.retry_after_seconds)

        k = tenant.k or self.default_k
        n = tenant.n or self.default_n
        capacity = max(k, self.stripe_bytes - self.stripe_bytes % k)
        # The address hashes (tenant, name, content) — not content alone:
        # identical bytes under two names must be two objects (their
        # manifests live and die independently) even though their
        # STRIPES still dedup to the same keys (the stripe key is the
        # signature prefix of identical payloads).
        digest = hashlib.blake2b(digest_size=16)
        digest.update(
            tenant.name.encode() + b"\0" + name.encode() + b"\0"
        )
        stripe_keys: list[str] = []
        # Write-through warmth: the PUT just produced decoded-equivalent
        # bytes, so small-enough objects land in the cache on the way in
        # (the address is only known once the whole body hashed, so the
        # logical stripe payloads are held until then — bounded by the
        # write-through cap, O(stripe) memory otherwise).
        warm: Optional[list[tuple[str, bytes]]] = (
            [] if self.cache is not None
            and size <= self._write_through_cap else None
        )
        buf = bytearray()
        total = 0

        def flush(payload: bytes) -> None:
            pad = (-len(payload)) % k
            # Data stripes opt into ring-targeted placement
            # (docs/placement.md: one cohort per owner instead of a
            # full broadcast); the MANIFEST below stays broadcast so
            # every node can index the object.
            with span("stripe_put", stripe=len(stripe_keys)) as sp:
                shards = self.plugin.shard_and_broadcast(
                    self.network, payload + bytes(pad), geometry=(k, n),
                    targeted=True,
                )
                stripe_keys.append(trace_key(shards[0].file_signature))
                sp.set_attr(key=stripe_keys[-1], bytes=len(payload))
            if warm is not None:
                warm.append((stripe_keys[-1], payload))

        for chunk in chunks:
            if not chunk:
                continue
            digest.update(chunk)
            total += len(chunk)
            if total > size:
                raise ValueError(
                    f"body exceeds the declared size of {size} bytes"
                )
            buf += chunk
            while len(buf) >= capacity:
                flush(bytes(buf[:capacity]))
                del buf[:capacity]
        if total != size:
            raise ValueError(
                f"body ended at {total} of the declared {size} bytes"
            )
        if buf:
            flush(bytes(buf))

        doc = {
            "version": 1,
            "address": digest.hexdigest(),
            "tenant": tenant.name,
            "name": name,
            "size": size,
            "stripe_bytes": capacity,
            "k": k,
            "n": n,
            "field": "gf256",
            "stripes": stripe_keys,
            "created": time.time(),
        }
        blob = MANIFEST_MAGIC + json.dumps(doc).encode()
        blob += b"\n" * ((-len(blob)) % k)
        # The broadcast lands the manifest in the local store too, where
        # the put listener (_on_store_put) indexes it — the exact code
        # path every replica runs, so origin and peers converge through
        # one absorb implementation.
        with span("stripe_put", kind="manifest", bytes=len(blob)):
            self.plugin.shard_and_broadcast(
                self.network, blob, geometry=(k, n)
            )
        if warm is not None:
            # After the manifest broadcast: an overwrite-PUT's manifest
            # absorb just evicted the REPLACED address, so the new
            # entries can never be invalidated by their own put.
            for idx, (skey, payload) in enumerate(warm):
                self.cache.put(doc["address"], idx, payload,
                               stripe_key=skey)
        if tenant.replicas > 1 and self.engine is not None:
            with self._lock:
                manifest_stripe = self._manifest_stripe_locked(doc["address"])
            pinned = list(stripe_keys)
            if manifest_stripe:
                pinned.append(manifest_stripe)
            self.engine.pin_announce(pinned)
        self._metrics.put(tenant.name, size)
        elapsed = time.monotonic() - t0
        self._metrics.put_seconds.observe(elapsed)
        self._metrics.op_seconds(
            tenant.name, "put", "encode", elapsed,
            exemplar=rscope.exemplar,
        )
        return self.store.get_manifest(doc["address"]) or doc

    def _manifest_stripe_locked(self, address: str) -> Optional[str]:
        doc = self.store.get_manifest(address)
        return doc.get("manifest_stripe") if doc else None

    # ----------------------------------------------------------- absorb

    def _on_store_put(self, key: str, data: bytes, meta) -> None:
        """Store put listener: recognize manifest objects (local puts
        AND signature-verified replicas arriving through the plugin) and
        index them; recognize warm-set adverts and feed the peer-cache
        directory. Never raises (the store logs and continues)."""
        if data.startswith(WARMSET_MAGIC):
            self._absorb_warmset(key, data)
            return
        if not data.startswith(MANIFEST_MAGIC):
            return
        try:
            doc = json.loads(data[len(MANIFEST_MAGIC):].decode())
            self._validate_manifest(doc)
        except (ValueError, KeyError, UnicodeDecodeError) as exc:
            log.warning("ignoring malformed manifest in stripe %s: %s",
                        key, exc)
            return
        doc["manifest_stripe"] = key
        self.store.put_manifest(doc["address"], doc)
        self._register(doc)

    @staticmethod
    def _validate_manifest(doc: dict) -> None:
        if not isinstance(doc, dict) or doc.get("version") != 1:
            raise ValueError("unsupported manifest version")
        if not re.match(r"^[0-9a-f]{8,128}$", str(doc.get("address", ""))):
            raise ValueError("bad manifest address")
        stripes = doc.get("stripes")
        if (
            not isinstance(stripes, list) or not stripes
            or not all(isinstance(s, str) for s in stripes)
        ):
            raise ValueError("bad manifest stripe list")
        size = doc.get("size")
        capacity = doc.get("stripe_bytes")
        k, n = doc.get("k"), doc.get("n")
        if not (isinstance(size, int) and size > 0):
            raise ValueError("bad manifest size")
        if not (isinstance(capacity, int) and capacity > 0):
            raise ValueError("bad manifest stripe_bytes")
        if len(stripes) != -(-size // capacity):
            raise ValueError("manifest stripe count disagrees with size")
        if not (isinstance(k, int) and isinstance(n, int) and 1 <= k <= n):
            raise ValueError("bad manifest geometry")
        if not isinstance(doc.get("tenant"), str) or not isinstance(
            doc.get("name"), str
        ):
            raise ValueError("bad manifest tenant/name")

    def _register(self, doc: dict) -> None:
        """Index one (validated) manifest; idempotent. A name re-pointed
        at a new address releases the old object locally (last-write-
        wins per node)."""
        addr = doc["address"]
        tenant, name = doc["tenant"], doc["name"]
        replaced: Optional[str] = None
        with self._lock:
            prev = self._index.get((tenant, name))
            if prev == addr and addr in self._known:
                return
            self._index[(tenant, name)] = addr
            if addr not in self._known:
                self._known.add(addr)
                used = self._usage.setdefault(tenant, [0, 0])
                used[0] += int(doc["size"])
                used[1] += 1
                tenant_bytes = used[0]
            else:
                tenant_bytes = self._usage.get(tenant, [0, 0])[0]
            if prev is not None and prev != addr:
                replaced = prev
        self._metrics.tenant_bytes(tenant, tenant_bytes)
        if replaced is not None:
            self._drop_address(replaced)

    def _reindex(self) -> None:
        cursor = None
        while True:
            page, cursor = self.store.list_manifests(cursor=cursor, limit=256)
            for _, doc in page:
                try:
                    self._validate_manifest(doc)
                except (ValueError, KeyError):
                    continue
                self._register(doc)
            if cursor is None:
                break

    # -------------------------------------------------------------- reads

    def resolve(self, tenant: str, name: str) -> dict:
        with self._lock:
            addr = self._index.get((tenant, name))
        if addr is None:
            raise UnknownObjectError(f"{tenant}/{name}")
        doc = self.store.get_manifest(addr)
        if doc is None:
            raise UnknownObjectError(f"{tenant}/{name}")
        return doc

    def get_range(
        self, tenant: str, name: str,
        start: int = 0, length: Optional[int] = None,
        *, shed: bool = True, peer_route: bool = True,
    ) -> tuple[dict, int, Iterator[bytes]]:
        """Resolve and stream one byte range: ``(manifest, range_length,
        chunk iterator)``. The range maps onto the minimal stripe set
        and each stripe is served from the cheapest surviving copy —
        decoded cache, local join, warm peer, degraded decode (module
        docstring; misses are single-flighted so concurrent readers of
        one cold stripe share a fetch). ``shed=False`` bypasses read
        admission (internal verification reads); ``peer_route=False``
        pins the read to local tiers (a peer serving a direct fetch
        must not hop again). The metrics for the read land when the
        iterator is exhausted."""
        try:
            doc = self.resolve(tenant, name)
        except UnknownObjectError:
            # Resolve-time misses raise before the streaming scope below
            # exists; replay through a short request scope so the tail
            # sampler keeps the trace (errors are always kept) — without
            # it the most common GET error class would be invisible.
            with request("get", tenant=tenant, name=name):
                raise
        address = doc["address"]
        size = int(doc["size"])
        capacity = int(doc["stripe_bytes"])
        if start < 0 or start > size:
            raise ValueError(f"range start {start} outside [0, {size}]")
        end = size if length is None else min(size, start + max(0, length))
        total = max(0, end - start)
        i0, i1 = start // capacity, -(-end // capacity)
        # Read admission (the PUT shed contract extended to reads): a
        # degraded node still serves its warm cache — those reads cost
        # RAM only — but refuses to enqueue NEW decode work. The cache
        # coverage check runs first so the hot path never pays the
        # verdict/HBM probe.
        if shed and not self._fully_cached(address, i0, i1):
            reason = self.shed_reason()
            if reason is not None:
                # Shed traces are always kept by the tail sampler: the
                # refusal raises through its own (short) request scope
                # when no outer one is active.
                with request("get", tenant=tenant, name=name):
                    self._metrics.shed(reason, tenant)
                    raise ShedError(reason, self.retry_after_seconds)
        # Per-request read state: served/cached stripe counts for the
        # result label, shared/degraded flags, the most expensive
        # serving tier touched (the per-tenant attribution route label),
        # and the lazily taken one-lock store snapshot of the request's
        # stripe set.
        state: dict = {
            "served": 0, "cached": 0, "degraded": False, "shared": False,
            "route": "cache", "snaps": None,
        }

        def chunks() -> Iterator[bytes]:
            # The request scope opens at first iteration (a built-but-
            # never-consumed iterator must not leak a held trace) and
            # closes when the stream ends — error, shed and abandonment
            # all propagate through it, so the tail sampler sees them.
            with request("get", tenant=tenant, name=name) as rscope, \
                    self._qos(tenant):
                t0 = time.monotonic()
                sent = 0
                result = "ok"
                with self._lock:
                    self._live_reads += 1
                try:
                    for i in range(i0, i1):
                        blob = self._read_stripe_tiered(
                            doc, i, i1, state, peer_route
                        )
                        logical = min(capacity, size - i * capacity)
                        lo = max(0, start - i * capacity)
                        hi = min(logical, end - i * capacity)
                        if lo == 0 and hi == logical == len(blob):
                            piece = blob  # whole-stripe serve: no copy
                        else:
                            piece = bytes(
                                memoryview(blob)[:logical][lo:hi]
                            )
                        sent += len(piece)
                        yield piece
                    if state["shared"]:
                        # The request rode another request's in-flight
                        # fetch; any degraded work was the leader's
                        # (which records it on its own request).
                        result = "coalesced"
                    elif state["degraded"]:
                        result = "degraded"
                    elif (
                        state["served"]
                        and state["cached"] == state["served"]
                    ):
                        result = "hit"
                except ObjectUnavailableError:
                    result = "unavailable"
                    raise
                except Exception:
                    result = "error"
                    raise
                finally:
                    with self._lock:
                        self._live_reads -= 1
                    self._metrics.get(result)
                    self._metrics.get_bytes.add(sent)
                    elapsed = time.monotonic() - t0
                    self._metrics.get_seconds.observe(elapsed)
                    self._metrics.op_seconds(
                        tenant, "get", state["route"], elapsed,
                        exemplar=rscope.exemplar,
                    )

        return doc, total, chunks()

    def read(
        self, tenant: str, name: str,
        *, shed: bool = True, peer_route: bool = True,
    ) -> bytes:
        """Whole-object convenience read (tests, small objects)."""
        _, _, chunks = self.get_range(
            tenant, name, shed=shed, peer_route=peer_route
        )
        return b"".join(chunks)

    def _fully_cached(self, address: str, i0: int, i1: int) -> bool:
        if self.cache is None:
            return False
        return all(self.cache.contains(address, i) for i in range(i0, i1))

    def _cache_store(
        self, address: str, i: int, blob: bytes, stripe_key: str
    ) -> None:
        if self.cache is not None:
            self.cache.put(address, i, blob, stripe_key=stripe_key)

    def _read_stripe_tiered(
        self, doc: dict, i: int, i1: int, state: dict, peer_route: bool
    ) -> bytes:
        """One stripe's logical payload through the tier order. The miss
        path rides the coalescer's single-flight tier keyed by
        (address, stripe index): a concurrent stampede on a cold stripe
        runs ONE fetch and broadcasts the bytes."""
        address = doc["address"]
        state["served"] += 1
        blob = (
            self.cache.get(address, i) if self.cache is not None else None
        )
        if blob is not None:
            state["cached"] += 1
            self._metrics.routes["cache"].add(1)
            return blob

        def fetch() -> tuple[bytes, str, bool, Optional[str]]:
            # The leader's trace id rides the flight result so a
            # coalesced follower can record a ``joined`` span pointing
            # at the trace that did the actual work.
            if self.cache is not None:
                hit = self.cache.peek(address, i)
                if hit is not None:
                    # Landed by another flight between this request's
                    # miss and its flight turn.
                    self._metrics.routes["cache"].add(1)
                    return hit, "cache", False, current_trace_id()
            blob, route, degraded = self._fetch_stripe(
                doc, i, i1, state, peer_route
            )
            return blob, route, degraded, current_trace_id()

        (blob, route, degraded, leader), shared = (
            coalescer().submit_shared(("objget", address, i), fetch)
        )
        if shared:
            with span("joined", stripe=i) as sp:
                if leader is not None:
                    sp.set_attr(leader=leader)
        if route == "cache":
            state["cached"] += 1
        if _ROUTE_RANK.get(route, 3) > _ROUTE_RANK[state["route"]]:
            state["route"] = route
        if shared:
            state["shared"] = True
        if degraded:
            state["degraded"] = True
        return blob

    def _fetch_stripe(
        self, doc: dict, i: int, i1: int, state: dict, peer_route: bool
    ) -> tuple[bytes, str, bool]:
        """The single-flight leader's miss path: local join ("local"
        route) when every data slot is trusted (a memcpy — the cheapest
        surviving copy after RAM), then a warm peer, then the degraded
        decode / anti-entropy tier. Returns ``(logical bytes, route,
        degraded)`` and write-through-populates the cache on every
        success."""
        address = doc["address"]
        key = doc["stripes"][i]
        size = int(doc["size"])
        capacity = int(doc["stripe_bytes"])
        logical = min(capacity, size - i * capacity)
        # ONE store-lock acquisition snapshots the request's remaining
        # stripe set (the per-stripe lock fix): the join fast path and
        # the degraded classification both work from it.
        with span("local_join", stripe=i) as lj:
            if state["snaps"] is None:
                state["snaps"] = self.store.snapshot_many(
                    doc["stripes"][i:i1]
                )
            snap = state["snaps"].get(key)
            if snap is not None:
                meta, shards, unverified = snap
                if all(
                    shards[j] is not None and j not in unverified
                    for j in range(meta.k)
                ):
                    blob = b"".join(
                        shards[: meta.k]
                    )[: meta.object_len][:logical]
                    self._cache_store(address, i, blob, key)
                    self._metrics.routes["local"].add(1)
                    lj.set_attr(outcome="hit", bytes=len(blob))
                    return blob, "local", False
            lj.set_attr(outcome="miss")
        if peer_route:
            blob = self._peer_fetch(doc, i, logical)
            if blob is not None:
                self._cache_store(address, i, blob, key)
                self._metrics.routes["peer"].add(1)
                return blob, "peer", False
        placement = getattr(self.plugin, "placement", None)
        if placement is not None:
            # Targeted placement scattered this stripe across its ring
            # owners, so no single node may hold k shards: gather them
            # (docs/placement.md). A refused or short gather falls
            # through to the decode/anti-entropy tier unchanged.
            padded = placement.gather(
                self.store, self.network, key,
                k=int(doc["k"]), n=int(doc["n"]),
                field=str(doc.get("field", "gf256")),
                code=str(doc.get("code", "rs")),
            )
            if padded is not None:
                blob = bytes(memoryview(padded)[:logical])
                self._cache_store(address, i, blob, key)
                self._metrics.routes["gather"].add(1)
                return blob, "gather", False
        with span("stripe_decode", stripe=i, stripe_key=key) as sd:
            padded, degraded = self._read_stripe(key)
            sd.set_attr(degraded=degraded, bytes=logical)
        blob = (
            padded if len(padded) == logical
            else bytes(memoryview(padded)[:logical])
        )
        self._cache_store(address, i, blob, key)
        self._metrics.routes["decode"].add(1)
        return blob, "decode", degraded

    def _peer_fetch(
        self, doc: dict, i: int, logical: int
    ) -> Optional[bytes]:
        """Fetch one stripe's logical bytes from the warm peers
        advertising the address (directory order: best-ranked first —
        freshest advert, lowest load hint), behind their breakers.
        Returns the bytes or None when no peer could serve.

        With hedging enabled and >= 2 allowed sources the HEDGED engine
        runs (``_peer_fetch_hedged``): the primary is raced by the next
        ranked peer once it straggles past its own clamped p95, the
        first complete response wins, and the losers are cancelled —
        their sockets closed and their threads unwound promptly, with
        every outcome accounted in the noise_ec_hedge_* counters.
        Otherwise the classic sequential ladder runs. Both paths keep
        the ETag contract: the peer must serve the SAME content address,
        so an overwrite landing mid-read can never mix versions."""
        address = doc["address"]
        peers = [
            endpoint
            for endpoint in self.directory.peers_for(address)
            if endpoint != self.advertise_url
            and self.directory.breaker(endpoint).allow()
        ]
        if not peers:
            return None
        if self.hedge_enabled and len(peers) >= 2:
            return self._peer_fetch_hedged(doc, i, logical, peers)
        return self._peer_fetch_serial(doc, i, logical, peers)

    def _peer_request(self, doc: dict, i: int, logical: int, hedged: bool):
        """Build the (urllib Request, address) pair for one stripe
        fetch attempt — shared by the serial and hedged paths."""
        from urllib.parse import quote
        from urllib.request import Request

        capacity = int(doc["stripe_bytes"])
        lo = i * capacity
        path = (
            f"/objects/{quote(doc['tenant'], safe='')}"
            f"/{quote(doc['name'], safe='')}"
        )
        headers = {
            "Range": f"bytes={lo}-{lo + logical - 1}",
            # One hop only: the serving peer reads local tiers.
            "X-NoiseEC-Route": "direct",
        }
        if hedged:
            # The serving peer stamps hedge=1 on its request scope, so
            # fleet-wide traces show which serving legs were races.
            headers["X-NoiseEC-Hedge"] = "1"
        trace_id = current_trace_id()
        if trace_id is not None:
            # Trace context propagation: the serving peer's request
            # scope adopts this id, so the collector merges its
            # local-tier spans into THIS request's fleet-wide trace.
            headers["X-NoiseEC-Trace"] = trace_id
        return lambda endpoint: Request(endpoint + path, headers=headers)

    def _peer_fetch_serial(
        self, doc: dict, i: int, logical: int, peers: list
    ) -> Optional[bytes]:
        """The pre-hedge sequential ladder (hedging disabled, or only
        one allowed source): try each peer in rank order."""
        from urllib.request import urlopen

        address = doc["address"]
        make_req = self._peer_request(doc, i, logical, hedged=False)
        for endpoint in peers:
            breaker = self.directory.breaker(endpoint)
            # One span per peer attempt — outcome + bytes per endpoint
            # is what makes a straggling or dead warm peer visible in
            # the trace's critical path.
            with span("peer_fetch", peer=endpoint, stripe=i) as sp:
                t0 = time.monotonic()
                try:
                    with urlopen(
                        make_req(endpoint),
                        timeout=self.peer_timeout_seconds,
                    ) as resp:
                        etag = (resp.headers.get("ETag") or "").strip('"')
                        if etag != address:
                            raise ValueError(
                                f"peer serves address {etag!r}, "
                                f"wanted {address!r}"
                            )
                        blob = resp.read(logical + 1)
                    if len(blob) != logical:
                        raise ValueError(
                            f"peer served {len(blob)} bytes, "
                            f"wanted {logical}"
                        )
                except Exception as exc:  # noqa: BLE001 — a dead cache
                    # peer degrades to the decode tier, never breaks
                    # the read
                    breaker.record_failure()
                    sp.set_attr(outcome="error", bytes=0)
                    log.debug("warm-peer fetch from %s failed: %s",
                              endpoint, exc)
                    continue
                breaker.record_success()
                self._metrics.peer_fetch_seconds(
                    endpoint, time.monotonic() - t0
                )
                sp.set_attr(outcome="ok", bytes=len(blob))
                return blob
        return None

    def _hedge_delay(self, endpoint: str) -> float:
        """How long the engine lets ``endpoint`` run before launching
        the next ranked source against it: that peer's rolling fetch
        p95, clamped to [floor, ceiling]; an unknown peer (distribution
        below HEDGE_MIN_COUNT) gets the ceiling — hedge late rather
        than double every fetch during warm-up."""
        p95 = self._metrics.peer_p95(endpoint)
        if p95 is None:
            return self.hedge_ceiling_seconds
        return min(
            self.hedge_ceiling_seconds,
            max(self.hedge_floor_seconds, p95),
        )

    def _peer_fetch_hedged(
        self, doc: dict, i: int, logical: int, peers: list
    ) -> Optional[bytes]:
        """The hedged fetch engine (see :meth:`_peer_fetch`). One
        coordinator thread (this one) launches ranked attempts and
        arbitrates; each attempt runs in its own short-lived thread.
        Decisions live under one condition variable:

        - the FIRST complete verified response is the winner; every
          other in-flight attempt is cancelled (its response socket
          closed out from under its read + a cancel flag it polls
          between chunks, so it unwinds within one chunk);
        - an attempt completing after the decision counts as LATE (its
          bytes are dropped but its breaker/latency accounting still
          lands — late responses are accounted, never leaked);
        - if every launched attempt fails fast, the next ranked source
          launches immediately (the sequential ladder's behavior);
        - the whole tier gives up at ``peer_timeout_seconds`` overall,
          cancelling whatever is still in flight, and returns None so
          the read degrades to the gather/decode tiers."""
        from urllib.request import urlopen

        address = doc["address"]
        make_req = self._peer_request(doc, i, logical, hedged=True)
        self._metrics.hedge_requests.add(1)
        cond = threading.Condition()
        state = {"winner": None, "decided": False, "live": 0}
        attempts: list[dict] = []
        trace_id = current_trace_id()

        def conclude(att: dict, outcome: str, blob, elapsed: float) -> str:
            """Land one attempt's result (worker thread). Returns the
            final outcome after arbitration (ok may become late). Only
            plain state mutates under the condition; breaker and metric
            calls land after release (lock-order hygiene)."""
            breaker = self.directory.breaker(att["endpoint"])
            with cond:
                att["live"] = False
                state["live"] -= 1
                if att["cancel"].is_set():
                    # The canceller already counted this attempt; its
                    # partial result is dropped whatever it was.
                    outcome = "cancelled"
                elif outcome == "ok":
                    if state["decided"]:
                        outcome = "late"
                    else:
                        state["winner"] = (att["rank"], blob)
                        state["winner_endpoint"] = att["endpoint"]
                        state["decided"] = True
                cond.notify_all()
            if outcome == "late":
                self._metrics.hedge_late.add(1)
                event("hedge.late", "warn", peer=att["endpoint"],
                      elapsed_ms=round(elapsed * 1e3, 3))
            if outcome in ("ok", "late"):
                breaker.record_success()
                self._metrics.peer_fetch_seconds(att["endpoint"], elapsed)
            elif outcome == "error":
                breaker.record_failure()
            return outcome

        def run(att: dict) -> None:
            endpoint = att["endpoint"]
            t0 = time.monotonic()
            # Joining the caller's request trace from this worker thread
            # re-uses the propagation path peers already take: same
            # trace id, non-owner scope, spans merge into the caller's
            # buffer.
            scope = (
                request("get", trace_id=trace_id)
                if trace_id is not None else _NULL_SCOPE
            )
            with scope:
                with span(
                    "peer_fetch", peer=endpoint, stripe=i,
                    hedge=att["rank"],
                ) as sp:
                    blob = None
                    outcome = "error"
                    try:
                        resp = urlopen(
                            make_req(endpoint),
                            timeout=self.peer_timeout_seconds,
                        )
                        with cond:
                            if att["cancel"].is_set():
                                resp.close()
                                raise _HedgeCancelled()
                            att["resp"] = resp
                        try:
                            etag = (
                                resp.headers.get("ETag") or ""
                            ).strip('"')
                            if etag != address:
                                raise ValueError(
                                    f"peer serves address {etag!r}, "
                                    f"wanted {address!r}"
                                )
                            parts: list[bytes] = []
                            got = 0
                            # Chunked reads so a cancelled attempt
                            # unwinds within one chunk even if the
                            # socket close raced the read.
                            while got < logical + 1:
                                if att["cancel"].is_set():
                                    raise _HedgeCancelled()
                                chunk = resp.read(
                                    min(1 << 16, logical + 1 - got)
                                )
                                if not chunk:
                                    break
                                got += len(chunk)
                                parts.append(chunk)
                        finally:
                            resp.close()
                        blob = b"".join(parts)
                        if len(blob) != logical:
                            raise ValueError(
                                f"peer served {len(blob)} bytes, "
                                f"wanted {logical}"
                            )
                        outcome = "ok"
                    except _HedgeCancelled:
                        outcome = "cancelled"
                    except Exception as exc:  # noqa: BLE001 — a loser
                        # or dead peer degrades, never breaks the read
                        outcome = "error"
                        log.debug(
                            "hedged fetch from %s failed: %s",
                            endpoint, exc,
                        )
                    outcome = conclude(
                        att, outcome, blob, time.monotonic() - t0
                    )
                    sp.set_attr(
                        outcome=outcome,
                        bytes=len(blob) if outcome == "ok" and blob
                        else 0,
                    )

        def launch(rank: int) -> dict:
            """Register + start one attempt. The thread starts OUTSIDE
            the condition (Thread.start() blocks on its own started-
            event; holding the engine lock across that handshake is a
            lock-order edge the lockgraph harness rejects)."""
            att = {
                "endpoint": peers[rank], "rank": rank,
                "cancel": threading.Event(), "resp": None, "live": True,
            }
            with cond:
                attempts.append(att)
                state["live"] += 1
            threading.Thread(
                target=run, args=(att,),
                name="noise-ec-hedge", daemon=True,
            ).start()
            return att

        deadline = time.monotonic() + self.peer_timeout_seconds
        launch(0)
        next_rank = 1
        hedge_at = time.monotonic() + self._hedge_delay(peers[0])
        while True:
            do_launch = False
            with cond:
                if state["winner"] is not None:
                    break
                now = time.monotonic()
                if now >= deadline:
                    break
                if state["live"] == 0 and next_rank >= len(peers):
                    break  # every source failed
                if next_rank < len(peers) and (
                    now >= hedge_at or state["live"] == 0
                ):
                    # Straggling primary (p95 elapsed) or fast failure:
                    # race/promote the next ranked source.
                    do_launch = True
                else:
                    wake = hedge_at if next_rank < len(peers) else deadline
                    cond.wait(max(0.0, min(wake, deadline) - now))
            if do_launch:
                att = launch(next_rank)
                next_rank += 1
                hedge_at = time.monotonic() + self._hedge_delay(
                    att["endpoint"]
                )
        # Decision point: whatever is still in flight loses. Close each
        # loser's response socket out from under its read — the
        # in-flight HTTP fetch aborts NOW, not at its timeout.
        losers: list = []
        with cond:
            state["decided"] = True  # any straggler is late from here
            for att in attempts:
                if att["live"] and not att["cancel"].is_set():
                    att["cancel"].set()
                    losers.append(att.get("resp"))
            winner = state["winner"]
        for resp in losers:
            if resp is not None:
                try:
                    resp.close()
                # noise-ec: allow(event-on-swallow) — loser response close race after hedge cancel; hedge.cancel event follows
                except Exception:  # noqa: BLE001
                    pass
        if losers:
            self._metrics.hedge_cancelled.add(len(losers))
            event("hedge.cancel", losers=len(losers))
        if winner is None:
            return None
        rank, blob = winner
        if rank > 0:
            self._metrics.hedge_wins.add(1)
            event("hedge.win", peer=state.get("winner_endpoint"),
                  rank=rank)
        return blob

    def _read_stripe(self, key: str) -> tuple[bytes, bool]:
        """One stripe's (padded) bytes + whether the read was degraded
        (any of the k data slots untrusted, forcing a reconstruct)."""
        try:
            status = self.store.status(key)
        except UnknownStripeError:
            raise ObjectUnavailableError(
                f"stripe {key} is not held by this node (no metadata to "
                "anchor an anti-entropy fetch)"
            )
        degraded = not all(
            i in status["trusted"] for i in range(status["k"])
        )
        try:
            return self.store.read(key), degraded
        except DegradedReadError:
            pass
        if self.engine is None:
            raise ObjectUnavailableError(
                f"stripe {key} has fewer than k trusted shards and no "
                "repair engine is wired"
            )
        # Below k locally: ask the fleet (anti-entropy) and wait a
        # bounded time for absorbs to lift the stripe back over k.
        self.engine.enqueue(key, "fetch")
        deadline = time.monotonic() + self.fetch_timeout_seconds
        while time.monotonic() < deadline:
            if getattr(self.engine, "_thread", None) is None:
                # No background worker: drive the queue ourselves so a
                # test/deterministic deployment still fetches.
                self.engine.drain_once()
            time.sleep(0.05)
            try:
                return self.store.read(key), True
            except DegradedReadError:
                continue
        raise ObjectUnavailableError(
            f"stripe {key}: below k trusted shards and anti-entropy did "
            f"not heal within {self.fetch_timeout_seconds:g}s"
        )

    # -------------------------------------------------------------- list

    def list_objects(
        self, tenant: str, *, cursor: Optional[str] = None, limit: int = 64
    ) -> tuple[list[dict], Optional[str]]:
        """One page of the tenant's objects in address order:
        ``(entries, next_cursor)`` — built on the store's cursored
        manifest walk, so a large namespace never snapshots whole."""
        out: list[dict] = []
        while len(out) < limit:
            page, cursor = self.store.list_manifests(
                cursor=cursor, limit=max(limit, 64)
            )
            for addr, doc in page:
                if doc.get("tenant") != tenant:
                    continue
                out.append({
                    "name": doc.get("name"),
                    "address": addr,
                    "size": doc.get("size"),
                    "created": doc.get("created"),
                })
                if len(out) >= limit:
                    return out, addr
            if cursor is None:
                return out, None
        return out, cursor

    # ------------------------------------------------------------ delete

    def delete(self, tenant: str, name: str) -> None:
        """Drop the manifest, release the quota, and evict stripes no
        other manifest references. Local-only: replicas keep their
        copies (v1 — see module docstring)."""
        with request("delete", tenant=tenant, name=name):
            doc = self.resolve(tenant, name)
            addr = doc["address"]
            with self._lock:
                self._index.pop((tenant, name), None)
            self._drop_address(addr)
            self._metrics.delete(tenant)

    def _drop_address(self, addr: str) -> None:
        # Invalidation-by-address: DELETE and overwrite-PUT both land
        # here (locally AND on every replica through the manifest absorb
        # path), and the cache key IS the address — one eviction call is
        # the whole coherence story.
        if self.cache is not None:
            self.cache.evict_address(addr)
        doc = self.store.get_manifest(addr)
        if doc is None:
            return
        tenant = doc.get("tenant", "")
        self.store.delete_manifest(addr)
        with self._lock:
            if addr in self._known:
                self._known.discard(addr)
                used = self._usage.setdefault(tenant, [0, 0])
                used[0] = max(0, used[0] - int(doc.get("size", 0)))
                used[1] = max(0, used[1] - 1)
                tenant_bytes = used[0]
            else:
                tenant_bytes = self._usage.get(tenant, [0, 0])[0]
        self._metrics.tenant_bytes(tenant, tenant_bytes)
        # Reference-count stripes across the surviving manifests before
        # evicting (identical content shares stripes by construction —
        # the key is the signature prefix of identical bytes).
        refs: set[str] = set()
        cursor = None
        while True:
            page, cursor = self.store.list_manifests(cursor=cursor, limit=256)
            for _, other in page:
                refs.update(other.get("stripes") or ())
                ms = other.get("manifest_stripe")
                if ms:
                    refs.add(ms)
            if cursor is None:
                break
        doomed = [
            key for key in dict.fromkeys(
                list(doc.get("stripes") or ())
                + ([doc["manifest_stripe"]] if doc.get("manifest_stripe")
                   else [])
            )
            if key not in refs
        ]
        for key in doomed:
            self.store.evict(key)
        if doomed and self.engine is not None:
            self.engine.unpin_announce(doomed)
