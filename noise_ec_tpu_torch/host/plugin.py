"""The shard plugin: encode/broadcast pipeline and receive state machine.

This is the reference's L4 (``ShardPlugin``, main.go:43-115, 201-241),
ported from ``noise_ec_tpu.host.plugin`` onto the port's codec: every
codec the plugin builds runs on ``device`` ("cuda" unless the caller asks
for "cpu") on the ``device`` backend (K5 on the baked route at the node's
geometries, through ``FEC`` and the object stream's
``StreamingEncoder``), and the ``numpy`` backend's stream encode runs on
the port's native shim, which raises when it cannot be built (the
reference drops to ``FEC``). The observable contract is preserved —

- every outgoing message is signed over the ``serialize_message`` preimage
  and the signature rides in each ``Shard.file_signature`` (main.go:219-223,
  228-239);
- the RS geometry (k, n) rides in every shard and the receiver always uses
  the arriving message's geometry, never its own defaults (main.go:73);
- when an input length is not divisible by k, the sender adjusts geometry
  instead of padding: k := largest prime factor of the length, n += k
  (main.go:185-191, reproduced bug-for-bug by the default policy);

— while the internal pool defects are fixed (see host.mempool).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Protocol

from noise_ec_tpu_torch.codec.fec import FEC, Share
from noise_ec_tpu_torch.host.crypto import (
    Blake2bPolicy,
    Ed25519Policy,
    KeyPair,
    PeerID,
    serialize_message,
    serialize_message_parts,
    verify,
    verify_parts,
)
from noise_ec_tpu_torch.host.mempool import PoolLimitError, PoolTooLargeError, ShardPool
from noise_ec_tpu_torch.host.wire import Shard
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.health import SLOEvaluator, record_e2e
from noise_ec_tpu_torch.obs.metrics import Counters, Timer
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import current_trace_id, span, trace_key


def _request_attrs(ctx=None) -> dict:
    """``{"request_trace": <id>}`` when the work runs inside a traced
    user request — on the send path read from the thread-local request
    scope, on the receive path from the delivery ``Ctx`` (the SHARD_BATCH
    frame's propagated trace block). The attr is what lets a collector
    merge signature-keyed pipeline spans into the originating request's
    fleet-wide trace; ``{}`` keeps untraced spans byte-identical."""
    rt = getattr(ctx, "trace", None) if ctx is not None else current_trace_id()
    return {"request_trace": rt} if rt else {}

__all__ = [
    "ShardPlugin",
    "PluginContext",
    "CorruptionError",
    "largest_prime_factor",
    "DEFAULT_MINIMUM_NEEDED_SHARDS",
    "DEFAULT_TOTAL_SHARDS",
]

log = logging.getLogger("noise_ec_tpu_torch.host")

# Reference defaults: RS(k=4, n=6), two parity shards (main.go:34-35).
DEFAULT_MINIMUM_NEEDED_SHARDS = 4
DEFAULT_TOTAL_SHARDS = 6


class CorruptionError(RuntimeError):
    """All n shards arrived and the signature still does not verify — the
    message cannot be recovered (the reference's intended hard-failure
    branch, main.go:96-98; unreachable there, reachable here because the
    pool keeps accepting shares after a failed verify)."""


def largest_prime_factor(n: int) -> int:
    """Largest prime factor of ``n``; -1 for n <= 1.

    Mirrors ``largestPrimeFactors`` (main.go:303-335, trial division to
    sqrt) including its unguarded n <= 1 edge returning -1.
    """
    if n <= 1:
        return -1
    largest = -1
    while n % 2 == 0:
        largest = 2
        n //= 2
    p = 3
    while p * p <= n:
        while n % p == 0:
            largest = p
            n //= p
        p += 2
    if n > 1:
        largest = n
    return largest


class PluginContext(Protocol):
    """What the transport hands to ``receive`` — the slice of noise's
    ``network.PluginContext`` the reference uses (main.go:53-87)."""

    def message(self) -> object: ...
    def sender(self) -> PeerID: ...
    def client_public_key(self) -> bytes: ...


class ShardPlugin:
    """Erasure-shard broadcast/reassembly plugin.

    Construction mirrors ``NewShardPlugin`` (main.go:108-115): signature
    and hash policies plus the default RS geometry are injected; per-message
    geometry still rides the wire and wins on receive.
    """

    def __init__(
        self,
        signature_policy: Optional[Ed25519Policy] = None,
        hash_policy: Optional[Blake2bPolicy] = None,
        minimum_needed_shards: int = DEFAULT_MINIMUM_NEEDED_SHARDS,
        total_shards: int = DEFAULT_TOTAL_SHARDS,
        *,
        backend: str = "device",
        device: str = "cuda",
        on_message: Optional[Callable[[bytes, PeerID], None]] = None,
        on_object: Optional[Callable[[bytearray, PeerID], None]] = None,
        pool_ttl_seconds: Optional[float] = ShardPool.DEFAULT_TTL_SECONDS,
        pool_max_pools: int = ShardPool.DEFAULT_MAX_POOLS,
        pool_max_total_bytes: int = ShardPool.DEFAULT_MAX_TOTAL_BYTES,
        adjust_geometry: bool = True,
        store=None,
        slo: Optional[SLOEvaluator] = None,
    ):
        self.signature_policy = signature_policy or Ed25519Policy()
        self.hash_policy = hash_policy or Blake2bPolicy()
        self.minimum_needed_shards = minimum_needed_shards
        self.total_shards = total_shards
        self.backend = backend
        # Where every device-backend codec of this plugin runs.
        self.device = device
        self.on_message = on_message
        # Zero-copy delivery for STREAM objects: receives the verified
        # reassembly buffer itself (a bytearray whose ownership transfers
        # to the callee — the plugin drops every reference first). The
        # reference's Go plugin hands its decode output []byte to the
        # logger without a copy (main.go:92); on_message's immutable-bytes
        # contract forces a whole-object copy per delivery, which on
        # multi-hundred-MB/s streams is a measurable tax. When set it
        # takes precedence over on_message for stream objects; single
        # messages always use on_message.
        self.on_object = on_object
        self.adjust_geometry = adjust_geometry
        # Optional stripe store (store.StripeStore): verified receives
        # land in it as full stripes, and every arriving shard is offered
        # to it first — a shard for a stripe we already hold is absorbed
        # (or matched as a duplicate) there instead of re-walking the
        # pool/decode/verify path, which is what makes the repair
        # engine's anti-entropy exchange ride the plain SHARD opcode.
        self.store = store
        # Optional placement policy (placement.TargetedDelivery): when
        # wired, targeted sends consult the ring and the receive path
        # store-absorbs shards whose assigned failure domain is ours —
        # additively, never consuming, so broadcast semantics (chat,
        # manifests) are untouched. None = pure broadcast, the default.
        self.placement = None
        self.pool = ShardPool(
            ttl_seconds=pool_ttl_seconds,
            max_pools=pool_max_pools,
            max_total_bytes=pool_max_total_bytes,
        )
        self.counters = Counters()
        # End-to-end outcome events (obs/health.py): every completed or
        # failed object records into noise_ec_e2e_latency_seconds and an
        # SLO evaluator. None routes to the process default (the one the
        # CLI wires to /healthz); tests pass their own.
        self.slo = slo
        # Decode-path histograms (p50/p99 surfaces — the flat decode_s
        # sum stays for back-compat but cannot answer tail questions).
        # Children resolved once; observe is a lock + bisect + adds.
        reg = default_registry()
        self._decode_hist = reg.histogram("noise_ec_decode_seconds").labels()
        self._decode_bytes_hist = reg.histogram("noise_ec_decode_bytes").labels()
        # Geometry is runtime-dynamic (SURVEY.md §7.4); cache one codec per
        # (k, n) so repeated geometries reuse their planned matrices. LRU-
        # bounded: geometry is attacker-influenced on the receive path, and
        # each FEC holds generator matrices + device plans.
        self._fec_cache: OrderedDict[tuple[int, int], FEC] = OrderedDict()
        self._fec_lock = threading.Lock()
        self.fec_cache_size = 64
        # GF(2^8) bound: n distinct evaluation points cap total shards at
        # the field order (rs.py enforces the same on construction).
        self.max_total_shards = 256
        # Duplicate-delivery suppression: signatures of recently completed
        # objects with their completion time. Shards still in flight after
        # a decode+evict can re-accumulate to k distinct and deliver the
        # message again (the reference re-logs in that case). Suppression
        # is WINDOWED, not permanent: the signature is deterministic
        # (Ed25519 over a nonce-free preimage), so an identical message
        # legitimately re-broadcast later produces the same signature — a
        # permanent cache would swallow it. Within the window: exactly
        # once; beyond it: at-least-once, like the reference.
        # The window is a tradeoff, kept SHORT: a user legitimately
        # re-broadcasting the identical plaintext within the window loses
        # the repeat (indistinguishable on the wire from the first
        # broadcast's stragglers). 5s covers in-flight shard tails without
        # noticeably shadowing interactive repeats; 0 disables dedup.
        self._completed: OrderedDict[str, float] = OrderedDict()
        self._completed_lock = threading.Lock()
        self.completed_cache_size = 4096
        self.dedup_window_seconds = 5.0
        # Guards the (minimum_needed_shards, total_shards) read-modify-write
        # in _adjusted_geometry: concurrent prepare_shards calls must not
        # tear the geometry or skip the max_total_shards validation.
        self._geometry_lock = threading.Lock()
        # Stream reassembly state (see _receive_stream) — initialized here,
        # not lazily: concurrent first stream shards must share one lock
        # and one table, and operator-configured caps must survive.
        self._streams: OrderedDict[str, dict] = OrderedDict()
        self._streams_lock = threading.Lock()
        self.max_stream_object_bytes = self.DEFAULT_MAX_STREAM_OBJECT_BYTES
        self.max_stream_objects = self.DEFAULT_MAX_STREAM_OBJECTS
        self.max_stream_total_bytes = self.DEFAULT_MAX_STREAM_TOTAL_BYTES
        self.max_stream_chunks = self.DEFAULT_MAX_STREAM_CHUNKS
        self._stream_buf_bytes = 0  # sum of active reassembly buffers
        self._shim_cache: dict[tuple[int, int], object] = {}
        # Novel-geometry rate limiter state (see _fec_receive) + the
        # host-only fallback codec cache for rate-limited senders.
        self._novel_geometry: OrderedDict[bytes, list] = OrderedDict()
        # Admission lifecycle: _fec_receive puts a granted novel geometry
        # into _novel_pending; the decode sites move it to _novel_inflight
        # for exactly the duration of the first decode (where the geometry's
        # matrices are planned) and clear it in their finally. Only INFLIGHT
        # entries count against NOVEL_COMPILES_INFLIGHT_MAX, so stray
        # shards that never assemble to k cannot pin the admission budget.
        self._novel_pending: dict[tuple, float] = {}
        self._novel_inflight: dict[tuple, float] = {}
        # Admission timestamps for the global window backstop.
        self._novel_global: list = []
        self._novel_lock = threading.Lock()
        self._fec_host_cache: OrderedDict[tuple[int, int], FEC] = OrderedDict()
        # NACK live shard repair (docs/resilience.md): a pool stuck with
        # 0 < have < k distinct shards past the grace timeout re-sends
        # its held shards — the anti-entropy interest framing, over
        # the plain SHARD opcode — first directly to the original sender
        # (transport ``send_to``), then broadcast to peers; a peer (or
        # the sender) storing the stripe answers with its trusted
        # shards, which complete the pool through the ordinary receive
        # path. Retries back off exponentially (capped); exhausting the
        # budget records an ``outcome=incomplete`` e2e event.
        # ``nack_grace_seconds = 0`` disables. The sweeper thread starts
        # on the first stuck pool and exits when none remain.
        self.nack_grace_seconds = 1.0
        self.nack_max_retries = 4
        self.nack_backoff_base = 0.5
        self.nack_backoff_cap = 8.0
        self._nack_lock = threading.Lock()
        self._nack: OrderedDict[str, dict] = {}
        self._nack_thread: Optional[threading.Thread] = None
        self._network = lambda: None  # weakref to the attached transport
        self._nack_requests = reg.counter(
            "noise_ec_nack_requests_total"
        ).labels()
        self._nack_repaired = reg.counter(
            "noise_ec_nack_repaired_total"
        ).labels()
        self._nack_giveups = reg.counter(
            "noise_ec_nack_giveups_total"
        ).labels()

    def attach_network(self, network) -> None:
        """Give the receive path a transport handle for NACK repair
        (transports call this from ``add_plugin``; weakly held so a
        plugin can never pin a closed network)."""
        self._network = weakref.ref(network)

    # ---------------------------------------------------------------- codec

    def _fec(self, k: int, n: int) -> FEC:
        # Locked: receive() runs on the transport thread while
        # prepare_shards() runs on the caller's, and LRU mutation
        # (move_to_end / popitem) is not safe to interleave.
        with self._fec_lock:
            fec = self._fec_cache.get((k, n))
            if fec is not None:
                self._fec_cache.move_to_end((k, n))
                return fec
        # build outside the lock
        fec = FEC(k, n, backend=self.backend, device=self.device)
        return self._cache_put_locked(self._fec_cache, (k, n), fec)

    # Per-sender novel-geometry budget on the RECEIVE path: geometry rides
    # in every message (main.go:73), and on the device backend the first
    # use of a fresh (k, n) plans its matrices (K5's operand, the decode
    # plans: 0.010-0.014 s at RS(50,20) on the H100, more for the wide
    # routes) and holds them in the codec cache. Without a cap one hostile
    # sender minting fresh geometries keeps a dispatch worker perpetually
    # planning and churns the cache. Within the window a sender gets this
    # many novel geometries on the full backend; beyond it, decodes go to
    # a host-only codec (numpy/shim — correct, nothing planned on the
    # card) until a geometry recurs or the window rolls. That is decided
    # before any product runs, counted in ``geometry_rate_limited``, and
    # never taken by a geometry already admitted: the reference's defence
    # against a geometry flood, not a device fallback.
    NOVEL_GEOMETRY_WINDOW_SECONDS = 60.0
    NOVEL_GEOMETRY_PER_WINDOW = 8
    # Aggregate control across ALL senders (identities are cheap to mint,
    # so the per-sender budget alone is bypassed by key rotation) — TWO
    # mechanisms, primary + backstop. Primary: a cap on first decodes IN
    # FLIGHT (admissions whose first full-backend decode has not
    # completed), so bystanders fall to the host codec only while the
    # planning pipeline is actually saturated; slots free as each first
    # decode lands, or after the grace timeout when one never does. A
    # tight global window count instead would let one key-rotating
    # flooder demote every bystander for a full window.
    NOVEL_COMPILES_INFLIGHT_MAX = 2
    NOVEL_COMPILE_GRACE_SECONDS = 60.0
    # Backstop: a LOOSE window ceiling on total admissions. The in-flight
    # cap alone bounds concurrency, not total work — a flooder whose
    # geometries plan fast could keep both slots perpetually owned and
    # churn the codec LRU. This ceiling bounds plans + cache insertions
    # per window. Deliberately HIGH: any window ceiling
    # demotes bystanders once exhausted — an inherent tension under
    # identity rotation (attacker and bystander are indistinguishable) —
    # so it should engage only under a genuinely heavy flood, with the
    # in-flight cap doing the everyday work.
    NOVEL_GEOMETRY_GLOBAL_PER_WINDOW = 64

    @staticmethod
    def _sender_key(ctx: PluginContext) -> bytes:
        try:
            return bytes(ctx.client_public_key())
        # noise-ec: allow(event-on-swallow) — identity-less test transports — empty identity is the contract
        except Exception:  # noqa: BLE001 — identity-less test transports
            return b""

    def _cache_put_locked(self, cache, key, fec: FEC) -> FEC:
        """LRU insert-or-get under self._fec_lock (shared by both codec
        caches so the eviction policy cannot diverge)."""
        with self._fec_lock:
            cache.setdefault(key, fec)
            cache.move_to_end(key)
            while len(cache) > self.fec_cache_size:
                cache.popitem(last=False)
            return cache[key]

    def _fec_receive(self, k: int, n: int, ctx: PluginContext) -> FEC:
        """Receive-path codec lookup with the novel-geometry rate caps
        (per sender AND global). Cached geometries (the steady state:
        senders reuse their geometry) bypass the limiter entirely."""
        with self._fec_lock:
            fec = self._fec_cache.get((k, n))
            if fec is not None:
                self._fec_cache.move_to_end((k, n))
                return fec
        if self.backend == "numpy":
            return self._fec(k, n)  # nothing planned on a card to protect
        sender_key = self._sender_key(ctx)
        now = time.monotonic()
        cutoff = now - self.NOVEL_GEOMETRY_WINDOW_SECONDS
        with self._novel_lock:
            dq = self._novel_geometry.get(sender_key)
            if dq is None:
                dq = self._novel_geometry[sender_key] = []
                # Bound the tracking table itself.
                while len(self._novel_geometry) > 1024:
                    self._novel_geometry.pop(
                        next(iter(self._novel_geometry))
                    )
            else:
                self._novel_geometry.move_to_end(sender_key)
            while dq and dq[0] < cutoff:
                dq.pop(0)
            # Release in-flight slots whose first decode never completed
            # (connection died mid-object, decode raised): the planning is
            # over by the grace deadline either way.
            stale = now - self.NOVEL_COMPILE_GRACE_SECONDS
            for g in [g for g, t0 in self._novel_inflight.items() if t0 < stale]:
                del self._novel_inflight[g]
            for g in [g for g, t0 in self._novel_pending.items() if t0 < cutoff]:
                del self._novel_pending[g]
            while self._novel_global and self._novel_global[0] < cutoff:
                self._novel_global.pop(0)
            limited = (
                len(dq) >= self.NOVEL_GEOMETRY_PER_WINDOW
                or len(self._novel_inflight)
                >= self.NOVEL_COMPILES_INFLIGHT_MAX
                or len(self._novel_global)
                >= self.NOVEL_GEOMETRY_GLOBAL_PER_WINDOW
            )
            if not limited:
                dq.append(now)
                self._novel_pending[(k, n)] = now
                self._novel_global.append(now)
        if not limited:
            return self._fec(k, n)
        self.counters.add("geometry_rate_limited", 1)
        with self._fec_lock:
            fec = self._fec_host_cache.get((k, n))
            if fec is not None:
                self._fec_host_cache.move_to_end((k, n))
                return fec
        return self._cache_put_locked(
            self._fec_host_cache, (k, n), FEC(k, n, backend="numpy")
        )

    def _geometry_decode_begin(self, k: int, n: int) -> None:
        """Admitted geometry's first decode is starting: occupy an
        in-flight slot for its duration (see _novel_pending)."""
        with self._novel_lock:
            if self._novel_pending.pop((k, n), None) is not None:
                self._novel_inflight[(k, n)] = time.monotonic()

    def _geometry_ready(self, k: int, n: int) -> None:
        """Release the in-flight slot for (k, n): its first full-backend
        decode finished (either way — the planning is over), so the
        geometry no longer occupies the global admission budget."""
        with self._novel_lock:
            self._novel_inflight.pop((k, n), None)
            self._novel_pending.pop((k, n), None)

    def prewarm(self, geometries=None, stripe_len: int = 64,
                ladder: int = 0) -> None:
        """Build and warm codecs for ``geometries`` before traffic.

        First use of a novel (k, n) constructs the FEC and, on the device
        backend, plans its matrices — latency that would otherwise land
        on the dispatch path of whichever peer sends that geometry first.
        Call at startup with the geometries you expect; defaults to this
        plugin's own (k, n).

        ``ladder > 1`` (the CLI's ``-compile-cache-dir``) additionally
        plans the geometry's parity matrix and the recovery matrix of
        each single lost data share with ``DeviceCodec.plan_for`` and
        runs one batched parity product at each power-of-two batch size
        up to ``ladder``, so the first live call of each finds its plans
        cached (the reference compiles its batch-ladder programs here).
        """
        if geometries is None:  # explicit [] means: warm nothing
            geometries = [(self.minimum_needed_shards, self.total_shards)]
        for k, n in geometries:
            fec = self._fec(k, n)
            shares = fec.encode_shares(bytes(k * stripe_len))  # content is irrelevant
            fec.decode(shares[:k])
            dev = fec._rs._dev
            if ladder > 1 and dev is not None:
                from noise_ec_tpu_torch.ops.dispatch import prewarm_ladder

                prewarm_ladder(dev, fec._rs.G, k, max_batch=ladder,
                               stripe_bytes=stripe_len)

    def _recently_completed(self, key: str) -> bool:
        """True iff ``key`` completed within the dedup window. Lazily drops
        expired entries."""
        with self._completed_lock:
            done_at = self._completed.get(key)
            if done_at is None:
                return False
            if time.monotonic() - done_at >= self.dedup_window_seconds:
                del self._completed[key]
                return False
            return True

    def _mark_completed(self, key: str) -> bool:
        """Record completion; returns False if another thread won the race
        (caller must not deliver again)."""
        with self._completed_lock:
            if key in self._completed:
                return False
            self._completed[key] = time.monotonic()
            while len(self._completed) > self.completed_cache_size:
                self._completed.popitem(last=False)
            return True

    # ----------------------------------------------------------- send path

    def shard_and_broadcast(
        self, network, input_bytes: bytes,
        *, geometry: Optional[tuple[int, int]] = None,
        targeted: bool = False,
    ) -> list[Shard]:
        """Encode ``input_bytes`` and broadcast one message per shard to all
        peers (main.go:201-210). Returns the shards for callers that want
        them (the reference discards them). ``geometry`` pins an explicit
        (k, n) instead of the plugin's mutable default — the object
        service's per-namespace geometry rides this.

        ``targeted`` opts the cohort into ring-directed placement
        (docs/placement.md): when a :class:`TargetedDelivery` policy is
        wired (``self.placement``), each shard goes ONLY to its assigned
        owner — one SHARD_BATCH cohort frame per destination peer,
        peers× wire fan-out cut to n×. Only the object service's data
        stripes pass ``targeted=True``; chat and manifest broadcasts
        stay full-fan-out so every node can index and the REPL is
        unchanged. With no placement policy (or a transport without the
        directed surface) the call is byte-identical to the broadcast
        path."""
        shards = self.prepare_shards(
            network.id, network.keys, input_bytes, geometry=geometry
        )
        # The origin keeps its own object too: anti-entropy repair
        # (store/repair.py) can then serve any peer that rots, and the
        # sender's stripe is the fleet's ground-truth copy.
        self._store_put_raw(
            shards[0].file_signature, input_bytes,
            int(shards[0].minimum_needed_shards),
            int(shards[0].total_shards),
            network.id.address, bytes(network.keys.public_key),
        )
        with span(
            "broadcast",
            key=trace_key(shards[0].file_signature),
            shards=len(shards),
            **_request_attrs(),
        ):
            placed = None
            if targeted and self.placement is not None:
                placed = self.placement.send(network, shards)
            if placed is None:
                # One cohort call: the TCP transport coalesces the whole
                # broadcast into a single SHARD_BATCH frame per peer
                # flush (one signature, one verify, one sendmsg —
                # design.md §15); transports without the hook keep
                # per-shard semantics.
                many = getattr(network, "broadcast_many", None)
                if many is not None:
                    many(shards)
                else:
                    for shard in shards:
                        network.broadcast(shard)
        self.counters.add("shards_out", len(shards))
        self.counters.add("bytes_out", sum(len(s.shard_data) for s in shards))
        return shards

    def prepare_shards(
        self, node_id: PeerID, keys: KeyPair, input_bytes: bytes,
        *, geometry: Optional[tuple[int, int]] = None,
    ) -> list[Shard]:
        """Sign the plaintext, split it into shares, wrap each in a wire
        ``Shard`` (main.go:211-241).

        The reference shadows and never checks the ``Sign`` error
        (main.go:219, noted in SURVEY.md C8); here a signing failure
        propagates. An explicit ``geometry`` bypasses the reference's
        mutable adjusted-geometry dance entirely: the caller promises a
        payload length divisible by k (the object service pads its
        stripes) and the plugin state is never touched.
        """
        if not input_bytes:
            raise ValueError("cannot prepare shards for empty input")  # main.go:215-217
        with span("prepare", nbytes=len(input_bytes),
                  **_request_attrs()) as psp:
            if geometry is not None:
                k, n = geometry
                if not 1 <= k <= n <= self.max_total_shards:
                    raise ValueError(
                        f"invalid explicit geometry k={k} n={n}"
                    )
                if len(input_bytes) % k:
                    raise ValueError(
                        f"input length {len(input_bytes)} is not a "
                        f"multiple of k={k} (explicit geometry does not "
                        "adjust; pad the payload)"
                    )
            else:
                k, n = self._adjusted_geometry(len(input_bytes))
            # The trace key IS the signature prefix, so the sign span
            # attaches it from inside (known only after signing) and the
            # enclosing prepare span adopts it before its own exit.
            with span("sign") as ssp:
                file_signature = keys.sign(
                    self.signature_policy,
                    self.hash_policy,
                    serialize_message(node_id, input_bytes),
                )
                ssp.set_key(trace_key(file_signature))
            psp.set_key(trace_key(file_signature))
            with span("encode", k=k, n=n):
                shares = self._fec(k, n).encode_shares(input_bytes)
        return [
            Shard(
                file_signature=file_signature,
                shard_data=s.data,
                shard_number=s.number,
                total_shards=n,
                minimum_needed_shards=k,
            )
            for s in shares
        ]

    def _adjusted_geometry(self, length: int) -> tuple[int, int]:
        """Dynamic geometry adjustment (main.go:185-191), reproduced
        bug-for-bug: when the length is not divisible by k, k becomes the
        largest prime factor of the length (so a prime-length message
        degenerates to k = length, 1-byte stripes) and n *accumulates* —
        ``n += k`` mutates plugin state, so n only ever grows over the
        process lifetime. Interop is unaffected either way because geometry
        rides in every shard; pass ``adjust_geometry=False`` to refuse
        (raise) instead."""
        with self._geometry_lock:
            k, n = self.minimum_needed_shards, self.total_shards
            if length % k == 0:
                return k, n
            if not self.adjust_geometry:
                raise ValueError(
                    f"input length {length} is not a multiple of k={k} "
                    "and geometry adjustment is disabled"
                )
            k = largest_prime_factor(length)
            if k < 1:
                raise ValueError(f"cannot shard {length}-byte input")
            # Validate BEFORE mutating plugin state: an over-field geometry
            # must not brick every subsequent send (the reference would panic
            # inside infectious here; we reject and keep the old geometry).
            if n + k > self.max_total_shards:
                raise ValueError(
                    f"adjusted geometry k={k} n={n + k} exceeds the GF(2^8) "
                    f"limit of {self.max_total_shards} total shards; message "
                    f"length {length} cannot be sharded with accumulated n={n}"
                )
            self.minimum_needed_shards = k
            self.total_shards = n + k
            log.info(
                "revised geometry: minimum_needed_shards=%d total_shards=%d",
                self.minimum_needed_shards,
                self.total_shards,
            )
            return self.minimum_needed_shards, self.total_shards

    # ---------------------------------------------------- streaming objects

    # Caps for the stream reassembly state (attacker-influenced sizes ride
    # in every stream shard, so all are validated before allocation):
    # per-object bytes, objects in flight, TOTAL reassembly-buffer bytes
    # across objects (a forged tiny shard pins a whole object's buffer,
    # so per-object x objects alone would multiply), and chunk count
    # (teardown/repair loops iterate it).
    DEFAULT_MAX_STREAM_OBJECT_BYTES = 1 << 30
    DEFAULT_MAX_STREAM_OBJECTS = 8
    DEFAULT_MAX_STREAM_TOTAL_BYTES = 1 << 30
    DEFAULT_MAX_STREAM_CHUNKS = 4096
    STREAM_TTL_SECONDS = 120.0

    def stream_and_broadcast(
        self,
        network,
        data: bytes,
        *,
        chunk_bytes: int = 4 << 20,
        geometry: Optional[tuple[int, int]] = None,
    ) -> int:
        """Broadcast a large object as a stream of erasure-coded chunks.

        The reference's node pushes whole stdin lines through one codec
        call (main.go:201-210); objects far beyond one codeword need the
        streaming shape instead (SURVEY.md §5 "long-context" row): the
        object is signed ONCE (same ``serialize_message`` preimage as a
        plain broadcast), split into fixed-capacity chunks, each chunk
        encoded as an independent RS(k, n) codeword — on the device
        backend through the pipelined ``StreamingEncoder``, so chunk i+1
        transfers while chunk i computes — and every share travels as a
        wire ``Shard`` carrying (chunk_index, chunk_count, object_bytes)
        in the streaming extension fields (wire.py fields 6-8).

        Chunk loss is repaired per chunk by the parity shares; corruption
        surfaces at the object-level signature verify on the receiver,
        exactly the reference's trust model (main.go:82-99). Returns the
        number of chunks sent.
        """
        if not data:
            raise ValueError("cannot stream an empty object")
        k, n, B, count = self._stream_plan(len(data), chunk_bytes, geometry)
        # Same preimage as a plain broadcast (serialize_message), hashed
        # in parts to skip a whole-object join copy.
        with span("sign", nbytes=len(data)) as ssp:
            file_signature = network.keys.sign_parts(
                self.signature_policy,
                self.hash_policy,
                serialize_message_parts(network.id, data),
            )
            ssp.set_key(trace_key(file_signature))
        # Whole object already in memory: keep the origin copy (one
        # stripe per object — the store's geometry, not the chunking).
        self._store_put_raw(
            file_signature, data, k, n,
            network.id.address, bytes(network.keys.public_key),
        )
        view = memoryview(data)
        chunks = (view[i * B : (i + 1) * B] for i in range(count))
        return self._emit_stream(
            network, file_signature, k, n, B, count, len(data), chunks
        )

    def stream_and_broadcast_file(
        self,
        network,
        path: str,
        *,
        chunk_bytes: int = 4 << 20,
        geometry: Optional[tuple[int, int]] = None,
    ) -> int:
        """Stream a FILE without loading it into memory.

        Sender memory stays O(chunk): pass 1 computes the object
        signature by streaming the file through the hash (same
        ``serialize_message`` preimage — bit-identical signature to
        ``stream_and_broadcast`` of the same bytes), pass 2 reads, encodes
        and broadcasts one chunk at a time.
        """
        import os

        stat0 = os.stat(path)
        size = stat0.st_size
        if size == 0:
            raise ValueError("cannot stream an empty file")
        k, n, B, count = self._stream_plan(size, chunk_bytes, geometry)
        header = serialize_message_parts(network.id, b"")[0]

        def sig_parts():
            yield header
            with open(path, "rb") as f:
                while True:
                    blk = f.read(4 << 20)
                    if not blk:
                        return
                    yield blk

        with span("sign", nbytes=size) as ssp:
            file_signature = network.keys.sign_parts(
                self.signature_policy, self.hash_policy, sig_parts()
            )
            ssp.set_key(trace_key(file_signature))

        def chunks():
            with open(path, "rb") as f:
                for _ in range(count):
                    yield f.read(B)

        sent = self._emit_stream(
            network, file_signature, k, n, B, count, size, chunks()
        )
        # Two-pass hazard: pass 1 signed the file, pass 2 re-read it. If
        # the file changed in between, every receiver reassembles bytes
        # that can never verify — the sender must report failure, not
        # success. size + mtime_ns catches
        # every ordinary rewrite; a same-size same-mtime splice is below
        # the filesystem's own change-detection granularity.
        stat1 = os.stat(path)
        if (stat1.st_size, stat1.st_mtime_ns) != (size, stat0.st_mtime_ns):
            raise RuntimeError(
                f"{path} changed while streaming (size {size} -> "
                f"{stat1.st_size}, mtime {stat0.st_mtime_ns} -> "
                f"{stat1.st_mtime_ns}): receivers got an unverifiable "
                "object; re-send"
            )
        return sent

    def _stream_plan(
        self, length: int, chunk_bytes: int, geometry
    ) -> tuple[int, int, int, int]:
        """Validate and size a stream: (k, n, chunk capacity B, count).

        Rejects up front what every receiver would reject anyway (chunk
        count / object size over the caps) — otherwise the sender reports
        success while receivers silently drop every shard.
        """
        k, n = geometry or (self.minimum_needed_shards, self.total_shards)
        if not 1 <= k <= n <= self.max_total_shards:
            raise ValueError(f"invalid stream geometry k={k} n={n}")
        # Chunk capacity: whole uint32 words per stripe so the padded
        # chunk equals the capacity on every backend (see wire.py field
        # docs — the receiver derives per-chunk payload from it).
        B = max(4 * k, chunk_bytes - chunk_bytes % (4 * k))
        count = -(-length // B)
        if length > self.max_stream_object_bytes:
            raise ValueError(
                f"object of {length} bytes exceeds the stream cap "
                f"{self.max_stream_object_bytes}; raise "
                "max_stream_object_bytes on both ends"
            )
        if count > self.max_stream_chunks:
            raise ValueError(
                f"{count} chunks exceed the stream cap "
                f"{self.max_stream_chunks}; use a larger chunk_bytes"
            )
        return k, n, B, count

    def _emit_stream(
        self, network, file_signature: bytes, k: int, n: int, B: int,
        count: int, length: int, chunks,
    ) -> int:
        shards_out = bytes_out = 0
        # Transport backpressure PER SHARE: without it a bulk stream
        # outruns TCP drain and the transport's anti-DoS write cap
        # disconnects the peers mid-object. Per-share (not per-chunk)
        # with the share's own size as headroom, so the guarantee holds
        # for any geometry/chunk combination — a whole chunk's burst can
        # exceed the cap's headroom on its own (e.g. k=1 fan-out).
        # Transports without the hook — the loopback fake — are
        # unbuffered. The non-busy check is one short lock + int reads.
        waiter = getattr(network, "wait_writable", None)
        many = getattr(network, "broadcast_many", None)
        with span("broadcast", key=trace_key(file_signature), chunks=count):
            for index, shares in self._encode_chunk_stream(chunks, k, n, B):
                chunk_shards = []
                chunk_bytes_ = 0
                for s in shares:
                    chunk_shards.append(Shard(
                        file_signature=file_signature,
                        shard_data=s.data,
                        shard_number=s.number,
                        total_shards=n,
                        minimum_needed_shards=k,
                        stream_chunk_index=index,
                        stream_chunk_count=count,
                        stream_object_bytes=length,
                    ))
                    chunk_bytes_ += len(s.data)
                if many is not None:
                    # Whole-chunk cohort: one SHARD_BATCH frame per peer
                    # flush. Backpressure waits once per chunk with the
                    # chunk's own burst as headroom — the same guarantee
                    # the per-share wait gave, at batch granularity.
                    if waiter is not None:
                        waiter(headroom=chunk_bytes_ + 4096 * len(shares))
                    many(chunk_shards)
                else:
                    for shard in chunk_shards:
                        if waiter is not None:
                            waiter(headroom=len(shard.shard_data) + 4096)
                        network.broadcast(shard)
                shards_out += len(chunk_shards)
                bytes_out += chunk_bytes_
        self.counters.add("stream_chunks_out", count)
        self.counters.add("shards_out", shards_out)
        self.counters.add("bytes_out", bytes_out)
        return count

    def _encode_chunk_stream(self, chunks, k: int, n: int, B: int):
        """Yield (chunk_index, shares) for an iterable of chunk payloads.

        Device backend: the pipelined StreamingEncoder on ``self.device``
        (the upload of chunk i+1 overlaps chunk i's kernels). The numpy
        backend: per-chunk encode on the native C++ shim, which raises
        ``ShimBuildError`` when it cannot be built (the reference encodes
        on ``FEC`` then).
        """
        if self.backend == "device":
            from noise_ec_tpu_torch.parallel.streaming import StreamingEncoder

            enc = StreamingEncoder(k, n - k, chunk_bytes=B,
                                   device=self.device)
            for sc in enc.encode_stream(chunks):
                # Row buffers, not .tobytes(): the wire marshal joins from
                # each buffer directly. rows() keeps the parity-only-fetch
                # split — data rows are zero-copy views of the caller's
                # payload, parity rows the (r, stride) D2H fetch — so no
                # (n, stride) codeword buffer is ever assembled.
                rows = sc.rows()
                yield sc.index, [Share(i, rows[i].data) for i in range(n)]
            return
        import numpy as np

        from noise_ec_tpu_torch.shim import gf_matmul_rows

        shim = self._stream_shim(k, n)
        stride = B // k
        parity_matrix = None
        for index, chunk in enumerate(chunks):
            if len(chunk) == B:
                # Full chunk: the k data shards ARE consecutive slices of
                # the caller's payload — emit them as zero-copy views and
                # compute only the parity, straight from those slices via
                # the pointer-based shim matmul (no staging copy of the
                # data into a codeword buffer). Parity rows get their
                # OWN buffer per chunk (never reused): callers may hold a
                # Shard past the broadcast call. NOTE the retention shape
                # of the zero-copy data shards: their memoryviews pin the
                # caller's WHOLE payload object, not one codeword buffer —
                # fine for the normal lifecycle (broadcast marshals before
                # the generator resumes, and the caller holds the payload
                # for the duration of the call anyway), but a consumer
                # that retains data Shards beyond the stream call keeps
                # the full object alive with them.
                if parity_matrix is None:
                    from noise_ec_tpu_torch.gf.field import GF256
                    from noise_ec_tpu_torch.matrix.generators import generator_matrix

                    # Same Cauchy construction the shim's encoder bakes in
                    # (byte-identical by tests/test_torch_shim.py).
                    parity_matrix = generator_matrix(GF256(), k, n, "cauchy")[k:]
                view = memoryview(chunk)
                rows = [
                    np.frombuffer(view[j * stride : (j + 1) * stride],
                                  dtype=np.uint8)
                    for j in range(k)
                ]
                parity = gf_matmul_rows(parity_matrix, rows, stride)
                yield index, (
                    [Share(j, view[j * stride : (j + 1) * stride])
                     for j in range(k)]
                    + [Share(k + i, parity[i].data) for i in range(n - k)]
                )
                continue
            # Tail chunk: stage into a codeword buffer with explicit zero
            # pad and use the in-place encode. np.empty: data rows are
            # fully written below and parity rows are outputs.
            buf = np.empty((n, stride), dtype=np.uint8)
            flat = buf[:k].reshape(-1)
            m = len(chunk)
            flat[:m] = np.frombuffer(chunk, dtype=np.uint8)
            flat[m:] = 0
            shim.encode_into(buf)
            yield index, [Share(i, buf[i].data) for i in range(n)]

    def _stream_shim(self, k: int, n: int):
        """Native C++ codec for the host-only stream encode (cached per
        geometry; raises ``ShimBuildError`` when the shim cannot be built
        or loaded).

        The numpy backend exists to serve hosts without a device; its
        stream hot loop still deserves the native path (SURVEY.md §2.2 —
        the shim IS the framework's native host codec)."""
        key = (k, n)
        shim = self._shim_cache.get(key)
        if shim is None:
            from noise_ec_tpu_torch.shim import CppReedSolomon

            shim = self._shim_cache[key] = CppReedSolomon(k, n - k)
        return shim

    def _receive_stream(self, ctx: PluginContext, msg: Shard):
        """Stream-shard arm of the receive state machine.

        Each chunk reassembles through the same ShardPool (pool key =
        object signature + chunk index, so chunk pools inherit the TTL /
        byte caps and dedup); decoded chunks land in a preallocated
        object buffer; completion of the last chunk triggers the one
        object-level signature verify and delivery.

        Repairability matches the non-stream path: chunk pools are kept
        (not evicted) until the OBJECT verifies, and a chunk re-decodes
        whenever its pool has gained shares since its last decode — so a
        corrupted share among the first k of a chunk (which decodes
        "successfully" at exactly k, with nothing to check against) is
        corrected by Berlekamp-Welch once a parity share arrives, and the
        object re-verifies. CorruptionError is raised only when every
        chunk already holds all n shares and the signature still fails —
        no future arrival can help.
        """
        # Stream state is keyed by (signature, SENDER): verify binds the
        # object to the transport sender's key (main.go:85 — the sender IS
        # the encoder; shards are never relayed), so shards from another
        # identity can never contribute to this object. Scoping the key
        # (rather than pinning a signature-keyed stream to its first
        # sender) means an interloper racing the first shard merely opens
        # their own doomed stream instead of hijacking the real one — and
        # it makes the reassembly buffer single-writer by construction
        # (per-sender serialized dispatch), which is what lets the
        # object-level verify hash the live buffer outside the lock.
        sender_pk = self._sender_key(ctx)
        key = f"{msg.file_signature.hex()}:{sender_pk.hex()}"
        if self._recently_completed(key):
            self.counters.add("late_shards", 1)
            return None
        k = int(msg.minimum_needed_shards)
        n = int(msg.total_shards)
        count = int(msg.stream_chunk_count)
        index = int(msg.stream_chunk_index)
        length = int(msg.stream_object_bytes)
        if not 1 <= k <= n <= self.max_total_shards:
            self.counters.add("rejected_shards", 1)
            raise ValueError(f"invalid geometry k={k} n={n} in stream shard")
        if not 0 <= msg.shard_number < n:
            self.counters.add("rejected_shards", 1)
            raise ValueError(
                f"shard number {msg.shard_number} out of range for n={n}"
            )
        streams = self._streams
        if not 0 <= index < count:
            self.counters.add("rejected_shards", 1)
            raise ValueError(f"stream chunk {index} out of range [0, {count})")
        if not 0 < length <= self.max_stream_object_bytes:
            self.counters.add("rejected_shards", 1)
            raise ValueError(
                f"stream object of {length} bytes outside (0, "
                f"{self.max_stream_object_bytes}]"
            )
        if count > self.max_stream_chunks:
            self.counters.add("rejected_shards", 1)
            raise ValueError(
                f"stream chunk count {count} exceeds the cap "
                f"{self.max_stream_chunks}"
            )
        B = k * len(msg.shard_data)
        if B <= 0 or (count - 1) * B >= length or count * B < length:
            self.counters.add("rejected_shards", 1)
            raise ValueError(
                f"stream chunk capacity {B} inconsistent with "
                f"{count} chunks / {length} bytes"
            )
        now = time.monotonic()
        with self._streams_lock:
            st = streams.get(key)
            if st is None:
                # Expire stale objects, then admit (bounded).
                for stale in [
                    sk for sk, sv in streams.items()
                    if now - sv["created"] > self.STREAM_TTL_SECONDS
                ]:
                    self._drop_stream_locked(stale)
                if len(streams) >= self.max_stream_objects:
                    self.counters.add("stream_rejections", 1)
                    raise PoolLimitError(
                        f"{len(streams)} stream objects in flight"
                    )
                if self._stream_buf_bytes + length > self.max_stream_total_bytes:
                    self.counters.add("stream_rejections", 1)
                    raise PoolLimitError(
                        f"stream reassembly budget exhausted "
                        f"({self._stream_buf_bytes} + {length} > "
                        f"{self.max_stream_total_bytes})"
                    )
                self._stream_buf_bytes += length
                st = {
                    "buf": bytearray(length),
                    # chunk index -> pool distinct count at last decode
                    "done": {},
                    "count": count,
                    "B": B,
                    "length": length,
                    "k": k,
                    "n": n,
                    "created": now,
                    "failed": False,  # a whole-object verify has failed
                }
                streams[key] = st
            if (st["count"], st["B"], st["length"], st["k"], st["n"]) != (
                count, B, length, k, n
            ):
                # Geometry is pinned too: a forged shard whose k *
                # len(shard_data) happens to match B must not steer the
                # repair/unrecoverability logic (or decode to a SHORTER
                # chunk — a step-1 bytearray slice assignment from a
                # shorter source silently RESIZES the buffer, corrupting
                # every later chunk's offsets).
                self.counters.add("rejected_shards", 1)
                raise ValueError(
                    "stream shard disagrees with the object's pinned "
                    f"shape (count {count} vs {st['count']}, capacity "
                    f"{B} vs {st['B']}, length {length} vs {st['length']}, "
                    f"geometry ({k},{n}) vs ({st['k']},{st['n']}))"
                )

        if self.store is not None:
            # Stream chunks never absorb into a stripe (the store holds
            # whole objects as single stripes), but a stream shard for an
            # object we already store IS peer interest — note_shard
            # surfaces it to the repair engine and returns False.
            self.store.note_shard(msg)
        share = Share(msg.shard_number, bytes(msg.shard_data))
        pool_key = f"{key}:{index}"
        try:
            with span("reassemble", key=trace_key(msg.file_signature),
                      chunk=index, **_request_attrs(ctx)):
                snapshot, distinct, was_new = self.pool.add(
                    pool_key, share, k, n
                )
        except PoolLimitError:
            self.counters.add("pool_limit_rejections", 1)
            raise
        except ValueError:
            self.counters.add("rejected_shards", 1)
            raise
        if distinct < k or not was_new:
            return None
        with self._streams_lock:
            st = streams.get(key)
            if st is None:
                return None
            prior = st["done"].get(index)
            if prior is not None and not (st["failed"] and distinct > prior):
                # Already decoded, and no verify failure demands a
                # re-decode: extra shares just accumulate in the pool
                # (repair evidence for later), the happy path pays one
                # decode per chunk.
                self.counters.add("late_shards", 1)
                return None
        if prior is None:
            # Happy-path direct assembly: with the k systematic data
            # shards present, the chunk's bytes ARE those shards — write
            # them straight into the object buffer, skipping the decode
            # join plus the buffer copy (two chunk-size memcpys; ~25% of
            # the non-hash receive cost on 4 MiB chunks). Consistency
            # against parity still happens: any later verify failure
            # re-decodes through the full error-correcting path
            # (_repair_stream), exactly as for a codec decode at k.
            stride = len(msg.shard_data)
            by_num: dict[int, bytes] = {}
            for s in snapshot:
                if s.number < k and s.number not in by_num:
                    if len(s.data) != stride:
                        by_num = {}
                        break
                    by_num[s.number] = s.data
            if len(by_num) == k:
                with self._streams_lock:
                    st = self._streams.get(key)
                    if st is None:
                        return None
                    data_len = min(st["B"], st["length"] - index * st["B"])
                    lo = index * st["B"]
                    for j in range(k):
                        seg_lo = j * stride
                        if seg_lo >= data_len:
                            break
                        seg = min(stride, data_len - seg_lo)
                        st["buf"][lo + seg_lo : lo + seg_lo + seg] = (
                            memoryview(by_num[j])[:seg]
                        )
                    # Record k, not distinct: direct assembly used only
                    # the k data shards and checked NO parity, so a later
                    # verify failure must re-decode this chunk whenever
                    # the pool holds ANY redundancy beyond k —
                    # _repair_stream's "pool grew" gate compares against
                    # this value (recording distinct > k here would make
                    # a repairable corrupt chunk permanently
                    # undeliverable).
                    st["done"][index] = k
                    self.counters.add("decodes", 1)
                    if len(st["done"]) < st["count"]:
                        return None
                    complete = st["buf"]
                delivered = self._verify_stream_object(ctx, msg, key, complete)
                if delivered is not None:
                    return delivered
                return self._repair_stream(ctx, msg, key, k, n, count)
        fec = self._fec_receive(k, n, ctx)
        self._geometry_decode_begin(k, n)
        decode_nbytes = sum(len(s.data) for s in snapshot)
        try:
            with span("decode", key=trace_key(msg.file_signature),
                      chunk=index, **_request_attrs(ctx)), \
                    Timer(self.counters, "decode_s", nbytes=decode_nbytes,
                          histogram=self._decode_hist):
                chunk = fec.decode(snapshot)
            self._decode_bytes_hist.observe(decode_nbytes)
        except Exception as exc:
            self.counters.add("decode_errors", 1)
            log.error("stream chunk %d decode failed for %s…: %s",
                      index, key[:16], exc)
            if distinct >= n:
                with self._streams_lock:
                    st = self._streams.get(key)
                    started = st["created"] if st is not None else None
                self._drop_stream(key)
                self._record_outcome("corrupt", started)
                raise CorruptionError(
                    f"all {n} shards of stream chunk {index} arrived for "
                    f"{key[:16]}… but decode fails: {exc}"
                ) from exc
            return None
        finally:
            # Release the in-flight slot on success AND failure: the
            # planning happened during the decode attempt either way,
            # and a failing decode must not let a poisoned novel geometry
            # pin the global admission budget for the whole grace window.
            self._geometry_ready(k, n)
        self.counters.add("decodes", 1)

        with self._streams_lock:
            st = streams.get(key)
            if st is None:
                return None
            data_len = min(st["B"], st["length"] - index * st["B"])
            lo = index * st["B"]
            first = index not in st["done"]
            # Compare only on RE-decodes (repair mode): on the first
            # decode the comparison is meaningless and its two 4 MiB
            # copies per chunk were ~25% of the happy path.
            changed = (not first) and (
                memoryview(chunk)[:data_len]
                != memoryview(st["buf"])[lo : lo + data_len]
            )
            if first or changed:
                st["buf"][lo : lo + data_len] = memoryview(chunk)[:data_len]
            st["done"][index] = distinct
            if len(st["done"]) < st["count"]:
                return None
            if not (first or changed):
                # A post-failure re-decode produced the same bytes: only
                # the unrecoverability verdict can have changed.
                complete = None
            else:
                # The live buffer, not a copy: the verify hash reads it
                # in place; bytes are materialized only on delivery.
                # (Per-sender serialized dispatch keeps it stable across
                # the verify.)
                complete = st["buf"]

        if complete is not None:
            delivered = self._verify_stream_object(ctx, msg, key, complete)
            if delivered is not None:
                return delivered
        # Verify failed (now or earlier): try to repair from the pooled
        # shares, then decide recoverability.
        return self._repair_stream(ctx, msg, key, k, n, count)

    def _verify_stream_object(
        self, ctx: PluginContext, msg: Shard, key: str, complete
    ):
        """Verify + deliver a fully reassembled object (``complete`` may
        be the live reassembly bytearray — hashed in place, materialized
        as bytes only on delivery); None on failure (caller decides
        repair/unrecoverability)."""
        sender = ctx.sender()
        with self._streams_lock:
            st0 = self._streams.get(key)
            started = st0["created"] if st0 is not None else None
        with span("verify", key=trace_key(msg.file_signature),
                  nbytes=len(complete), **_request_attrs(ctx)):
            ok = verify_parts(
                self.signature_policy,
                self.hash_policy,
                ctx.client_public_key(),
                serialize_message_parts(sender, complete),
                msg.file_signature,
            )
        if not ok:
            self.counters.add("verify_failures", 1)
            log.warning("stream object signature verify failed for %s…",
                        key[:16])
            with self._streams_lock:
                st = self._streams.get(key)
                if st is not None:
                    st["failed"] = True
            self._record_outcome("verify_failed", started)
            return None
        if not self._mark_completed(key):
            self.counters.add("late_shards", 1)
            return None
        self._record_outcome("ok", started)
        # Store BEFORE delivery: the on_object path below transfers
        # ownership of the reassembly buffer to the callee.
        self._store_put(
            ctx, msg, int(msg.minimum_needed_shards),
            int(msg.total_shards), complete, sender,
        )
        if self.on_object is not None and isinstance(complete, bytearray):
            # Zero-copy delivery: hand over the reassembly buffer itself.
            # _drop_stream first — the plugin must hold no reference to a
            # buffer whose ownership moves to the callee.
            self._drop_stream(key)
            self.counters.add("verified", 1)
            self.counters.add("stream_objects_in", 1)
            log.info("completed stream object %s… (%d bytes)",
                     key[:16], len(complete))
            self.on_object(complete, sender)
            return complete
        delivered = bytes(complete)
        self._drop_stream(key)
        self.counters.add("verified", 1)
        self.counters.add("stream_objects_in", 1)
        log.info("completed stream object %s… (%d bytes)",
                 key[:16], len(delivered))
        if self.on_message is not None:
            self.on_message(delivered, sender)
        return delivered

    def _repair_stream(
        self, ctx: PluginContext, msg: Shard, key: str, k: int, n: int,
        count: int,
    ) -> Optional[bytes]:
        """After a verify failure: re-decode every chunk whose pool holds
        more shares than its last decode used (the extra shares enable
        the consistency check and Berlekamp-Welch correction), re-verify
        if anything changed, and raise CorruptionError only once every
        chunk has all n shares and the signature still fails."""
        fec = self._fec_receive(k, n, ctx)
        while True:
            changed_any = False
            for i in range(count):
                shares, _ = self.pool.snapshot(f"{key}:{i}")
                if not shares:
                    continue
                with self._streams_lock:
                    st = self._streams.get(key)
                    if st is None:
                        return None
                    if len(shares) <= st["done"].get(i, 0):
                        continue
                self._geometry_decode_begin(k, n)
                try:
                    chunk = fec.decode(shares)
                except Exception as exc:  # noqa: BLE001 — keep repairing others
                    log.debug("stream chunk decode failed: %s", exc)
                    self.counters.add("decode_errors", 1)
                    continue
                finally:
                    self._geometry_ready(k, n)  # slot freed on any outcome
                self.counters.add("decodes", 1)
                with self._streams_lock:
                    st = self._streams.get(key)
                    if st is None:
                        return None
                    data_len = min(st["B"], st["length"] - i * st["B"])
                    lo = i * st["B"]
                    if bytes(st["buf"][lo : lo + data_len]) != chunk[:data_len]:
                        st["buf"][lo : lo + data_len] = (
                            memoryview(chunk)[:data_len]
                        )
                        changed_any = True
                    st["done"][i] = len(shares)
            if not changed_any:
                break
            with self._streams_lock:
                st = self._streams.get(key)
                if st is None or len(st["done"]) < st["count"]:
                    return None
                complete = st["buf"]
            delivered = self._verify_stream_object(ctx, msg, key, complete)
            if delivered is not None:
                self.counters.add("stream_repairs", 1)
                return delivered
        if self._stream_has_all_shards(key, count, n):
            with self._streams_lock:
                st = self._streams.get(key)
                started = st["created"] if st is not None else None
            self._drop_stream(key)
            self._record_outcome("corrupt", started)
            raise CorruptionError(
                f"stream object {key[:16]}… has all {n} shards of all "
                f"{count} chunks but the signature does not verify"
            )
        return None

    def _stream_has_all_shards(self, key: str, count: int, n: int) -> bool:
        return all(
            self.pool.snapshot(f"{key}:{i}")[1] >= n for i in range(count)
        )

    def _drop_stream(self, key: str) -> None:
        with self._streams_lock:
            self._drop_stream_locked(key)

    def _drop_stream_locked(self, key: str) -> None:
        st = self._streams.pop(key, None)
        if st is not None:
            self._stream_buf_bytes -= st["length"]
            for i in range(st["count"]):
                self.pool.evict(f"{key}:{i}")

    # ------------------------------------------------------------- store

    def _store_put(
        self, ctx: PluginContext, msg: Shard, k: int, n: int, data, sender
    ) -> None:
        """Land a signature-verified object in the stripe store (when one
        is wired in). The sender identity rides along so the repair
        engine can re-anchor error-corrected restores on the same
        signature the receive path just checked. A store failure must
        never break delivery."""
        self._store_put_raw(
            msg.file_signature, data, k, n,
            sender.address, bytes(ctx.client_public_key()),
        )

    def _store_put_raw(
        self, file_signature: bytes, data, k: int, n: int,
        address: str, public_key: bytes,
    ) -> None:
        if self.store is None:
            return
        try:
            self.store.put_object(
                file_signature,
                bytes(data),
                k,
                n,
                sender_address=address,
                sender_public_key=public_key,
            )
            self.counters.add("store_puts", 1)
        except Exception as exc:  # noqa: BLE001 — delivery must proceed
            self.counters.add("store_put_errors", 1)
            log.warning("stripe store put failed for %s…: %s",
                        file_signature[:8].hex(), exc)

    # ------------------------------------------------- NACK shard repair

    def _nack_note(self, key: str, msg: Shard, ctx: PluginContext) -> None:
        """An arriving shard left pool ``key`` below k: arm (or keep) its
        NACK timer. Runs on the dispatch path — one lock, no I/O."""
        if self.nack_grace_seconds <= 0 or self._network() is None:
            return
        now = time.monotonic()
        with self._nack_lock:
            st = self._nack.get(key)
            if st is None:
                self._nack[key] = {
                    "sig": bytes(msg.file_signature),
                    "k": int(msg.minimum_needed_shards),
                    "n": int(msg.total_shards),
                    "sender": self._sender_key(ctx),
                    "retries": 0,
                    "next_at": now + self.nack_grace_seconds,
                }
                # Bounded: keys are attacker-suppliable (one per forged
                # first shard); evict oldest state, the pool TTL still
                # owns the shares themselves.
                while len(self._nack) > 4096:
                    self._nack.popitem(last=False)
            if self._nack_thread is None:
                self._nack_thread = threading.Thread(
                    target=self._nack_run, name="noise-ec-nack", daemon=True
                )
                self._nack_thread.start()

    def _nack_resolve(self, key: str, delivered: bool = True) -> None:
        """The pool completed (or became unrecoverable): retire its NACK
        state; a delivery that needed at least one NACK round counts as
        a repair."""
        with self._nack_lock:
            st = self._nack.pop(key, None)
        if st is not None and delivered and st["retries"] > 0:
            self._nack_repaired.add(1)

    def _nack_run(self) -> None:
        while True:
            tick = max(
                0.05, min(self.nack_grace_seconds, self.nack_backoff_base) / 4
            )
            time.sleep(tick)
            try:
                self._nack_sweep()
            except Exception as exc:  # noqa: BLE001 — keep the sweeper up
                log.warning("NACK sweep failed: %s", exc)
            with self._nack_lock:
                if not self._nack:
                    # Idle: let the thread die; the next stuck pool
                    # restarts it (tests build many short-lived plugins).
                    self._nack_thread = None
                    return

    def _nack_sweep(self) -> None:
        now = time.monotonic()
        with self._nack_lock:
            items = list(self._nack.items())
        net = self._network()
        for key, st in items:
            entry = self.pool.get(key)
            if entry is None:
                # TTL'd or evicted underneath us: nothing left to repair.
                with self._nack_lock:
                    self._nack.pop(key, None)
                continue
            if entry.distinct() >= st["k"]:
                continue  # decode path owns it; resolve happens there
            if now < st["next_at"]:
                continue
            if st["retries"] >= self.nack_max_retries:
                with self._nack_lock:
                    self._nack.pop(key, None)
                self._nack_giveups.add(1)
                event("repair.giveup", "error", key=key[:16],
                      have=entry.distinct(), need=st["k"],
                      retries=st["retries"])
                self._record_outcome("incomplete", entry.created_at)
                log.warning(
                    "object %s… stuck at %d/%d shards after %d NACK "
                    "rounds; recording incomplete (pool TTL keeps the "
                    "shards for late repair)", key[:16], entry.distinct(),
                    st["k"], st["retries"],
                )
                continue
            if net is None:
                continue
            shares, _ = self.pool.snapshot(key)
            if not shares:
                continue
            shards = [
                Shard(
                    file_signature=st["sig"],
                    shard_data=bytes(s.data),
                    shard_number=s.number,
                    total_shards=st["n"],
                    minimum_needed_shards=st["k"],
                )
                for s in shares
            ]
            # Round 0 goes straight to the original sender (it stores
            # its own broadcasts); on sender-silence the later rounds
            # broadcast so any peer holding the stripe can answer.
            sent_direct = False
            send_to = getattr(net, "send_to", None)
            if st["retries"] == 0 and st["sender"] and send_to is not None:
                sent_direct = all(send_to(st["sender"], sh) for sh in shards)
            if not sent_direct:
                for sh in shards:
                    net.broadcast(sh)
            self._nack_requests.add(1)
            with self._nack_lock:
                cur = self._nack.get(key)
                if cur is st:
                    st["retries"] += 1
                    st["next_at"] = now + min(
                        self.nack_backoff_cap,
                        self.nack_backoff_base * (2 ** (st["retries"] - 1)),
                    )

    # -------------------------------------------------------- receive path

    def _record_outcome(self, outcome: str, started) -> None:
        """One e2e outcome event (obs/health.py): latency measured from
        the object's first-seen time (pool/stream creation) when known,
        0.0 otherwise (the outcome still burns or feeds the SLO)."""
        seconds = (
            max(0.0, time.monotonic() - started) if started is not None
            else 0.0
        )
        record_e2e(outcome, seconds, slo=self.slo)

    def _pool_started(self, key: str):
        entry = self.pool.get(key)
        return entry.created_at if entry is not None else None

    def receive(self, ctx: PluginContext) -> Optional[bytes]:
        """Shard-reassembly state machine (main.go:52-107).

        Returns the reassembled, signature-verified plaintext when this
        arrival completes an object, else None. Raises
        :class:`CorruptionError` / :class:`PoolTooLargeError` where the
        reference returns its CASE C/D errors.

        Case map vs the reference (§3.2): A/B collapse into ``pool.add``
        (first arrival and accumulation are the same code path); C fires at
        k *distinct* shares including this one; D lives in the pool.
        """
        msg = ctx.message()
        if not isinstance(msg, Shard):  # type switch, main.go:53-54
            return None
        self.counters.add("shards_in", 1)
        self.counters.add("bytes_in", len(msg.shard_data))
        if msg.stream_chunk_count:
            return self._receive_stream(ctx, msg)
        key = msg.file_signature.hex()  # mempool key, main.go:55
        if (
            self.placement is not None
            and self.store is not None
            and self.placement.absorbs(msg)
            and self.store.note_placement_shard(msg)
        ):
            # A targeted placement shard for a slot whose failure domain
            # is ours (checked BEFORE the general absorb — this is the
            # only branch allowed to CREATE a stripe entry): anchor it in
            # the store and CONSUME it — pooling a below-k targeted
            # cohort would only arm the NACK timer and pull the whole
            # stripe back over the wire, undoing the fanout savings.
            # Broadcast stripes still complete: a domain owns at most one
            # local group of any stripe, so >= k other slots reach the
            # pool — note_shard absorbs them additively (placement-born
            # stripes report unconsumed) rather than starving it.
            self.counters.add("placement_absorbed_shards", 1)
            return None
        if self.store is not None and self.store.note_shard(msg):
            # The store consumed it (BEFORE the dedup window — an
            # anti-entropy response arrives precisely for objects we
            # completed, and absorbing it must not depend on timing):
            # either a fill of a stripe we hold or a duplicate of a shard
            # we already store (the interest signal peers answer). No
            # pool work needed — the object is already durable locally.
            self.counters.add("store_absorbed_shards", 1)
            return None
        if self._recently_completed(key):
            self.counters.add("late_shards", 1)
            return None
        share = Share(msg.shard_number, bytes(msg.shard_data))
        k = int(msg.minimum_needed_shards)
        n = int(msg.total_shards)
        # Full message validation up front: geometry within the field bound
        # and share number within the geometry. One malformed (or
        # adversarial) message must neither crash the transport's dispatch
        # loop nor poison the pool for the legitimate shards.
        if not 1 <= k <= n <= self.max_total_shards:
            self.counters.add("rejected_shards", 1)
            raise ValueError(f"invalid geometry k={k} n={n} in shard message")
        if not 0 <= msg.shard_number < n:
            self.counters.add("rejected_shards", 1)
            raise ValueError(
                f"shard number {msg.shard_number} out of range for n={n}"
            )
        try:
            with span("reassemble", key=trace_key(msg.file_signature),
                      **_request_attrs(ctx)):
                snapshot, distinct, was_new = self.pool.add(key, share, k, n)
        except PoolTooLargeError:
            self.counters.add("pool_overflows", 1)
            raise
        except PoolLimitError:
            # Resource budget exhausted — a distinct signal from malformed
            # shards: this is the memory-exhaustion alarm.
            self.counters.add("pool_limit_rejections", 1)
            raise
        except ValueError:
            # Geometry or length disagrees with the pinned pool: drop this
            # share, keep the pool intact.
            self.counters.add("rejected_shards", 1)
            raise
        if distinct < k:
            # CASE A/B: keep accumulating (main.go:56-71) — and arm the
            # NACK timer so a stalled pool asks for its missing shards
            # instead of silently waiting out the TTL.
            self._nack_note(key, msg, ctx)
            return None
        if not was_new:
            # A replayed duplicate adds no information; don't pay another
            # decode + verify for it.
            return None

        # CASE C: enough distinct shares — decode + verify (main.go:72-99).
        fec = self._fec_receive(k, n, ctx)
        self._geometry_decode_begin(k, n)
        decode_nbytes = sum(len(s.data) for s in snapshot)
        try:
            with span("decode", key=trace_key(msg.file_signature), k=k, n=n,
                      **_request_attrs(ctx)), \
                    Timer(self.counters, "decode_s", nbytes=decode_nbytes,
                          histogram=self._decode_hist):
                complete = fec.decode(snapshot)
            self._decode_bytes_hist.observe(decode_nbytes)
        except Exception as exc:
            # The reference logs decode errors and falls through to a
            # doomed Verify on nil (main.go:75-80, quirk 5); we log and
            # wait for more shares — unless every share number has arrived,
            # in which case no future arrival can help (duplicates
            # short-circuit above) and the object is unrecoverable.
            self.counters.add("decode_errors", 1)
            log.error("decode failed for %s…: %s", key[:16], exc)
            if distinct >= n:
                started = self._pool_started(key)
                self.pool.evict(key)
                self._nack_resolve(key, delivered=False)
                self._record_outcome("corrupt", started)
                raise CorruptionError(
                    f"all {n} shards arrived for {key[:16]}… but decode "
                    f"fails: {exc}"
                ) from exc
            return None
        finally:
            self._geometry_ready(k, n)  # slot freed on any outcome
        self.counters.add("decodes", 1)

        sender = ctx.sender()
        with span("verify", key=trace_key(msg.file_signature),
                  **_request_attrs(ctx)):
            ok = verify(
                self.signature_policy,
                self.hash_policy,
                ctx.client_public_key(),  # transport sender == original encoder
                serialize_message(sender, complete),  # (main.go:85, quirk 6)
                msg.file_signature,
            )
        if ok:
            started = self._pool_started(key)
            self.pool.evict(key)  # main.go:90-93
            self._nack_resolve(key)
            if not self._mark_completed(key):
                # A concurrent receive() already delivered this object
                # between our pool snapshot and now; exactly-once holds.
                self.counters.add("late_shards", 1)
                return None
            self.counters.add("verified", 1)
            self._record_outcome("ok", started)
            self._store_put(ctx, msg, k, n, complete, sender)
            log.info("completed message %s… (%d bytes)", complete[:32].hex(), len(complete))
            if self.on_message is not None:
                self.on_message(complete, sender)
            return complete

        self.counters.add("verify_failures", 1)
        log.warning("signature verify failed for %s…", key[:16])
        started = self._pool_started(key)
        if distinct >= n:
            # Every shard arrived and the object still fails verification:
            # unrecoverable (main.go:96-98 made reachable — see
            # CorruptionError docstring).
            self.pool.evict(key)
            self._nack_resolve(key, delivered=False)
            self._record_outcome("corrupt", started)
            raise CorruptionError(
                f"all {n} shards arrived for {key[:16]}… but the signature "
                "does not verify"
            )
        self._record_outcome("verify_failed", started)
        return None
