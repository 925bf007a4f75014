"""Repair engine: coalesce pending stripe repairs into batched device
reconstructs, with anti-entropy peer fetch as the fallback.

The queue holds at most one task per stripe key (re-enqueues upgrade the
kind in place). A drain groups local reconstructions by *repair shape* —
(k, n, field, shard length, trusted-slot pattern) — and runs each group
of same-shape stripes as ONE batched device dispatch
(``rs.matmul_many`` through the coalescer into
``DeviceCodec.matmul_stripes_many``: the B (k, S) stacks against one
inverted submatrix), which turns per-stripe reconstructs into an
always-on background workload on the card instead of B host round
trips. Port of ``noise_ec_tpu.store.repair``.

Task kinds (classified by :meth:`StripeStore.classify`):

- ``missing`` — >= k trusted shards: batched erasure reconstruct, holes
  (and unverified slots) rewritten from the trusted basis.
- ``restore`` — < k trusted but >= k present counting unverified wire
  absorbs: the error-correcting whole-stripe decode (``codec.fec.FEC``,
  Berlekamp-Welch radius), anchored by the stored sender signature when
  available; on success every slot is rewritten/blessed.
- ``fetch`` — < k present: local math cannot help. The engine broadcasts
  the surviving trusted shards over the ordinary SHARD opcode (no new
  wire surface); peers that hold the stripe notice the interest
  (:meth:`StripeStore.note_shard` → :meth:`on_remote_interest`) and
  answer with their shards, which the requester absorbs shard-by-shard.
- ``respond`` — a peer showed interest in a stripe we hold with >= k
  trusted shards: broadcast our trusted shards (rate-limited per key).

Run it either as a background thread (:meth:`start`) that wakes on
enqueue and lingers briefly to let same-shape work coalesce, or drive it
deterministically with :meth:`drain_once` (tests, bench).
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np

from noise_ec_tpu_torch.host.wire import Shard
from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import node_attrs, span
from noise_ec_tpu_torch.store.stripe import StripeStore, UnknownStripeError

__all__ = ["RepairEngine"]

log = logging.getLogger("noise_ec_tpu_torch.store")

# Task kinds in escalation order: a re-enqueue may only upgrade towards
# the network fallback, never downgrade a fetch back to local math (the
# classifier re-checks at drain time anyway). "verify_failed" is the
# scrubber's flag for a fully-present stripe whose parity disagrees —
# classify() cannot see it (it only counts slots), so the kind survives
# re-classification below.
_KIND_RANK = {
    "respond": 0, "missing": 1, "verify_failed": 2, "restore": 3, "fetch": 4,
}


class _EngineMetrics:
    _registered = False
    _instances: "weakref.WeakSet[RepairEngine]" = weakref.WeakSet()

    def __init__(self):
        reg = default_registry()
        self.repairs = reg.counter(
            "noise_ec_store_repairs_completed_total"
        ).labels()
        self.failures = reg.counter(
            "noise_ec_store_repair_failures_total"
        ).labels()
        self.batches = reg.counter(
            "noise_ec_store_repair_batches_total"
        ).labels()
        self.batch_stripes = reg.counter(
            "noise_ec_store_repair_batch_stripes_total"
        ).labels()
        self.corrupt_shards = reg.counter(
            "noise_ec_store_corrupt_shards_total"
        ).labels()
        self.requests = reg.counter(
            "noise_ec_store_anti_entropy_requests_total"
        ).labels()
        self.responses = reg.counter(
            "noise_ec_store_anti_entropy_responses_total"
        ).labels()
        # Repair-input accounting by codec kind: the repair-storm
        # bench's repair_fetch_amplification is (lrc reads per heal) /
        # (rs reads per heal) off these counters (docs/lrc.md).
        self.shards_read = {
            code: reg.counter(
                "noise_ec_store_repair_shards_read_total"
            ).labels(code=code)
            for code in ("rs", "lrc")
        }
        self.announces = reg.counter(
            "noise_ec_store_announces_total"
        ).labels()
        cls = _EngineMetrics
        if not cls._registered:
            cls._registered = True
            reg.gauge("noise_ec_store_repair_queue_depth").set_callback(
                lambda: sum(e.queue_depth() for e in list(cls._instances))
            )


class RepairEngine:
    """Batched repair worker over one :class:`StripeStore` (module doc)."""

    def __init__(
        self,
        store: StripeStore,
        network=None,
        *,
        batch_min: int = 2,
        max_batch: Optional[int] = None,
        linger_seconds: float = 0.05,
        fetch_interval_seconds: float = 30.0,
        respond_interval_seconds: float = 30.0,
        announce_interval_seconds: float = 0.0,
        announce_window_seconds: float = 60.0,
        announce_max_stripes: int = 64,
    ):
        self.store = store
        self.network = network
        self.batch_min = batch_min
        if max_batch is None:
            # A drain's group dispatch rides rs.matmul_many through the
            # mesh dispatch tier (parallel/mesh.py): with N devices one
            # batched reconstruct shards N ways, so a repair storm may
            # drain N x wider per dispatch at the same load a device.
            from noise_ec_tpu_torch.parallel.mesh import mesh_router

            router = mesh_router()
            max_batch = min(64 * router.n_pow2, 512) if router.enabled else 64
        self.max_batch = max_batch
        self.linger_seconds = linger_seconds
        self.fetch_interval_seconds = fetch_interval_seconds
        self.respond_interval_seconds = respond_interval_seconds
        # Anti-entropy ANNOUNCE (docs/resilience.md): every interval,
        # broadcast ONE trusted shard of each stripe stored within the
        # last ``announce_window_seconds`` (capped). Peers holding the
        # stripe absorb it silently; peers that never received the
        # object open a 1-of-k pool, whose NACK grace timer then pulls
        # the full stripe — the recovery path for SILENT loss (a
        # directional partition drops every shard, so the receiver has
        # nothing to NACK from). 0 disables (the default: announce is a
        # broadcast tax only resilience-minded deployments opt into).
        self.announce_interval_seconds = announce_interval_seconds
        self.announce_window_seconds = announce_window_seconds
        self.announce_max_stripes = announce_max_stripes
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: OrderedDict[str, str] = {}  # key -> kind
        # Stripe keys announced EVERY interval regardless of recency:
        # the object service pins the stripes of namespaces with a
        # replication target (tenant.replicas > 1), so peers that missed
        # (or lost) them keep getting re-offered one shard per interval
        # and NACK-pull the rest (docs/object-service.md).
        self._pinned: set[str] = set()
        # Announce piggybacks: zero-arg callables run after each
        # announce round — the object service's warm-set advert (which
        # peers hold which addresses decoded-warm, service/cache.py)
        # rides the same interval instead of growing its own timer.
        self._announce_hooks: list = []
        self._last_fetch: OrderedDict[str, float] = OrderedDict()
        self._last_respond: OrderedDict[str, float] = OrderedDict()
        self._fecs: dict[tuple[int, int, str], object] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.metrics = _EngineMetrics()
        _EngineMetrics._instances.add(self)
        store.bind_engine(self)

    # ------------------------------------------------------------- queue

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def enqueue(self, key: str, kind: str) -> None:
        if kind not in _KIND_RANK:
            raise ValueError(f"unknown repair kind {kind!r}")
        with self._cond:
            prev = self._queue.get(key)
            if prev is None or _KIND_RANK[kind] > _KIND_RANK[prev]:
                self._queue[key] = kind
            self._cond.notify()

    def enqueue_auto(self, key: str) -> None:
        """Classify-and-enqueue (the absorb path calls this after filling
        a hole; a healthy stripe enqueues nothing)."""
        try:
            kind = self.store.classify(key)
        except UnknownStripeError:
            return
        if kind is not None:
            self.enqueue(key, kind)

    def pin_announce(self, keys: "Iterable[str]") -> None:
        """Mark stripe keys as standing announce targets (per-namespace
        replication): :meth:`announce_once` includes them beyond the
        recency window until they are unpinned or evicted."""
        with self._lock:
            self._pinned.update(keys)

    def unpin_announce(self, keys: "Iterable[str]") -> None:
        with self._lock:
            self._pinned.difference_update(keys)

    def pinned_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._pinned)

    def add_announce_hook(self, fn) -> None:
        """Register a zero-arg callable to run after each announce round
        (piggyback surface: the object service broadcasts its warm-set
        advert here — docs/object-service.md "Read path"). Exceptions
        are logged, never raised."""
        self._announce_hooks.append(fn)

    def on_remote_interest(self, key: str) -> None:
        """A peer is moving shards of a stripe we hold (called from the
        plugin receive path via the store — must stay cheap). Rate-limit
        per key, then queue a respond task."""
        now = time.monotonic()
        with self._lock:
            last = self._last_respond.get(key)
            if (
                last is not None
                and now - last < self.respond_interval_seconds
            ):
                return
            self._last_respond[key] = now
            while len(self._last_respond) > 4096:
                self._last_respond.popitem(last=False)
        self.enqueue(key, "respond")

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="noise-ec-repair", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        from noise_ec_tpu_torch.ops.coalesce import qos_lane

        # Repair reconstruct dispatches ride the device gate's
        # background lane: durability work yields to live traffic at a
        # contended gate (the starvation floor guarantees progress).
        with qos_lane("background", tenant="repair"):
            self._run_loop()

    def _run_loop(self) -> None:
        next_announce = (
            time.monotonic() + self.announce_interval_seconds
            if self.announce_interval_seconds > 0 else None
        )
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    if next_announce is None:
                        self._cond.wait()
                    else:
                        remaining = next_announce - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                if self._closed:
                    return
            if (
                next_announce is not None
                and time.monotonic() >= next_announce
            ):
                next_announce = (
                    time.monotonic() + self.announce_interval_seconds
                )
                try:
                    self.announce_once()
                except Exception as exc:  # noqa: BLE001 — keep the worker up
                    log.error("announce failed: %s", exc)
            with self._lock:
                has_work = bool(self._queue)
            if not has_work:
                continue
            # Linger so same-shape repairs arriving in a burst (a scrub
            # cycle, a dying device) coalesce into one batched dispatch.
            if self.linger_seconds > 0:
                time.sleep(self.linger_seconds)
            try:
                self.drain_once()
            except Exception as exc:  # noqa: BLE001 — keep the worker up
                log.error("repair drain failed: %s", exc)

    # -------------------------------------------------------------- drain

    def drain_once(self) -> int:
        """Process everything currently queued; returns the number of
        stripes repaired (fetch/respond count as processed, not
        repaired). Deterministic entry point for tests and bench."""
        with self._lock:
            tasks = list(self._queue.items())[: self.max_batch]
            for key, _ in tasks:
                del self._queue[key]
        if not tasks:
            return 0
        # Re-classify at drain time: absorbs since enqueue may have
        # upgraded a fetch to a local reconstruct (or healed it outright).
        groups: dict[tuple, list[tuple[str, list]]] = {}
        singles: list[tuple[str, str]] = []
        for key, kind in tasks:
            if kind == "respond":
                singles.append((key, "respond"))
                continue
            try:
                now_kind = self.store.classify(key)
            except UnknownStripeError:
                continue
            if now_kind is None:
                # Slot-complete — but a scrub verify_failed flag means the
                # bytes are wrong even though every slot is filled.
                if kind == "verify_failed":
                    singles.append((key, "verify_failed"))
                continue
            if now_kind == "missing":
                meta, shards, unverified = self.store.snapshot(key)
                trusted = tuple(
                    i for i, s in enumerate(shards)
                    if s is not None and i not in unverified
                )
                gkey = (
                    meta.k, meta.n, meta.field, meta.shard_len, trusted,
                    meta.code,
                )
                groups.setdefault(gkey, []).append((key, shards))
            else:
                singles.append((key, now_kind))
        repaired = 0
        for gkey, members in groups.items():
            repaired += self._reconstruct_group(gkey, members)
        for key, kind in singles:
            if kind in ("restore", "verify_failed"):
                repaired += self._restore(key)
            elif kind == "fetch":
                self._fetch(key)
            elif kind == "respond":
                self._respond(key)
        return repaired

    # ------------------------------------------------- local reconstruct

    def _sym_dtype(self, field: str):
        return np.dtype("<u2") if field == "gf65536" else np.dtype(np.uint8)

    def _reconstruct_group(self, gkey: tuple, members: list) -> int:
        """Rebuild every non-trusted slot of a same-shape stripe group.
        B >= batch_min stripes fold into one batched device dispatch;
        smaller groups take the per-stripe codec path. LRC stripes route
        through the codec's tiered ``repair_many``: loss patterns inside
        the group budget heal from ~k/g cell members per stripe (all
        B×|wanted| heals in ONE coalesced all-ones dispatch) instead of
        the full-k basis — the fetch-amplification win docs/lrc.md
        quantifies."""
        k, n, fieldname, shard_len, trusted, code = gkey
        wanted = [i for i in range(n) if i not in trusted]
        if not wanted or len(trusted) < k:
            return 0
        dt = self._sym_dtype(fieldname)
        repaired = 0
        with span("repair", stripes=len(members), k=k, n=n, **node_attrs()):
            from noise_ec_tpu_torch.codec.lrc import LocalReconstructionCode

            rs = self.store.codec(k, n, fieldname, code)
            if isinstance(rs, LocalReconstructionCode):
                plan = rs.repair_plan(trusted, wanted)
                reads = (
                    len({m for basis in plan.values() for m in basis})
                    if plan is not None else k
                )
                rebuilt = rs.repair_many(
                    [shards for _, shards in members], trusted, wanted
                )
                self.metrics.shards_read["lrc"].add(reads * len(members))
                if plan is not None and len(members) >= self.batch_min:
                    self.metrics.batches.add(1)
                    self.metrics.batch_stripes.add(len(members))
            elif len(members) >= self.batch_min:
                # One coalesced dispatch for the whole group: the engine
                # no longer keeps a private batch path — it hands the
                # pre-formed batch to the live-path CoalescingDispatcher
                # (rs.matmul_many -> ops/coalesce.py submit_many), so
                # repair work and live encode/decode traffic share one
                # queue (and the DeviceGate admission behind it), and a
                # concurrent same-shape live request can ride the same
                # device call as a repair storm.
                from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

                basis = sorted(trusted)[:k]
                R = reconstruction_matrix(rs.gf, rs.G, basis, wanted)
                self.metrics.shards_read["rs"].add(k * len(members))
                stacks = [
                    np.stack([
                        np.frombuffer(shards[i], dtype=np.uint8).view(dt)
                        for i in basis
                    ])
                    for _, shards in members
                ]
                filled = rs.matmul_many(R, stacks)
                self.metrics.batches.add(1)
                self.metrics.batch_stripes.add(len(members))
                rebuilt = [
                    {
                        i: np.ascontiguousarray(rows[row])
                        .view(np.uint8).tobytes()
                        for row, i in enumerate(wanted)
                    }
                    for rows in filled
                ]
            else:
                self.metrics.shards_read["rs"].add(k * len(members))
                required = [i in wanted for i in range(n)]
                rebuilt = []
                for _, shards in members:
                    usable = [
                        shards[i] if i in trusted else None for i in range(n)
                    ]
                    rows = rs.reconstruct_some(usable, required)
                    rebuilt.append({
                        i: np.ascontiguousarray(rows[i])
                        .view(np.uint8).tobytes()
                        for i in wanted
                    })
            for (key, shards), fixed in zip(members, rebuilt):
                corrected = sum(
                    1 for i in wanted
                    if shards[i] is not None and shards[i] != fixed[i]
                )
                try:
                    self.store.write_repaired(key, fixed)
                except (UnknownStripeError, ValueError) as exc:
                    self.metrics.failures.add(1)
                    log.warning("repair write-back failed for %s: %s",
                                key, exc)
                    continue
                if corrected:
                    self.metrics.corrupt_shards.add(corrected)
                    event("scrub.corrupt", "error", key=key[:16],
                          shards=corrected, source="repair")
                self.metrics.repairs.add(1)
                repaired += 1
        return repaired

    # -------------------------------------------------- restore / verify

    def _fec(self, k: int, n: int, fieldname: str, code: str = "rs"):
        fkey = (k, n, fieldname, code)
        fec = self._fecs.get(fkey)
        if fec is None:
            from noise_ec_tpu_torch.codec.fec import FEC

            # The code kind IS the generator: an LRC stripe restores
            # through FEC over the same "lrc:<g>" matrix (no GRS form,
            # so correction runs the support-enumeration/subset tiers).
            # The host codec, as in the reference: the error-correcting
            # restore is a rare whole-stripe decode whose products run on
            # the native shim, not a device product moved to the host.
            fec = self._fecs[fkey] = FEC(
                k, n, field=fieldname, backend="numpy",
                matrix="cauchy" if code == "rs" else code,
            )
        return fec

    def repair_corrupt(self, key: str) -> bool:
        """Whole-stripe validation + correction: the scrubber sends
        parity-inconsistent stripes here. Error-correcting decode over
        every present shard, sender-signature check when the stripe
        carries one, then re-encode and rewrite whatever disagreed."""
        return self._restore(key) > 0

    def _restore(self, key: str) -> int:
        from noise_ec_tpu_torch.codec.fec import Share

        try:
            meta, shards, unverified = self.store.snapshot(key)
        except UnknownStripeError:
            return 0
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < meta.k:
            self.enqueue(key, "fetch")
            return 0
        fec = self._fec(meta.k, meta.n, meta.field, meta.code)
        with span("repair", key=key, kind="restore", **node_attrs()):
            try:
                data_full = fec.decode(
                    [Share(i, shards[i]) for i in present]
                )
            except Exception as exc:  # noqa: BLE001 — undecodable as-is
                self.metrics.failures.add(1)
                log.warning("restore decode failed for %s: %s", key, exc)
                self.enqueue(key, "fetch")
                return 0
            obj = data_full[: meta.object_len]
            if meta.sender_public_key:
                if not self._signature_ok(meta, obj):
                    self.metrics.failures.add(1)
                    log.warning(
                        "restore of %s decodes but fails the stored "
                        "sender signature; keeping slots unverified", key
                    )
                    self.enqueue(key, "fetch")
                    return 0
            elif len(present) == meta.k and unverified:
                # k mixed trusted/unverified shards, no redundancy and no
                # signature anchor: nothing vouches for the decode.
                self.metrics.failures.add(1)
                self.enqueue(key, "fetch")
                return 0
            rs = self.store.codec(meta.k, meta.n, meta.field, meta.code)
            stride = meta.shard_len // self._sym_dtype(meta.field).itemsize
            D = (
                np.frombuffer(data_full, dtype=np.uint8)
                .view(self._sym_dtype(meta.field))
                .reshape(meta.k, stride)
            )
            truth = [
                np.ascontiguousarray(row).view(np.uint8).tobytes()
                for row in rs.encode(list(D))
            ]
            fixed = {
                i: truth[i]
                for i in range(meta.n)
                if shards[i] != truth[i]
            }
            corrupt = sum(
                1 for i in fixed if shards[i] is not None
            )
            try:
                if fixed:
                    self.store.write_repaired(key, fixed)
                self.store.mark_trusted(key, range(meta.n))
            except (UnknownStripeError, ValueError) as exc:
                self.metrics.failures.add(1)
                log.warning("restore write-back failed for %s: %s", key, exc)
                return 0
            if corrupt:
                self.metrics.corrupt_shards.add(corrupt)
                event("scrub.corrupt", "error", key=key[:16],
                      shards=corrupt, source="restore")
            self.metrics.repairs.add(1)
        return 1

    def _signature_ok(self, meta, obj: bytes) -> bool:
        from noise_ec_tpu_torch.host.crypto import (
            Blake2bPolicy,
            Ed25519Policy,
            PeerID,
            serialize_message,
            verify,
        )

        try:
            return verify(
                Ed25519Policy(),
                Blake2bPolicy(),
                meta.sender_public_key,
                serialize_message(
                    PeerID.create(
                        meta.sender_address, meta.sender_public_key
                    ),
                    obj,
                ),
                meta.file_signature,
            )
        # noise-ec: allow(event-on-swallow) — malformed stored identity — treated as non-origin, nothing to report
        except Exception:  # noqa: BLE001 — malformed stored identity
            return False

    # ------------------------------------------------------ anti-entropy

    def _broadcast_shards(self, meta, shards, numbers) -> int:
        sent = 0
        for i in numbers:
            if shards[i] is None:
                continue
            self.network.broadcast(Shard(
                file_signature=meta.file_signature,
                shard_data=shards[i],
                shard_number=i,
                total_shards=meta.n,
                minimum_needed_shards=meta.k,
            ))
            sent += 1
        return sent

    def _fetch(self, key: str) -> None:
        """Anti-entropy request: re-broadcast our surviving trusted
        shards over the plain SHARD opcode. Peers holding the stripe see
        shards they already have, which is the interest signal their
        engine answers (``respond``); their shards then heal us via the
        absorb path."""
        if self.network is None:
            return
        peers = getattr(self.network, "peers", None)
        if peers is not None and not peers:
            # Nobody to ask yet (startup races peer registration): do NOT
            # burn the per-key rate-limit window on a broadcast to zero
            # peers — the next scrub cycle re-enqueues the fetch and it
            # goes out once a peer registers.
            return
        now = time.monotonic()
        with self._lock:
            last = self._last_fetch.get(key)
            if (
                last is not None
                and now - last < self.fetch_interval_seconds
            ):
                return
            self._last_fetch[key] = now
            while len(self._last_fetch) > 4096:
                self._last_fetch.popitem(last=False)
        try:
            meta, shards, unverified = self.store.snapshot(key)
        except UnknownStripeError:
            return
        trusted = [
            i for i, s in enumerate(shards)
            if s is not None and i not in unverified
        ]
        self._broadcast_shards(meta, shards, trusted)
        self.metrics.requests.add(1)
        log.info(
            "anti-entropy request for stripe %s (%d/%d trusted shards "
            "survive)", key, len(trusted), meta.n,
        )

    def announce_once(self) -> int:
        """Broadcast ONE trusted shard per recently stored stripe (see
        the ``announce_interval_seconds`` doc in ``__init__``). Returns
        the number of stripes announced. Deterministic entry point for
        tests; the background thread calls it on the interval."""
        if self.network is None:
            return 0
        peers = getattr(self.network, "peers", None)
        if peers is not None and not peers:
            return 0  # nobody listening; the next interval retries
        announced = 0
        # Follow the cursor to the END of the recency window: one page
        # per recent_keys call (the per-page cap keeps each store-lock
        # hold bounded), but a store with more than announce_max_stripes
        # fresh stripes announces ALL of them, not just page 1.
        recent: list = []
        cursor = None
        while True:
            page, cursor = self.store.recent_keys(
                self.announce_window_seconds,
                self.announce_max_stripes,
                cursor=cursor,
            )
            recent.extend(page)
            if cursor is None or not page:
                break
        # Pinned keys (namespace replication targets) ride every
        # announce beyond the recency window; dict.fromkeys dedups while
        # keeping the newest-first recents ahead of the standing set.
        for key in dict.fromkeys(list(recent) + self.pinned_keys()):
            try:
                meta, shards, unverified = self.store.snapshot(key)
            except UnknownStripeError:
                continue
            trusted = [
                i for i, s in enumerate(shards)
                if s is not None and i not in unverified
            ]
            if not trusted:
                continue
            self._broadcast_shards(meta, shards, trusted[:1])
            announced += 1
        if announced:
            self.metrics.announces.add(announced)
        for fn in list(self._announce_hooks):
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 — a piggyback must
                # not break the announce loop
                log.warning("announce hook failed: %s", exc)
        return announced

    def _respond(self, key: str) -> None:
        if self.network is None:
            return
        try:
            meta, shards, unverified = self.store.snapshot(key)
        except UnknownStripeError:
            return
        trusted = [
            i for i, s in enumerate(shards)
            if s is not None and i not in unverified
        ]
        if len(trusted) < meta.k:
            return  # we are the one needing help here
        sent = self._broadcast_shards(meta, shards, trusted)
        if sent:
            self.metrics.responses.add(1)
