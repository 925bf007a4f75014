"""Content-addressed stripe store with degraded reads and disk persistence.

A *stripe* is one object's full erasure-coded shard set plus geometry
metadata, addressed by the 16-hex signature prefix that obs tracing and
the plugin's pool keys already use (:func:`obs.trace.trace_key`). The
store is the durability layer the reference lacks: verified receives land
here instead of being dropped after reassembly, and the object stays
readable while up to n-k shards are missing (reconstructed on demand —
the degraded-read path).

Trust model (mirrors the plugin's): shards written by :meth:`put_object`
come from a signature-verified object and are *trusted*. Shards absorbed
from the wire (:meth:`note_shard`, the anti-entropy fill path) are
verified against the trusted remainder when >= k trusted shards exist
(reconstruct-and-compare); otherwise they are held *unverified* until the
repair engine can validate the whole stripe (error-correcting decode,
plus the stored sender signature when available). Degraded reads use
trusted shards only.

Port of ``noise_ec_tpu.store.stripe``. Every codec of a store runs on
``device`` ("cuda" unless the caller asks for "cpu") on the ``device``
backend by default (the reference defaults to ``backend="numpy"``): a
store's encodes, degraded reads, scrub verifies and batched repairs are
products on the card, and a store built where there is no card raises at
its first codec. ``backend="numpy"`` keeps the host codec (the native
shim). Keys, ``<key>/meta.json`` fields and ``shard.NNN`` files are the
reference's, so either package loads the other's store directory.

Thread safety: one lock guards the stripe table and every stripe
mutation; codec construction happens outside it. Disk writes are atomic
(tmp + rename) so a torn write can never leave a wrong-content shard
under a content-derived name.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np

from noise_ec_tpu_torch.codec.lrc import codec_for_code, parse_code
from noise_ec_tpu_torch.codec.rs import ReedSolomon
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import trace_key

__all__ = [
    "DegradedReadError",
    "StripeMeta",
    "StripeStore",
    "UnknownStripeError",
]

log = logging.getLogger("noise_ec_tpu_torch.store")

_FIELD_SYM = {"gf256": 1, "gf65536": 2}

# Manifest addresses are content hashes (hex); validated before they
# become file names under <store_dir>/_manifests/.
_MANIFEST_DIR = "_manifests"
_ADDRESS_RE = re.compile(r"^[0-9a-f]{8,128}$")


class UnknownStripeError(KeyError):
    """No stripe under this key."""


class DegradedReadError(RuntimeError):
    """Fewer than k trusted shards survive: the object cannot be served
    locally. The repair engine's anti-entropy fetch is the recovery path."""


@dataclass
class StripeMeta:
    """Geometry + identity metadata for one stripe (persisted as JSON)."""

    file_signature: bytes
    k: int
    n: int
    shard_len: int
    object_len: int
    field: str = "gf256"
    # Codec kind: "rs" (default) or "lrc:<g>" (docs/lrc.md — g local
    # parity groups inside the n-k parity budget). The code travels with
    # the stripe so every reader (degraded read, scrub verify, repair,
    # conversion) rebuilds the SAME generator.
    code: str = "rs"
    # Sender identity captured at put time: lets the repair engine verify
    # an error-corrected restore against the object signature, the same
    # end-to-end anchor the plugin's receive path uses. Optional — a
    # stripe stored outside the plugin path has no sender.
    sender_address: str = ""
    sender_public_key: bytes = b""

    @property
    def key(self) -> str:
        return trace_key(self.file_signature)


@dataclass
class _Stripe:
    meta: StripeMeta
    shards: list  # Optional[bytes] per slot, length n
    unverified: set = field(default_factory=set)  # slot numbers
    # Local arrival time (monotonic): drives the repair engine's
    # anti-entropy ANNOUNCE of recently stored stripes. Stripes loaded
    # from disk stamp load time — after a restart they ARE news to peers
    # that churned while we were down.
    created_at: float = field(default_factory=time.monotonic)
    # Placement-born (docs/placement.md): the entry was CREATED by a
    # targeted placement shard, not a local put or an announced
    # interest. ``note_shard`` absorbs into such stripes ADDITIVELY
    # (returns False so the plugin's pool still sees broadcast
    # traffic) — consuming would starve the reassembly pool of any
    # stripe whose early slots land in this node's failure domain.
    placement: bool = False

    def present(self) -> list[int]:
        return [i for i, s in enumerate(self.shards) if s is not None]

    def trusted(self) -> list[int]:
        return [
            i for i, s in enumerate(self.shards)
            if s is not None and i not in self.unverified
        ]


class _StoreMetrics:
    """Cached registry children for the store metric family (resolved
    once; the scrub/repair loops record per stripe)."""

    _instances: "weakref.WeakSet[StripeStore]" = weakref.WeakSet()

    def __init__(self):
        reg = default_registry()
        self.degraded_reads = reg.counter(
            "noise_ec_store_degraded_reads_total"
        ).labels()
        self.absorbed = reg.counter(
            "noise_ec_store_absorbed_shards_total"
        ).labels()
        self.absorb_rejected = reg.counter(
            "noise_ec_store_absorb_rejected_total"
        ).labels()
        cls = _StoreMetrics
        # Re-registered on every construction (idempotent — the closures
        # read the CLASS WeakSet): the test-isolation registry reset
        # drops callback children, and a once-guard would leave the
        # gauges dead for the rest of the process.
        reg.gauge("noise_ec_store_stripes").set_callback(
            lambda: sum(len(s) for s in list(cls._instances))
        )
        reg.gauge("noise_ec_store_shard_bytes").set_callback(
            lambda: sum(s.shard_bytes for s in list(cls._instances))
        )


class StripeStore:
    """Content-addressed stripe store (see module docstring).

    ``store_dir=None`` keeps stripes in memory only; with a directory,
    every stripe persists as ``<dir>/<key>/meta.json`` + per-shard files
    and :meth:`load` (called from ``__init__``) restores them on startup.
    Codecs run on ``device`` with the ``device`` backend unless told
    otherwise (module docstring).
    """

    def __init__(
        self,
        store_dir: Optional[str] = None,
        *,
        backend: str = "device",
        device: str = "cuda",
        max_stripes: int = 65536,
    ):
        self.store_dir = store_dir
        self.backend = backend
        self.device = device
        self.max_stripes = max_stripes
        self._lock = threading.Lock()
        self._stripes: dict[str, _Stripe] = {}
        # Object manifests (service/objects.py): content address ->
        # manifest document. The stripe table holds codewords; this
        # table holds the object layer's map from an object to its
        # ordered stripe keys + geometry + size, persisted alongside
        # the stripes so a restart restores the whole object space.
        self._manifests: dict[str, dict] = {}
        # Put listeners: called (key, data, meta) after every successful
        # put_object — the object service absorbs replicated manifests
        # through this hook (a verified receive lands here via the
        # plugin before any listener sees it).
        self._put_listeners: list[Callable] = []
        # Delete listeners: called (key) after a stripe is evicted — the
        # object service's decoded cache drops the RAM copy of a stripe
        # the store no longer backs.
        self._delete_listeners: list[Callable] = []
        self._codecs: dict[tuple[int, int, str, str], ReedSolomon] = {}
        self._codec_lock = threading.Lock()
        self.shard_bytes = 0
        # The repair engine registers itself so note_shard can classify
        # newly fillable stripes and surface remote interest; weakref so
        # a dropped engine cannot pin the store (or vice versa).
        self._engine = lambda: None
        self._metrics = _StoreMetrics()
        _StoreMetrics._instances.add(self)
        if store_dir:
            os.makedirs(store_dir, exist_ok=True)
            self.load()

    # ------------------------------------------------------------- codecs

    def codec(
        self, k: int, n: int, field: str = "gf256", code: str = "rs"
    ) -> ReedSolomon:
        ckey = (k, n, field, code)
        with self._codec_lock:
            rs = self._codecs.get(ckey)
            if rs is not None:
                return rs
        rs = codec_for_code(code, k, n, field=field, backend=self.backend,
                            device=self.device)
        with self._codec_lock:
            return self._codecs.setdefault(ckey, rs)

    def bind_engine(self, engine) -> None:
        self._engine = weakref.ref(engine)

    def add_put_listener(self, fn: Callable) -> None:
        """Register ``fn(key, data, meta)`` to run after every successful
        :meth:`put_object` (outside the store lock; exceptions are logged,
        never raised — a listener must not break the put path)."""
        self._put_listeners.append(fn)

    def add_delete_listener(self, fn: Callable) -> None:
        """Register ``fn(key)`` to run after every successful
        :meth:`evict` (outside the store lock; exceptions are logged,
        never raised — same contract as the put listeners)."""
        self._delete_listeners.append(fn)

    # ------------------------------------------------------------ writes

    def put_object(
        self,
        file_signature: bytes,
        data: bytes,
        k: int,
        n: int,
        *,
        field: str = "gf256",
        code: str = "rs",
        sender_address: str = "",
        sender_public_key: bytes = b"",
    ) -> str:
        """Encode a (verified) object into a full trusted stripe; returns
        the store key. Re-putting the same key replaces the stripe — the
        put path only ever runs on signature-verified bytes, so the
        replacement is at worst identical. ``code`` selects the codec
        kind ("rs" or "lrc:<g>" — the archival tier's geometry)."""
        if not data:
            raise ValueError("cannot store an empty object")
        if not 1 <= k <= n:
            raise ValueError(f"invalid geometry k={k} n={n}")
        parse_code(code)  # reject unknown kinds before any encode
        rs = self.codec(k, n, field, code)
        shards = [
            np.ascontiguousarray(s).view(np.uint8).tobytes()
            for s in rs.encode(rs.split(data))
        ]
        meta = StripeMeta(
            file_signature=bytes(file_signature),
            k=k,
            n=n,
            shard_len=len(shards[0]),
            object_len=len(data),
            field=field,
            code=code,
            sender_address=sender_address,
            sender_public_key=bytes(sender_public_key),
        )
        stripe = _Stripe(meta=meta, shards=list(shards))
        with self._lock:
            if (
                meta.key not in self._stripes
                and len(self._stripes) >= self.max_stripes
            ):
                raise RuntimeError(
                    f"stripe store full ({self.max_stripes} stripes)"
                )
            self._replace_locked(meta.key, stripe)
        self._persist_stripe(stripe)
        for fn in list(self._put_listeners):
            try:
                fn(meta.key, data, meta)
            except Exception as exc:  # noqa: BLE001 — advisory hook only
                log.warning("store put listener failed for %s: %s",
                            meta.key, exc)
        return meta.key

    def write_repaired(
        self, key: str, repaired: dict[int, bytes], *, corrected: bool = False
    ) -> None:
        """Install repaired shard bytes as trusted slots (repair engine
        write-back). ``corrected`` marks overwrites of previously-present
        shards (corruption fixes) as opposed to hole fills."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                raise UnknownStripeError(key)
            for num, blob in repaired.items():
                if not 0 <= num < stripe.meta.n:
                    raise ValueError(f"shard number {num} out of range")
                if len(blob) != stripe.meta.shard_len:
                    raise ValueError(
                        f"repaired shard {num} length {len(blob)} != "
                        f"{stripe.meta.shard_len}"
                    )
                if stripe.shards[num] is None:
                    self.shard_bytes += len(blob)
                stripe.shards[num] = bytes(blob)
                stripe.unverified.discard(num)
        for num in repaired:
            self._persist_shard(key, num)

    def mark_trusted(self, key: str, numbers: Iterable[int]) -> None:
        """Clear the unverified flag (repair engine: whole-stripe
        validation succeeded for these slots as-is)."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                raise UnknownStripeError(key)
            for num in numbers:
                stripe.unverified.discard(num)
        self._persist_meta(key)

    def drop_shard(self, key: str, number: int) -> bool:
        """Remove one shard (device loss / test fault injection)."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None or stripe.shards[number] is None:
                return False
            self.shard_bytes -= len(stripe.shards[number])
            stripe.shards[number] = None
            stripe.unverified.discard(number)
        if self.store_dir:
            try:
                os.unlink(self._shard_path(key, number))
            except OSError:
                pass
        return True

    def corrupt_shard(self, key: str, number: int, mutate: Callable) -> bool:
        """Apply ``mutate(bytes) -> bytes`` to a stored shard in place —
        the test hook the scrub story is exercised through (pairs with
        ``FaultInjector.apply``). Returns False if the shard is absent."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None or stripe.shards[number] is None:
                return False
            old = stripe.shards[number]
            new = bytes(mutate(old))
            if len(new) != len(old):
                raise ValueError("corruption must preserve shard length")
            stripe.shards[number] = new
        self._persist_shard(key, number)
        return True

    def evict(self, key: str) -> bool:
        with self._lock:
            stripe = self._stripes.pop(key, None)
            if stripe is None:
                return False
            self.shard_bytes -= sum(
                len(s) for s in stripe.shards if s is not None
            )
        if self.store_dir:
            self._rmtree_stripe(key)
        for fn in list(self._delete_listeners):
            try:
                fn(key)
            except Exception as exc:  # noqa: BLE001 — advisory hook only
                log.warning("store delete listener failed for %s: %s",
                            key, exc)
        return True

    def _replace_locked(self, key: str, stripe: _Stripe) -> None:
        old = self._stripes.get(key)
        if old is not None:
            self.shard_bytes -= sum(
                len(s) for s in old.shards if s is not None
            )
        self._stripes[key] = stripe
        self.shard_bytes += sum(
            len(s) for s in stripe.shards if s is not None
        )

    # ------------------------------------------------------------- reads

    def __len__(self) -> int:
        with self._lock:
            return len(self._stripes)

    def recent_keys(
        self,
        window_seconds: float,
        limit: int = 64,
        cursor: Optional[str] = None,
    ) -> tuple[list[str], Optional[str]]:
        """One page of keys of stripes stored within the last
        ``window_seconds``, newest first: ``(keys, next_cursor)``.

        Pass the returned opaque ``next_cursor`` back to continue the
        walk; ``None`` means the window is exhausted. A single-shot
        caller (the announce loop's capped working set) just takes the
        first page — but a LIST-style consumer can now iterate a large
        store page by page instead of forcing one unbounded snapshot.
        A stripe stored *while* paging appears at the front of a fresh
        walk, never in the middle of an in-flight one (the cursor orders
        strictly backward in arrival time)."""
        cutoff = time.monotonic() - window_seconds
        with self._lock:
            fresh = [
                (s.created_at, key)
                for key, s in self._stripes.items()
                if s.created_at >= cutoff
            ]
        fresh.sort(reverse=True)
        if cursor is not None:
            try:
                ts_text, _, ckey = cursor.partition(":")
                pos = (float(ts_text), ckey)
            except ValueError:
                raise ValueError(f"bad recent_keys cursor {cursor!r}")
            fresh = [entry for entry in fresh if entry < pos]
        page = fresh[:limit]
        next_cursor = (
            f"{page[-1][0]!r}:{page[-1][1]}" if len(fresh) > limit else None
        )
        return [key for _, key in page], next_cursor

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._stripes)

    # ---------------------------------------------------------- manifests

    def put_manifest(self, address: str, doc: dict) -> None:
        """Store an object manifest under its content ``address`` (the
        object service's map from one object to its ordered stripe keys
        + geometry + size — docs/object-service.md). Re-putting replaces;
        persisted under ``<store_dir>/_manifests/<address>.json``."""
        if not _ADDRESS_RE.match(address):
            raise ValueError(f"bad manifest address {address!r}")
        with self._lock:
            self._manifests[address] = dict(doc)
        if self.store_dir:
            d = os.path.join(self.store_dir, _MANIFEST_DIR)
            os.makedirs(d, exist_ok=True)
            self._atomic_write(
                os.path.join(d, f"{address}.json"),
                json.dumps(doc).encode(),
            )

    def get_manifest(self, address: str) -> Optional[dict]:
        with self._lock:
            doc = self._manifests.get(address)
            return dict(doc) if doc is not None else None

    def delete_manifest(self, address: str) -> bool:
        with self._lock:
            found = self._manifests.pop(address, None) is not None
        if found and self.store_dir and _ADDRESS_RE.match(address):
            try:
                os.unlink(
                    os.path.join(self.store_dir, _MANIFEST_DIR,
                                 f"{address}.json")
                )
            except OSError:
                pass
        return found

    def manifest_count(self) -> int:
        with self._lock:
            return len(self._manifests)

    def list_manifests(
        self, *, cursor: Optional[str] = None, limit: int = 64
    ) -> tuple[list[tuple[str, dict]], Optional[str]]:
        """One page of ``(address, manifest)`` pairs in address order:
        ``(page, next_cursor)`` — the same cursor contract as
        :meth:`recent_keys` (``None`` = exhausted; the cursor is the last
        address served, iteration resumes strictly after it)."""
        with self._lock:
            addresses = sorted(self._manifests)
            if cursor is not None:
                addresses = [a for a in addresses if a > cursor]
            page = addresses[:limit]
            out = [(a, dict(self._manifests[a])) for a in page]
        next_cursor = page[-1] if len(addresses) > limit else None
        return out, next_cursor

    def meta(self, key: str) -> StripeMeta:
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                raise UnknownStripeError(key)
            return stripe.meta

    def status(self, key: str) -> dict:
        """Snapshot of one stripe's health (counts + slot lists)."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                raise UnknownStripeError(key)
            present = stripe.present()
            trusted = stripe.trusted()
            return {
                "k": stripe.meta.k,
                "n": stripe.meta.n,
                "code": stripe.meta.code,
                "present": present,
                "trusted": trusted,
                "unverified": sorted(stripe.unverified),
                "missing": [
                    i for i in range(stripe.meta.n) if i not in present
                ],
            }

    def snapshot(self, key: str) -> tuple[StripeMeta, list, set]:
        """(meta, shard list copy, unverified copy) under the lock —
        what the scrubber and repair engine work from."""
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                raise UnknownStripeError(key)
            return stripe.meta, list(stripe.shards), set(stripe.unverified)

    def snapshot_many(
        self, keys: Iterable[str]
    ) -> dict[str, tuple[StripeMeta, list, set]]:
        """:meth:`snapshot` for a whole key set under ONE lock
        acquisition — the object service's GET path snapshots the
        stripes of a request at once instead of re-taking the store
        lock per stripe. Keys not held are simply absent from the
        result (the caller's per-stripe miss path handles them)."""
        out: dict[str, tuple[StripeMeta, list, set]] = {}
        with self._lock:
            for key in keys:
                stripe = self._stripes.get(key)
                if stripe is not None:
                    out[key] = (
                        stripe.meta, list(stripe.shards),
                        set(stripe.unverified),
                    )
        return out

    def read(self, key: str) -> bytes:
        """Serve the object byte-identically from whatever trusted shards
        survive (the degraded-read API). With the k data shards present
        this is a join; with any k-of-n trusted subset the missing data
        shards are reconstructed on demand through the codec backend.
        Raises :class:`DegradedReadError` below k trusted shards."""
        meta, shards, unverified = self.snapshot(key)
        k = meta.k
        usable = [
            s if (s is not None and i not in unverified) else None
            for i, s in enumerate(shards)
        ]
        if all(usable[i] is not None for i in range(k)):
            blob = b"".join(usable[:k])
            return blob[: meta.object_len]
        trusted = [i for i, s in enumerate(usable) if s is not None]
        if len(trusted) < k:
            raise DegradedReadError(
                f"stripe {key} has {len(trusted)} trusted shards, "
                f"need {k}"
            )
        self._metrics.degraded_reads.add(1)
        rs = self.codec(k, meta.n, meta.field, meta.code)
        full = rs.reconstruct_data(usable)
        return rs.join(full, meta.object_len)

    def classify(self, key: str) -> Optional[str]:
        """Repair-need classification for one stripe:

        - ``None`` — fully present, all trusted (verify is scrub's job);
        - ``"missing"`` — >= k trusted, but holes or unverified slots:
          locally reconstructable from the trusted basis;
        - ``"restore"`` — < k trusted but >= k present including
          unverified: needs the error-correcting whole-stripe decode;
        - ``"fetch"`` — < k present: only peers can help (anti-entropy).
        """
        meta, shards, unverified = self.snapshot(key)
        present = [i for i, s in enumerate(shards) if s is not None]
        trusted = [i for i in present if i not in unverified]
        if len(trusted) == meta.n:
            return None
        if len(trusted) >= meta.k:
            return "missing"
        if len(present) >= meta.k:
            return "restore"
        return "fetch"

    # ----------------------------------------------------- wire absorb

    def note_shard(self, msg) -> bool:
        """Feed one arriving wire shard (a ``host.wire.Shard``) to the
        store — the plugin calls this for every delivery when a store is
        wired in. Two jobs:

        - *absorb*: if the shard names a stripe we hold with that slot
          empty, verify it against >= k trusted shards
          (reconstruct-and-compare) and fill the hole; below k trusted it
          is held unverified for the repair engine's whole-stripe
          validation. This is how anti-entropy responses (and plain
          re-broadcasts) heal local stripes without a decode.
        - *interest*: notify the repair engine that a peer is moving
          shards of a stripe we hold — if we are healthy and the traffic
          is an anti-entropy request, the engine answers with our shards.

        Returns True iff the shard was *consumed* (absorbed, matched a
        stored duplicate, or rejected as inconsistent with the verified
        stripe) — the plugin then skips the pool/decode path: the object
        is already durable here. Placement-born stripes absorb
        ADDITIVELY instead (stored but False — see ``_Stripe.placement``)
        so broadcast stripes still complete through the pool. Never
        raises: a store problem must not break plugin delivery.
        """
        try:
            return self._note_shard(msg, additive=True)
        except Exception as exc:  # noqa: BLE001 — advisory path only
            log.warning("store note_shard failed: %s", exc)
            return False

    def _note_shard(self, msg, *, additive: bool = False) -> bool:
        key = trace_key(msg.file_signature)
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                return False
            meta = stripe.meta
            num = int(msg.shard_number)
            if (
                bytes(msg.file_signature) != meta.file_signature
                or int(msg.minimum_needed_shards) != meta.k
                or int(msg.total_shards) != meta.n
                or not 0 <= num < meta.n
                or len(msg.shard_data) != meta.shard_len
                or getattr(msg, "stream_chunk_count", 0)
            ):
                engine = self._engine()
                if engine is not None:
                    engine.on_remote_interest(key)
                return False
            slot_empty = stripe.shards[num] is None
            duplicate = (
                not slot_empty and stripe.shards[num] == bytes(msg.shard_data)
            )
            shards = list(stripe.shards)
            unverified = set(stripe.unverified)
            # additive=True + placement-born: store the shard but report
            # False so the pool path still runs (docstring).
            pass_through = additive and stripe.placement
        engine = self._engine()
        if not slot_empty:
            # A shard we already hold: the interest signal anti-entropy
            # requests ride on. A DIFFERING copy of an occupied slot is
            # not consumed — the normal pool path keeps its evidence (and
            # scrub adjudicates our own copy against parity).
            if engine is not None:
                engine.on_remote_interest(key)
            return duplicate and not pass_through
        blob = bytes(msg.shard_data)
        trusted = [
            i for i, s in enumerate(shards)
            if s is not None and i not in unverified
        ]
        if len(trusted) >= meta.k:
            rs = self.codec(meta.k, meta.n, meta.field, meta.code)
            usable = [
                shards[i] if i in trusted else None for i in range(meta.n)
            ]
            want = rs.reconstruct_some(
                usable, [i == num for i in range(meta.n)]
            )[num]
            if np.ascontiguousarray(want).view(np.uint8).tobytes() != blob:
                # Inconsistent with the verified stripe: drop it here —
                # the stripe already vouches for the object, so the bad
                # copy must not reach the pool either.
                self._metrics.absorb_rejected.add(1)
                return True
            accepted_unverified = False
        else:
            accepted_unverified = True
        with self._lock:
            stripe = self._stripes.get(key)
            if (
                stripe is None
                or stripe.meta is not meta
                or stripe.shards[num] is not None
            ):
                return False
            stripe.shards[num] = blob
            if accepted_unverified:
                stripe.unverified.add(num)
            self.shard_bytes += len(blob)
        self._metrics.absorbed.add(1)
        self._persist_shard(key, num)
        if engine is not None:
            engine.enqueue_auto(key)
        return not pass_through

    def note_placement_shard(self, msg) -> bool:
        """Absorb a TARGETED placement shard (docs/placement.md) — a
        shard the placement ring routed to this node even though no
        local stripe anchors it yet. Unlike :meth:`note_shard`, an
        unknown key CREATES the stripe entry: meta derives from the
        wire geometry (``object_len = k * shard_len`` — the padded
        capacity; the manifest carries the logical size) and the slot
        lands unverified until >= k shards accumulate and the repair
        engine (or a gather's reconstruct-and-compare) vouches for it.
        Known keys delegate to the normal absorb. Advisory like
        ``note_shard``: never raises, True iff the shard was stored or
        rejected against a verified stripe."""
        try:
            with self._lock:
                known = trace_key(msg.file_signature) in self._stripes
            if known:
                return self._note_shard(msg)
            return self._note_placement_shard(msg)
        except Exception as exc:  # noqa: BLE001 — advisory path only
            log.warning("store note_placement_shard failed: %s", exc)
            return False

    def _note_placement_shard(self, msg) -> bool:
        k = int(msg.minimum_needed_shards)
        n = int(msg.total_shards)
        num = int(msg.shard_number)
        blob = bytes(msg.shard_data)
        if (
            not 1 <= k <= n
            or not 0 <= num < n
            or not blob
            or getattr(msg, "stream_chunk_count", 0)
        ):
            return False
        meta = StripeMeta(
            file_signature=bytes(msg.file_signature),
            k=k,
            n=n,
            shard_len=len(blob),
            object_len=k * len(blob),
            field="gf256",
        )
        stripe = _Stripe(
            meta=meta,
            shards=[blob if i == num else None for i in range(n)],
            unverified={num},
            placement=True,
        )
        stored = False
        with self._lock:
            if meta.key in self._stripes:
                # Raced with another arrival: fall through to absorb.
                pass
            elif len(self._stripes) >= self.max_stripes:
                return False
            else:
                self._stripes[meta.key] = stripe
                self.shard_bytes += len(blob)
                self._metrics.absorbed.add(1)
                stored = True
        if not stored:
            return self._note_shard(msg)
        # Persist and enqueue OUTSIDE the lock: both re-enter it
        # (snapshot / classify), and self._lock is not reentrant.
        self._persist_stripe(stripe)
        engine = self._engine()
        if engine is not None:
            engine.enqueue_auto(meta.key)
        return True

    # ------------------------------------------------------- persistence

    def _stripe_dir(self, key: str) -> str:
        return os.path.join(self.store_dir, key)

    def _shard_path(self, key: str, num: int) -> str:
        return os.path.join(self._stripe_dir(key), f"shard.{num:03d}")

    @staticmethod
    def _atomic_write(path: str, blob: bytes) -> None:
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    def _persist_stripe(self, stripe: _Stripe) -> None:
        if not self.store_dir:
            return
        key = stripe.meta.key
        os.makedirs(self._stripe_dir(key), exist_ok=True)
        self._persist_meta(key)
        with self._lock:
            live = self._stripes.get(key)
            shards = list(live.shards) if live is not None else []
        for num, blob in enumerate(shards):
            if blob is not None:
                self._atomic_write(self._shard_path(key, num), blob)

    def _persist_meta(self, key: str) -> None:
        if not self.store_dir:
            return
        with self._lock:
            stripe = self._stripes.get(key)
            if stripe is None:
                return
            m = stripe.meta
            doc = {
                "file_signature": m.file_signature.hex(),
                "k": m.k,
                "n": m.n,
                "shard_len": m.shard_len,
                "object_len": m.object_len,
                "field": m.field,
                "code": m.code,
                "sender_address": m.sender_address,
                "sender_public_key": m.sender_public_key.hex(),
                "unverified": sorted(stripe.unverified),
                "placement": stripe.placement,
            }
        os.makedirs(self._stripe_dir(key), exist_ok=True)
        self._atomic_write(
            os.path.join(self._stripe_dir(key), "meta.json"),
            json.dumps(doc).encode(),
        )

    def _persist_shard(self, key: str, num: int) -> None:
        if not self.store_dir:
            return
        with self._lock:
            stripe = self._stripes.get(key)
            blob = stripe.shards[num] if stripe is not None else None
        if blob is not None:
            os.makedirs(self._stripe_dir(key), exist_ok=True)
            self._atomic_write(self._shard_path(key, num), blob)
        self._persist_meta(key)

    def _rmtree_stripe(self, key: str) -> None:
        d = self._stripe_dir(key)
        try:
            for name in os.listdir(d):
                os.unlink(os.path.join(d, name))
            os.rmdir(d)
        except OSError:
            pass

    def load(self) -> int:
        """Restore stripes from ``store_dir``; returns the stripe count.
        A shard file whose length disagrees with the metadata is treated
        as missing (the scrubber will flag and repair it)."""
        if not self.store_dir:
            return 0
        loaded = 0
        for key in sorted(os.listdir(self.store_dir)):
            meta_path = os.path.join(self.store_dir, key, "meta.json")
            if not os.path.isfile(meta_path):
                continue
            try:
                with open(meta_path, "rb") as f:
                    doc = json.load(f)
                meta = StripeMeta(
                    file_signature=bytes.fromhex(doc["file_signature"]),
                    k=int(doc["k"]),
                    n=int(doc["n"]),
                    shard_len=int(doc["shard_len"]),
                    object_len=int(doc["object_len"]),
                    field=doc.get("field", "gf256"),
                    code=doc.get("code", "rs"),
                    sender_address=doc.get("sender_address", ""),
                    sender_public_key=bytes.fromhex(
                        doc.get("sender_public_key", "")
                    ),
                )
                parse_code(meta.code)
            except (ValueError, KeyError, json.JSONDecodeError) as exc:
                log.warning("skipping unreadable stripe %s: %s", key, exc)
                continue
            if meta.key != key or not 1 <= meta.k <= meta.n:
                log.warning("skipping inconsistent stripe dir %s", key)
                continue
            shards: list[Optional[bytes]] = [None] * meta.n
            for num in range(meta.n):
                try:
                    with open(self._shard_path(key, num), "rb") as f:
                        blob = f.read()
                except OSError:
                    continue
                if len(blob) == meta.shard_len:
                    shards[num] = blob
            stripe = _Stripe(
                meta=meta,
                shards=shards,
                unverified={
                    int(i) for i in doc.get("unverified", [])
                    if 0 <= int(i) < meta.n
                },
                placement=bool(doc.get("placement", False)),
            )
            with self._lock:
                self._replace_locked(key, stripe)
            loaded += 1
        manifest_dir = os.path.join(self.store_dir, _MANIFEST_DIR)
        if os.path.isdir(manifest_dir):
            for name in sorted(os.listdir(manifest_dir)):
                if not name.endswith(".json"):
                    continue
                address = name[: -len(".json")]
                if not _ADDRESS_RE.match(address):
                    continue
                try:
                    with open(os.path.join(manifest_dir, name), "rb") as f:
                        doc = json.load(f)
                except (OSError, json.JSONDecodeError) as exc:
                    log.warning("skipping unreadable manifest %s: %s",
                                address, exc)
                    continue
                if isinstance(doc, dict):
                    with self._lock:
                        self._manifests[address] = doc
        return loaded

    def close(self) -> None:
        """Flush nothing (writes are synchronous); kept for symmetry with
        the scrubber/engine lifecycle in cli.py."""
