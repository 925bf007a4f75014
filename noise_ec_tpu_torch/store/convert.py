"""Hot→archival code conversion: merge cold narrow stripes into wide
ones as objects cool (docs/lrc.md).

Hot writes land as narrow RS stripes (fast to encode, cheap to repair
at small k); archival storage wants wide geometries — RS(200, 56) or an
LRC — whose lower overhead the panel kernels made computationally free.
Convertible codes (Maturana & Rashmi) are the theory; this module is the
operational loop:

- :class:`ConversionPolicy` — the per-tenant policy grammar
  (``service/tenants.py`` ``policy`` field, validated at configure
  time): ``archive=lrc:K/G+R`` or ``archive=rs:K+R`` names the archival
  tier and geometry, ``age=SECONDS`` the cold threshold,
  ``stripe_bytes=B`` the archival stripe capacity. Unknown tier names
  and invalid LRC geometries (group count must divide k; >= 1 global
  parity) are rejected with clear ``ValueError``\\ s when the policy is
  parsed, never at conversion time.

- :class:`ConversionEngine` — a background loop (or a deterministic
  :meth:`run_cycle`) that walks the manifest table, picks objects that
  are *cold* (manifest age past the policy threshold AND the address
  not touched in the decoded-object cache within that same threshold —
  recency-bounded, since residency in an idle LRU is not warmth) and
  converts them:

  1. **gather** — source logical bytes come decode-free where a source
     stripe's k data shards are all trusted (a join, no field ops);
     degraded source stripes group by erasure pattern and rebuild
     through ONE batched device dispatch per pattern
     (``reconstruction_matrix`` + ``matmul_many`` — the repair engine's
     shape, riding the same coalescer/DeviceGate path);
  2. **verify** — the gathered bytes must re-hash to the manifest
     address (the uploader's content anchor), so a conversion can never
     silently launder corruption across tiers;
  3. **re-encode** — the bytes re-chunk at the archival capacity and
     encode through ``StripeStore.put_object`` with the target code
     ("rs" or "lrc:<g>"), one device-dispatched encode per stripe;
     stripe signatures are derived deterministically from (address,
     capacity, code, index), so a crashed conversion re-runs
     idempotently;
  4. **swap** — ONE atomic manifest write (tmp + rename) repoints the
     object at the archival generation. Before the swap every read
     serves the hot generation; after it, the archival one — at no
     instant does the manifest reference an incomplete generation,
     which is the crash-consistency contract the conversion e2e test
     pins (kill before the swap: hot generation intact, re-run
     converts; kill after: archival generation serves, re-run GCs);
  5. **GC** — source stripes no other manifest references are evicted
     (and unpinned from the announce loop); the decoded cache drops the
     address (stripe indexing changed with the capacity).

Scope: conversion is a *local* generation change — the manifest address
(and therefore the object's bytes) is unchanged, so peers holding the
hot generation keep serving it byte-identically; each holder applies
its own tenant policy. Replicating archival stripes across the fleet is
future work (docs/lrc.md).
"""

from __future__ import annotations

import hashlib
import logging
import re
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from noise_ec_tpu_torch.obs.events import event
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import node_attrs, span
from noise_ec_tpu_torch.store.stripe import StripeStore

__all__ = [
    "ConversionEngine",
    "ConversionPolicy",
    "derive_stripe_sig",
    "finish_prev_stripes_gc",
    "split_qos",
]

log = logging.getLogger("noise_ec_tpu_torch.store")


def derive_stripe_sig(
    namespace: bytes, address: str, code: str, capacity: int, idx: int,
    *, salt: int = 0,
) -> bytes:
    """Deterministic generation-stripe signature: blake2b over
    (namespace, address, code, capacity, index[, salt]). The same
    inputs always reproduce the same key, which is what makes a
    crashed conversion/rebalance re-run idempotent — ``put_object``
    replacement lands on identical keys. ``salt`` (the placement
    epoch for rebalance moves) is omitted from the preimage when 0 so
    conversion signatures are byte-identical to the historical form."""
    return hashlib.blake2b(
        namespace + address.encode() + b"\0"
        + code.encode() + b"\0"
        + capacity.to_bytes(8, "little")
        + idx.to_bytes(8, "little")
        + (salt.to_bytes(8, "little") if salt else b""),
        digest_size=32,
    ).digest()


def finish_prev_stripes_gc(
    store: StripeStore, address: str, doc: dict, *, repair=None
) -> None:
    """Evict source stripes no surviving manifest references (the same
    refcount walk DELETE uses), unpin them from the announce loop, then
    clear the ``prev_stripes`` marker — the idempotent tail of a
    generation swap (conversion or placement rebalance), re-runnable
    after a crash."""
    old_keys = [str(s) for s in doc.get("prev_stripes") or ()]
    new_keys = {str(s) for s in doc.get("stripes") or ()}
    doomed = [k for k in dict.fromkeys(old_keys) if k not in new_keys]
    if doomed:
        refs: set = set()
        cursor = None
        while True:
            page, cursor = store.list_manifests(cursor=cursor, limit=256)
            for _, other in page:
                refs.update(str(s) for s in other.get("stripes") or ())
                ms = other.get("manifest_stripe")
                if ms:
                    refs.add(str(ms))
            if cursor is None:
                break
        doomed = [k for k in doomed if k not in refs]
        for key in doomed:
            store.evict(key)
        if doomed and repair is not None:
            repair.unpin_announce(doomed)
    done = dict(doc)
    done.pop("prev_stripes", None)
    store.put_manifest(address, done)

_FIELD_ORDER = {"gf256": 256, "gf65536": 65536}

# archive=lrc:K/G+R  |  archive=rs:K+R
_GEOMETRY_RE = re.compile(r"^([a-z0-9_]+):(\d+)(?:/(\d+))?\+(\d+)$")

# Tenant-policy QoS tokens (service/tenants.py grammar): ``lane=`` and
# ``weight=`` ride the SAME comma-separated policy string as
# ``archive=``/``age=`` but belong to the device-gate fairness layer
# (ops/dispatch.py), not conversion. The splitter lives here so both
# consumers — tenant configure-time validation and :meth:`policy_for`'s
# archival parse — share one tokenizer without a service<->store import
# cycle (tenants.py already imports this module lazily).
QOS_LANES = ("live", "background")
QOS_WEIGHT_MAX = 1000


def split_qos(text: str) -> tuple[str, int, str]:
    """Split the ``lane=``/``weight=`` QoS tokens out of a tenant policy
    string: ``(lane, weight, archival_rest)``. Raises ``ValueError`` for
    an unknown lane or a weight outside ``[1, QOS_WEIGHT_MAX]`` — the
    same configure-time contract as the archival grammar."""
    lane, weight = "live", 1
    rest: list[str] = []
    for raw in (text or "").split(","):
        tok = raw.strip()
        if not tok:
            continue
        key, _, val = tok.partition("=")
        key, val = key.strip(), val.strip()
        if key == "lane":
            if val not in QOS_LANES:
                raise ValueError(
                    f"unknown QoS lane {val!r} (lanes: "
                    f"{', '.join(QOS_LANES)})"
                )
            lane = val
        elif key == "weight":
            try:
                weight = int(val)
            except ValueError as exc:
                raise ValueError(
                    f"QoS weight {val!r} is not an integer"
                ) from exc
            if not 1 <= weight <= QOS_WEIGHT_MAX:
                raise ValueError(
                    f"QoS weight {weight} outside [1, {QOS_WEIGHT_MAX}]"
                )
        else:
            rest.append(tok)
    return lane, weight, ",".join(rest)


@dataclass(frozen=True)
class ConversionPolicy:
    """One tenant's archival policy (module docstring for the grammar)."""

    tier: str = "lrc"           # "rs" | "lrc"
    k: int = 0
    groups: int = 0             # LRC local groups (0 for rs)
    global_parities: int = 0
    age_seconds: float = 300.0
    stripe_bytes: int = 1 << 20
    field: str = "gf256"

    @property
    def n(self) -> int:
        return self.k + self.groups + self.global_parities

    @property
    def code(self) -> str:
        """The stripe-store code string of the archival tier."""
        return f"lrc:{self.groups}" if self.tier == "lrc" else "rs"

    @property
    def capacity(self) -> int:
        """Logical bytes per archival stripe (k-aligned, like the object
        layer's PUT capacity)."""
        return max(self.k, self.stripe_bytes - self.stripe_bytes % self.k)

    @classmethod
    def parse(cls, text: str) -> "ConversionPolicy":
        """Parse one policy string, e.g. ::

            archive=lrc:20/4+6,age=600,stripe_bytes=4194304

        Raises ``ValueError`` for unknown tiers, malformed geometry
        specs, LRC group counts that do not divide k, or a missing
        global parity — the tenant-configure-time contract."""
        kwargs: dict = {}
        saw_archive = False
        for raw in text.split(","):
            tok = raw.strip()
            if not tok:
                continue
            if "=" not in tok:
                raise ValueError(f"unparseable policy token {tok!r}")
            key, _, val = tok.partition("=")
            key, val = key.strip(), val.strip()
            if key == "archive":
                saw_archive = True
                m = _GEOMETRY_RE.match(val)
                if not m:
                    raise ValueError(
                        f"bad archival geometry {val!r} (want "
                        "'lrc:K/G+R' or 'rs:K+R')"
                    )
                tier, k, g, r = (
                    m.group(1), int(m.group(2)),
                    int(m.group(3)) if m.group(3) else 0, int(m.group(4)),
                )
                if tier not in ("rs", "lrc"):
                    raise ValueError(
                        f"unknown archival tier {tier!r} (known tiers: "
                        "lrc, rs)"
                    )
                if tier == "rs" and g:
                    raise ValueError(
                        f"rs geometry {val!r} takes no group count"
                    )
                if tier == "lrc" and not g:
                    raise ValueError(
                        f"lrc geometry {val!r} needs a group count "
                        "('lrc:K/G+R')"
                    )
                kwargs.update(
                    tier=tier, k=k, groups=g, global_parities=r
                )
            elif key == "age":
                kwargs["age_seconds"] = float(val)
            elif key == "stripe_bytes":
                kwargs["stripe_bytes"] = int(val)
            elif key == "field":
                if val not in _FIELD_ORDER:
                    raise ValueError(f"unknown field {val!r}")
                kwargs["field"] = val
            else:
                raise ValueError(f"unknown policy knob {key!r}")
        if not saw_archive:
            raise ValueError(
                "policy must name an archival tier (archive=lrc:K/G+R "
                "or archive=rs:K+R)"
            )
        pol = cls(**kwargs)
        pol.validate()
        return pol

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError(f"archival k must be >= 1, got {self.k}")
        if self.global_parities < 1:
            raise ValueError(
                f"archival tier needs >= 1 global parity, got "
                f"{self.global_parities}"
            )
        if self.tier == "lrc":
            if self.groups < 1:
                raise ValueError(
                    f"LRC group count must be >= 1, got {self.groups}"
                )
            if self.k % self.groups:
                raise ValueError(
                    f"LRC group count {self.groups} must divide "
                    f"k={self.k}"
                )
        elif self.groups:
            raise ValueError("rs tier takes no local groups")
        if self.n > _FIELD_ORDER[self.field]:
            raise ValueError(
                f"total shards {self.n} exceeds the {self.field} "
                f"field order"
            )
        if self.age_seconds < 0:
            raise ValueError(
                f"age must be >= 0, got {self.age_seconds}"
            )
        if self.stripe_bytes < self.k:
            raise ValueError(
                f"stripe_bytes {self.stripe_bytes} below k={self.k}"
            )


class _ConvertMetrics:
    def __init__(self):
        reg = default_registry()
        self.objects = {
            result: reg.counter(
                "noise_ec_convert_objects_total"
            ).labels(result=result)
            for result in ("converted", "failed")
        }
        self.bytes = reg.counter("noise_ec_convert_bytes_total").labels()
        self.stripes = {
            mode: reg.counter(
                "noise_ec_convert_stripes_total"
            ).labels(mode=mode)
            for mode in ("merge", "reconstruct")
        }
        self.seconds = reg.histogram("noise_ec_convert_seconds").labels()


class ConversionEngine:
    """Background hot→archival converter over one store (module doc).

    ``tenants`` supplies per-namespace policies; ``cache`` (optional)
    supplies the temperature signal and is invalidated on swap;
    ``repair`` (optional, the :class:`RepairEngine`) has GC'd source
    stripes unpinned from its announce loop."""

    def __init__(
        self,
        store: StripeStore,
        tenants,
        *,
        cache=None,
        repair=None,
        interval_seconds: float = 60.0,
        clock: Callable[[], float] = time.time,
    ):
        self.store = store
        self.tenants = tenants
        self.cache = cache
        self.repair = repair
        self.interval_seconds = interval_seconds
        self.clock = clock
        self._policies: dict[str, Optional[ConversionPolicy]] = {}
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # Crash-injection hooks (the conversion e2e test): each runs at
        # its boundary when set; raising simulates dying there.
        self.fault_before_swap: Optional[Callable[[], None]] = None
        self.fault_after_swap: Optional[Callable[[], None]] = None
        self._metrics = _ConvertMetrics()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="noise-ec-convert", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        from noise_ec_tpu_torch.ops.coalesce import qos_lane

        # Conversion decode/re-encode dispatches ride the device gate's
        # background lane (docs/object-service.md "QoS lanes").
        with qos_lane("background", tenant="convert"):
            while not self._closed:
                try:
                    self.run_cycle()
                except Exception as exc:  # noqa: BLE001 — keep converting
                    log.error("conversion cycle failed: %s", exc)
                self._wake.wait(self.interval_seconds)
                self._wake.clear()

    # ------------------------------------------------------------- policy

    def policy_for(self, tenant_name: str) -> Optional[ConversionPolicy]:
        """The tenant's parsed policy, or None (no policy / unknown
        tenant / unparseable — configure-time validation makes the last
        a should-not-happen, logged once)."""
        try:
            tenant = self.tenants.get(tenant_name)
        except KeyError:
            return None
        text = getattr(tenant, "policy", "") or ""
        if not text:
            return None
        if text not in self._policies:
            try:
                # QoS tokens (lane=, weight=) share the policy string but
                # configure the device-gate lanes, not conversion: strip
                # them before the archival parse. A policy that is ONLY
                # QoS tokens has no archival tier.
                archival = split_qos(text)[2]
                self._policies[text] = (
                    ConversionPolicy.parse(archival) if archival else None
                )
            except ValueError as exc:
                log.warning("ignoring bad policy %r: %s", text, exc)
                self._policies[text] = None
        return self._policies[text]

    # -------------------------------------------------------------- cycle

    def run_cycle(self) -> dict:
        """One manifest walk; returns counts for deterministic callers
        (tests, bench): {scanned, converted, failed, young, warm}."""
        stats = {"scanned": 0, "converted": 0, "failed": 0,
                 "young": 0, "warm": 0}
        now = self.clock()
        cursor = None
        while True:
            page, cursor = self.store.list_manifests(
                cursor=cursor, limit=256
            )
            for address, doc in page:
                stats["scanned"] += 1
                pol = self.policy_for(str(doc.get("tenant", "")))
                if pol is None:
                    continue
                if self._at_target(doc, pol):
                    if doc.get("prev_stripes"):
                        # A crash landed between the swap and GC: the
                        # archival generation serves; finish the GC.
                        self._finish_gc(address, doc)
                    continue
                if now - float(doc.get("created", now)) < pol.age_seconds:
                    stats["young"] += 1
                    continue
                if self.cache is not None and self.cache.warm(
                    address, within_seconds=pol.age_seconds
                ):
                    # Temperature: the address was READ within the cold
                    # threshold — converting it would evict the working
                    # set and re-chunk under its readers. Residency
                    # alone is not warmth (an idle LRU never expires),
                    # so the signal is recency-bounded by the policy's
                    # own age. Next cycle.
                    stats["warm"] += 1
                    continue
                if self.convert_object(doc):
                    stats["converted"] += 1
                else:
                    stats["failed"] += 1
            if cursor is None:
                break
        return stats

    @staticmethod
    def _at_target(doc: dict, pol: ConversionPolicy) -> bool:
        return (
            str(doc.get("code", "rs")) == pol.code
            and int(doc.get("k", 0)) == pol.k
            and int(doc.get("n", 0)) == pol.n
            and int(doc.get("stripe_bytes", 0)) == pol.capacity
            and str(doc.get("field", "gf256")) == pol.field
        )

    # ------------------------------------------------------------ convert

    def convert_object(self, doc: dict, pol: Optional[ConversionPolicy] = None) -> bool:
        """Convert one object to its tenant's archival tier (module
        docstring steps); returns True on success. Failures count and
        log, never raise — the loop must survive a sick object."""
        if pol is None:
            pol = self.policy_for(str(doc.get("tenant", "")))
            if pol is None:
                return False
        t0 = time.monotonic()
        address = str(doc["address"])
        try:
            with span("convert", address=address, tier=pol.code,
                      **node_attrs()):
                whole = self._gather(doc)
                if whole is None:
                    raise ValueError("source generation not readable")
                digest = hashlib.blake2b(digest_size=16)
                digest.update(
                    str(doc["tenant"]).encode() + b"\0"
                    + str(doc["name"]).encode() + b"\0"
                )
                digest.update(whole)
                if digest.hexdigest() != address:
                    raise ValueError(
                        "gathered bytes do not hash to the manifest "
                        "address — refusing to convert"
                    )
                new_keys = self._encode_generation(address, whole, pol)
                if self.fault_before_swap is not None:
                    self.fault_before_swap()
                old_keys = [str(s) for s in doc.get("stripes") or ()]
                new_doc = dict(doc)
                new_doc.update(
                    stripes=new_keys,
                    k=pol.k, n=pol.n, field=pol.field,
                    code=pol.code,
                    stripe_bytes=pol.capacity,
                    tier="archive",
                    converted=self.clock(),
                    # Source keys ride the manifest until GC completes,
                    # so a crash in the swap..GC window leaves a marker
                    # the next cycle converges on instead of orphaned
                    # stripes.
                    prev_stripes=old_keys,
                )
                # THE swap: one atomic manifest write. Every read
                # before this line serves the hot generation, every
                # read after it the archival one.
                self.store.put_manifest(address, new_doc)
                event("convert.swap", address=address[:16],
                      tier="archive", stripes=len(old_keys))
                if self.fault_after_swap is not None:
                    self.fault_after_swap()
                if self.cache is not None:
                    # Stripe indexing changed with the capacity; the
                    # address's cached entries map the OLD chunking.
                    self.cache.evict_address(address)
                self._finish_gc(address, new_doc)
        except Exception as exc:  # noqa: BLE001 — counted, not raised
            self._metrics.objects["failed"].add(1)
            log.warning("conversion of %s failed: %s", address, exc)
            return False
        self._metrics.objects["converted"].add(1)
        self._metrics.bytes.add(len(whole))
        self._metrics.seconds.observe(time.monotonic() - t0)
        log.info(
            "converted %s: %d bytes, %d -> %d stripes, %s(%d,%d) -> "
            "%s k=%d n=%d", address, len(whole),
            len(doc.get("stripes") or ()), len(new_keys),
            doc.get("code", "rs"), int(doc.get("k", 0)),
            int(doc.get("n", 0)), pol.code, pol.k, pol.n,
        )
        return True

    # ------------------------------------------------------------- gather

    def _gather(self, doc: dict) -> Optional[bytes]:
        """The object's logical bytes from the source generation:
        decode-free joins where the data shards are intact, batched
        reconstructs (grouped by erasure pattern) otherwise. None when
        any stripe is below k trusted shards locally."""
        keys = [str(s) for s in doc.get("stripes") or ()]
        size = int(doc["size"])
        capacity = int(doc["stripe_bytes"])
        snaps = self.store.snapshot_many(keys)
        parts: list = [None] * len(keys)
        # (pattern gkey) -> [(part index, meta, shards)]
        degraded: dict[tuple, list] = {}
        for idx, key in enumerate(keys):
            snap = snaps.get(key)
            if snap is None:
                return None
            meta, shards, unverified = snap
            trusted = [
                i for i, s in enumerate(shards)
                if s is not None and i not in unverified
            ]
            logical = min(capacity, size - idx * capacity)
            if all(i in trusted for i in range(meta.k)):
                parts[idx] = b"".join(
                    shards[: meta.k]
                )[: meta.object_len][:logical]
                self._metrics.stripes["merge"].add(1)
                continue
            if len(trusted) < meta.k:
                return None
            gkey = (
                meta.k, meta.n, meta.field, meta.shard_len,
                tuple(sorted(trusted)), meta.code,
            )
            degraded.setdefault(gkey, []).append((idx, meta, shards))
        for gkey, members in degraded.items():
            rows_by_member = self._reconstruct_batch(gkey, members)
            for (idx, meta, _), rows in zip(members, rows_by_member):
                logical = min(capacity, size - idx * capacity)
                parts[idx] = rows[: meta.object_len][:logical]
            self._metrics.stripes["reconstruct"].add(len(members))
        return b"".join(parts)

    def _reconstruct_batch(self, gkey: tuple, members: list) -> list:
        """Data bytes for B same-pattern degraded stripes through ONE
        batched dispatch (the repair engine's shape: one inverted
        submatrix, ``matmul_many`` over the member stacks)."""
        from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

        k, n, fieldname, shard_len, trusted, code = gkey
        rs = self.store.codec(k, n, fieldname, code)
        dt = np.dtype("<u2") if fieldname == "gf65536" else np.dtype(
            np.uint8
        )
        missing_data = [
            i for i in range(k) if i not in trusted
        ]
        basis = sorted(trusted)[:k]
        R = reconstruction_matrix(rs.gf, rs.G, basis, missing_data)
        stacks = [
            np.stack([
                np.frombuffer(shards[i], dtype=np.uint8).view(dt)
                for i in basis
            ])
            for _, _, shards in members
        ]
        filled = rs.matmul_many(R, stacks)
        out = []
        for (_, meta, shards), rows in zip(members, filled):
            data = [
                shards[i] if i in trusted
                else np.ascontiguousarray(
                    rows[missing_data.index(i)]
                ).view(np.uint8).tobytes()
                for i in range(k)
            ]
            out.append(b"".join(data))
        return out

    # ---------------------------------------------------------- re-encode

    def _encode_generation(
        self, address: str, whole: bytes, pol: ConversionPolicy
    ) -> list:
        """Chunk + encode the archival generation; returns the ordered
        stripe keys. Signatures derive from (address, code, capacity,
        index), so a re-run after a crash re-produces the SAME keys and
        ``put_object`` replacement is byte-identical (idempotence)."""
        capacity = pol.capacity
        keys = []
        for idx in range(0, max(1, -(-len(whole) // capacity))):
            chunk = whole[idx * capacity : (idx + 1) * capacity]
            sig = derive_stripe_sig(
                b"noise-ec-convert\0", address, pol.code, capacity, idx
            )
            keys.append(self.store.put_object(
                sig, chunk, pol.k, pol.n,
                field=pol.field, code=pol.code,
            ))
        return keys

    # ----------------------------------------------------------------- gc

    def _finish_gc(self, address: str, doc: dict) -> None:
        finish_prev_stripes_gc(
            self.store, address, doc, repair=self.repair
        )
