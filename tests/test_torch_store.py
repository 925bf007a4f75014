"""The port's stripe store, scrubber, repair engine and conversion engine
on the CPU against the JAX package's (``backend="numpy"``): the same
signature and data give the same key, meta and shard bytes; degraded
reads at every 1..n-k loss pattern; wire absorbs (fill, duplicate,
forged, held unverified); a store directory written by either package
loads in the other, file for file; the scrubber's flags and counters on
the same rot; the repair engine's healed bytes and batch and read
counters on the same storm (the LRC storm's fetch amplification of
0.125 included); and the conversion engine's derived signatures,
manifests and bytes. Every comparison is exact: bytes and counters.
The port runs ``device="cpu"`` (the kernels' plain versions); its
default is the card."""

import itertools
import json
import os

import numpy as np
import pytest

import noise_ec_tpu.host.wire as ref_wire
import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu.store as ref_store
import noise_ec_tpu.store.convert as ref_convert
import noise_ec_tpu_torch.host.wire as port_wire
import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.registry as port_registry
import noise_ec_tpu_torch.store as port_store
import noise_ec_tpu_torch.store.convert as port_convert
from noise_ec_tpu.service import TenantRegistry as RefTenants
from noise_ec_tpu_torch.service import TenantRegistry as PortTenants


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    yield


class Side:
    """One package's store layer: its classes, its registry, and the
    codec placement each side runs (the port on the CPU's plain
    versions, the reference on its host codec)."""

    def __init__(self, name, store_mod, registry, wire):
        self.name = name
        self.mod = store_mod
        self.registry = registry
        self.Shard = wire.Shard
        self.engines = []

    def store(self, store_dir=None, **kw):
        if self.name == "port":
            return self.mod.StripeStore(store_dir, device="cpu", **kw)
        return self.mod.StripeStore(store_dir, backend="numpy", **kw)

    def engine(self, store, **kw):
        eng = self.mod.RepairEngine(store, **kw)
        self.engines.append(eng)
        return eng

    def scrubber(self, store, engine):
        return self.mod.Scrubber(store, engine, interval_seconds=3600.0)

    def counter(self, name, **labels) -> float:
        return self.registry.default_registry().counter(name).labels(
            **labels).value

    def close(self):
        for eng in self.engines:
            eng.close()


@pytest.fixture
def sides():
    pair = (Side("ref", ref_store, ref_registry, ref_wire),
            Side("port", port_store, port_registry, port_wire))
    yield pair
    for side in pair:
        side.close()


def _sig(seed: int) -> bytes:
    return bytes(np.random.default_rng(seed).integers(0, 256, 64,
                                                      dtype=np.uint8))


def _blob(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _meta_tuple(m) -> tuple:
    return (m.file_signature, m.k, m.n, m.shard_len, m.object_len, m.field,
            m.code, m.sender_address, m.sender_public_key, m.key)


STORE_COUNTERS = (
    "noise_ec_store_degraded_reads_total",
    "noise_ec_store_absorbed_shards_total",
    "noise_ec_store_absorb_rejected_total",
    "noise_ec_store_verify_failures_total",
    "noise_ec_store_missing_shards_total",
    "noise_ec_store_corrupt_shards_total",
    "noise_ec_store_repairs_completed_total",
    "noise_ec_store_repair_batches_total",
    "noise_ec_store_repair_batch_stripes_total",
)


def _counters(side) -> dict:
    return {name: side.counter(name) for name in STORE_COUNTERS}


# -------------------------------------------------------------- defaults


def test_stripe_store_runs_its_codecs_on_the_card_by_default():
    store = port_store.StripeStore()
    assert (store.backend, store.device) == ("device", "cuda")
    import torch

    if torch.cuda.is_available():  # pragma: no cover - a card's host
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        store.put_object(_sig(1), _blob(1, 100), 4, 6)
    assert len(store) == 0
    host = port_store.StripeStore(backend="numpy")
    key = host.put_object(_sig(1), _blob(1, 100), 4, 6)
    assert host.read(key) == _blob(1, 100)


# ------------------------------------------------------------ put / read


@pytest.mark.parametrize("k,n,field,code,size", [
    (4, 6, "gf256", "rs", 1000),
    (10, 14, "gf256", "rs", 12345),
    (3, 5, "gf65536", "rs", 999),
    (1, 3, "gf256", "rs", 17),
    (12, 16, "gf256", "lrc:2", 5000),
])
def test_put_gives_the_reference_key_meta_and_shard_bytes(
        sides, k, n, field, code, size):
    got = []
    for side in sides:
        store = side.store()
        key = store.put_object(_sig(k), _blob(size, size), k, n, field=field,
                               code=code, sender_address="tcp://h:1",
                               sender_public_key=b"\x07" * 32)
        meta, shards, unverified = store.snapshot(key)
        got.append((key, _meta_tuple(meta), shards, unverified,
                    store.read(key), store.status(key)))
    assert got[0] == got[1]
    assert got[1][4] == _blob(size, size)


@pytest.mark.parametrize("k,n,field,code", [
    (3, 5, "gf256", "rs"), (4, 6, "gf256", "rs"), (2, 4, "gf65536", "rs"),
    (4, 7, "gf256", "lrc:2"),
])
def test_degraded_reads_at_every_loss_pattern(sides, k, n, field, code):
    """Every pattern of 1..n-k lost shards reads the object back on both
    sides, classifies the same, and counts the same degraded reads. LRC
    is not MDS: a pattern it cannot decode raises the same on both."""
    size = 7 * k * (2 if field == "gf65536" else 1) + 3
    blob = _blob(k * n, size)
    outcomes = []
    for side in sides:
        store = side.store()
        key = store.put_object(_sig(n), blob, k, n, field=field, code=code)
        full = store.snapshot(key)[1]
        seen = []
        for lost in range(1, n - k + 1):
            for missing in itertools.combinations(range(n), lost):
                store.write_repaired(key, {i: full[i] for i in range(n)})
                for i in missing:
                    store.drop_shard(key, i)
                try:
                    read = store.read(key) == blob
                except ValueError as exc:  # an LRC pattern past its reach
                    read = str(exc)
                seen.append((missing, store.classify(key), read))
        outcomes.append((seen, _counters(side)))
    assert outcomes[0] == outcomes[1]
    reads = [read for _, _, read in outcomes[1][0]]
    if code == "rs":
        assert all(read is True for read in reads)
    else:
        assert reads.count(True) > len(reads) // 2


def test_read_below_k_raises_on_both(sides):
    for side in sides:
        store = side.store()
        key = store.put_object(_sig(3), _blob(3, 256), 4, 6)
        for i in (0, 2, 4):
            store.drop_shard(key, i)
        with pytest.raises(side.mod.DegradedReadError):
            store.read(key)
        assert store.classify(key) == "fetch"


# -------------------------------------------------------------- absorbs


def _absorb_script(side) -> list:
    """Fill, duplicate, forged and differing absorbs into a verified
    stripe, then absorbs held unverified into a stripe below k trusted
    shards, with each call's return value and the stripe's status."""
    trace = []
    store = side.store()
    key = store.put_object(_sig(11), _blob(11, 600), 4, 6)
    meta, shards, _ = store.snapshot(key)

    def shard(num, data):
        return side.Shard(file_signature=meta.file_signature,
                          shard_data=data, shard_number=num,
                          total_shards=meta.n,
                          minimum_needed_shards=meta.k)

    store.drop_shard(key, 3)
    trace.append(("forged", store.note_shard(shard(3, bytes(meta.shard_len))),
                  store.status(key)))
    trace.append(("good", store.note_shard(shard(3, shards[3])),
                  store.status(key)))
    trace.append(("duplicate", store.note_shard(shard(3, shards[3])),
                  store.status(key)))
    trace.append(("differing", store.note_shard(shard(2, b"\x01" * len(
        shards[2]))), store.status(key)))
    trace.append(("bad geometry", store.note_shard(side.Shard(
        file_signature=meta.file_signature, shard_data=shards[1],
        shard_number=1, total_shards=7, minimum_needed_shards=4)),
        store.status(key)))
    unknown = side.Shard(file_signature=_sig(99), shard_data=b"x" * 10,
                         shard_number=0, total_shards=6,
                         minimum_needed_shards=4)
    trace.append(("unknown", store.note_shard(unknown), len(store)))
    # Below k trusted shards: absorbs are held unverified, never read.
    for i in (0, 1, 2):
        store.drop_shard(key, i)
    trace.append(("classify", store.classify(key)))
    for i in (0, 1):
        trace.append((f"held {i}", store.note_shard(shard(i, shards[i])),
                      store.status(key), store.classify(key)))
    with pytest.raises(side.mod.DegradedReadError):
        store.read(key)
    trace.append(("unverified", store.snapshot(key)[2]))
    store.mark_trusted(key, [0, 1])
    trace.append(("trusted", store.status(key), store.read(key)))
    trace.append(("counters", _counters(side)))
    return trace


def test_note_shard_absorbs_duplicates_and_holds_unverified(sides):
    ref, port = (_absorb_script(side) for side in sides)
    assert ref == port
    assert port[-2][2] == _blob(11, 600)


def test_placement_shard_creates_an_unverified_stripe(sides):
    got = []
    for side in sides:
        store = side.store()
        full = side.store()
        key = full.put_object(_sig(21), _blob(21, 4000), 4, 6)
        meta, shards, _ = full.snapshot(key)
        trace = []
        for num in (0, 2, 5, 1):
            msg = side.Shard(file_signature=meta.file_signature,
                             shard_data=shards[num], shard_number=num,
                             total_shards=6, minimum_needed_shards=4)
            trace.append((store.note_placement_shard(msg),
                          store.status(key), store.classify(key)))
        got.append((trace, _meta_tuple(store.meta(key))))
    assert got[0] == got[1]


# ----------------------------------------------------- store directories


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _fill(store) -> dict:
    """Stripes of both fields and codes, one degraded, one with an
    unverified absorb, and a manifest."""
    blobs = {}
    for i, (k, n, field, code) in enumerate([
            (4, 6, "gf256", "rs"), (2, 4, "gf65536", "rs"),
            (5, 7, "gf256", "rs"), (4, 7, "gf256", "lrc:2")]):
        blob = _blob(100 + i, 3000 + i)
        blobs[store.put_object(_sig(100 + i), blob, k, n, field=field,
                               code=code)] = blob
    first = next(iter(blobs))
    store.drop_shard(first, 0)
    store.put_manifest("a1b2c3d4e5f60718", {
        "address": "a1b2c3d4e5f60718", "stripes": list(blobs)[:2],
        "size": 6001})
    return blobs


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_directory_loads_in_the_other_package(sides, tmp_path,
                                                      writer):
    ref, port = sides
    src, dst = (ref, port) if writer == "ref" else (port, ref)
    a, b = tmp_path / "a", tmp_path / "b"
    blobs = _fill(src.store(str(a)))
    # The same puts on the other side write the same files.
    _fill(dst.store(str(b)))
    assert _tree(a) == _tree(b)
    loaded = dst.store(str(a))
    assert sorted(loaded.keys()) == sorted(blobs)
    for key, blob in blobs.items():
        assert loaded.read(key) == blob
    first = next(iter(blobs))
    assert loaded.status(first)["missing"] == [0]
    assert loaded.get_manifest("a1b2c3d4e5f60718")["size"] == 6001
    # What the loader then writes is still readable by the writer.
    key = loaded.put_object(_sig(7), _blob(7, 999), 3, 5)
    again = src.store(str(a))
    assert again.read(key) == _blob(7, 999)
    assert _tree(a)[os.path.join(key, "meta.json")] == json.dumps(
        json.loads(_tree(a)[os.path.join(key, "meta.json")])).encode()


# ------------------------------------------------------- scrub and repair


def test_scrubber_flags_and_counts_the_same_rot(sides):
    """Corrupt parity and data shards, a missing shard: the same flags,
    the same counters, the same repaired bytes, and a clean next cycle."""
    got = []
    for side in sides:
        store = side.store()
        engine = side.engine(store)
        scrub = side.scrubber(store, engine)
        blobs = {}
        for i, field in enumerate(("gf256", "gf65536", "gf256", "gf256")):
            blob = _blob(200 + i, 2048)
            blobs[store.put_object(_sig(200 + i), blob, 4, 6,
                                   field=field)] = blob
        keys = list(blobs)
        flip = lambda b: bytes([b[0] ^ 0x5A]) + bytes(b[1:])  # noqa: E731
        assert store.corrupt_shard(keys[0], 1, flip)
        assert store.corrupt_shard(keys[1], 5, flip)
        store.drop_shard(keys[2], 2)
        first = scrub.run_cycle()
        second = scrub.run_cycle()
        healed = engine.drain_once()
        third = scrub.run_cycle()
        got.append((first, second, healed, third, _counters(side),
                    [store.read(k) == b for k, b in blobs.items()],
                    [store.snapshot(k)[1] for k in keys]))
    assert got[0] == got[1]
    assert got[1][0]["flagged_corrupt"] == 2 and got[1][2] == 3
    assert all(got[1][5])


@pytest.mark.parametrize("batch_min", [2, 99])
def test_repair_storm_heals_the_same_bytes_with_the_same_counters(
        sides, batch_min):
    """Five RS(4,6) stripes with one erasure pattern: one batched
    dispatch (or, below ``batch_min``, one reconstruct a stripe), the
    same healed shards and the same ``batches``, ``batch_stripes`` and
    ``shards_read{code}``."""
    got = []
    for side in sides:
        store = side.store()
        engine = side.engine(store, batch_min=batch_min)
        scrub = side.scrubber(store, engine)
        blobs = {}
        for i in range(5):
            blob = _blob(300 + i, 4096)
            blobs[store.put_object(_sig(300 + i), blob, 4, 6)] = blob
        full = {k: store.snapshot(k)[1] for k in blobs}
        for key in blobs:
            store.drop_shard(key, 1)
            store.drop_shard(key, 4)
        scrub.run_cycle()
        healed = engine.drain_once()
        got.append((healed, _counters(side),
                    side.counter("noise_ec_store_repair_shards_read_total",
                                 code="rs"),
                    {k: store.snapshot(k)[1] == full[k] for k in blobs},
                    {k: store.read(k) == b for k, b in blobs.items()}))
    assert got[0] == got[1]
    assert got[1][0] == 5 and all(got[1][3].values())
    batches = got[1][1]["noise_ec_store_repair_batches_total"]
    assert batches == (1 if batch_min == 2 else 0)


def test_lrc_storm_reads_an_eighth_of_the_rs_storm(sides):
    """RS(40,16) against LRC(40,8,8), one data loss a stripe over 4
    stripes (the CPU's plain versions are slow at k = 40): the repair
    engine's ``shards_read{code}`` gives the same
    fetch amplification on both sides, exactly 0.125 (a local heal reads
    its 5-member cell, RS reads k = 40)."""
    per_side = []
    for side in sides:
        per_heal = {}
        for label, code in (("rs", "rs"), ("lrc", "lrc:8")):
            store = side.store()
            engine = side.engine(store, linger_seconds=0.0, max_batch=16)
            scrub = side.scrubber(store, engine)
            blobs = {}
            for i in range(4):
                blob = _blob(400 + i, 40 * 256)
                blobs[store.put_object(
                    (0x4C52 + i).to_bytes(4, "little") + code.encode(),
                    blob, 40, 56, code=code)] = blob
            r0 = side.counter("noise_ec_store_repair_shards_read_total",
                              code=label)
            for key in blobs:
                store.drop_shard(key, 3)
            scrub.run_cycle()
            healed = engine.drain_once()
            assert healed == 4
            assert all(store.read(k) == b for k, b in blobs.items())
            per_heal[label] = (side.counter(
                "noise_ec_store_repair_shards_read_total",
                code=label) - r0) / healed
        per_side.append((per_heal, per_heal["lrc"] / per_heal["rs"],
                         _counters(side)))
    assert per_side[0] == per_side[1]
    assert per_side[1][1] == 0.125


def test_repair_corrupt_restores_through_the_host_codec(sides):
    """The error-correcting restore (``FEC`` on the host codec, as in
    the reference) fixes a rotten data shard byte for byte."""
    got = []
    for side in sides:
        store = side.store()
        engine = side.engine(store)
        key = store.put_object(_sig(500), _blob(500, 5000), 10, 14)
        want = store.snapshot(key)[1]
        store.corrupt_shard(key, 4, lambda b: bytes(len(b)))
        fixed = engine.repair_corrupt(key)
        got.append((fixed, store.snapshot(key)[1] == want, _counters(side)))
    assert got[0] == got[1] and got[1][:2] == (True, True)


def test_repair_queue_dedups_and_upgrades(sides):
    for side in sides:
        store = side.store()
        engine = side.engine(store)
        key = store.put_object(_sig(6), _blob(6, 512), 4, 6)
        engine.enqueue(key, "missing")
        engine.enqueue(key, "missing")
        assert engine.queue_depth() == 1
        engine.enqueue(key, "fetch")
        engine.enqueue(key, "missing")
        with engine._lock:
            assert engine._queue[key] == "fetch"
        assert engine.max_batch == 64


def test_engines_run_and_join_their_threads(sides):
    """Started scrubber and repair threads heal on their own and are
    joined by ``close``."""
    import time

    for side in sides:
        store = side.store()
        engine = side.engine(store, linger_seconds=0.0)
        scrub = side.mod.Scrubber(store, engine, interval_seconds=0.05)
        key = store.put_object(_sig(8), _blob(8, 2048), 4, 6)
        store.drop_shard(key, 0)
        engine.start()
        scrub.start()
        threads = (scrub._thread, engine._thread)
        deadline = time.monotonic() + 30
        while store.status(key)["missing"] and time.monotonic() < deadline:
            time.sleep(0.02)
        scrub.close()
        engine.close()
        assert store.status(key)["missing"] == []
        assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------------ conversion


@pytest.mark.parametrize("code,capacity,idx,salt", [
    ("lrc:8", 4 << 20, 0, 0), ("rs", 1 << 20, 7, 0), ("lrc:2", 65536, 3, 5)])
def test_derive_stripe_sig_matches(code, capacity, idx, salt):
    args = (b"tenant-a", "deadbeefcafef00d", code, capacity, idx)
    assert port_convert.derive_stripe_sig(*args, salt=salt) == \
        ref_convert.derive_stripe_sig(*args, salt=salt)


@pytest.mark.parametrize("policy", [
    "archive=lrc:40/8+8,age=0,stripe_bytes=4194304",
    "archive=rs:20+8",
    "archive=lrc:20/4+6,age=600,stripe_bytes=1048576,field=gf256",
])
def test_conversion_policy_grammar_matches(policy):
    ref = ref_convert.ConversionPolicy.parse(policy)
    port = port_convert.ConversionPolicy.parse(policy)
    assert vars(ref) == vars(port)
    assert (ref.n, ref.code, ref.capacity) == (port.n, port.code,
                                              port.capacity)


@pytest.mark.parametrize("bad", [
    "archive=ice:20+6", "archive=lrc:20/3+6", "archive=lrc:20/4+0",
    "archive=lrc:20+6", "archive=rs:20/4+6", "age=600",
    "archive=lrc:20/4+6,turbo=1", "archive=lrc:300/4+6",
    "archive=lrc:20/4+6,stripe_bytes=3", "garbage"])
def test_conversion_policy_errors_match(bad):
    errs = []
    for mod in (ref_convert, port_convert):
        with pytest.raises(ValueError) as info:
            mod.ConversionPolicy.parse(bad)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_conversion_gives_the_reference_signatures_manifest_and_bytes():
    """A 1 MiB object in RS(10,4) stripes of 64 KiB converted to
    LRC(40,8,8) archival stripes by the same tenant policy: the same new
    manifest, stripe keys and shard bytes on both sides, and the object
    reads back, also with one data shard lost from every archival
    stripe."""
    from noise_ec_tpu.host.plugin import ShardPlugin as RefPlugin
    from noise_ec_tpu.host.transport import (
        LoopbackHub as RefHub,
        LoopbackNetwork as RefNet,
        format_address as ref_fmt,
    )
    from noise_ec_tpu.service import ObjectStore as RefObjects
    from noise_ec_tpu_torch.host.plugin import ShardPlugin as PortPlugin
    from noise_ec_tpu_torch.host.transport import (
        LoopbackHub as PortHub,
        LoopbackNetwork as PortNet,
        format_address as port_fmt,
    )
    from noise_ec_tpu_torch.service import ObjectStore as PortObjects
    from noise_ec_tpu.host.crypto import KeyPair as RefKeys
    from noise_ec_tpu_torch.host.crypto import KeyPair as PortKeys

    seed = bytes(range(32))
    obj = _blob(600, 1 << 20)
    got = []
    for (mod, Hub, Net, fmt, Plugin, Objects, Tenants, Keys, kw) in (
            (ref_store, RefHub, RefNet, ref_fmt, RefPlugin, RefObjects,
             RefTenants, RefKeys, {"backend": "numpy"}),
            (port_store, PortHub, PortNet, port_fmt, PortPlugin,
             PortObjects, PortTenants, PortKeys,
             {"backend": "device", "device": "cpu"})):
        node = Net(Hub(), fmt("tcp", "localhost", 4000),
                   keys=Keys.from_seed(seed))
        store = mod.StripeStore(**kw)
        engine = mod.RepairEngine(store, network=node, linger_seconds=0.0)
        plugin = Plugin(store=store, **kw)
        node.add_plugin(plugin)
        tenants = Tenants()
        tenants.configure("cold", policy="archive=lrc:40/8+8,age=0,"
                          f"stripe_bytes={256 << 10}")
        objects = Objects(store, plugin, node, tenants=tenants,
                          engine=engine, stripe_bytes=64 << 10, k=10, n=14)
        objects.put("cold", "glacier", obj)
        hot = objects.resolve("cold", "glacier")
        conv = mod.ConversionEngine(store, tenants, repair=engine)
        stats = conv.run_cycle()
        doc = objects.resolve("cold", "glacier")
        shards = [store.snapshot(k)[1] for k in doc["stripes"]]
        read = objects.read("cold", "glacier")
        for key in doc["stripes"]:
            store.drop_shard(key, 1)
        degraded = objects.read("cold", "glacier")
        # The manifests' clock fields, and the stripe that carries the
        # manifest (its bytes hold them), differ run to run.
        clock = ("created", "converted", "manifest_stripe")
        assert all(doc[k] for k in clock)
        got.append((stats, {k: v for k, v in hot.items() if k not in clock},
                    {k: v for k, v in doc.items() if k not in clock},
                    shards, read == obj, degraded == obj))
        conv.close()
        engine.close()
    assert got[0] == got[1]
    assert got[1][0]["converted"] == 1 and got[1][2]["code"] == "lrc:8"
    assert got[1][4] and got[1][5]
