"""The port's mesh tier and sharded builders on the CPU against the JAX
package: the router over ``[torch.device("cpu")] * 8`` beside the
reference's over the conftest's 8 virtual devices (planning, byte
identity of every sharded route with the uneven tail B = 5, the batch
codec, a repair storm, a shard's fault through the breaker, the chained
encode -> decode1 with no reshard, the panel route's tile label, the
"mxu" route left unsharded), and ``BatchCodec.make_sharded_*`` against
the reference's builders and ``GoldenCodec``."""

import jax
import numpy as np
import pytest
import torch

import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.gf.field import GF65536 as RefGF65536
from noise_ec_tpu.golden.codec import GoldenCodec
from noise_ec_tpu.matrix.hostmath import host_matvec as ref_host_matvec
from noise_ec_tpu.parallel import mesh as ref_mesh
from noise_ec_tpu.parallel.batch import BatchCodec as RefBatchCodec
from noise_ec_tpu_torch.gf import GF256, GF65536
from noise_ec_tpu_torch.matrix import generator_matrix, reconstruction_matrix
from noise_ec_tpu_torch.ops import dispatch, launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec, tile_label
from noise_ec_tpu_torch.parallel.batch import BatchCodec
from noise_ec_tpu_torch.parallel.mesh import (
    MeshRouter,
    ShardedBatch,
    configure_mesh_router,
    default_2d_mesh,
    ladder_pad,
    make_mesh,
    mesh_router,
    reset_mesh_router,
)

_FIELDS = {"gf256": GF256, "gf65536": GF65536}
_REF_FIELDS = {"gf256": RefGF256, "gf65536": RefGF65536}
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _isolate_port_state():
    """The port's registry and event log scoped to the test (the shared
    conftest resets only the reference's), and the default (disabled)
    routers and a closed breaker after it."""
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    yield
    reset_mesh_router()
    ref_mesh.reset_mesh_router()
    dispatch.configure_codec_breaker()


@pytest.fixture
def mesh8():
    router = configure_mesh_router(devices=CPU8, enable=True)
    assert router.enabled and router.n_pow2 == 8
    return router


def _counter(name: str, **labels) -> float:
    return port_registry.default_registry().counter(name).labels(
        **labels).value


def _shard_maps() -> float:
    return _counter("noise_ec_mesh_sharded_dispatches_total",
                    mode="shard_map")


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ------------------------------------------------------------- planning


def test_planning_is_the_references(mesh8):
    ref = ref_mesh.configure_mesh_router(enable=True)
    assert ref.n_pow2 == mesh8.n_pow2 == 8
    for B in range(1, 70):
        assert ladder_pad(B) == ref_mesh.ladder_pad(B)
        assert mesh8.n_dev_for(ladder_pad(B)) == ref.n_dev_for(
            ref_mesh.ladder_pad(B))
        assert mesh8.should_shard(B) == ref.should_shard(B)
    for n in (3, 5, 6, 7):
        assert MeshRouter(CPU8[:n], enable=True).n_pow2 == (
            ref_mesh.MeshRouter(jax.devices()[:n],
                                enable=True).n_pow2)
    # Default construction on the CPU: present, disabled, one device.
    reset_mesh_router()
    ref_mesh.reset_mesh_router()
    assert not mesh_router().enabled and not ref_mesh.mesh_router().enabled
    assert not mesh_router().should_shard(64)
    gauge = dict(port_registry.default_registry().gauge(
        "noise_ec_mesh_devices").children())
    assert gauge[()].read() == 1
    assert mesh8.enabled  # the configured router read 8 while it was set


def test_meshes_have_the_references_shapes_and_errors():
    for names, sizes in [(("batch",), None), (("batch", "row"), (4, 2)),
                         (("batch", "row"), (1, 8))]:
        m = make_mesh(names, sizes, CPU8)
        r = ref_mesh.make_mesh(names, sizes, jax.devices()[:8])
        assert m.shape == dict(r.shape) and m.axis_names == r.axis_names
    assert default_2d_mesh(CPU8).shape == dict(
        ref_mesh.default_2d_mesh(jax.devices()[:8]).shape)
    with pytest.raises(ValueError, match="axis sizes"):
        make_mesh(("batch", "row"), (3, 2), CPU8)
    with pytest.raises(ValueError, match="axis sizes"):
        ref_mesh.make_mesh(("batch", "row"), (3, 2),
                           jax.devices()[:8])


# ---------------------------------------------- byte identity, B = 5


@pytest.mark.parametrize("field,k,r", [
    ("gf256", 4, 2),
    ("gf256", 10, 4),
    ("gf65536", 3, 2),
])
def test_stripes_batch_shards_byte_identical(mesh8, rng, field, k, r):
    """B = 5 on 8 positions (ladder pad 8, three garbage members): every
    member equals the reference's host arithmetic, and the batch ran as
    one sharded dispatch in one gate slot and one device_op window."""
    gf = _FIELDS[field]()
    G = generator_matrix(gf, k, k + r, "cauchy")
    dev = DeviceCodec(field=field, device="cpu")
    Ds = [rng.integers(0, gf.order, size=(k, 96)).astype(gf.dtype)
          for _ in range(5)]
    grants = _counter("noise_ec_lane_grants_total", lane="live")
    before = _shard_maps()
    got = dev.matmul_stripes_many(G[k:], Ds)
    for D, g in zip(Ds, got):
        np.testing.assert_array_equal(
            g, ref_host_matvec(_REF_FIELDS[field](), G[k:], D))
        assert g.flags.writeable
    assert _shard_maps() == before + 1
    assert _counter("noise_ec_lane_grants_total", lane="live") == grants + 1
    ops = port_registry.default_registry().histogram(
        "noise_ec_device_op_seconds")
    assert sum(h.count for key, h in ops.children()
               if key[0] == "matmul_stripes") == 1
    shard_bytes = port_registry.default_registry().histogram(
        "noise_ec_mesh_shard_bytes").labels()
    assert shard_bytes.count == 1


def test_words_batch_shards_like_one_device(mesh8, rng):
    """GF(2^8) words batches of B > 1 shard (a plain tensor input counts
    one reshard, as the reference's ``_note_input``); the result is one
    tensor on the codec's device, equal to the single-device route."""
    k, r = 10, 4
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    words = _t(_words(rng, (5, k, 300)))
    reshard = _counter("noise_ec_mesh_reshard_total")
    before = _shard_maps()
    got = dev.matmul_words_batch(G[k:], words)
    assert isinstance(got, torch.Tensor) and got.shape == (5, r, 300)
    assert _shard_maps() == before + 1
    assert _counter("noise_ec_mesh_reshard_total") == reshard + 1
    for b in range(5):
        np.testing.assert_array_equal(
            got[b].numpy().view(np.uint8),
            ref_host_matvec(RefGF256(), G[k:],
                            words[b].numpy().view(np.uint8)))
    reset_mesh_router()
    np.testing.assert_array_equal(
        got.numpy(), dev.matmul_words_batch(G[k:], words).numpy())
    assert _shard_maps() == before + 1  # the default router shards nothing


def test_words_tier_matches_the_references_interpret_mesh(mesh8, rng):
    """One small geometry against the reference's interpret-mode words
    tier (shard_map over the 8 virtual devices): RS(4,2), B = 2."""
    from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec

    k, r, B, TW = 4, 2, 2, 8192
    ref = ref_mesh.configure_mesh_router(enable=True)
    rdev = RefDeviceCodec(field="gf256", kernel="pallas_interpret")
    G = generator_matrix(GF256(), k, k + r, "cauchy")
    words = _words(rng, (B, k, TW))
    want = np.asarray(ref.matmul_words_batch(rdev, G[k:], words))
    got = mesh8.matmul_words_batch(DeviceCodec(device="cpu"), G[k:], words)
    assert isinstance(got, ShardedBatch) and got.mesh.size == 2
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32), want)


def test_batch_codec_rides_the_mesh(mesh8, rng):
    """BatchCodec.encode_batch / reconstruct_batch shard through
    matmul_stripes_many, both fields, equal to the reference's
    GoldenCodec."""
    for field in ("gf256", "gf65536"):
        gf = _FIELDS[field]()
        bc = BatchCodec(4, 2, field=field, device="cpu")
        g = GoldenCodec(4, 6, field=field)
        batch = rng.integers(0, gf.order, size=(5, 4, 50)).astype(gf.dtype)
        before = _shard_maps()
        full = bc.encode_batch(batch)
        for b in range(5):
            np.testing.assert_array_equal(full[b, 4:],
                                          np.asarray(g.encode(batch[b])))
        present = [1, 2, 4, 5]
        np.testing.assert_array_equal(
            bc.reconstruct_batch(full[:, present], present), full)
        assert _shard_maps() == before + 2


def test_repair_storm_heals_through_the_sharded_entry(mesh8, rng):
    """The repair engine's group reconstruct (rs.matmul_many -> the
    coalescer -> matmul_stripes_many) lands on the mesh tier; the drain
    is the reference's mesh-wide 64 x 8 = 512."""
    from noise_ec_tpu_torch.store import RepairEngine, Scrubber, StripeStore

    k, n = 4, 6
    store = StripeStore(device="cpu")
    engine = RepairEngine(store, batch_min=2, linger_seconds=0.0)
    try:
        assert engine.max_batch == 512
        scrub = Scrubber(store, engine, interval_seconds=3600.0)
        payloads = {}
        for i in range(6):
            sig = i.to_bytes(8, "little") + bytes(56)
            blob = rng.integers(0, 256, size=k * 256,
                                dtype=np.uint8).tobytes()
            payloads[store.put_object(sig, blob, k, n)] = blob
        before = _shard_maps()
        for skey in payloads:
            store.drop_shard(skey, 0)
            store.drop_shard(skey, 1)
        scrub.run_cycle()
        assert engine.drain_once() == len(payloads)
        for skey, blob in payloads.items():
            assert store.read(skey) == blob
        assert _shard_maps() > before
        scrub.close()
    finally:
        engine.close()
        store.close()
    reset_mesh_router()
    engine = RepairEngine(StripeStore(device="cpu"))
    try:
        assert engine.max_batch == 64  # one device
    finally:
        engine.close()


def test_a_shard_fault_is_refused_through_the_breaker(mesh8, monkeypatch):
    """A shard's RuntimeError goes through the codec breaker like any
    dispatch error: one retry, then CodecUnavailableError counted as
    reason "error"; nothing runs on the host (the reference serves host
    bytes here; the port refuses by design)."""
    from noise_ec_tpu_torch.codec.rs import ReedSolomon
    import noise_ec_tpu_torch.codec.rs as port_rs

    dispatch.configure_codec_breaker(reset_timeout=60.0)
    rs = ReedSolomon(4, 2, device="cpu")
    rng = np.random.default_rng(7)
    Ds = [rng.integers(0, 256, size=(4, 64)).astype(np.uint8)
          for _ in range(6)]
    calls = []

    def boom(self, *a, **kw):
        calls.append(1)
        raise RuntimeError("injected mesh device fault")

    def host(*a, **kw):
        raise AssertionError("a device product ran on the host")

    monkeypatch.setattr(MeshRouter, "words_product", boom)
    monkeypatch.setattr(port_rs, "native_matvec", host)
    with pytest.raises(dispatch.CodecUnavailableError):
        rs.matmul_many(rs.G[4:], Ds)
    assert len(calls) == 2  # the in-call retry, then the trip
    assert _counter("noise_ec_codec_refused_total", reason="error") == 1
    assert not dispatch.codec_breaker().closed


def test_chained_encode_decode_never_reshards(mesh8, rng):
    """Encode -> corruption on the shards -> decode1, every stage on the
    tier's mesh: noise_ec_mesh_reshard_total stays still, the corrected
    row is the data and the consistency rows are zero; a plain-tensor
    input counts exactly one reshard."""
    k, r = 10, 4
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    B, TW = 8, 1024
    words = _words(rng, (B, k, TW))
    parity = mesh8.matmul_words_batch(dev, G[k:], words)
    data = mesh8.shard(words)
    flip = int(np.uint32(0xA5A5A5A5).view(np.int32))

    def assemble(d, p):
        full = torch.cat([d, p], dim=1)
        full[:, 5] ^= flip
        return full

    full = data.map(assemble, parity)
    reshard0 = _counter("noise_ec_mesh_reshard_total")
    corrected, bad = mesh8.decode1_words_batch(dev, G[k:], 5, full)
    assert _counter("noise_ec_mesh_reshard_total") == reshard0
    assert not np.asarray(bad).any()
    np.testing.assert_array_equal(np.asarray(corrected).view(np.uint32),
                                  words[:, 5, :])
    corrected2, _ = mesh8.decode1_words_batch(dev, G[k:], 5,
                                              full.to_tensor())
    assert _counter("noise_ec_mesh_reshard_total") == reshard0 + 1
    np.testing.assert_array_equal(np.asarray(corrected2).view(np.uint32),
                                  words[:, 5, :])
    with pytest.raises(NotImplementedError, match="GF\\(2\\^8\\) words"):
        mesh8.decode1_words_batch(DeviceCodec(field="gf65536",
                                              device="cpu"),
                                  G[k:], 5, full)


def test_panel_route_shards_tile_labelled(mesh8, rng):
    """RS(229,6) (the port's panel route: K6 -> K7 -> K6 on each shard)
    shards, names its K7 plan on the tile families, and counts its
    sub-launches under "mesh_words" as the reference's tier does."""
    k, r = 229, 6
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    assert dev.route_for(G[k:]) == "panel"
    Ds = [rng.integers(0, 256, size=(k, 256)).astype(np.uint8)
          for _ in range(3)]
    reset_launch_counts()
    got = dev.matmul_stripes_many(G[k:], Ds)
    launches = launch_counts()
    for D, g in zip(Ds, got):
        np.testing.assert_array_equal(
            g, ref_host_matvec(RefGF256(), G[k:], D))
    _, _, tiles, G_sub = dev.plan_for(G[k:])
    label = tile_label(tiles, G_sub)
    assert _counter("noise_ec_kernel_tile_dispatches_total",
                    entry="matmul_stripes", tile=label) == 1
    assert _counter("noise_ec_kernel_tile_bytes_total",
                    entry="matmul_stripes", tile=label) == sum(
        D.nbytes for D in Ds)
    assert _counter("noise_ec_kernel_sublaunch_dispatches_total",
                    entry="mesh_words") == G_sub
    assert _shard_maps() == 1
    assert launches["gf2mm_panel"] == 0  # plain versions on the CPU


def test_mxu_and_interleaved_gf16_batches_do_not_shard(mesh8, rng):
    """As in the reference: an "mxu" matrix and the interleaved GF(2^16)
    words entry stay on one device."""
    dev = DeviceCodec(device="cpu")
    M = rng.integers(1, 256, size=(200, 200)).astype(np.uint8)
    assert dev.route_for(M) == "mxu"
    Ds = [rng.integers(0, 256, size=(200, 128)).astype(np.uint8)
          for _ in range(2)]
    got = dev.matmul_stripes_many(M, Ds)
    np.testing.assert_array_equal(
        got[1], ref_host_matvec(RefGF256(), M, Ds[1]))
    dev16 = DeviceCodec(field="gf65536", device="cpu")
    G16 = generator_matrix(dev16.gf, 4, 6, "cauchy")
    dev16.matmul_words_batch(G16[4:], _t(_words(rng, (3, 4, 64))))
    assert _shard_maps() == 0


def test_symbol_entries_and_programs_ride_the_words_tier(mesh8, rng):
    """The reference's pjit-tier entries (``matmul_sym_many``,
    ``matmul_sym_batch``, ``encode_sym_program``), the byte-sliced batch
    and ``encode_words_program`` all run the words tier and record
    ``shard_map``, byte-equal to the host arithmetic."""
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, 4, 6, "cauchy")
    batch = rng.integers(0, 256, size=(5, 4, 80)).astype(np.uint8)
    want = np.stack([ref_host_matvec(RefGF256(), G[4:], D) for D in batch])
    np.testing.assert_array_equal(
        np.stack(mesh8.matmul_sym_many(dev, G[4:], list(batch), 8)), want)
    np.testing.assert_array_equal(mesh8.matmul_sym_batch(dev, G[4:], batch),
                                  want)
    np.testing.assert_array_equal(
        mesh8.encode_sym_program(dev, G[4:], 2)(batch), want)
    words = np.ascontiguousarray(batch).view(np.uint32)
    got = mesh8.encode_words_program(dev, G[4:], 4)(words)
    assert got.mesh.size == 4
    np.testing.assert_array_equal(np.asarray(got).view(np.uint8), want)
    dev16 = DeviceCodec(field="gf65536", device="cpu")
    G16 = generator_matrix(dev16.gf, 3, 5, "cauchy")
    Ds = [rng.integers(0, 1 << 16, size=(3, 40)).astype(np.uint16)
          for _ in range(3)]
    for D, g in zip(Ds, mesh8.matmul_bytesliced_many(dev16, G16[3:], Ds)):
        np.testing.assert_array_equal(
            g, ref_host_matvec(RefGF65536(), G16[3:], D))
    with pytest.raises(ValueError, match="gf65536-only"):
        mesh8.matmul_bytesliced_many(dev, G[4:], list(batch))
    assert _shard_maps() == 5


def test_donation_is_recorded_once(mesh8, rng):
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, 4, 6, "cauchy")
    words = _t(_words(rng, (4, 4, 64)))
    out = dev.matmul_words_batch(G[4:], words, donate=True)
    assert dev._pool.was_donated(words)
    with pytest.raises(RuntimeError, match="donated twice"):
        dev.matmul_words_batch(G[4:], words, donate=True)
    with pytest.raises(RuntimeError, match="donated twice"):
        mesh8.matmul_words_batch(dev, G[4:], words, donate=True)
    fresh = words.clone()
    np.testing.assert_array_equal(
        out.numpy(), dev.matmul_words_batch(G[4:], fresh).numpy())


# ------------------------------------------------ the sharded builders


def _golden_parity(k, r, batch, field="gf256"):
    g = GoldenCodec(k, k + r, field=field)
    return np.stack([np.asarray(g.encode(b)) for b in batch])


def _ref_devs(n=8):
    return jax.devices()[:n]


def test_sharded_dp_encoder(rng):
    k, r, S = 4, 2, 40
    mesh = make_mesh(("batch",), devices=CPU8)
    B = 16
    batch = rng.integers(0, 256, size=(B, k, S)).astype(np.uint8)
    got = BatchCodec(k, r, device="cpu").make_sharded_encoder(mesh)(batch)
    np.testing.assert_array_equal(got, _golden_parity(k, r, batch))
    ref = RefBatchCodec(k, r).make_sharded_encoder(
        ref_mesh.make_mesh(("batch",), devices=_ref_devs()))
    np.testing.assert_array_equal(got, np.asarray(ref(batch)))


def test_sharded_dp_tp_encoder(rng):
    """(4, 2) mesh: objects over "batch", parity rows over "row"."""
    k, r, S = 10, 4, 96
    mesh = default_2d_mesh(CPU8)
    assert mesh.shape["row"] == 2
    B = mesh.shape["batch"] * 2
    batch = rng.integers(0, 256, size=(B, k, S)).astype(np.uint8)
    got = BatchCodec(k, r, device="cpu").make_sharded_encoder(
        mesh, row_axis="row")(batch)
    np.testing.assert_array_equal(got, _golden_parity(k, r, batch))
    ref = RefBatchCodec(k, r).make_sharded_encoder(
        ref_mesh.default_2d_mesh(_ref_devs()), row_axis="row")
    np.testing.assert_array_equal(got, np.asarray(ref(batch)))


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_sharded_words_encoder_dp_tp(rng, field):
    k, r, S = 10, 4, 256
    gf = _FIELDS[field]()
    per_word = 4 // (gf.degree // 8)
    mesh = default_2d_mesh(CPU8)
    B = mesh.shape["batch"] * 2
    batch = rng.integers(0, gf.order, size=(B, k, S)).astype(gf.dtype)
    words = np.ascontiguousarray(batch).view("<u4").reshape(
        B, k, S // per_word)
    enc = BatchCodec(k, r, field=field, device="cpu")
    got = enc.make_sharded_encoder_words(mesh, row_axis="row")(words)
    parity = got.numpy().view(gf.dtype).reshape(B, r, S)
    np.testing.assert_array_equal(parity,
                                  _golden_parity(k, r, batch, field))
    ref = RefBatchCodec(k, r, field=field).make_sharded_encoder_words(
        ref_mesh.default_2d_mesh(_ref_devs()), row_axis="row",
        kernel="xla")
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref(words)))


def test_sharded_reconstruct_matmul(rng):
    k, r, S = 4, 2, 32
    mesh = make_mesh(("batch",), devices=CPU8)
    B = 8
    bc = BatchCodec(k, r, device="cpu")
    batch = rng.integers(0, 256, size=(B, k, S)).astype(np.uint8)
    full = bc.encode_batch(batch)
    present = [1, 2, 4, 5]
    R = reconstruction_matrix(bc.gf, bc.G, present, [0, 3])
    filled = bc.make_sharded_matmul(mesh, R)(full[:, present])
    np.testing.assert_array_equal(filled[:, 0], full[:, 0])
    np.testing.assert_array_equal(filled[:, 1], full[:, 3])


def test_sharded_syndrome_scan_localizes_corruption():
    k, r, S, B = 4, 2, 128, 8
    bc = BatchCodec(k, r, device="cpu")
    mesh = make_mesh(("batch", "row"), (4, 2), CPU8)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(B, k, S)).astype(np.uint8)
    parity = bc.make_sharded_encoder(mesh, row_axis="row")(data)
    full = np.concatenate([data, parity], axis=1)
    full[5, 0, 10:20] ^= 0x77
    aug = np.concatenate([bc.G[k:], np.eye(r, dtype=bc.G.dtype)], axis=1)
    s = bc.make_sharded_matmul(mesh, aug)(full)
    assert s.shape == (B, r, S)
    np.testing.assert_array_equal(np.nonzero(s.any(axis=(1, 2)))[0], [5])
    np.testing.assert_array_equal(np.nonzero(s[5].any(axis=0))[0],
                                  np.arange(10, 20))


def test_sharded_decode1_corrects_over_mesh():
    mesh = make_mesh(("batch", "row"), (4, 2), CPU8)
    k, r, S, B = 10, 4, 256, 8
    bc = BatchCodec(k, r, device="cpu")
    gold = GoldenCodec(k, k + r)
    rng = np.random.default_rng(0xDEC1)
    data = rng.integers(0, 256, size=(B, k, S)).astype(np.uint8)
    full = np.stack([np.asarray(gold.encode_all(data[b])) for b in range(B)])
    received = full.copy()
    received[3, 5] ^= 0x6B
    received[7, 5, ::7] ^= 0x15
    out = bc.make_sharded_decode1(mesh, 5, row_axis="row")(received)
    assert out.shape == (B, r, S)
    assert not out[:, 1:].any()
    np.testing.assert_array_equal(out[:, 0], data[:, 5])
    ref = RefBatchCodec(k, r).make_sharded_decode1(
        ref_mesh.make_mesh(("batch", "row"), (4, 2), _ref_devs()), 5,
        row_axis="row")
    np.testing.assert_array_equal(out, np.asarray(ref(received)))


def test_sharded_words_near_limit_runs_k8():
    """RS(200,56) passes the reference's mesh route gate: K8 per row slice
    (its plain version here), equal to GoldenCodec; GF(2^16) past the
    gate raises the reference's NotImplementedError."""
    mesh = make_mesh(("batch", "row"), (4, 2), CPU8)
    k, r = 200, 56
    bc = BatchCodec(k, r, device="cpu")
    B, TW = 8, 500
    words = _words(np.random.default_rng(0x200), (B, k, TW))
    reset_launch_counts()
    parity = bc.make_sharded_matmul_words(mesh, bc.parity_matrix,
                                          row_axis="row")(words)
    gold = GoldenCodec(k, k + r)
    for b in range(2):
        np.testing.assert_array_equal(
            parity[b].numpy().view(np.uint8),
            np.asarray(gold.encode(np.ascontiguousarray(words[b])
                                   .view(np.uint8))))
    bc16 = BatchCodec(k, r, field="gf65536", device="cpu")
    ref16 = RefBatchCodec(k, r, field="gf65536")
    with pytest.raises(NotImplementedError) as port_err:
        bc16.make_sharded_encoder_words(mesh, row_axis="row")
    with pytest.raises(NotImplementedError) as ref_err:
        ref16.make_sharded_encoder_words(
            ref_mesh.make_mesh(("batch", "row"), (4, 2), _ref_devs()),
            row_axis="row", kernel="pallas_interpret")
    assert str(port_err.value) == str(ref_err.value)


def test_builders_refuse_what_the_reference_refuses():
    bc = BatchCodec(10, 3, device="cpu")
    mesh = default_2d_mesh(CPU8)
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        bc.make_sharded_encoder(mesh, row_axis="row")
    enc = BatchCodec(10, 4, device="cpu").make_sharded_encoder(mesh)
    with pytest.raises(ValueError, match="not divisible"):
        enc(np.zeros((3, 10, 8), np.uint8))
    with pytest.raises(ValueError, match="no axis"):
        bc.make_sharded_encoder(mesh, batch_axis="objects")
