"""The telemetry the ported modules had left out, on the CPU against the
JAX package: the per-tile attribution of ``obs.device``
(``record_tile_dispatch``, ``tile_summary``, ``roofline_summary``,
``reset_dispatch_tracking``) and its feed from the panel route's
dispatches (``DeviceOpTimer.tile``, ``tile_label``, the sub-launch
counter), and the staging pool's hit and miss counters and donation
record (``StagingPool`` beside the reference's ``DeviceBufferPool``)."""

import numpy as np
import pytest
import torch

import noise_ec_tpu.obs.device as ref_device
import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu_torch.obs.device as obs_device
import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu.ops import dispatch as ref_dispatch
from noise_ec_tpu_torch.gf import GF65536
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.ops.dispatch import (
    DeviceCodec,
    StagingPool,
    tile_label,
)
from noise_ec_tpu_torch.ops.pack import words16_to_bytesliced

TILE_FAMILIES = ("noise_ec_kernel_tile_dispatches_total",
                 "noise_ec_kernel_tile_bytes_total")


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    obs_device.reset_dispatch_tracking()
    ref_device.reset_dispatch_tracking()
    yield
    obs_device.set_peak_hbm_gbps(None)
    ref_device.set_peak_hbm_gbps(None)
    ref_dispatch.configure_buffer_pool()


def _family(reg, name) -> dict:
    """A counter family's nonzero children (a reset zeroes them in place)."""
    return {key: c.value for key, c in reg.counter(name).children()
            if c.value}


def _tiles(reg) -> dict:
    return {name: _family(reg, name) for name in TILE_FAMILIES}


def _port_counter(name, **labels) -> float:
    return port_registry.default_registry().counter(name).labels(
        **labels).value


# ------------------------------------------------- the attribution itself


def test_tile_attribution_is_the_references():
    """One script of dispatches through both packages' record_tile_dispatch:
    the same counters, the same utilization gauges, the same summary keys
    and values; a compile-route dispatch counts but feeds no bandwidth."""
    script = [("matmul_stripes", "t1", 1000, 0.5, "compile"),
              ("matmul_stripes", "t1", 4000, 1e-6, "execute"),
              ("matmul_stripes", "t2", 2000, 2e-6, "execute"),
              ("matmul_words_bytesliced", "t1", 3000, 3e-6, "execute")]
    for mod in (obs_device, ref_device):
        mod.set_peak_hbm_gbps(100.0)
        for entry, tile, nbytes, seconds, route in script:
            mod.record_tile_dispatch(entry, tile, nbytes, seconds,
                                     route=route)
    port, ref = port_registry.default_registry(), ref_registry.default_registry()
    assert _tiles(port) == _tiles(ref)
    assert _tiles(port)[TILE_FAMILIES[0]] == {
        ("matmul_stripes", "t1"): 2.0, ("matmul_stripes", "t2"): 1.0,
        ("matmul_words_bytesliced", "t1"): 1.0}
    gauge = {key: g.read() for key, g in port.gauge(
        "noise_ec_kernel_tile_utilization").children()}
    assert gauge == {key: g.read() for key, g in ref.gauge(
        "noise_ec_kernel_tile_utilization").children()}
    assert gauge[("matmul_stripes", "t1")] == pytest.approx(0.04)
    assert obs_device.tile_summary() == ref_device.tile_summary()
    assert obs_device.tile_achieved_gbps("matmul_stripes", "t2") == (
        ref_device.tile_achieved_gbps("matmul_stripes", "t2"))
    obs_device.reset_dispatch_tracking()
    assert obs_device.tile_summary() == {}


def test_roofline_summary_has_the_references_keys(monkeypatch):
    """The same synced execute dispatches on both timers give the same
    summary keys; the memory keys come from the card's snapshot (faked
    here: the CPU has none, and the summary then has no memory keys)."""
    for mod in (obs_device, ref_device):
        mod.set_peak_hbm_gbps(100.0)
    with obs_device.device_op("matmul_stripes", "execute", 4096) as dt:
        pass
    ref_device._op_stats["matmul_stripes"] = [4096.0, dt.elapsed]
    assert set(obs_device.roofline_summary()) == {
        "device_matmul_stripes_achieved_gbps",
        "device_matmul_stripes_utilization"}
    monkeypatch.setattr(obs_device, "hbm_snapshot", lambda: {
        "live_bytes": 3 << 20, "peak_bytes": 5 << 20, "limit_bytes": 1,
        "bytes_in_use": 1})
    port_keys = obs_device.roofline_summary()
    ref_keys = ref_device.roofline_summary()
    assert set(port_keys) == set(ref_keys)
    assert port_keys["hbm_live_mib"] == 3.0
    assert port_keys["hbm_peak_mib"] == 5.0
    assert (port_keys["device_matmul_stripes_achieved_gbps"]
            == ref_keys["device_matmul_stripes_achieved_gbps"])


def test_words_entries_count_tiles_but_feed_no_bandwidth():
    """An entry that returns before the card finishes (synced=False)
    counts its tile dispatch and bytes, and feeds no utilization gauge:
    its host time is the submit time."""
    with obs_device.device_op("matmul_words", "execute", 512,
                              synced=False) as dt:
        dt.tile = "kt32_rg1_wr2_wc2_g1"
    reg = port_registry.default_registry()
    assert _family(reg, TILE_FAMILIES[1]) == {
        ("matmul_words", "kt32_rg1_wr2_wc2_g1"): 512.0}
    assert dict(reg.gauge("noise_ec_kernel_tile_utilization")
                .children()) == {}
    assert obs_device.tile_summary() == {}


def test_a_failed_dispatch_records_no_tile():
    with pytest.raises(RuntimeError):
        with obs_device.device_op("matmul_stripes", "execute", 64) as dt:
            dt.tile = "kt32_rg1_wr2_wc2_g1"
            raise RuntimeError("launch failed")
    assert _tiles(port_registry.default_registry()) == {
        name: {} for name in TILE_FAMILIES}


# ------------------------------------------- fed by the panel dispatches


def test_panel_dispatches_are_tile_labelled(rng):
    """Every panel-routed dispatch names its K7 plan and counts its
    sub-launches (as the reference does on its panel route); baked and
    "mxu" dispatches leave both families still."""
    dev = DeviceCodec(device="cpu")
    k, r = 229, 6
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    assert dev.route_for(G[k:]) == "panel"
    D = rng.integers(0, 256, size=(k, 1001)).astype(np.uint8)
    np.testing.assert_array_equal(dev.matmul_stripes(G[k:], D),
                                  host_matvec(dev.gf, G[k:], D))
    kind, threads, tiles, G_sub = dev.plan_for(G[k:])
    label = tile_label(tiles, G_sub)
    assert label == (f"kt{tiles.KT}_rg{tiles.NRG}_wr{tiles.WR}"
                     f"_wc{tiles.WC}_g{G_sub}")
    reg = port_registry.default_registry()
    assert _tiles(reg) == {
        TILE_FAMILIES[0]: {("matmul_stripes", label): 1.0},
        TILE_FAMILIES[1]: {("matmul_stripes", label): float(D.nbytes)}}
    words = torch.from_numpy(D[:, :1000].copy().view(np.int32))
    dev.matmul_words(G[k:], words)
    assert _port_counter(TILE_FAMILIES[0], entry="matmul_words",
                         tile=label) == 1
    assert _port_counter("noise_ec_kernel_sublaunch_dispatches_total",
                         entry="matmul_stripes") == G_sub
    assert _port_counter("noise_ec_kernel_sublaunch_dispatches_total",
                         entry="matmul_words") == G_sub
    # The second stripes call is warm: its execute time feeds the gauge.
    dev.matmul_stripes(G[k:], D)
    assert obs_device.tile_achieved_gbps("matmul_stripes", label) > 0
    assert set(obs_device.tile_summary()) == {
        f"device_tile_matmul_stripes_{label}_gbps"}
    before = _tiles(reg)
    G10 = generator_matrix(dev.gf, 10, 14, "cauchy")
    dev.matmul_stripes(G10[10:], D[:10])
    M = rng.integers(1, 256, size=(200, 200)).astype(np.uint8)
    assert dev.route_for(M) == "mxu"
    dev.matmul_stripes(M, D[:200, :64])
    assert _tiles(reg) == before


def test_bytesliced_panel_dispatch_is_tile_labelled(rng):
    """GF(2^16) RS(60,20) on the byte-sliced entry: 120 byte rows on the
    panel route, labelled under its own entry."""
    dev = DeviceCodec(field="gf65536", device="cpu")
    k, r = 60, 20
    G = generator_matrix(GF65536(), k, k + r, "cauchy")
    assert dev.route_for(G[k:]) == "panel"
    w = torch.from_numpy(rng.integers(0, 1 << 32, size=(k, 128),
                                      dtype=np.uint64)
                         .astype(np.uint32).view(np.int32))
    dev.matmul_words_bytesliced(G[k:], words16_to_bytesliced(w))
    _, _, tiles, G_sub = dev.plan_for(G[k:])
    assert _port_counter(TILE_FAMILIES[0],
                         entry="matmul_words_bytesliced",
                         tile=tile_label(tiles, G_sub)) == 1


# ------------------------------------------------------ the staging pool


def test_pool_counts_hits_and_misses_as_the_reference():
    """The same acquire/release script on both pools: a reused buffer is a
    hit, a fresh allocation a miss."""
    port = StagingPool(pin=False, max_per_key=1)
    ref = ref_dispatch.configure_buffer_pool(max_per_key=1)
    script = ["a", "r", "a", "a", "r", "r", "a", "a"]
    held_p, held_r = [], []
    for op in script:
        if op == "a":
            held_p.append(port.acquire(4, 64))
            held_r.append(ref.acquire_padded(4, 64, 48))
        else:
            port.release(held_p.pop())
            ref.release(held_r.pop())
    names = ("noise_ec_device_buffer_pool_hits_total",
             "noise_ec_device_buffer_pool_misses_total")
    port_vals = [_port_counter(n) for n in names]
    ref_vals = [ref_registry.default_registry().counter(n).labels().value
                for n in names]
    assert port_vals == ref_vals == [2.0, 3.0]


def test_codec_staging_reuses_its_pages(rng):
    """Warm stripes calls of one shape take their page from the pool."""
    dev = DeviceCodec(device="cpu")
    G = generator_matrix(dev.gf, 4, 6, "cauchy")
    D = rng.integers(0, 256, size=(4, 100)).astype(np.uint8)
    for _ in range(3):
        dev.matmul_stripes(G[4:], D)
    assert _port_counter("noise_ec_device_buffer_pool_misses_total") == 1
    assert _port_counter("noise_ec_device_buffer_pool_hits_total") == 2


def test_donation_is_recorded_exactly_once_as_the_reference():
    for pool in (StagingPool(pin=False), ref_dispatch.configure_buffer_pool()):
        x = torch.arange(16, dtype=torch.int32)
        assert not pool.was_donated(x)
        pool.donate(x)
        assert pool.was_donated(x)
        with pytest.raises(RuntimeError, match="donated twice"):
            pool.donate(x)
        del x
        other = torch.arange(16, dtype=torch.int32)
        assert not pool.was_donated(other)
        pool.donate(other)
