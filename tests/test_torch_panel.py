"""The port's panel route against the reference: the plain block-panel
matmul (K7, the masked product of the GF(2) core) against the reference's
panel Pallas kernel in interpret mode, the row-blocked pack and unpack (K6)
against the reference's, the per-panel factoring against
``factor_panels``, the planner's ring fit, the three-way routing, and wide
codes end to end against the reference's ``backend="numpy"`` codec. Exact
to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.codec.rs import ReedSolomon as RefRS
from noise_ec_tpu.gf import gf2_matmul_planes
from noise_ec_tpu.gf.bitmatrix import expand_generator_bits as ref_expand
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.matrix.linalg import reconstruction_matrix as ref_recon
from noise_ec_tpu.ops.pallas_gf2mm import (
    bits_to_rows as ref_bits_to_rows,
    gf2_matmul_pallas_panel_rows,
    planes_to_tiled,
    sublaunch_bounds as ref_sublaunch_bounds,
    sublaunch_count as ref_sublaunch_count,
)
from noise_ec_tpu.ops.pallas_pack import (
    pack_words_lanes_blocked as ref_pack_blocked,
    unpack_words_lanes_blocked as ref_unpack_blocked,
)
from noise_ec_tpu.ops.xor_factor import (
    factor_panels as ref_factor_panels,
    factored_cost as ref_factored_cost,
    paar_factor as ref_paar_factor,
    panel_raw_costs as ref_panel_raw_costs,
    split_bits_rows_panels as ref_split_panels,
)
from noise_ec_tpu_torch.codec import ReedSolomon
from noise_ec_tpu_torch.matrix import reconstruction_matrix
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops import dispatch as dispatch_mod
from noise_ec_tpu_torch.ops import panel as panel_mod
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.gf2tile import build_tiles, ring_bytes
from noise_ec_tpu_torch.ops.network import SMEM_BYTES, compile_panels
from noise_ec_tpu_torch.ops.pack import (
    blocked_lane_tl,
    pack_words_lanes_blocked,
    pack_words_lanes_blocked_plain,
    unpack_words_lanes_blocked,
    unpack_words_lanes_blocked_plain,
)
from noise_ec_tpu_torch.ops.panel import (
    gf2_matmul_panel,
    gf2_matmul_panel_chain,
    gf2_matmul_panel_plain,
    panel_plan,
    sublaunch_bounds,
    sublaunch_count,
)
from noise_ec_tpu_torch.ops.xor_factor import (
    factor_panels,
    panel_raw_costs,
    split_bits_rows_panels,
)

_GF = RefGF256()


def _matrix(k, r, erasures=None):
    """Parity rows of Cauchy RS(k, r), or the reconstruct matrix for
    ``erasures`` from the first k surviving shards (reference
    construction)."""
    G = ref_generator(_GF, k, k + r, "cauchy")
    if erasures is None:
        return G[k:]
    present = [i for i in range(k + r) if i not in erasures][:k]
    return ref_recon(_GF, G, present, list(erasures))


def _bits_rows(M):
    return ref_bits_to_rows(ref_expand(_GF, M))


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None)
        or (x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a, b)
    )


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernels on the card")


# ------------------------------------------------------------ K7 (plain)

# The uneven geometry of the reference's own panel test
# (tests/test_panel.py): 19 x 45 bits with an empty row, 777 words.
# Forced reference plans as (KB, RB, temp_cap, G); each spans several K and
# R blocks there. The port's operand takes KB as its K tile.
_FORCED = [(16, 8, 512, 1), (8, 4, 64, 1), (8, 4, 64, 2), (8, 8, 3, 3),
           (16, 4, 100_000, 3)]


@pytest.fixture(scope="module")
def uneven():
    rng = np.random.default_rng(0x5EED)
    bits = rng.integers(0, 2, size=(19, 45)).astype(np.uint8)
    bits[3] = 0  # an empty output row
    planes = rng.integers(0, 2**32, size=(45, 777), dtype=np.uint32)
    tiled = np.asarray(planes_to_tiled(jnp.asarray(planes)))  # (45, 8, 98)
    return bits, tiled


@pytest.mark.parametrize("KB,RB,cap,G", _FORCED)
def test_plain_panel_matches_reference_kernel(uneven, KB, RB, cap, G):
    bits, tiled = uneven
    rows = ref_bits_to_rows(bits)
    want = np.asarray(gf2_matmul_pallas_panel_rows(
        rows, jnp.asarray(tiled), plan=(KB, RB, 128, cap, G), interpret=True
    ))
    np.testing.assert_array_equal(
        want.reshape(19, -1)[:, :777],
        gf2_matmul_planes(bits, tiled.reshape(45, -1)[:, :777]),
    )
    tiles = build_tiles(rows, 45, KB)
    assert (tiles.NRG, tiles.NT) == (1, -(-45 // KB))
    planes = torch.from_numpy(tiled.view(np.int32).copy())
    reset_launch_counts()
    got = gf2_matmul_panel_chain(tiles, planes, tiles.threads, G)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The sub-launches by hand: the first K slice, then each later slice
    # XORed into it in place; batched planes give each batch its own rows.
    bounds = sublaunch_bounds(tiles.NT, G)
    batch = torch.stack([planes, planes.flip(2), planes ^ 0x0F0F0F0F])
    acc = gf2_matmul_panel(tiles, batch, tiles.threads,
                           k_slice=tuple(bounds[:2]))
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        assert gf2_matmul_panel(tiles, batch, tiles.threads, acc=acc,
                                k_slice=(lo, hi)) is acc
    np.testing.assert_array_equal(acc[0].numpy().view(np.uint32), want)
    for b in (1, 2):
        np.testing.assert_array_equal(
            acc[b], gf2_matmul_panel_plain(tiles, batch[b].contiguous()))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,r,erasures,KB", [
    (64, 32, None, 32), (229, 6, None, 16), (20, 4, None, 8),
])
def test_panel_operand_bits_equal_the_expansion(k, r, erasures, KB):
    """K7's mask operand holds -1 exactly at the set bits of the
    reference's expansion; the tiled layout is (row group, K tile, plane,
    row), zero past R and C."""
    M = _matrix(k, r, erasures)
    bits = ref_expand(_GF, M)
    tiles = build_tiles(_bits_rows(M), 8 * k, KB)
    np.testing.assert_array_equal(tiles.matrix().numpy(),
                                  -bits.astype(np.int32))
    m = tiles.masks.numpy()
    assert m.shape == (tiles.NRG, -(-8 * k // KB), KB, tiles.RGR)
    assert int((m != 0).sum()) == int(bits.sum())


def test_panel_rejects_bad_operands(uneven):
    _, tiled = uneven
    tiles = build_tiles(ref_bits_to_rows(uneven[0]), 45, 8)
    planes = torch.from_numpy(tiled.view(np.int32).copy())
    T = tiles.threads
    with pytest.raises(ValueError, match="planes"):
        gf2_matmul_panel(tiles, planes[:44].contiguous(), T)
    with pytest.raises(ValueError, match="slice"):
        gf2_matmul_panel(tiles, planes, T, k_slice=(3, 3))
    with pytest.raises(ValueError, match="acc"):
        gf2_matmul_panel(tiles, planes, T, acc=torch.zeros((18, 8, 98),
                                                           dtype=torch.int32))
    with pytest.raises(ValueError, match="threads"):
        gf2_matmul_panel(tiles, planes, 2 * T)
    with pytest.raises(ValueError, match="no kernel"):
        gf2_matmul_panel(tiles, planes.to("meta"), T)


@pytest.mark.parametrize("raw,PK", [(1, 1), (130_000, 13), (130_001, 13),
                                    (360_968, 13), (360_968, 2),
                                    (533_504, 16), (0, 0)])
def test_sublaunch_model_matches_reference(raw, PK):
    assert sublaunch_count(raw, PK) == ref_sublaunch_count(raw, PK)
    G = sublaunch_count(raw, PK)
    assert sublaunch_bounds(PK, G) == ref_sublaunch_bounds(PK, G)


# ------------------------------------------------------------ K6 (plain)


@pytest.mark.parametrize("TW,tl", [(8192, 128), (16384, 256)])
def test_blocked_pack_matches_reference(rng, TW, tl):
    """45 rows, not a multiple of the reference's 32-row block."""
    assert blocked_lane_tl(TW) == tl
    xw = _words(rng, (45, TW))
    ref_planes = np.asarray(ref_pack_blocked(jnp.asarray(xw), 8, interpret=True))
    reset_launch_counts()
    planes = pack_words_lanes_blocked(torch.from_numpy(xw.view(np.int32)))
    assert planes.shape == (45, 8, 8, TW // 64)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), ref_planes)
    back = unpack_words_lanes_blocked(planes)
    ref_back = np.asarray(ref_unpack_blocked(jnp.asarray(ref_planes),
                                             interpret=True))
    np.testing.assert_array_equal(back.numpy().view(np.uint32), ref_back)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), xw)
    assert all(n == 0 for n in launch_counts().values())


def test_blocked_tl_rule():
    """256 wherever it divides W8 (1 MiB shards), else 128; never 512."""
    assert blocked_lane_tl(262_144) == 256
    assert blocked_lane_tl(8192 * 3) == 128
    with pytest.raises(ValueError):
        blocked_lane_tl(4096)


# ------------------------------------------ per-panel factoring and planner


@pytest.mark.parametrize("KB,RB,cap", [(32, 32, 100_000), (32, 32, 40),
                                       (64, 16, 64)])
def test_compile_panels_matches_reference_factoring(KB, RB, cap):
    """RS(64,32): the program's per-panel factored costs are the
    reference's ``paar_factor`` costs at the same (KB, RB, cap), and its
    totals are the reference's ``factor_panels`` and ``panel_raw_costs``."""
    br = _bits_rows(_matrix(64, 32))
    panels = split_bits_rows_panels(br, 512, KB, RB)
    ref_panels = ref_split_panels(br, 512, KB, RB)
    assert panels == ref_panels
    prog = compile_panels(br, 512, KB, RB, cap)
    want = [ref_factored_cost(*ref_paar_factor(p, KB, max_temps=cap))
            for row in ref_panels for p in row]
    assert list(prog.panel_costs) == want
    total, worst = ref_factor_panels(ref_panels, KB, max_temps=cap)
    assert factor_panels(panels, KB, max_temps=cap) == (total, worst)
    assert prog.cost == total and worst <= cap
    assert prog.raw == panel_raw_costs(panels)[0] == ref_panel_raw_costs(ref_panels)[0]
    assert prog.n_slots <= KB + min(cap, worst)
    ops_per_panel = np.diff(prog.op_ptr.numpy())
    assert ops_per_panel.max() == worst


@pytest.mark.parametrize("k,r,erasures", [
    (64, 32, None), (100, 30, None), (229, 6, None),
    (64, 32, tuple(range(0, 64, 2))),
])
def test_every_plan_fits_shared_memory_at_its_cap(k, r, erasures):
    """Every default plan's ring fits one block's shared memory with one
    warp a row block (one row group where at most 16 warps hold the rows)
    and at most 512 threads; the plan is one launch (G = 1)."""
    M = _matrix(k, r, erasures)
    br = _bits_rows(M)
    C = 8 * M.shape[1]
    threads, tiles, G = panel_plan(br, C)
    assert G == 1 and threads == tiles.threads <= 512
    assert tiles.ring_bytes <= SMEM_BYTES
    assert tiles.NRG * tiles.RGR >= 8 * r > (tiles.NRG * tiles.WR - 1) * 32
    assert tiles.NRG == -(-8 * r // 512)
    assert tiles.NT * tiles.KT >= C


def test_planner_reject_boundary(monkeypatch):
    """The plan takes the most column warps whose ring fits: at exactly
    the two-warp ring it takes two, a byte below one, and a byte below the
    one-warp ring it raises. A narrowed plan still computes the product."""
    KB = panel_mod.PANEL_KB
    M = _matrix(20, 4)
    br = _bits_rows(M)
    two = ring_bytes(KB, 128, 32)
    one = ring_bytes(KB, 64, 32)
    monkeypatch.setattr(panel_mod, "SMEM_BYTES", two)
    assert panel_plan(br, 160)[1].WC == 2
    monkeypatch.setattr(panel_mod, "SMEM_BYTES", two - 1)
    threads, tiles, G = panel_plan(br, 160)
    assert (threads, tiles.WC, G) == (32, 1, 1)
    rng = np.random.default_rng(7)
    planes = _words(rng, (160, 8, 16))
    np.testing.assert_array_equal(
        gf2_matmul_panel_plain(tiles, torch.from_numpy(planes.view(np.int32)))
        .numpy().view(np.uint32).reshape(32, -1),
        gf2_matmul_planes(ref_expand(_GF, M), planes.reshape(160, -1)),
    )
    monkeypatch.setattr(panel_mod, "SMEM_BYTES", one - 1)
    with pytest.raises(ValueError, match="shared memory"):
        panel_plan(br, 160)


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("k,r,erasures,route", [
    (64, 32, None, "panel"), (100, 30, None, "panel"),
    (229, 6, None, "panel"), (64, 32, tuple(range(0, 64, 2)), "panel"),
    (200, 56, (0, 1, 2), "baked"), (50, 20, None, "baked"),
])
def test_routing_pins(k, r, erasures, route):
    codec = DeviceCodec(device="cpu")
    M = _matrix(k, r, erasures)
    assert codec.route_for(M) == route
    if erasures == tuple(range(0, 64, 2)):
        assert codec._xor_cost_for(M) == 62_736


# ------------------------------------------------------ the slice end to end


@pytest.mark.parametrize("k,r,S,lost", [
    (64, 32, 4096, tuple(range(0, 64, 2))),
    (229, 6, 1024, (0, 117, 231)),
])
def test_wide_codes_match_numpy_backend(k, r, S, lost):
    rng = np.random.default_rng(k * 100 + r)
    rs = ReedSolomon(k, r, device="cpu")
    ref = RefRS(k, r, backend="numpy")
    data = list(rng.integers(0, 256, size=(k, S), dtype=np.uint8))
    reset_launch_counts()
    enc = rs.encode(data)
    assert _same(enc, ref.encode(data))
    assert rs.verify(enc)
    bad = [s.copy() for s in enc]
    bad[k + r - 1][S // 3] ^= 0x10
    assert not rs.verify(bad)
    holes = [None if i in lost else s for i, s in enumerate(enc)]
    got = rs.reconstruct(holes)
    assert _same(got, ref.reconstruct(holes)) and _same(got, enc)
    # Both products took the panel route.
    present = [i for i in range(k + r) if i not in lost][:k]
    recovery = reconstruction_matrix(rs.gf, rs.G, present, list(lost))
    for M in (rs.G[k:], recovery):
        assert rs._dev.plan_for(M)[0] == "panel"
    assert all(n == 0 for n in launch_counts().values())


def test_forced_sublaunches_give_the_same_product(rng, monkeypatch):
    """A plan forced to G = 3 (the reference's RS(200,56) split) runs the
    codec's product in three sub-launches and returns the planner's G = 1
    bytes."""
    M = _matrix(64, 32)
    D = rng.integers(0, 256, size=(64, 3000), dtype=np.uint8)
    one = DeviceCodec(device="cpu")
    assert one.plan_for(M)[3] == 1
    want = one.matmul_stripes(M, D)
    planner = dispatch_mod.panel_plan
    monkeypatch.setattr(dispatch_mod, "panel_plan",
                        lambda br, C: planner(br, C)[:2] + (3,))
    chains = []
    chain = dispatch_mod.gf2_matmul_panel_chain
    monkeypatch.setattr(dispatch_mod, "gf2_matmul_panel_chain",
                        lambda *a: chains.append(a[3]) or chain(*a))
    three = DeviceCodec(device="cpu")
    assert three.plan_for(M)[3] == 3
    np.testing.assert_array_equal(three.matmul_stripes(M, D), want)
    assert chains == [3]
    with pytest.raises(ValueError, match="panel"):
        one.plan_for(M, "fused")


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_panel_kernel_matches_plain_on_cuda(rng):
    """K7 against its plain version: at its plan, in the reference's three
    sub-launches (the accumulating launch), in a forced K split, and on a
    ragged plane width."""
    _require_cuda()
    br = _bits_rows(_matrix(64, 32))
    threads, tiles, _ = panel_plan(br, 512)
    tiles = tiles.to("cuda")
    planes = torch.from_numpy(_words(rng, (2, 512, 8, 512)).view(np.int32)).cuda()
    want = gf2_matmul_panel_plain(tiles, planes)
    for G in (1, 3):
        assert torch.equal(gf2_matmul_panel_chain(tiles, planes, threads, G),
                           want)
    assert torch.equal(gf2_matmul_panel(tiles, planes, threads, ksplit=5),
                       want)
    acc = torch.from_numpy(_words(rng, (2, 256, 8, 512)).view(np.int32)).cuda()
    acc_plain = acc.clone()
    gf2_matmul_panel(tiles, planes, threads, acc=acc, k_slice=(2, 9),
                     ksplit=3)
    gf2_matmul_panel_plain(tiles, planes, acc=acc_plain, k_slice=(2, 9))
    assert torch.equal(acc, acc_plain)
    ragged = planes[:, :, :, :98].contiguous()
    assert torch.equal(gf2_matmul_panel(tiles, ragged, threads),
                       gf2_matmul_panel_plain(tiles, ragged))


@pytest.mark.cuda
def test_blocked_pack_matches_plain_on_cuda(rng):
    _require_cuda()
    words = torch.from_numpy(_words(rng, (45, 16384)).view(np.int32)).cuda()
    planes = pack_words_lanes_blocked(words)
    assert torch.equal(planes, pack_words_lanes_blocked_plain(words))
    back = unpack_words_lanes_blocked(planes)
    assert torch.equal(back, unpack_words_lanes_blocked_plain(planes))
    assert torch.equal(back, words)
