"""The port's panel route against the reference: the plain block-panel
matmul (K7) against the reference's panel Pallas kernel in interpret mode,
the row-blocked pack and unpack (K6) against the reference's, the per-panel
factoring against ``factor_panels``, the shared-memory planner's bounds,
the three-way routing, and wide codes end to end against the reference's
``backend="numpy"`` codec. Exact to the bit."""

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
from noise_ec_tpu_torch.ops.network import SMEM_BYTES, compile_panels
from noise_ec_tpu_torch.ops.pack import (
    blocked_lane_tl,
    pack_words_lanes_blocked,
    pack_words_lanes_blocked_plain,
    unpack_words_lanes_blocked,
    unpack_words_lanes_blocked_plain,
)
from noise_ec_tpu_torch.ops.panel import (
    MIN_TEMP_CAP,
    gf2_matmul_panel,
    gf2_matmul_panel_chain,
    gf2_matmul_panel_plain,
    panel_plan,
    panel_smem_bytes,
    panel_temp_cap,
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
# Forced plans as (KB, RB, temp_cap, G); each spans several K and R blocks.
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
    prog = compile_panels(rows, 45, KB, RB, cap)
    assert (prog.PR, prog.PK) == (-(-19 // RB), -(-45 // KB))
    planes = torch.from_numpy(tiled.view(np.int32).copy())
    reset_launch_counts()
    got = gf2_matmul_panel_chain(prog, planes, 32, G)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The sub-launches by hand: the first K slice, then each later slice
    # XORed into it in place; batched planes give each batch its own rows.
    bounds = sublaunch_bounds(prog.PK, G)
    batch = torch.stack([planes, planes.flip(2)])
    acc = gf2_matmul_panel(prog, batch, 32, k_slice=tuple(bounds[:2]))
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        assert gf2_matmul_panel(prog, batch, 32, acc=acc,
                                k_slice=(lo, hi)) is acc
    np.testing.assert_array_equal(acc[0].numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        acc[1], gf2_matmul_panel_plain(prog, planes.flip(2).contiguous())
    )
    assert all(n == 0 for n in launch_counts().values())


def test_panel_rejects_bad_operands(uneven):
    _, tiled = uneven
    prog = compile_panels(ref_bits_to_rows(uneven[0]), 45, 8, 4, 64)
    planes = torch.from_numpy(tiled.view(np.int32).copy())
    with pytest.raises(ValueError, match="planes"):
        gf2_matmul_panel(prog, planes[:44].contiguous(), 32)
    with pytest.raises(ValueError, match="slice"):
        gf2_matmul_panel(prog, planes, 32, k_slice=(3, 3))
    with pytest.raises(ValueError, match="acc"):
        gf2_matmul_panel(prog, planes, 32, acc=torch.zeros((18, 8, 98),
                                                           dtype=torch.int32))


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
    M = _matrix(k, r, erasures)
    br = _bits_rows(M)
    C = 8 * M.shape[1]
    threads, prog, G = panel_plan(br, C)
    KB, RB, cap = prog.KB, prog.RB, prog.temp_cap
    assert G == 1 and cap >= 1
    assert panel_smem_bytes(KB, RB, threads, cap) <= SMEM_BYTES
    assert int(np.diff(prog.op_ptr.numpy()).max()) <= cap
    assert prog.n_slots <= KB + cap
    assert (prog.n_slots + RB) * threads * 4 <= SMEM_BYTES


def test_planner_reject_boundary(monkeypatch):
    """The cap is the largest temp count that fits; the planner takes the
    capped factoring down to MIN_TEMP_CAP temps at 32 threads and rejects
    one byte below, and a capped plan still computes the product. (32 x
    32 panels of RS(20,4) want more than MIN_TEMP_CAP temps.)"""
    KB = RB = 32
    for threads in (32, 64, 128, 256):
        cap = panel_temp_cap(KB, RB, threads)
        assert panel_smem_bytes(KB, RB, threads, cap) <= SMEM_BYTES
        assert panel_smem_bytes(KB, RB, threads, cap + 1) > SMEM_BYTES
    M = _matrix(20, 4)
    br = _bits_rows(M)
    assert factor_panels(split_bits_rows_panels(br, 160, KB, RB), KB)[1] > MIN_TEMP_CAP
    edge = panel_smem_bytes(KB, RB, 32, MIN_TEMP_CAP)
    monkeypatch.setattr(panel_mod, "SMEM_BYTES", edge)
    threads, prog, G = panel_plan(br, 160, KB, RB)
    assert (threads, G) == (32, 1)
    assert (prog.KB, prog.RB, prog.temp_cap) == (KB, RB, MIN_TEMP_CAP)
    assert int(np.diff(prog.op_ptr.numpy()).max()) == MIN_TEMP_CAP
    rng = np.random.default_rng(7)
    planes = _words(rng, (160, 8, 16))
    np.testing.assert_array_equal(
        gf2_matmul_panel_plain(prog, torch.from_numpy(planes.view(np.int32)))
        .numpy().view(np.uint32).reshape(32, -1),
        gf2_matmul_planes(ref_expand(_GF, M), planes.reshape(160, -1)),
    )
    monkeypatch.setattr(panel_mod, "SMEM_BYTES", edge - 1)
    with pytest.raises(ValueError, match="shared memory"):
        panel_plan(br, 160, KB, RB)


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
    _require_cuda()
    br = _bits_rows(_matrix(64, 32))
    threads, prog, _ = panel_plan(br, 512)
    prog = prog.to("cuda")
    planes = torch.from_numpy(_words(rng, (2, 512, 8, 512)).view(np.int32)).cuda()
    want = gf2_matmul_panel_plain(prog, planes)
    for G in (1, 3):
        assert torch.equal(gf2_matmul_panel_chain(prog, planes, threads, G), want)


@pytest.mark.cuda
def test_blocked_pack_matches_plain_on_cuda(rng):
    _require_cuda()
    words = torch.from_numpy(_words(rng, (45, 16384)).view(np.int32)).cuda()
    planes = pack_words_lanes_blocked(words)
    assert torch.equal(planes, pack_words_lanes_blocked_plain(words))
    back = unpack_words_lanes_blocked(planes)
    assert torch.equal(back, unpack_words_lanes_blocked_plain(planes))
    assert torch.equal(back, words)
