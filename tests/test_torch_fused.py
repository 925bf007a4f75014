"""The port's fused encode (K1) and its planner against the reference's
fused Pallas kernel in interpret mode and the golden codec. Exact to the
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.golden.codec import GoldenCodec
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu.ops.pallas_fused import fused_encode_words_planned
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.fused import (
    fused_encode_words,
    fused_encode_words_plain,
    fused_plan,
)
from noise_ec_tpu_torch.ops.gf2mm import sparse_plan
from noise_ec_tpu_torch.ops.network import (
    BLOCKS,
    SMEM_BYTES,
    TILES,
    compile_network,
    fits,
    schedule_program,
)

_GF = RefGF256()
_REF = RefDeviceCodec(field="gf256", kernel="pallas_interpret")


def _parity(k, r):
    return ref_generator(_GF, k, k + r, "cauchy")[k:]


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernels on the card")


@pytest.mark.parametrize("k,r", [(4, 2), (10, 4)])
def test_fused_matches_reference_kernel_and_golden(rng, k, r):
    TW = 8192
    M = _parity(k, r)
    br = _REF.bits_rows_for(M)
    words = _words(rng, (k, TW))
    want = np.asarray(
        fused_encode_words_planned(br, jnp.asarray(words), r, 8, interpret=True)
    )
    golden = GoldenCodec(k, k + r).encode(words.view(np.uint8))
    np.testing.assert_array_equal(want.view(np.uint8), golden)
    threads, prog = fused_plan(br, 8 * k)
    reset_launch_counts()
    got = fused_encode_words(prog, torch.from_numpy(words.view(np.int32)), r,
                             threads)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert all(n == 0 for n in launch_counts().values())


def test_fused_result_does_not_depend_on_the_lane_tile(rng):
    """The fused kernel's internal bijection is its own: any TL gives the
    same words (checked on the plain version at TL 128, 256 and 512), and
    a batch equals its members one by one."""
    k, r, TW = 10, 4, 32768
    M = _parity(k, r)
    threads, prog = fused_plan(_REF.bits_rows_for(M), 8 * k)
    words = torch.from_numpy(_words(rng, (2, k, TW)).view(np.int32))
    outs = [fused_encode_words_plain(prog, words, r, tl) for tl in (128, 256, 512)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    golden = GoldenCodec(k, k + r)
    for b in range(2):
        np.testing.assert_array_equal(
            outs[0][b].numpy().view(np.uint8),
            golden.encode(words[b].numpy().view(np.uint8)),
        )


@pytest.mark.parametrize("k,r,threads,slots", [
    (4, 2, 256, 77), (10, 4, 512, 306), (17, 3, 512, 347),
])
def test_planner_picks_the_largest_block_that_fits(k, r, threads, slots):
    """The plan's schedule fits the widest tile (64 columns), with sixteen
    warps where an SM holds fewer than four such blocks."""
    plan = fused_plan(_REF.bits_rows_for(_parity(k, r)), 8 * k)
    assert plan is not None
    assert (plan[0], plan[1].n_slots) == (threads, slots)
    assert plan[1].tiles[0] == 64 and fits(plan[1], 64)
    assert plan[1].smem_bytes(64) <= SMEM_BYTES


def test_planner_caps_temps_then_gives_up(monkeypatch):
    """With less shared memory K1's planner first sums the output rows in
    chains, then caps the temporaries (accepting at most 1.25x the full XOR
    count), then returns no plan. The codec tries K5 first: its planner
    halves the phase until the ring fits (RS(17,3) under a budget K1 cannot
    meet); the codec takes K1 where K5 has no plan, and routes a matrix
    that neither kernel holds to the pipeline."""
    import noise_ec_tpu_torch.ops.dispatch as dispatch
    import noise_ec_tpu_torch.ops.fused as fused
    import noise_ec_tpu_torch.ops.network as network

    M = _parity(10, 4)
    br = _REF.bits_rows_for(M)
    full = compile_network(br, 80)

    def budget(nbytes):
        monkeypatch.setattr(network, "SMEM_BYTES", nbytes)
        monkeypatch.setattr(fused, "SMEM_BYTES", nbytes)
        fused.fused_plan.cache_clear()
        fused.fused_split_plan.cache_clear()

    try:
        # 9,000 bytes: the full factoring's 253 chained slots at an 8-column
        # tile and its program do not fit; a capped network's do.
        budget(9_000)
        assert not fits(schedule_program(full, row_width=1), 8)
        threads, prog = fused.fused_plan(br, 80)
        assert threads == 1024 and prog.n_slots < 253 and fits(prog, 8)
        assert prog.tiles == (8,)
        assert full.cost < prog.cost <= 1.25 * full.cost
        # RS(17,3) in 10,000 bytes: K1's cap would cost more than 1.25x;
        # K5's ring of 2-row phases needs 12,288 bytes at one column warp,
        # one of 1-row phases 6,144.
        budget(10_000)
        M17 = _parity(17, 3)
        br17 = _REF.bits_rows_for(M17)
        assert fused.fused_plan(br17, 136) is None
        kind, threads, tiles, G = DeviceCodec(device="cpu").plan_for(M17)
        assert (kind, threads, tiles.KT, tiles.ring_bytes, G) == (
            "split", 32, 8, 6_144, 1)
        # Below K5's smallest ring (one-row phases, one column warp: 6,144
        # bytes) and K1's capped slots, the pipeline.
        budget(6_000)
        assert fused.fused_plan(br, 80) is None
        assert fused.fused_split_plan(br, 10, 4) is None
        codec = DeviceCodec(device="cpu")
        kind, threads, prog, G = codec.plan_for(M)
        assert kind == "pipeline" and prog.in_slot is None and G == 1
        with pytest.raises(ValueError, match="no fused-kernel plan"):
            codec.plan_for(M, "fused")
        with pytest.raises(ValueError, match="no split-kernel plan"):
            codec.plan_for(M, "split")
        budget(SMEM_BYTES)
        monkeypatch.setattr(dispatch, "fused_split_plan", lambda *a: None)
        assert DeviceCodec(device="cpu").plan_for(M)[:2] == (
            "fused", fused.fused_plan(br, 80)[0])
    finally:
        fused.fused_plan.cache_clear()
        fused.fused_split_plan.cache_clear()


def test_fused_rejects_programs_it_cannot_run(rng):
    br = _REF.bits_rows_for(_parity(4, 2))
    words = torch.zeros((4, 8192), dtype=torch.int32)
    _, external = sparse_plan(br, 32)
    with pytest.raises(ValueError, match="does not fit"):
        fused_encode_words(external, words, 2, 256)  # K4's program form
    _, prog = fused_plan(br, 32)
    with pytest.raises(ValueError, match="does not fit"):
        fused_encode_words(prog, words[:3], 2, 256)
    with pytest.raises(ValueError, match="no kernel"):
        fused_encode_words(prog, words.to("meta"), 2, 256)
    assert fits(prog, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(4, 2), (10, 4), (17, 3)])
def test_fused_kernel_matches_plain_on_cuda(rng, k, r):
    """K1 at its plan and at every tile and block its schedule fits, on a
    ragged last tile, against its plain version."""
    _require_cuda()
    threads, prog = fused_plan(_REF.bits_rows_for(_parity(k, r)), 8 * k)
    prog = prog.to("cuda")
    words = torch.from_numpy(_words(rng, (k, 65536 + 1024)).view(np.int32))
    words = words.cuda()
    want = fused_encode_words_plain(prog, words, r, 128)
    assert torch.equal(fused_encode_words(prog, words, r, threads), want)
    for tile in prog.tiles:
        for t in BLOCKS:
            got = fused_encode_words(prog, words, r, t, tile=tile)
            assert torch.equal(got, want), (tile, t)
    assert set(prog.tiles) <= set(TILES)
