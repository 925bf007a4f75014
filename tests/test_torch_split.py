"""The port's K-sliced fused encode (K5) on the GF(2) product core, its
mask operand and its planner against the reference's ``_dma_split_kernel``
in Pallas interpret mode, the reference's bit expansion and the NumPy field
arithmetic, and the planner order (K5 first). Exact to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.bitmatrix import expand_generator_bits as ref_expand
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu.ops.pallas_fused import (
    _build_planned_call,
    split_bits_rows_ksl as ref_split,
)
from noise_ec_tpu_torch.codec import ReedSolomon
from noise_ec_tpu_torch.gf import GF256, GF65536
from noise_ec_tpu_torch.matrix import (
    generator_matrix,
    host_matvec,
    reconstruction_matrix,
)
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.fused import (
    fused_split_encode_words,
    fused_split_encode_words_plain,
    fused_split_plan,
)
from noise_ec_tpu_torch.ops.gf2tile import build_tiles, ring_bytes
from noise_ec_tpu_torch.ops.network import SMEM_BYTES, compile_split
from noise_ec_tpu_torch.ops.xor_factor import split_bits_rows_ksl

_REF = RefDeviceCodec(field="gf256", kernel="pallas_interpret")

# RS(50,20) losing 10 data and 10 parity shards: the code's limit, a
# (20, 50) recovery matrix.
WIDE_LOST = list(range(0, 20, 2)) + list(range(50, 70, 2))


@pytest.fixture(scope="module")
def codec():
    """One CPU codec for the module: each matrix's expansion and plan are
    built once."""
    return DeviceCodec(device="cpu")


def _parity(k, r):
    return generator_matrix(GF256(), k, k + r, "cauchy")[k:]


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint8)


@pytest.mark.parametrize("k,r,ksl,TW", [
    (10, 4, 8, 16384),  # P = 2, one lane tile at TL = 256
    (17, 3, 8, 32768),  # P = 3, a one-row last slice, two lane tiles
])
def test_plain_split_matches_reference_dma_kernel(rng, k, r, ksl, TW):
    """The plain K5 equals the reference's K5 (``_dma_split_kernel``,
    interpreted) byte for byte on the same words, the reference's input
    zero-padded to P * ksl rows as its runner pads it."""
    M = ref_generator(RefGF256(), k, k + r, "cauchy")[k:]
    br = _REF.bits_rows_for(M)
    words = _words(rng, (k, TW))
    call, k_pad = _build_planned_call(br, k, r, TW, 8, ("dma", 256, ksl),
                                      True)
    assert k_pad == -(-k // ksl) * ksl
    padded = np.zeros((k_pad, TW), dtype=np.uint32)
    padded[:k] = words
    want = np.asarray(call(jnp.asarray(padded)))
    tiles = build_tiles(DeviceCodec(device="cpu").bits_rows_for(M), 8 * k,
                        8 * ksl)
    assert tiles.NT == -(-k // ksl)
    threads = tiles.threads
    reset_launch_counts()
    got = fused_split_encode_words(tiles, _t(words), r, threads)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        want.view(np.uint8), host_matvec(GF256(), M, words.view(np.uint8)))
    # A batch of three, the reference's words in the middle.
    batch = np.stack([words[::-1], words, words ^ np.uint32(0x5A5A5A5A)])
    got3 = fused_split_encode_words(tiles, _t(batch), r, threads)
    np.testing.assert_array_equal(got3[1].numpy().view(np.uint32), want)
    for b in (0, 2):
        np.testing.assert_array_equal(
            _u8(got3[b]), host_matvec(GF256(), M, batch[b].view(np.uint8)))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,ksl", [(10, 8), (17, 8), (17, 16), (50, 16)])
def test_split_bits_rows_matches_reference(codec, k, ksl):
    r = {10: 4, 17: 3, 50: 20}[k]
    br = codec.bits_rows_for(_parity(k, r))
    assert split_bits_rows_ksl(br, k, 8, ksl) == ref_split(br, k, 8, ksl)


@pytest.mark.parametrize("k,r,threads", [(50, 20, 320), (64, 16, 256)])
def test_wide_parity_plans_split_and_matches_host(codec, rng, k, r, threads):
    M = _parity(k, r)
    kind, got_threads, tiles, G = codec.plan_for(M)
    assert (kind, got_threads, tiles.KT, G) == ("split", threads, 32, 1)
    D = rng.integers(0, 256, size=(k, 3000), dtype=np.uint8)
    np.testing.assert_array_equal(codec.matmul_stripes(M, D),
                                  host_matvec(GF256(), M, D))
    w = _words(rng, (2, k, 8192))
    got = fused_split_encode_words_plain(tiles, _t(w), r, 128)
    for b in range(2):
        np.testing.assert_array_equal(
            _u8(got[b]), host_matvec(GF256(), M, w[b].view(np.uint8)))


def test_wide_recovery_matrix_plans_split(codec, rng):
    """RS(50,20) at its 20-erasure limit: the (20, 50) recovery matrix
    runs on K5 too, and rebuilds what was lost; a batch of three ragged
    stripes (TW off the word quantum) through the words entry."""
    gf = GF256()
    G = generator_matrix(gf, 50, 70, "cauchy")
    present = [i for i in range(70) if i not in WIDE_LOST]
    R = reconstruction_matrix(gf, G, present[:50], WIDE_LOST)
    kind, threads, tiles, _ = codec.plan_for(R)
    assert (kind, threads, tiles.KT) == ("split", 320, 32)
    data = rng.integers(0, 256, size=(50, 2048), dtype=np.uint8)
    full = np.concatenate([data, host_matvec(gf, G[50:], data)])
    np.testing.assert_array_equal(
        codec.matmul_stripes(R, full[present[:50]]), full[WIDE_LOST])
    w = _words(rng, (3, 50, 1001))
    got = codec.matmul_words_batch(R, _t(w))
    assert tuple(got.shape) == (3, 20, 1001)
    for b in range(3):
        np.testing.assert_array_equal(
            _u8(got[b]), host_matvec(gf, R, w[b].view(np.uint8)))


def test_gf16_rs_30_10_runs_split(rng):
    """GF(2^16) RS(30,10) runs byte-sliced over 60 byte rows on K5, for
    encode and a 10-erasure reconstruct."""
    from noise_ec_tpu.codec.rs import ReedSolomon as RefRS

    rs = ReedSolomon(30, 10, field="gf65536", device="cpu")
    kind, threads, tiles, _ = rs._dev.plan_for(rs.G[30:])
    assert (kind, threads, tiles.KT, tiles.n_inputs, tiles.n_rows) == (
        "split", 320, 32, 480, 160)
    ref = RefRS(30, 10, field="gf65536", backend="numpy")
    data = list(rng.integers(0, 256, size=(30, 2048), dtype=np.uint8))
    enc = rs.encode(data)
    want = ref.encode(data)
    assert all(np.array_equal(a, b) for a, b in zip(enc, want))
    holes = [None if i % 4 == 1 else s for i, s in enumerate(enc)]
    assert sum(s is None for s in holes) == 10
    rec = rs.reconstruct(holes)
    assert all(np.array_equal(a, b) for a, b in zip(rec, enc))


@pytest.mark.parametrize("k,r,KT,WC", [(10, 4, 32, 2), (17, 3, 8, 1),
                                       (50, 20, 64, 3)])
def test_operand_bits_equal_the_expansion(k, r, KT, WC):
    """The mask operand holds -1 exactly at the set bits of the
    reference's (8r, 8k) expansion, zero in its padding, in the tiled
    layout the kernel stages ((row group, K tile, plane, row))."""
    M = ref_generator(RefGF256(), k, k + r, "cauchy")[k:]
    bits = ref_expand(RefGF256(), M)
    tiles = build_tiles(_REF.bits_rows_for(M), 8 * k, KT, WC=WC)
    np.testing.assert_array_equal(tiles.matrix().numpy(),
                                  -bits.astype(np.int32))
    m = tiles.masks.numpy()
    assert m.shape == (tiles.NRG, -(-8 * k // KT), KT, tiles.RGR)
    assert set(np.unique(m)) <= {0, -1}
    assert int((m != 0).sum()) == int(bits.sum())
    for t in range(m.shape[1]):  # tile t, plane c, row q = bit (q, t*KT+c)
        c = t * KT
        if c < 8 * k:
            np.testing.assert_array_equal(
                m[0, t, 0, :8 * r], -bits[:, c].astype(np.int32))


def test_split_plan_takes_the_largest_block_then_the_fewest_xors(
        codec, monkeypatch):
    """K5's plan is the widest block whose ring fits: one warp a row
    block (RS(50,20): five), up to SPLIT_WC column warps (at most 16 warps
    in all), at SPLIT_KSL-row phases, halving the phase only when not even
    one column warp fits. No network is factored, so the plan costs no
    XOR count; the old factored split is still the reference's."""
    import noise_ec_tpu_torch.ops.fused as fused

    br = codec.bits_rows_for(_parity(50, 20))
    threads, ksl, tiles = fused_split_plan(br, 50, 20)
    assert (threads, ksl, tiles.WR, tiles.WC, tiles.NT) == (320, 4, 5, 2, 13)
    assert tiles.ring_bytes == ring_bytes(32, 128, 160) == 73_728
    assert tiles.ring_bytes <= SMEM_BYTES

    def plan_at(nbytes):
        monkeypatch.setattr(fused, "SMEM_BYTES", nbytes)
        fused.fused_split_plan.cache_clear()
        return fused_split_plan(br, 50, 20)

    try:
        # At exactly the two-warp ring, two column warps; a byte below,
        # one (57,344 bytes); below that, 2-row phases at two (36,864).
        assert plan_at(73_728)[:2] == (320, 4)
        threads, ksl, tiles = plan_at(73_727)
        assert (threads, ksl, tiles.ring_bytes) == (160, 4, 57_344)
        threads, ksl, tiles = plan_at(57_343)
        assert (threads, ksl, tiles.KT, tiles.ring_bytes) == (
            320, 2, 16, 36_864)
    finally:
        fused.fused_split_plan.cache_clear()
    br17 = codec.bits_rows_for(_parity(17, 3))
    threads, ksl, tiles17 = fused_split_plan(br17, 17, 3)
    assert (threads, ksl, tiles17.NT, tiles17.NRG) == (64, 4, 5, 1)
    # The factored slices the reference's "dma" plan runs stay available.
    assert compile_split(br17, 17, 8).P == 3


def test_planner_order_and_forced_split(codec, rng, monkeypatch):
    """K5 first, then K1, then the pipeline: every baked matrix measured
    ran faster on K5 (PERF.md), so RS(4,2) through RS(50,20) plan onto it
    without factoring any network; forcing "fused" on RS(10,4) gives K1
    and the same bytes; forcing "split" on the interleaved GF(2^16) entry
    runs K5 at m = 16 and gives the host arithmetic's words."""
    import noise_ec_tpu_torch.ops.fused as fused

    def no_factoring(*args, **kwargs):
        raise AssertionError("the default plan factored a network")

    monkeypatch.setattr(fused, "compile_network", no_factoring)
    fresh = DeviceCodec(device="cpu")
    for k, r in ((4, 2), (10, 4), (17, 3), (30, 10), (50, 20)):
        assert fresh.plan_for(_parity(k, r))[0] == "split"
    monkeypatch.undo()
    M = _parity(10, 4)
    kind, threads, prog, _ = codec.plan_for(M, "fused")
    assert kind == "fused" and prog.n_inputs == 80
    D = rng.integers(0, 256, size=(10, 5000), dtype=np.uint8)
    np.testing.assert_array_equal(codec.matmul_stripes(M, D, tier="fused"),
                                  codec.matmul_stripes(M, D))
    w = _t(_words(rng, (10, 700)))
    assert torch.equal(codec.matmul_words(M, w, tier="fused"),
                       codec.matmul_words(M, w))
    codec16 = DeviceCodec(field="gf65536", device="cpu")
    M16 = generator_matrix(GF65536(), 4, 6)[4:]
    w16 = _words(rng, (4, 64))
    np.testing.assert_array_equal(
        codec16.matmul_words(M16, _t(w16), tier="split").numpy().view("<u2"),
        host_matvec(GF65536(), M16, w16.view("<u2")))


def test_split_rejects_what_it_cannot_run(codec):
    threads, _, tiles = fused_split_plan(codec.bits_rows_for(_parity(10, 4)),
                                         10, 4)
    words = torch.zeros((10, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        fused_split_encode_words(tiles, words[:9], 4, threads)
    with pytest.raises(ValueError, match="does not fit"):
        fused_split_encode_words(tiles, words, 4, 2 * threads)
    with pytest.raises(ValueError, match="int32"):
        fused_split_encode_words(
            tiles, torch.zeros((10, 16384), dtype=torch.int32)[:, ::2], 4,
            threads)
    with pytest.raises(ValueError, match="no kernel"):
        fused_split_encode_words(tiles, words.to("meta"), 4, threads)


@pytest.mark.parametrize("tl", [1, 2])
def test_split_refuses_lane_tiles_below_four(codec, tl):
    """K5's ring copies four neighbouring groups' word i as one 16-byte
    chunk, so a TL below 4 is refused before any launch, on the CPU as on
    the card, even where the words' width would allow it."""
    threads, _, tiles = fused_split_plan(codec.bits_rows_for(_parity(10, 4)),
                                         10, 4)
    words = torch.zeros((10, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="TL"):
        fused_split_encode_words(tiles, words, 4, threads, tl=tl)
    assert fused_split_encode_words(tiles, words, 4, threads, tl=4).shape == (
        4, 8192)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds K5 on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(10, 4), (17, 3), (50, 20)])
def test_split_kernel_matches_plain_on_cuda(codec, rng, k, r):
    """K5 against its plain version at its plan, in a forced K split (the
    phases over three blocks a column tile, XORed atomically), and on a
    batch of three at the smallest word quantum."""
    _require_cuda()
    M = _parity(k, r)
    threads, _, tiles = fused_split_plan(codec.bits_rows_for(M), k, r)
    tiles = tiles.to("cuda")
    words = _t(_words(rng, (k, 65536))).cuda()
    want = fused_split_encode_words_plain(tiles, words, r, 128)
    assert torch.equal(fused_split_encode_words(tiles, words, r, threads),
                       want)
    assert torch.equal(
        fused_split_encode_words(tiles, words, r, threads, ksplit=3), want)
    batch = _t(_words(rng, (3, k, 8192))).cuda()
    assert torch.equal(fused_split_encode_words(tiles, batch, r, threads),
                       fused_split_encode_words_plain(tiles, batch, r, 128))
