"""K11/K12 on the GF(2) product core (``csrc/dense.cu`` on
``csrc/gf2tile.cuh``): a NumPy walk of the kernel's index math in its own
order — the block grid, the K ranges of a split (``k_range``), the ring's
stages (stale words left from earlier tiles), the plane copies of 4 or 1
words with their edge tests, the row-major masks staged transposed into
[KT][rgr + kMaskPad] with zero edges, each warp's copy landing in 32
banks, the warps along K and the shared-memory sums they park, the column
and row edges of the stores — held against
``gf2_matmul_dense_plain`` and the reference's ``gf2_matmul_pallas`` /
``gf2_matmul_pallas_tiled`` in interpret mode; the shape planner
``dense_shape`` pinned for a 132-SM card; the wrapper's copy width. The
``cuda`` cases run on the card (``python -m pytest -m cuda
tests/test_torch_dense_core.py``). Tolerance: byte-identical throughout."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.ops import pallas_gf2mm as ref_gf2mm
from noise_ec_tpu_torch.gf import GF256, expand_generator_masks
from noise_ec_tpu_torch.matrix import generator_matrix
from noise_ec_tpu_torch.ops import gf2tile
from noise_ec_tpu_torch.ops.gf2mm import (
    _dense,
    dense_copy_words,
    gf2_matmul_dense,
    gf2_matmul_dense_plain,
    gf2_matmul_dense_tiled,
    gf2_matmul_dense_tiled_plain,
)
from noise_ec_tpu_torch.ops.gf2tile import (
    COLS,
    DENSE_KT,
    DENSE_MIN_WARPS,
    DENSE_STAGES,
    DENSE_TILE_COST,
    MASK_PAD,
    MAX_WARPS,
    ROW_BLOCK,
    dense_shape,
    dense_smem_bytes,
)
from noise_ec_tpu_torch.ops.network import SMEM_BYTES

CORE = (Path(__file__).resolve().parent.parent / "noise_ec_tpu_torch"
        / "csrc" / "gf2tile.cuh")
SMS = 132
# The edge-hitting shapes (R, C, W): a partial column tile and W % 4 != 0,
# R not a multiple of 32 with C not a multiple of the K tile, W < ncol.
SHAPES = [(32, 80, 300), (20, 37, 33), (40, 24, 1001)]


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _select(rng, shape):
    return (rng.integers(0, 2, size=shape).astype(np.uint32)
            * np.uint32(0xFFFFFFFF))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _k_range(lo, hi, parts, part):
    n = hi - lo
    return lo + n * part // parts, lo + n * (part + 1) // parts


def emulate(masks, planes, KT, WR, WC, WK, ksplit, vec, rng):
    """csrc/gf2tile.cuh masked_kernel<vec, RowMajorMasks> as launched by
    ec_gf2mm_dense, block by block; shared memory starts as random words
    and keeps what earlier tiles left, and the unstored output holds
    random words, so a word read or left where the kernel must not
    shows."""
    R, C = masks.shape
    W = planes.shape[1]
    assert KT % 8 == 0 and KT % WK == 0 and (vec == 1 or W % 4 == 0)
    rgr, ncol = ROW_BLOCK * WR, 32 * COLS * WC
    nrc, kn = WR * WC, KT // WK
    warps = nrc * WK
    assert warps <= MAX_WARPS
    mld = rgr + MASK_PAD
    NT, NRG = -(-C // KT), -(-R // rgr)
    smem_words = dense_smem_bytes(KT, WR, WC, WK) // 4
    stage_words = KT * (ncol + mld)
    out = (np.zeros((R, W), np.uint32) if ksplit > 1
           else _words(rng, (R, W)))
    written = np.zeros((R, W), np.int64)
    lanes = np.arange(32)
    # A lane's columns: warp column wc, lane l, kCols columns 32 apart.
    cols = np.array([wc * 32 * COLS + l + 32 * i for wc in range(WC)
                     for l in range(32) for i in range(COLS)])
    assert sorted(cols) == list(range(ncol))
    # Where warp (wrc, wk > 0) parks accumulator (i, r) of each lane.
    park = np.array([((((wk - 1) * nrc + wrc) * COLS + i) * ROW_BLOCK + r)
                     * 32 + l for wk in range(1, WK) for wrc in range(nrc)
                     for i in range(COLS) for r in range(ROW_BLOCK)
                     for l in range(32)], dtype=np.int64)
    assert len(set(park)) == len(park) and (park < smem_words).all()
    chunks = ncol // vec
    for bx in range(-(-W // ncol)):
        col0 = bx * ncol
        for rg in range(NRG):
            for part in range(ksplit):
                t0, t1 = _k_range(0, NT, ksplit, part)
                assert DENSE_STAGES * stage_words <= smem_words
                stages = [(_words(rng, (KT, ncol)), _words(rng, (KT, mld)))
                          for _ in range(DENSE_STAGES)]
                acc = np.zeros((WK, rgr, ncol), np.uint32)
                for t in range(t0, t1):
                    sp, sm = stages[(t - t0) % DENSE_STAGES]
                    for e in range(KT * chunks):
                        c, x = e // chunks, vec * (e % chunks)
                        if t * KT + c < C and col0 + x < W:
                            sp[c, x:x + vec] = planes[t * KT + c,
                                                      col0 + x:col0 + x + vec]
                    for warp in range(warps):
                        for r4 in range(warp, rgr // 4, warps):
                            r = 4 * r4 + lanes // 8
                            row = rg * rgr + r
                            for c8 in range(0, KT, 8):
                                c = c8 + lanes % 8
                                dst = c * mld + r
                                # One warp's copy: 32 words in 32 banks.
                                assert len(set(dst % 32)) == 32
                                ok = (row < R) & (t * KT + c < C)
                                val = np.where(ok, masks[np.minimum(row, R - 1),
                                                         np.minimum(t * KT + c,
                                                                    C - 1)], 0)
                                sm[c, r] = val
                    for wk in range(WK):
                        k = slice(wk * kn, (wk + 1) * kn)
                        acc[wk] ^= np.bitwise_xor.reduce(
                            sm[k, :rgr, None] & sp[k, None, :], axis=0)
                total = np.bitwise_xor.reduce(acc, axis=0)
                rows = rg * rgr + np.arange(rgr)
                keep_r = rows < R
                keep_c = col0 + np.arange(ncol) < W
                sub = total[keep_r][:, keep_c]
                rr, cc = rows[keep_r], col0 + np.arange(ncol)[keep_c]
                if ksplit > 1:
                    out[np.ix_(rr, cc)] ^= sub
                else:
                    out[np.ix_(rr, cc)] = sub
                written[np.ix_(rr, cc)] += 1
    assert (written == ksplit).all()
    return out


def _plain(masks, planes):
    return gf2_matmul_dense_plain(_t(masks), _t(planes)).numpy().view(
        np.uint32)


def _shapes_for(R, C, W):
    """The planner's shape and forced ones: every K split up to the tile
    count at one and two column warps and one and two warps along K, and
    the narrowest K tile with four warps along K."""
    planned = dense_shape(R, C, W, SMS)
    KT, WR = planned[0], planned[1]
    NT = -(-C // KT)
    forced = {(KT, WR, WC, WK, ks) for WC in (1, 2) for WK in (1, 2)
              for ks in {1, 2, NT}}
    forced.add((8, WR, 1, 4, min(3, -(-C // 8))))
    return [planned] + sorted(forced - {planned})


@pytest.mark.parametrize("R, C, W", SHAPES)
@pytest.mark.parametrize("kind", ["select", "random"])
def test_emulated_kernel_matches_plain_and_reference(rng, R, C, W, kind):
    masks = _select(rng, (R, C)) if kind == "select" else _words(rng, (R, C))
    planes = _words(rng, (C, W))
    want = np.asarray(ref_gf2mm.gf2_matmul_pallas(
        jnp.asarray(masks), jnp.asarray(planes), interpret=True))
    np.testing.assert_array_equal(_plain(masks, planes), want)
    np.testing.assert_array_equal(
        gf2_matmul_dense(_t(masks), _t(planes)).numpy().view(np.uint32), want)
    for shape in _shapes_for(R, C, W):
        for vec in ((1, 4) if W % 4 == 0 else (1,)):
            np.testing.assert_array_equal(
                emulate(masks, planes, *shape, vec, rng), want,
                err_msg=f"shape {shape}, {vec}-word copies")


@pytest.mark.parametrize("kind", ["select", "random"])
def test_emulated_tiled_kernel_matches_reference(rng, kind):
    """K12 is K11 on the contiguous (C, 8 W8) view: RS(5,3)'s (24, 40)
    masks over W8 = 37 (W = 296 words a plane)."""
    gf = GF256()
    masks = expand_generator_masks(gf, generator_matrix(gf, 5, 8)[5:]).view(
        np.uint32)
    if kind == "random":
        masks = _words(rng, masks.shape)
    tiled = _words(rng, (40, 8, 37))
    want = np.asarray(ref_gf2mm.gf2_matmul_pallas_tiled(
        jnp.asarray(masks), jnp.asarray(tiled), interpret=True))
    got = gf2_matmul_dense_tiled(_t(masks), _t(tiled))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    flat = tiled.reshape(40, -1)
    for shape in _shapes_for(24, 40, flat.shape[1])[:3]:
        np.testing.assert_array_equal(
            emulate(masks, flat, *shape, 4, rng).reshape(want.shape), want)


def test_sliced_masks_and_offset_planes_match_reference(rng):
    """A slice of a wider mask matrix and planes starting one word into
    their rows: the CPU path and the emulation of the 4-byte copies agree
    with the reference on the same values."""
    big = _words(rng, (40, 90))
    masks = big[3:35, 5:85]
    planes_big = _words(rng, (80, 301))
    planes = planes_big[:, 1:]
    want = np.asarray(ref_gf2mm.gf2_matmul_pallas(
        jnp.asarray(np.ascontiguousarray(masks)),
        jnp.asarray(np.ascontiguousarray(planes)), interpret=True))
    tm = torch.from_numpy(big.view(np.int32))[3:35, 5:85]
    tp = torch.from_numpy(planes_big.view(np.int32))[:, 1:]
    assert not tm.is_contiguous() and tm.stride() == (90, 1)
    assert dense_copy_words(tp) == 1
    np.testing.assert_array_equal(
        gf2_matmul_dense(tm, tp).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        emulate(masks, planes, *dense_shape(32, 80, 300, SMS), 1, rng), want)


def test_dense_copy_words():
    base = torch.zeros((8, 1024), dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    assert dense_copy_words(base) == 4
    assert dense_copy_words(base[:, :1001]) == 1  # W % 4
    assert dense_copy_words(base[:, 1:1001]) == 1  # 4 bytes off
    assert dense_copy_words(base[:, 4:1004]) == 4  # 16 bytes off
    assert dense_copy_words(base.reshape(16, 512)[::2]) == 4  # row stride
    assert dense_copy_words(base.reshape(-1)[:7 * 1001].reshape(7, 1001)) == 1


@pytest.mark.parametrize("R, C, W, want", [
    (32, 80, 32768, (16, 1, 2, 2, 1)),
    (160, 400, 32768, (32, 5, 2, 1, 1)),
    (32, 80, 2048, (16, 1, 1, 2, 5)),
])
def test_dense_shape_pinned(R, C, W, want):
    KT, WR, WC, WK, ksplit = dense_shape(R, C, W, SMS)
    assert (KT, WR, WC, WK, ksplit) == want
    rgr, ncol = ROW_BLOCK * WR, 32 * COLS * WC
    assert dense_smem_bytes(KT, WR, WC, WK) <= SMEM_BYTES
    blocks = -(-W // ncol) * -(-R // rgr)
    NT = -(-C // KT)
    # Every SM gets a block, or the split takes every K tile it can.
    assert blocks * ksplit >= SMS or ksplit == NT
    if blocks >= SMS:
        assert ksplit == 1


@pytest.mark.parametrize("R", [1, 20, 32, 64, 160, 448, 512, 600])
@pytest.mark.parametrize("C", [1, 8, 37, 80, 400, 1600])
def test_dense_shape_invariants(R, C):
    for W in (1, 33, 300, 1001, 2048, 8192, 32767, 262144):
        KT, WR, WC, WK, ksplit = dense_shape(R, C, W, SMS)
        assert KT in DENSE_KT and WR * WC * WK <= MAX_WARPS
        rgr, ncol = ROW_BLOCK * WR, 32 * COLS * WC
        assert dense_smem_bytes(KT, WR, WC, WK) <= SMEM_BYTES
        NT = -(-C // KT)
        # The K tile costs least: padded planes and a fixed cost a tile.
        assert NT * (KT + DENSE_TILE_COST) == min(
            -(-C // k) * (k + DENSE_TILE_COST) for k in DENSE_KT)
        assert 1 <= ksplit <= NT
        blocks = -(-W // ncol) * -(-R // rgr)
        # Never a split where some column shape fills the card.
        fills = any(-(-W // (32 * COLS * wc)) * -(-R // rgr) >= SMS
                    for wc in range(1, min(gf2tile.DENSE_WC,
                                           MAX_WARPS // WR) + 1))
        if fills:
            assert ksplit == 1 and blocks >= SMS
        else:
            assert WC == 1 and ksplit == min(NT, -(-SMS // blocks))
        # Warps along K only where the launch leaves SMs short of warps.
        few = blocks * ksplit * WR * WC < DENSE_MIN_WARPS * SMS
        assert WK == (2 if few and 2 * WR * WC <= MAX_WARPS else 1)


def test_dense_shape_refuses_empty():
    with pytest.raises(ValueError):
        dense_shape(0, 80, 100, SMS)
    with pytest.raises(ValueError):
        dense_shape(32, 80, 100, 0)


def test_core_constants_match_source():
    """The planner's constants are the core's (csrc/gf2tile.cuh)."""
    src = CORE.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kRowBlock"] == ROW_BLOCK
    assert consts["kStages"] == gf2tile.STAGES
    assert consts["kMaxThreads"] == 32 * gf2tile.MAX_WARPS
    assert consts["kCols"] == COLS
    assert consts["kMaskPad"] == MASK_PAD
    ring = re.search(r"struct RowMajorMasks \{.*?kRing = (\d+);", src,
                     re.S)
    assert int(ring.group(1)) == DENSE_STAGES
    assert all(kt % 8 == 0 for kt in DENSE_KT)


def test_empty_products_launch_nothing():
    for R, C, W in ((0, 4, 8), (4, 0, 8), (4, 4, 0)):
        out = gf2_matmul_dense(torch.zeros((R, C), dtype=torch.int32),
                               torch.zeros((C, W), dtype=torch.int32))
        assert out.shape == (R, W) and not out.any()


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.cuda
def test_dense_core_matches_plain_on_cuda(rng):
    """Every edge on the card: odd W, planes 4 bytes off, sliced masks,
    R = 20, the K split (planned and forced), random words and RS(50,20)'s
    select masks; K12 against K11."""
    _require_cuda()
    dev = torch.device("cuda")

    def check(masks, planes, shape=None):
        got = _dense(masks, planes, "gf2mm_dense", shape)
        assert torch.equal(got, gf2_matmul_dense_plain(masks, planes))

    m = _t(_words(rng, (32, 80))).to(dev)
    for W in (32767, 1001, 2048, 33):
        check(m, _t(_words(rng, (80, W))).to(dev))
    big = _t(_words(rng, (80, 4100))).to(dev)
    check(m, big[:, 1:4097])
    wide = _t(_words(rng, (40, 90))).to(dev)
    check(wide[3:35, 5:85], _t(_words(rng, (80, 4096))).to(dev))
    check(_t(_words(rng, (20, 80))).to(dev),
          _t(_words(rng, (80, 4096))).to(dev))
    check(m, _t(_words(rng, (80, 8192))).to(dev), (16, 1, 2, 1, 3))
    check(m, _t(_words(rng, (80, 8192))).to(dev), (8, 1, 1, 4, 2))
    gf = GF256()
    m50 = torch.from_numpy(expand_generator_masks(
        gf, generator_matrix(gf, 50, 70)[50:])).to(dev)
    check(m50, _t(_words(rng, (400, 4096))).to(dev))
    tiled = _t(_words(rng, (80, 8, 4096))).to(dev)
    out = gf2_matmul_dense_tiled(m, tiled)
    assert torch.equal(out, gf2_matmul_dense_tiled_plain(m, tiled))
    assert torch.equal(out.reshape(32, -1),
                       gf2_matmul_dense(m, tiled.reshape(80, -1)))
