"""The m = 16 forms of the fused kernels and the lane pack against the
reference: K2/K3 (and K6, their kernel at the blocked TL) at 16 planes a
symbol against ``pack_words_lanes(xw, 16, ...)`` in Pallas interpret mode,
K5 and K1 at m = 16 against the reference's ``_dma_split_kernel`` and
``_fused_kernel`` at m = 16, the interleaved GF(2^16) words entry under
every tier and on the panel route against the reference's
``_fused_words16_fn`` / ``_panel_words_fn``, the byte-sliced entry and the
host arithmetic, its planner, and the GF(2^16) streams against the
reference's interpreted words path. Tolerance: byte-identical throughout.
The ``cuda``-marked cases hold each m = 16 kernel against its plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu.ops.dispatch import _fused_words16_fn, _panel_words_fn
from noise_ec_tpu.ops.pallas_fused import _build_planned_call
from noise_ec_tpu.ops.pallas_gf2mm import panel_plan as ref_panel_plan
from noise_ec_tpu.ops.pallas_pack import (
    _lane_tl,
    pack_words_lanes as ref_pack,
    pack_words_lanes_blocked as ref_pack_blocked,
    unpack_words_lanes as ref_unpack,
    unpack_words_lanes_blocked as ref_unpack_blocked,
)
from noise_ec_tpu.parallel.streaming import (
    StreamingDecoder as RefDecoder,
    StreamingEncoder as RefEncoder,
)
from noise_ec_tpu_torch.gf import GF65536
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.fused import (
    fused_encode_words,
    fused_encode_words_plain,
    fused_plan,
    fused_split_encode_words,
    fused_split_encode_words_plain,
    fused_split_plan,
)
from noise_ec_tpu_torch.ops.pack import (
    blocked_lane_tl,
    bytesliced_to_words16,
    lane_tl,
    pack_words_lanes,
    pack_words_lanes_blocked,
    pack_words_lanes_blocked_plain,
    pack_words_lanes_plain,
    reference_lane_tl,
    unpack_words_lanes,
    unpack_words_lanes_blocked,
    unpack_words_lanes_blocked_plain,
    unpack_words_lanes_plain,
    words16_to_bytesliced,
)
from noise_ec_tpu_torch.parallel import (
    BatchCodec,
    StreamingDecoder,
    StreamingEncoder,
    decode_stream,
)

# The interleaved words quantum (64 KiB a GF(2^16) shard): the smallest
# width the lane layout at m = 16 tiles.
Q16 = 16384
_REF = RefDeviceCodec(field="gf65536", kernel="pallas_interpret")


@pytest.fixture(scope="module")
def codec():
    """One CPU codec for the module: each matrix is planned once."""
    return DeviceCodec(field="gf65536", device="cpu")


def _parity(k, r):
    return generator_matrix(GF65536(), k, k + r, "cauchy")[k:]


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _host(M, w: np.ndarray) -> np.ndarray:
    """The host arithmetic's product of interleaved-u16 words, as words."""
    return host_matvec(GF65536(), M, w.view("<u2")).view(np.uint32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


# ------------------------------------------------------ the lane pack at 16


# rows_budget values that make the reference's _lane_tl pick each TL at
# m = 16 (rows * TL <= 6144 fits its VMEM budget).
@pytest.mark.parametrize("TW,rows_budget,tl", [
    (Q16, 2, 128), (3 * Q16, 10, 128), (4 * Q16, 2, 512), (4 * Q16, 20, 256),
])
def test_lane_pack16_matches_reference(rng, TW, rows_budget, tl):
    """K2 at m = 16 plane for plane against the reference's lane pack at
    each TL, and K3 back to the words."""
    assert _lane_tl(TW, 16, rows_budget) == tl
    assert reference_lane_tl(TW, 16, rows_budget) == tl
    xw = _words(rng, (3, TW))
    want = np.asarray(ref_pack(jnp.asarray(xw), 16, rows_budget=rows_budget,
                               interpret=True))
    reset_launch_counts()
    planes = pack_words_lanes(_t(xw), tl, 16)
    assert planes.shape == (3, 16, 8, TW // 128)
    np.testing.assert_array_equal(_u32(planes), want)
    np.testing.assert_array_equal(_u32(unpack_words_lanes(planes, tl)), xw)
    assert all(n == 0 for n in launch_counts().values())


def test_lane_unpack16_matches_reference(rng):
    """K3 at m = 16 against the reference's lane unpack on random planes."""
    planes = _words(rng, (3, 16, 8, 3 * Q16 // 128))
    want = np.asarray(ref_unpack(jnp.asarray(planes), rows_budget=10,
                                 interpret=True))
    np.testing.assert_array_equal(_u32(unpack_words_lanes(_t(planes), 128)),
                                  want)


@pytest.mark.parametrize("TW", [Q16, 3 * Q16])
def test_blocked_pack16_matches_reference(rng, TW):
    """K6 at m = 16: K2/K3's kernel at the reference's ``_lane_tl(TW, 16,
    32)``, 128 at every width."""
    assert blocked_lane_tl(TW, 16) == _lane_tl(TW, 16, 32) == 128
    xw = _words(rng, (5, TW))
    want = np.asarray(ref_pack_blocked(jnp.asarray(xw), 16, interpret=True))
    planes = pack_words_lanes_blocked(_t(xw), 16)
    np.testing.assert_array_equal(_u32(planes), want)
    back = unpack_words_lanes_blocked(planes)
    np.testing.assert_array_equal(_u32(back), xw)
    if TW == Q16:
        np.testing.assert_array_equal(_u32(back), np.asarray(
            ref_unpack_blocked(jnp.asarray(want), interpret=True)))


@pytest.mark.parametrize("TW", [Q16, 2 * Q16, 3 * Q16, 4 * Q16, 8192])
def test_lane_tl_rules_follow_the_reference(TW):
    """The port's copies of ``_lane_tl``'s rule at m = 16: None exactly
    where the reference raises (48 rows is the last that fits at TL =
    128); the port's own TL the largest that divides W8."""
    for rows in range(1, 60):
        try:
            want = _lane_tl(TW, 16, rows)
        except ValueError:
            want = None
        assert reference_lane_tl(TW, 16, rows) == want
    if TW % Q16:
        with pytest.raises(ValueError):
            lane_tl(TW, 16)
        with pytest.raises(ValueError):
            blocked_lane_tl(TW, 16)
    else:
        assert lane_tl(TW, 16) == {1: 128, 2: 256, 3: 128, 4: 512}[TW // Q16]
        assert reference_lane_tl(TW, 16, 48) == 128
        assert reference_lane_tl(TW, 16, 49) is None


def test_lane_pack16_refuses_what_it_cannot_tile():
    x = torch.zeros((2, Q16), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_words_lanes(x, 256, 16)  # 16384 words do not tile at TL=256
    with pytest.raises(ValueError):
        pack_words_lanes(x, 128, 12)
    with pytest.raises(ValueError):
        unpack_words_lanes(torch.zeros((2, 16, 4, 128), dtype=torch.int32),
                           128)
    with pytest.raises(ValueError, match="no kernel"):
        pack_words_lanes(x.to("meta"), 128, 16)


# --------------------------------------------------------------- K5 at 16


@pytest.mark.parametrize("k,r", [
    (4, 2),
    pytest.param(10, 4, marks=pytest.mark.slow),  # ~18 s interpreted
])
def test_plain_split16_matches_reference_dma_kernel(codec, rng, k, r):
    """The plain K5 at m = 16 equals the reference's ``_dma_split_kernel``
    at m = 16 (interpreted) on the same words, the reference's input
    zero-padded to P * ksl rows as its runner pads it; a batch of three
    holds the reference's words in the middle."""
    M = _parity(k, r)
    br = _REF.bits_rows_for(M)
    words = _words(rng, (k, Q16))
    call, k_pad = _build_planned_call(br, k, r, Q16, 16, ("dma", 128, 8),
                                      True)
    padded = np.zeros((k_pad, Q16), dtype=np.uint32)
    padded[:k] = words
    want = np.asarray(call(jnp.asarray(padded)))
    np.testing.assert_array_equal(want, _host(M, words))
    threads, ksl, tiles = fused_split_plan(codec.bits_rows_for(M), k, r, 16)
    assert (ksl, tiles.KT, tiles.NT) == (2, 32, -(-k // 2))
    reset_launch_counts()
    got = fused_split_encode_words(tiles, _t(words), r, threads, m=16)
    np.testing.assert_array_equal(_u32(got), want)
    batch = np.stack([words[::-1], words, words ^ np.uint32(0x5A5A5A5A)])
    got3 = fused_split_encode_words(tiles, _t(batch), r, threads, m=16)
    np.testing.assert_array_equal(_u32(got3[1]), want)
    for b in (0, 2):
        np.testing.assert_array_equal(_u32(got3[b]), _host(M, batch[b]))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,r", [(10, 4), (17, 3), (30, 10), (64, 4)])
def test_split16_plans_the_bytesliced_operand(codec, k, r):
    """A GF(2^16) matrix plans one K5 operand for both entries: at m = 16
    two symbol rows a phase, at m = 8 four byte rows, the same 32 planes
    and masks; the codec's plan (what both entries run) is that one."""
    br = codec.bits_rows_for(_parity(k, r))
    t16, ksl16, tiles16 = fused_split_plan(br, k, r, 16)
    t8, ksl8, tiles8 = fused_split_plan(br, 2 * k, 2 * r)
    assert (ksl16, ksl8, t16) == (2, 4, t8)
    assert tiles16.KT == tiles8.KT == 32
    assert torch.equal(tiles16.masks, tiles8.masks)
    kind, threads, tiles, _ = codec.plan_for(_parity(k, r))
    assert (kind, threads) == ("split", t16)
    assert torch.equal(tiles.masks, tiles16.masks)
    assert tiles.ring_bytes <= 232_448


@pytest.mark.parametrize("nbytes,kind,KT", [(30_000, "split", 16),
                                            (15_000, "fused", None)])
def test_split16_plan_halves_by_symbol_rows(rng, monkeypatch, nbytes, kind,
                                            KT):
    """Under a smaller shared-memory budget K5's plan halves its phase in
    whole symbol rows: RS(10,4)'s ring fits at one (16 planes) in 30,000
    bytes, and in 15,000 not even that, so the codec takes K1. Both
    entries run the one plan and give the host's words."""
    import noise_ec_tpu_torch.ops.fused as fused

    M = _parity(10, 4)
    w = _words(rng, (10, 1000))
    monkeypatch.setattr(fused, "SMEM_BYTES", nbytes)
    fused.fused_split_plan.cache_clear()
    try:
        codec = DeviceCodec(field="gf65536", device="cpu")
        got_kind, _, prog, _ = codec.plan_for(M)
        assert got_kind == kind
        assert getattr(prog, "KT", None) == KT
        np.testing.assert_array_equal(
            _u32(codec.matmul_words(M, _t(w))), _host(M, w))
        np.testing.assert_array_equal(_u32(bytesliced_to_words16(
            codec.matmul_words_bytesliced(M, words16_to_bytesliced(_t(w))))),
            _host(M, w))
    finally:
        fused.fused_split_plan.cache_clear()


@pytest.mark.parametrize("k,r,TW", [(17, 3, Q16), (10, 4, 2 * Q16)])
def test_split16_tl_and_odd_r(codec, rng, k, r, TW):
    """Odd r (RS(17,3): 48 output planes, half a warp's 32-row block past
    the last symbol row) and every lane tile give the host's words."""
    M = _parity(k, r)
    threads, _, tiles = fused_split_plan(codec.bits_rows_for(M), k, r, 16)
    w = _words(rng, (k, TW))
    for tl in (4, 128, lane_tl(TW, 16)):
        got = fused_split_encode_words(tiles, _t(w), r, threads, tl=tl, m=16)
        np.testing.assert_array_equal(_u32(got), _host(M, w))


def test_split16_refuses_what_it_cannot_run(codec):
    br = codec.bits_rows_for(_parity(10, 4))
    threads, _, tiles = fused_split_plan(br, 10, 4, 16)
    words = torch.zeros((10, Q16), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        fused_split_encode_words(tiles, words, 4, threads)  # m = 8
    with pytest.raises(ValueError, match="does not fit"):
        fused_split_encode_words(tiles, words[:9], 4, threads, m=16)
    with pytest.raises(ValueError, match="multiple"):
        fused_split_encode_words(tiles, words[:, :8192], 4, threads, m=16)
    with pytest.raises(ValueError):
        fused_split_encode_words(tiles, words, 4, threads, m=12)
    with pytest.raises(ValueError, match="no kernel"):
        fused_split_encode_words(tiles, words.to("meta"), 4, threads, m=16)
    with pytest.raises(ValueError, match="network rows"):
        fused_split_plan(br, 10, 5, 16)


# --------------------------------------------------------------- K1 at 16


def test_plain_fused16_matches_reference_single_kernel(rng):
    """The plain K1 at m = 16 equals the reference's ``_fused_kernel`` at
    m = 16 (interpreted): the program is the byte-sliced entry's,
    ``fused_plan(bits_rows, 16k)``."""
    k, r = 4, 2
    M = _parity(k, r)
    br = _REF.bits_rows_for(M)
    words = _words(rng, (k, Q16))
    call, _ = _build_planned_call(br, k, r, Q16, 16, ("single", 128, None),
                                  True)
    want = np.asarray(call(jnp.asarray(words)))
    threads, prog = fused_plan(br, 16 * k)
    reset_launch_counts()
    got = fused_encode_words(prog, _t(words), r, threads, m=16)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, _host(M, words))
    batch = np.stack([words, words[::-1]])
    got2 = fused_encode_words(prog, _t(batch), r, threads, m=16)
    np.testing.assert_array_equal(_u32(got2[0]), want)
    np.testing.assert_array_equal(_u32(got2[1]), _host(M, batch[1]))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,r", [(10, 4), (17, 3)])
def test_plain_fused16_at_every_tile(codec, rng, k, r):
    M = _parity(k, r)
    threads, prog = fused_plan(codec.bits_rows_for(M), 16 * k)
    w = _words(rng, (k, 4 * Q16))
    outs = [fused_encode_words_plain(prog, _t(w), r, tl, 16)
            for tl in (128, 256, 512)]
    for out in outs:
        np.testing.assert_array_equal(_u32(out), _host(M, w))
    with pytest.raises(ValueError, match="does not fit"):
        fused_encode_words(prog, _t(w), r, threads)  # m = 8


# ------------------------------------------ the interleaved words entry


@pytest.fixture(scope="module")
def rs42_reference():
    """RS(4,2)'s words and the reference's ``_fused_words16_fn`` product
    (its verified planner's first candidate, interpreted)."""
    rng = np.random.default_rng(42)
    M = _parity(4, 2)
    w = _words(rng, (4, Q16))
    want = np.asarray(_fused_words16_fn(2, _REF.bits_rows_for(M), True)(
        jnp.asarray(w)))
    return M, w, want


@pytest.mark.parametrize("tier,kind", [
    (None, "split"), ("split", "split"), ("fused", "fused"),
    ("pipeline", "pipeline"),
])
def test_interleaved_tiers_match_reference(codec, rs42_reference, tier,
                                           kind):
    """Every tier of the interleaved entry gives the reference's words,
    the byte-sliced entry's and the host's; None plans K5, as on byte
    rows."""
    M, w, want = rs42_reference
    assert codec.plan_for(M, tier)[0] == kind
    reset_launch_counts()
    got = codec.matmul_words(M, _t(w), tier=tier)
    np.testing.assert_array_equal(_u32(got), want)
    via = bytesliced_to_words16(
        codec.matmul_words_bytesliced(M, words16_to_bytesliced(_t(w))))
    assert torch.equal(got, via)
    np.testing.assert_array_equal(want, _host(M, w))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,r,TW", [(10, 4, Q16 + 100), (17, 3, 1000),
                                    (30, 10, 3 * Q16)])
def test_interleaved_tiers_agree(codec, rng, k, r, TW):
    """Every tier at RS(10,4), RS(17,3) (odd r) and RS(30,10), on ragged
    widths (the pad path), in a batch of three: the host's words."""
    M = _parity(k, r)
    assert codec.plan_for(M)[0] == "split"
    w = _words(rng, (3, k, TW))
    tiers = (None, "split", "fused", "pipeline") if k < 30 else (None,)
    for tier in tiers:
        got = codec.matmul_words_batch(M, _t(w), tier=tier)
        for b in range(3):
            np.testing.assert_array_equal(_u32(got[b]), _host(M, w[b]))


@pytest.mark.slow  # ~20 s: the reference's RS(10,4) network interpreted
def test_interleaved_rs_10_4_matches_reference(codec, rng):
    M = _parity(10, 4)
    w = _words(rng, (10, Q16))
    want = np.asarray(_fused_words16_fn(4, _REF.bits_rows_for(M), True)(
        jnp.asarray(w)))
    for tier in (None, "fused", "pipeline"):
        np.testing.assert_array_equal(
            _u32(codec.matmul_words(M, _t(w), tier=tier)), want)


def test_interleaved_tier3_only_past_48_rows(codec, rng, monkeypatch):
    """The pipeline tier runs the lane pack at m = 16 up to 48 rows and the
    sublane pack K10 past them, as the reference's ``_lane_tl`` decides:
    GF(2^16) RS(48,1) on K2 -> K4 -> K3, RS(49,1) on K10 -> K4 -> K10."""
    from noise_ec_tpu_torch.ops import dispatch, pack

    calls = []
    for name in ("pack_words_lanes", "pack_words16"):
        real = getattr(pack, name)
        monkeypatch.setattr(dispatch, name,
                            lambda *a, _real=real, _n=name:
                            calls.append(_n) or _real(*a))
    for k, want in ((48, "pack_words_lanes"), (49, "pack_words16")):
        M = _parity(k, 1)
        assert codec.route_for(M) == "baked"
        w = _words(rng, (k, 2000))
        got = codec.matmul_words(M, _t(w), tier="pipeline")
        np.testing.assert_array_equal(_u32(got), _host(M, w))
        assert calls[-1] == want


@pytest.mark.slow  # ~45 s: the reference's panel network interpreted
def test_interleaved_panel_matches_reference(codec, rng):
    """RS(20,25), the smallest panel-routed GF(2^16) code: K6 at m = 16 ->
    K7 -> K6 equals the reference's ``_panel_words_fn(r, 16, ...)`` under
    its planner's plan, and the host's words."""
    M = _parity(20, 25)
    assert codec.route_for(M) == "panel"
    assert codec.plan_for(M)[0] == "panel"
    br = codec.bits_rows_for(M)
    w = _words(rng, (20, Q16))
    want = np.asarray(_panel_words_fn(25, 16, br, ref_panel_plan(br, 320),
                                      True)(jnp.asarray(w)))
    np.testing.assert_array_equal(want, _host(M, w))
    got = codec.matmul_words(M, _t(w))
    np.testing.assert_array_equal(_u32(got), want)
    with pytest.raises(ValueError, match="tier"):
        codec.matmul_words(M, _t(w), tier="split")


@pytest.mark.parametrize("k,r,kind", [(10, 4, "split"), (30, 10, "split"),
                                      (50, 20, "panel")])
def test_interleaved_planner(codec, k, r, kind):
    """The interleaved entry plans K5 on RS(10,4) and RS(30,10), and the
    panel route for RS(50,20)."""
    M = _parity(k, r)
    assert codec.plan_for(M)[0] == kind


# ------------------------------------------------------------- the streams

_LOST = {(4, 2): [1, 4], (17, 3): [1, 16, 18]}
_STREAM_GEOMETRIES = [
    (4, 2),
    pytest.param(17, 3, marks=pytest.mark.slow),  # ~16 s interpreted
]


def _stream_data(rng, k):
    """Two whole chunks and a short tail, whole int32 words a stripe."""
    chunk = 4 * k * 80
    size = 2 * chunk + chunk // 3 + 6
    return chunk, rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,r", _STREAM_GEOMETRIES)
def test_gf16_stream_encode_matches_reference_words_path(rng, k, r):
    """``StreamingEncoder`` over GF(2^16) equals the reference's on its
    interpreted words path (``kernel="pallas_interpret"``), chunk for
    chunk; the port's chunks plan K5 at m = 16 (plain here: no launch)."""
    chunk, data = _stream_data(rng, k)
    enc = StreamingEncoder(k, r, chunk_bytes=chunk, field="gf65536",
                           device="cpu")
    ref = RefEncoder(k, r, chunk_bytes=chunk, field="gf65536",
                     kernel="pallas_interpret")
    want = list(ref.encode_bytes(data))
    reset_launch_counts()
    got = list(enc.encode_bytes(data, depth=2))
    assert [c.index for c in got] == [c.index for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.shards, np.asarray(b.shards))
    assert decode_stream(iter(got), k, total_len=len(data)) == data
    assert all(n == 0 for n in launch_counts().values())
    dev = enc.codec.device_codec()
    assert dev.plan_for(enc.codec.parity_matrix)[0] == "split"


@pytest.mark.parametrize("k,r", _STREAM_GEOMETRIES)
def test_gf16_stream_decode_matches_reference_words_path(rng, k, r):
    """``StreamingDecoder`` over GF(2^16) rebuilds the rows the reference's
    interpreted words path rebuilds, chunk for chunk, from the reference
    encoder's chunks."""
    chunk, data = _stream_data(rng, k)
    chunks = list(RefEncoder(k, r, chunk_bytes=chunk,
                             field="gf65536").encode_bytes(data))
    present = [i for i in range(k + r) if i not in _LOST[(k, r)]]
    degraded = [(c.index, np.asarray(c.shards)[present]) for c in chunks]
    want = list(RefDecoder(k, r, field="gf65536", kernel="pallas_interpret")
                .reconstruct_stream(iter(degraded), present))
    got = list(StreamingDecoder(k, r, field="gf65536", device="cpu")
               .reconstruct_stream(iter(degraded), present, depth=2))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, a), (_, b), c in zip(got, want, chunks):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(c.shards))


def test_batch_words16_every_tier(rng):
    """``BatchCodec(field="gf65536")`` words entries under each forced tier
    (a batch of four, ragged width) and a 2-erasure rebuild."""
    bc = BatchCodec(10, 4, field="gf65536", device="cpu")
    w = _words(rng, (4, 10, 3000))
    full = None
    for tier in (None, "split", "fused", "pipeline"):
        parity = bc.device_codec().matmul_words_batch(
            bc.parity_matrix, _t(w), tier=tier)
        for b in range(4):
            np.testing.assert_array_equal(
                _u32(parity[b]), _host(bc.parity_matrix, w[b]))
        enc = bc.encode_batch_words(_t(w))
        assert torch.equal(enc[:, 10:], parity)
        full = enc
    present = [i for i in range(14) if i not in (3, 12)]
    got = bc.reconstruct_batch_words(full[:, present], present)
    assert torch.equal(got, full)


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_lane_pack16_kernels_match_plain_on_cuda(rng):
    _require_cuda()
    for TW in (Q16, 3 * Q16, 262_144):
        words = _t(_words(rng, (10, TW))).cuda()
        for tl in sorted({128, lane_tl(TW, 16)}):
            planes = pack_words_lanes(words, tl, 16)
            assert torch.equal(planes, pack_words_lanes_plain(words, tl, 16))
            back = unpack_words_lanes(planes, tl)
            assert torch.equal(back, unpack_words_lanes_plain(planes, tl))
            assert torch.equal(back, words)
        planes = pack_words_lanes_blocked(words, 16)
        assert torch.equal(planes, pack_words_lanes_blocked_plain(words, 16))
        back = unpack_words_lanes_blocked(planes)
        assert torch.equal(back, unpack_words_lanes_blocked_plain(planes))


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(4, 2), (10, 4), (17, 3), (30, 10)])
def test_fused16_kernels_match_plain_on_cuda(rng, k, r):
    _require_cuda()
    codec = DeviceCodec(field="gf65536")
    M = _parity(k, r)
    words = _t(_words(rng, (k, 4 * Q16))).cuda()
    _, threads, tiles, _ = codec.plan_for(M)
    want = fused_split_encode_words_plain(tiles, words, r, 128, 16)
    assert torch.equal(
        fused_split_encode_words(tiles, words, r, threads, m=16), want)
    assert torch.equal(
        fused_split_encode_words(tiles, words, r, threads,
                                 ksplit=min(3, tiles.NT), m=16),
        want)
    batch = torch.stack([words, words.flip(1), words ^ 0x0F0F0F0F])
    assert torch.equal(
        fused_split_encode_words(tiles, batch, r, threads, m=16),
        fused_split_encode_words_plain(tiles, batch, r, 128, 16))
    np.testing.assert_array_equal(
        _u32(want.cpu()), _host(M, _u32(words.cpu())))
    if k <= 17:
        _, t1, prog, _ = codec.plan_for(M, "fused")
        assert torch.equal(fused_encode_words(prog, words, r, t1, m=16), want)
    ragged = _t(_words(rng, (3, k, Q16 - 7))).cuda()
    got = codec.matmul_words_batch(M, ragged)
    for b in range(3):
        np.testing.assert_array_equal(_u32(got[b].cpu()),
                                      _host(M, _u32(ragged[b].cpu())))
