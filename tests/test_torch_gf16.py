"""The port's GF(2^16) slice against the reference: the 16-plane pack and
unpack (K10) against the reference's Pallas kernels in interpret mode, the
byte-sliced layout helpers against theirs, the vectorised bit expansion,
the "mxu" routing decision, and ``ReedSolomon(field="gf65536")`` end to
end against the reference's ``backend="numpy"`` codec on every route.
Tolerance: byte-identical throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.codec.rs import ReedSolomon as RefRS
from noise_ec_tpu.gf.bitmatrix import expand_generator_bits as ref_expand
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.gf.field import GF65536 as RefGF65536
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.matrix.linalg import reconstruction_matrix as ref_recon
from noise_ec_tpu.ops import pallas_pack as ref_pack
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu_torch.codec import ReedSolomon
from noise_ec_tpu_torch.gf import GF256, GF65536, expand_generator_bits
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.pack import (
    bytesliced_to_words16,
    pack_u16_bytesliced,
    pack_words16,
    pack_words16_plain,
    tile_lanes,
    transpose16,
    unpack_u16_bytesliced,
    unpack_words16,
    unpack_words16_plain,
    words16_to_bytesliced,
)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or np.array_equal(x, y) for x, y in zip(a, b)
    )


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


# ------------------------------------------------------------------ K10


@pytest.mark.parametrize("TW", [2048, 4096, 6144, 16384, 3 * 16384])
def test_pack16_matches_reference_kernel(rng, TW):
    """Plane for plane against ``pack_words16_pallas(interpret=True)``,
    TL included (384 at TW = 6144: not a power of two)."""
    w = _words(rng, (3, TW))
    assert tile_lanes(TW, 16) == ref_pack._tile_lanes(TW, 512, group=16)
    want = np.asarray(ref_pack.pack_words16_pallas(jnp.asarray(w),
                                                    interpret=True))
    planes = pack_words16(_t(w))
    np.testing.assert_array_equal(_u32(planes), want)
    back = np.asarray(ref_pack.unpack_words16_pallas(jnp.asarray(want),
                                                     interpret=True))
    got = unpack_words16(planes)
    np.testing.assert_array_equal(_u32(got), back)
    np.testing.assert_array_equal(_u32(got), w)


def test_transpose16_is_bit_transpose(rng):
    w = _words(rng, (16, 5))
    out = _u32(transpose16(_t(w), 0))
    for i in range(16):
        for j in range(16):
            for h in range(2):
                assert ((out[i] >> (16 * h + j)) & 1 == (w[j] >> (16 * h + i)) & 1).all()
    np.testing.assert_array_equal(_u32(transpose16(_t(out), 0)), w)


def test_pack16_rejects_what_it_cannot_tile():
    with pytest.raises(ValueError):
        pack_words16(torch.zeros((2, 1000), dtype=torch.int32))
    with pytest.raises(ValueError):
        pack_words16(torch.zeros((2, 2048), dtype=torch.int64))
    with pytest.raises(ValueError):
        unpack_words16(torch.zeros((2, 8, 256), dtype=torch.int32))


def test_k10_takes_no_plain_route_off_the_cpu():
    with pytest.raises(ValueError, match="no kernel"):
        pack_words16(torch.empty((2, 2048), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        unpack_words16(torch.empty((2, 16, 128), dtype=torch.int32,
                                   device="meta"))


# ----------------------------------------------------- byte-sliced layouts


@pytest.mark.parametrize("k,S", [(1, 2), (5, 100), (12, 4097)])
def test_host_bytesliced_helpers_match_reference(rng, k, S):
    x = rng.integers(0, 1 << 16, size=(k, S), dtype=np.uint16)
    got = pack_u16_bytesliced(x)
    np.testing.assert_array_equal(got, ref_pack.pack_u16_bytesliced(x))
    np.testing.assert_array_equal(unpack_u16_bytesliced(got),
                                  ref_pack.unpack_u16_bytesliced(got))
    np.testing.assert_array_equal(unpack_u16_bytesliced(got), x)
    page = np.full((2 * k, S + 7), 0xAB, dtype=np.uint8)
    pack_u16_bytesliced(x, out=page)
    np.testing.assert_array_equal(page[:, :S], got)
    assert (page[:, S:] == 0xAB).all()


@pytest.mark.parametrize("k,TW", [(1, 2), (3, 64), (7, 1030)])
def test_device_bytesliced_helpers_match_reference(rng, k, TW):
    w = _words(rng, (k, TW))
    want = np.asarray(ref_pack.words16_to_bytesliced(jnp.asarray(w)))
    got = words16_to_bytesliced(_t(w))
    np.testing.assert_array_equal(_u32(got), want)
    back = bytesliced_to_words16(got)
    np.testing.assert_array_equal(
        _u32(back), np.asarray(ref_pack.bytesliced_to_words16(
            jnp.asarray(want))))
    np.testing.assert_array_equal(_u32(back), w)
    # The device layout is the host layout's bytes.
    sym = w.view("<u2")
    np.testing.assert_array_equal(_u32(got).view(np.uint8),
                                  pack_u16_bytesliced(sym))


# -------------------------------------------------------- bit expansion


@pytest.mark.parametrize("field,k,r", [
    ("gf256", 10, 4), ("gf256", 50, 20), ("gf65536", 10, 4),
    ("gf65536", 20, 25),
])
def test_bit_expansion_matches_reference(field, k, r):
    ref_gf, gf = ((RefGF256(), GF256()) if field == "gf256"
                  else (RefGF65536(), GF65536()))
    G = ref_generator(ref_gf, k, k + r, "cauchy")
    rng = np.random.default_rng(k * r)
    dense = rng.integers(0, ref_gf.order, size=(3, 5)).astype(ref_gf.dtype)
    for M in (G[k:], G[:k], dense):
        want = ref_expand(ref_gf, M)
        got = expand_generator_bits(gf, M)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- routing


def _recovery_56():
    gf = RefGF65536()
    G = ref_generator(gf, 200, 256, "cauchy")
    lost = list(range(0, 56, 2)) + list(range(200, 256, 2))
    present = [i for i in range(256) if i not in lost][:200]
    return ref_recon(gf, G, present, lost)


@pytest.mark.parametrize("k,r", [
    (10, 4), (30, 10), (60, 20), (100, 30), (200, 56), (300, 60),
    (100, 60), (250, 20), (None, None),
])
def test_mxu_route_matches_reference(k, r):
    """The "mxu" answer (and the raw XOR count behind it) agrees with the
    reference's ``route_for`` over GF(2^16); None is RS(200,56)'s (56, 200)
    recovery matrix at 56 erasures."""
    if k is None:
        M = _recovery_56()
    else:
        M = ref_generator(RefGF65536(), k, k + r, "cauchy")[k:]
    ref = RefDeviceCodec(field="gf65536", kernel="pallas")
    port = DeviceCodec(field="gf65536", device="cpu")
    assert port._xor_cost_for(M) == ref._xor_cost_for(M)
    assert (port.route_for(M) == "mxu") == (ref.route_for(M) == "mxu")
    if k in (10, 30):
        assert port.route_for(M) == "baked"


def test_baked_row_bound_counts_byte_rows():
    """RS(114,1) over GF(2^16) has 228 byte rows, one past K1's 227."""
    port = DeviceCodec(field="gf65536", device="cpu")
    narrow = DeviceCodec(device="cpu")
    for k, route in ((113, "baked"), (114, "panel")):
        M = ref_generator(RefGF65536(), k, k + 1, "cauchy")[k:]
        assert port.route_for(M) == route
    M = ref_generator(RefGF256(), 114, 115, "cauchy")[114:]
    assert narrow.route_for(M) == "baked"


# ------------------------------------------------------ the slice end to end

_GEOMETRIES = [
    # (k, r, S bytes, lost, route of the parity and of both recovery
    # matrices: all the lost shards, and the lost data shards)
    (10, 4, 512, (0, 5, 11), "baked", "baked"),
    # The smallest GF(2^16) code the reference routes "panel"; a wide
    # recovery matrix would plan for seconds, so three erasures.
    (20, 25, 256, (0, 5, 30), "panel", "baked"),
    (100, 60, 128, tuple(range(0, 100, 2)) + tuple(range(100, 110)),
     "mxu", "mxu"),
    # 270 shards: past GF(2^8)'s 256.
    (250, 20, 128, tuple(range(0, 200, 10)), "mxu", "mxu"),
]


@pytest.mark.parametrize("k,r,S,lost,route,rec_route", _GEOMETRIES)
def test_gf16_codec_matches_numpy_backend(k, r, S, lost, route, rec_route):
    if (k, r) == (20, 25):
        ref_dev = RefDeviceCodec(field="gf65536", kernel="pallas")
        M = ref_generator(RefGF65536(), k, k + r, "cauchy")[k:]
        assert ref_dev.route_for(M) == "panel"
    rng = np.random.default_rng(k * 1000 + r)
    rs = ReedSolomon(k, r, field="gf65536", device="cpu")
    ref = RefRS(k, r, field="gf65536", backend="numpy")
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
    want = ref.reconstruct(holes)
    assert _same(got, want) and _same(got, enc)
    data_only = rs.reconstruct_data(holes)
    assert _same(data_only[:k], want[:k])
    assert all(data_only[i] is None for i in lost if i >= k)
    from noise_ec_tpu_torch.matrix import reconstruction_matrix

    present = [i for i in range(k + r) if i not in lost][:k]
    assert rs._dev.route_for(rs.G[k:]) == route
    for rows in (list(lost), [i for i in lost if i < k]):
        R = reconstruction_matrix(rs.gf, rs.G, present, rows)
        assert rs._dev.route_for(R) == rec_route
    assert all(n == 0 for n in launch_counts().values())


def test_gf16_batch_through_the_coalescer(rng):
    rs = ReedSolomon(10, 4, field="gf65536", device="cpu")
    Ds = [rng.integers(0, 1 << 16, size=(10, 300), dtype=np.uint16)
          for _ in range(3)]
    outs = rs.matmul_many(rs.G[10:], Ds)
    for D, got in zip(Ds, outs):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, rs.gf.matvec_stripes(rs.G[10:], D))


def test_gf16_split_join_and_update(rng):
    rs = ReedSolomon(6, 3, field="gf65536", device="cpu")
    ref = RefRS(6, 3, field="gf65536", backend="numpy")
    msg = rng.integers(0, 256, size=1001, dtype=np.uint8).tobytes()
    shards = rs.split(msg)
    assert all(len(s) % 2 == 0 for s in shards)
    enc = rs.encode(shards)
    assert rs.join(rs.reconstruct([None, *enc[1:]]), len(msg)) == msg
    new = [None, rng.integers(0, 256, size=len(shards[0]), dtype=np.uint8),
           None, None, None, None]
    assert _same(rs.update(enc, new), ref.update(enc, new))
    with pytest.raises(ValueError, match="even"):
        rs.encode([np.zeros(3, np.uint8)] * 6)


# ------------------------------------------------- the words entries


@pytest.mark.parametrize("k,r,TW", [(10, 4, 2048), (20, 25, 16384 + 512)])
def test_interleaved_words_match_the_bytesliced_entry(rng, k, r, TW):
    """``matmul_words`` on interleaved u16 words (K10 -> K4 at RS(10,4),
    K10 -> K7 at RS(20,25)) equals ``bytesliced_to_words16`` of the
    byte-sliced entry and the host arithmetic."""
    codec = DeviceCodec(field="gf65536", device="cpu")
    M = ref_generator(RefGF65536(), k, k + r, "cauchy")[k:]
    w = _words(rng, (k, TW))
    got = codec.matmul_words(M, _t(w))
    via = bytesliced_to_words16(
        codec.matmul_words_bytesliced(M, words16_to_bytesliced(_t(w))))
    assert torch.equal(got, via)
    want = RefGF65536().matvec_stripes(M, w.view("<u2"))
    np.testing.assert_array_equal(_u32(got).view("<u2"), want)
    kind = codec.plan_for(M, "pipeline" if (k, r) == (10, 4) else None)[0]
    assert kind == ("pipeline" if (k, r) == (10, 4) else "panel")


def test_interleaved_words_batch_and_refusals(rng):
    codec = DeviceCodec(field="gf65536", device="cpu")
    M = ref_generator(RefGF65536(), 10, 14, "cauchy")[10:]
    w = _words(rng, (2, 10, 100))
    got = codec.matmul_words_batch(M, _t(w))
    for b in range(2):
        np.testing.assert_array_equal(
            _u32(got[b]).view("<u2"),
            RefGF65536().matvec_stripes(M, w[b].view("<u2")))
    with pytest.raises(ValueError, match="fused"):
        codec.matmul_words(M, _t(w[0]), tier="fused")
    with pytest.raises(ValueError, match="gf65536"):
        DeviceCodec(device="cpu").matmul_words_bytesliced(
            M, torch.zeros((20, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        codec.matmul_words_bytesliced(M, torch.zeros((10, 64),
                                                     dtype=torch.int32))
    big = ref_generator(RefGF65536(), 100, 160, "cauchy")[100:]
    assert codec.route_for(big) == "mxu"
    with pytest.raises(NotImplementedError, match="byte-sliced"):
        codec.matmul_words(big, torch.zeros((100, 64), dtype=torch.int32))


def test_bytesliced_tiers_give_the_same_product(rng):
    """The byte-sliced RS(10,4) product forced through K1 and through the
    K2 -> K4 -> K3 pipeline, both over 20 byte rows, equals the planner's
    K5."""
    codec = DeviceCodec(field="gf65536", device="cpu")
    M = ref_generator(RefGF65536(), 10, 14, "cauchy")[10:]
    D = rng.integers(0, 1 << 16, size=(10, 5000), dtype=np.uint16)
    fused = codec.matmul_stripes(M, D, tier="fused")
    piped = codec.matmul_stripes(M, D, tier="pipeline")
    np.testing.assert_array_equal(fused, piped)
    np.testing.assert_array_equal(fused, RefGF65536().matvec_stripes(M, D))
    assert codec.plan_for(M)[0] == "split"
    np.testing.assert_array_equal(codec.matmul_stripes(M, D), fused)


def test_gf16_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReedSolomon(10, 4, field="gf65536")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceCodec(field="gf65536")


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_k10_kernels_match_plain_on_cuda(rng):
    _require_cuda()
    for TW in (6144, 65536):
        words = _t(_words(rng, (10, TW))).cuda()
        planes = pack_words16(words)
        assert torch.equal(planes, pack_words16_plain(words))
        back = unpack_words16(planes)
        assert torch.equal(back, unpack_words16_plain(planes))
        assert torch.equal(back, words)


@pytest.mark.cuda
@pytest.mark.parametrize("k,r,S,lost,route,rec_route", _GEOMETRIES)
def test_gf16_codec_on_cuda(k, r, S, lost, route, rec_route):
    _require_cuda()
    rng = np.random.default_rng(k)
    rs = ReedSolomon(k, r, field="gf65536")
    ref = ReedSolomon(k, r, field="gf65536", backend="numpy")
    data = list(rng.integers(0, 256, size=(k, 4 * S), dtype=np.uint8))
    enc = rs.encode(data)
    assert _same(enc, ref.encode(data))
    holes = [None if i in lost else s for i, s in enumerate(enc)]
    assert _same(rs.reconstruct(holes), enc)
