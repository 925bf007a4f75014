"""The port's "mxu" route against the reference: the plain dense GF(2)
product (K8) against ``mxu_encode_words_bits`` in interpret mode on random
bit matrices, ``MxuCodec`` against the reference's, the bounded operand
cache, and GF(2^8) matrices past the XOR-network budgets through
``DeviceCodec``. Tolerance: byte-identical throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.golden import GoldenCodec
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.ops.mxu_gf2 import MxuCodec as RefMxuCodec
from noise_ec_tpu.ops.mxu_gf2 import (
    mxu_encode_words_bits as ref_mxu_encode_words_bits,
)
from noise_ec_tpu_torch.gf import GF256, GF65536
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.mxu import (
    MxuCodec,
    MxuTiles,
    cached_bit_expansion,
    mxu_encode_words_bits,
    mxu_encode_words_bits_plain,
)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.parametrize("r,k", [(1, 1), (4, 10), (17, 33)])
def test_plain_mxu_matches_reference_kernel(rng, r, k):
    """Random 0/1 bit matrices, not only GF expansions: the product is pure
    GF(2)."""
    m2 = rng.integers(0, 2, size=(8 * r, 8 * k)).astype(np.int8)
    w = _words(rng, (k, 512))
    want = np.asarray(ref_mxu_encode_words_bits(
        m2, jnp.asarray(w), r=r, k=k, interpret=True))
    got = mxu_encode_words_bits(torch.from_numpy(m2), _t(w), r, k)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_plain_mxu_chunks_and_batches(rng, monkeypatch):
    """The plain version's column chunks and batch axis give one product."""
    import noise_ec_tpu_torch.ops.mxu as mxu

    m2 = torch.from_numpy(rng.integers(0, 2, size=(24, 40)).astype(np.int8))
    w = _t(_words(rng, (2, 5, 96)))
    whole = mxu_encode_words_bits_plain(m2, w, 3, 5)
    monkeypatch.setattr(mxu, "_PLAIN_CHUNK_WORDS", 32)
    assert torch.equal(mxu_encode_words_bits_plain(m2, w, 3, 5), whole)
    for b in range(2):
        assert torch.equal(mxu_encode_words_bits(m2, w[b].contiguous(), 3, 5),
                           whole[b])


@pytest.mark.parametrize("k,r", [(10, 4), (50, 20)])
def test_mxu_codec_matches_reference_and_golden(rng, k, r):
    """As ``tests/test_ops.py`` holds the reference's MxuCodec: a narrow and
    a wide geometry at a stripe length off the tile (the pad path)."""
    G = ref_generator(RefGF256(), k, k + r, "cauchy")
    D = rng.integers(0, 256, size=(k, 3000)).astype(np.uint8)
    got = MxuCodec(GF256(), device="cpu").encode_stripes(G[k:], D)
    np.testing.assert_array_equal(
        got, RefMxuCodec(RefGF256(), interpret=True).encode_stripes(G[k:], D))
    np.testing.assert_array_equal(
        got, np.asarray(GoldenCodec(k, k + r).encode(D)))


def test_mxu_codec_refuses_gf65536_and_bad_shapes(rng):
    with pytest.raises(ValueError, match="GF"):
        MxuCodec(GF65536(), device="cpu")
    mx = MxuCodec(GF256(), device="cpu")
    G = ref_generator(RefGF256(), 4, 6, "cauchy")
    with pytest.raises(ValueError, match="cols"):
        mx.encode_words(G[4:], torch.zeros((3, 64), dtype=torch.int32))
    m2 = torch.zeros((16, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple"):
        mxu_encode_words_bits(m2, torch.zeros((4, 33), dtype=torch.int32),
                              2, 4)
    with pytest.raises(ValueError, match="bit matrix"):
        mxu_encode_words_bits(m2.to(torch.int32), torch.zeros(
            (4, 64), dtype=torch.int32), 2, 4)
    with pytest.raises(ValueError, match="no kernel"):
        mxu_encode_words_bits(
            m2, torch.zeros((4, 64), dtype=torch.int32, device="meta"), 2, 4)


def test_bit_expansion_cache_keys_on_shape_and_bytes():
    gf = GF256()
    cache: dict = {}
    a = np.array([[1, 2, 3, 4]], dtype=np.uint8)
    first = cached_bit_expansion(cache, gf, a, "cpu", bound=2)
    assert first.dtype == torch.int8 and first.shape == (8, 32)
    assert cached_bit_expansion(cache, gf, a.copy(), "cpu", bound=2) is first
    # The same bytes in another shape are another matrix.
    b = cached_bit_expansion(cache, gf, a.reshape(2, 2), "cpu", bound=2)
    assert b.shape == (16, 16) and len(cache) == 2
    cached_bit_expansion(cache, gf, a + 1, "cpu", bound=2)
    cached_bit_expansion(cache, gf, a + 2, "cpu", bound=2)
    assert len(cache) <= 3


def test_mxu_codec_plans_its_tiles_once(rng):
    """MxuCodec caches K8's tiled operand (not the bare expansion), so a
    repeated matrix is laid out once; the tiles read back to the
    expansion."""
    gf = GF256()
    G = ref_generator(RefGF256(), 10, 14, "cauchy")[10:]
    tiles = cached_bit_expansion({}, gf, G, "cpu", tiled=True)
    assert isinstance(tiles, MxuTiles) and (tiles.r, tiles.k) == (4, 10)
    assert torch.equal(tiles.matrix(),
                       cached_bit_expansion({}, gf, G, "cpu"))
    mx = MxuCodec(gf, device="cpu")
    w = _t(_words(rng, (10, 64)))
    first = mx.encode_words(G, w)
    again = mx.encode_words(G.copy(), w)
    assert len(mx._tiles_cache) == 1
    assert all(isinstance(v, MxuTiles) for v in mx._tiles_cache.values())
    want = RefGF256().matvec_stripes(G, w.numpy().view(np.uint8))
    np.testing.assert_array_equal(first.numpy().view(np.uint8), want)
    assert torch.equal(again, first)


def _dense(seed, r, k):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, size=(r, k), dtype=np.uint8)


def test_dense_gf256_matrix_through_matmul_stripes():
    """A dense (200, 200) GF(2^8) matrix is past the panel budget; the
    reference serves it on the MXU route and so does the port, on K8."""
    M = _dense(7, 200, 200)
    codec = DeviceCodec(device="cpu")
    assert codec.route_for(M) == "mxu"
    kind, threads, tiles, G = codec.plan_for(M)
    assert (kind, threads, G) == ("mxu", None, 1)
    m2 = tiles.matrix()
    assert m2.dtype == torch.int8 and tuple(m2.shape) == (1600, 1600)
    D = np.random.default_rng(8).integers(0, 256, size=(200, 300),
                                          dtype=np.uint8)
    reset_launch_counts()
    got = codec.matmul_stripes(M, D)
    np.testing.assert_array_equal(got, RefGF256().matvec_stripes(M, D))
    assert all(n == 0 for n in launch_counts().values())
    with pytest.raises(ValueError, match="mxu"):
        codec.plan_for(M, "pipeline")
    with pytest.raises(NotImplementedError, match="mxu"):
        codec.bits_rows_for(M)


def test_mxu_words_batch_and_stripes_many(rng):
    M = _dense(9, 100, 220)
    codec = DeviceCodec(device="cpu")
    assert codec.route_for(M) == "mxu"
    w = _words(rng, (3, 220, 40))  # TW off the tile: padded and sliced
    got = codec.matmul_words_batch(M, _t(w))
    assert got.shape == (3, 100, 40)
    Ds = [w[b].view(np.uint8) for b in range(3)]
    many = codec.matmul_stripes_many(M, Ds)
    for b in range(3):
        want = RefGF256().matvec_stripes(M, Ds[b])
        np.testing.assert_array_equal(got[b].numpy().view(np.uint8), want)
        np.testing.assert_array_equal(many[b], want)


def test_gf16_bytesliced_entry_on_the_mxu_route(rng):
    """The byte-sliced GF(2^16) entry runs K8 over 2k byte rows with the
    (16r, 16k) expansion as an (8R, 8K) operand."""
    from noise_ec_tpu.gf.field import GF65536 as RefGF65536

    M = ref_generator(RefGF65536(), 100, 160, "cauchy")[100:]
    codec = DeviceCodec(field="gf65536", device="cpu")
    assert codec.plan_for(M)[0] == "mxu"
    assert tuple(codec.plan_for(M)[2].matrix().shape) == (960, 1600)
    D = rng.integers(0, 1 << 16, size=(100, 64), dtype=np.uint16)
    np.testing.assert_array_equal(codec.matmul_stripes(M, D),
                                  RefGF65536().matvec_stripes(M, D))


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,TW", [(112, 400, 4096), (3, 5, 32),
                                    (200, 200, 1024), (56, 400, 1024),
                                    (5, 7, 4128), (3, 5, 96)])
def test_mxu_kernel_matches_plain_on_cuda(rng, r, k, TW):
    """RS(200,56)'s GF(2^16) shapes (896 and 448 bit rows over 400 byte
    rows), the dense GF(2^8) one, odd K (8K not a multiple of 128 bits)
    and TW ending in half a column block of the four-warpgroup ring (64
    words), each in a batch of two."""
    _require_cuda()
    m2 = torch.from_numpy(
        rng.integers(0, 2, size=(8 * r, 8 * k)).astype(np.int8)).cuda()
    w = _t(_words(rng, (2, k, TW))).cuda()
    got = mxu_encode_words_bits(m2, w, r, k)
    assert torch.equal(got, mxu_encode_words_bits_plain(m2, w, r, k))


@pytest.mark.cuda
def test_every_mxu_build_matches_plain_on_cuda(rng):
    """Each wgmma width the library holds (ops/mxu.py N_MENU), at a ragged
    width in a batch of three."""
    from noise_ec_tpu_torch.ops.mxu import (
        N_MENU,
        build_mxu_tiles,
        mxu_encode_tiles,
    )

    _require_cuda()
    m2 = torch.from_numpy(
        rng.integers(0, 2, size=(8 * 30, 8 * 21)).astype(np.int8)).cuda()
    w = _t(_words(rng, (3, 21, 352))).cuda()
    want = mxu_encode_words_bits_plain(m2, w, 30, 21)
    for N in N_MENU:
        got = mxu_encode_tiles(build_mxu_tiles(m2, 30, 21, N), w)
        assert torch.equal(got, want), N
