"""The port's last three TPU kernels against the reference: K9 (the
sublane-group pack and unpack) against ``pack_words_pallas`` /
``unpack_words_pallas`` in interpret mode, K11 and K12 (the dense-mask GF(2)
products) against ``gf2_matmul_pallas`` / ``gf2_matmul_pallas_tiled`` in
interpret mode and against the sparse K4, and ``expand_generator_masks``
against the reference's. Tolerance: byte-identical throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.bitmatrix import expand_generator_masks as ref_masks
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.gf.field import GF65536 as RefGF65536
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.ops import pallas_gf2mm as ref_gf2mm
from noise_ec_tpu.ops import pallas_pack as ref_pack
from noise_ec_tpu_torch.gf import GF256, GF65536, expand_generator_masks
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.gf2mm import (
    bits_to_rows,
    gf2_matmul_dense,
    gf2_matmul_dense_plain,
    gf2_matmul_dense_tiled,
    gf2_matmul_dense_tiled_plain,
    gf2_matmul_sparse,
    planes_to_tiled,
    sparse_plan,
    tiled_to_planes,
)
from noise_ec_tpu_torch.ops.pack import (
    pack_words_sublane,
    pack_words_sublane_plain,
    tile_lanes,
    unpack_words_sublane,
    unpack_words_sublane_plain,
)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.parametrize("TW", [8192, 3072, 1024, 6144])
def test_tile_lanes_matches_reference(TW):
    for group in (8, 16):
        if TW % (group * 128) == 0:
            assert tile_lanes(TW, group) == ref_pack._tile_lanes(
                TW, 512, group=group)
    assert tile_lanes(3072) == 384


@pytest.mark.parametrize("TW", [8192, 3072])
def test_k9_plain_matches_reference_interpret(rng, TW):
    words = _words(rng, (5, TW))
    want = np.asarray(ref_pack.pack_words_pallas(jnp.asarray(words),
                                                 interpret=True))
    reset_launch_counts()
    planes = pack_words_sublane(_t(words))
    np.testing.assert_array_equal(_u32(planes), want)
    np.testing.assert_array_equal(_u32(pack_words_sublane_plain(_t(words))),
                                  want)
    back_want = np.asarray(ref_pack.unpack_words_pallas(jnp.asarray(want),
                                                        interpret=True))
    back = unpack_words_sublane(planes)
    np.testing.assert_array_equal(_u32(back), back_want)
    np.testing.assert_array_equal(_u32(back), words)
    np.testing.assert_array_equal(
        _u32(unpack_words_sublane_plain(planes)), words)
    # The CPU runs the plain versions: no kernel launched.
    assert launch_counts()["pack_sublane"] == 0
    assert launch_counts()["unpack_sublane"] == 0


def test_k9_planes_feed_the_sparse_product(rng):
    """The reference's tier 3 on the port: K9 pack -> K4 over the (8k, 8,
    W/8) view (plane (j, i) is row 8j + i) -> K9 unpack is the GF(2^8)
    product."""
    gf = GF256()
    k, r, TW = 4, 2, 3072
    M = generator_matrix(gf, k, k + r, "cauchy")[k:]
    words = _words(rng, (k, TW))
    planes = pack_words_sublane(_t(words))
    W = TW // 8
    bits = expand_generator_masks(gf, M) != 0
    threads, prog = sparse_plan(bits_to_rows(bits), 8 * k)
    out = gf2_matmul_sparse(prog, planes.reshape(8 * k, 8, W // 8), threads)
    got = unpack_words_sublane(out.reshape(r, 8, W))
    want = host_matvec(gf, M, words.view(np.uint8))
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want)


def test_k9_refuses_bad_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        pack_words_sublane(torch.zeros((2, 1000), dtype=torch.int32))
    with pytest.raises(ValueError, match="planes"):
        unpack_words_sublane(torch.zeros((2, 16, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        pack_words_sublane(torch.zeros((2, 1024), dtype=torch.int64))


@pytest.mark.parametrize("field, gf_ref", [(GF256, RefGF256),
                                           (GF65536, RefGF65536)])
def test_expand_generator_masks_matches_reference(field, gf_ref):
    G = generator_matrix(field(), 5, 8, "cauchy")
    want = ref_masks(gf_ref(), ref_generator(gf_ref(), 5, 8, "cauchy")[5:])
    got = expand_generator_masks(field(), G[5:])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert set(np.unique(got)) <= {0, -1}


def _select_masks(rng, R, C):
    bits = rng.integers(0, 2, size=(R, C)).astype(np.uint32)
    return (bits * np.uint32(0xFFFFFFFF)).astype(np.uint32)


@pytest.mark.parametrize("kind", ["select", "random"])
def test_k11_plain_matches_reference_interpret(rng, kind):
    masks = (_select_masks(rng, 16, 32) if kind == "select"
             else _words(rng, (16, 32)))
    planes = _words(rng, (32, 300))
    want = np.asarray(ref_gf2mm.gf2_matmul_pallas(
        jnp.asarray(masks), jnp.asarray(planes), interpret=True))
    got = gf2_matmul_dense(_t(masks), _t(planes))
    assert got.shape == (16, 300)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(gf2_matmul_dense_plain(_t(masks), _t(planes))), want)


@pytest.mark.parametrize("kind", ["select", "random"])
def test_k12_plain_matches_reference_interpret(rng, kind):
    """RS(5,3)'s masks (and random words of that shape) on tiled planes,
    against the reference's tiled kernel and, for the select masks, the
    sparse product K4 on the same matrix."""
    gf = GF256()
    k, r = 5, 3
    G = generator_matrix(gf, k, k + r, "cauchy")
    masks = expand_generator_masks(gf, G[k:])
    if kind == "random":
        masks = _words(rng, masks.shape).view(np.int32)
    tiled = _words(rng, (8 * k, 8, 200))
    want = np.asarray(ref_gf2mm.gf2_matmul_pallas_tiled(
        jnp.asarray(masks.view(np.uint32)), jnp.asarray(tiled),
        interpret=True))
    got = gf2_matmul_dense_tiled(torch.from_numpy(masks), _t(tiled))
    assert got.shape == (8 * r, 8, 200)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(gf2_matmul_dense_tiled_plain(torch.from_numpy(masks), _t(tiled))),
        want)
    if kind == "select":
        threads, prog = sparse_plan(bits_to_rows(masks != 0), 8 * k)
        sparse = gf2_matmul_sparse(prog, _t(tiled), threads)
        np.testing.assert_array_equal(_u32(sparse), _u32(got))


def test_tiled_layout_helpers_match_reference(rng):
    planes = _words(rng, (6, 45))
    want = np.asarray(ref_gf2mm.planes_to_tiled(jnp.asarray(planes)))
    tiled = planes_to_tiled(_t(planes))
    np.testing.assert_array_equal(_u32(tiled), want)
    back = np.asarray(ref_gf2mm.tiled_to_planes(jnp.asarray(want), 45))
    np.testing.assert_array_equal(_u32(tiled_to_planes(tiled, 45)), back)
    np.testing.assert_array_equal(back, planes)


def test_dense_refuses_mismatched_operands():
    masks = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        gf2_matmul_dense(masks, torch.zeros((9, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        gf2_matmul_dense(masks.long(), torch.zeros((8, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="tiled"):
        gf2_matmul_dense_tiled(masks, torch.zeros((8, 4, 16),
                                                  dtype=torch.int32))


@pytest.mark.cuda
def test_dense_kernels_match_plain_on_cuda(rng):
    _require_cuda()
    for TW in (262144, 3072):
        words = _t(_words(rng, (10, TW))).cuda()
        planes = pack_words_sublane(words)
        assert torch.equal(planes, pack_words_sublane_plain(words))
        assert torch.equal(unpack_words_sublane(planes), words)
    gf = GF256()
    for k, r in ((10, 4), (50, 20)):
        masks = torch.from_numpy(expand_generator_masks(
            gf, generator_matrix(gf, k, k + r)[k:])).cuda()
        planes = _t(_words(rng, (8 * k, 32768 + 5))).cuda()
        assert torch.equal(gf2_matmul_dense(masks, planes),
                           gf2_matmul_dense_plain(masks, planes))
        rand = _t(_words(rng, tuple(masks.shape))).cuda()
        tiled = _t(_words(rng, (8 * k, 8, 4096))).cuda()
        assert torch.equal(gf2_matmul_dense_tiled(rand, tiled),
                           gf2_matmul_dense_tiled_plain(rand, tiled))
