"""The port's lane pack/unpack (K2/K3) against the reference's Pallas lane
kernels, run in interpret mode. Exact to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.ops.pallas_pack import (
    _lane_tl,
    pack_words_lanes as ref_pack,
    unpack_words_lanes as ref_unpack,
)
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.pack import (
    lane_quantum,
    lane_tl,
    pack_words_lanes,
    pack_words_lanes_plain,
    transpose8,
    unpack_words_lanes,
    unpack_words_lanes_plain,
)


def _words(rng, shape) -> np.ndarray:
    """Random uint32 words (half of them with bit 31 set)."""
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernels on the card")


# rows_budget values that make the reference's _lane_tl pick each TL at
# TW = 32768 words (its VMEM brackets: <= 24 rows, <= 48, <= 96).
@pytest.mark.parametrize("tl,rows_budget", [(512, 2), (256, 30), (128, 60)])
def test_pack_unpack_match_reference(rng, tl, rows_budget):
    k, TW = 2, 32768
    assert _lane_tl(TW, 8, rows_budget) == tl
    xw = _words(rng, (k, TW))
    ref_planes = np.asarray(
        ref_pack(jnp.asarray(xw), 8, rows_budget=rows_budget, interpret=True)
    )
    reset_launch_counts()
    planes = pack_words_lanes(torch.from_numpy(xw.view(np.int32)), tl)
    assert planes.shape == (k, 8, 8, TW // 64)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32), ref_planes)

    ref_back = np.asarray(
        ref_unpack(jnp.asarray(ref_planes), rows_budget=rows_budget,
                   interpret=True)
    )
    back = unpack_words_lanes(planes, tl)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), ref_back)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), xw)
    # On the CPU the wrappers ran the plain versions: no kernel launched.
    assert all(n == 0 for n in launch_counts().values())


def test_transpose8_is_bit_transpose(rng):
    """out[i] bit (8b+j) == in[j] bit (8b+i), per word, for int32 words
    with the sign bit set."""
    V = _words(rng, (8, 5))
    P = transpose8(torch.from_numpy(V.view(np.int32)), 0).numpy().view(np.uint32)
    for l in range(5):
        for i in range(8):
            for b in range(4):
                for j in range(8):
                    assert (P[i, l] >> (8 * b + j)) & 1 == (V[j, l] >> (8 * b + i)) & 1
    back = transpose8(torch.from_numpy(P.view(np.int32)), 0)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), V)


@pytest.mark.parametrize("TW,tl", [(8192, 128), (16384, 256), (32768, 512),
                                   (3 * 32768, 512), (5 * 8192, 128)])
def test_lane_tl_rule(TW, tl):
    assert lane_tl(TW) == tl


def test_lane_rules_reject_what_they_cannot_tile():
    assert lane_quantum(8) == 8192
    assert lane_quantum(16) == 16384  # the interleaved GF(2^16) quantum
    with pytest.raises(ValueError):
        lane_quantum(4)
    with pytest.raises(ValueError):
        lane_tl(1000)
    x = torch.zeros((2, 8192), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_words_lanes(x, 256)  # 8192 words do not tile at TL=256
    with pytest.raises(ValueError):
        pack_words_lanes(x.to(torch.int64), 128)


def test_wrappers_take_no_plain_route_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    a kernel or raises (here: the meta device, which has no kernel)."""
    x = torch.empty((2, 8192), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pack_words_lanes(x, 128)
    p = torch.empty((2, 8, 8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        unpack_words_lanes(p, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("tl", [128, 256, 512])
def test_pack_kernels_match_plain_on_cuda(rng, tl):
    _require_cuda()
    words = torch.from_numpy(_words(rng, (10, 32768)).view(np.int32)).cuda()
    planes = pack_words_lanes(words, tl)
    assert torch.equal(planes, pack_words_lanes_plain(words, tl))
    back = unpack_words_lanes(planes, tl)
    assert torch.equal(back, unpack_words_lanes_plain(planes, tl))
    assert torch.equal(back, words)
