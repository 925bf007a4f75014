"""The mesh tier and the sharded builders on the card (``cuda``-marked:
they skip without a CUDA device; run them with ``python -m pytest -m cuda
tests/test_torch_mesh_cuda.py``). A router over ``cuda:0`` listed four
times puts each shard on its own stream of the one card; every product is
held against the host arithmetic and the unsharded route. No JAX here:
the CPU cases in tests/test_torch_mesh.py hold the same paths against the
reference."""

import numpy as np
import pytest
import torch

from noise_ec_tpu_torch.gf import GF65536
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.parallel.batch import BatchCodec
from noise_ec_tpu_torch.parallel.mesh import (
    configure_mesh_router,
    make_mesh,
    reset_mesh_router,
)


@pytest.fixture
def card4():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    router = configure_mesh_router(devices=[torch.device("cuda", 0)] * 4,
                                   enable=True)
    yield router
    reset_mesh_router()


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,r,B", [(10, 4, 5), (50, 20, 8), (229, 6, 4)])
def test_stripes_batches_shard_on_the_card(card4, k, r, B):
    rng = np.random.default_rng(k)
    dev = DeviceCodec()
    G = generator_matrix(dev.gf, k, k + r, "cauchy")
    Ds = [rng.integers(0, 256, size=(k, 4096)).astype(np.uint8)
          for _ in range(B)]
    reset_launch_counts()
    got = dev.matmul_stripes_many(G[k:], Ds)
    launches = launch_counts()
    for D, g in zip(Ds, got):
        np.testing.assert_array_equal(g, host_matvec(dev.gf, G[k:], D))
    kernel = "gf2mm_panel" if dev.route_for(G[k:]) == "panel" else (
        "fused_split")
    assert launches[kernel] == 4  # one a shard


@pytest.mark.cuda
def test_gf16_bytesliced_batch_shards_on_the_card(card4):
    rng = np.random.default_rng(16)
    dev = DeviceCodec(field="gf65536")
    G = generator_matrix(GF65536(), 10, 14, "cauchy")
    Ds = [rng.integers(0, 1 << 16, size=(10, 2048)).astype(np.uint16)
          for _ in range(5)]
    for D, g in zip(Ds, dev.matmul_stripes_many(G[10:], Ds)):
        np.testing.assert_array_equal(g, host_matvec(dev.gf, G[10:], D))


@pytest.mark.cuda
def test_chained_encode_decode_on_the_card(card4):
    rng = np.random.default_rng(5)
    dev = DeviceCodec()
    G = generator_matrix(dev.gf, 10, 14, "cauchy")
    words = _words(rng, (8, 10, 4096))
    parity = card4.matmul_words_batch(dev, G[10:], words)
    data = card4.shard(words)
    assert len({s.cuda_stream for s in parity.streams}) == 4
    flip = int(np.uint32(0x5A5A5A5A).view(np.int32))

    def assemble(d, p):
        full = torch.cat([d, p], dim=1)
        full[:, 3] ^= flip
        return full

    corrected, bad = card4.decode1_words_batch(
        dev, G[10:], 3, data.map(assemble, parity))
    assert not np.asarray(bad).any()
    np.testing.assert_array_equal(np.asarray(corrected).view(np.uint32),
                                  words[:, 3])


@pytest.mark.cuda
def test_builders_on_the_card(card4):
    rng = np.random.default_rng(2)
    mesh = make_mesh(("batch", "row"), (2, 2),
                     [torch.device("cuda", 0)] * 4)
    bc = BatchCodec(10, 4)
    words = _words(rng, (4, 10, 2048))
    got = bc.make_sharded_encoder_words(mesh, row_axis="row")(words)
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].cpu().numpy().view(np.uint8),
            host_matvec(bc.gf, bc.parity_matrix, words[b].view(np.uint8)))
    bc200 = BatchCodec(200, 56)
    w200 = _words(rng, (4, 200, 1024))
    reset_launch_counts()
    p200 = bc200.make_sharded_encoder_words(mesh, row_axis="row")(w200)
    assert launch_counts()["mxu_gf2"] == 4
    np.testing.assert_array_equal(
        p200[0].cpu().numpy().view(np.uint8),
        host_matvec(bc200.gf, bc200.parity_matrix, w200[0].view(np.uint8)))
