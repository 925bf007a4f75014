"""The port's K-sliced fused encode (K5) and its planner against the
reference's ``_dma_split_kernel`` in Pallas interpret mode, the NumPy
field arithmetic and the planner order the reference's candidate list
gives. Exact to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from noise_ec_tpu_torch.ops.network import (
    BLOCK_SIZES,
    compile_split,
    fits,
)
from noise_ec_tpu_torch.ops.xor_factor import split_bits_rows_ksl

_REF = RefDeviceCodec(field="gf256", kernel="pallas_interpret")

# RS(50,20) losing 10 data and 10 parity shards: the code's limit, a
# (20, 50) recovery matrix.
WIDE_LOST = list(range(0, 20, 2)) + list(range(50, 70, 2))


@pytest.fixture(scope="module")
def codec():
    """One CPU codec for the module: RS(50,20)'s planning (a whole-network
    factoring for K1, then K5's slices) runs once."""
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
    prog = compile_split(DeviceCodec(device="cpu").bits_rows_for(M), k, ksl)
    assert prog.P == -(-k // ksl)
    reset_launch_counts()
    got = fused_split_encode_words(prog, _t(words), r, 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        want.view(np.uint8), host_matvec(GF256(), M, words.view(np.uint8)))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("k,ksl", [(10, 8), (17, 8), (17, 16), (50, 16)])
def test_split_bits_rows_matches_reference(codec, k, ksl):
    r = {10: 4, 17: 3, 50: 20}[k]
    br = codec.bits_rows_for(_parity(k, r))
    assert split_bits_rows_ksl(br, k, 8, ksl) == ref_split(br, k, 8, ksl)


@pytest.mark.parametrize("k,r", [(50, 20), (64, 16)])
def test_wide_parity_plans_split_and_matches_host(codec, rng, k, r):
    M = _parity(k, r)
    kind, threads, prog, G = codec.plan_for(M)
    assert (kind, threads, prog.ksl, G) == ("split", 64, 8, 1)
    D = rng.integers(0, 256, size=(k, 3000), dtype=np.uint8)
    np.testing.assert_array_equal(codec.matmul_stripes(M, D),
                                  host_matvec(GF256(), M, D))
    w = _words(rng, (2, k, 8192))
    got = fused_split_encode_words_plain(prog, _t(w), r, 128)
    for b in range(2):
        np.testing.assert_array_equal(
            _u8(got[b]), host_matvec(GF256(), M, w[b].view(np.uint8)))


def test_wide_recovery_matrix_plans_split(codec, rng):
    """RS(50,20) at its 20-erasure limit: the (20, 50) recovery matrix
    runs on K5 too, and rebuilds what was lost."""
    gf = GF256()
    G = generator_matrix(gf, 50, 70, "cauchy")
    present = [i for i in range(70) if i not in WIDE_LOST]
    R = reconstruction_matrix(gf, G, present[:50], WIDE_LOST)
    kind, threads, prog, _ = codec.plan_for(R)
    assert (kind, threads, prog.ksl) == ("split", 64, 8)
    data = rng.integers(0, 256, size=(50, 2048), dtype=np.uint8)
    full = np.concatenate([data, host_matvec(gf, G[50:], data)])
    np.testing.assert_array_equal(
        codec.matmul_stripes(R, full[present[:50]]), full[WIDE_LOST])


def test_gf16_rs_30_10_runs_split(rng):
    """GF(2^16) RS(30,10) runs byte-sliced over 60 byte rows: K1 cannot
    hold its network, K5 at ksl = 8 can, for encode and a 10-erasure
    reconstruct."""
    from noise_ec_tpu.codec.rs import ReedSolomon as RefRS

    rs = ReedSolomon(30, 10, field="gf65536", device="cpu")
    kind, threads, prog, _ = rs._dev.plan_for(rs.G[30:])
    assert (kind, threads, prog.ksl, prog.n_slots) == ("split", 64, 8, 743)
    ref = RefRS(30, 10, field="gf65536", backend="numpy")
    data = list(rng.integers(0, 256, size=(30, 2048), dtype=np.uint8))
    enc = rs.encode(data)
    want = ref.encode(data)
    assert all(np.array_equal(a, b) for a, b in zip(enc, want))
    holes = [None if i % 4 == 1 else s for i, s in enumerate(enc)]
    assert sum(s is None for s in holes) == 10
    rec = rs.reconstruct(holes)
    assert all(np.array_equal(a, b) for a, b in zip(rec, enc))


def test_split_plan_takes_the_largest_block_then_the_fewest_xors(codec):
    """RS(50,20) fits no block above 64 threads at any slicing; at 64
    threads only ksl = 8 fits (ksl = 16 does not), and that is
    the plan. RS(17,3) fits 256 threads at ksl = 8 (P = 3)."""
    br = codec.bits_rows_for(_parity(50, 20))
    threads, ksl, prog = fused_split_plan(br, 50, 20)
    assert (threads, ksl, prog.n_slots, prog.cost) == (64, 8, 736, 12144)
    assert fits(prog, 64) and not fits(prog, 128)
    assert not fits(compile_split(br, 50, 16), 64)
    assert prog.cost == sum(p.cost for p in prog.phases) + 6 * 160
    br17 = codec.bits_rows_for(_parity(17, 3))
    threads, ksl, prog17 = fused_split_plan(br17, 17, 3)
    assert (threads, ksl, prog17.P) == (BLOCK_SIZES[0], 8, 3)
    cands = [compile_split(br17, 17, s) for s in (8, 16)]
    assert prog17.cost == min(p.cost for p in cands if fits(p, 256))


def test_planner_order_and_forced_split(codec, rng):
    """K1 first, then K5, then the pipeline: RS(10,4) and RS(17,3) stay on
    K1; forcing "split" on RS(10,4) gives K1's bytes; forcing it on the
    interleaved GF(2^16) entry raises."""
    for k, r in ((10, 4), (17, 3)):
        assert codec.plan_for(_parity(k, r))[0] == "fused"
    M = _parity(10, 4)
    kind, threads, prog, _ = codec.plan_for(M, "split")
    assert (kind, prog.P) == ("split", 2)
    D = rng.integers(0, 256, size=(10, 5000), dtype=np.uint8)
    np.testing.assert_array_equal(codec.matmul_stripes(M, D, tier="split"),
                                  codec.matmul_stripes(M, D, tier="fused"))
    w = _t(_words(rng, (10, 700)))
    assert torch.equal(codec.matmul_words(M, w, tier="split"),
                       codec.matmul_words(M, w))
    codec16 = DeviceCodec(field="gf65536", device="cpu")
    with pytest.raises(ValueError, match="split"):
        codec16.matmul_words(generator_matrix(GF65536(), 4, 6)[4:],
                             torch.zeros((4, 64), dtype=torch.int32),
                             tier="split")


def test_split_rejects_what_it_cannot_run(codec):
    prog = fused_split_plan(codec.bits_rows_for(_parity(10, 4)), 10, 4)[2]
    words = torch.zeros((10, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        fused_split_encode_words(prog, words[:9], 4, 256)
    with pytest.raises(ValueError, match="int32"):
        fused_split_encode_words(
            prog, torch.zeros((10, 16384), dtype=torch.int32)[:, ::2], 4, 256)
    with pytest.raises(ValueError, match="no kernel"):
        fused_split_encode_words(prog, words.to("meta"), 4, 256)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds K5 on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(10, 4), (17, 3), (50, 20)])
def test_split_kernel_matches_plain_on_cuda(codec, rng, k, r):
    _require_cuda()
    M = _parity(k, r)
    threads, _, prog = fused_split_plan(codec.bits_rows_for(M), k, r)
    prog = prog.to("cuda")
    words = _t(_words(rng, (k, 65536))).cuda()
    got = fused_split_encode_words(prog, words, r, threads)
    assert torch.equal(got, fused_split_encode_words_plain(prog, words, r,
                                                           128))
