"""The port's XorProgram and sparse GF(2) matmul (K4) against the reference:
the Paar factoring copy, the reference's sparse Pallas kernel in interpret
mode, and its own ``eval_bits_rows``. Exact to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.bitmatrix import expand_generator_bits as ref_expand
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.matrix.linalg import reconstruction_matrix as ref_recon
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu.ops.pallas_gf2mm import (
    bits_to_rows as ref_bits_to_rows,
    gf2_matmul_pallas_sparse_rows,
)
from noise_ec_tpu.ops.xor_factor import (
    eval_bits_rows as ref_eval_bits_rows,
    paar_factor as ref_paar_factor,
    split_bits_rows_panels as ref_split_panels,
)
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.gf2mm import (
    bits_to_rows,
    gf2_matmul_sparse,
    gf2_matmul_sparse_plain,
    sparse_plan,
)
from noise_ec_tpu_torch.ops.network import (
    BLOCKS,
    TILES,
    block_threads,
    compile_network,
    eval_program,
    fits,
    schedule_program,
)
from noise_ec_tpu_torch.ops.xor_factor import (
    eval_bits_rows,
    factored_cost,
    paar_factor,
    paar_factor_capped,
    split_bits_rows_panels,
)

_GF = RefGF256()


def _matrix(k, r, kind="cauchy", erasures=None):
    """Parity rows of RS(k, r), or the reconstruct matrix for ``erasures``
    from the first k surviving shards (reference construction)."""
    G = ref_generator(_GF, k, k + r, kind)
    if erasures is None:
        return G[k:]
    present = [i for i in range(k + r) if i not in erasures][:k]
    return ref_recon(_GF, G, present, list(erasures))


def _bits_rows(M):
    return ref_bits_to_rows(ref_expand(_GF, M))


def _planes(rng, C, W8=128) -> np.ndarray:
    w = rng.integers(0, 1 << 32, size=(C, 8, W8), dtype=np.uint64)
    return w.astype(np.uint32)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernels on the card")


# The factoring copy gives the reference's (ops, rows) exactly. The
# reference takes most of a minute to factor a whole RS(50,20) parity
# network in Python, so those two are compared on their first 100 rounds
# (a capped run is the prefix of the uncapped one; test_torch_codec.py
# runs the port's whole factoring through the slice).
@pytest.mark.parametrize("k,r,kind,erasures,cap", [
    (4, 2, "cauchy", None, None), (4, 2, "cauchy", (0, 3), None),
    (4, 2, "par1", None, None), (4, 2, "par1", (1, 5), None),
    (10, 4, "cauchy", None, None), (10, 4, "cauchy", (0, 5, 11), None),
    (10, 4, "par1", None, None), (10, 4, "par1", (0, 5, 11), None),
    (17, 3, "cauchy", None, None), (17, 3, "cauchy", (2, 9, 18), None),
    (17, 3, "par1", None, None), (17, 3, "par1", (2, 9, 18), None),
    (50, 20, "cauchy", None, 100), (50, 20, "cauchy", (0, 25, 49), None),
    (50, 20, "par1", None, 100), (50, 20, "par1", (0, 25, 49), None),
])
def test_paar_factor_matches_reference(k, r, kind, erasures, cap):
    br = _bits_rows(_matrix(k, r, kind, erasures))
    if cap is None:
        assert paar_factor(br, 8 * k) == ref_paar_factor(br, 8 * k)
    else:
        assert paar_factor(br, 8 * k, max_temps=cap) == ref_paar_factor(
            br, 8 * k, max_temps=cap
        )
    assert split_bits_rows_panels(br, 8 * k, 32, 16) == ref_split_panels(
        br, 8 * k, 32, 16
    )


@pytest.mark.parametrize("cap", [0, 1, 17, 100, 192, 193, 1000])
def test_capped_factoring_is_the_uncapped_prefix(cap):
    br = _bits_rows(_matrix(10, 4))
    assert paar_factor_capped(br, 80, cap) == paar_factor(br, 80, max_temps=cap)


def test_bits_rows_match_reference():
    M = _matrix(10, 4)
    port = DeviceCodec(device="cpu")
    ref = RefDeviceCodec(field="gf256", kernel="pallas_interpret")
    assert port.bits_rows_for(M) == ref.bits_rows_for(M) == bits_to_rows(
        ref_expand(_GF, M)
    )


# One interpret compile of the reference's sparse kernel per matrix; the
# same reference output then checks the port's program uncapped, capped,
# and in both slot forms.
@pytest.mark.parametrize("erasures", [None, (0, 5, 11)])
def test_program_matches_reference_sparse_kernel(rng, erasures):
    M = _matrix(10, 4, erasures=erasures)
    br = _bits_rows(M)
    C = 80
    planes = _planes(rng, C)
    want = np.asarray(
        gf2_matmul_pallas_sparse_rows(br, jnp.asarray(planes), interpret=True)
    )
    tplanes = torch.from_numpy(planes.view(np.int32))
    reset_launch_counts()
    for max_temps in (100_000, 50, 0):
        ops, _ = paar_factor_capped(br, C, max_temps)
        prog = compile_network(br, C, max_temps, inputs_in_slots=False)
        assert prog.n_slots <= len(ops)  # only temps take slots
        for reload in (False, True):
            sched = schedule_program(prog, reload)
            assert fits(sched, TILES[-1])
            got = gf2_matmul_sparse(sched, tplanes, block_threads(sched))
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        slotted = compile_network(br, C, max_temps)
        assert slotted.n_slots <= C + len(ops)
        assert slotted.n_slots >= int((slotted.in_slot >= 0).sum())
        np.testing.assert_array_equal(
            eval_program(slotted, tplanes).numpy().view(np.uint32), want
        )
    assert all(n == 0 for n in launch_counts().values())


def test_program_matches_eval_bits_rows(rng):
    """The port's program evaluation equals the factoring copy's own
    evaluator (and the reference's) on a reconstruct network, batched."""
    br = _bits_rows(_matrix(17, 3, erasures=(2, 9, 18)))
    C = 136
    planes = _planes(rng, C, W8=16)
    ref = np.stack(ref_eval_bits_rows(
        br, C, lambda c: planes[c], lambda: np.zeros((8, 16), np.uint32)))
    mine = np.stack(eval_bits_rows(
        br, C, lambda c: planes[c], lambda: np.zeros((8, 16), np.uint32)))
    np.testing.assert_array_equal(mine, ref)
    threads, prog = sparse_plan(br, C)
    batch = torch.from_numpy(np.stack([planes, planes[::-1].copy()]).view(np.int32))
    got = gf2_matmul_sparse(prog, batch, threads).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(
        got[1], np.stack(ref_eval_bits_rows(
            br, C, lambda c: planes[C - 1 - c],
            lambda: np.zeros((8, 16), np.uint32)))
    )


def test_liveness_reuses_slots():
    """Slots are reused after a value's last use: the peak is below one
    slot per value, and every slot index is in range."""
    br = _bits_rows(_matrix(10, 4))
    ops, rows = paar_factor(br, 80)
    prog = compile_network(br, 80)
    assert prog.n_slots < 80 + len(ops)
    assert prog.cost == factored_cost(ops, rows)
    assert int(prog.ops[:, 0].max()) < prog.n_slots
    assert int(prog.ops[:, 1:].min()) >= 0  # inputs live in slots
    ext = compile_network(br, 80, inputs_in_slots=False)
    assert int(ext.ops[:, 1:].min()) < 0  # inputs read from memory
    assert ext.in_slot is None and ext.n_slots < len(ops)


def test_sparse_plan_always_fits(monkeypatch):
    """A matrix whose temps overflow shared memory still gets a plan: the
    temp cap that fills it (here with a shrunken budget)."""
    br = _bits_rows(_matrix(10, 4))
    threads, prog = sparse_plan(br, 80)
    assert (threads, prog.n_slots) == (512, 306) and fits(prog, 64)
    assert not prog.reload and prog.tiles == TILES
    import noise_ec_tpu_torch.ops.gf2mm as gf2mm
    import noise_ec_tpu_torch.ops.network as network

    monkeypatch.setattr(network, "SMEM_BYTES", 40 * 32 * 4)
    monkeypatch.setattr(gf2mm, "SMEM_BYTES", 40 * 32 * 4)
    gf2mm.sparse_plan.cache_clear()
    try:
        threads, prog = gf2mm.sparse_plan(br, 80)
        assert threads == 1024 and prog.reload and prog.tiles == (8,)
        assert prog.n_slots * 8 * 4 + prog.ring_bytes + 16 <= 40 * 32 * 4
        assert prog.cost > 532  # the cap costs XORs
    finally:
        gf2mm.sparse_plan.cache_clear()


def test_sparse_rejects_a_slotted_program(rng):
    br = _bits_rows(_matrix(4, 2))
    prog = schedule_program(compile_network(br, 32))
    with pytest.raises(ValueError, match="inputs stay in memory"):
        gf2_matmul_sparse(prog, torch.zeros((32, 8, 128), dtype=torch.int32), 256)


@pytest.mark.cuda
@pytest.mark.parametrize("reload", [False, True])
def test_sparse_kernel_matches_plain_on_cuda(rng, reload):
    """K4 at its plan and at every tile and block its schedule fits, with
    its inputs loaded once and before every use, on a ragged last tile
    (33,000 plane words) and a batch of two, against its plain version."""
    _require_cuda()
    br = _bits_rows(_matrix(10, 4))
    threads, prog = sparse_plan(br, 80)
    if reload:
        prog = schedule_program(compile_network(br, 80, inputs_in_slots=False),
                                reload=True)
    prog = prog.to("cuda")
    planes = torch.from_numpy(_planes(rng, 80, W8=4125).view(np.int32)).cuda()
    want = gf2_matmul_sparse_plain(prog, planes)
    assert torch.equal(gf2_matmul_sparse(prog, planes, threads), want)
    for tile in prog.tiles:
        for t in BLOCKS:
            got = gf2_matmul_sparse(prog, planes, t, tile=tile)
            assert torch.equal(got, want), (tile, t)
    batch = torch.stack([planes, planes.flip(0)])
    assert torch.equal(gf2_matmul_sparse(prog, batch, threads),
                       gf2_matmul_sparse_plain(prog, batch))
