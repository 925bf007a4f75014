"""The level schedule of the factored XOR network (ops/network.py
``XorSchedule``), the operand K1 and K4 run on the executor in
``csrc/xornet.cuh``: its invariants, its packed fields and their overflow,
and a NumPy walk of the packed schedule in the kernel's own order (levels,
each level's op pairs split over the block's warps, slots ``[slot][column]``)
held to ``eval_program``, to the reference's ``eval_bits_rows`` and to the
reference's fused and sparse Pallas kernels in interpret mode. Exact to the
bit. The ``cuda``-marked cases hold the kernels to their plain versions on
the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.gf.field import GF65536 as RefGF65536
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.matrix.linalg import reconstruction_matrix as ref_recon
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu.ops.pallas_fused import _fused_call
from noise_ec_tpu.ops.pallas_gf2mm import _sparse_call
from noise_ec_tpu.ops.xor_factor import eval_bits_rows as ref_eval_bits_rows
from noise_ec_tpu_torch.ops import network
from noise_ec_tpu_torch.ops.fused import (
    _planes,
    _words,
    fused_encode_words,
    fused_encode_words_plain,
    fused_plan,
)
from noise_ec_tpu_torch.ops.gf2mm import (
    gf2_matmul_sparse,
    gf2_matmul_sparse_plain,
)
from noise_ec_tpu_torch.ops.network import (
    BLOCKS,
    NO_CAP,
    OP_LOAD,
    OP_NOP,
    OP_XOR,
    TILES,
    XorProgram,
    block_threads,
    compile_network,
    eval_program,
    fits,
    pick_tile,
    plan_schedule,
    schedule_program,
)

_FIELDS = {"gf256": RefGF256(), "gf65536": RefGF65536()}

# name: (field, k, r, erasures, temp cap, form). Form "K1" keeps the inputs
# in slots (the fused kernel's stage-in writes them); "K4" loads them one
# level before their first use, "K4 reload" before every use.
CASES = {
    "RS(4,2)": ("gf256", 4, 2, None, NO_CAP, "K1"),
    "RS(10,4)": ("gf256", 10, 4, None, NO_CAP, "K1"),
    "RS(17,3)": ("gf256", 17, 3, None, NO_CAP, "K1"),
    "RS(10,4) reconstruct {0,5,11}": ("gf256", 10, 4, (0, 5, 11), NO_CAP,
                                      "K1"),
    "GF(2^16) RS(10,4)": ("gf65536", 10, 4, None, NO_CAP, "K1"),
    "RS(10,4) temps capped at 50": ("gf256", 10, 4, None, 50, "K1"),
    "RS(10,4) inputs in memory": ("gf256", 10, 4, None, NO_CAP, "K4"),
    "RS(10,4) inputs reloaded": ("gf256", 10, 4, None, NO_CAP, "K4 reload"),
}


@functools.lru_cache(maxsize=None)
def _matrix(field, k, r, erasures):
    gf = _FIELDS[field]
    G = ref_generator(gf, k, k + r, "cauchy")
    if erasures is None:
        return G[k:]
    present = [i for i in range(k + r) if i not in erasures][:k]
    return ref_recon(gf, G, present, list(erasures))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(bits_rows, m, k, r, form, program, schedule) of a case."""
    field, k, r, erasures, cap, form = CASES[name]
    M = _matrix(field, k, r, erasures)
    ref = RefDeviceCodec(field=field, kernel="pallas_interpret")
    br = ref.bits_rows_for(M)
    m = 8 if field == "gf256" else 16
    r, k = M.shape
    prog = compile_network(br, m * k, max_temps=cap,
                           inputs_in_slots=form == "K1")
    return br, m, k, r, form, prog, schedule_program(prog, form == "K4 reload")


def _ops(sched):
    """The packed ops in stream order: (level, row, kind, dst, a, b)."""
    pairs = sched.pairs.numpy().view(np.uint32)
    ptr = sched.level_ptr.tolist()
    for lv in range(sched.n_levels):
        for p in range(ptr[lv], ptr[lv + 1]):
            for x, y in (pairs[p, :2], pairs[p, 2:]):
                yield (lv, p, int(y >> 16), int(x & 0xFFFF), int(x >> 16),
                       int(y & 0xFFFF))


def walk(sched, planes: np.ndarray, warps: int, tile: int,
         reverse: bool = False) -> np.ndarray:
    """The kernels' order on (C, cols) uint32 planes -> (R, cols): a block
    holds ``tile`` columns (the last one zero past ``cols``) in slots
    ``[slot][column]``; the fused kernel's stage-in parks the inputs first;
    then level by level, warp w takes op pairs w * P + q (q < P = 32 /
    min(tile, 32)) and every W * P-th after, and runs both ops of a pair;
    the warps run one after another (in reverse with ``reverse``: the
    order does not matter, since no op reads a slot written in its level);
    last, the output rows are read from ``out_slot``. Every tile runs the
    same program, so the walk runs all of them at once."""
    C, cols = planes.shape
    width = -(-cols // tile) * tile
    src = np.zeros((C, width), np.uint32)
    src[:, :cols] = planes
    slots = np.zeros((sched.n_slots, width), np.uint32)
    if sched.in_slot is not None:
        for c, s in enumerate(sched.in_slot.tolist()):
            if s >= 0:
                slots[s] = src[c]
    pairs = sched.pairs.numpy().view(np.uint32)
    ptr = sched.level_ptr.tolist()
    per_step = 32 // min(tile, 32)
    order = range(warps - 1, -1, -1) if reverse else range(warps)
    for lv in range(sched.n_levels):
        for w in order:
            for p in range(ptr[lv] + w * per_step, ptr[lv + 1],
                           warps * per_step):
                for q in range(per_step):
                    if p + q >= ptr[lv + 1]:
                        break
                    row = pairs[p + q]
                    for x, y in ((row[0], row[1]), (row[2], row[3])):
                        kind, d = y >> 16, x & 0xFFFF
                        if kind == OP_XOR:
                            slots[d] = slots[x >> 16] ^ slots[y & 0xFFFF]
                        elif kind == OP_LOAD:
                            slots[d] = src[x >> 16]
    out = np.zeros((sched.n_rows, cols), np.uint32)
    for r, s in enumerate(sched.out_slot.tolist()):
        if s >= 0:
            out[r] = slots[s, :cols]
    return out


def _rng_words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(input, reference output) of a case at one grid step of the
    reference's kernel: (k, TW) words through ``_fused_call`` for the
    fused form, (C, 8, 128) planes through ``_sparse_call`` for K4's."""
    br, m, k, r, form, _, _ = _case(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    if form == "K1":
        words = _rng_words(rng, (k, 1024 * m))
        out = _fused_call(br, k, r, 1024 * m, m, True)(jnp.asarray(words))
    else:
        words = _rng_words(rng, (m * k, 8, 128))
        out = _sparse_call(br, m * k, 128, 128, True)(jnp.asarray(words))
    return words, np.asarray(out)


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_invariants(name):
    """Every operand is an input or was written at an earlier level and
    still holds the value the program means: each slot is followed as a
    GF(2) sum of input planes (a bitset), and every output row is exactly
    its matrix row. No op reads a slot written in its own level, no two
    ops of a level write one slot, fields stay in range, pads only end an
    odd level, chunks hold whole levels within their size."""
    br, m, k, r, form, prog, sched = _case(name)
    C = m * k
    val = [None] * sched.n_slots
    if form == "K1":
        for c, s in enumerate(sched.in_slot.tolist()):
            if s >= 0:
                assert val[s] is None
                val[s] = 1 << c
    ptr = sched.level_ptr.tolist()
    assert all(a < b for a, b in zip(ptr, ptr[1:]))
    by_level = {}
    for op in _ops(sched):
        by_level.setdefault(op[0], []).append(op)
    n_xor = n_load = 0
    for lv in range(sched.n_levels):
        reads, writes = set(), []
        new = {}
        for _, row, kind, d, a, b in by_level[lv]:
            assert kind in (OP_XOR, OP_LOAD, OP_NOP)
            if kind == OP_NOP:
                assert row == ptr[lv + 1] - 1  # the pad of an odd level
                continue
            assert d < sched.n_slots
            if kind == OP_XOR:
                assert a < sched.n_slots and b < sched.n_slots
                assert val[a] is not None and val[b] is not None
                reads |= {a, b}
                new[d] = val[a] ^ val[b]
                n_xor += 1
            else:
                assert form != "K1" and a < C
                new[d] = 1 << a
                n_load += 1
            writes.append(d)
        assert len(writes) == len(set(writes))
        assert not reads & set(writes)
        for d, v in new.items():
            val[d] = v
    want = [sum(1 << c for c in row) for row in br]
    got = [0 if s < 0 else val[s] for s in sched.out_slot.tolist()]
    assert got == want
    assert n_xor == prog.cost and n_xor + n_load == sched.n_ops
    if form == "K4":  # each used input loaded once
        assert n_load == len({c for row in br for c in row})
    cl = sched.chunk_level.tolist()
    assert cl[0] == 0 and cl[-1] == sched.n_levels
    assert all(ptr[b] - ptr[a] <= sched.chunk_pairs
               for a, b in zip(cl, cl[1:]))


def test_reload_loads_before_every_use():
    """With ``reload`` an input's slot is read only in the level right
    after its load; without, each input is loaded once, a level before its
    first reader."""
    for name in ("RS(10,4) inputs in memory", "RS(10,4) inputs reloaded"):
        _, _, _, _, form, _, sched = _case(name)
        loaded = {}  # slot -> (load level, plane)
        first_use, loads = {}, {}
        for lv, _, kind, d, a, b in _ops(sched):
            if kind == OP_LOAD:
                loaded[d] = (lv, a)
                loads[a] = loads.get(a, 0) + 1
            elif kind == OP_XOR:
                for s in (a, b):
                    if s in loaded:
                        at, plane = loaded[s]
                        first_use.setdefault((plane, at), lv)
                        if form == "K4 reload":
                            assert lv == at + 1
                loaded.pop(d, None)
        assert all(lv == at + 1 for (_, at), lv in first_use.items())
        if form == "K4":
            assert set(loads.values()) == {1}
        else:
            assert max(loads.values()) > 1


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("warps,tile", [(8, 64), (16, 32), (3, 8)])
def test_walk_matches_program_and_reference(name, warps, tile):
    """The walk, in the kernel's order at this block shape (and with its
    warps in reverse), equals ``eval_program``, the reference's
    ``eval_bits_rows`` and the reference's interpret-mode kernel, byte for
    byte."""
    br, m, k, r, form, prog, sched = _case(name)
    inp, want = _reference(name)
    if form == "K1":
        tl = 128
        planes = _planes(torch.from_numpy(inp.view(np.int32)), tl, m)
        flat = planes.reshape(m * k, -1).numpy().view(np.uint32)
    else:
        flat = inp.reshape(m * k, -1)
    got = walk(sched, flat, warps, tile)
    np.testing.assert_array_equal(walk(sched, flat, warps, tile, True), got)
    plain = eval_program(prog, torch.from_numpy(flat.view(np.int32)))
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), got)
    ref = np.stack(ref_eval_bits_rows(
        br, m * k, lambda c: flat[c], lambda: np.zeros(flat.shape[1],
                                                       np.uint32)))
    np.testing.assert_array_equal(ref, got)
    if form == "K1":
        out = _words(torch.from_numpy(got.view(np.int32)).reshape(
            m * r, 8, -1), r, tl, m)
        np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    else:
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_ring_chunks_hold_whole_levels():
    """A program cut into 32-pair chunks splits its long levels into
    consecutive ones (their ops are independent) and computes the same."""
    _, m, k, _, _, prog, whole = _case("RS(17,3)")
    ringed = schedule_program(prog, chunk_pairs=32)
    assert ringed.n_chunks > 1 and ringed.n_levels > whole.n_levels
    assert ringed.ring_bytes == 2 * 32 * 16
    ptr, cl = ringed.level_ptr.tolist(), ringed.chunk_level.tolist()
    assert all(0 < ptr[b] - ptr[a] <= 32 for a, b in zip(cl, cl[1:]))
    assert ringed.n_slots == whole.n_slots and ringed.n_ops == whole.n_ops
    flat = _rng_words(np.random.default_rng(3), (m * k, 96))
    np.testing.assert_array_equal(walk(ringed, flat, 4, 32),
                                  walk(whole, flat, 4, 32))


def test_row_chains_trade_levels_for_slots():
    """Summing each output row in a chain keeps one partial sum a row:
    fewer slots, more levels, the same function."""
    _, m, k, _, _, prog, tree = _case("RS(10,4)")
    chain = schedule_program(prog, row_width=1)
    assert chain.n_slots < tree.n_slots and chain.n_levels > tree.n_levels
    flat = _rng_words(np.random.default_rng(4), (m * k, 64))
    np.testing.assert_array_equal(walk(chain, flat, 8, 32),
                                  walk(tree, flat, 8, 32))


def test_packed_fields_overflow_raises(monkeypatch):
    """An input plane or a slot past the 16-bit fields raises at plan
    time; nothing is truncated."""
    wide = XorProgram(
        ops=torch.tensor([[0, -1, -70_000]], dtype=torch.int32),
        row_ptr=torch.tensor([0, 1], dtype=torch.int32),
        row_terms=torch.tensor([0], dtype=torch.int32),
        in_slot=None, n_inputs=70_000, n_slots=1, cost=1,
    )
    with pytest.raises(ValueError, match="16-bit fields"):
        schedule_program(wide)
    _, _, _, _, _, prog, sched = _case("RS(10,4)")
    monkeypatch.setattr(network, "FIELD_LIMIT", sched.n_slots - 1)
    with pytest.raises(ValueError, match="16-bit fields"):
        schedule_program(prog)


def test_tile_and_block_choice():
    """A call takes the widest tile whose grid gives every SM a block,
    else the narrowest that fits; a block has sixteen warps where an SM
    holds fewer than four blocks of the widest tile."""
    _, _, _, _, _, _, sched = _case("RS(10,4)")
    assert sched.tiles == TILES
    assert pick_tile(sched, 262_144 // 8) == 64  # 1 MiB shards
    assert pick_tile(sched, 8192 // 8) == 8  # 32 KiB: 128 blocks of 8
    assert pick_tile(sched, 8192 // 8, batch=5) == 32
    assert block_threads(sched) == 512
    _, _, _, _, _, _, small = _case("RS(4,2)")
    assert block_threads(small) == 256
    assert fits(small, 64) and 4 * small.smem_bytes(64) <= network.SMEM_BYTES


def test_plan_schedule_streams_a_program_that_does_not_fit(monkeypatch):
    """Where the whole program and the slots of the narrowest tile exceed
    shared memory, the plan streams the program through a ring."""
    _, _, _, _, _, prog, whole = _case("RS(17,3)")
    budget = whole.smem_bytes(8) - 1
    monkeypatch.setattr(network, "SMEM_BYTES", budget)
    sched = plan_schedule(prog)
    assert sched is not None and sched.n_chunks > 1
    assert sched.smem_bytes(8) <= budget < whole.smem_bytes(8)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernels on "
                    "the card")


@pytest.mark.cuda
def test_fused16_kernel_matches_plain_on_cuda():
    """K1@16 on GF(2^16) RS(10,4) at its plan and at every tile and block
    its schedule fits, on a batch of two, against its plain version."""
    _require_cuda()
    br, m, k, r, _, _, _ = _case("GF(2^16) RS(10,4)")
    threads, sched = fused_plan(br, m * k)
    sched = sched.to("cuda")
    words = torch.from_numpy(_rng_words(np.random.default_rng(5), (
        2, k, 65536)).view(np.int32)).cuda()
    want = fused_encode_words_plain(sched, words, r, 128, m)
    assert torch.equal(fused_encode_words(sched, words, r, threads, m=m),
                       want)
    for tile in sched.tiles:
        for t in BLOCKS:
            got = fused_encode_words(sched, words, r, t, m=m, tile=tile)
            assert torch.equal(got, want), (tile, t)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_pairs", [None, 32])
def test_sparse_kernel_ring_matches_plain_on_cuda(chunk_pairs):
    """K4 with its program whole and streamed through 32-pair chunks, at
    every tile, against its plain version."""
    _require_cuda()
    _, m, k, _, _, prog, _ = _case("RS(10,4) inputs in memory")
    sched = schedule_program(prog, chunk_pairs=chunk_pairs).to("cuda")
    planes = torch.from_numpy(_rng_words(np.random.default_rng(6), (
        m * k, 8, 1000)).view(np.int32)).cuda()
    want = gf2_matmul_sparse_plain(sched, planes)
    for tile in sched.tiles:
        got = gf2_matmul_sparse(sched, planes, 512, tile=tile)
        assert torch.equal(got, want), tile
