"""K9 and K10 (``csrc/pack.cu`` ``groups_kernel<N, V, kPack>``): a NumPy
walk of the kernel's index math in its own order — blocks on (x, y), rows
on y with the row-stride loop, V lanes a thread with the grid-stride loop
past the one-wave cap, the group index by the host's magic multiply, each
thread's N vector loads and N vector stores — at every V, block size and
the grid ``groups_launch`` plans for 1, 4 and 132 SMs, checking that every
input word is read once and every output word written once. The walk's
result is held against ``_pack_groups_plain`` / ``_unpack_groups_plain``
and the reference's ``pack_words_pallas`` / ``unpack_words_pallas`` /
``pack_words16_pallas`` / ``unpack_words16_pallas`` in interpret mode, at
TL = 129, 130, 384 and 512. Also: ``lane_divider`` against floor division,
pins of ``groups_launch`` and of the wrapper's V, the constants against the
source. The ``cuda`` case runs on the card (``python -m pytest -m cuda
tests/test_torch_pack_groups.py``). Tolerance: byte-identical
throughout."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.ops import pallas_pack as ref_pack
from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.pack import (
    GROUP_THREADS,
    GROUP_VECS,
    GROUP_WORDS,
    LAUNCHES,
    MAX_GRID_Y,
    SM_THREADS,
    _groups,
    _pack_groups_plain,
    _unpack_groups_plain,
    groups_launch,
    groups_vec,
    lane_divider,
    pack_words16,
    pack_words_sublane,
    tile_lanes,
    unpack_words16,
    unpack_words_sublane,
)

SOURCE = (Path(__file__).resolve().parent.parent / "noise_ec_tpu_torch"
          / "csrc" / "pack.cu")
# (group, TW) at each TL the reference's _tile_lanes gives: 129 and 130
# (TL not a multiple of 4), 384 (not a power of two), 512 over two groups.
SHAPES = {(8, 129): 1032, (8, 130): 1040, (8, 384): 3072, (8, 512): 8192,
          (16, 129): 2064, (16, 130): 2080, (16, 384): 6144,
          (16, 512): 16384}
_ROUNDS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
           (8, 0x00FF00FF))


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _transpose(w: np.ndarray) -> np.ndarray:
    """transpose_group<N> over the last axis of uint32 words (csrc/
    common.cuh): the delta-swap rounds d < N, pairs (i, i + d), i & d == 0."""
    w = w.copy()
    N = w.shape[-1]
    for d, mask in _ROUNDS[:N.bit_length() - 1]:
        for i in range(N):
            if i & d == 0:
                t = ((w[..., i] >> np.uint32(d)) ^ w[..., i + d]) \
                    & np.uint32(mask)
                w[..., i] ^= t << np.uint32(d)
                w[..., i + d] ^= t
    return w


def emulate(x: np.ndarray, group: int, pack: bool, V: int, launch, rng):
    """groups_kernel<group, V, pack> on the flat uint32 words of ``x`` as
    ec_groups launches it on the (threads, bx, by) ``launch``, block row by
    block row and grid-stride step by step, all threads of a step at once.
    The output starts as random words; returns it with the count of reads
    of every input word and writes of every output word."""
    threads, bx, by = launch
    rows = x.shape[0]
    TW = x.size // rows
    TL = tile_lanes(TW, group)
    magic, shift = lane_divider(TL)
    src = x.reshape(-1)
    out = _words(rng, src.shape)
    reads = np.zeros(src.size, dtype=np.int64)
    writes = np.zeros(src.size, dtype=np.int64)
    per_row = TW // group
    items = per_row // V
    stride = bx * threads
    tid = np.arange(stride, dtype=np.uint64)  # blockIdx.x * blockDim.x + x
    i = np.arange(group, dtype=np.uint64)
    v = np.arange(V, dtype=np.uint64)
    for y in range(by):
        for j in range(y, rows, by):
            base = j * TW  # the one 64-bit multiply
            for t0 in range(0, items, stride):
                t = tid[t0 + tid < items] + np.uint64(t0)
                assert t.max() + stride < 1 << 32  # t += stride in 32 bits
                q = t * np.uint64(V)
                umulhi = (q * np.uint64(magic)) >> np.uint64(32)
                assert (umulhi + q).max() < 1 << 32
                g = (umulhi + q) >> np.uint64(shift)
                grouped = g * np.uint64((group - 1) * TL) + q
                assert grouped.max() < 1 << 32
                words_at = grouped[:, None] + i[None, :] * np.uint64(TL)
                planes_at = i[None, :] * np.uint64(per_row) + q[:, None]
                load_at, store_at = ((words_at, planes_at) if pack
                                     else (planes_at, words_at))
                # Each vector access starts on a V-word boundary.
                assert not (load_at % V).any() and not (store_at % V).any()
                # [thread, i, v] -> w[thread][v][i], V transposes, stores.
                ld = (base + load_at[:, :, None] + v).astype(np.int64)
                st = (base + store_at[:, :, None] + v).astype(np.int64)
                np.add.at(reads, ld.reshape(-1), 1)
                w = _transpose(src[ld].transpose(0, 2, 1))
                out[st] = w.transpose(0, 2, 1)
                np.add.at(writes, st.reshape(-1), 1)
    return out, reads, writes


def _reference(x: np.ndarray, group: int, pack: bool) -> np.ndarray:
    fn = {(8, True): ref_pack.pack_words_pallas,
          (8, False): ref_pack.unpack_words_pallas,
          (16, True): ref_pack.pack_words16_pallas,
          (16, False): ref_pack.unpack_words16_pallas}[group, pack]
    return np.asarray(fn(jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("pack", [True, False], ids=["pack", "unpack"])
@pytest.mark.parametrize("group, TL", list(SHAPES))
def test_emulated_kernel_matches_plain_and_reference(rng, group, TL, pack):
    TW = SHAPES[group, TL]
    assert tile_lanes(TW, group) == TL
    for rows in (1, 3, 10):
        shape = (rows, TW) if pack else (rows, group, TW // group)
        x = _words(rng, shape)
        plain = _pack_groups_plain if pack else _unpack_groups_plain
        want = _u32(plain(_t(x), group) if pack else plain(_t(x)))
        if rows == 3:
            np.testing.assert_array_equal(_reference(x, group, pack), want)
        for V in GROUP_VECS:
            if TL % V:
                continue
            for sms in (1, 4, 132):
                for threads in GROUP_THREADS:
                    launch = groups_launch(rows, TW, group, V, sms, threads)
                    out, reads, writes = emulate(x, group, pack, V, launch,
                                                 rng)
                    assert (reads == 1).all() and (writes == 1).all(), (
                        V, sms, launch)
                    np.testing.assert_array_equal(out.reshape(want.shape),
                                                  want)


def test_emulation_runs_the_grid_stride_and_row_loops(rng):
    """At one SM the wave caps both grid axes, so both loops run."""
    threads, bx, by = groups_launch(10, 8192, 8, 1, 1, 256)
    assert by == 8 and bx == 1 and bx * threads < 8192 // 8
    x = _words(rng, (10, 8192))
    out, reads, writes = emulate(x, 8, True, 1, (threads, bx, by), rng)
    assert (reads == 1).all() and (writes == 1).all()
    np.testing.assert_array_equal(out.reshape(10, 8, 1024),
                                  _u32(_pack_groups_plain(_t(x), 8)))


@pytest.mark.parametrize("TL", [1, 2, 3, 7, 128, 129, 130, 255, 256, 384,
                                511, 512, 1000, 65535, (1 << 31) - 1])
def test_lane_divider_divides(rng, TL):
    magic, shift = lane_divider(TL)
    assert 0 < magic < 1 << 32 and (1 << shift) >= TL
    top = (1 << 31) - 1
    q = np.concatenate([
        rng.integers(0, 1 << 31, size=4096, dtype=np.uint64),
        np.arange(0, min(4 * TL + 2, 10000), dtype=np.uint64),
        np.array([top, top - 1, top - top % TL, top - top % TL - 1],
                 dtype=np.uint64)])
    umulhi = (q * np.uint64(magic)) >> np.uint64(32)
    assert (umulhi + q).max() < 1 << 32
    np.testing.assert_array_equal((umulhi + q) >> np.uint64(shift),
                                  q // np.uint64(TL))


def test_lane_divider_every_small_tl():
    q = np.arange(0, 1 << 16, dtype=np.uint64)
    for TL in range(1, 1025):
        magic, shift = lane_divider(TL)
        got = (((q * np.uint64(magic)) >> np.uint64(32)) + q) \
            >> np.uint64(shift)
        assert (got == q // np.uint64(TL)).all(), TL
    with pytest.raises(ValueError):
        lane_divider(0)


@pytest.mark.parametrize("rows, TW, group, V, want", [
    (10, 262144, 8, 4, (256, 32, 10)),   # K9 pack, RS(10,4), 1 MiB shards
    (4, 262144, 8, 4, (128, 64, 4)),     # K9 unpack: 128 blocks of 256 < 132
    (10, 262144, 16, 2, (256, 32, 10)),  # K10 pack
    (4, 262144, 16, 2, (128, 64, 4)),    # K10 unpack
    (49, 262144, 16, 2, (256, 21, 49)),  # K10 at RS(49,2): one wave
    (2, 262144, 16, 2, (64, 128, 2)),
    (4, 262144, 16, 4, (64, 64, 4)),     # four lanes: the sweep's shape
    (10, 1040, 8, 2, (64, 2, 10)),       # TL = 130
    (100000, 1024, 8, 4, (256, 1, 1056)),  # rows past one wave
    (1, 1 << 30, 8, 4, (256, 1056, 1)),  # one row past one wave
])
def test_groups_launch_pinned(rows, TW, group, V, want):
    assert groups_launch(rows, TW, group, V, 132) == want


@pytest.mark.parametrize("sms", [1, 4, 132])
def test_groups_launch_invariants(sms):
    for rows in (1, 2, 3, 4, 10, 49, 200, 70000):
        for TW in (1024, 2048, 3072, 16384, 262144):
            for group in (8, 16):
                if TW % (group * 128):
                    continue
                for V in GROUP_VECS:
                    threads, bx, by = groups_launch(rows, TW, group, V, sms)
                    items = TW // (group * V)
                    assert threads in GROUP_THREADS
                    assert 1 <= bx <= -(-items // threads)
                    assert 1 <= by <= min(rows, MAX_GRID_Y)
                    # Never past one wave of resident threads.
                    assert bx * by * threads <= sms * SM_THREADS
                    # The widest block that gives every SM one.
                    fills = [t for t in GROUP_THREADS
                             if -(-items // t) * rows >= sms]
                    assert threads == (fills[0] if fills
                                       else GROUP_THREADS[-1])


def test_groups_launch_refuses():
    with pytest.raises(ValueError):
        groups_launch(0, 1024, 8, 4, 132)
    with pytest.raises(ValueError):
        groups_launch(1, 1024, 8, 3, 132)
    with pytest.raises(ValueError):
        groups_launch(1, 1024, 8, 4, 132, 32)
    with pytest.raises(ValueError):
        groups_launch(1, 1032, 8, 4, 132)  # 129 lanes a group


def test_groups_vec_by_tl_group_and_alignment():
    base = torch.zeros(4096 + 4, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    assert groups_vec(512, 8, base) == 4
    assert groups_vec(384, 8, base, base) == 4
    assert groups_vec(130, 8, base) == 2
    assert groups_vec(129, 8, base) == 1
    assert groups_vec(512, 8, base[1:]) == 1   # 4 bytes off
    assert groups_vec(512, 8, base[2:]) == 2   # 8 bytes off
    assert groups_vec(512, 8, base[4:]) == 4   # 16 bytes off
    assert groups_vec(512, 8, base, base[2:]) == 2
    assert groups_vec(130, 8, base[2:]) == 2
    assert groups_vec(130, 8, base[1:]) == 1
    # Sixteen planes: two lanes a thread at most (GROUP_WORDS words).
    assert groups_vec(512, 16, base) == 2
    assert groups_vec(130, 16, base) == 2
    assert groups_vec(129, 16, base) == 1
    assert groups_vec(512, 16, base[1:]) == 1
    assert GROUP_WORDS == 32


def test_constants_match_source():
    """The planner's menu and the C entry's are the same (csrc/pack.cu)."""
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kMaxThreads = (\d+);",
                         src).group(1)) == max(GROUP_THREADS)
    entry = src[src.index('extern "C" int ec_groups('):]
    threads = {int(n) for n in re.findall(r"threads == (\d+)", entry)}
    assert threads | {max(GROUP_THREADS)} == set(GROUP_THREADS)
    assert {int(n) for n in re.findall(r"[(|] ?V == (\d+)", entry)} \
        == set(GROUP_VECS)
    assert len(re.search(r"ec_groups\((.*?)\)", entry, re.S).group(1)
               .split(",")) == len(_build._SIGNATURES["ec_groups"])
    # No 64-bit division left in the groups kernel.
    kernel = src[src.index("groups_kernel("):src.index("kThreads = 256")]
    assert "long long" not in kernel


def test_wrappers_plain_on_cpu_and_no_plain_route_elsewhere(rng):
    x = _t(_words(rng, (3, 3072)))
    before = dict(LAUNCHES)
    planes = pack_words_sublane(x)
    assert torch.equal(planes, _pack_groups_plain(x, 8))
    assert torch.equal(unpack_words_sublane(planes), x)
    x16 = _t(_words(rng, (3, 6144)))
    assert torch.equal(unpack_words16(pack_words16(x16)), x16)
    assert LAUNCHES == before  # the plain versions launch nothing
    assert _groups(x, 8, True, "pack_sublane", vec=1, threads=64).equal(
        planes)
    with pytest.raises(ValueError, match="no kernel"):
        pack_words_sublane(torch.empty((2, 1024), dtype=torch.int32,
                                       device="meta"))
    empty = pack_words_sublane(torch.zeros((0, 1024), dtype=torch.int32))
    assert empty.shape == (0, 8, 128)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")


@pytest.mark.cuda
def test_every_vec_and_block_matches_plain_on_cuda(rng):
    """Every V, block size and the planned launch on the card, at every TL
    of SHAPES, on inputs 4 and 8 bytes off 16, and past one wave."""
    _require_cuda()
    dev = torch.device("cuda")
    for (group, TL), TW in list(SHAPES.items()) + [((8, 512), 262144)]:
        for rows in (1, 10):
            flat = torch.from_numpy(_words(rng, rows * TW + 4).view(
                np.int32)).to(dev)
            for off in (0, 1, 2):
                x = flat[off:off + rows * TW].reshape(rows, TW)
                want = _pack_groups_plain(x, group)
                for V in GROUP_VECS:
                    if TL % V or x.data_ptr() % (4 * V):
                        continue
                    for threads in GROUP_THREADS + (None,):
                        got = _groups(x, group, True, "pack_sublane", V,
                                      threads)
                        assert torch.equal(got, want), (group, TL, V)
                        back = _groups(got, group, False, "unpack_sublane",
                                       V, threads)
                        assert torch.equal(back, x), (group, TL, V)
    big = torch.from_numpy(_words(rng, (70000, 1024)).view(np.int32)).to(dev)
    assert torch.equal(pack_words_sublane(big), _pack_groups_plain(big, 8))
