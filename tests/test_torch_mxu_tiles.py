"""K8's staged operand and its register maps, on the CPU.

- :class:`MxuTiles` (M2 laid out as ``csrc/mxu.cu`` stages it: row tiles
  by 128-bit K chunks, each piece in ``wgmma``'s 128-byte-swizzled image)
  reads back to M2, and its swizzle permutes the 16-byte groups of every
  row of every piece;
- a NumPy emulation of the kernel (the data bytes each lane spreads into
  its ``wgmma`` A fragment, the B operand read through the swizzled
  descriptor's addresses, the accumulator map, the epilogue's lane OR and
  the masked word store) gives the plain product, with stale bytes in the
  data rows past K;
- the plain version on a planned operand equals the reference's
  ``mxu_encode_words_bits(interpret=True)``.

Tolerance: byte-identical throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_ec_tpu.gf.field import GF65536 as RefGF65536
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.ops.mxu_gf2 import (
    mxu_encode_words_bits as ref_mxu_encode_words_bits,
)
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.mxu import (
    N_MENU,
    MxuTiles,
    build_mxu_tiles,
    mxu_encode_tiles,
    mxu_encode_words_bits_plain,
    tile_width,
)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _m2(rng, r, k):
    return torch.from_numpy(
        rng.integers(0, 2, size=(8 * r, 8 * k)).astype(np.int8))


@pytest.mark.parametrize("r,k", [(112, 400), (56, 400), (200, 200), (3, 5),
                                 (17, 33)])
def test_tiles_read_back_and_swizzle_is_a_bijection(rng, r, k):
    m2 = _m2(rng, r, k)
    t = build_mxu_tiles(m2, r, k)
    N, T, NCH = t.N, t.T, t.NCH
    assert N in N_MENU and T * N >= 8 * r > (T - 1) * N
    assert NCH == -(-k // 16)
    assert t.tiles.shape == (T, NCH, N, 128) and t.tiles.is_contiguous()
    assert torch.equal(t.matrix(), m2)
    # Zero past 8R and 8K: the padded matrix's bytes are all in the pieces.
    assert int(t.tiles.ne(0).sum()) == int(m2.ne(0).sum())
    # Slot q of row n holds 16-byte group q ^ (n % 8) (every row of every
    # piece a permutation of its eight groups).
    full = np.zeros((T * N, NCH * 128), dtype=np.int8)
    full[:8 * r, :8 * k] = m2.numpy()
    pieces = t.tiles.numpy().reshape(T, NCH, N, 8, 16)
    rng_rows = rng.integers(0, N, size=8)
    for tt in range(T):
        for c in range(NCH):
            for n in rng_rows:
                slots = [(q ^ (n % 8)) for q in range(8)]
                assert sorted(slots) == list(range(8))
                for q, grp in enumerate(slots):
                    want = full[tt * N + n,
                                c * 128 + 16 * grp:c * 128 + 16 * grp + 16]
                    np.testing.assert_array_equal(pieces[tt, c, n, q], want)


def test_tile_width_and_builds():
    assert [tile_width(x) for x in (896, 448, 1600, 24, 136, 8, 128)] == [
        224, 224, 128, 32, 224, 32, 128]
    with pytest.raises(ValueError, match="no K8 build"):
        build_mxu_tiles(torch.zeros((8, 8), dtype=torch.int8), 1, 1, n=40)


def test_builds_match_the_kernel_source():
    """ops/mxu.py's N_MENU is the set of EC_MXU_CASE lines of csrc/mxu.cu,
    and the wrapper refuses words it has no kernel or layout for."""
    import re
    from pathlib import Path

    import noise_ec_tpu_torch

    src = (Path(noise_ec_tpu_torch.__file__).parent / "csrc" /
           "mxu.cu").read_text()
    cases = {int(m) for m in re.findall(r"EC_MXU_CASE\((\d+)\)", src)}
    assert cases == set(N_MENU)
    tiles = build_mxu_tiles(torch.zeros((24, 40), dtype=torch.int8), 3, 5)
    with pytest.raises(ValueError, match="no kernel"):
        mxu_encode_tiles(tiles, torch.zeros((5, 64), dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError, match="multiple"):
        mxu_encode_tiles(tiles, torch.zeros((5, 48), dtype=torch.int32))


def _spread4(x):
    x = x.astype(np.uint32) & 0xF
    return ((x * 0x00204081) & 0x01010101).astype(np.uint32)


def emulate_k8(tiles: MxuTiles, words: np.ndarray, NC: int, rng) -> np.ndarray:
    """csrc/mxu.cu step by step on one (K, TW) uint32 array: each column
    block's stages (stale random bytes in the rows past K and the columns
    past TW), each lane's A registers, one wgmma per k32 step under the
    m64nNk32 register maps, then the epilogue."""
    R, K, N, T, NCH = tiles.r, tiles.k, tiles.N, tiles.T, tiles.NCH
    TW = words.shape[1]
    BW = 16 * NC  # words a block
    pieces = tiles.tiles.numpy().view(np.uint8).reshape(T, NCH, N * 128)
    wbytes = words.view(np.uint8).reshape(K, 4 * TW)
    out = np.zeros((R, TW), dtype=np.uint32)
    g = np.arange(32) >> 2
    tig = np.arange(32) & 3
    n = np.arange(N)
    for cb in range(-(-TW // BW)):
        word0 = cb * BW
        valid = min(BW, TW - word0)
        D = rng.integers(0, 256, size=(16 * NCH, 4 * BW), dtype=np.uint8)
        D[:K, :4 * valid] = wbytes[:, 4 * word0:4 * (word0 + valid)]
        for rt in range(T):
            # acc[wg, w, lane, 4 jn + e]
            acc = np.zeros((NC, 4, 32, N // 2), dtype=np.int64)
            for c in range(NCH):
                P = pieces[rt, c]
                for j in range(4):
                    kb = 32 * j + np.arange(32)
                    # B[kk, n]: the byte the descriptor at +32 j addresses.
                    B = P[n[None, :] * 128
                          + ((kb[:, None] // 16) ^ (n[None, :] % 8)) * 16
                          + kb[:, None] % 16].astype(np.int64)
                    for wg in range(NC):
                        for w in range(4):
                            c0 = 64 * wg + 16 * w + g
                            q0 = 16 * c + 4 * j + (tig >> 1)
                            q1 = q0 + 2
                            sh = 4 * (tig & 1)
                            regs = [_spread4(D[q0, c0] >> sh),
                                    _spread4(D[q0, c0 + 8] >> sh),
                                    _spread4(D[q1, c0] >> sh),
                                    _spread4(D[q1, c0 + 8] >> sh)]
                            # A fragment: register e of lane (g, tig) holds
                            # row g (+8 for odd e), K 4 tig .. (+16 for e >= 2).
                            A = np.zeros((16, 32), dtype=np.int64)
                            for e in range(4):
                                for i in range(4):
                                    A[g + 8 * (e & 1),
                                      4 * tig + 16 * (e >> 1) + i] = (
                                        regs[e] >> (8 * i)) & 0xFF
                            Dm = A @ B  # this warp's 16 rows x N
                            # Accumulator 4 jn + e: row g (+8 for e >= 2),
                            # column 8 jn + 2 tig + (e & 1).
                            for jn in range(N // 8):
                                for e in range(4):
                                    acc[wg, w, :, 4 * jn + e] += Dm[
                                        g + 8 * (e >> 1),
                                        8 * jn + 2 * tig + (e & 1)]
            obytes = np.zeros((N // 8, 64 * NC), dtype=np.uint8)
            for wg in range(NC):
                for w in range(4):
                    a = acc[wg, w] & 1
                    c0 = 64 * wg + 16 * w + g
                    for jn in range(N // 8):
                        v = ((a[:, 4 * jn] | a[:, 4 * jn + 1] << 1) << (2 * tig)
                             | (a[:, 4 * jn + 2] | a[:, 4 * jn + 3] << 1)
                             << (2 * tig + 8))
                        # The two shuffles: OR over the four lanes of a g.
                        v = np.bitwise_or.reduce(v.reshape(8, 4), axis=1)
                        v = np.repeat(v, 4)
                        mine = tig == (jn & 3)
                        obytes[jn, c0[mine]] = v[mine] & 0xFF
                        obytes[jn, c0[mine] + 8] = v[mine] >> 8
            owords = obytes.view(np.uint32)
            for jn in range(N // 8):
                row = rt * (N // 8) + jn
                if row < R:
                    out[row, word0:word0 + valid] = owords[jn, :valid]
    return out


@pytest.mark.parametrize("r,k,TW,n,NC", [(3, 5, 64, None, 4),
                                         (17, 33, 96, 128, 4),
                                         (2, 20, 32, None, 4),
                                         (17, 33, 96, None, 2),
                                         (30, 9, 160, 224, 2)])
def test_emulated_fragments_and_epilogue_give_the_product(rng, r, k, TW, n,
                                                          NC):
    m2 = _m2(rng, r, k)
    w = _words(rng, (k, TW))
    tiles = build_mxu_tiles(m2, r, k, n)
    got = emulate_k8(tiles, w, NC, rng)
    want = mxu_encode_words_bits_plain(m2, _t(w), r, k).numpy().view(
        np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r,k,n", [(3, 5, None), (17, 33, None),
                                   (17, 33, 128), (4, 10, 224)])
def test_plain_on_planned_operand_matches_reference(rng, r, k, n):
    m2 = _m2(rng, r, k)
    w = _words(rng, (k, 512))
    want = np.asarray(ref_mxu_encode_words_bits(
        m2.numpy(), jnp.asarray(w), r=r, k=k, interpret=True))
    got = mxu_encode_tiles(build_mxu_tiles(m2, r, k, n), _t(w))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_codec_plans_tiles_for_gf16(rng):
    """The byte-sliced GF(2^16) plan holds the tiled operand of the (16r,
    16k) expansion over 2k byte rows."""
    M = ref_generator(RefGF65536(), 100, 160, "cauchy")[100:]
    codec = DeviceCodec(field="gf65536", device="cpu")
    kind, _, tiles, _ = codec.plan_for(M)
    assert kind == "mxu" and isinstance(tiles, MxuTiles)
    assert (tiles.r, tiles.k, tiles.N, tiles.T) == (120, 200, 128, 8)
    np.testing.assert_array_equal(tiles.matrix().numpy().view(np.uint8),
                                  codec._bits_for(M))
