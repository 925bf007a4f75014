"""K8: the dense GF(2) product of the "mxu" route, on the tensor cores.

Port of ``noise_ec_tpu.ops.mxu_gf2`` (``_mxu_kernel`` under
``mxu_encode_words_bits``), CUDA source ``csrc/mxu.cu``. The (8R, 8K) GF(2)
bit matrix of a GF matrix is an int8 operand of 0/1, the data's bits an
(8K, N) 0/1 matrix over its N byte columns, and

    out bit (8i + b, n) = (M2 @ bits)[8i + b, n] & 1,

packed back into bytes and int32 words. The kernel is pure GF(2), so it
serves GF(2^8) matrices over K = k byte rows and, unchanged, the byte-sliced
GF(2^16) route over K = 2k byte rows, whose (16r, 16k) bit expansion is an
(8R, 8K) one with R = 2r (the flat plane index 16j + b is
(2j + b//8)*8 + b%8). The work is a fixed 64*R*K multiply-adds a byte
column, so dispatch sends a matrix here only past every XOR-network budget.

The kernel (``wgmma`` over a ring of bulk copies, ``csrc/mxu.cu``) stages
M2 as :class:`MxuTiles`: row tiles of N bit rows (N from :data:`N_MENU`,
one ``wgmma`` width) by K chunks of 128 bits, each piece N rows of 128
bytes in the shared-memory image ``wgmma`` reads with its 128-byte swizzle
(16-byte group q of row r stored at q ^ (r % 8)), zero past 8R and 8K.
:func:`build_mxu_tiles` lays it out with torch ops on M2's device;
``DeviceCodec`` plans it once per matrix and calls
:func:`mxu_encode_tiles`; :func:`mxu_encode_words_bits` keeps the
reference's signature and tiles an untiled M2 on every call.

The wrappers take the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF
from noise_ec_tpu_torch.ops import _build

LAUNCHES = {"mxu_gf2": 0}

# The pad-to multiple of TW: the kernel masks a ragged edge of its own
# column blocks, and its bulk copies need rows of whole 16-byte pieces.
MXU_TILE_WORDS = 32

# N_MENU: the wgmma widths N (bit rows a row tile) that csrc/mxu.cu builds,
# each on its own ring (four consumer warpgroups up to N = 128, two above);
# K_CHUNK_BITS: the K bits a stage (one 128-byte swizzled row of M2).
N_MENU = (32, 128, 224)
K_CHUNK_BITS = 128
# tile_width's charge for a row tile beyond its rows: each tile re-reads the
# data and rebuilds its fragments. The fit t = a * (T N) + b * T to K8 at
# N = 224 and N = 128 on RS(200,56)'s 896 rows (chip_smoke.py --mxu-sweep,
# PERF.md) gives b / a = 20 rows; it also orders the two widths on
# the dense (200, 200) matrix as measured.
_TILE_COST_ROWS = 20

# Columns the plain version expands to bits at a time (32768 byte columns:
# 8K * 4 * 32768 bytes of float32 bits, 420 MB at K = 400), so it runs at
# full shard width on the card.
_PLAIN_CHUNK_WORDS = 8192


def cached_bit_expansion(cache: dict, gf: GF, M: np.ndarray, device,
                         *, bound: int = 256, tiled: bool = False):
    """The int8 (m*r, m*k) GF(2) expansion of ``M`` on ``device`` (with
    ``tiled``, laid out as K8 stages it: :func:`build_mxu_tiles`), cached
    per full shape, bytes and form (``cache`` is the caller's; cleared past
    ``bound`` entries)."""
    M = np.ascontiguousarray(np.asarray(M, dtype=gf.dtype))
    key = (M.shape, M.tobytes(), tiled)
    hit = cache.get(key)
    if hit is None:
        hit = torch.from_numpy(
            expand_generator_bits(gf, M).view(np.int8)).to(device)
        if tiled:
            hit = build_mxu_tiles(hit, hit.shape[0] // 8, hit.shape[1] // 8)
        if len(cache) > bound:
            cache.clear()
        cache[key] = hit
    return hit


def tile_width(rows: int) -> int:
    """The wgmma width N for 8R = ``rows`` bit rows: the N of
    :data:`N_MENU` whose T = ceil(rows / N) row tiles cost least, T * (N +
    20), the wider on a tie (896 rows: 4 x 224; 448: 2 x 224; 1600: 13 x
    128; 24: 1 x 32)."""
    return min(N_MENU, key=lambda n: (-(-rows // n) * (n + _TILE_COST_ROWS),
                                      -n))


def _swizzle(N: int, device) -> torch.Tensor:
    """(N, 8) int64: the 16-byte group stored at slot q of row r (an
    involution: the same map lays out and reads back)."""
    r = torch.arange(N, device=device)[:, None] % 8
    q = torch.arange(8, device=device)[None, :]
    return q ^ r


@dataclass(frozen=True)
class MxuTiles:
    """M2 as K8 stages it (module doc): ``tiles`` (T, NCH, N, 128) int8, row
    tile t and K chunk c one contiguous, swizzled piece."""

    tiles: torch.Tensor
    r: int  # R: output byte rows (8R bit rows)
    k: int  # K: input byte rows (8K bits)

    @property
    def T(self) -> int:
        return self.tiles.shape[0]

    @property
    def NCH(self) -> int:
        return self.tiles.shape[1]

    @property
    def N(self) -> int:
        return self.tiles.shape[2]

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def to(self, device) -> "MxuTiles":
        """The same operand on ``device``."""
        return dataclasses.replace(self, tiles=self.tiles.to(device))

    def matrix(self) -> torch.Tensor:
        """The (8R, 8K) int8 bit matrix, read back from the pieces."""
        T, NCH, N = self.T, self.NCH, self.N
        x = self.tiles.reshape(T, NCH, N, 8, 16)
        idx = _swizzle(N, self.device)[None, None, :, :, None].expand(
            T, NCH, N, 8, 16)
        x = torch.gather(x, 3, idx).permute(0, 2, 1, 3, 4)
        return x.reshape(T * N, NCH * 128)[:8 * self.r,
                                           :8 * self.k].contiguous()


def build_mxu_tiles(m2: torch.Tensor, r: int, k: int,
                    n: Optional[int] = None) -> MxuTiles:
    """Lay the (8r, 8k) int8 bit matrix ``m2`` out as :class:`MxuTiles` on
    its device, at wgmma width ``n`` (default :func:`tile_width`)."""
    _check_m2(m2, r, k)
    N = tile_width(8 * r) if n is None else n
    if N not in N_MENU:
        raise ValueError(f"no K8 build at width N={N}")
    T = -(-8 * r // N)
    NCH = -(-8 * k // K_CHUNK_BITS)
    full = m2.new_zeros((T * N, NCH * 128))
    full[:8 * r, :8 * k] = m2
    x = full.reshape(T, N, NCH, 8, 16).permute(0, 2, 1, 3, 4)
    idx = _swizzle(N, m2.device)[None, None, :, :, None].expand(
        T, NCH, N, 8, 16)
    tiles = torch.gather(x, 3, idx).reshape(T, NCH, N, 128).contiguous()
    return MxuTiles(tiles, r, k)


def _check_m2(m2: torch.Tensor, r: int, k: int) -> None:
    if (m2.dtype != torch.int8 or m2.shape != (8 * r, 8 * k)
            or not m2.is_contiguous()):
        raise ValueError(
            f"expected a contiguous int8 ({8 * r}, {8 * k}) bit matrix, got "
            f"{m2.dtype} {tuple(m2.shape)}"
        )


def _check_words(words: torch.Tensor, k: int) -> None:
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or not words.is_contiguous() or words.shape[-2] != k
            or words.shape[-1] % MXU_TILE_WORDS):
        raise ValueError(
            f"expected contiguous int32 (.., {k}, TW) words with TW a "
            f"multiple of {MXU_TILE_WORDS}, got {words.dtype} "
            f"{tuple(words.shape)}"
        )


def mxu_encode_words_bits_plain(m2: torch.Tensor, words: torch.Tensor,
                                r: int, k: int) -> torch.Tensor:
    """Plain PyTorch K8 on (k, TW) or (B, k, TW) words: the sums in
    float32, exact on 0/1 values while 8k < 2^24 (and under TF32 too, which
    keeps 0 and 1 exact and accumulates in float32)."""
    if words.dim() == 3:
        return torch.stack(
            [mxu_encode_words_bits_plain(m2, w, r, k) for w in words])
    TW = words.shape[1]
    a = m2.to(torch.float32)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    weights = torch.arange(8, dtype=torch.int32,
                           device=words.device)[None, :, None]
    out = torch.empty((r, TW), dtype=torch.int32, device=words.device)
    for c0 in range(0, TW, _PLAIN_CHUNK_WORDS):
        w = words[:, c0:c0 + _PLAIN_CHUNK_WORDS].contiguous()
        cols = w.view(torch.uint8)  # (k, N) byte columns, little-endian
        bits = (cols[:, None, :] >> shifts[None, :, None]) & 1
        acc = a @ bits.reshape(8 * k, -1).to(torch.float32)
        parity = acc.to(torch.int32).reshape(r, 8, -1) & 1
        byte = (parity << weights).sum(1).to(torch.uint8)
        out[:, c0:c0 + w.shape[1]] = byte.view(torch.int32)
    return out


def mxu_encode_words_bits(m2: torch.Tensor, words: torch.Tensor,
                          r: int, k: int) -> torch.Tensor:
    """K8: (k, TW) or (B, k, TW) int32 words over k byte rows -> (.., r, TW)
    through the (8r, 8k) 0/1 int8 bit matrix ``m2``. TW must be a multiple
    of :data:`MXU_TILE_WORDS` (callers pad; byte columns are positionwise,
    so padding is inert). On the card ``m2`` is tiled on every call
    (:func:`build_mxu_tiles`), so this is the reference's signature and
    not a hot path: a caller that reuses a matrix plans its tiles once and
    calls :func:`mxu_encode_tiles`, as ``DeviceCodec`` and
    :class:`MxuCodec` do."""
    _check_m2(m2, r, k)
    _check_words(words, k)
    if words.device.type == "cpu" and m2.device.type == "cpu":
        return mxu_encode_words_bits_plain(m2, words, r, k)
    if words.device.type != "cuda" or m2.device != words.device:
        raise ValueError(
            f"no kernel for words on {words.device} and a bit matrix on "
            f"{m2.device}"
        )
    return mxu_encode_tiles(build_mxu_tiles(m2, r, k), words)


def mxu_encode_tiles(tiles: MxuTiles, words: torch.Tensor) -> torch.Tensor:
    """K8 on a planned operand: (K, TW) or (B, K, TW) int32 words ->
    (.., R, TW), on a grid of at most one block an SM."""
    r, k = tiles.r, tiles.k
    _check_words(words, k)
    if words.device.type == "cpu" and tiles.device.type == "cpu":
        return mxu_encode_words_bits_plain(tiles.matrix(), words, r, k)
    if words.device.type != "cuda" or tiles.device != words.device:
        raise ValueError(
            f"no kernel for words on {words.device} and tiles on "
            f"{tiles.device}"
        )
    batched = words if words.dim() == 3 else words[None]
    B, _, TW = batched.shape
    ctas = torch.cuda.get_device_properties(
        words.device).multi_processor_count
    if tiles.tiles.data_ptr() % 16 or batched.data_ptr() % 16:
        raise ValueError("K8's bulk copies need 16-byte aligned tensors")
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch("ec_mxu", words, _build.ptr(tiles.tiles),
                  _build.ptr(batched), _build.ptr(out), B, r, k, TW,
                  tiles.N, tiles.T, tiles.NCH, ctas)
    LAUNCHES["mxu_gf2"] += 1
    return out if words.dim() == 3 else out[0]


class MxuCodec:
    """The "mxu" route on its own: a GF(2^8) matrix times word or byte
    stripes through K8, parity rows only (the reference's ``MxuCodec``).
    ``DeviceCodec`` reaches the same kernel through its "mxu" plans."""

    def __init__(self, gf: GF, device: str = "cuda"):
        if gf.degree != 8:
            raise ValueError("MxuCodec takes GF(2^8); GF(2^16) runs K8 on "
                             "DeviceCodec's byte-sliced entries")
        self.gf = gf
        self.device = torch.device(device)
        self._tiles_cache: dict = {}

    def encode_words(self, M: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        """(r, k) GF matrix x (k, TW) int32 words on the codec's device ->
        (r, TW) words; TW a multiple of :data:`MXU_TILE_WORDS`."""
        r, k = np.asarray(M).shape
        if words.shape[0] != k:
            raise ValueError(f"matrix cols {k} != word rows {words.shape[0]}")
        tiles = cached_bit_expansion(self._tiles_cache, self.gf, M,
                                     self.device, tiled=True)
        return mxu_encode_tiles(tiles, words)

    def encode_stripes(self, M: np.ndarray, D: np.ndarray) -> np.ndarray:
        """(r, k) x (k, S) uint8 host stripes -> (r, S), padded to the
        word tile on the way in and sliced on the way out."""
        D = np.asarray(D, dtype=np.uint8)
        k, S = D.shape
        TW = -(-S // (4 * MXU_TILE_WORDS)) * MXU_TILE_WORDS
        buf = np.zeros((k, 4 * TW), dtype=np.uint8)
        buf[:, :S] = D
        words = torch.from_numpy(buf.view(np.int32)).to(self.device)
        out = self.encode_words(M, words).cpu().numpy().view(np.uint8)
        return np.ascontiguousarray(out[:, :S])
