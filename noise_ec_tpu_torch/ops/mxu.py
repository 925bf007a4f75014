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

The wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from noise_ec_tpu_torch.gf.bitmatrix import expand_generator_bits
from noise_ec_tpu_torch.gf.field import GF
from noise_ec_tpu_torch.ops import _build

LAUNCHES = {"mxu_gf2": 0}

# Words a kernel block covers (128 byte columns): the pad-to multiple of TW.
MXU_TILE_WORDS = 32

# Columns the plain version expands to bits at a time (32768 byte columns:
# 8K * 4 * 32768 bytes of float32 bits, 420 MB at K = 400), so it runs at
# full shard width on the card.
_PLAIN_CHUNK_WORDS = 8192

_MAX_BATCH = 65535  # the grid's y dimension


def cached_bit_expansion(cache: dict, gf: GF, M: np.ndarray, device,
                         *, bound: int = 256) -> torch.Tensor:
    """The int8 (m*r, m*k) GF(2) expansion of ``M`` on ``device``, cached
    per full shape and bytes (``cache`` is the caller's; cleared past
    ``bound`` entries)."""
    M = np.ascontiguousarray(np.asarray(M, dtype=gf.dtype))
    key = (M.shape, M.tobytes())
    hit = cache.get(key)
    if hit is None:
        hit = torch.from_numpy(
            expand_generator_bits(gf, M).view(np.int8)).to(device)
        if len(cache) > bound:
            cache.clear()
        cache[key] = hit
    return hit


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
    so padding is inert)."""
    if (m2.dtype != torch.int8 or m2.shape != (8 * r, 8 * k)
            or not m2.is_contiguous()):
        raise ValueError(
            f"expected a contiguous int8 ({8 * r}, {8 * k}) bit matrix, got "
            f"{m2.dtype} {tuple(m2.shape)}"
        )
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or not words.is_contiguous() or words.shape[-2] != k
            or words.shape[-1] % MXU_TILE_WORDS):
        raise ValueError(
            f"expected contiguous int32 (.., {k}, TW) words with TW a "
            f"multiple of {MXU_TILE_WORDS}, got {words.dtype} "
            f"{tuple(words.shape)}"
        )
    if words.device.type == "cpu" and m2.device.type == "cpu":
        return mxu_encode_words_bits_plain(m2, words, r, k)
    if words.device.type != "cuda" or m2.device != words.device:
        raise ValueError(
            f"no kernel for words on {words.device} and a bit matrix on "
            f"{m2.device}"
        )
    batched = words if words.dim() == 3 else words[None]
    B, _, TW = batched.shape
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the grid's {_MAX_BATCH}")
    if m2.data_ptr() % 8:
        raise ValueError("the bit matrix must be 8-byte aligned")
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch("ec_mxu", words, _build.ptr(m2), _build.ptr(batched),
                  _build.ptr(out), B, r, k, TW)
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
        self._m2_cache: dict = {}

    def encode_words(self, M: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        """(r, k) GF matrix x (k, TW) int32 words on the codec's device ->
        (r, TW) words; TW a multiple of :data:`MXU_TILE_WORDS`."""
        r, k = np.asarray(M).shape
        if words.shape[0] != k:
            raise ValueError(f"matrix cols {k} != word rows {words.shape[0]}")
        m2 = cached_bit_expansion(self._m2_cache, self.gf, M, self.device)
        return mxu_encode_words_bits(m2, words, r, k)

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
