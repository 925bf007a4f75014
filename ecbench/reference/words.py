"""Plain PyTorch GF(2^8) matrix products on int32 words.

A word holds four field elements, one a byte. Multiplying a word by x is
``xtime``: each byte shifts left, and a byte whose top bit fell out takes
the low byte of the field's polynomial. A product by a constant c is the
XOR of the ``xtime`` powers that c's set bits pick. Elementwise tensor ops
only, so it runs on the card or the CPU. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

_LOW7 = 0x7F7F7F7F
_TOP = 0x01010101


def xtime(x: torch.Tensor, poly: int) -> torch.Tensor:
    """Each byte of int32 words times x, modulo ``poly``."""
    top = (x >> 7) & _TOP
    return ((x & _LOW7) << 1) ^ (top * (poly & 0xFF))


def matmul_words(poly: int, M, words: torch.Tensor,
                 block: int = 32) -> torch.Tensor:
    """(R, K) matrix over GF(2^8) modulo ``poly`` x (B, K, TW) int32 words
    -> (B, R, TW), computed ``block`` stripes at a time so the temporaries
    stay small."""
    M = np.asarray(M, dtype=np.int64)
    B, K, TW = words.shape
    if M.shape[1] != K or words.dtype != torch.int32:
        raise ValueError(f"matrix {M.shape} against words "
                         f"{tuple(words.shape)} {words.dtype}")
    R = M.shape[0]
    out = torch.zeros((B, R, TW), dtype=torch.int32, device=words.device)
    for b0 in range(0, B, block):
        o = out[b0:b0 + block]
        for j in range(K):
            col = M[:, j]
            top = int(col.max()).bit_length()
            x = words[b0:b0 + block, j]
            for bit in range(top):
                for i in np.nonzero((col >> bit) & 1)[0]:
                    o[:, int(i)].bitwise_xor_(x)
                if bit + 1 < top:
                    x = xtime(x, poly)
    return out
