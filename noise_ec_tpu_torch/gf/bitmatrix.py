"""The bitsliced view of GF(2^m): constants as GF(2) bit-matrices.

A copy of the part of ``noise_ec_tpu.gf.bitmatrix`` the port needs.

Multiplication by a constant c in GF(2^m) is linear over GF(2): writing a field
element x as the bit-vector (x_0 .. x_{m-1}), there is an m x m binary matrix
M_c with bits(c * x) = M_c @ bits(x) (mod 2). Expanding every entry of an
r x k generator matrix G into its M_c block turns the whole RS encode
(parity = G_parity @ data over GF(2^m), reference hot loop main.go:262)
into ONE binary matrix multiply over bit-planes — pure XOR on 32-bit words,
which is what the port's CUDA kernels evaluate.
"""

from __future__ import annotations

import numpy as np

from noise_ec_tpu_torch.gf.field import GF


def constant_bitmatrix(gf: GF, c: int) -> np.ndarray:
    """The m x m GF(2) matrix M_c with bits(c*x) = M_c @ bits(x).

    Column j of M_c is the bit-vector of c * 2^j.
    """
    m = gf.degree
    cols = gf.mul(c, (1 << np.arange(m)).astype(np.int64))  # (m,) values c * 2^j
    out = np.zeros((m, m), dtype=np.uint8)
    for j in range(m):
        v = int(cols[j])
        for i in range(m):
            out[i, j] = (v >> i) & 1
    return out


def expand_generator_bits(gf: GF, G: np.ndarray) -> np.ndarray:
    """Expand an (r, k) GF generator matrix to its (m*r, m*k) GF(2) form.

    Block (i, j) is :func:`constant_bitmatrix` of ``G[i, j]``, built for
    every entry at once: one broadcast ``gf.mul`` gives each symbol's m
    columns c * 2^b, and shifts pull out their bits."""
    G = np.asarray(G)
    r, k = G.shape
    m = gf.degree
    cols = gf.mul(G[:, :, None], (1 << np.arange(m))[None, None, :])
    bits = (cols[..., None].astype(np.uint32)
            >> np.arange(m, dtype=np.uint32)) & 1  # [i, j, col b, bit a]
    return np.ascontiguousarray(
        bits.transpose(0, 3, 1, 2).reshape(m * r, m * k), dtype=np.uint8)


def expand_generator_masks(gf: GF, G: np.ndarray) -> np.ndarray:
    """Like :func:`expand_generator_bits` but as select masks: the (m*r,
    m*k) operand of the dense-mask kernels (ops/gf2mm.py), -1 (every bit
    set, the reference's 0xFFFFFFFF) where the bit is set and 0 elsewhere,
    as int32. Built by a view of the uint32 masks, so no value is clamped."""
    bits = expand_generator_bits(gf, G)
    return (bits.astype(np.uint32) * np.uint32(0xFFFFFFFF)).view(np.int32)
