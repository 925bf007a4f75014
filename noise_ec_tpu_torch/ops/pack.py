"""K2/K3: the lane pack and unpack between words and tiled bit-planes.

Port of ``noise_ec_tpu.ops.pallas_pack``'s lane kernels
(``_pack_lanes_kernel`` / ``_unpack_lanes_kernel``), CUDA source
``csrc/pack.cu``. Words ``(rows, TW)`` int32 become planes
``(rows, 8, 8, W8)``, W8 = TW / 64, with the reference's TL-dependent
bijection: plane i of row j holds at ``(sigma, c*TL + l)`` bit i of the
32 symbols in words ``c*64*TL + (sigma*8 + i')*TL + l``, i' = 0..7. The
reference picks TL from its VMEM budget (``_lane_tl``); here it is a
parameter, so a test can pass the reference's choice, and pack and unpack
of one pipeline must be given the same TL.

Words are int32 views of the shard bytes: torch cannot shift uint32 on
the CPU. ``>>`` on int32 is arithmetic, which is exact here because every
right shift of the delta-swap is masked to bits the sign cannot reach.

The row-blocked pair (:func:`pack_words_lanes_blocked`,
:func:`unpack_words_lanes_blocked`) is the reference's wide-geometry
variant (``_pack_lanes_blocked_call`` / ``_unpack_lanes_blocked_call``,
K6): the same kernels, at the TL the reference pins to a 32-row block, so
the panel pipeline's two ends agree whatever the row counts.

The sublane pair (:func:`pack_words_sublane`, :func:`unpack_words_sublane`,
K9) ports ``_pack_kernel`` / ``_unpack_kernel``, the reference's tier-3
layout: words ``(rows, TW)`` viewed as ``(rows, TW/(8*TL), 8, TL)``
groups become 8 bit-planes ``(rows, 8, TW/8)`` through the 8x8
delta-swap, so plane i of row j is row 8j + i of the ``(8*rows, TW/8)``
plane matrix. The GF(2^16) pair (:func:`pack_words16`,
:func:`unpack_words16`, K10) ports ``_pack16_kernel`` /
``_unpack16_kernel``: the same sublane bijection at 16 words a group, so
interleaved-u16 words become 16 bit-planes ``(rows, 16, TW/16)`` through
the 16x16 delta-swap. One CUDA kernel, templated on the group, serves
both. Beside them sit the layout helpers of the byte-sliced GF(2^16)
route: the host relayout between u16 symbols and adjacent lo/hi byte
rows, and its device counterpart on words (plain PyTorch bit ops, as in
the reference).

Each kernel has a plain PyTorch version beside it. The wrappers take the
plain version only for a tensor on the CPU; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from noise_ec_tpu_torch.ops import _build

_ROUNDS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))
_ROUNDS16 = _ROUNDS + ((8, 0x00FF00FF),)
LAUNCHES = {"pack_lanes": 0, "unpack_lanes": 0, "pack_lanes_blocked": 0,
            "unpack_lanes_blocked": 0, "pack_sublane": 0,
            "unpack_sublane": 0, "pack_words16": 0, "unpack_words16": 0}

# The reference's row block for the wide-geometry pack, and the VMEM budget
# its TL rule sizes that block's double-buffered in and out tiles against
# (pallas_pack.PACK_ROW_BLOCK, _LANE_VMEM_BUDGET).
PACK_ROW_BLOCK = 32
_LANE_VMEM_BUDGET = 12 << 20


def lane_quantum(m: int = 8) -> int:
    """Pad-to multiple of the words entries: 8*m*128 words — the lane
    kernels' unit for GF(2^8), and for GF(2^16) the reference's
    interleaved-words quantum, which K10's tile divides."""
    if m not in (8, 16):
        raise ValueError(f"no words layout for m={m}")
    return 1024 * m


def lane_tl(TW: int) -> int:
    """The port's TL rule: the largest TL in {512, 256, 128} that divides
    W8 = TW / 64. The reference also shrinks TL to fit its VMEM; a CUDA
    thread holds one 8-word group whatever TL is, so here TL only fixes
    the bijection (and the run a warp's loads cover)."""
    for TL in (512, 256, 128):
        if TW % (64 * TL) == 0:
            return TL
    raise ValueError(f"word count {TW} is not a multiple of {lane_quantum()}")


def blocked_lane_tl(TW: int) -> int:
    """The blocked pair's TL: the reference's ``_lane_tl(TW, 8, 32)``, the
    largest TL in {512, 256, 128} dividing W8 = TW / 64 whose 32-row tiles
    fit its VMEM budget — 256 whenever it divides (1 MiB shards), else
    128. A CUDA thread packs one 8-word group whatever the row count, so
    the reference's row-block grid axis, there only to fit VMEM, has no
    counterpart here; only the TL it implies carries over."""
    for TL in (512, 256, 128):
        fits_vmem = PACK_ROW_BLOCK * 64 * TL * 4 * 4 <= _LANE_VMEM_BUDGET
        if TW % (64 * TL) == 0 and fits_vmem:
            return TL
    raise ValueError(f"word count {TW} is not a multiple of {lane_quantum()}")


def _delta_swap(V: torch.Tensor, dim: int, rounds) -> torch.Tensor:
    w = list(V.unbind(dim))
    for d, mask in rounds:
        for i in range(len(w)):
            if i & d == 0:
                t = ((w[i] >> d) ^ w[i + d]) & mask
                w[i] = w[i] ^ (t << d)
                w[i + d] = w[i + d] ^ t
    return torch.stack(w, dim)


def transpose8(V: torch.Tensor, dim: int) -> torch.Tensor:
    """8x8 bit transpose across the size-8 ``dim`` of int32 words:
    out[i] bit (8b + j) == in[j] bit (8b + i). An involution."""
    return _delta_swap(V, dim, _ROUNDS)


def transpose16(V: torch.Tensor, dim: int) -> torch.Tensor:
    """16x16 bit transpose across the size-16 ``dim`` of int32 words, one
    per 16-bit half h: out[i] bit (16h + j) == in[j] bit (16h + i). The
    d=8 round's exchanged bits stay inside their half. An involution."""
    return _delta_swap(V, dim, _ROUNDS16)


def _check(x: torch.Tensor, ndim: int, TW: int, tl: int) -> None:
    if x.dtype != torch.int32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"expected a contiguous {ndim}-D int32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if tl not in (128, 256, 512) or TW % (64 * tl):
        raise ValueError(f"TL={tl} does not tile {TW} words")


def _launch(fn: str, src: torch.Tensor, out: torch.Tensor, rows: int,
            TW: int, tl_arg: int) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    _build.launch(fn, src, _build.ptr(src), _build.ptr(out), rows, TW, tl_arg)


def pack_words_lanes_plain(words: torch.Tensor, tl: int) -> torch.Tensor:
    """Plain PyTorch K2: (rows, TW) int32 words -> (rows, 8, 8, TW/64)."""
    rows, TW = words.shape
    nc = TW // (64 * tl)
    V = transpose8(words.reshape(rows, nc, 8, 8, tl), 3)  # [j, c, sigma, i, l]
    return V.permute(0, 3, 2, 1, 4).reshape(rows, 8, 8, nc * tl).contiguous()


def unpack_words_lanes_plain(planes: torch.Tensor, tl: int) -> torch.Tensor:
    """Plain PyTorch K3: (rows, 8, 8, W8) planes -> (rows, 64*W8) words."""
    rows, _, _, W8 = planes.shape
    V = planes.reshape(rows, 8, 8, W8 // tl, tl).permute(0, 3, 2, 1, 4)
    return transpose8(V, 3).reshape(rows, 64 * W8).contiguous()


def _pack(words: torch.Tensor, tl: int, counter: str) -> torch.Tensor:
    TW = words.shape[-1]
    _check(words, 2, TW, tl)
    if words.device.type == "cpu":
        return pack_words_lanes_plain(words, tl)
    rows = words.shape[0]
    out = torch.empty((rows, 8, 8, TW // 64), dtype=torch.int32,
                      device=words.device)
    _launch("ec_pack_lanes", words, out, rows, TW, tl.bit_length() - 1)
    LAUNCHES[counter] += 1
    return out


def _unpack(planes: torch.Tensor, tl: int, counter: str) -> torch.Tensor:
    TW = 64 * planes.shape[-1]
    _check(planes, 4, TW, tl)
    if planes.shape[1:3] != (8, 8):
        raise ValueError(f"expected (rows, 8, 8, W8) planes, got "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return unpack_words_lanes_plain(planes, tl)
    rows = planes.shape[0]
    out = torch.empty((rows, TW), dtype=torch.int32, device=planes.device)
    _launch("ec_unpack_lanes", planes, out, rows, TW, tl.bit_length() - 1)
    LAUNCHES[counter] += 1
    return out


def pack_words_lanes(words: torch.Tensor, tl: int) -> torch.Tensor:
    """K2: (rows, TW) int32 words -> (rows, 8, 8, TW/64) tiled planes.
    TW must be a multiple of 64*tl. Inverse: :func:`unpack_words_lanes`
    at the same ``tl``."""
    return _pack(words, tl, "pack_lanes")


def unpack_words_lanes(planes: torch.Tensor, tl: int) -> torch.Tensor:
    """K3: (rows, 8, 8, W8) int32 planes -> (rows, 64*W8) words."""
    return _unpack(planes, tl, "unpack_lanes")


def pack_words_lanes_blocked_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 pack: K2's plain version at :func:`blocked_lane_tl`."""
    return pack_words_lanes_plain(words, blocked_lane_tl(words.shape[-1]))


def unpack_words_lanes_blocked_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 unpack: K3's plain version at the blocked TL."""
    return unpack_words_lanes_plain(
        planes, blocked_lane_tl(64 * planes.shape[-1]))


def pack_words_lanes_blocked(words: torch.Tensor) -> torch.Tensor:
    """K6 pack: (rows, TW) int32 words -> (rows, 8, 8, TW/64) planes at
    the blocked TL, any row count; K2's kernel with its own launch count.
    Inverse: :func:`unpack_words_lanes_blocked`."""
    return _pack(words, blocked_lane_tl(words.shape[-1]), "pack_lanes_blocked")


def unpack_words_lanes_blocked(planes: torch.Tensor) -> torch.Tensor:
    """K6 unpack: (rows, 8, 8, W8) planes at the blocked TL -> (rows,
    64*W8) words; K3's kernel with its own launch count."""
    return _unpack(planes, blocked_lane_tl(64 * planes.shape[-1]),
                   "unpack_lanes_blocked")


# -- the sublane-group pack: K9 (8 planes) and K10 (16 planes) ------------


def tile_lanes(TW: int, group: int = 8) -> int:
    """The sublane kernels' TL: the reference's ``_tile_lanes(TW, 512,
    group)``, min(512, max(128, TW/group)) halved until its ``group``-word
    groups tile TW (not always a power of two: 384 at TW = 3072 for
    group 8, at TW = 6144 for group 16)."""
    TL = min(512, max(128, TW // group))
    while TW % (group * TL):
        TL //= 2
        if TL < 128:
            raise ValueError(
                f"word count {TW} not divisible by {group}*128")
    return TL


_GROUP_TRANSPOSE = {8: transpose8, 16: transpose16}


def _pack_groups_plain(words: torch.Tensor, group: int) -> torch.Tensor:
    rows, TW = words.shape
    TL = tile_lanes(TW, group)
    V = _GROUP_TRANSPOSE[group](
        words.reshape(rows, TW // (group * TL), group, TL), 2)
    return V.permute(0, 2, 1, 3).reshape(rows, group, TW // group).contiguous()


def _unpack_groups_plain(planes: torch.Tensor) -> torch.Tensor:
    rows, group, W = planes.shape
    TL = tile_lanes(group * W, group)
    V = planes.reshape(rows, group, W // TL, TL).permute(0, 2, 1, 3)
    return _GROUP_TRANSPOSE[group](V, 2).reshape(rows, group * W).contiguous()


def pack_words_sublane_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 pack: (rows, TW) int32 -> (rows, 8, TW/8)."""
    return _pack_groups_plain(words, 8)


def unpack_words_sublane_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K9 unpack: (rows, 8, W) int32 -> (rows, 8*W)."""
    return _unpack_groups_plain(planes)


def pack_words16_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10 pack: (rows, TW) int32 -> (rows, 16, TW/16)."""
    return _pack_groups_plain(words, 16)


def unpack_words16_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10 unpack: (rows, 16, W) int32 -> (rows, 16*W)."""
    return _unpack_groups_plain(planes)


def _pack_groups(words: torch.Tensor, group: int, counter: str) -> torch.Tensor:
    if words.dtype != torch.int32 or words.dim() != 2 \
            or not words.is_contiguous():
        raise ValueError(
            f"expected contiguous (rows, TW) int32 words, got {words.dtype} "
            f"{tuple(words.shape)}"
        )
    rows, TW = words.shape
    tl = tile_lanes(TW, group)
    if words.device.type == "cpu":
        return _pack_groups_plain(words, group)
    out = torch.empty((rows, group, TW // group), dtype=torch.int32,
                      device=words.device)
    _launch(f"ec_pack_groups{group}", words, out, rows, TW, tl)
    LAUNCHES[counter] += 1
    return out


def _unpack_groups(planes: torch.Tensor, group: int,
                   counter: str) -> torch.Tensor:
    if planes.dtype != torch.int32 or planes.dim() != 3 \
            or not planes.is_contiguous() or planes.shape[1] != group:
        raise ValueError(
            f"expected contiguous (rows, {group}, W) int32 planes, got "
            f"{planes.dtype} {tuple(planes.shape)}"
        )
    rows, _, W = planes.shape
    tl = tile_lanes(group * W, group)
    if planes.device.type == "cpu":
        return _unpack_groups_plain(planes)
    out = torch.empty((rows, group * W), dtype=torch.int32,
                      device=planes.device)
    _launch(f"ec_unpack_groups{group}", planes, out, rows, group * W, tl)
    LAUNCHES[counter] += 1
    return out


def pack_words_sublane(words: torch.Tensor) -> torch.Tensor:
    """K9 pack: (rows, TW) int32 words -> (rows, 8, TW/8) bit-planes, the
    reference's ``pack_words_pallas``; plane i of row j is row 8j + i of
    the (8*rows, TW/8) plane matrix. TW must be a multiple of 8*128.
    Inverse: :func:`unpack_words_sublane`."""
    return _pack_groups(words, 8, "pack_sublane")


def unpack_words_sublane(planes: torch.Tensor) -> torch.Tensor:
    """K9 unpack: (rows, 8, W) int32 bit-planes -> (rows, 8*W) words."""
    return _unpack_groups(planes, 8, "unpack_sublane")


def pack_words16(words: torch.Tensor) -> torch.Tensor:
    """K10 pack: (rows, TW) int32 interleaved-u16 words -> (rows, 16,
    TW/16) bit-planes; plane i of row j holds bit i of its 32 symbols a
    group. TW must be a multiple of 16*128. Inverse:
    :func:`unpack_words16`."""
    return _pack_groups(words, 16, "pack_words16")


def unpack_words16(planes: torch.Tensor) -> torch.Tensor:
    """K10 unpack: (rows, 16, W) int32 bit-planes -> (rows, 16*W) words."""
    return _unpack_groups(planes, 16, "unpack_words16")


# -- GF(2^16): the byte-sliced layouts ---------------------------------------


def pack_u16_bytesliced(x: np.ndarray, out: np.ndarray = None) -> np.ndarray:
    """HOST: (k, S) uint16 symbols -> (2k, S) uint8 byte rows, row 2j the
    lo bytes of shard j and row 2j+1 its hi bytes. With ``out`` (a (2k,
    >= S) uint8 view, e.g. a staging page) the rows are written into its
    first S columns in the one pass."""
    k, S = x.shape
    src = np.ascontiguousarray(x, dtype="<u2").view(np.uint8).reshape(k, S, 2)
    if out is None:
        out = np.empty((2 * k, S), dtype=np.uint8)
    out[0::2, :S] = src[:, :, 0]
    out[1::2, :S] = src[:, :, 1]
    return out


def unpack_u16_bytesliced(b: np.ndarray) -> np.ndarray:
    """HOST: (2r, S) uint8 byte rows -> (r, S) uint16 symbols
    (:func:`pack_u16_bytesliced` inverse)."""
    r2, S = b.shape
    out = np.empty((r2 // 2, S), dtype="<u2")
    sym = out.view(np.uint8).reshape(r2 // 2, S, 2)
    sym[:, :, 0] = b[0::2]
    sym[:, :, 1] = b[1::2]
    return out


def _byte(w: torch.Tensor, i: int) -> torch.Tensor:
    return (w >> (8 * i)) & 0xFF if i else w & 0xFF


def words16_to_bytesliced(xw: torch.Tensor) -> torch.Tensor:
    """DEVICE: (k, TW) int32 interleaved-u16 words -> (2k, TW/2) int32
    byte-sliced words (row 2j the lo bytes of shard j, 2j+1 the hi
    bytes), by bit ops on the words. TW must be even. Inverse:
    :func:`bytesliced_to_words16`."""
    k, TW = xw.shape
    pairs = xw.reshape(k, TW // 2, 2)
    w0, w1 = pairs[..., 0], pairs[..., 1]
    lo = (_byte(w0, 0) | (_byte(w0, 2) << 8) | (_byte(w1, 0) << 16)
          | (_byte(w1, 2) << 24))
    hi = (_byte(w0, 1) | (_byte(w0, 3) << 8) | (_byte(w1, 1) << 16)
          | (_byte(w1, 3) << 24))
    return torch.stack([lo, hi], dim=1).reshape(2 * k, TW // 2)


def bytesliced_to_words16(bw: torch.Tensor) -> torch.Tensor:
    """DEVICE: (2r, TW8) int32 byte-sliced words -> (r, 2*TW8) int32
    interleaved-u16 words (:func:`words16_to_bytesliced` inverse)."""
    r2, TW8 = bw.shape
    pairs = bw.reshape(r2 // 2, 2, TW8)
    lo, hi = pairs[:, 0, :], pairs[:, 1, :]
    w0 = (_byte(lo, 0) | (_byte(hi, 0) << 8) | (_byte(lo, 1) << 16)
          | (_byte(hi, 1) << 24))
    w1 = (_byte(lo, 2) | (_byte(hi, 2) << 8) | (_byte(lo, 3) << 16)
          | (_byte(hi, 3) << 24))
    return torch.stack([w0, w1], dim=2).reshape(r2 // 2, 2 * TW8)
