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

Each kernel has a plain PyTorch version beside it. The wrappers take the
plain version only for a tensor on the CPU; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from noise_ec_tpu_torch.ops import _build

_ROUNDS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))
LAUNCHES = {"pack_lanes": 0, "unpack_lanes": 0, "pack_lanes_blocked": 0,
            "unpack_lanes_blocked": 0}

# The reference's row block for the wide-geometry pack, and the VMEM budget
# its TL rule sizes that block's double-buffered in and out tiles against
# (pallas_pack.PACK_ROW_BLOCK, _LANE_VMEM_BUDGET).
PACK_ROW_BLOCK = 32
_LANE_VMEM_BUDGET = 12 << 20


def lane_quantum(m: int = 8) -> int:
    """Pad-to multiple of the lane kernels: 8*m*128 words (TL >= 128)."""
    if m != 8:
        raise NotImplementedError(
            "the port packs GF(2^8) (m=8) only; GF(2^16) is ROADMAP queue 1"
        )
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


def transpose8(V: torch.Tensor, dim: int) -> torch.Tensor:
    """8x8 bit transpose across the size-8 ``dim`` of int32 words:
    out[i] bit (8b + j) == in[j] bit (8b + i). An involution."""
    w = list(V.unbind(dim))
    for d, mask in _ROUNDS:
        for i in range(8):
            if i & d == 0:
                t = ((w[i] >> d) ^ w[i + d]) & mask
                w[i] = w[i] ^ (t << d)
                w[i + d] = w[i + d] ^ t
    return torch.stack(w, dim)


def _check(x: torch.Tensor, ndim: int, TW: int, tl: int) -> None:
    if x.dtype != torch.int32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"expected a contiguous {ndim}-D int32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if tl not in (128, 256, 512) or TW % (64 * tl):
        raise ValueError(f"TL={tl} does not tile {TW} words")


def _launch(fn: str, src: torch.Tensor, out: torch.Tensor, rows: int,
            TW: int, tl: int) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    _build.launch(
        fn, src, _build.ptr(src), _build.ptr(out), rows, TW,
        tl.bit_length() - 1,
    )


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
    _launch("ec_pack_lanes", words, out, rows, TW, tl)
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
    _launch("ec_unpack_lanes", planes, out, rows, TW, tl)
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
