"""K2/K3: the lane pack and unpack between words and tiled bit-planes.

Port of ``noise_ec_tpu.ops.pallas_pack``'s lane kernels
(``_pack_lanes_kernel`` / ``_unpack_lanes_kernel``) at m = 8 and m = 16
bit-planes a symbol, CUDA source ``csrc/pack.cu``. Words ``(rows, TW)``
int32 become planes ``(rows, m, 8, W8)``, W8 = TW / (8m), with the
reference's TL-dependent bijection: plane i of row j holds at
``(sigma, c*TL + l)`` bit i of the symbols in words
``c*8*m*TL + (sigma*m + i')*TL + l``, i' = 0..m-1 (GF(2^8) bytes at
m = 8; at m = 16, interleaved u16 symbols: symbol (word i', half h) at bit
16h + i'). The reference picks TL from its VMEM budget (``_lane_tl``);
here it is a parameter, so a test can pass the reference's choice, and
pack and unpack of one pipeline must be given the same TL.

Words are int32 views of the shard bytes: torch cannot shift uint32 on
the CPU. ``>>`` on int32 is arithmetic, which is exact here because every
right shift of the delta-swap is masked to bits the sign cannot reach.

The row-blocked pair (:func:`pack_words_lanes_blocked`,
:func:`unpack_words_lanes_blocked`) is the reference's wide-geometry
variant (``_pack_lanes_blocked_call`` / ``_unpack_lanes_blocked_call``,
K6): the same kernels, at the TL the reference pins to a 32-row block, so
the panel pipeline's two ends agree whatever the row counts. The m = 16
forms count their launches apart (``*16``).

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
both; its launch is planned here: the lanes a thread moves in one vector
(:func:`groups_vec`), the block and grid (:func:`groups_launch`) and the
multiply that divides by TL (:func:`lane_divider`). Beside them sit the
layout helpers of the byte-sliced GF(2^16) route: the host relayout
between u16 symbols and adjacent lo/hi byte rows, and its device
counterpart on words (plain PyTorch bit ops, as in the reference).

Each kernel has a plain PyTorch version beside it. The wrappers take the
plain version only for a tensor on the CPU; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from noise_ec_tpu_torch.ops import _build

_ROUNDS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))
_ROUNDS16 = _ROUNDS + ((8, 0x00FF00FF),)
LAUNCHES = {"pack_lanes": 0, "unpack_lanes": 0, "pack_lanes_blocked": 0,
            "unpack_lanes_blocked": 0, "pack_sublane": 0,
            "unpack_sublane": 0, "pack_words16": 0, "unpack_words16": 0,
            "pack_lanes16": 0, "unpack_lanes16": 0,
            "pack_lanes_blocked16": 0, "unpack_lanes_blocked16": 0}

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


def lane_tl(TW: int, m: int = 8) -> int:
    """The port's TL rule: the largest TL in {512, 256, 128} that divides
    W8 = TW / (8m). The reference also shrinks TL to fit its VMEM; a CUDA
    thread holds one m-word group whatever TL is, so here TL only fixes
    the bijection (and the run a warp's loads cover)."""
    for TL in (512, 256, 128):
        if TW % (8 * m * TL) == 0:
            return TL
    raise ValueError(
        f"word count {TW} is not a multiple of {lane_quantum(m)}")


def reference_lane_tl(TW: int, m: int, rows: int) -> Optional[int]:
    """The reference's ``_lane_tl(TW, m, rows)`` (a copy of its rule): the
    largest TL in {512, 256, 128} dividing W8 = TW / (8m) whose ``rows``-row
    in and out tiles, double-buffered, fit its VMEM budget; None where the
    reference raises. Its tier 2 runs where this is not None at
    max(k, r) rows (at m = 16: up to 48 rows), its tier 3 elsewhere."""
    for TL in (512, 256, 128):
        fits_vmem = rows * 8 * m * TL * 4 * 4 <= _LANE_VMEM_BUDGET
        if TW % (8 * m * TL) == 0 and fits_vmem:
            return TL
    return None


def blocked_lane_tl(TW: int, m: int = 8) -> int:
    """The blocked pair's TL: the reference's ``_lane_tl(TW, m, 32)`` —
    at m = 8 256 whenever it divides W8 (1 MiB shards), else 128; at
    m = 16 always 128. A CUDA thread packs one m-word group whatever the
    row count, so the reference's row-block grid axis, there only to fit
    VMEM, has no counterpart here; only the TL it implies carries over."""
    tl = reference_lane_tl(TW, m, PACK_ROW_BLOCK)
    if tl is None:
        raise ValueError(
            f"word count {TW} is not a multiple of {lane_quantum(m)}")
    return tl


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


# The group transpose at m = 8 and 16 planes a symbol.
_GROUP_TRANSPOSE = {8: transpose8, 16: transpose16}


def _check(x: torch.Tensor, ndim: int, TW: int, tl: int, m: int) -> None:
    if x.dtype != torch.int32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"expected a contiguous {ndim}-D int32 tensor, got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if m not in _GROUP_TRANSPOSE:
        raise ValueError(f"no lane layout for m={m}")
    if tl not in (128, 256, 512) or TW % (8 * m * tl):
        raise ValueError(f"TL={tl} does not tile {TW} words at m={m}")


def _launch(fn: str, src: torch.Tensor, out: torch.Tensor, rows: int,
            TW: int, tl_arg: int, *extra) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    _build.launch(fn, src, _build.ptr(src), _build.ptr(out), rows, TW, tl_arg,
                  *extra)


def pack_words_lanes_plain(words: torch.Tensor, tl: int,
                           m: int = 8) -> torch.Tensor:
    """Plain PyTorch K2: (rows, TW) int32 words -> (rows, m, 8,
    TW/(8m))."""
    rows, TW = words.shape
    nc = TW // (8 * m * tl)
    # [j, c, sigma, i, l]
    V = _GROUP_TRANSPOSE[m](words.reshape(rows, nc, 8, m, tl), 3)
    return V.permute(0, 3, 2, 1, 4).reshape(rows, m, 8, nc * tl).contiguous()


def unpack_words_lanes_plain(planes: torch.Tensor, tl: int) -> torch.Tensor:
    """Plain PyTorch K3: (rows, m, 8, W8) planes -> (rows, 8*m*W8) words."""
    rows, m, _, W8 = planes.shape
    V = planes.reshape(rows, m, 8, W8 // tl, tl).permute(0, 3, 2, 1, 4)
    return _GROUP_TRANSPOSE[m](V, 3).reshape(rows, 8 * m * W8).contiguous()


def _counter(name: str, m: int) -> str:
    """The launch counter of kernel ``name`` at m planes a symbol (the
    m = 16 forms count apart; ops/fused.py shares this rule)."""
    return name if m == 8 else f"{name}16"


def _pack(words: torch.Tensor, tl: int, m: int, counter: str) -> torch.Tensor:
    TW = words.shape[-1]
    _check(words, 2, TW, tl, m)
    if words.device.type == "cpu":
        return pack_words_lanes_plain(words, tl, m)
    rows = words.shape[0]
    out = torch.empty((rows, m, 8, TW // (8 * m)), dtype=torch.int32,
                      device=words.device)
    _launch("ec_pack_lanes", words, out, rows, TW, tl.bit_length() - 1, m)
    LAUNCHES[_counter(counter, m)] += 1
    return out


def _unpack(planes: torch.Tensor, tl: int, counter: str) -> torch.Tensor:
    if planes.dim() != 4 or planes.shape[2] != 8:
        raise ValueError(f"expected (rows, m, 8, W8) planes, got "
                         f"{tuple(planes.shape)}")
    m = planes.shape[1]
    TW = 8 * m * planes.shape[-1]
    _check(planes, 4, TW, tl, m)
    if planes.device.type == "cpu":
        return unpack_words_lanes_plain(planes, tl)
    rows = planes.shape[0]
    out = torch.empty((rows, TW), dtype=torch.int32, device=planes.device)
    _launch("ec_unpack_lanes", planes, out, rows, TW, tl.bit_length() - 1, m)
    LAUNCHES[_counter(counter, m)] += 1
    return out


def pack_words_lanes(words: torch.Tensor, tl: int,
                     m: int = 8) -> torch.Tensor:
    """K2: (rows, TW) int32 words -> (rows, m, 8, TW/(8m)) tiled planes, m
    = 8 (GF(2^8) bytes) or 16 (interleaved u16 symbols; counted apart, as
    ``pack_lanes16``). TW must be a multiple of 8*m*tl. Inverse:
    :func:`unpack_words_lanes` at the same ``tl``."""
    return _pack(words, tl, m, "pack_lanes")


def unpack_words_lanes(planes: torch.Tensor, tl: int) -> torch.Tensor:
    """K3: (rows, m, 8, W8) int32 planes -> (rows, 8*m*W8) words; m (8 or
    16) is the planes' second axis."""
    return _unpack(planes, tl, "unpack_lanes")


def pack_words_lanes_blocked_plain(words: torch.Tensor,
                                   m: int = 8) -> torch.Tensor:
    """Plain PyTorch K6 pack: K2's plain version at :func:`blocked_lane_tl`."""
    return pack_words_lanes_plain(words, blocked_lane_tl(words.shape[-1], m),
                                  m)


def unpack_words_lanes_blocked_plain(planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 unpack: K3's plain version at the blocked TL."""
    m = planes.shape[1]
    return unpack_words_lanes_plain(
        planes, blocked_lane_tl(8 * m * planes.shape[-1], m))


def pack_words_lanes_blocked(words: torch.Tensor, m: int = 8) -> torch.Tensor:
    """K6 pack: (rows, TW) int32 words -> (rows, m, 8, TW/(8m)) planes at
    the blocked TL, any row count; K2's kernel with its own launch count
    (``pack_lanes_blocked``, ``pack_lanes_blocked16`` at m = 16).
    Inverse: :func:`unpack_words_lanes_blocked`."""
    return _pack(words, blocked_lane_tl(words.shape[-1], m), m,
                 "pack_lanes_blocked")


def unpack_words_lanes_blocked(planes: torch.Tensor) -> torch.Tensor:
    """K6 unpack: (rows, m, 8, W8) planes at the blocked TL -> (rows,
    8*m*W8) words; K3's kernel with its own launch count."""
    if planes.dim() != 4:
        raise ValueError(f"expected (rows, m, 8, W8) planes, got "
                         f"{tuple(planes.shape)}")
    m = planes.shape[1]
    return _unpack(planes, blocked_lane_tl(8 * m * planes.shape[-1], m),
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


# K9/K10's launch menu (csrc/pack.cu groups_kernel): lanes a thread, in one
# 16-, 8- or 4-byte vector, and threads a block, widest first; the words a
# thread may hold (V x N: at N = 16 four lanes are 64 words, 80-86
# registers and a 768-op transpose chain a thread, which read up to 17%
# slower than two lanes on an H100 by `chip_smoke.py --pack-sweep`: the
# unpack at every block size, the pack at 256 threads); the threads an SM
# holds at once (the H100's 2048), which sizes one wave; the grid's y
# limit (rows beyond it take the row-stride loop).
GROUP_VECS = (4, 2, 1)
GROUP_THREADS = (256, 128, 64)
GROUP_WORDS = 32
SM_THREADS = 2048
MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=1024)
def lane_divider(TL: int) -> tuple[int, int]:
    """(magic, shift) with q // TL == (umulhi(q, magic) + q) >> shift for
    every 0 <= q < 2^31: the division K9/K10 do by a multiply (shift =
    ceil(log2 TL), magic = 2^32 (2^shift - TL) // TL + 1 < 2^32)."""
    if not 1 <= TL < 1 << 31:
        raise ValueError(f"no divider for TL={TL}")
    shift = (TL - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - TL)) // TL + 1, shift


@functools.lru_cache(maxsize=1024)
def groups_launch(rows: int, TW: int, group: int, vec: int, sms: int,
                  threads: Optional[int] = None) -> tuple[int, int, int]:
    """(threads, blocks_x, blocks_y) of K9/K10 on (rows, TW) words at
    ``vec`` lanes a thread on a card of ``sms`` SMs. Rows go on y, a row's
    TW / (group * vec) thread items on x. The widest block of
    :data:`GROUP_THREADS` that gives every SM a block is taken (else the
    narrowest), unless ``threads`` is given. The grid is capped at one wave
    (``sms`` x :data:`SM_THREADS` threads): y at min(rows,
    :data:`MAX_GRID_Y`, the wave's blocks), x at the wave's blocks over y;
    the kernel's loops stride past the cap."""
    if min(rows, TW, sms) < 1 or vec not in GROUP_VECS \
            or TW % (group * vec):
        raise ValueError(f"no K9/K10 launch for rows={rows}, TW={TW}, "
                         f"group={group}, V={vec}, sms={sms}")
    items = TW // (group * vec)
    if threads is None:
        threads = next((t for t in GROUP_THREADS
                        if -(-items // t) * rows >= sms), GROUP_THREADS[-1])
    if threads not in GROUP_THREADS:
        raise ValueError(f"no K9/K10 block of {threads} threads")
    wave = sms * (SM_THREADS // threads)
    by = min(rows, MAX_GRID_Y, wave)
    bx = min(-(-items // threads), max(1, wave // by))
    return threads, bx, by


def groups_vec(TL: int, group: int, *tensors: torch.Tensor) -> int:
    """K9/K10's lanes a thread: the largest V of :data:`GROUP_VECS` whose
    V x ``group`` words fit :data:`GROUP_WORDS`, that divides TL, and to
    whose 4V bytes every tensor's start is aligned."""
    return next(V for V in GROUP_VECS if V * group <= GROUP_WORDS
                and TL % V == 0
                and all(t.data_ptr() % (4 * V) == 0 for t in tensors))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _groups(x: torch.Tensor, group: int, pack: bool, counter: str,
            vec: Optional[int] = None,
            threads: Optional[int] = None) -> torch.Tensor:
    """K9/K10: pack (rows, TW) words into (rows, group, TW/group) planes,
    or unpack them back; ``vec`` and ``threads`` override the launch's
    lanes a thread and block (:func:`groups_vec`, :func:`groups_launch`)."""
    ok = x.dim() == 2 if pack else x.dim() == 3 and x.shape[1] == group
    if x.dtype != torch.int32 or not ok or not x.is_contiguous():
        what = "(rows, TW) words" if pack else f"(rows, {group}, W) planes"
        raise ValueError(f"expected contiguous {what} int32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows, TW = x.shape[0], x.shape[1] if pack else group * x.shape[2]
    tl = tile_lanes(TW, group)
    if x.device.type == "cpu":
        return _pack_groups_plain(x, group) if pack \
            else _unpack_groups_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if TW >= 1 << 31 or rows >= 1 << 31:
        raise ValueError(f"K9/K10 index in 32 bits: rows={rows}, TW={TW}")
    shape = (rows, group, TW // group) if pack else (rows, TW)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if rows == 0 or TW == 0:
        return out
    V = groups_vec(tl, group, x, out) if vec is None else vec
    if tl % V or x.data_ptr() % (4 * V) or out.data_ptr() % (4 * V):
        raise ValueError(f"V={V} lanes do not fit TL={tl} or the alignment")
    nthreads, bx, by = groups_launch(rows, TW, group, V,
                                     _sm_count(x.device.index), threads)
    magic, shift = lane_divider(tl)
    _build.launch("ec_groups", x, int(pack), _build.ptr(x), _build.ptr(out),
                  rows, TW, tl, magic, shift, group, V, nthreads, bx, by)
    LAUNCHES[counter] += 1
    return out


def pack_words_sublane(words: torch.Tensor) -> torch.Tensor:
    """K9 pack: (rows, TW) int32 words -> (rows, 8, TW/8) bit-planes, the
    reference's ``pack_words_pallas``; plane i of row j is row 8j + i of
    the (8*rows, TW/8) plane matrix. TW must be a multiple of 8*128.
    Inverse: :func:`unpack_words_sublane`."""
    return _groups(words, 8, True, "pack_sublane")


def unpack_words_sublane(planes: torch.Tensor) -> torch.Tensor:
    """K9 unpack: (rows, 8, W) int32 bit-planes -> (rows, 8*W) words."""
    return _groups(planes, 8, False, "unpack_sublane")


def pack_words16(words: torch.Tensor) -> torch.Tensor:
    """K10 pack: (rows, TW) int32 interleaved-u16 words -> (rows, 16,
    TW/16) bit-planes; plane i of row j holds bit i of its 32 symbols a
    group. TW must be a multiple of 16*128. Inverse:
    :func:`unpack_words16`."""
    return _groups(words, 16, True, "pack_words16")


def unpack_words16(planes: torch.Tensor) -> torch.Tensor:
    """K10 unpack: (rows, 16, W) int32 bit-planes -> (rows, 16*W) words."""
    return _groups(planes, 16, False, "unpack_words16")


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
