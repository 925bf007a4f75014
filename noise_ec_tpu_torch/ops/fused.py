"""K1 and K5: the fused encodes — lane pack, XOR network, unpack in one
launch.

K1 ports ``noise_ec_tpu.ops.pallas_fused._fused_kernel`` (built by
``_build_planned_call("single")`` under ``fused_encode_words_planned``);
K5 ports ``_dma_split_kernel`` (the planner's "dma" candidate). Both are
in ``csrc/fused.cu`` and map ``(k, TW)`` int32 data words to ``(r, TW)``
int32 product words, at m = 8 bit-planes a symbol (GF(2^8) bytes) or
m = 16 (interleaved GF(2^16) symbols, on K2's lane layout at m = 16): K1's
operand is the matrix's factored (mr x mk) bit network, K5's its bit
expansion as mask words. Encode and reconstruct both run them; only the
matrix differs.

A GF(2^16) matrix's operands are the same at m = 16 as over its 2k byte
rows at m = 8 (the byte-sliced entry): plane 16j + b of the interleaved
layout is plane (2j + b//8)*8 + b%8 of the byte rows, and K5's phases
are counted in planes (``SPLIT_KSL`` byte rows' worth, two symbol rows at
m = 16), so one plan serves both entries. ``DeviceCodec`` plans a
GF(2^16) matrix at m = 16, so a phase halved to fit shared memory still
holds whole symbol rows.

The planners here stand where the reference's verified planner probes a
compile: shared-memory fit is the feasibility test. ``DeviceCodec.plan_for``
tries K5 first, then K1, then the pipeline: the reference tries K1 first,
but K5 ran every measured matrix faster on the H100 (PERF.md), and its plan
factors no network.

1. K5 (:func:`fused_split_plan`) runs the matrix's bit expansion as mask
   words on the GF(2) product core (ops/gf2tile.py), in phases of ksl
   input rows that a shared-memory ring stages: the plan is the widest
   block whose ring fits 227 KB. No network is factored.
2. K1 (:func:`fused_plan`, the counterpart of ``single_fused_plan``)
   keeps every input plane and live temporary of its block's column tile
   in shared-memory slots, and runs the network's level schedule
   (ops/network.py :class:`~noise_ec_tpu_torch.ops.network.XorSchedule`)
   with all its warps: the full factoring where its slots fit some tile,
   else a temp cap that fits while the capped network costs at most
   ``_CAP_COST_RATIO`` of the full one (the reference's rule). A call
   takes the widest tile that still fills the card
   (:func:`~noise_ec_tpu_torch.ops.network.pick_tile`).
3. With neither, the matrix runs the K2 -> K4 -> K3 pipeline.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.gf2tile import (
    COLS,
    MAX_WARPS,
    ROW_BLOCK,
    MaskTiles,
    build_tiles,
    check_aligned,
    k_split,
    masked_product_plain,
    ring_bytes,
    row_groups,
)
from noise_ec_tpu_torch.ops.network import (
    SMEM_BYTES,
    TILES,
    XorSchedule,
    block_threads,
    compile_network,
    eval_program,
    plan_schedule,
    schedule_args,
)
from noise_ec_tpu_torch.ops.pack import (
    _counter,
    lane_tl,
    pack_words_lanes_plain,
    unpack_words_lanes_plain,
)

LAUNCHES = {"fused_encode": 0, "fused_split": 0, "fused_encode16": 0,
            "fused_split16": 0}

# A temp cap is accepted only while the refactored network stays within
# this factor of the fully factored XOR cost (pallas_fused._CAP_COST_RATIO).
_CAP_COST_RATIO = 1.25

# K5's block shape (fused_split_plan): phases of SPLIT_KSL GF(2^8) input
# rows (8 * SPLIT_KSL planes), up to SPLIT_WC column warps (chip_smoke.py
# --panel-sweep, PERF.md).
SPLIT_KSL = 4
SPLIT_WC = 2
SPLIT_PLANES = 8 * SPLIT_KSL


@functools.lru_cache(maxsize=256)
def fused_plan(bits_rows: tuple, C: int
               ) -> Optional[tuple[int, XorSchedule]]:
    """(threads, schedule) for K1 over C = m k input planes, or None when
    no block holds the matrix (module doc). Where the full factoring's
    schedule fits no tile, its output rows are summed in chains (one
    partial sum a row); then a temp cap starts where the used inputs and
    the temps would fill the narrowest tile and halves until the schedule
    fits or the capped network costs too much."""
    full = compile_network(bits_rows, C)
    for width in (None, 1):
        sched = plan_schedule(full, row_width=width)
        if sched is not None:
            return block_threads(sched), sched
    used = int((full.in_slot >= 0).sum())
    cap = SMEM_BYTES // (4 * TILES[-1]) - used
    while cap >= 1:
        prog = compile_network(bits_rows, C, max_temps=cap)
        if prog.cost > _CAP_COST_RATIO * full.cost:
            break  # a smaller cap factors less and costs more
        sched = plan_schedule(prog, row_width=1)
        if sched is not None:
            return block_threads(sched), sched
        cap //= 2
    return None


@functools.lru_cache(maxsize=256)
def fused_split_plan(bits_rows: tuple, k: int, r: int, m: int = 8
                     ) -> Optional[tuple[int, int, MaskTiles]]:
    """(threads, ksl, operand) for K5 over k input and r output rows of m
    bit-planes each (byte rows at m = 8, GF(2^16) symbol rows at m = 16),
    or None when no ring fits shared memory.

    The block has one warp per 32 of the m r output planes (row groups of
    at most MAX_WARPS warps) and up to SPLIT_WC column warps; the plan
    takes the most column warps whose two ring stages of ksl = SPLIT_PLANES
    / m rows fit SMEM_BYTES, halving the phase if not even one does. The
    operand depends on the planes only, so a GF(2^16) matrix plans the same
    one at m = 16 as over its byte rows at m = 8 (module doc)."""
    if len(bits_rows) != m * r:
        raise ValueError(f"{len(bits_rows)} network rows for r={r}, m={m}")
    _, WR = row_groups(m * r)
    rgr = ROW_BLOCK * WR
    ksl = SPLIT_PLANES // m
    while ksl >= 1:
        for wc in range(min(SPLIT_WC, MAX_WARPS // WR), 0, -1):
            if ring_bytes(m * ksl, 32 * COLS * wc, rgr) <= SMEM_BYTES:
                tiles = build_tiles(bits_rows, m * k, m * ksl, WC=wc)
                return tiles.threads, ksl, tiles
        ksl //= 2
    return None


def _planes(words: torch.Tensor, tl: int, m: int) -> torch.Tensor:
    """(k, TW) words -> the (m k, 8, TW/(8m)) planes the kernels compute
    on (K2's plain version)."""
    k, TW = words.shape
    return pack_words_lanes_plain(words, tl, m).reshape(m * k, 8,
                                                        TW // (8 * m))


def _words(planes: torch.Tensor, r: int, tl: int, m: int) -> torch.Tensor:
    """(m r, 8, W8) product planes -> (r, 8 m W8) words (K3's plain
    version)."""
    return unpack_words_lanes_plain(planes.reshape(r, m, 8, -1), tl)


def fused_encode_words_plain(sched: XorSchedule, words: torch.Tensor,
                             r: int, tl: int, m: int = 8) -> torch.Tensor:
    """Plain PyTorch K1 on (k, TW) or (B, k, TW) words: pack, the
    schedule's program (:func:`~noise_ec_tpu_torch.ops.network.
    eval_program`), unpack — the kernel's function, with planes in tensors
    instead of registers and slots."""
    if words.dim() == 3:
        return torch.stack(
            [fused_encode_words_plain(sched, w, r, tl, m) for w in words]
        )
    return _words(eval_program(sched.prog, _planes(words, tl, m)), r, tl, m)


def _check_words(words: torch.Tensor, tl: Optional[int], m: int) -> int:
    """Validate (.., k, TW) words for a fused kernel at m planes a symbol;
    returns the lane tile."""
    if m not in (8, 16):
        raise ValueError(f"no fused kernel for m={m}")
    TW = words.shape[-1]
    tl = lane_tl(TW, m) if tl is None else tl
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or not words.is_contiguous() or TW % (8 * m * tl)):
        raise ValueError(
            f"expected contiguous int32 (.., k, TW) words with TW a multiple "
            f"of {8 * m * tl}, got {words.dtype} {tuple(words.shape)}"
        )
    return tl


def _check_device(words: torch.Tensor, operand: torch.Tensor) -> None:
    if words.device.type != "cuda" or operand.device != words.device:
        raise ValueError(
            f"no kernel for words on {words.device} and an operand on "
            f"{operand.device}"
        )


def fused_encode_words(sched: XorSchedule, words: torch.Tensor, r: int,
                       threads: int, tl: Optional[int] = None, m: int = 8,
                       tile: Optional[int] = None) -> torch.Tensor:
    """K1: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words,
    at m = 8 or 16 bit-planes a symbol (counted apart at 16, as
    ``fused_encode16``).

    ``sched`` is the schedule of a program built with
    ``inputs_in_slots=True`` over m k planes into m r rows (``threads`` is
    its plan's block, one of :data:`~noise_ec_tpu_torch.ops.network.
    BLOCKS`); TW must be a multiple of 8*m*tl (``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`; the result does not
    depend on it). ``tile`` (groups of m words a block) defaults to
    :func:`~noise_ec_tpu_torch.ops.network.pick_tile`'s."""
    k = words.shape[-2]
    if (sched.in_slot is None or sched.n_inputs != m * k
            or sched.n_rows != m * r):
        raise ValueError(
            f"schedule ({sched.n_inputs} inputs, {sched.n_rows} rows) does "
            f"not fit k={k}, r={r}, m={m} on the fused kernel"
        )
    tl = _check_words(words, tl, m)
    if words.device.type == "cpu":
        return fused_encode_words_plain(sched, words, r, tl, m)
    _check_device(words, sched.pairs)
    batched = words if words.dim() == 3 else words[None]
    B, k, TW = batched.shape
    tile, net = schedule_args(sched, words, threads, TW // m, B, tile)
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused", words, _build.ptr(batched), _build.ptr(out), B, k, r, TW,
        tl.bit_length() - 1, m, _build.ptr(sched.in_slot), *net,
    )
    LAUNCHES[_counter("fused_encode", m)] += 1
    return out if words.dim() == 3 else out[0]


def fused_split_encode_words_plain(tiles: MaskTiles, words: torch.Tensor,
                                   r: int, tl: int, m: int = 8, *,
                                   in_rows: Optional[torch.Tensor] = None,
                                   out: Optional[torch.Tensor] = None,
                                   out_rows: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch K5 on (k, TW) or (B, k, TW) words: pack, the masked
    product (:func:`~noise_ec_tpu_torch.ops.gf2tile.masked_product_plain`),
    unpack; with the row maps of :func:`fused_split_encode_words`, the
    input rows ``in_rows`` of ``words`` and the output stored at rows
    ``out_rows`` of ``out``."""
    if in_rows is not None:
        words = words.index_select(-2, in_rows)
    if words.dim() == 3:
        prod = torch.stack(
            [fused_split_encode_words_plain(tiles, w, r, tl, m)
             for w in words]
        )
    else:
        prod = _words(masked_product_plain(tiles, _planes(words, tl, m)), r,
                      tl, m)
    if out is None:
        return prod
    rows = (torch.arange(r) if out_rows is None else out_rows).long()
    out.index_copy_(-2, rows.to(out.device), prod)
    return out


def _check_rows(rows: Optional[torch.Tensor], n: int, what: str,
                device: torch.device) -> None:
    if rows is not None and (rows.dtype != torch.int32 or rows.dim() != 1
                             or rows.numel() != n or rows.device != device
                             or not rows.is_contiguous()):
        raise ValueError(
            f"{what} must be {n} contiguous int32 row indices on {device}, "
            f"got {rows.dtype} {tuple(rows.shape)} on {rows.device}"
        )


def _check_mapped(x: torch.Tensor, what: str) -> None:
    """A row-mapped operand: int32 (.., rows, TW) whose rows are TW-word
    runs and whose batches start 16 bytes apart (the ring's copies)."""
    if (x.dtype != torch.int32 or x.dim() not in (2, 3) or x.stride(-1) != 1
            or x.stride(-2) != x.shape[-1]
            or (x.dim() == 3 and x.shape[0] > 1 and x.stride(0) % 4)):
        raise ValueError(
            f"{what}: expected int32 (.., rows, TW) words with TW-word rows "
            f"and 16-byte batch strides, got {x.dtype} {tuple(x.shape)} "
            f"strides {x.stride()}"
        )


def fused_split_encode_words(tiles: MaskTiles, words: torch.Tensor, r: int,
                             threads: int, tl: Optional[int] = None,
                             ksplit: Optional[int] = None,
                             m: int = 8, *,
                             in_rows: Optional[torch.Tensor] = None,
                             out: Optional[torch.Tensor] = None,
                             out_rows: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """K5: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words,
    at m = 8 or 16 bit-planes a symbol (counted apart at 16, as
    ``fused_split16``).

    ``tiles`` comes from :func:`fused_split_plan` for k input and r output
    rows of m planes (``threads`` is its block size; its K tile must hold
    whole rows); TW must be a multiple of 8*m*tl,
    and tl a power of two of at least 4 (the kernel copies four
    neighbouring groups as one 16-byte chunk; ``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`, and the result does not
    depend on it). ``ksplit`` splits the phases over that
    many blocks a column tile (default: enough to fill the card's SMs,
    :func:`~noise_ec_tpu_torch.ops.gf2tile.k_split`).

    Row maps (symbol rows at m = 16): ``in_rows``, k int32 indices on the
    words' device, makes input row j row ``in_rows[j]`` of ``words``, which
    may then hold more rows than k; ``out``, (.., N, TW) words, takes the
    product in place, at its rows ``out_rows`` (r int32 indices; default
    0..r-1), and is returned; no other row of it is written, and with
    ``ksplit`` > 1 only those rows are zeroed first. Either tensor's rows
    must be TW-word runs and its batches 16 bytes apart; the batch strides
    are the tensors' own."""
    k = tiles.n_inputs // m
    if (tiles.n_inputs != m * k or tiles.n_rows != m * r or tiles.KT % m
            or threads != tiles.threads
            or (in_rows is None and words.shape[-2] != k)):
        raise ValueError(
            f"operand ({tiles.n_inputs} planes, {tiles.n_rows} rows, tile "
            f"{tiles.KT}, {tiles.threads} threads) does not fit "
            f"{words.shape[-2]} input rows, r={r}, m={m} at {threads} "
            f"threads on the split kernel"
        )
    mapped = in_rows is not None or out is not None
    if mapped:
        _check_mapped(words, "words")
        if out is not None:
            _check_mapped(out, "out")
            if (out.dim() != words.dim() or out.shape[-1] != words.shape[-1]
                    or out.shape[:-2] != words.shape[:-2]
                    or (out_rows is None and out.shape[-2] < r)):
                raise ValueError(
                    f"out {tuple(out.shape)} does not take {r} rows of "
                    f"words {tuple(words.shape)}")
        elif out_rows is not None:
            raise ValueError("out_rows needs out")
        _check_rows(in_rows, k, "in_rows", words.device)
        _check_rows(out_rows, r, "out_rows", words.device)
    TW = words.shape[-1]
    tl = lane_tl(TW, m) if tl is None else tl
    if not mapped:
        tl = _check_words(words, tl, m)
    elif m not in (8, 16) or TW % (8 * m * tl):
        raise ValueError(f"TW {TW} is not a multiple of {8 * m * tl} at m={m}")
    if tl < 4 or tl & (tl - 1):
        raise ValueError(f"the split kernel needs TL a power of two >= 4, "
                         f"got {tl}")
    if words.device.type == "cpu":
        return fused_split_encode_words_plain(
            tiles, words, r, tl, m, in_rows=in_rows, out=out,
            out_rows=out_rows)
    _check_device(words, tiles.masks)
    batched = words if words.dim() == 3 else words[None]
    B = batched.shape[0]
    blocks = -(-(TW // m) // tiles.ncol) * tiles.NRG * B
    if ksplit is None:
        ksplit = k_split(blocks, tiles.NT, words.device)
    if not 1 <= ksplit <= tiles.NT:
        raise ValueError(f"K split {ksplit} not within [1, {tiles.NT}]")
    if out is None:
        alloc = torch.zeros if ksplit > 1 else torch.empty
        dest = alloc((B, r, TW), dtype=torch.int32, device=words.device)
    else:
        _check_device(out, tiles.masks)
        dest = out if out.dim() == 3 else out[None]
        if ksplit > 1:
            if out_rows is None:
                dest[:, :r].zero_()
            else:
                dest.index_fill_(1, out_rows.long(), 0)
    check_aligned(batched, tiles.masks)
    # The contiguous strides, unless the maps' tensors have their own (a
    # batch of one has none to follow).
    strides = (k * TW, r * TW)
    if mapped and B > 1:
        strides = (batched.stride(0), dest.stride(0))
    _build.launch(
        "ec_fused_split", words, _build.ptr(batched), _build.ptr(dest),
        _build.ptr(tiles.masks), B, k, r, TW, tl.bit_length() - 1, m,
        tiles.KT // m, tiles.NT, tiles.NRG, tiles.WR, tiles.WC, ksplit,
        strides[0], None if in_rows is None else _build.ptr(in_rows),
        strides[1], None if out_rows is None else _build.ptr(out_rows),
    )
    LAUNCHES[_counter("fused_split", m)] += 1
    if out is not None:
        return out
    return dest if words.dim() == 3 else dest[0]
