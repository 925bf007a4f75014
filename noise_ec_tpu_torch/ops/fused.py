"""K1 and K5: the fused encodes — lane pack, XOR network, unpack in one
launch.

K1 ports ``noise_ec_tpu.ops.pallas_fused._fused_kernel`` (built by
``_build_planned_call("single")`` under ``fused_encode_words_planned``);
K5 ports ``_dma_split_kernel`` (the planner's "dma" candidate). Both are
in ``csrc/fused.cu`` and map ``(k, TW)`` int32 data words to ``(r, TW)``
int32 product words for a GF(2^8) matrix: K1's operand is the matrix's
factored bit network, K5's its bit expansion as mask words. Encode and
reconstruct both run them; only the matrix differs.

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
   keeps every input plane and live temporary of its thread in
   shared-memory slots: the largest block whose slots fit 227 KB with the
   full factoring, else a temp cap that fits while the capped network
   costs at most ``_CAP_COST_RATIO`` of the full one (the reference's
   rule).
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
    BLOCK_SIZES,
    SMEM_BYTES,
    XorProgram,
    compile_network,
    eval_program,
    fits,
)
from noise_ec_tpu_torch.ops.pack import (
    lane_tl,
    pack_words_lanes_plain,
    unpack_words_lanes_plain,
)

LAUNCHES = {"fused_encode": 0, "fused_split": 0}

# A temp cap is accepted only while the refactored network stays within
# this factor of the fully factored XOR cost (pallas_fused._CAP_COST_RATIO).
_CAP_COST_RATIO = 1.25

# K5's block shape (fused_split_plan): phases of SPLIT_KSL input rows, up
# to SPLIT_WC column warps (chip_smoke.py --panel-sweep, PERF.md).
SPLIT_KSL = 4
SPLIT_WC = 2


@functools.lru_cache(maxsize=256)
def fused_plan(bits_rows: tuple, C: int) -> Optional[tuple[int, XorProgram]]:
    """(threads, program) for K1 over C = 8k input planes, or None when no
    block holds the matrix (module doc)."""
    full = compile_network(bits_rows, C)
    for threads in BLOCK_SIZES:
        if fits(full, threads):
            return threads, full
    used = int((full.in_slot >= 0).sum())
    for threads in BLOCK_SIZES:
        # Live values never exceed the used inputs plus the temps.
        cap = SMEM_BYTES // (4 * threads) - used
        if cap < 1:
            continue
        prog = compile_network(bits_rows, C, max_temps=cap)
        if prog.cost <= _CAP_COST_RATIO * full.cost and fits(prog, threads):
            return threads, prog
    return None


@functools.lru_cache(maxsize=256)
def fused_split_plan(bits_rows: tuple, k: int, r: int
                     ) -> Optional[tuple[int, int, MaskTiles]]:
    """(threads, ksl, operand) for K5 over k input and r output byte rows,
    or None when no ring fits shared memory.

    The block has one warp per 32 of the 8r output planes (row groups of
    at most MAX_WARPS warps) and up to SPLIT_WC column warps; the plan
    takes the most column warps whose two ring stages of SPLIT_KSL rows
    fit SMEM_BYTES, halving the phase if not even one does."""
    if len(bits_rows) != 8 * r:
        raise ValueError(f"{len(bits_rows)} network rows for r={r}")
    _, WR = row_groups(8 * r)
    rgr = ROW_BLOCK * WR
    ksl = SPLIT_KSL
    while ksl >= 1:
        for wc in range(min(SPLIT_WC, MAX_WARPS // WR), 0, -1):
            if ring_bytes(8 * ksl, 32 * COLS * wc, rgr) <= SMEM_BYTES:
                tiles = build_tiles(bits_rows, 8 * k, 8 * ksl, WC=wc)
                return tiles.threads, ksl, tiles
        ksl //= 2
    return None


def fused_encode_words_plain(prog: XorProgram, words: torch.Tensor, r: int,
                             tl: int) -> torch.Tensor:
    """Plain PyTorch K1 on (k, TW) or (B, k, TW) words: pack, program,
    unpack — the kernel's arithmetic, with planes in tensors instead of
    registers and slots."""
    if words.dim() == 3:
        return torch.stack(
            [fused_encode_words_plain(prog, w, r, tl) for w in words]
        )
    k, TW = words.shape
    planes = pack_words_lanes_plain(words, tl).reshape(8 * k, 8, TW // 64)
    out = eval_program(prog, planes)
    return unpack_words_lanes_plain(out.reshape(r, 8, 8, TW // 64), tl)


def _check_words(words: torch.Tensor, tl: Optional[int]) -> int:
    """Validate (.., k, TW) words for a fused kernel; returns the lane
    tile."""
    TW = words.shape[-1]
    tl = lane_tl(TW) if tl is None else tl
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or not words.is_contiguous() or TW % (64 * tl)):
        raise ValueError(
            f"expected contiguous int32 (.., k, TW) words with TW a multiple "
            f"of {64 * tl}, got {words.dtype} {tuple(words.shape)}"
        )
    return tl


def _check_device(words: torch.Tensor, operand: torch.Tensor) -> None:
    if words.device.type != "cuda" or operand.device != words.device:
        raise ValueError(
            f"no kernel for words on {words.device} and an operand on "
            f"{operand.device}"
        )


def _check(prog, words: torch.Tensor, r: int, threads: int,
           tl: Optional[int]) -> int:
    """Validate K1's program and words (the program's planes and rows, the
    words' type and layout and, for a kernel launch, their device and the
    block's shared memory); returns the lane tile."""
    k = words.shape[-2]
    if prog.in_slot is None or prog.n_inputs != 8 * k or prog.n_rows != 8 * r:
        raise ValueError(
            f"program ({prog.n_inputs} inputs, {prog.n_rows} rows) does not "
            f"fit k={k}, r={r} on the fused kernel"
        )
    tl = _check_words(words, tl)
    if words.device.type != "cpu":
        _check_device(words, prog.ops)
        if not fits(prog, threads):
            raise ValueError(
                f"{prog.n_slots} slots x {threads} threads exceed shared "
                "memory"
            )
    return tl


def fused_encode_words(prog: XorProgram, words: torch.Tensor, r: int,
                       threads: int, tl: Optional[int] = None) -> torch.Tensor:
    """K1: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words.

    ``prog`` is built with ``inputs_in_slots=True`` over 8k planes into 8r
    rows; TW must be a multiple of 64*tl (``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`; the result does not
    depend on it)."""
    tl = _check(prog, words, r, threads, tl)
    if words.device.type == "cpu":
        return fused_encode_words_plain(prog, words, r, tl)
    batched = words if words.dim() == 3 else words[None]
    B, k, TW = batched.shape
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused", words, _build.ptr(batched), _build.ptr(out), B, k, r, TW,
        tl.bit_length() - 1, _build.ptr(prog.ops), prog.ops.shape[0],
        _build.ptr(prog.row_ptr), _build.ptr(prog.row_terms),
        _build.ptr(prog.in_slot), prog.n_slots, threads,
    )
    LAUNCHES["fused_encode"] += 1
    return out if words.dim() == 3 else out[0]


def fused_split_encode_words_plain(tiles: MaskTiles, words: torch.Tensor,
                                   r: int, tl: int) -> torch.Tensor:
    """Plain PyTorch K5 on (k, TW) or (B, k, TW) words: pack, the masked
    product (:func:`~noise_ec_tpu_torch.ops.gf2tile.masked_product_plain`),
    unpack."""
    if words.dim() == 3:
        return torch.stack(
            [fused_split_encode_words_plain(tiles, w, r, tl) for w in words]
        )
    k, TW = words.shape
    planes = pack_words_lanes_plain(words, tl).reshape(8 * k, 8, TW // 64)
    out = masked_product_plain(tiles, planes)
    return unpack_words_lanes_plain(out.reshape(r, 8, 8, TW // 64), tl)


def fused_split_encode_words(tiles: MaskTiles, words: torch.Tensor, r: int,
                             threads: int, tl: Optional[int] = None,
                             ksplit: Optional[int] = None) -> torch.Tensor:
    """K5: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words.

    ``tiles`` comes from :func:`fused_split_plan` for k input and r output
    rows (``threads`` is its block size); TW must be a multiple of 64*tl,
    and tl a power of two of at least 4 (the kernel copies four
    neighbouring groups as one 16-byte chunk; ``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`, and the result does not
    depend on it). ``ksplit`` splits the phases over that
    many blocks a column tile (default: enough to fill the card's SMs,
    :func:`~noise_ec_tpu_torch.ops.gf2tile.k_split`)."""
    k = words.shape[-2]
    if (tiles.n_inputs != 8 * k or tiles.n_rows != 8 * r or tiles.KT % 8
            or threads != tiles.threads):
        raise ValueError(
            f"operand ({tiles.n_inputs} planes, {tiles.n_rows} rows, tile "
            f"{tiles.KT}, {tiles.threads} threads) does not fit k={k}, r={r} "
            f"at {threads} threads on the split kernel"
        )
    tl = _check_words(words, tl)
    if tl < 4 or tl & (tl - 1):
        raise ValueError(f"the split kernel needs TL a power of two >= 4, "
                         f"got {tl}")
    if words.device.type == "cpu":
        return fused_split_encode_words_plain(tiles, words, r, tl)
    _check_device(words, tiles.masks)
    batched = words if words.dim() == 3 else words[None]
    check_aligned(batched, tiles.masks)
    B, k, TW = batched.shape
    blocks = -(-(TW // 8) // tiles.ncol) * tiles.NRG * B
    if ksplit is None:
        ksplit = k_split(blocks, tiles.NT, words.device)
    if not 1 <= ksplit <= tiles.NT:
        raise ValueError(f"K split {ksplit} not within [1, {tiles.NT}]")
    alloc = torch.zeros if ksplit > 1 else torch.empty
    out = alloc((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused_split", words, _build.ptr(batched), _build.ptr(out),
        _build.ptr(tiles.masks), B, k, r, TW, tl.bit_length() - 1,
        tiles.KT // 8, tiles.NT, tiles.NRG, tiles.WR, tiles.WC, ksplit,
    )
    LAUNCHES["fused_split"] += 1
    return out if words.dim() == 3 else out[0]
