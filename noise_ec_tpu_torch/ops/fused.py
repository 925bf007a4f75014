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
def fused_plan(bits_rows: tuple, C: int) -> Optional[tuple[int, XorProgram]]:
    """(threads, program) for K1 over C = m k input planes, or None when no
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


def fused_encode_words_plain(prog: XorProgram, words: torch.Tensor, r: int,
                             tl: int, m: int = 8) -> torch.Tensor:
    """Plain PyTorch K1 on (k, TW) or (B, k, TW) words: pack, program,
    unpack — the kernel's arithmetic, with planes in tensors instead of
    registers and slots."""
    if words.dim() == 3:
        return torch.stack(
            [fused_encode_words_plain(prog, w, r, tl, m) for w in words]
        )
    return _words(eval_program(prog, _planes(words, tl, m)), r, tl, m)


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


def _check(prog, words: torch.Tensor, r: int, threads: int,
           tl: Optional[int], m: int) -> int:
    """Validate K1's program and words (the program's planes and rows, the
    words' type and layout and, for a kernel launch, their device and the
    block's shared memory); returns the lane tile."""
    k = words.shape[-2]
    if (prog.in_slot is None or prog.n_inputs != m * k
            or prog.n_rows != m * r):
        raise ValueError(
            f"program ({prog.n_inputs} inputs, {prog.n_rows} rows) does not "
            f"fit k={k}, r={r}, m={m} on the fused kernel"
        )
    tl = _check_words(words, tl, m)
    if words.device.type != "cpu":
        _check_device(words, prog.ops)
        if not fits(prog, threads):
            raise ValueError(
                f"{prog.n_slots} slots x {threads} threads exceed shared "
                "memory"
            )
    return tl


def fused_encode_words(prog: XorProgram, words: torch.Tensor, r: int,
                       threads: int, tl: Optional[int] = None,
                       m: int = 8) -> torch.Tensor:
    """K1: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words,
    at m = 8 or 16 bit-planes a symbol (counted apart at 16, as
    ``fused_encode16``).

    ``prog`` is built with ``inputs_in_slots=True`` over m k planes into
    m r rows; TW must be a multiple of 8*m*tl (``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`; the result does not
    depend on it)."""
    tl = _check(prog, words, r, threads, tl, m)
    if words.device.type == "cpu":
        return fused_encode_words_plain(prog, words, r, tl, m)
    batched = words if words.dim() == 3 else words[None]
    B, k, TW = batched.shape
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused", words, _build.ptr(batched), _build.ptr(out), B, k, r, TW,
        tl.bit_length() - 1, m, _build.ptr(prog.ops), prog.ops.shape[0],
        _build.ptr(prog.row_ptr), _build.ptr(prog.row_terms),
        _build.ptr(prog.in_slot), prog.n_slots, threads,
    )
    LAUNCHES[_counter("fused_encode", m)] += 1
    return out if words.dim() == 3 else out[0]


def fused_split_encode_words_plain(tiles: MaskTiles, words: torch.Tensor,
                                   r: int, tl: int,
                                   m: int = 8) -> torch.Tensor:
    """Plain PyTorch K5 on (k, TW) or (B, k, TW) words: pack, the masked
    product (:func:`~noise_ec_tpu_torch.ops.gf2tile.masked_product_plain`),
    unpack."""
    if words.dim() == 3:
        return torch.stack(
            [fused_split_encode_words_plain(tiles, w, r, tl, m)
             for w in words]
        )
    return _words(masked_product_plain(tiles, _planes(words, tl, m)), r, tl,
                  m)


def fused_split_encode_words(tiles: MaskTiles, words: torch.Tensor, r: int,
                             threads: int, tl: Optional[int] = None,
                             ksplit: Optional[int] = None,
                             m: int = 8) -> torch.Tensor:
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
    :func:`~noise_ec_tpu_torch.ops.gf2tile.k_split`)."""
    k = words.shape[-2]
    if (tiles.n_inputs != m * k or tiles.n_rows != m * r or tiles.KT % m
            or threads != tiles.threads):
        raise ValueError(
            f"operand ({tiles.n_inputs} planes, {tiles.n_rows} rows, tile "
            f"{tiles.KT}, {tiles.threads} threads) does not fit k={k}, r={r}, "
            f"m={m} at {threads} threads on the split kernel"
        )
    tl = _check_words(words, tl, m)
    if tl < 4 or tl & (tl - 1):
        raise ValueError(f"the split kernel needs TL a power of two >= 4, "
                         f"got {tl}")
    if words.device.type == "cpu":
        return fused_split_encode_words_plain(tiles, words, r, tl, m)
    _check_device(words, tiles.masks)
    batched = words if words.dim() == 3 else words[None]
    check_aligned(batched, tiles.masks)
    B, k, TW = batched.shape
    blocks = -(-(TW // m) // tiles.ncol) * tiles.NRG * B
    if ksplit is None:
        ksplit = k_split(blocks, tiles.NT, words.device)
    if not 1 <= ksplit <= tiles.NT:
        raise ValueError(f"K split {ksplit} not within [1, {tiles.NT}]")
    alloc = torch.zeros if ksplit > 1 else torch.empty
    out = alloc((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused_split", words, _build.ptr(batched), _build.ptr(out),
        _build.ptr(tiles.masks), B, k, r, TW, tl.bit_length() - 1, m,
        tiles.KT // m, tiles.NT, tiles.NRG, tiles.WR, tiles.WC, ksplit,
    )
    LAUNCHES[_counter("fused_split", m)] += 1
    return out if words.dim() == 3 else out[0]
