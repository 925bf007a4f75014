"""K1 and K5: the fused encodes — lane pack, XOR network, unpack in one
launch.

K1 ports ``noise_ec_tpu.ops.pallas_fused._fused_kernel`` (built by
``_build_planned_call("single")`` under ``fused_encode_words_planned``);
K5 ports ``_dma_split_kernel`` (the planner's "dma" candidate). Both are
in ``csrc/fused.cu`` and map ``(k, TW)`` int32 data words to ``(r, TW)``
int32 product words for the GF(2^8) matrix whose factored bit network is
their operand. Encode and reconstruct both run them; only the matrix
differs.

The planners here stand where the reference's verified planner probes a
compile: shared-memory fit is the feasibility test, and
``DeviceCodec.plan_for`` tries them in the reference's candidate order.

1. K1 (:func:`fused_plan`, the counterpart of ``single_fused_plan``)
   keeps every input plane and live temporary of its thread in
   shared-memory slots: the largest block whose slots fit 227 KB with the
   full factoring, else a temp cap that fits while the capped network
   costs at most ``_CAP_COST_RATIO`` of the full one (the reference's
   rule).
2. K5 (:func:`fused_split_plan`) cuts the input into P phases of ksl rows
   and holds only one phase's planes and temporaries beside the 8r parity
   accumulators: the largest block at which some ksl fits, and there the
   ksl with the fewest XORs.
3. With neither, the matrix runs the K2 -> K4 -> K3 pipeline.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.network import (
    BLOCK_SIZES,
    SMEM_BYTES,
    SplitProgram,
    XorProgram,
    compile_network,
    compile_split,
    eval_program,
    eval_split,
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
def fused_split_plan(bits_rows: tuple, k: int,
                     r: int) -> Optional[tuple[int, int, SplitProgram]]:
    """(threads, ksl, program) for K5 over k input rows and r output rows,
    or None when no block holds any slicing (module doc).

    ksl runs over the multiples of 8 with P = ceil(k/ksl) >= 2, the
    reference's "dma" candidates, so every plan here has a reference
    counterpart. At each block the scan takes ksl in ascending order and
    stops at the first that does not fit: a phase parks all its used
    planes in slots at once, so the peak grows with ksl."""
    if len(bits_rows) != 8 * r:
        raise ValueError(f"{len(bits_rows)} network rows for r={r}")
    ksls = [ksl for ksl in range(8, -(-k // 8) * 8 + 1, 8)
            if -(-k // ksl) >= 2]
    progs: dict[int, SplitProgram] = {}
    for threads in BLOCK_SIZES:
        fitting = []
        for ksl in ksls:
            if ksl not in progs:
                progs[ksl] = compile_split(bits_rows, k, ksl)
            if not fits(progs[ksl], threads):
                break
            fitting.append(progs[ksl])
        if fitting:
            best = min(fitting, key=lambda prog: prog.cost)
            return threads, best.ksl, best
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


def _check(prog, words: torch.Tensor, r: int, threads: int,
           tl: Optional[int], kernel: str) -> int:
    """Validate a fused kernel's program and words (the program's planes
    and rows, the words' type and layout and, for a kernel launch, their
    device and the block's shared memory); returns the lane tile."""
    k, TW = words.shape[-2:]
    tl = lane_tl(TW) if tl is None else tl
    if prog.in_slot is None or prog.n_inputs != 8 * k or prog.n_rows != 8 * r:
        raise ValueError(
            f"program ({prog.n_inputs} inputs, {prog.n_rows} rows) does not "
            f"fit k={k}, r={r} on the {kernel} kernel"
        )
    if (words.dtype != torch.int32 or words.dim() not in (2, 3)
            or not words.is_contiguous() or TW % (64 * tl)):
        raise ValueError(
            f"expected contiguous int32 (.., k, TW) words with TW a multiple "
            f"of {64 * tl}, got {words.dtype} {tuple(words.shape)}"
        )
    if words.device.type != "cpu":
        if words.device.type != "cuda" or prog.ops.device != words.device:
            raise ValueError(
                f"no kernel for words on {words.device} and a program on "
                f"{prog.ops.device}"
            )
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
    tl = _check(prog, words, r, threads, tl, "fused")
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


def fused_split_encode_words_plain(prog: SplitProgram, words: torch.Tensor,
                                   r: int, tl: int) -> torch.Tensor:
    """Plain PyTorch K5 on (k, TW) or (B, k, TW) words: pack each ksl-row
    slice, evaluate the phases into the accumulators (:func:`eval_split`),
    unpack once."""
    if words.dim() == 3:
        return torch.stack(
            [fused_split_encode_words_plain(prog, w, r, tl) for w in words]
        )
    k, TW = words.shape
    planes = torch.cat([
        pack_words_lanes_plain(words[j:j + prog.ksl], tl)
        for j in range(0, k, prog.ksl)
    ]).reshape(8 * k, 8, TW // 64)
    out = eval_split(prog, planes)
    return unpack_words_lanes_plain(out.reshape(r, 8, 8, TW // 64), tl)


def fused_split_encode_words(prog: SplitProgram, words: torch.Tensor, r: int,
                             threads: int,
                             tl: Optional[int] = None) -> torch.Tensor:
    """K5: (k, TW) or (B, k, TW) int32 words -> (.., r, TW) int32 words.

    ``prog`` comes from :func:`fused_split_plan` for k input and r output
    rows; TW must be a multiple of 64*tl (``tl`` defaults to
    :func:`~noise_ec_tpu_torch.ops.pack.lane_tl`; the result does not
    depend on it)."""
    tl = _check(prog, words, r, threads, tl, "split")
    if words.device.type == "cpu":
        return fused_split_encode_words_plain(prog, words, r, tl)
    batched = words if words.dim() == 3 else words[None]
    B, k, TW = batched.shape
    out = torch.empty((B, r, TW), dtype=torch.int32, device=words.device)
    _build.launch(
        "ec_fused_split", words, _build.ptr(batched), _build.ptr(out), B, k,
        r, TW, tl.bit_length() - 1, prog.ksl, prog.P, _build.ptr(prog.ops),
        _build.ptr(prog.op_ptr), _build.ptr(prog.row_ptr),
        _build.ptr(prog.row_terms), _build.ptr(prog.in_slot), prog.n_slots,
        threads,
    )
    LAUNCHES["fused_split"] += 1
    return out if words.dim() == 3 else out[0]
