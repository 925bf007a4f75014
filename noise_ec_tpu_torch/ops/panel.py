"""K7: the block-panel K-tiled GF(2) matmul for wide geometries.

Port of the reference's panel tier (``noise_ec_tpu.ops.pallas_gf2mm``:
``_make_panel_kernel`` and ``_make_panel_acc_kernel`` under
``gf2_matmul_pallas_panel_rows``), CUDA source ``csrc/panel.cu``. Planes
``(B, C, 8, W8)`` int32 -> ``(B, R, 8, W8)``: output row r is the XOR, over
the K blocks pk of the launch's slice, of panel (r // RB, pk)'s program
applied to input planes [pk*KB, (pk+1)*KB) (ops/network.py
:class:`~noise_ec_tpu_torch.ops.network.PanelProgram`). Given ``acc``, the
launch XORs its sum into ``acc`` in place — the reference's accumulating
sub-launch, whose accumulator XLA donates to the output; here the kernel
reads and writes the same tensor, so a chain of sub-launches allocates
nothing.

Factoring runs per panel, so a network of hundreds of thousands of XORs
plans in seconds, and a panel's live values, not the whole network's,
decide shared memory. The planner here replaces the reference's VMEM model
with the H100's shared memory (:func:`panel_plan`).
"""

from __future__ import annotations

from typing import Optional

import torch

from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.network import (
    BLOCK_SIZES,
    SMEM_BYTES,
    PanelProgram,
    compile_panels,
    eval_panels,
)
from noise_ec_tpu_torch.ops.xor_factor import (
    factor_panels,
    split_bits_rows_panels,
)

LAUNCHES = {"gf2mm_panel": 0, "gf2mm_panel_acc": 0}

# The plan's panel shape: KB input planes by RB output rows, one shape for
# every matrix. Measured on an H100 (chip_smoke.py --panel-sweep, PERF.md)
# on RS(200,56)'s parity and (56,200) recovery matrices at 1 MiB shards,
# 16 x 16 panels ran in 11.4 ms, within 4% of the fastest shape (8 x 16),
# against 18.4 ms at 32 x 32 and 39 ms at the reference's 128 x 32: they
# factor a little worse and re-stage the inputs once per row block, but
# need so few slots that several times as many threads stay resident to
# hide the network's latency. On RS(229,6)'s parity at 64 KiB shards,
# whose grid does not fill the card, 32 x 8 ran 1.2 ms against 1.9.
PANEL_KB = 16
PANEL_RB = 16

# A temp cap below this leaves the per-panel factoring too little room to
# help (the reference's floor, pallas_gf2mm.panel_plan).
MIN_TEMP_CAP = 32

# One SM's shared memory (228 KB), the share the runtime keeps per resident
# block, and the SM's thread limit: what decides how many blocks of a plan
# are resident at once.
_SM_SMEM_BYTES = 233_472
_SMEM_PER_BLOCK_RESERVED = 1024
_SM_THREADS = 2048
_SM_BLOCKS = 32

# The reference's per-sub-launch raw-XOR budget (pallas_gf2mm), kept for
# sublaunch_count: Mosaic caps one compiled program's size.
PANEL_SUBLAUNCH_XOR_BUDGET = 130_000


def sublaunch_count(raw_xors: int, PK: int) -> int:
    """The reference's program-size model: G K-grid sub-launches for a
    panel network of ``raw_xors`` over ``PK`` K blocks (1 = one launch)."""
    G = max(1, -(-raw_xors // PANEL_SUBLAUNCH_XOR_BUDGET))
    return min(G, max(1, PK))


def sublaunch_bounds(PK: int, G: int) -> list[int]:
    """Even contiguous partition of PK K blocks into G chunks:
    ``bounds[g]..bounds[g+1]`` is sub-launch g's K-block slice (sizes
    within one block of each other, none empty for G <= PK)."""
    return [round(g * PK / G) for g in range(G + 1)]


def panel_smem_bytes(KB: int, RB: int, threads: int, temps: int) -> int:
    """Shared memory of one K7 block: per thread, KB input slots, ``temps``
    temporaries and RB row accumulators, 4 bytes each. (A compiled
    program needs at most this: its inputs and temporaries share slots by
    liveness.)"""
    return (KB + RB + temps) * threads * 4


def panel_temp_cap(KB: int, RB: int, threads: int) -> int:
    """The largest temp count whose block still fits ``SMEM_BYTES`` at
    (KB, RB, threads); below MIN_TEMP_CAP the shape is rejected."""
    return SMEM_BYTES // (4 * threads) - KB - RB


def resident_threads(smem_bytes: int, threads: int) -> int:
    """Threads of blocks this size that one SM holds at once."""
    blocks = min(
        _SM_BLOCKS,
        _SM_SMEM_BYTES // (smem_bytes + _SMEM_PER_BLOCK_RESERVED),
        _SM_THREADS // threads,
    )
    return blocks * threads


def panel_plan(bits_rows: tuple, C: int, KB: int = PANEL_KB,
               RB: int = PANEL_RB) -> tuple[int, PanelProgram, int]:
    """(threads, program, G) for K7 over C input planes, with panels of KB
    input planes by RB output rows; the program is compiled on the CPU.

    Each thread keeps its live values in shared memory, and the kernel's
    interpreted network is bound by latency, so what counts is how many
    threads an SM holds. The panels are factored uncapped first
    (:func:`factor_panels`; the same factorings the program is compiled
    from, so this costs nothing twice); the temp cap is the largest
    panel's temp count, or, where a block of 32 threads cannot hold that,
    the cap that fills one (the factoring then stops early). ``threads``
    is, among the block sizes that fit at that cap, the one whose blocks
    leave the most threads resident per SM with the compiled program's
    own slot count, the smaller on a tie (measured 1-2% faster: the last
    wave of blocks is shorter). Raises ValueError when even 32 threads
    leave less than MIN_TEMP_CAP temps.

    G is 1: the reference splits the K axis into sub-launches only
    because Mosaic caps the size of one compiled program
    (:func:`sublaunch_count`), and this kernel takes its network as data,
    so nothing caps it. Callers cache the plan per matrix
    (``DeviceCodec.plan_for``).
    """
    fit = panel_temp_cap(KB, RB, BLOCK_SIZES[-1])
    if fit < MIN_TEMP_CAP:
        raise ValueError(
            f"no panel block fits shared memory for R={len(bits_rows)}, "
            f"C={C} (KB={KB}, RB={RB}: {fit} temps at 32 threads)"
        )
    panels = split_bits_rows_panels(bits_rows, C, KB, RB)
    _, need = factor_panels(panels, KB)
    temp_cap = max(1, min(need, fit))
    prog = compile_panels(bits_rows, C, KB, RB, temp_cap)
    best = None
    for threads in BLOCK_SIZES:
        if panel_smem_bytes(KB, RB, threads, temp_cap) > SMEM_BYTES:
            continue
        smem = (prog.n_slots + RB) * threads * 4
        key = (resident_threads(smem, threads), -threads)
        if best is None or key > best[0]:
            best = (key, threads)
    return best[1], prog, 1


def _check(prog: PanelProgram, planes: torch.Tensor,
           acc: Optional[torch.Tensor], k_slice) -> tuple[int, int]:
    if (planes.dtype != torch.int32 or planes.dim() not in (3, 4)
            or not planes.is_contiguous()
            or planes.shape[-3] != prog.n_inputs
            or planes.shape[-2] != 8):
        raise ValueError(
            f"expected contiguous int32 (.., {prog.n_inputs}, 8, W8) planes, "
            f"got {planes.dtype} {tuple(planes.shape)}"
        )
    want = planes.shape[:-3] + (prog.n_rows,) + planes.shape[-2:]
    if acc is not None and (acc.dtype != torch.int32
                            or tuple(acc.shape) != tuple(want)
                            or not acc.is_contiguous()
                            or acc.device != planes.device):
        raise ValueError(
            f"acc must be a contiguous int32 {tuple(want)} tensor on "
            f"{planes.device}, got {acc.dtype} {tuple(acc.shape)} on "
            f"{acc.device}"
        )
    lo, hi = (0, prog.PK) if k_slice is None else k_slice
    if not 0 <= lo < hi <= prog.PK:
        raise ValueError(f"K-block slice {k_slice} not within [0, {prog.PK}]")
    return lo, hi


def gf2_matmul_panel_plain(prog: PanelProgram, planes: torch.Tensor, *,
                           acc: Optional[torch.Tensor] = None,
                           k_slice: Optional[tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Plain PyTorch K7 on (C, 8, W8) or (B, C, 8, W8) planes; with ``acc``
    the result is XORed into it in place and returned."""
    lo, hi = _check(prog, planes, acc, k_slice)
    if planes.dim() == 3:
        return eval_panels(prog, planes, (lo, hi), acc)
    # The batch rides along as a plane dimension: (C, B, 8, W8).
    acc_t = None if acc is None else acc.transpose(0, 1)
    out = eval_panels(prog, planes.transpose(0, 1), (lo, hi), acc_t)
    return acc if acc is not None else out.transpose(0, 1).contiguous()


def gf2_matmul_panel(prog: PanelProgram, planes: torch.Tensor, threads: int,
                     *, acc: Optional[torch.Tensor] = None,
                     k_slice: Optional[tuple[int, int]] = None
                     ) -> torch.Tensor:
    """K7: (C, 8, W8) or (B, C, 8, W8) int32 planes -> (.., R, 8, W8) over
    the K blocks ``k_slice`` (default all), ``threads`` threads a block.
    With ``acc`` (the previous sub-launch's output) the sum is XORed into
    it in place and ``acc`` is returned."""
    lo, hi = _check(prog, planes, acc, k_slice)
    if planes.device.type == "cpu":
        return gf2_matmul_panel_plain(prog, planes, acc=acc, k_slice=(lo, hi))
    if planes.device.type != "cuda" or prog.ops.device != planes.device:
        raise ValueError(
            f"no kernel for planes on {planes.device} and a program on "
            f"{prog.ops.device}"
        )
    smem = (prog.n_slots + prog.RB) * threads * 4
    if smem > SMEM_BYTES or threads not in BLOCK_SIZES:
        raise ValueError(
            f"{prog.n_slots} slots + {prog.RB} rows x {threads} threads do "
            "not fit one block"
        )
    batched = planes if planes.dim() == 4 else planes[None]
    B, C = batched.shape[:2]
    P = batched.shape[2] * batched.shape[3]
    R = prog.n_rows
    if acc is None:
        out = torch.empty((B, R) + tuple(batched.shape[2:]),
                          dtype=torch.int32, device=planes.device)
    else:
        out = acc if acc.dim() == 4 else acc[None]
    _build.launch(
        "ec_panel", planes, _build.ptr(batched), _build.ptr(out), B, P, C, R,
        prog.KB, prog.RB, prog.PK, lo, hi, int(acc is not None),
        _build.ptr(prog.ops), _build.ptr(prog.op_ptr),
        _build.ptr(prog.row_ptr), _build.ptr(prog.row_terms),
        _build.ptr(prog.in_slot), prog.n_slots, threads,
    )
    LAUNCHES["gf2mm_panel_acc" if acc is not None else "gf2mm_panel"] += 1
    if acc is not None:
        return acc
    return out if planes.dim() == 4 else out[0]


def gf2_matmul_panel_chain(prog: PanelProgram, planes: torch.Tensor,
                           threads: int, G: int) -> torch.Tensor:
    """The whole K axis in G sub-launches (:func:`sublaunch_bounds`): the
    first writes its slice's sum, each later one XORs its own in place —
    the reference's ``gf2_matmul_pallas_panel_rows`` for a plan with G."""
    bounds = sublaunch_bounds(prog.PK, max(1, min(G, prog.PK)))
    out = gf2_matmul_panel(prog, planes, threads, k_slice=tuple(bounds[:2]))
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        gf2_matmul_panel(prog, planes, threads, acc=out, k_slice=(lo, hi))
    return out

