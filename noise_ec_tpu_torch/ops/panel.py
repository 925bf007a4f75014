"""K7: the block-panel K-tiled GF(2) matmul for wide geometries.

Port of the reference's panel tier (``noise_ec_tpu.ops.pallas_gf2mm``:
``_make_panel_kernel`` and ``_make_panel_acc_kernel`` under
``gf2_matmul_pallas_panel_rows``), CUDA source ``csrc/panel.cu``. Planes
``(B, C, 8, W8)`` int32 -> ``(B, R, 8, W8)``: output row r is the XOR, over
the input planes of the launch's K tiles, of bit (r, c) of the matrix times
plane c. Given ``acc``, the launch XORs its sum into ``acc`` in place — the
reference's accumulating sub-launch, whose accumulator XLA donates to the
output; here the kernel reads and writes the same tensor, so a chain of
sub-launches allocates nothing.

The operand is the matrix's bit expansion as mask words on the GF(2)
product core (:class:`~noise_ec_tpu_torch.ops.gf2tile.MaskTiles`): the
reference's panel (KB input planes by RB output rows) becomes the core's
K tile and a block's row group. No network is factored, so a new matrix
plans in milliseconds.
"""

from __future__ import annotations

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
from noise_ec_tpu_torch.ops.network import SMEM_BYTES

LAUNCHES = {"gf2mm_panel": 0, "gf2mm_panel_acc": 0}

# The plan's block shape: K tiles of PANEL_KB planes, up to PANEL_WC column
# warps, and one row group of all R rows where MAX_WARPS warps hold them
# (chip_smoke.py --panel-sweep, PERF.md).
PANEL_KB = 32
PANEL_WC = 2

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


def panel_plan(bits_rows: tuple, C: int) -> tuple[int, MaskTiles, int]:
    """(threads, operand, G) for K7 over C input planes, with K tiles of
    PANEL_KB planes and the fewest row groups of at most MAX_WARPS warps,
    built on the CPU.

    The block takes the most column warps, up to PANEL_WC, whose two ring
    stages fit SMEM_BYTES; raises ValueError when not even one does. G is
    1: the reference splits the K axis into sub-launches only because
    Mosaic caps the size of one compiled program (:func:`sublaunch_count`),
    and this kernel takes its matrix as data, so nothing caps it. Callers
    cache the plan per matrix (``DeviceCodec.plan_for``)."""
    _, WR = row_groups(len(bits_rows))
    rgr = ROW_BLOCK * WR
    for wc in range(min(PANEL_WC, MAX_WARPS // WR), 0, -1):
        if ring_bytes(PANEL_KB, 32 * COLS * wc, rgr) <= SMEM_BYTES:
            tiles = build_tiles(bits_rows, C, PANEL_KB, WC=wc)
            return tiles.threads, tiles, 1
    raise ValueError(
        f"no panel block fits shared memory for R={len(bits_rows)}, C={C} "
        f"({WR} row warps: {ring_bytes(PANEL_KB, 32 * COLS, rgr)} bytes at "
        f"one column warp)"
    )


def _check(tiles: MaskTiles, planes: torch.Tensor,
           acc: Optional[torch.Tensor], k_slice) -> tuple[int, int]:
    if (planes.dtype != torch.int32 or planes.dim() not in (3, 4)
            or not planes.is_contiguous()
            or planes.shape[-3] != tiles.n_inputs
            or planes.shape[-2] != 8):
        raise ValueError(
            f"expected contiguous int32 (.., {tiles.n_inputs}, 8, W8) planes, "
            f"got {planes.dtype} {tuple(planes.shape)}"
        )
    want = planes.shape[:-3] + (tiles.n_rows,) + planes.shape[-2:]
    if acc is not None and (acc.dtype != torch.int32
                            or tuple(acc.shape) != tuple(want)
                            or not acc.is_contiguous()
                            or acc.device != planes.device):
        raise ValueError(
            f"acc must be a contiguous int32 {tuple(want)} tensor on "
            f"{planes.device}, got {acc.dtype} {tuple(acc.shape)} on "
            f"{acc.device}"
        )
    lo, hi = (0, tiles.NT) if k_slice is None else k_slice
    if not 0 <= lo < hi <= tiles.NT:
        raise ValueError(f"K-block slice {k_slice} not within [0, {tiles.NT}]")
    return lo, hi


def gf2_matmul_panel_plain(tiles: MaskTiles, planes: torch.Tensor, *,
                           acc: Optional[torch.Tensor] = None,
                           k_slice: Optional[tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Plain PyTorch K7 on (C, 8, W8) or (B, C, 8, W8) planes: the masked
    product (:func:`~noise_ec_tpu_torch.ops.gf2tile.masked_product_plain`);
    with ``acc`` the result is XORed into it in place and returned."""
    lo, hi = _check(tiles, planes, acc, k_slice)
    if planes.dim() == 3:
        return masked_product_plain(tiles, planes, (lo, hi), acc)
    # The batch rides along as a plane dimension: (C, B, 8, W8).
    acc_t = None if acc is None else acc.transpose(0, 1)
    out = masked_product_plain(tiles, planes.transpose(0, 1), (lo, hi), acc_t)
    return acc if acc is not None else out.transpose(0, 1).contiguous()


def gf2_matmul_panel(tiles: MaskTiles, planes: torch.Tensor, threads: int,
                     *, acc: Optional[torch.Tensor] = None,
                     k_slice: Optional[tuple[int, int]] = None,
                     ksplit: Optional[int] = None) -> torch.Tensor:
    """K7: (C, 8, W8) or (B, C, 8, W8) int32 planes -> (.., R, 8, W8) over
    the K tiles ``k_slice`` (default all); ``threads`` is the plan's block
    size. With ``acc`` (the previous sub-launch's output) the sum is XORed
    into it in place and ``acc`` is returned. ``ksplit`` splits the K tiles
    over that many blocks a column tile (default: enough to fill the
    card's SMs, :func:`~noise_ec_tpu_torch.ops.gf2tile.k_split`)."""
    lo, hi = _check(tiles, planes, acc, k_slice)
    if threads != tiles.threads:
        raise ValueError(
            f"operand runs {tiles.threads} threads, not {threads}")
    if planes.device.type == "cpu":
        return gf2_matmul_panel_plain(tiles, planes, acc=acc, k_slice=(lo, hi))
    if planes.device.type != "cuda" or tiles.masks.device != planes.device:
        raise ValueError(
            f"no kernel for planes on {planes.device} and an operand on "
            f"{tiles.masks.device}"
        )
    batched = planes if planes.dim() == 4 else planes[None]
    B, C = batched.shape[:2]
    P = batched.shape[2] * batched.shape[3]
    R = tiles.n_rows
    if ksplit is None:
        blocks = -(-P // tiles.ncol) * tiles.NRG * B
        ksplit = k_split(blocks, hi - lo, planes.device)
    if not 1 <= ksplit <= hi - lo:
        raise ValueError(f"K split {ksplit} not within [1, {hi - lo}]")
    if acc is None:
        alloc = torch.zeros if ksplit > 1 else torch.empty
        out = alloc((B, R) + tuple(batched.shape[2:]), dtype=torch.int32,
                    device=planes.device)
    else:
        out = acc if acc.dim() == 4 else acc[None]
    check_aligned(batched, out, tiles.masks)
    _build.launch(
        "ec_panel", planes, _build.ptr(batched), _build.ptr(out),
        _build.ptr(tiles.masks), B, P, C, R, tiles.KT, tiles.NT, tiles.NRG,
        tiles.WR, tiles.WC, lo, hi, ksplit, int(acc is not None),
    )
    LAUNCHES["gf2mm_panel_acc" if acc is not None else "gf2mm_panel"] += 1
    if acc is not None:
        return acc
    return out if planes.dim() == 4 else out[0]


def gf2_matmul_panel_chain(tiles: MaskTiles, planes: torch.Tensor,
                           threads: int, G: int) -> torch.Tensor:
    """The whole K axis in G sub-launches (:func:`sublaunch_bounds`): the
    first writes its slice's sum, each later one XORs its own in place —
    the reference's ``gf2_matmul_pallas_panel_rows`` for a plan with G."""
    bounds = sublaunch_bounds(tiles.NT, max(1, min(G, tiles.NT)))
    out = gf2_matmul_panel(tiles, planes, threads, k_slice=tuple(bounds[:2]))
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        gf2_matmul_panel(tiles, planes, threads, acc=out, k_slice=(lo, hi))
    return out
