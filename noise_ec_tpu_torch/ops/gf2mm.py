"""K4: the sparse GF(2) matmul on tiled planes; K11/K12: the dense-mask
GF(2) matmul.

Port of ``noise_ec_tpu.ops.pallas_gf2mm._make_sparse_kernel`` (via
``gf2_matmul_pallas_sparse_rows``), CUDA source ``csrc/gf2mm.cu``. Planes
``(C, 8, W8)`` int32 -> ``(R, 8, W8)``: output plane r is the XOR of the
input planes of row r of the bit matrix, evaluated through the
Paar-factored :class:`~noise_ec_tpu_torch.ops.network.XorProgram`, run
from its level schedule (:class:`~noise_ec_tpu_torch.ops.network.
XorSchedule`). The reference bakes the network into each compiled
program; here it is an operand, so one build serves every geometry.

The schedule's load ops bring a block's input planes into shared-memory
slots with ``cp.async``, one level before the level that first reads
them, the counterpart of the reference's one read per input plane a grid
step. Where the inputs would not fit beside the temporaries, each load
comes again before every level that reads the plane (``reload``), and a
temp cap fits any matrix: K4 is stage 2 of the K2 -> K4 -> K3 pipeline
that carries the matrices the fused kernels cannot hold (ops/fused.py).

K11 and K12 port ``pallas_gf2mm._kernel`` (``gf2_matmul_pallas``) and
``_tiled_dense_kernel`` (``gf2_matmul_pallas_tiled``): the product with the
mask matrix as an operand, ``out[r, w] = XOR over c of (masks[r, c] &
planes[c, w])``, for callers whose matrix changes on every call, so no
network is planned. Masks are int32 words (the reference's uint32
0xFFFFFFFF select mask is -1; :func:`~noise_ec_tpu_torch.gf.bitmatrix.
expand_generator_masks`), and any word is ANDed as it is. Both run on the
GF(2) product core that K5 and K7 run (``csrc/dense.cu`` on
``csrc/gf2tile.cuh``), which stages the caller's (R, C) masks itself, so a
call relays nothing out; the block shape and K split come from
:func:`~noise_ec_tpu_torch.ops.gf2tile.dense_shape`. The tiled product is
positionwise over its (8, W8) positions, so K12 is K11 on the contiguous
(C, 8 * W8) view, with its own launch count. The port takes any W, plane
offset and mask stride, and writes exactly W columns, where the reference
pads to its tile and slices back.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.gf2tile import dense_shape
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

LAUNCHES = {"gf2mm_sparse": 0,
            "gf2mm_dense": 0, "gf2mm_dense_tiled": 0}


def bits_to_rows(bits) -> tuple[tuple[int, ...], ...]:
    """(R, C) 0/1 matrix -> hashable per-output-row term tuples."""
    bits = np.asarray(bits)
    return tuple(
        tuple(int(c) for c in np.nonzero(bits[r])[0]) for r in range(bits.shape[0])
    )


@functools.lru_cache(maxsize=256)
def sparse_plan(bits_rows: tuple, C: int) -> tuple[int, XorSchedule]:
    """(threads, schedule) for K4: the full factoring with its inputs
    loaded once where its slots fit some tile, else loaded before every
    level that reads them (``reload``), else with its output rows summed
    in chains too; else the temp cap that fills the narrowest tile,
    halved until the schedule fits (the program then does more XORs, but
    every matrix gets a plan)."""
    prog = compile_network(bits_rows, C, inputs_in_slots=False)
    for reload, width in ((False, None), (True, None), (True, 1)):
        sched = plan_schedule(prog, reload, width)
        if sched is not None:
            return block_threads(sched), sched
    cap = SMEM_BYTES // (4 * TILES[-1])
    while True:
        prog = compile_network(bits_rows, C, max_temps=cap,
                               inputs_in_slots=False)
        sched = plan_schedule(prog, True, 1)
        if sched is not None:
            return block_threads(sched), sched
        if cap == 0:
            raise ValueError(f"no K4 schedule of {len(bits_rows)} rows over "
                             f"{C} planes fits shared memory")
        cap //= 2


def gf2_matmul_sparse_plain(sched: XorSchedule,
                            planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4 on (C, 8, W8) or (B, C, 8, W8) planes: the
    schedule's program (:func:`~noise_ec_tpu_torch.ops.network.
    eval_program`)."""
    if planes.dim() == 4:
        return torch.stack([eval_program(sched.prog, p) for p in planes])
    return eval_program(sched.prog, planes)


def gf2_matmul_sparse(sched: XorSchedule, planes: torch.Tensor,
                      threads: int, tile: Optional[int] = None
                      ) -> torch.Tensor:
    """K4: (C, 8, W8) or (B, C, 8, W8) int32 planes -> (.., R, 8, W8)
    through ``sched`` (the schedule of a program built with
    ``inputs_in_slots=False``; ``threads`` is its plan's block, one of
    :data:`~noise_ec_tpu_torch.ops.network.BLOCKS`). ``tile`` (plane
    words a block) defaults to
    :func:`~noise_ec_tpu_torch.ops.network.pick_tile`'s."""
    if sched.in_slot is not None:
        raise ValueError("K4 takes a program whose inputs stay in memory")
    if (planes.dtype != torch.int32 or planes.dim() not in (3, 4)
            or not planes.is_contiguous()
            or planes.shape[-3] != sched.n_inputs):
        raise ValueError(
            f"expected contiguous int32 (.., {sched.n_inputs}, 8, W8) "
            f"planes, got {planes.dtype} {tuple(planes.shape)}"
        )
    if planes.device.type == "cpu":
        return gf2_matmul_sparse_plain(sched, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for planes on {planes.device}")
    batched = planes if planes.dim() == 4 else planes[None]
    if batched.data_ptr() % 16:
        raise ValueError("K4's loads copy 16 bytes: planes must be 16-byte "
                         "aligned")
    B, C = batched.shape[:2]
    P = batched.shape[2] * batched.shape[3]
    R = sched.n_rows
    tile, net = schedule_args(sched, planes, threads, P, B, tile)
    out = torch.empty((B, R) + tuple(batched.shape[2:]), dtype=torch.int32,
                      device=planes.device)
    _build.launch("ec_gf2mm", planes, _build.ptr(batched), _build.ptr(out),
                  B, P, C, R, *net)
    LAUNCHES["gf2mm_sparse"] += 1
    return out if planes.dim() == 4 else out[0]


def planes_to_tiled(planes: torch.Tensor) -> torch.Tensor:
    """(C, W) planes -> (C, 8, ceil(W/8)) tiled layout: a row-major reshape
    after zero-padding W to a multiple of 8 (the reference's
    ``planes_to_tiled``). Inverse: :func:`tiled_to_planes`."""
    C, W = planes.shape
    if W % 8:
        planes = torch.nn.functional.pad(planes, (0, 8 - W % 8))
    return planes.reshape(C, 8, -1)


def tiled_to_planes(tiled: torch.Tensor, num_words: int) -> torch.Tensor:
    """(C, 8, W8) tiled planes -> (C, num_words) planes."""
    return tiled.reshape(tiled.shape[0], -1)[:, :num_words]


def gf2_matmul_dense_plain(masks: torch.Tensor,
                           planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11: (R, C) int32 masks x (C, W) int32 planes -> (R, W)."""
    out = torch.zeros((masks.shape[0], planes.shape[1]), dtype=torch.int32,
                      device=planes.device)
    for c in range(planes.shape[0]):
        out ^= masks[:, c, None] & planes[c]
    return out


def gf2_matmul_dense_tiled_plain(masks: torch.Tensor,
                                 tiled: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K12: (R, C) masks x (C, 8, W8) tiled -> (R, 8, W8)."""
    C = tiled.shape[0]
    out = gf2_matmul_dense_plain(masks, tiled.reshape(C, -1))
    return out.reshape((masks.shape[0],) + tuple(tiled.shape[1:]))


def dense_copy_words(planes: torch.Tensor) -> int:
    """Words a K11 plane copy moves: 4 (16 bytes) where every plane row
    starts 16-byte aligned and holds whole 16-byte chunks, else 1."""
    W, ld = planes.shape[1], planes.stride(0)
    aligned = planes.data_ptr() % 16 == 0
    return 4 if W % 4 == 0 and ld % 4 == 0 and aligned else 1


def _dense(masks: torch.Tensor, planes: torch.Tensor, counter: str,
           shape: Optional[tuple[int, int, int, int, int]] = None
           ) -> torch.Tensor:
    """The dense-mask product of K11 and K12 on (C, W) ``planes``, at the
    (KT, WR, WC, WK, ksplit) ``shape`` (default
    :func:`~noise_ec_tpu_torch.ops.gf2tile.dense_shape`'s)."""
    if (masks.dtype != torch.int32 or planes.dtype != torch.int32
            or masks.dim() != 2 or planes.dim() != 2
            or masks.shape[1] != planes.shape[0]):
        raise ValueError(
            f"expected int32 (R, C) masks and (C, W) planes, got "
            f"{masks.dtype} {tuple(masks.shape)} and {planes.dtype} "
            f"{tuple(planes.shape)}"
        )
    if masks.device != planes.device:
        raise ValueError(
            f"masks on {masks.device}, planes on {planes.device}")
    if planes.device.type == "cpu":
        return gf2_matmul_dense_plain(masks, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"no kernel for device {planes.device}")
    # The kernel reads rows at any stride; only a strided row is copied.
    if masks.stride(1) != 1:
        masks = masks.contiguous()
    if planes.stride(1) != 1:
        planes = planes.contiguous()
    (R, C), W = masks.shape, planes.shape[1]
    if R == 0 or W == 0 or C == 0:
        return torch.zeros((R, W), dtype=torch.int32, device=planes.device)
    if shape is None:
        sms = torch.cuda.get_device_properties(
            planes.device).multi_processor_count
        shape = dense_shape(R, C, W, sms)
    KT, WR, WC, WK, ksplit = shape
    alloc = torch.zeros if ksplit > 1 else torch.empty
    out = alloc((R, W), dtype=torch.int32, device=planes.device)
    _build.launch("ec_gf2mm_dense", planes, _build.ptr(masks),
                  _build.ptr(planes), _build.ptr(out), R, C, W,
                  masks.stride(0), planes.stride(0), KT, WR, WC, WK, ksplit,
                  dense_copy_words(planes))
    LAUNCHES[counter] += 1
    return out


def gf2_matmul_dense(masks: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """K11: (R, C) int32 masks x (C, W) int32 planes -> (R, W), any W: the
    reference's ``gf2_matmul_pallas``."""
    return _dense(masks, planes, "gf2mm_dense")


def gf2_matmul_dense_tiled(masks: torch.Tensor,
                           tiled: torch.Tensor) -> torch.Tensor:
    """K12: (R, C) int32 masks x (C, 8, W8) int32 tiled planes -> (R, 8,
    W8), any W8: the reference's ``gf2_matmul_pallas_tiled``."""
    if tiled.dim() != 3 or tiled.shape[1] != 8:
        raise ValueError(f"expected (C, 8, W8) tiled planes, got "
                         f"{tuple(tiled.shape)}")
    out = _dense(masks, tiled.reshape(tiled.shape[0], -1), "gf2mm_dense_tiled")
    return out.reshape((masks.shape[0],) + tuple(tiled.shape[1:]))
