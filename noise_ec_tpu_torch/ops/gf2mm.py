"""K4: the sparse GF(2) matmul on tiled planes; K11/K12: the dense-mask
GF(2) matmul.

Port of ``noise_ec_tpu.ops.pallas_gf2mm._make_sparse_kernel`` (via
``gf2_matmul_pallas_sparse_rows``), CUDA source ``csrc/gf2mm.cu``. Planes
``(C, 8, W8)`` int32 -> ``(R, 8, W8)``: output plane r is the XOR of the
input planes of row r of the bit matrix, evaluated through the
Paar-factored :class:`~noise_ec_tpu_torch.ops.network.XorProgram`. The
reference bakes the network into each compiled program; here it is an
operand, so one build serves every geometry.

This kernel reads its inputs from device memory and keeps only the
temporaries in shared memory, so a temp cap fits any matrix: it is stage 2
of the K2 -> K4 -> K3 pipeline that carries the matrices the fused kernel
cannot hold (ops/fused.py).

K11 and K12 port ``pallas_gf2mm._kernel`` (``gf2_matmul_pallas``) and
``_tiled_dense_kernel`` (``gf2_matmul_pallas_tiled``): the product with the
mask matrix as an operand, ``out[r, w] = XOR over c of (masks[r, c] &
planes[c, w])``, for callers whose matrix changes on every call, so no
network is planned. Masks are int32 words (the reference's uint32
0xFFFFFFFF select mask is -1; :func:`~noise_ec_tpu_torch.gf.bitmatrix.
expand_generator_masks`), and any word is ANDed as it is. The tiled product
is positionwise over its (8, W8) positions, so both entries run one CUDA
kernel, the tiled one on the contiguous (C, 8 * W8) view, each with its own
launch count. The port takes any W and writes exactly W columns, where the
reference pads to its tile and slices back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.network import (
    BLOCK_SIZES,
    SMEM_BYTES,
    XorProgram,
    compile_network,
    eval_program,
    fits,
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
def sparse_plan(bits_rows: tuple, C: int) -> tuple[int, XorProgram]:
    """(threads, program) for K4: the largest block whose temp slots fit
    the full factoring; else 32 threads and the temp cap that fills 227 KB
    (the program then does more XORs, but every matrix gets a plan)."""
    prog = compile_network(bits_rows, C, inputs_in_slots=False)
    for threads in BLOCK_SIZES:
        if fits(prog, threads):
            return threads, prog
    threads = BLOCK_SIZES[-1]
    cap = SMEM_BYTES // (4 * threads)
    return threads, compile_network(
        bits_rows, C, max_temps=cap, inputs_in_slots=False
    )


def gf2_matmul_sparse_plain(prog: XorProgram,
                            planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4 on (C, 8, W8) or (B, C, 8, W8) planes."""
    if planes.dim() == 4:
        return torch.stack([eval_program(prog, p) for p in planes])
    return eval_program(prog, planes)


def gf2_matmul_sparse(prog: XorProgram, planes: torch.Tensor,
                      threads: int) -> torch.Tensor:
    """K4: (C, 8, W8) or (B, C, 8, W8) int32 planes -> (.., R, 8, W8)
    through ``prog`` (built with ``inputs_in_slots=False``), ``threads``
    threads a block."""
    if prog.in_slot is not None:
        raise ValueError("K4 takes a program whose inputs stay in memory")
    if (planes.dtype != torch.int32 or planes.dim() not in (3, 4)
            or not planes.is_contiguous()
            or planes.shape[-3] != prog.n_inputs):
        raise ValueError(
            f"expected contiguous int32 (.., {prog.n_inputs}, 8, W8) planes, "
            f"got {planes.dtype} {tuple(planes.shape)}"
        )
    if planes.device.type == "cpu":
        return gf2_matmul_sparse_plain(prog, planes)
    if planes.device.type != "cuda" or prog.ops.device != planes.device:
        raise ValueError(
            f"no kernel for planes on {planes.device} and a program on "
            f"{prog.ops.device}"
        )
    if not fits(prog, threads):
        raise ValueError(
            f"{prog.n_slots} slots x {threads} threads exceed shared memory"
        )
    batched = planes if planes.dim() == 4 else planes[None]
    B, C = batched.shape[:2]
    P = batched.shape[2] * batched.shape[3]
    R = prog.n_rows
    out = torch.empty((B, R) + tuple(batched.shape[2:]), dtype=torch.int32,
                      device=planes.device)
    _build.launch(
        "ec_gf2mm", planes, _build.ptr(batched), _build.ptr(out), B, P, C, R,
        _build.ptr(prog.ops), prog.ops.shape[0], _build.ptr(prog.row_ptr),
        _build.ptr(prog.row_terms), prog.n_slots, threads,
    )
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


def _dense(masks: torch.Tensor, planes: torch.Tensor,
           counter: str) -> torch.Tensor:
    """The dense-mask product of K11 and K12 on (C, W) ``planes``."""
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
    masks, planes = masks.contiguous(), planes.contiguous()
    (R, C), W = masks.shape, planes.shape[1]
    out = torch.empty((R, W), dtype=torch.int32, device=planes.device)
    _build.launch("ec_gf2mm_dense", planes, _build.ptr(masks),
                  _build.ptr(planes), _build.ptr(out), R, C, W)
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
