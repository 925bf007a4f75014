"""The Paar-factored XOR network as a kernel operand.

The JAX package bakes each matrix's factored network into a compiled
Pallas program (``eval_bits_rows`` at trace time). The port's kernels are
compiled once for every geometry instead, and take the network as data: an
:class:`XorProgram` of int32 tensors, built here from the same ``bits_rows``
tuples (``DeviceCodec.bits_rows_for``), cached per matrix and uploaded to
the card once. This is the state that a matrix carries into the kernels.

Values live in per-thread *slots* (the kernels keep them in shared memory,
laid out ``[slot][thread]``). A slot is freed after the last use of the
value it holds and handed to the next temporary, so ``n_slots`` is the peak
number of live values, not ``C + len(ops)``: shared memory per thread is
``4 * n_slots`` bytes, and that decides the block size (ops/fused.py).

Operand codes: ``code >= 0`` is a slot; ``code < 0`` is input plane
``-1 - code``, read straight from the input tensor. A program built with
``inputs_in_slots=True`` (the fused kernel, which packs its inputs into
slots first) has no negative codes and maps input plane c to slot
``in_slot[c]`` (-1 for a plane no term reads). One built with
``inputs_in_slots=False`` (the standalone sparse matmul) keeps every input
in device memory, so only temporaries take slots and a temp cap bounds
shared memory whatever the input width.

A wide network can also be cut into panels (:func:`compile_panels`):
each (row block, K block) panel factored and slotted on its own, the
reference's per-panel factoring, whose XOR counts ``chip_smoke.py``'s
bounds read; and into K slices (:func:`compile_split`), one slotted
program per slice of ksl input rows, the reference's "dma" factoring. The
kernels of those two tiers, K7 and K5, take the matrix's bit expansion
instead (ops/gf2tile.py).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import torch

from noise_ec_tpu_torch.ops.xor_factor import (
    factored_cost,
    paar_factor_capped,
    panel_raw_costs,
    split_bits_rows_ksl,
    split_bits_rows_panels,
)

# paar_factor's own "no cap" default.
NO_CAP = 100_000

# Dynamic shared memory one block may use on the H100 (227 KB of the SM's
# 228 KB): the budget for n_slots * threads * 4 bytes of slots.
SMEM_BYTES = 232_448
BLOCK_SIZES = (256, 128, 64, 32)


def _i32(x, shape=None) -> torch.Tensor:
    t = torch.tensor(x, dtype=torch.int32)
    return t.reshape(shape) if shape is not None else t


def fits(prog: "XorProgram | SplitProgram", threads: int) -> bool:
    """True when ``prog``'s slots for ``threads`` threads fit one block:
    an :class:`XorProgram`'s, or a :class:`SplitProgram`'s accumulators
    and the one phase region every phase reuses."""
    return prog.n_slots * threads * 4 <= SMEM_BYTES


@dataclass(frozen=True)
class XorProgram:
    """A factored GF(2) XOR network over ``n_inputs`` planes (module doc)."""

    ops: torch.Tensor  # (n_ops, 3) int32: dst slot, operand a, operand b
    row_ptr: torch.Tensor  # (R + 1,) int32 CSR offsets of the output rows
    row_terms: torch.Tensor  # (nnz,) int32 operand codes
    in_slot: Optional[torch.Tensor]  # (n_inputs,) int32, or None
    n_inputs: int
    n_slots: int
    cost: int  # two-input XORs: len(ops) + sum(max(len(row) - 1, 0))

    @property
    def n_rows(self) -> int:
        return self.row_ptr.numel() - 1

    def to(self, device) -> "XorProgram":
        """The same program with its tensors on ``device``."""

        def move(t):
            return None if t is None else t.to(device)

        return XorProgram(
            move(self.ops), move(self.row_ptr), move(self.row_terms),
            move(self.in_slot), self.n_inputs, self.n_slots, self.cost,
        )


def compile_network(bits_rows: tuple, C: int, max_temps: int = NO_CAP,
                    inputs_in_slots: bool = True) -> XorProgram:
    """Factor ``bits_rows`` over C input planes and allocate slots by
    liveness (module doc). The program lives on the CPU; ``.to(device)``
    uploads it."""
    ops, rows = paar_factor_capped(bits_rows, C, max_temps)
    end = len(ops)
    last: dict[int, int] = {}
    for i, (_, a, b) in enumerate(ops):
        last[a] = i
        last[b] = i
    for row in rows:
        for v in row:
            last[v] = end
    free: list[int] = []
    n_slots = 0
    slot: dict[int, int] = {}

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return heapq.heappop(free)
        n_slots += 1
        return n_slots - 1

    in_slot = None
    if inputs_in_slots:
        in_slot = [-1] * C
        for c in range(C):
            if c in last:
                slot[c] = in_slot[c] = alloc()

    def code(v: int) -> int:
        return slot[v] if v in slot else -1 - v

    prog_ops = []
    for i, (t, a, b) in enumerate(ops):
        ca, cb = code(a), code(b)
        for v in (a, b):
            if last[v] == i and v in slot:
                heapq.heappush(free, slot.pop(v))
        slot[t] = alloc()
        prog_ops.append((slot[t], ca, cb))
        if t not in last:  # never read again: its slot is free at once
            heapq.heappush(free, slot.pop(t))
    row_ptr = [0]
    terms: list[int] = []
    for row in rows:
        terms.extend(code(v) for v in row)
        row_ptr.append(len(terms))

    return XorProgram(
        ops=_i32(prog_ops, (len(prog_ops), 3)),
        row_ptr=_i32(row_ptr),
        row_terms=_i32(terms),
        in_slot=None if in_slot is None else _i32(in_slot),
        n_inputs=C,
        n_slots=n_slots,
        cost=factored_cost(ops, rows),
    )


def eval_program(prog: XorProgram, planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch evaluation of ``prog`` over ``planes`` (C, ...) ->
    (R, ...): the arithmetic the kernels run, slot for slot, on any
    device. Used by the plain versions of the fused and sparse kernels."""
    if planes.shape[0] != prog.n_inputs:
        raise ValueError(
            f"program takes {prog.n_inputs} planes, got {planes.shape[0]}"
        )
    shape = planes.shape[1:]
    slots = planes.new_zeros((prog.n_slots,) + shape)
    if prog.in_slot is not None:
        for c, s in enumerate(prog.in_slot.tolist()):
            if s >= 0:
                slots[s] = planes[c]

    def val(code: int) -> torch.Tensor:
        return slots[code] if code >= 0 else planes[-1 - code]

    for t, a, b in prog.ops.tolist():
        slots[t] = val(a) ^ val(b)
    ptr = prog.row_ptr.tolist()
    terms = prog.row_terms.tolist()
    out = planes.new_zeros((prog.n_rows,) + shape)
    for r in range(prog.n_rows):
        for code in terms[ptr[r]:ptr[r + 1]]:
            out[r] ^= val(code)
    return out


@dataclass(frozen=True)
class PanelProgram:
    """A wide network cut into PR x PK panels of RB output rows over KB
    input planes, each panel its own slotted program (module doc).

    Panel ``i = pr * PK + pk`` covers output rows [pr*RB, (pr+1)*RB) and
    input planes [pk*KB, (pk+1)*KB). Its ops are ``ops[op_ptr[i]:
    op_ptr[i+1]]``, its row r is CSR row ``i * RB + r`` of
    (``row_ptr``, ``row_terms``), and its panel-local input plane c sits
    in slot ``in_slot[i * KB + c]`` (-1 for a plane no term of the panel
    reads). Every operand code is a slot: a panel's inputs take their
    slots before its ops run.
    """

    ops: torch.Tensor  # (n_ops, 3) int32: dst slot, slot a, slot b
    op_ptr: torch.Tensor  # (PR * PK + 1,) int32
    row_ptr: torch.Tensor  # (PR * PK * RB + 1,) int32
    row_terms: torch.Tensor  # (nnz,) int32 slots
    in_slot: torch.Tensor  # (PR * PK * KB,) int32
    n_inputs: int  # C
    n_rows: int  # R
    KB: int
    RB: int
    n_slots: int  # the largest panel's peak live values
    temp_cap: int  # the temporaries each panel's factoring may keep
    cost: int  # two-input XORs over all panels
    raw: int  # the same panels' unfactored XORs
    panel_costs: tuple  # per panel, in panel order

    @property
    def PR(self) -> int:
        return -(-self.n_rows // self.RB)

    @property
    def PK(self) -> int:
        return -(-self.n_inputs // self.KB)


def compile_panels(bits_rows: tuple, C: int, KB: int, RB: int,
                   temp_cap: int) -> PanelProgram:
    """Cut ``bits_rows`` (R rows over C planes) into RB x KB panels
    (``split_bits_rows_panels``), compile each with
    ``compile_network(..., max_temps=temp_cap, inputs_in_slots=True)``
    and concatenate them into one :class:`PanelProgram` on the CPU.

    Inputs take slots, and a slot allocated by liveness is handed to a
    temporary once its input is read for the last time, so a panel's
    peak (``n_slots``) is below KB + its temporaries."""
    panels = split_bits_rows_panels(bits_rows, C, KB, RB)
    ops: list = []
    op_ptr = [0]
    row_ptr = [0]
    terms: list = []
    in_slot: list = []
    costs = []
    n_slots = 0
    for row in panels:
        for net in row:
            prog = compile_network(net, KB, max_temps=temp_cap)
            ops.extend(prog.ops.tolist())
            op_ptr.append(len(ops))
            base = len(terms)
            terms.extend(prog.row_terms.tolist())
            row_ptr.extend(base + x for x in prog.row_ptr.tolist()[1:])
            in_slot.extend(prog.in_slot.tolist())
            costs.append(prog.cost)
            n_slots = max(n_slots, prog.n_slots)

    return PanelProgram(
        ops=_i32(ops, (len(ops), 3)), op_ptr=_i32(op_ptr),
        row_ptr=_i32(row_ptr), row_terms=_i32(terms), in_slot=_i32(in_slot),
        n_inputs=C, n_rows=len(bits_rows), KB=KB, RB=RB, n_slots=n_slots,
        temp_cap=temp_cap, cost=sum(costs), raw=panel_raw_costs(panels)[0],
        panel_costs=tuple(costs),
    )


@dataclass(frozen=True)
class SplitProgram:
    """A network over 8k input planes cut into P = ceil(k/ksl) phases of
    ksl input rows (``split_bits_rows_ksl``), each phase its own program
    compiled with ``inputs_in_slots=True`` over 8·ksl planes.

    Slots ``[0, 8r)`` hold the parity accumulators; every phase's slots
    follow from ``8r`` on, in one region that each phase reuses, so
    ``n_slots = 8r + max(phase n_slots)``. Phase p's ops are ``ops[
    op_ptr[p]:op_ptr[p+1]]``, its output row q is CSR row ``p * 8r + q``
    of (``row_ptr``, ``row_terms``), and its local input plane c (plane
    ``p*8*ksl + c`` of the whole input) sits in slot ``in_slot[p*8*ksl +
    c]`` (-1 for a plane no term reads, and for the planes past row k of
    a short last slice). Every code in these tensors is already offset by
    8r. ``phases`` keeps the per-phase programs, unshifted.
    """

    ops: torch.Tensor  # (n_ops, 3) int32: dst slot, slot a, slot b
    op_ptr: torch.Tensor  # (P + 1,) int32
    row_ptr: torch.Tensor  # (P * 8r + 1,) int32
    row_terms: torch.Tensor  # (nnz,) int32 slots
    in_slot: torch.Tensor  # (P * 8 * ksl,) int32
    phases: tuple  # P XorPrograms on the CPU
    n_inputs: int  # 8k
    n_rows: int  # 8r
    ksl: int
    n_slots: int
    cost: int  # two-input XORs: the phases' costs + (P - 1) * 8r accumulates

    @property
    def P(self) -> int:
        return len(self.phases)


def compile_split(bits_rows: tuple, k: int, ksl: int) -> SplitProgram:
    """Cut ``bits_rows`` (8r rows over 8k planes) into ksl-row phases,
    compile each over 8·ksl planes and concatenate them into one
    :class:`SplitProgram` on the CPU (class doc)."""
    R = len(bits_rows)
    phases = tuple(compile_network(net, 8 * ksl)
                   for net in split_bits_rows_ksl(bits_rows, k, 8, ksl))
    ops: list = []
    op_ptr = [0]
    row_ptr = [0]
    terms: list = []
    in_slot: list = []
    for prog in phases:
        ops.extend((t + R, a + R, b + R) for t, a, b in prog.ops.tolist())
        op_ptr.append(len(ops))
        base = len(terms)
        terms.extend(c + R for c in prog.row_terms.tolist())
        row_ptr.extend(base + x for x in prog.row_ptr.tolist()[1:])
        in_slot.extend(s + R if s >= 0 else -1 for s in prog.in_slot.tolist())
    return SplitProgram(
        ops=_i32(ops, (len(ops), 3)), op_ptr=_i32(op_ptr),
        row_ptr=_i32(row_ptr), row_terms=_i32(terms), in_slot=_i32(in_slot),
        phases=phases, n_inputs=8 * k, n_rows=R, ksl=ksl,
        n_slots=R + max(p.n_slots for p in phases),
        cost=sum(p.cost for p in phases) + (len(phases) - 1) * R,
    )
