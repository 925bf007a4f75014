"""The Paar-factored XOR network as a kernel operand.

The JAX package bakes each matrix's factored network into a compiled
Pallas program (``eval_bits_rows`` at trace time). The port's kernels are
compiled once for every geometry instead, and take the network as data: an
:class:`XorProgram` of int32 tensors, built here from the same ``bits_rows``
tuples (``DeviceCodec.bits_rows_for``), cached per matrix and uploaded to
the card once. This is the state that a matrix carries into the kernels.

Values live in *slots*. A slot is freed after the last use of the value
it holds and handed to the next temporary, so ``n_slots`` is the peak
number of live values, not ``C + len(ops)``.

Operand codes: ``code >= 0`` is a slot; ``code < 0`` is input plane
``-1 - code``, read straight from the input tensor. A program built with
``inputs_in_slots=True`` (the fused kernel, which packs its inputs into
slots first) has no negative codes and maps input plane c to slot
``in_slot[c]`` (-1 for a plane no term reads). One built with
``inputs_in_slots=False`` (the standalone sparse matmul) keeps every input
in device memory, so only temporaries take slots and a temp cap bounds
them whatever the input width.

The :class:`XorProgram` is the function (:func:`eval_program` is the plain
version of both kernels that run it); what the kernels take is its level
schedule, an :class:`XorSchedule` (:func:`schedule_program`). Ops are
sorted into levels, so that no op reads a value written in its own level;
output rows become XOR ops of the same stream, their terms paired by the
level at which they are ready; slots are allocated again, by liveness,
over the levels, in shared memory laid out ``[slot][column]``. A block of
the kernels (``csrc/xornet.cuh``) holds one tile of columns and all its
warps share each level, with a barrier between levels, so a block's slots
cost ``4 * n_slots * tile`` bytes. Two ops share one 16-byte row of the
packed program (16-bit fields), which the block stages in shared memory
once, or streams through a two-chunk ring where it does not fit beside
the slots. The sparse matmul's inputs enter through load ops of the
stream, one level before their first use (or before every use, where the
inputs would not fit as slots: ``reload``).

A wide network can also be cut into panels (:func:`compile_panels`):
each (row block, K block) panel factored and slotted on its own, the
reference's per-panel factoring, whose XOR counts ``chip_smoke.py``'s
bounds read; and into K slices (:func:`compile_split`), one slotted
program per slice of ksl input rows, the reference's "dma" factoring. The
kernels of those two tiers, K7 and K5, take the matrix's bit expansion
instead (ops/gf2tile.py).
"""

from __future__ import annotations

import functools
import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np
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
# 228 KB): the budget for a block's slots and its staged program.
SMEM_BYTES = 232_448
# The column tiles a block of K1 or K4 may hold (csrc/xornet.cuh), widest
# first; a call takes one of them (:func:`pick_tile`).
TILES = (64, 32, 16, 8)
# The block sizes K1 and K4 take (threads).
BLOCKS = (256, 512, 1024)
# Streaming multiprocessors of an H100 SXM: the planners' default card.
N_SM = 132
# Op kinds and the packed fields' range (csrc/xornet.cuh).
OP_XOR, OP_LOAD, OP_NOP = 0, 1, 2
FIELD_LIMIT = 1 << 16
# Op pairs (16 bytes each) a ring chunk holds, for a program that does not
# fit beside its slots: two chunks take 16 KB, or 1 KB where even that
# leaves too little room for the slots.
RING_PAIRS = (512, 32)


def _i32(x, shape=None) -> torch.Tensor:
    t = torch.tensor(x, dtype=torch.int32)
    return t.reshape(shape) if shape is not None else t


def fits(sched: "XorSchedule", columns: int) -> bool:
    """True when ``sched``'s slots for a tile of ``columns`` columns and
    its staged program fit one block's shared memory."""
    return sched.smem_bytes(columns) <= SMEM_BYTES


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


@dataclass(frozen=True, eq=False)
class XorSchedule:
    """An :class:`XorProgram` in level order, packed for K1 and K4 (module
    doc).

    Each row of ``pairs`` holds two ops, words ``(x, y)`` at columns 0-1
    and 2-3, with ``x = dst | a << 16`` and ``y = b | kind << 16``: OP_XOR
    writes slot a ^ slot b to slot dst, OP_LOAD copies input plane a into
    slot dst, OP_NOP (the pad of a level with an odd op count) does
    nothing. Level l is rows ``level_ptr[l]:level_ptr[l+1]``; ring chunk c
    is levels ``chunk_level[c]:chunk_level[c+1]``, at most ``chunk_pairs``
    rows (one chunk, the whole program, where it fits beside the slots).
    ``in_slot[c]`` is the slot the fused kernel writes input plane c to
    before the first level (-1 for a plane no op reads; None for the
    sparse matmul, whose inputs enter through load ops); output row r is
    slot ``out_slot[r]`` after the last level (-1: zero)."""

    prog: XorProgram  # the function; eval_program(prog) is the plain version
    pairs: torch.Tensor  # (n_pairs, 4) int32
    level_ptr: torch.Tensor  # (n_levels + 1,) int32
    chunk_level: torch.Tensor  # (n_chunks + 1,) int32
    in_slot: Optional[torch.Tensor]  # (C,) int32, or None
    out_slot: torch.Tensor  # (R,) int32
    n_slots: int
    n_ops: int  # XOR and load ops, pads not counted
    chunk_pairs: int
    reload: bool  # loads before every use level, not only the first

    @property
    def n_inputs(self) -> int:
        return self.prog.n_inputs

    @property
    def n_rows(self) -> int:
        return self.prog.n_rows

    @property
    def cost(self) -> int:
        return self.prog.cost

    @property
    def n_levels(self) -> int:
        return self.level_ptr.numel() - 1

    @property
    def n_chunks(self) -> int:
        return self.chunk_level.numel() - 1

    @property
    def program_bytes(self) -> int:
        return 16 * self.pairs.shape[0]

    @property
    def ring_bytes(self) -> int:
        return 16 * self.chunk_pairs * min(self.n_chunks, 2)

    def smem_bytes(self, tile: int) -> int:
        """Shared memory of a block holding ``tile`` columns: two
        mbarriers, the program's ring and the slots."""
        return 16 + self.ring_bytes + 4 * self.n_slots * tile

    @functools.cached_property
    def tiles(self) -> tuple[int, ...]:
        """The tiles of :data:`TILES` whose block fits, widest first."""
        return tuple(t for t in TILES if fits(self, t))

    @functools.cached_property
    def net_args(self) -> tuple:
        """The C entries' schedule arguments, computed once: the packed
        pairs, level and chunk tables, chunk count and size, slot count
        and output slots (a kernel call's host time is part of its
        time on the card at small sizes)."""
        from noise_ec_tpu_torch.ops import _build

        return (_build.ptr(self.pairs), _build.ptr(self.level_ptr),
                _build.ptr(self.chunk_level), self.n_chunks,
                self.chunk_pairs, self.n_slots, _build.ptr(self.out_slot))

    def to(self, device) -> "XorSchedule":
        """The same schedule with its tensors on ``device``."""

        def move(t):
            return None if t is None else t.to(device)

        return XorSchedule(
            self.prog.to(device), move(self.pairs), move(self.level_ptr),
            move(self.chunk_level), move(self.in_slot), move(self.out_slot),
            self.n_slots, self.n_ops, self.chunk_pairs, self.reload,
        )


def _level_ops(prog: XorProgram, reload: bool,
               row_width: Optional[int] = None):
    """``prog`` as levels of independent ops over fresh slots: (levels,
    in_slot, out_slot, n_slots), each level a list of (kind, dst, a, b).

    Values are numbered inputs first (0..C-1), then ``prog``'s temporaries,
    then the output rows' XORs, whose terms are paired by the level at
    which they are ready (a Huffman merge on levels), so a row adds about
    log2 of its terms to the depth. An op's level is one more than its
    operands' deepest; ops no output needs are dropped. Without
    ``in_slot`` the inputs enter through load ops: one a used input, a
    level before its first use, or with ``reload`` one a (input, use
    level), a level before it. A slot is handed on once the level that
    reads its value for the last time has ended (a barrier later)."""
    C = prog.n_inputs
    slot_val: dict[int, int] = {}
    if prog.in_slot is not None:
        for c, s in enumerate(prog.in_slot.tolist()):
            if s >= 0:
                slot_val[s] = c

    def val(code: int) -> int:
        return slot_val[code] if code >= 0 else -1 - code

    args: list[tuple[int, int]] = []  # value C + i is args[i][0] ^ args[i][1]
    level = [0] * C
    for t, a, b in prog.ops.tolist():
        va, vb = val(a), val(b)
        slot_val[t] = C + len(args)
        args.append((va, vb))
        level.append(1 + max(level[va], level[vb]))
    ptr, terms = prog.row_ptr.tolist(), prog.row_terms.tolist()
    rows = [[val(c) for c in terms[ptr[r]:ptr[r + 1]]]
            for r in range(prog.n_rows)]
    outs: list[Optional[int]] = []
    for row in rows:
        terms = [(level[v], v) for v in row]
        heapq.heapify(terms)
        parts: list[tuple[int, int]] = []  # the row's partial sums
        while len(terms) + len(parts) > 1:
            # The two earliest-ready items; two terms make a new partial
            # sum only while the row has fewer than row_width of them.
            pick = []
            for _ in range(2):
                heap = (parts if not terms or (parts and parts[0] <= terms[0])
                        else terms)
                pick.append((heap is parts,) + heapq.heappop(heap))
            if (not pick[0][0] and not pick[1][0] and parts
                    and row_width is not None and len(parts) >= row_width):
                heapq.heappush(terms, pick[1][1:])
                pick[1] = (True,) + heapq.heappop(parts)
            (_, la, a), (_, lb, b) = pick
            args.append((a, b))
            level.append(1 + max(la, lb))
            heapq.heappush(parts, (level[-1], len(level) - 1))
        outs.append((parts or terms)[0][1] if parts or terms else None)

    live = [False] * len(level)
    for v in outs:
        if v is not None:
            live[v] = True
    for v in range(len(level) - 1, C - 1, -1):
        if live[v]:
            live[args[v - C][0]] = live[args[v - C][1]] = True
    end = 1 + max((level[v] for v in range(C, len(level)) if live[v]),
                  default=0)

    # Each op as (level, value, kind, a, b) over values; the reads of an
    # input go through a load value where the inputs are not in slots.
    ops = [(level[v], v, OP_XOR) + args[v - C]
           for v in range(C, len(level)) if live[v]]
    if prog.in_slot is None:
        uses: dict[int, set[int]] = {}
        for lv, _, _, a, b in ops:
            for x in (a, b):
                if x < C:
                    uses.setdefault(x, set()).add(lv)
        for v in outs:
            if v is not None and v < C:
                uses.setdefault(v, set()).add(end)
        loaded: dict[tuple[int, int], int] = {}
        for c in sorted(uses):
            at = sorted(uses[c]) if reload else [min(uses[c])]
            for u in at:
                loaded[c, u] = len(level)
                level.append(u - 1)
                ops.append((u - 1, loaded[c, u], OP_LOAD, c, 0))

        def src(x: int, u: int) -> int:
            if x >= C:
                return x
            return loaded[x, u] if reload else loaded[x, min(uses[x])]

        ops = [(lv, v, k, a, b) if k == OP_LOAD
               else (lv, v, k, src(a, lv), src(b, lv))
               for lv, v, k, a, b in ops]
        outs = [None if v is None else src(v, end) for v in outs]

    last = {}
    for lv, _, k, a, b in ops:
        if k == OP_XOR:
            last[a] = max(last.get(a, -1), lv)
            last[b] = max(last.get(b, -1), lv)
    for v in outs:
        if v is not None:
            last[v] = end
    release: dict[int, list[int]] = {}
    for v, lv in last.items():
        release.setdefault(lv + 1, []).append(v)
    free: list[int] = []
    slot: dict[int, int] = {}
    n_slots = 0

    def alloc(v: int) -> None:
        nonlocal n_slots
        if free:
            slot[v] = heapq.heappop(free)
        else:
            slot[v] = n_slots
            n_slots += 1

    in_slot = None
    if prog.in_slot is not None:
        in_slot = [-1] * C
        for c in range(C):
            if c in last:
                alloc(c)
                in_slot[c] = slot[c]
    by_level: dict[int, list] = {}
    for op in sorted(ops):
        by_level.setdefault(op[0], []).append(op)
    levels = []
    for lv in range(end):
        for v in release.get(lv, ()):
            if v in slot:
                heapq.heappush(free, slot[v])
        todo = by_level.get(lv, [])
        for _, v, _, _, _ in todo:
            alloc(v)
        if todo:
            levels.append([
                (k, slot[v], a, 0) if k == OP_LOAD
                else (k, slot[v], slot[a], slot[b])
                for _, v, k, a, b in todo])
    out_slot = [-1 if v is None else slot[v] for v in outs]
    return levels, in_slot, out_slot, n_slots


def _pack(prog: XorProgram, levels, in_slot, out_slot, n_slots: int,
          reload: bool, chunk_pairs: Optional[int]) -> XorSchedule:
    """Pack ``levels`` (from :func:`_level_ops`) two ops a row, cut into
    ring chunks of at most ``chunk_pairs`` rows (None: one chunk). A level
    longer than a chunk becomes consecutive levels: its ops are
    independent, so running them in turn is valid."""
    if n_slots > FIELD_LIMIT or prog.n_inputs > FIELD_LIMIT:
        raise ValueError(
            f"{n_slots} slots over {prog.n_inputs} input planes overflow "
            f"the schedule's 16-bit fields (at most {FIELD_LIMIT})"
        )
    if chunk_pairs is not None:
        step = 2 * chunk_pairs
        levels = [lv[i:i + step] for lv in levels
                  for i in range(0, len(lv), step)]
    rows: list = []
    level_ptr = [0]
    for lv in levels:
        ops = lv + [(OP_NOP, 0, 0, 0)] * (len(lv) % 2)
        for o0, o1 in zip(ops[::2], ops[1::2]):
            rows.append([w for kind, dst, a, b in (o0, o1)
                         for w in (dst | a << 16, b | kind << 16)])
        level_ptr.append(len(rows))
    if chunk_pairs is None:
        chunk_pairs = len(rows)
        chunk_level = [0, len(levels)] if levels else [0]
    else:
        chunk_level = [0]
        for lv in range(len(levels)):
            start = level_ptr[chunk_level[-1]]
            if level_ptr[lv + 1] - start > chunk_pairs:
                chunk_level.append(lv)
        if levels:
            chunk_level.append(len(levels))
    packed = np.asarray(rows, dtype=np.uint32).reshape(-1, 4)
    return XorSchedule(
        prog=prog, pairs=torch.from_numpy(packed.view(np.int32)),
        level_ptr=_i32(level_ptr), chunk_level=_i32(chunk_level),
        in_slot=None if in_slot is None else _i32(in_slot),
        out_slot=_i32(out_slot, (len(out_slot),)), n_slots=n_slots,
        n_ops=sum(map(len, levels)),
        chunk_pairs=chunk_pairs, reload=reload,
    )


def schedule_program(prog: XorProgram, reload: bool = False,
                     chunk_pairs: Optional[int] = None,
                     row_width: Optional[int] = None) -> XorSchedule:
    """The level schedule of ``prog`` (module doc): K1's where ``prog``
    keeps its inputs in slots, K4's otherwise (``reload``: load an input
    before every level that reads it). ``chunk_pairs`` cuts the packed
    program into ring chunks of that many op pairs; by default it is one
    chunk. ``row_width`` bounds the partial sums an output row keeps at
    once (fewer slots, more levels; 1 sums each row in a chain). Raises
    where a slot or input plane overflows the 16-bit fields."""
    if reload and prog.in_slot is not None:
        raise ValueError("reload applies to a program whose inputs stay in "
                         "memory")
    return _pack(prog, *_level_ops(prog, reload, row_width), reload,
                 chunk_pairs)


def plan_schedule(prog: XorProgram, reload: bool = False,
                  row_width: Optional[int] = None) -> Optional[XorSchedule]:
    """``prog``'s schedule (:func:`schedule_program`) with the whole
    program staged beside the slots, or streamed through a ring of chunks
    of one of :data:`RING_PAIRS` op pairs, whichever lets a block hold the
    widest tile of :data:`TILES` (the fewest chunks on a tie); None when
    none fits even the narrowest tile."""
    parts = _level_ops(prog, reload, row_width)
    scheds = [_pack(prog, *parts, reload, None)]
    for pairs in RING_PAIRS:
        if scheds[0].pairs.shape[0] > 2 * pairs:
            scheds.append(_pack(prog, *parts, reload, pairs))
    for tile in TILES:
        for sched in scheds:
            if fits(sched, tile):
                return sched
    return None


def block_threads(sched: XorSchedule) -> int:
    """Threads a block of K1 or K4: the warps of a block share each level,
    so the fewer blocks of the schedule's widest tile an SM holds, the
    more warps each: 8 where it holds four or more, 16 where two or three,
    32 where one."""
    blocks = (SMEM_BYTES // sched.smem_bytes(sched.tiles[0])
              if sched.tiles else 0)
    return 256 if blocks >= 4 else 512 if blocks >= 2 else 1024


def pick_tile(sched: XorSchedule, columns: int, batch: int = 1,
              n_sm: int = N_SM) -> int:
    """The column tile for a call of ``batch`` x ``columns`` columns: the
    widest of the schedule's tiles whose grid still gives every SM a
    block (a wider tile reads each op's words for more columns), else the
    narrowest (a small call spreads over the SMs in narrow tiles: each
    warp step then runs four op pairs of eight columns, or two of
    sixteen)."""
    if not sched.tiles:
        raise ValueError(
            f"{sched.n_slots} slots and a {sched.ring_bytes}-byte ring fit "
            "no tile of shared memory"
        )
    for t in sched.tiles:
        if -(-columns // t) * batch >= n_sm:
            return t
    return sched.tiles[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def schedule_args(sched: XorSchedule, like: torch.Tensor, threads: int,
                  columns: int, batch: int,
                  tile: Optional[int] = None) -> tuple[int, tuple]:
    """(tile, the C entry's schedule arguments) for a launch of K1 or K4
    on ``like``'s device over ``batch`` x ``columns`` columns: the tile is
    :func:`pick_tile`'s for the device's SMs unless given. Raises where
    the schedule is not on that device, ``threads`` is not a block the
    kernels take (:data:`BLOCKS`) or the tile does not fit."""
    if sched.pairs.device != like.device:
        raise ValueError(
            f"no kernel for data on {like.device} and a schedule on "
            f"{sched.pairs.device}"
        )
    if threads not in BLOCKS:
        raise ValueError(f"a block of {threads} threads; the kernels take "
                         f"{BLOCKS}")
    if tile is None:
        tile = pick_tile(sched, columns, batch, _sm_count(like.device.index))
    elif tile not in sched.tiles:
        raise ValueError(f"tile {tile}: {sched.smem_bytes(tile)} bytes of "
                         "shared memory do not fit a block")
    return tile, sched.net_args + (tile, threads)


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
