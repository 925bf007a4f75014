"""Greedy common-subexpression factoring for GF(2) XOR networks.

A copy of ``noise_ec_tpu.ops.xor_factor`` (the JAX package's ``ops``
package imports jax, so the port keeps its own), with a faster update step
in :func:`paar_factor` that gives the same result.

The geometry-baked kernels evaluate each output bit-plane as an XOR chain
over the input planes with a set bit in the expanded generator matrix
(gf/bitmatrix.py). For RS(10,4)/GF(2^8) that is a (32, 80) 0/1 matrix at
~50% density: ~1,230 two-input XORs evaluated straight off the rows.
Because generator rows are algebraically related, many column pairs
co-occur in several rows; Paar's greedy algorithm (Paar 1997, "Optimized
arithmetic for Reed-Solomon encoders") repeatedly materializes the most
frequent pair as a shared temporary, typically cutting the XOR count by
30-45% for these matrices. The factoring runs once per geometry on the
host; the port compiles the result into an ``ops.network.XorProgram`` that
its kernels take as an operand (shared-memory pressure there is what
``max_temps`` bounds).
"""

from __future__ import annotations

import functools

# paar_factor's int encodings: node ids and frequencies below 2**20.
_ID_BITS = 20
_ID_MASK = (1 << _ID_BITS) - 1
_PAIR_BITS = 2 * _ID_BITS
_PAIR_MASK = (1 << _PAIR_BITS) - 1
_FREQ_TOP = 1 << _ID_BITS


# Sized for a panel-routed network: RS(200,56) at 32-column panels has 700
# panels, each factored once here and read again by its capped replays.
@functools.lru_cache(maxsize=4096)
def paar_factor(
    bits_rows: tuple[tuple[int, ...], ...],
    num_inputs: int,
    min_freq: int = 2,
    max_temps: int = 100_000,
) -> tuple[tuple[tuple[int, int, int], ...], tuple[tuple[int, ...], ...]]:
    """Factor shared pairs out of XOR rows.

    Returns ``(ops, rows)``: ``ops`` is an ordered tuple of
    ``(temp_id, a, b)`` meaning ``t[temp_id] = t[a] ^ t[b]`` (ids >=
    ``num_inputs`` are temporaries, evaluated in order); ``rows[r]`` is the
    remaining term tuple for output row r over inputs and temporaries.
    Total two-input XORs = ``len(ops) + sum(max(len(row)-1, 0))``.

    Incremental implementation: the pair-frequency table is built once and
    updated only for the rows a factoring touches, with a lazy max-heap
    over (frequency, pair); distinct pairs are bounded by the (small)
    column count squared, not by rows x terms^2. ``min_freq`` stops the
    factoring when the best pair saves fewer than ``min_freq - 1`` XORs
    per round; ``max_temps`` bounds temporary count (shared-memory
    pressure in the kernels).

    Each round picks the pair of highest frequency, the smallest pair
    among equals — the reference's choice, round for round, so the result
    is the reference's. Two changes make it several times faster on
    RS(50,20)'s network: a round updates the table once per distinct
    column of the affected rows, by that column's count (``np.unique``),
    not once per (row, term); and pairs and heap keys are ints, not
    tuples.
    """
    import heapq

    import numpy as np

    rows = [set(t) for t in bits_rows]
    where: dict[int, set[int]] = {}  # column id -> set of row indices
    for ri, s in enumerate(rows):
        for c in s:
            where.setdefault(c, set()).add(ri)
    # Initial pair table via one co-occurrence matmul: distinct pairs are
    # bounded by num_inputs^2, far below rows x terms^2 Counter updates.
    M = np.zeros((len(rows), num_inputs), dtype=np.int32)
    for ri, s in enumerate(rows):
        M[ri, list(s)] = 1
    P = M.T @ M
    iu = np.triu_indices(num_inputs, k=1)
    nz = P[iu] > 0
    # A pair (a < b) is the int a << _ID_BITS | b; a heap key orders by
    # frequency (descending), then pair (ascending) as one int, which
    # heapq compares far faster than the reference's nested tuples.
    if num_inputs + sum(len(t) for t in bits_rows) >= 1 << _ID_BITS:
        raise ValueError("network too large for the pair encoding")
    cnt: dict[int, int] = {
        (int(a) << _ID_BITS) | int(b): int(f)
        for a, b, f in zip(iu[0][nz], iu[1][nz], P[iu][nz])
    }
    heap = [((_FREQ_TOP - f) << _PAIR_BITS) | p for p, f in cnt.items()]
    heapq.heapify(heap)

    ops: list[tuple[int, int, int]] = []
    next_id = num_inputs
    while heap and len(ops) < max_temps:
        key = heapq.heappop(heap)
        p = key & _PAIR_MASK
        f = _FREQ_TOP - (key >> _PAIR_BITS)
        cur = cnt.get(p, 0)
        if cur != f:  # stale lazy-heap entry
            # Decrements don't push, so a pair whose only entry went stale
            # would otherwise vanish from the heap while still profitable:
            # re-enqueue it at its current count.
            if cur >= min_freq:
                heapq.heappush(heap, ((_FREQ_TOP - cur) << _PAIR_BITS) | p)
            continue
        if f < min_freq:
            break
        a, b = p >> _ID_BITS, p & _ID_MASK
        t = next_id
        next_id += 1
        ops.append((t, a, b))
        affected = where[a] & where[b]
        del cnt[p]
        where[t] = set()
        others: list[int] = []  # the affected rows' other terms
        for ri in affected:
            s = rows[ri]
            s.discard(a)
            s.discard(b)
            others.extend(s)
            s.add(t)
            where[a].discard(ri)
            where[b].discard(ri)
            where[t].add(ri)
        if others:
            xs, ns = np.unique(np.array(others), return_counts=True)
            for x, n in zip(xs.tolist(), ns.tolist()):
                pa = (a << _ID_BITS | x) if a < x else (x << _ID_BITS | a)
                pb = (b << _ID_BITS | x) if b < x else (x << _ID_BITS | b)
                cnt[pa] = cnt.get(pa, 0) - n
                cnt[pb] = cnt.get(pb, 0) - n
                px = x << _ID_BITS | t  # x < t always: temps get the largest ids
                c = cnt[px] = cnt.get(px, 0) + n
                heapq.heappush(heap, ((_FREQ_TOP - c) << _PAIR_BITS) | px)
    return tuple(ops), tuple(tuple(sorted(s)) for s in rows)


def eval_factored(ops, rows, get_input, make_zero):
    """Evaluate a factored XOR network during kernel tracing.

    ``get_input(c)`` fetches input plane c; ``make_zero()`` builds an
    all-zero tile for empty rows. Returns the list of output-row values.
    Temps live in the traced SSA graph — the dict here only spans tracing,
    so compiled liveness is last-use, not whole-program.
    """
    vals: dict[int, object] = {}

    def get(c):
        return vals[c] if c in vals else get_input(c)

    for t, a, b in ops:
        vals[t] = get(a) ^ get(b)
    outs = []
    for terms in rows:
        if not terms:
            outs.append(make_zero())
            continue
        acc = get(terms[0])
        for c in terms[1:]:
            acc = acc ^ get(c)
        outs.append(acc)
    return outs


def eval_bits_rows(bits_rows, C: int, get_plane, make_zero,
                   max_temps: int = 100_000):
    """Factor ``bits_rows`` and evaluate it over input planes 0..C-1.

    The one entry point both baked kernels (the fused single-kernel encode
    and the standalone sparse matmul) trace through: hoists each used input
    plane once via ``get_plane``, then runs the factored network. Returns
    the list of output-row values. ``max_temps`` caps the temporary count
    (VMEM stack pressure) at the price of more XORs — see paar_factor.
    """
    ops, rows = paar_factor(bits_rows, C, max_temps=max_temps)
    used = {c for terms in rows for c in terms if c < C}
    used |= {c for _, a, b in ops for c in (a, b) if c < C}
    vs = {c: get_plane(c) for c in sorted(used)}
    return eval_factored(ops, rows, vs.__getitem__, make_zero)


def xor_cost(bits_rows: tuple[tuple[int, ...], ...]) -> int:
    """Two-input XOR count of the unfactored row evaluation."""
    return sum(max(len(t) - 1, 0) for t in bits_rows)


# --------------------------------------------------------------------- panels
#
# The block-panel kernels (pallas_gf2mm "panel tier") split a wide
# (R, C) network into a 2-D grid of (RB output-rows x KB input-cols)
# panels and evaluate one panel's sub-network per grid step. Factoring
# runs PER PANEL, which is what makes near-field-limit geometries
# plannable at all: Paar is super-linear in terms, so the whole
# RS(200,56) network (~361k raw XORs) ran >9 min while its 64x128
# panels factor in seconds total — and the temp count (VMEM stack
# pressure) is bounded per panel instead of per program.


def split_bits_rows_panels(
    bits_rows: tuple[tuple[int, ...], ...], C: int, KB: int, RB: int
) -> tuple[tuple[tuple[tuple[int, ...], ...], ...], ...]:
    """Partition an (R rows x C cols) network into ceil(R/RB) x
    ceil(C/KB) panels.

    ``out[pr][pk]`` is the sub-network of output rows
    [pr*RB, (pr+1)*RB) over input columns [pk*KB, (pk+1)*KB), columns
    re-indexed to the panel-local [0, KB) range. A padded final row
    block simply carries empty rows; a padded final column block has
    columns no term references — XOR over GF(2) is associative and
    commutative, so the row sum of a panel row over all pk panels
    equals the original row.
    """
    R = len(bits_rows)
    PR = -(-R // RB) if R else 1
    PK = -(-C // KB) if C else 1
    out = []
    for pr in range(PR):
        rows = bits_rows[pr * RB : (pr + 1) * RB]
        rows = rows + ((),) * (RB - len(rows))
        row_panels = []
        for pk in range(PK):
            lo, hi = pk * KB, (pk + 1) * KB
            row_panels.append(
                tuple(
                    tuple(c - lo for c in row if lo <= c < hi)
                    for row in rows
                )
            )
        out.append(tuple(row_panels))
    return tuple(out)


def split_bits_rows_ksl(bits_rows: tuple, k: int, m: int, ksl: int) -> tuple:
    """Partition the (r*m)-row network into ceil(k/ksl) sub-networks by
    contiguous ksl-row input slices (the K-sliced fused kernel's phases);
    sub-network p's column ids are re-indexed to its local [0, ksl*m)
    plane range (a short final slice simply has columns no term
    references). A copy of ``pallas_fused.split_bits_rows_ksl``."""
    P = -(-k // ksl)
    out = []
    for p in range(P):
        lo, hi = p * ksl * m, min((p + 1) * ksl * m, k * m)
        out.append(
            tuple(
                tuple(c - lo for c in row if lo <= c < hi) for row in bits_rows
            )
        )
    return tuple(out)


def panel_raw_costs(panels) -> tuple[int, int]:
    """(total, max_single) raw XOR cost over a panel grid — the
    planner's cheap pre-factoring score inputs."""
    costs = [xor_cost(p) for row in panels for p in row]
    return sum(costs), max(costs) if costs else 0


def factor_panels(panels, KB: int, max_temps: int = 100_000):
    """Factor every panel (cached per panel via paar_factor) and return
    ``(total_factored_cost, max_temps_used)`` — the exact numbers the
    panel planner sizes shared memory from, where a pre-factoring
    estimate would be a ratio."""
    total = 0
    worst = 0
    for row in panels:
        for p in row:
            ops, rem = paar_factor_capped(p, KB, max_temps)
            total += factored_cost(ops, rem)
            worst = max(worst, len(ops))
    return total, worst


def factored_cost(
    ops: tuple[tuple[int, int, int], ...], rows: tuple[tuple[int, ...], ...]
) -> int:
    return len(ops) + sum(max(len(t) - 1, 0) for t in rows)


def paar_factor_capped(
    bits_rows: tuple[tuple[int, ...], ...], num_inputs: int, max_temps: int
) -> tuple[tuple[tuple[int, int, int], ...], tuple[tuple[int, ...], ...]]:
    """``paar_factor(bits_rows, num_inputs, max_temps=max_temps)``, cheaply.

    ``max_temps`` only stops paar_factor's greedy loop early, so a capped
    run is the first ``max_temps`` rounds of the uncapped one. This replays
    those rounds over the rows of the (cached) uncapped factoring instead
    of re-running the pair search: the planner tries several caps, and one
    pair search over RS(50,20)'s network takes seconds in Python.
    """
    ops, rows = paar_factor(bits_rows, num_inputs)
    if max_temps >= len(ops):
        return ops, rows
    ops = ops[:max_temps]
    rows = [set(t) for t in bits_rows]
    for t, a, b in ops:
        for s in rows:
            if a in s and b in s:
                s.discard(a)
                s.discard(b)
                s.add(t)
    return ops, tuple(tuple(sorted(s)) for s in rows)
