"""Berlekamp-Welch error-correcting decode for the GRS constructions.

A copy of ``noise_ec_tpu.matrix.bw`` on the port's modules. The host route
(``device=None``, chosen by the caller) runs the syndrome, the row products
and the decode1 fused fold on the port's native shim
(:mod:`noise_ec_tpu_torch.shim`), over GF(2^8) and GF(2^16), as the
reference does; only a shape the shim does not take goes to NumPy, and a
shim that cannot be built or loaded raises ``ShimBuildError`` (the
reference drops to NumPy instead). The device route (``device`` a
:class:`~noise_ec_tpu_torch.ops.dispatch.DeviceCodec`) sends the syndrome,
solve and decode1-fold products to the card, and a device error
propagates.

The reference's codec (``vivint/infectious``, called at main.go:77) does
not just fill erasures: with more than k
shares its ``Decode`` runs Berlekamp-Welch per byte offset, correcting up to
floor((m - k) / 2) corrupted shares *per column*. The golden codec's
consistent-subset search has the same unique-decoding radius for shard-level
corruption but is exponential in the worst case and only models whole-share
corruption. This module is the faithful polynomial-time algorithm.

It works because every MDS construction in :mod:`matrix.generators` is a
generalized Reed-Solomon (GRS) evaluation code whose evaluation point for
shard ``pos`` is ``pos`` itself:

- ``vandermonde_raw``: codeword row p is f(p) where f's coefficients are the
  data — the evaluation code itself, multipliers 1.
- ``vandermonde`` (systematic): right-multiplying by inv(V[:k]) is a change
  of basis on the message, not on the code: codeword row p is still f(p),
  now with f interpolating the data at points 0..k-1.
- ``cauchy``: with w_j = prod_{l<k, l!=j} (j ^ l) and Z_p = prod_{l<k} (p ^ l),
  the degree-<k polynomial f interpolating f(j) = d_j * w_j satisfies
  f(p) = Z_p * parity_p for every parity position p >= k (Lagrange expansion;
  the w_j cancels the interpolation denominator). So the codeword is the GRS
  code with column multipliers 1/w_j (data) and 1/Z_p (parity).

``par1`` is not MDS (singular generalized-Vandermonde minors) and has no
GRS representation; callers must keep the subset search for it.

Given the normalizers N_pos (w or Z above, ones for Vandermonde), the
received word normalizes to R_pos = N_pos * r_pos = f(pos) + error, and
classic Berlekamp-Welch applies: solve the linear system

    Q(x_i) = R_i * E(x_i)        deg Q < k + e,  E = x^e + ...,  e = (m-k)//2

for each received position x_i; then f = Q / E exactly, or the column is
beyond the unique-decoding radius.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from noise_ec_tpu_torch.gf.field import GF
from noise_ec_tpu_torch.matrix.linalg import gf_inv


def gf_solve_any(gf: GF, A: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """One solution x of A @ x = b over GF, or None if inconsistent.

    Plain Gauss elimination with free variables pinned to zero; A may be
    rectangular or rank-deficient (Berlekamp-Welch systems are both when
    fewer than e errors occurred).
    """
    A = np.asarray(A, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    rows, cols = A.shape
    aug = np.concatenate([A, b[:, None]], axis=1)
    pivot_col_of_row: list[int] = []
    row = 0
    for col in range(cols):
        pivot = None
        for rr in range(row, rows):
            if aug[rr, col] != 0:
                pivot = rr
                break
        if pivot is None:
            continue
        if pivot != row:
            aug[[row, pivot]] = aug[[pivot, row]]
        aug[row] = gf.div(aug[row], aug[row, col]).astype(np.int64)
        factors = aug[:, col].copy()
        factors[row] = 0
        aug ^= gf.mul(factors[:, None], aug[row][None, :]).astype(np.int64)
        pivot_col_of_row.append(col)
        row += 1
        if row == rows:
            break
    # Inconsistent iff a zero row has nonzero RHS.
    if np.any((aug[row:, :cols] == 0).all(axis=1) & (aug[row:, cols] != 0)):
        return None
    x = np.zeros(cols, dtype=np.int64)
    for r, c in enumerate(pivot_col_of_row):
        x[c] = aug[r, cols]
    return x.astype(gf.dtype)


def poly_eval(gf: GF, coeffs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Evaluate sum_j coeffs[j] x^j at each x (Horner, vectorized over xs)."""
    xs = np.asarray(xs, dtype=np.int64)
    out = np.zeros_like(xs)
    for c in np.asarray(coeffs, dtype=np.int64)[::-1]:
        out = (gf.mul(out, xs).astype(np.int64)) ^ c
    return out.astype(gf.dtype)


def poly_divmod(
    gf: GF, num: np.ndarray, den: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Polynomial division over GF; coefficient order is ascending."""
    num = list(np.asarray(num, dtype=np.int64))
    den = np.asarray(den, dtype=np.int64)
    dlen = len(den)
    while dlen > 1 and den[dlen - 1] == 0:
        dlen -= 1
    if dlen == 0 or den[dlen - 1] == 0:
        raise ZeroDivisionError("division by zero polynomial")
    lead_inv = int(gf.inv(den[dlen - 1]))
    qlen = max(len(num) - dlen + 1, 0)
    quot = np.zeros(max(qlen, 1), dtype=np.int64)
    for i in range(qlen - 1, -1, -1):
        c = int(gf.mul(num[i + dlen - 1], lead_inv))
        quot[i] = c
        if c:
            for j in range(dlen):
                num[i + j] ^= int(gf.mul(c, den[j]))
    rem = np.asarray(num[: dlen - 1] if dlen > 1 else [0], dtype=np.int64)
    return quot.astype(gf.dtype), rem.astype(gf.dtype)


def grs_normalizers(gf: GF, kind: str, k: int, n: int) -> np.ndarray:
    """(n,) multipliers N with N[pos] * codeword[pos] == f(pos).

    Raises ValueError for constructions with no GRS representation (par1).
    """
    if kind in ("vandermonde", "vandermonde_raw"):
        return np.ones(n, dtype=gf.dtype)
    if kind != "cauchy":
        raise ValueError(f"no GRS representation for generator kind {kind!r}")
    pts = np.arange(n, dtype=np.int64)
    N = np.ones(n, dtype=np.int64)
    for l in range(k):
        term = pts ^ l
        term[l] = 1  # skip the l == pos factor inside the data block
        N = gf.mul(N, term).astype(np.int64)
    return N.astype(gf.dtype)


def bw_correct_column(
    gf: GF, xs: np.ndarray, R: np.ndarray, k: int
) -> Optional[np.ndarray]:
    """Berlekamp-Welch on one normalized column; returns f's k coefficients.

    ``xs``: m distinct evaluation points; ``R``: the m received (normalized)
    values, at most floor((m - k)/2) of them wrong. None if the column is
    beyond the unique-decoding radius.
    """
    m = len(xs)
    e = (m - k) // 2
    xs = np.asarray(xs, dtype=np.int64)
    R = np.asarray(R, dtype=np.int64)
    # Power basis columns x^0 .. x^{k+e-1} (Q), then R*x^0 .. R*x^{e-1} (E).
    powers = np.ones((m, k + e), dtype=np.int64)
    for j in range(1, k + e):
        powers[:, j] = gf.mul(powers[:, j - 1], xs)
    if e:
        epows = gf.mul(R[:, None], powers[:, :e]).astype(np.int64)
        A = np.concatenate([powers, epows], axis=1)
        xe = gf.mul(powers[:, e - 1], xs).astype(np.int64)  # x^e
        rhs = gf.mul(R, xe).astype(np.int64)
    else:
        A = powers
        rhs = R
    sol = gf_solve_any(gf, A, rhs)
    if sol is None:
        return None
    Q = sol[: k + e]
    E = np.concatenate([sol[k + e :], np.array([1], dtype=gf.dtype)])  # monic
    f, rem = poly_divmod(gf, Q, E)
    if np.any(rem):
        return None
    out = np.zeros(k, dtype=gf.dtype)
    out[: min(len(f), k)] = f[:k]
    if np.any(f[k:]):
        return None  # degree overflow: not a valid message polynomial
    # Q/E exact does not by itself guarantee the radius: re-check agreement.
    agree = int(np.sum(poly_eval(gf, out, xs).astype(np.int64) == R))
    if agree < m - e:
        return None
    return out


def _syndrome(
    gf: GF,
    A: np.ndarray,
    rows: list,
    k: int,
    *,
    want_s: bool = True,
    device=None,
) -> tuple[Optional[np.ndarray], np.ndarray]:
    """s = A @ rows[:k] ^ rows[k:], plus per-column nonzero-row counts.

    Dispatch: DeviceCodec (one augmented-matrix device matmul) when a
    device is supplied, else the native shim's fused tiled kernels on the
    host (GF(2^8) and GF(2^16); ``want_s`` False lets it skip building s),
    NumPy for what the shim does not take. Row buffers are consumed in
    place (no stacking copy on the shim path).
    """
    if device is not None:
        return device.syndrome_stripes(A, np.stack(rows))
    if gf.degree in (8, 16):
        from noise_ec_tpu_torch.shim import gf16_syndrome_rows, gf_syndrome_rows

        fn = gf_syndrome_rows if gf.degree == 8 else gf16_syndrome_rows
        out = fn(np.asarray(A), rows[:k], rows[k:], rows[0].size,
                 want_syndrome=want_s)
        if out is not None:
            return out
    pred = gf.matvec_stripes(np.asarray(A, dtype=np.int64), np.stack(rows[:k]))
    s = (pred.astype(gf.dtype) ^ np.stack(rows[k:])).astype(gf.dtype)
    return s, np.count_nonzero(s, axis=0)


def _matmul_rows(gf: GF, M: np.ndarray, rows: list, *, device=None) -> np.ndarray:
    """M @ rows over GF on the fastest available backend (see _syndrome)."""
    if device is not None:
        return np.asarray(device.matmul_stripes(np.asarray(M), np.stack(rows)))
    if gf.degree in (8, 16):
        from noise_ec_tpu_torch.shim import gf16_matmul_rows, gf_matmul_rows

        fn = gf_matmul_rows if gf.degree == 8 else gf16_matmul_rows
        return fn(np.asarray(M), rows, rows[0].size)
    return gf.matvec_stripes(
        np.asarray(M, dtype=np.int64), np.stack(rows)
    ).astype(gf.dtype)


def _independent_rows(gf: GF, B: np.ndarray) -> Optional[list[int]]:
    """Indices of linearly independent rows spanning B's column space,
    one per column (B must have full column rank — guaranteed for error
    signature matrices of MDS codes, where any <= m-k columns of the
    parity check are independent)."""
    r2, t = B.shape
    M = np.asarray(B, dtype=np.int64).copy()
    chosen: list[int] = []
    used: set[int] = set()
    for col in range(t):
        piv = next(
            (rr for rr in range(r2) if rr not in used and M[rr, col]), None
        )
        if piv is None:
            return None
        used.add(piv)
        chosen.append(piv)
        M[piv] = gf.div(M[piv], M[piv, col]).astype(np.int64)
        factors = M[:, col].copy()
        factors[piv] = 0
        M ^= gf.mul(factors[:, None], M[piv][None, :]).astype(np.int64)
    return chosen


def _solve_support_gathered(
    gf: GF,
    A: np.ndarray,
    r2: int,
    k: int,
    T,
    scols: np.ndarray,
    cols: np.ndarray,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Solve and verify error support ``T`` over gathered syndrome columns.

    ``scols`` is the (r2, nbad) gathered syndrome; ``cols`` indexes the
    still-unresolved subset to work on. Builds the signature matrix B_T
    (A-columns for basis rows, unit vectors for extra rows), solves z from
    |T| independent syndrome rows, verifies the remaining rows. Returns
    (ok_mask over ``cols``, z) — or None when B_T is rank-deficient (its
    reachable syndromes are covered by a strict subset of T). Shared by
    the MDS decoder's shared-support rounds and the generic
    support-enumeration decoder so the two stay in lockstep.
    """
    size = len(T)
    B = np.zeros((r2, size), dtype=gf.dtype)
    for ci, trow in enumerate(T):
        if trow < k:
            B[:, ci] = A[:, trow]
        else:
            B[trow - k, ci] = 1
    P = _independent_rows(gf, B)
    if P is None:
        return None
    W = gf_inv(gf, B[P])
    z = _matmul_rows(
        gf, W, [np.ascontiguousarray(scols[p][cols]) for p in P]
    )
    Q = [i for i in range(r2) if i not in set(P)]
    if Q:
        _, c2 = _syndrome(
            gf, B[Q],
            list(z) + [np.ascontiguousarray(scols[q][cols]) for q in Q],
            size, want_s=False,
        )
        ok = c2 == 0
    else:
        ok = np.ones(len(cols), dtype=bool)
    return ok, z


def _single_supports_batch(
    gf: GF, A: np.ndarray, k: int, sc64: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-column single BASIS-row supports for a batch of syndrome
    columns, in one algebra pass over the (r2, nb) batch.

    Returns ``(jstar, Z)``: ``jstar[c]`` is the basis row whose single
    error explains column c in FULL (the candidate magnitude
    Z[c, jstar[c]] = sigma[p0]/A[p0, j] predicts sigma on EVERY check
    row), or -1 when no single basis row does. The full-row match IS the
    verification — a column with jstar >= 0 needs no further solve.
    Extra-row singles are the caller's concern (they cannot appear among
    radius-flagged columns: a single extra-row error gives count 1 <= e).
    The ONE implementation behind both the scalar discovery helper and
    the gathered classification pass, so the support algebra cannot
    diverge between them.
    """
    r2, nb = sc64.shape
    p0 = np.argmax(sc64 != 0, axis=0)
    s_p0 = sc64[p0, np.arange(nb)]
    A64 = np.asarray(A, dtype=np.int64)
    Ap0 = A64[p0]  # (nb, k): row p0_c of A per column
    valid = Ap0 != 0
    Z = np.zeros((nb, k), dtype=np.int64)
    if valid.any():
        Z[valid] = np.asarray(gf.div(
            np.broadcast_to(s_p0[:, None], (nb, k))[valid], Ap0[valid],
        ), dtype=np.int64)
    pred = np.asarray(
        gf.mul(A64[:, None, :], Z[None, :, :]), dtype=np.int64
    )  # (r2, nb, k)
    match = valid & (pred == sc64[:, :, None]).all(axis=0)
    has = match.any(axis=1)
    jstar = np.where(has, np.argmax(match, axis=1), -1)
    return jstar, Z


def _single_support_from_sigma(
    gf: GF, A: np.ndarray, k: int, sigma: np.ndarray
) -> Optional[frozenset]:
    """The unique single-received-row error support explaining syndrome
    column ``sigma`` (s = B_T @ z with \\|T\\| = 1), or None when no single
    row explains it (two-plus-row supports and beyond-radius columns both
    return None — callers fall back to the per-column Berlekamp-Welch).

    Pure syndrome algebra, no GRS structure needed: an error z in basis
    row j produces sigma = A[:, j] * z (proportionality, checked over all
    check rows at once); an error in extra row p produces sigma = z * e_p
    (exactly one nonzero). Uniqueness for \\|T\\| <= e follows from any
    2e <= m - k columns of [A | I] being independent (MDS dual). Replaces
    a ~1.5 ms pure-Python BW solve with a few vectorized ops on (r2, k)
    arrays — the discovery step runs once per corruption pattern but sat
    on the decode latency path.
    """
    sig = np.asarray(sigma, dtype=np.int64)
    nz = np.flatnonzero(sig)
    if nz.size == 0:
        return frozenset()
    if nz.size == 1:
        return frozenset([k + int(nz[0])])
    jstar, _ = _single_supports_batch(gf, A, k, sig[:, None])
    if jstar[0] >= 0:
        return frozenset([int(jstar[0])])
    return None


def _column_error_support(
    gf: GF, kind: str, k: int, n: int, nums: list[int], colvals: np.ndarray
) -> Optional[frozenset]:
    """Received-row indices in error at one column, via a full per-column
    Berlekamp-Welch solve in the normalized GRS domain; None when the
    column is beyond the unique-decoding radius."""
    N = grs_normalizers(gf, kind, k, n)
    xs = np.asarray(nums, dtype=np.int64)
    R = gf.mul(N[xs], colvals).astype(np.int64)
    f = bw_correct_column(gf, xs, R, k)
    if f is None:
        return None
    diff = poly_eval(gf, f, xs).astype(np.int64) != R
    return frozenset(np.flatnonzero(diff).tolist())


def _data_from_coeffs(
    gf: GF, kind: str, k: int, n: int, f: np.ndarray
) -> np.ndarray:
    """One column's k output symbols from its message polynomial: the
    coefficients themselves for ``vandermonde_raw``, f(j)/N_j at the data
    positions for the systematic kinds."""
    if kind == "vandermonde_raw":
        out = np.zeros(k, dtype=gf.dtype)
        out[: len(f)] = f[:k]
        return out
    N = grs_normalizers(gf, kind, k, n)
    pts = np.arange(k, dtype=np.int64)
    vals = poly_eval(gf, f, pts).astype(np.int64)
    return gf.mul(vals, gf.inv(N[:k]).astype(np.int64)).astype(gf.dtype)


# Gather bad columns into a compact sub-problem below this count; above it
# the full-width path (one masked pass over every column) wins because the
# gather/scatter traffic exceeds the extra matmul width.
_GATHER_CAP = 1 << 16

# Speculative fused single-row decode: probe this many leading BYTES'
# worth of columns; if most are bad and one received basis row explains
# the sampled ones, run the one-pass fused kernel over the full width.
# Only worth arming above _SPECULATE_MIN_S (below it the generic path's
# extra passes are cheap). Both thresholds are BYTE budgets — the
# pass-cost they model scales with bytes moved — while ``rows[0].size``
# counts SYMBOLS, so the gate must scale by the field's symbol width
# (without it, GF(2^16) armed at 2x the intended threshold and probed 2x
# the intended prefix).
_PROBE_S = 32 << 10
_SPECULATE_MIN_S = 256 << 10


def _probe_symbols(gf: "GF") -> int:
    """_PROBE_S expressed in this field's symbols."""
    return _PROBE_S // np.dtype(gf.dtype).itemsize


def _speculate_min_symbols(gf: "GF") -> int:
    """_SPECULATE_MIN_S expressed in this field's symbols."""
    return _SPECULATE_MIN_S // np.dtype(gf.dtype).itemsize


def _try_fused_single_row(
    gf: GF,
    k: int,
    nums: list[int],
    rows: list,
    Gb_inv: np.ndarray,
    A: np.ndarray,
    e: int,
    systematic: bool,
    recurse,
    device=None,
):
    """Speculative whole-share decode: one fused pass when a single basis
    row explains the corruption.

    Whole-share corruption — the reference's dominant corruption mode (a
    peer ships one bad share; infectious Decode corrects it,
    main.go:77) — makes EVERY column bad with the same single-row
    support. The generic path then materializes the (m-k, S) syndrome and
    runs solve + verify + apply passes over the full width (~25 MiB of
    traffic for RS(10,4) at 1 MiB shards). This path instead probes a
    prefix, and when the probe says "mostly bad, one basis row explains
    it" runs the shim's rs_decode1_fused: syndrome + solve + verify +
    apply in ONE tiled pass (~16 MiB), never materializing the syndrome.
    Columns the hypothesis cannot explain are gathered and re-decoded
    through ``recurse`` (the caller's generic machinery — exact,
    per-column; MDS and par1 callers pass their own decoder so the
    per-column guarantee matches the caller's contract).

    On the DEVICE route the same speculation runs the decode1 fold
    (ops/dispatch.decode1_fold_matrix) instead of the shim: corrected
    row + rank-1 consistency rows as ONE generator-shaped device matmul
    — the same kernels as encode. Columns whose consistency rows are
    nonzero defeated the hypothesis
    and recurse exactly like the shim path's ``state == 2`` columns.

    Returns NotImplemented when the speculation does not apply (caller
    runs the generic path), None when a gathered leftover column is
    beyond the decoding radius, or the (data_rows, touched, corrected)
    result.
    """
    S = rows[0].size
    probe = min(_probe_symbols(gf), S)
    res = _syndrome(gf, A, [r_[:probe] for r_ in rows], k)
    s_p, counts_p = res
    bad_p = np.flatnonzero(counts_p > e)
    if bad_p.size * 2 < probe:
        return NotImplemented
    j: Optional[int] = None
    for col in (bad_p[0], bad_p[bad_p.size // 2], bad_p[-1]):
        supp = _single_support_from_sigma(gf, A, k, s_p[:, col])
        if supp is None or len(supp) != 1:
            return NotImplemented
        (cand,) = supp
        if cand >= k or (j is not None and cand != j):
            return NotImplemented
        j = cand
    if device is not None:
        from noise_ec_tpu_torch.ops.dispatch import decode1_fold_matrix

        try:
            Dm = decode1_fold_matrix(gf, A, j)
        except ValueError:  # < 2 check rows: no verify behind the fold
            return NotImplemented
        out = np.asarray(device.matmul_stripes(Dm, np.stack(rows)))
        out_row = np.ascontiguousarray(out[0])
        # Any nonzero consistency byte defeats the hypothesis there —
        # same column contract as the shim's state == 2.
        state = (out[1:] != 0).any(axis=0).astype(np.uint8) * 2
    else:
        from noise_ec_tpu_torch.shim import gf16_decode1_fused, gf_decode1_fused

        fused_fn = gf_decode1_fused if gf.degree == 8 else gf16_decode1_fused
        fused = fused_fn(A, rows[:k], rows[k:], j, e, S)
        if fused is None:
            return NotImplemented
        out_row, state = fused
    corrections: dict[int, list] = {j: [("replace", out_row)]}
    overrides = {}
    leftover = np.flatnonzero(state == 2)
    if leftover.size:
        sub_rows = [np.ascontiguousarray(r_[leftover]) for r_ in rows]
        sub = recurse(sub_rows)
        if sub is None:
            return None
        sub_data, _, _ = sub
        overrides = (leftover, np.stack(sub_data))
    return _emit_data_rows(
        gf, k, nums, rows, corrections, overrides, Gb_inv, systematic
    )


def _maybe_fused_single_row(
    gf: GF,
    k: int,
    nums: list[int],
    rows: list,
    Gb_inv: np.ndarray,
    A: np.ndarray,
    e: int,
    systematic: bool,
    recurse,
    device,
    speculate: bool,
):
    """One owner for the speculation gate shared by both decoders: arm the
    fused path only on wide decodes (both shim fields; the device route
    arms at the same byte budget — one device pass beats materializing
    the syndrome there too) with correction actually permitted (callers
    fold contract knobs like max_support into ``speculate``).
    NotImplemented = generic path."""
    if not (
        speculate and e >= 1
        and gf.degree in (8, 16)
        and rows[0].size >= _speculate_min_symbols(gf)
    ):
        return NotImplemented
    return _try_fused_single_row(
        gf, k, nums, rows, Gb_inv, A, e, systematic, recurse,
        device=device,
    )

# (field degree, kind, k, n, received numbers) -> (inv(G[basis]), A).
# Geometry and arrival pattern recur per stream/bench (the reference's
# geometry rides in every message and is stable per sender), and the k x k
# inversion plus the A product are per-decode host algebra worth skipping.
_PLAN_CACHE: dict[tuple, tuple[np.ndarray, Optional[np.ndarray]]] = {}


def _decode_plan(
    gf: GF, kind: str, k: int, n: int, nums: list[int], G: np.ndarray
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    # The generator bytes are part of the key: callers may supply their own
    # G (and fields of one degree can use different polynomials), and a
    # plan inverted from a different matrix would decode to wrong bytes.
    key = (
        gf.degree, getattr(gf, "poly", None), kind, k, n, tuple(nums),
        np.ascontiguousarray(G).tobytes(),
    )
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        Gb_inv = gf_inv(gf, G[nums[:k]])
        A = None
        if len(nums) > k:
            A = gf.matvec_stripes(
                np.asarray(G[nums[k:]], dtype=np.int64),
                np.asarray(Gb_inv, dtype=np.int64),
            ).astype(gf.dtype)
        if len(_PLAN_CACHE) > 512:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = (Gb_inv, A)
        hit = (Gb_inv, A)
    return hit


def syndrome_decode_rows(
    gf: GF,
    kind: str,
    k: int,
    n: int,
    nums: list[int],
    rows: list,
    *,
    G: Optional[np.ndarray] = None,
    device=None,
    _speculate: bool = True,
) -> Optional[tuple[list[np.ndarray], list[bool], bool]]:
    """Error-correcting decode of m received stripe rows, syndrome-first.

    The polynomial-time replacement for per-column Berlekamp-Welch as the
    *bulk* algorithm, with the same unique-decoding radius floor((m-k)/2)
    per column — the guarantee infectious's ``Decode`` gives the reference
    at main.go:77. Structure:

    1. ONE (m-k) x k parity-check product ``s = A @ basis ^ extra`` with
       ``A = G[extra] @ inv(G[basis])`` flags the bad columns: a column
       whose basis-decode disagrees with at most e = floor((m-k)/2)
       received rows IS the unique codeword (distinct codewords differ in
       >= m-k+1 > 2e rows), so columns with counts <= e are done — and for
       a systematic basis their data rows are the received buffers,
       zero-copy.
    2. The error *support* T is discovered once per corruption pattern
       (per-column BW on one bad column), and the error *magnitudes* come
       from the syndrome itself: s = B_T @ z where B_T stacks A-columns
       (basis rows) and unit vectors (extra rows), so z solves from |T|
       independent syndrome rows and the remaining rows verify the
       hypothesis — small matmuls, no re-interpolation over the payload.
       Any <= m-k columns of B are independent (punctured MDS duals are
       MDS), so the solve is exact whenever |T| <= e.
    3. Corrections are row XORs (``data ^= z`` at verified bad columns);
       only columns that defeat every shared support fall to the
       per-column BW loop.

    Returns (data_rows, touched, corrected) — ``touched[j]`` False means
    row j is the caller's own received buffer, untouched (callers can emit
    the original bytes without a copy); ``corrected`` is True when error
    correction actually fired — or None when some column is beyond the
    radius. Row count m may exceed n only through duplicate share numbers,
    which callers must have deduplicated.
    """
    m = len(rows)
    if len(nums) != m:
        raise ValueError(f"{m} rows but {len(nums)} share numbers")
    if m < k:
        raise ValueError(f"need >= {k} rows, got {m}")
    S = rows[0].size
    if any(r.size != S for r in rows):
        raise ValueError("stripe lengths differ")
    nums = [int(x) for x in nums]
    grs_normalizers(gf, kind, k, n)  # raises for kinds with no GRS form
    if G is None:
        from noise_ec_tpu_torch.matrix.generators import generator_matrix

        G = generator_matrix(gf, k, n, kind)
    e = (m - k) // 2
    r2 = m - k
    Gb_inv, A = _decode_plan(gf, kind, k, n, nums, G)
    systematic = kind != "vandermonde_raw" and np.array_equal(
        np.asarray(G[:k]), np.eye(k, dtype=np.asarray(G).dtype)
    )
    res = _maybe_fused_single_row(
        gf, k, nums, rows, Gb_inv, A, e, systematic,
        lambda sub: syndrome_decode_rows(
            gf, kind, k, n, nums, sub, G=G, _speculate=False
        ),
        device, _speculate,
    )
    if res is not NotImplemented:
        return res
    s = None
    # received-row index -> pending XOR deltas; column -> solved (k,) output
    corrections: dict[int, list] = {}
    overrides: dict[int, np.ndarray] = {}
    if r2:
        s, counts = _syndrome(gf, A, rows, k, device=device)
        rem_mask = counts > e
        nrem = int(np.count_nonzero(rem_mask))
        if nrem:
            if e == 0:
                return None  # any inconsistency is beyond the radius
            if nrem <= _GATHER_CAP:
                # Vectorized single-support classification of EVERY
                # gathered bad column at once: one algebra pass finds
                # each column's single-row explanation (if any), and one
                # gathered solve per distinct support group applies it —
                # so scattered corruption across several shares resolves
                # in a single round instead of one discovery + solve
                # round per support. Columns no single row explains fall
                # through to the shared-support rounds below unchanged.
                remaining = np.flatnonzero(rem_mask)
                nb = remaining.size
                # Chunked: the classification's (r2, chunk, k) temporaries
                # must stay bounded for large geometries at the gather cap
                # (a full-width (64, 65536, 96) int64 batch would be GBs).
                chunk = max(512, (1 << 24) // max(1, r2 * k))
                for lo in range(0, nb, chunk):
                    idx = remaining[lo : lo + chunk]
                    sc64 = np.ascontiguousarray(
                        s[:, idx]
                    ).astype(np.int64)
                    jstar, Z = _single_supports_batch(gf, A, k, sc64)
                    for j_s in np.unique(jstar[jstar >= 0]):
                        cols_j = np.flatnonzero(jstar == j_s)
                        okcols = idx[cols_j]
                        # The full-row match in _single_supports_batch IS
                        # the verification (Z predicts sigma on every
                        # check row), so the correction applies directly
                        # — no second solve/verify pass.
                        corrections.setdefault(int(j_s), []).append(
                            ("sparse", okcols,
                             Z[cols_j, j_s].astype(gf.dtype))
                        )
                        rem_mask[okcols] = False
                        nrem -= int(okcols.size)
            T: list[int] = []
            for _round in range(e + 1):
                if not nrem:
                    break
                col = int(np.argmax(rem_mask))  # first still-bad column
                # Single-row supports resolve from the syndrome column in
                # a few vectorized ops; only multi-row supports pay the
                # per-column Berlekamp-Welch solve.
                supp = _single_support_from_sigma(gf, A, k, s[:, col])
                if supp is None:
                    colvals = np.array(
                        [int(r_[col]) for r_ in rows], dtype=np.int64
                    )
                    supp = _column_error_support(gf, kind, k, n, nums, colvals)
                if supp is None:
                    return None
                new_T = sorted(set(T) | supp)
                if not supp or len(new_T) > e:
                    break  # shared-support model exhausted -> per-column
                T = new_T
                t = len(T)
                if nrem <= _GATHER_CAP:
                    remaining = np.flatnonzero(rem_mask)
                    scols = np.ascontiguousarray(s[:, remaining])
                    solved = _solve_support_gathered(
                        gf, A, r2, k, T, scols, np.arange(remaining.size)
                    )
                    if solved is None:
                        break
                    ok, z = solved
                    if not ok.any():
                        break
                    okcols = remaining[ok]
                    for ci, trow in enumerate(T):
                        corrections.setdefault(trow, []).append(
                            ("sparse", okcols, z[ci][ok].astype(gf.dtype))
                        )
                    rem_mask[okcols] = False
                    nrem -= int(okcols.size)
                    continue
                B = np.zeros((r2, t), dtype=gf.dtype)
                for ci, trow in enumerate(T):
                    if trow < k:
                        B[:, ci] = A[:, trow]
                    else:
                        B[trow - k, ci] = 1
                P = _independent_rows(gf, B)
                if P is None:
                    break
                W = gf_inv(gf, B[P])
                Q = [i for i in range(r2) if i not in set(P)]
                # Full-width pass: index materialization over millions
                # of bad columns (whole-share corruption makes every
                # column bad) costs more than operating on the masks.
                z = _matmul_rows(gf, W, [s[p] for p in P], device=device)
                if Q:
                    _, c2 = _syndrome(
                        gf, B[Q], list(z) + [s[q] for q in Q], t,
                        want_s=False, device=device,
                    )
                    apply_mask = rem_mask & (c2 == 0)
                else:
                    apply_mask = rem_mask.copy()
                napply = int(np.count_nonzero(apply_mask))
                if napply == 0:
                    break
                for ci, trow in enumerate(T):
                    delta = (
                        z[ci].astype(gf.dtype, copy=False)
                        if napply == S
                        else np.where(apply_mask, z[ci], 0).astype(gf.dtype)
                    )
                    corrections.setdefault(trow, []).append(("full", delta))
                if napply == nrem:
                    nrem = 0
                else:
                    rem_mask &= ~apply_mask
                    nrem -= napply
            # Columns no shared support explains: full per-column solves.
            if nrem:
                N = grs_normalizers(gf, kind, k, n)
                xs = np.asarray(nums, dtype=np.int64)
                for col in np.flatnonzero(rem_mask):
                    colvals = np.array(
                        [int(r_[col]) for r_ in rows], dtype=np.int64
                    )
                    f = bw_correct_column(
                        gf, xs, gf.mul(N[xs], colvals).astype(np.int64), k
                    )
                    if f is None:
                        return None
                    overrides[int(col)] = _data_from_coeffs(gf, kind, k, n, f)

    return _emit_data_rows(
        gf, k, nums, rows, corrections, overrides, Gb_inv, systematic,
        device=device,
    )


def _emit_data_rows(
    gf: GF,
    k: int,
    nums: list[int],
    rows: list,
    corrections: dict,
    overrides,  # dict {col: (k,) values} | tuple (cols, (k, ncols) values)
    Gb_inv: np.ndarray,
    systematic: bool,
    *,
    device=None,
) -> tuple[list[np.ndarray], list[bool], bool]:
    """Assemble the k output rows from received rows + pending fixes.

    ``overrides`` carries whole-column replacements in either shape: the
    per-column BW loop passes a dict {col: (k,) data values}; the fused
    path passes (cols_array, (k, ncols) values) precomputed in bulk.

    Shared by the MDS and generic syndrome decoders. The zero-copy
    passthrough requires every data share to sit in the BASIS (the first
    k received rows), not merely to be present: the clean-column argument
    proves error-free BASIS rows only (an error in a basis row forces
    counts > e), while an extra-block row can be wrong at a column whose
    count is still <= e — emitting such a data row untouched would return
    corrupt bytes inside the decoding radius. Data shares in the extra
    block take the general path, which decodes from the
    (error-free-at-clean-columns) corrected basis.
    """
    ov_cols = ov_vals = None
    if isinstance(overrides, tuple):
        # (cols, (k, ncols) values) — the fused path's gathered re-decode.
        ov_cols, ov_vals = overrides
    elif overrides:
        ov_cols = np.fromiter(overrides.keys(), dtype=np.int64)
        ov_vals = np.stack([overrides[int(c)] for c in ov_cols], axis=1)

    def corrected(i: int, force_copy: bool = False) -> tuple[np.ndarray, bool]:
        """Row i with its pending deltas applied; (array, was_touched)."""
        out: Optional[np.ndarray] = None
        for entry in corrections.get(i, ()):
            if entry[0] == "replace":
                # A fully-corrected buffer the caller owns (fused kernel
                # output) — the base for any further deltas.
                out = entry[1]
            elif entry[0] == "full":
                out = (rows[i] if out is None else out) ^ entry[1]
            else:
                _, cols, vals = entry
                if out is None:
                    out = rows[i].copy()
                out[cols] ^= vals
        if out is None:
            if force_copy:
                return rows[i].copy(), False
            return rows[i], False
        return out, True

    pos_of: dict[int, int] = {}
    for i, num in enumerate(nums):
        pos_of.setdefault(num, i)
    if systematic and all(pos_of.get(j, k) < k for j in range(k)):
        data_rows: list[np.ndarray] = []
        touched: list[bool] = []
        for j in range(k):
            row, was = corrected(pos_of[j], force_copy=ov_cols is not None)
            if ov_cols is not None:
                row[ov_cols] = ov_vals[j]
                was = True
            data_rows.append(row)
            touched.append(was)
        return data_rows, touched, bool(corrections or overrides)
    # General path (missing data positions, or an evaluation code): decode
    # the message from the corrected basis rows — clean columns have
    # error-free basis rows (an error there forces counts > e), corrected
    # columns were restored above, override columns are overwritten below.
    base = [corrected(i)[0] for i in range(k)]
    data = _matmul_rows(gf, Gb_inv, base, device=device)
    if ov_cols is not None:
        data[:, ov_cols] = ov_vals
    return list(data), [True] * k, bool(corrections or overrides)


def syndrome_decode_rows_any(
    gf: GF,
    G: np.ndarray,
    k: int,
    nums: list[int],
    rows: list,
    *,
    max_support: Optional[int] = None,
    device=None,
    _speculate: bool = True,
) -> Optional[tuple[list[np.ndarray], list[bool], bool]]:
    """Support-enumeration syndrome decode for ANY linear code.

    The MDS decoder (:func:`syndrome_decode_rows`) discovers error
    supports with a per-column Berlekamp-Welch solve, which needs the GRS
    structure. Non-MDS constructions (par1 — the reason this exists) get
    the same syndrome machinery with the support found by ENUMERATION:
    for each candidate error-row set T with \\|T\\| <= ``max_support``,
    solve ``B_T z = s`` from independent syndrome rows and verify the
    rest — polynomial (C(m, max_support) small solves over the bad
    columns) where the previous consistent-subset search was exponential
    in k.

    Guarantee matches the subset search it replaces, not unique decoding:
    the returned word agrees with >= m - e received rows per column
    (e = floor((m-k)/2)); a non-MDS code may admit several such words and
    this picks one, exactly as the subset search did. Returns None when a
    bad column has no explanation within ``max_support`` errors (or the
    first-k basis is singular) — the caller falls back to the subset
    search. ``max_support`` defaults adaptively: the largest t with
    C(m, 1) + ... + C(m, t) candidate supports under ~10k solves (never
    below min(e, 2)), so geometries with many redundant shares correct
    within their full radius in polynomial time instead of silently
    capping at 2.
    """
    import itertools
    import math

    m = len(rows)
    if m < k or len(nums) != m:
        raise ValueError(f"need >= {k} rows with matching nums, got {m}")
    S = rows[0].size
    if any(r_.size != S for r_ in rows):
        raise ValueError("stripe lengths differ")
    nums = [int(x) for x in nums]
    e = (m - k) // 2
    r2 = m - k
    if max_support is None:
        max_support, total = 0, 0
        while max_support < e:
            c = math.comb(m, max_support + 1)
            if total + c > 10_000:
                break
            total += c
            max_support += 1
        max_support = max(max_support, min(e, 2))
    try:
        Gb_inv = gf_inv(gf, np.asarray(G)[nums[:k]])
    except np.linalg.LinAlgError:
        return None  # singular basis (possible off-MDS): caller falls back
    systematic = np.array_equal(
        np.asarray(G)[:k], np.eye(k, dtype=np.asarray(G).dtype)
    )
    corrections: dict[int, list] = {}
    if r2:
        A = gf.matvec_stripes(
            np.asarray(np.asarray(G)[nums[k:]], dtype=np.int64),
            np.asarray(Gb_inv, dtype=np.int64),
        ).astype(gf.dtype)
        # Same speculative whole-share fast path as the MDS decoder; the
        # per-column guarantee (agree with >= m - e rows) is exactly this
        # decoder's contract, and unexplained columns recurse into the
        # generic enumeration below. For par1 this replaces a full-width
        # gather + per-candidate solves with one fused pass. max_support
        # gates it too: a caller that forbids corrections (max_support=0)
        # must get the documented None, not a speculative fix.
        res = _maybe_fused_single_row(
            gf, k, nums, rows, Gb_inv, A, e, systematic,
            lambda sub: syndrome_decode_rows_any(
                gf, G, k, nums, sub, max_support=max_support,
                _speculate=False,
            ),
            device, _speculate and max_support >= 1,
        )
        if res is not NotImplemented:
            return res
        s, counts = _syndrome(gf, A, rows, k, device=device)
        bad_idx = np.flatnonzero(counts > e)
        if bad_idx.size:
            if e == 0:
                return None
            scols = np.ascontiguousarray(s[:, bad_idx])
            unresolved = np.ones(bad_idx.size, dtype=bool)
            for size in range(1, max_support + 1):
                if not unresolved.any():
                    break
                for T in itertools.combinations(range(m), size):
                    if not unresolved.any():
                        break
                    cols = np.flatnonzero(unresolved)
                    solved = _solve_support_gathered(
                        gf, A, r2, k, T, scols, cols
                    )
                    if solved is None:
                        # rank-deficient support: its reachable syndromes
                        # are covered by a strict subset already tried.
                        continue
                    ok, z = solved
                    if not ok.any():
                        continue
                    okcols = bad_idx[cols[ok]]
                    for ci, trow in enumerate(T):
                        corrections.setdefault(trow, []).append(
                            ("sparse", okcols, z[ci][ok].astype(gf.dtype))
                        )
                    unresolved[cols[ok]] = False
            if unresolved.any():
                return None
    return _emit_data_rows(
        gf, k, nums, rows, corrections, {}, Gb_inv, systematic,
        device=device,
    )


def bw_decode_stripes(
    gf: GF,
    kind: str,
    k: int,
    n: int,
    nums: list[int],
    stripes: np.ndarray,
) -> Optional[np.ndarray]:
    """Decode (m, S) received stripes at share numbers ``nums`` -> (k, S) data.

    Array-in/array-out wrapper over :func:`syndrome_decode_rows` (same
    radius, same reference contract — infectious Decode, main.go:77).
    For ``vandermonde_raw`` the returned rows are f's coefficients (the
    code's message is the coefficient vector); for the systematic kinds
    they are the data shards.
    """
    stripes = np.asarray(stripes)
    rows = [np.ascontiguousarray(stripes[i]) for i in range(stripes.shape[0])]
    res = syndrome_decode_rows(gf, kind, k, n, list(nums), rows)
    if res is None:
        return None
    data_rows, _, _ = res
    return np.stack(data_rows).astype(gf.dtype)
