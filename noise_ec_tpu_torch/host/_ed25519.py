"""Pure-Python Ed25519 (RFC 8032) — the no-dependency fallback backend.

host/crypto.py prefers the ``cryptography`` package (OpenSSL: fast and
constant-time); this module keeps the host layer *functional* when that
wheel is absent (hermetic CI images, minimal containers) so the loopback
harness, transports and the observability round-trip tests still run.

Bit-identical output to the RFC 8032 test vectors (pinned in
tests/test_host_crypto.py). NOT constant-time — Python big-int arithmetic
leaks timing — so crypto.py logs a warning once when this backend is
active; production deployments install ``cryptography``
(requirements-test.txt).

Performance: the generic double-and-add costs ~2.5 ms per scalar
multiplication on a current x86 core (sign ≈ 3 ms, verify ≈ 6 ms). The
wire hot loop (docs/design.md §15) cannot live with that, so three
amortizations sit on top of the same field arithmetic:

- a windowed fixed-base table for ``B`` (built once, lazily): a base
  mult becomes ~32 table adds, which is what every sign and half of
  every verify pays;
- per-public-key power tables behind a bounded LRU
  (:func:`_verify_key`): a node verifies a small stable peer set, so
  the 256 doublings of ``k*A`` are paid once per key, not per frame;
- :func:`verify_batch` — true Ed25519 batch verification: one random
  linear combination ``(Σ zᵢSᵢ)·B == Σ zᵢRᵢ + Σ (zᵢkᵢ)·A`` checked
  with a shared-doubling multi-scalar multiplication, so a cohort of
  frames shares one pass of doublings (and, for the common one-sender
  cohort, ONE table mult of ``A``). A failing batch falls back to
  per-item verification, so the accept set is exactly the per-item
  accept set: one bad signature never poisons its cohort, and the
  only divergence is a 2^-128 false batch accept (standard RLC bound).

Still NOT constant-time either way — production installs
``cryptography``.
"""

from __future__ import annotations

import hashlib
import os
import threading

__all__ = ["public_from_seed", "sign", "verify", "verify_batch"]

_p = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493


def _inv(x: int) -> int:
    return pow(x, _p - 2, _p)


_d = -121665 * _inv(121666) % _p
_I = pow(2, (_p - 1) // 4, _p)
_By = 4 * _inv(5) % _p


def _recover_x(y: int, sign_bit: int) -> int | None:
    if y >= _p:
        return None
    x2 = (y * y - 1) * _inv(_d * y * y + 1) % _p
    x = pow(x2, (_p + 3) // 8, _p)
    if (x * x - x2) % _p:
        x = x * _I % _p
    if (x * x - x2) % _p:
        return None
    if x == 0 and sign_bit:
        return None
    if x & 1 != sign_bit:
        x = _p - x
    return x


# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
_Bx = _recover_x(_By, 0)
_B = (_Bx, _By, 1, _Bx * _By % _p)
_ZERO = (0, 1, 1, 0)


def _add(P, Q):
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    A = (Y1 - X1) * (Y2 - X2) % _p
    B = (Y1 + X1) * (Y2 + X2) % _p
    C = 2 * T1 * _d * T2 % _p
    D = 2 * Z1 * Z2 % _p
    E, F, G, H = B - A, D - C, D + C, B + A
    return (E * F % _p, G * H % _p, F * G % _p, E * H % _p)


def _mult(P, s: int):
    Q = _ZERO
    while s:
        if s & 1:
            Q = _add(Q, P)
        P = _add(P, P)
        s >>= 1
    return Q


def _compress(P) -> bytes:
    X, Y, Z, _ = P
    zi = _inv(Z)
    x, y = X * zi % _p, Y * zi % _p
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    if len(data) != 32:
        return None
    val = int.from_bytes(data, "little")
    y = val & ((1 << 255) - 1)
    x = _recover_x(y, val >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % _p)


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254)


def _hash_to_scalar(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little") % _L


def _points_equal(P, Q) -> bool:
    """Projective equality x1/z1 == x2/z2 ∧ y1/z1 == y2/z2 — two cross
    multiplications instead of the two field inversions a compressed
    compare pays."""
    X1, Y1, Z1, _ = P
    X2, Y2, Z2, _ = Q
    return (
        (X1 * Z2 - X2 * Z1) % _p == 0 and (Y1 * Z2 - Y2 * Z1) % _p == 0
    )


# ------------------------------------------------------- table scalar mult
#
# A windowed table for point P holds T[j][v] = (v << (w*j)) * P for every
# w-bit window j and digit v in 1..2^w-1, so P*s is one add per nonzero
# window digit — no doublings at mult time. Build cost is ~one generic
# scalar mult, so a table pays for itself on its second use.

_SCALAR_BITS = 256  # S < L < 2^253, but clamped scalars set bit 254


def _window_table(P, w: int):
    rows = []
    base = P  # (1 << (w * j)) * P
    span = (1 << w) - 1
    for _ in range((_SCALAR_BITS + w - 1) // w):
        row = [None] * (span + 1)
        acc = base
        row[1] = acc
        for v in range(2, span + 1):
            acc = _add(acc, base)
            row[v] = acc
        rows.append(row)
        for _ in range(w):
            base = _add(base, base)
    return rows


def _mult_table(rows, w: int, s: int):
    acc = _ZERO
    mask = (1 << w) - 1
    j = 0
    while s:
        v = s & mask
        if v:
            acc = _add(acc, rows[j][v])
        s >>= w
        j += 1
    return acc


_B_W = 8  # 32 windows; a base mult is <= 32 adds
_B_TABLE = None
_table_lock = threading.Lock()


def _base_table():
    global _B_TABLE
    if _B_TABLE is None:
        with _table_lock:
            if _B_TABLE is None:
                _B_TABLE = _window_table(_B, _B_W)
    return _B_TABLE


def _mult_base(s: int):
    return _mult_table(_base_table(), _B_W, s)


class VerifyKey:
    """Decompressed public key with lazily built, tiered mult tables.

    Tier 0 (first use): generic double-and-add — a key seen once, e.g.
    fleet-scale identity churn, pays nothing extra. Tier 1 (second
    use): ``pows[i] = 2^i * A`` (build ≈ one mult), making ``k*A``
    ~128 adds with zero doublings. Tier 2 (a hot peer,
    ``_W4_AFTER_USES``): a 4-bit window table — one add per nonzero
    window digit, ~63 adds per mult — amortized across the thousands of
    verifies a stable peer sends."""

    __slots__ = ("point", "_pows", "_w4", "_uses")

    _W4_AFTER_USES = 16

    def __init__(self, point):
        self.point = point
        self._pows = None
        self._w4 = None
        self._uses = 0

    def mult(self, s: int):
        self._uses += 1
        if self._w4 is not None:
            return _mult_table(self._w4, 4, s)
        if self._pows is None:
            if self._uses < 2:
                return _mult(self.point, s)
            pows = []
            P = self.point
            for _ in range(_SCALAR_BITS):
                pows.append(P)
                P = _add(P, P)
            self._pows = pows
        if self._uses >= self._W4_AFTER_USES:
            self._w4 = _window_table(self.point, 4)
            return _mult_table(self._w4, 4, s)
        acc = _ZERO
        i = 0
        pows = self._pows
        while s:
            if s & 1:
                acc = _add(acc, pows[i])
            s >>= 1
            i += 1
        return acc


# Parsed-key LRU: a node talks to a bounded peer set; hostile identity
# churn past the cap falls back to table-less keys (correct, slower).
_VERIFY_KEYS: dict[bytes, VerifyKey] = {}
_VERIFY_KEYS_MAX = 128


def _verify_key(public_key: bytes):
    """VerifyKey for ``public_key`` via the LRU, or None if the bytes do
    not decode to a curve point."""
    with _table_lock:
        vk = _VERIFY_KEYS.get(public_key)
    if vk is not None:
        return vk
    A = _decompress(public_key)
    if A is None:
        return None
    vk = VerifyKey(A)
    with _table_lock:
        if len(_VERIFY_KEYS) >= _VERIFY_KEYS_MAX:
            _VERIFY_KEYS.pop(next(iter(_VERIFY_KEYS)))
        _VERIFY_KEYS[public_key] = vk
    return vk


def _msm(pairs):
    """Σ sᵢ·Pᵢ by interleaved double-and-add: ONE shared run of
    doublings for the whole set (the batch-verify amortization)."""
    if not pairs:
        return _ZERO
    top = max(s.bit_length() for _, s in pairs)
    acc = _ZERO
    for bit in range(top - 1, -1, -1):
        acc = _add(acc, acc)
        for P, s in pairs:
            if (s >> bit) & 1:
                acc = _add(acc, P)
    return acc


class SigningKey:
    """Expanded signing key: the per-seed work (SHA-512 expansion plus
    the public-key scalar mult) done once, so a cached key signs with a
    single scalar mult. Same ``.sign(message)`` surface as
    ``cryptography``'s ``Ed25519PrivateKey``, which lets crypto.py's LRU
    key cache hold either backend's object."""

    __slots__ = ("_a", "_prefix", "public_key")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("Ed25519 seed must be 32 bytes")
        h = hashlib.sha512(seed).digest()
        self._a = _clamp(h)
        self._prefix = h[32:]
        self.public_key = _compress(_mult_base(self._a))

    def sign(self, message: bytes) -> bytes:
        r = _hash_to_scalar(self._prefix, message)
        R = _compress(_mult_base(r))
        S = (r + _hash_to_scalar(R, self.public_key, message) * self._a) % _L
        return R + S.to_bytes(32, "little")


def public_from_seed(seed: bytes) -> bytes:
    return SigningKey(seed).public_key


def sign(seed: bytes, message: bytes) -> bytes:
    return SigningKey(seed).sign(message)


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    if len(public_key) != 32 or len(signature) != 64:
        return False
    vk = _verify_key(bytes(public_key))
    R = _decompress(signature[:32])
    if vk is None or R is None:
        return False
    S = int.from_bytes(signature[32:], "little")
    if S >= _L:
        return False  # malleability check, RFC 8032 §5.1.7
    k = _hash_to_scalar(signature[:32], public_key, message)
    # S*B == R + k*A (projective equality — same accept set as the
    # compressed compare, minus its two field inversions).
    return _points_equal(_mult_base(S), _add(R, vk.mult(k)))


def verify_batch(items) -> list[bool]:
    """Verify ``[(public_key, message, signature), ...]`` as one batch.

    Returns per-item verdicts identical to ``[verify(*it) for it in
    items]`` (up to the 2^-128 RLC bound): structurally bad items are
    rejected up front, the rest ride one random-linear-combination
    check, and a failing batch fans back to per-item verification so a
    single bad signature costs only its cohort's fast path, never its
    cohort's verdicts. Terms sharing a public key collapse into one
    scalar mult — the per-sender drain shape of the wire hot loop, where
    a whole cohort usually carries ONE key."""
    items = list(items)
    ok = [False] * len(items)
    parsed = []  # (index, vk, R, S, k, pk_bytes)
    for i, (public_key, message, signature) in enumerate(items):
        if len(public_key) != 32 or len(signature) != 64:
            continue
        pk = bytes(public_key)
        vk = _verify_key(pk)
        R = _decompress(signature[:32])
        if vk is None or R is None:
            continue
        S = int.from_bytes(signature[32:], "little")
        if S >= _L:
            continue
        k = _hash_to_scalar(signature[:32], pk, message)
        parsed.append((i, vk, R, S, k, pk))
    if not parsed:
        return ok
    if len(parsed) == 1:
        i, vk, R, S, k, _ = parsed[0]
        ok[i] = _points_equal(_mult_base(S), _add(R, vk.mult(k)))
        return ok
    # Random 128-bit coefficients: an adversary who cannot predict z
    # passes the combined equation with probability 2^-128 unless every
    # term holds individually.
    rnd = os.urandom(16 * len(parsed))
    z = [
        int.from_bytes(rnd[16 * j : 16 * (j + 1)], "little") | 1
        for j in range(len(parsed))
    ]
    s_sum = 0
    a_coeff: dict[bytes, list] = {}  # pk -> [vk, scalar] (shared-key collapse)
    r_pairs = []
    for (i, vk, R, S, k, pk), zi in zip(parsed, z):
        s_sum = (s_sum + zi * S) % _L
        ent = a_coeff.get(pk)
        if ent is None:
            a_coeff[pk] = [vk, zi * k % _L]
        else:
            ent[1] = (ent[1] + zi * k) % _L
        r_pairs.append((R, zi))
    rhs = _msm(r_pairs)
    for vk, c in a_coeff.values():
        rhs = _add(rhs, vk.mult(c))
    if _points_equal(_mult_base(s_sum), rhs):
        for i, _vk, _R, _S, _k, _pk in parsed:
            ok[i] = True
        return ok
    # Fan back: isolate the bad item(s) without changing any verdict.
    for i, vk, R, S, k, _pk in parsed:
        ok[i] = _points_equal(_mult_base(S), _add(R, vk.mult(k)))
    return ok
