"""ctypes binding for the native RS codec shim.

A copy of ``noise_ec_tpu.shim.binding`` for the port. It wraps the C ABI
(``rs_shim.h``) in the same shard-list surface as
:class:`noise_ec_tpu_torch.codec.rs.ReedSolomon`, so the native codec is
the host's drop-in for NumPy: the numpy-backend codec's products
(``matrix/hostmath.py``), ``FEC``'s host-route decode (``matrix/bw.py``),
the numpy node's stream encode and the node's whole-object hashes. The same library is what a Go host
would cgo-link under the ``reedsolomon.Encoder`` interface — the C ABI,
not this module, is the compatibility boundary.

The library builds itself at first use with ``g++`` and the reference
Makefile's flags (:data:`CXXFLAGS`) into ``noise_ec_tpu_torch/_build/``
(listed in ``.gitignore``; nothing is written beside the sources), under a
name keyed on a hash of the sources, the flags and the compiler, and is
moved into place from a file tagged with the builder's pid, so processes
that race on a first build each produce a whole library and none loads a
half-written one. ``-march=native`` makes the library specific to the CPU
it was built on, which the key does not cover; ``_build/`` is never
committed, so every machine builds its own.

Unlike the reference, whose host callers drop to NumPy or ``hashlib`` when
the shim cannot be built or loaded, a missing or failing compiler raises
:class:`ShimBuildError` (with the compiler's output), and so does a library
that will not load. Only a product the shim does not take (a shape past
its counters, a hypothesis its fused pass cannot check) returns None, and
the caller takes NumPy for that call, as in the reference.

Run ``python -m noise_ec_tpu_torch.shim.binding --selftest`` to build and
cross-check against the golden codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SHIM_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SHIM_DIR.parent / "_build"
SOURCES = ("rs_shim.cpp", "blake2b.cpp")
# The reference Makefile's flags (noise_ec_tpu/shim/Makefile).
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-march=native", "-shared")

_MATRIX_KINDS = {"cauchy": 0, "vandermonde": 1}


class ShimBuildError(RuntimeError):
    """``g++`` is missing, the shim failed to compile, or the built library
    failed to load."""


def _compiler() -> tuple[str, str]:
    """(path, ``--version`` output) of ``g++``; raises ShimBuildError."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise ShimBuildError("g++ not found on PATH: the native shim cannot "
                             "be built")
    try:
        ver = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        raise ShimBuildError(f"{cxx} --version failed: {exc}") from exc
    return cxx, ver.stdout


def library_path() -> Path:
    """Where this checkout's shim library is (or will be) built."""
    cxx, version = _compiler()
    h = hashlib.sha256("\0".join((cxx, version) + CXXFLAGS).encode())
    for name in SOURCES + ("rs_shim.h",):
        h.update(name.encode() + (_SHIM_DIR / name).read_bytes())
    return BUILD_DIR / f"librs_shim-{h.hexdigest()[:16]}.so"


def build_shim(force: bool = False) -> Path:
    """Build the shim library unless it exists (or ``force``); returns its
    path. Raises ShimBuildError with the compiler's output on failure."""
    target = library_path()
    if target.exists() and not force:
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [shutil.which("g++"), *CXXFLAGS, "-o", str(tmp),
           *(str(_SHIM_DIR / name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.SubprocessError) as exc:
        tmp.unlink(missing_ok=True)
        raise ShimBuildError(f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ShimBuildError(
            f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def shim_available() -> bool:
    """True if the shared library exists or can be built."""
    try:
        build_shim()
        return True
    except ShimBuildError:
        return False


_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def _reload_fresh(stale: ctypes.CDLL, path) -> ctypes.CDLL:
    """Reopen ``path`` bypassing the dlopen pathname cache.

    glibc dedups dlopen by pathname, so CDLL(path) after a rebuild hands
    back the SAME stale handle. Drop our reference via dlclose first; if
    the handle is pinned (some other refcount), load a temp copy instead.
    """
    try:
        import _ctypes

        _ctypes.dlclose(stale._handle)
        fresh = ctypes.CDLL(str(path))
        if hasattr(fresh, "rs16_decode1_fused"):
            return fresh
    except OSError:  # pinned or unloadable handle: load a temp copy
        pass
    import tempfile

    tmp = tempfile.NamedTemporaryFile(
        prefix="librs_shim_", suffix=".so", delete=False
    )
    tmp.close()
    shutil.copyfile(path, tmp.name)
    lib = ctypes.CDLL(tmp.name)
    # The dlopen handle keeps the inode alive on Linux; unlinking now
    # avoids leaking one temp file per stale-shim recovery.
    try:
        os.unlink(tmp.name)
    except OSError:
        pass
    return lib


def _load() -> ctypes.CDLL:
    """The loaded shim (built on first use); raises ShimBuildError."""
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = _bind(_open())
        return _lib


def _open() -> ctypes.CDLL:
    path = build_shim()
    try:
        lib = ctypes.CDLL(str(path))
        if not hasattr(lib, "rs16_decode1_fused"):
            # A library from before the ABI grew: rebuild, then reopen
            # past the dlopen pathname cache (the hash in the name makes
            # this a corrupted-file case only).
            lib = _reload_fresh(lib, build_shim(force=True))
    except OSError as exc:
        raise ShimBuildError(f"cannot load {path}: {exc}") from exc
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry's argtypes and restype on ``lib``."""
    lib.rs_encoder_new.restype = ctypes.c_void_p
    lib.rs_encoder_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rs_encoder_free.argtypes = [ctypes.c_void_p]
    lib.rs_encode.restype = ctypes.c_int
    lib.rs_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    lib.rs_verify.restype = ctypes.c_int
    lib.rs_verify.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    lib.rs_reconstruct.restype = ctypes.c_int
    lib.rs_reconstruct.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.rs_shim_version.restype = ctypes.c_char_p
    lib.rs_matmul.restype = ctypes.c_int
    lib.rs_matmul.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    lib.rs_scale_rows.restype = ctypes.c_int
    lib.rs_scale_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_size_t,
    ]
    lib.rs_matmul_rows.restype = ctypes.c_int
    lib.rs_matmul_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_size_t,
    ]
    lib.rs_syndrome_rows.restype = ctypes.c_int
    lib.rs_syndrome_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    lib.rs_decode1_fused.restype = ctypes.c_int
    lib.rs_decode1_fused.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.rs16_matmul_rows.restype = ctypes.c_int
    lib.rs16_matmul_rows.argtypes = [
        u16p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_size_t,
    ]
    lib.rs16_syndrome_rows.restype = ctypes.c_int
    lib.rs16_syndrome_rows.argtypes = [
        u16p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), u16p, ctypes.c_size_t,
    ]
    lib.rs16_decode1_fused.restype = ctypes.c_int
    lib.rs16_decode1_fused.argtypes = [
        u16p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int,
        u16p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    lib.b2b_new.restype = ctypes.c_void_p
    lib.b2b_new.argtypes = [ctypes.c_int]
    lib.b2b_update.restype = ctypes.c_int
    lib.b2b_update.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.b2b_final.restype = ctypes.c_int
    lib.b2b_final.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.b2b_copy.restype = ctypes.c_void_p
    lib.b2b_copy.argtypes = [ctypes.c_void_p]
    lib.b2b_free.argtypes = [ctypes.c_void_p]
    return lib


def _as_u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gf_matmul_stripes(M: np.ndarray, D: np.ndarray) -> Optional[np.ndarray]:
    """M (r, k) @ D (k, S) over GF(2^8) on the native split-nibble/GFNI
    kernels.

    Only uint8 operands (GF(2^8)); the matrix entries must already be
    field elements of the shim's polynomial (0x11D — the same one as
    gf/field.py, asserted by the cross tests in tests/test_shim.py).
    """
    lib = _load()
    Mb = np.ascontiguousarray(M, dtype=np.uint8)
    Db = np.ascontiguousarray(D, dtype=np.uint8)
    r, k = Mb.shape
    out = np.empty((r, Db.shape[1]), dtype=np.uint8)
    rc = lib.rs_matmul(_as_u8_ptr(Mb), r, k, _as_u8_ptr(Db), _as_u8_ptr(out),
                       Db.shape[1])
    if rc != 0:
        raise RuntimeError(f"rs_matmul failed: {rc}")
    return out


def _row_ptrs(rows: Sequence[np.ndarray]):
    """ctypes void* array over per-row uint8 buffers (no stacking copy).

    Each row must be a C-contiguous 1-D uint8 array; returns (ptr_array,
    keepalive list) — the caller must hold the keepalive until the C call
    returns, because ascontiguousarray may have created temporaries.
    """
    keep = [np.ascontiguousarray(r, dtype=np.uint8) for r in rows]
    arr = (ctypes.c_void_p * len(keep))(*[r.ctypes.data for r in keep])
    return arr, keep


def gf_matmul_rows(
    M: np.ndarray, rows: Sequence[np.ndarray], length: int
) -> Optional[np.ndarray]:
    """M (r, k) @ rows (k separate buffers of ``length`` bytes) -> (r,
    length) uint8, tiled."""
    lib = _load()
    Mb = np.ascontiguousarray(M, dtype=np.uint8)
    r, k = Mb.shape
    out = np.empty((r, length), dtype=np.uint8)
    in_ptrs, in_keep = _row_ptrs(rows)
    out_ptrs, out_keep = _row_ptrs(list(out))
    rc = lib.rs_matmul_rows(_as_u8_ptr(Mb), r, k, in_ptrs, out_ptrs, length)
    del in_keep
    if rc != 0:
        raise RuntimeError(f"rs_matmul_rows failed: {rc}")
    # out rows were written through out_keep views, which alias out's rows
    # only if ascontiguousarray did not copy — rows of a fresh C-order
    # array are contiguous, so they alias by construction.
    del out_keep
    return out


def gf_syndrome_rows(
    A: np.ndarray,
    basis: Sequence[np.ndarray],
    extra: Sequence[np.ndarray],
    length: int,
    want_syndrome: bool = True,
) -> Optional[tuple[Optional[np.ndarray], np.ndarray]]:
    """Fused decode syndrome (see rs_syndrome_rows): returns (s, counts)
    where s (len(extra), length) = A @ basis ^ extra and counts[col] is the
    number of nonzero syndrome rows at that column; s is None when
    ``want_syndrome`` is False. None (the caller takes NumPy) past 255
    extra rows."""
    lib = _load()
    Ab = np.ascontiguousarray(A, dtype=np.uint8)
    r2, k = Ab.shape
    if r2 > 255:
        # counts is uint8 in the C ABI; more extra rows would silently
        # wrap the bad-column scan. Unreachable for deduped
        # GF(2^8) geometries (m <= n <= 256, k >= 1), so NumPy fallback.
        return None
    counts = np.empty(length, dtype=np.uint8)
    b_ptrs, b_keep = _row_ptrs(basis)
    e_ptrs, e_keep = _row_ptrs(extra)
    s = np.empty((r2, length), dtype=np.uint8) if want_syndrome else None
    if s is not None:
        s_ptrs, s_keep = _row_ptrs(list(s))
    else:
        s_ptrs, s_keep = None, None
    rc = lib.rs_syndrome_rows(
        _as_u8_ptr(Ab), r2, k, b_ptrs, e_ptrs, s_ptrs, _as_u8_ptr(counts),
        length,
    )
    del b_keep, e_keep, s_keep
    if rc != 0:
        raise RuntimeError(f"rs_syndrome_rows failed: {rc}")
    return s, counts


def gf_decode1_fused(
    A: np.ndarray,
    basis: Sequence[np.ndarray],
    extra: Sequence[np.ndarray],
    j: int,
    e: int,
    length: int,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Fused single-corrupt-row decode (see rs_decode1_fused): one pass
    computes the syndrome, verifies the single-support hypothesis
    {basis row j} per column, and returns (corrected_row_j, state) with
    state 0 = clean, 1 = corrected, 2 = needs the general path. None when
    the hypothesis cannot be verified (check
    column j identically zero — impossible for MDS checks)."""
    lib = _load()
    Ab = np.ascontiguousarray(A, dtype=np.uint8)
    r2, k = Ab.shape
    if r2 > 255:
        # Conservative parity with gf_syndrome_rows: the fused kernel is
        # count-free (it thresholds per column without materializing a
        # counter), so r2 > 255 would not wrap anything here — but the
        # syndrome kernel's uint8 per-column counter DOES cap at 255
        # check rows, and the two paths must refuse the same inputs so a
        # decode can't succeed fused yet fail when the probe routes it
        # generically. Reachable via custom generator matrices through
        # syndrome_decode_rows_any; NumPy fallback.
        return None
    out = np.empty(length, dtype=np.uint8)
    state = np.empty(length, dtype=np.uint8)
    b_ptrs, b_keep = _row_ptrs(basis)
    e_ptrs, e_keep = _row_ptrs(extra)
    rc = lib.rs_decode1_fused(
        _as_u8_ptr(Ab), r2, k, b_ptrs, e_ptrs, int(j), int(e),
        _as_u8_ptr(out), _as_u8_ptr(state), length,
    )
    del b_keep, e_keep
    if rc in (-2, -3):
        # -2: check column j identically zero; -3: nnz(A[:, j]) <= e so
        # the count-free shortcut is unsound. Neither occurs for MDS
        # checks; the caller falls back to the generic path.
        return None
    if rc != 0:
        raise RuntimeError(f"rs_decode1_fused failed: {rc}")
    return out, state


def _as_u16_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _row_ptrs16(rows: Sequence[np.ndarray]):
    """ctypes void* array over per-row uint16 buffers (see _row_ptrs)."""
    keep = [np.ascontiguousarray(r, dtype=np.uint16) for r in rows]
    arr = (ctypes.c_void_p * len(keep))(*[r.ctypes.data for r in keep])
    return arr, keep


def gf16_matmul_rows(
    M: np.ndarray, rows: Sequence[np.ndarray], length: int
) -> Optional[np.ndarray]:
    """GF(2^16) tier of gf_matmul_rows: M (r, k) uint16 @ rows (k uint16
    buffers of ``length`` symbols) -> (r, length) uint16."""
    lib = _load()
    Mb = np.ascontiguousarray(M, dtype=np.uint16)
    r, k = Mb.shape
    out = np.empty((r, length), dtype=np.uint16)
    in_ptrs, in_keep = _row_ptrs16(rows)
    out_ptrs, out_keep = _row_ptrs16(list(out))
    rc = lib.rs16_matmul_rows(_as_u16_ptr(Mb), r, k, in_ptrs, out_ptrs, length)
    del in_keep, out_keep
    if rc != 0:
        raise RuntimeError(f"rs16_matmul_rows failed: {rc}")
    return out


def gf16_syndrome_rows(
    A: np.ndarray,
    basis: Sequence[np.ndarray],
    extra: Sequence[np.ndarray],
    length: int,
    want_syndrome: bool = True,
) -> Optional[tuple[Optional[np.ndarray], np.ndarray]]:
    """GF(2^16) tier of gf_syndrome_rows; counts come back uint16 (the
    wide field admits more than 255 extra rows). Lengths in symbols."""
    lib = _load()
    Ab = np.ascontiguousarray(A, dtype=np.uint16)
    r2, k = Ab.shape
    counts = np.empty(length, dtype=np.uint16)
    b_ptrs, b_keep = _row_ptrs16(basis)
    e_ptrs, e_keep = _row_ptrs16(extra)
    s = np.empty((r2, length), dtype=np.uint16) if want_syndrome else None
    if s is not None:
        s_ptrs, s_keep = _row_ptrs16(list(s))
    else:
        s_ptrs, s_keep = None, None
    rc = lib.rs16_syndrome_rows(
        _as_u16_ptr(Ab), r2, k, b_ptrs, e_ptrs, s_ptrs, _as_u16_ptr(counts),
        length,
    )
    del b_keep, e_keep, s_keep
    if rc != 0:
        raise RuntimeError(f"rs16_syndrome_rows failed: {rc}")
    return s, counts


def gf16_decode1_fused(
    A: np.ndarray,
    basis: Sequence[np.ndarray],
    extra: Sequence[np.ndarray],
    j: int,
    e: int,
    length: int,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """GF(2^16) tier of gf_decode1_fused (lengths in symbols; state is
    one byte per column as in the GF(2^8) kernel)."""
    lib = _load()
    Ab = np.ascontiguousarray(A, dtype=np.uint16)
    r2, k = Ab.shape
    out = np.empty(length, dtype=np.uint16)
    state = np.empty(length, dtype=np.uint8)
    b_ptrs, b_keep = _row_ptrs16(basis)
    e_ptrs, e_keep = _row_ptrs16(extra)
    rc = lib.rs16_decode1_fused(
        _as_u16_ptr(Ab), r2, k, b_ptrs, e_ptrs, int(j), int(e),
        _as_u16_ptr(out), _as_u8_ptr(state), length,
    )
    del b_keep, e_keep
    if rc in (-2, -3):
        # -2: check column j identically zero; -3: nnz(A[:, j]) <= e so
        # the count-free shortcut is unsound. Neither occurs for MDS
        # checks; the caller falls back to the generic path.
        return None
    if rc != 0:
        raise RuntimeError(f"rs16_decode1_fused failed: {rc}")
    return out, state


def gf_scale_rows(consts: np.ndarray, D: np.ndarray) -> Optional[np.ndarray]:
    """Row-wise constant scale over GF(2^8): returns a new (rows, S) array
    with row i = consts[i] * D[i]."""
    lib = _load()
    buf = np.array(D, dtype=np.uint8, copy=True, order="C")
    cb = np.ascontiguousarray(consts, dtype=np.uint8)
    rc = lib.rs_scale_rows(_as_u8_ptr(cb), _as_u8_ptr(buf), buf.shape[0],
                           buf.shape[1])
    if rc != 0:
        raise RuntimeError(f"rs_scale_rows failed: {rc}")
    return buf


class NativeBlake2b:
    """Streaming unkeyed BLAKE2b on the shim (bit-identical to
    hashlib.blake2b — RFC 7693; cross-checked in tests/test_torch_shim.py).

    Exists because the host node's sign/verify hashes whole objects
    (main.go:82-89, 219-223) and the shim's compression function uses the
    AVX512VL rotate form. Use :func:`native_blake2b` to construct.
    """

    __slots__ = ("_lib", "_ctx", "digest_size")

    def __init__(self, lib, digest_size: int):
        self._lib = lib
        self.digest_size = digest_size
        self._ctx = lib.b2b_new(digest_size)
        if not self._ctx:
            raise ValueError(f"bad digest size {digest_size}")

    def update(self, data) -> None:
        n = len(data)
        if n == 0:
            return
        if isinstance(data, bytes):
            ptr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
        else:
            try:  # writable buffers (bytearray, writable memoryview)
                ptr = ctypes.cast(
                    (ctypes.c_ubyte * n).from_buffer(data), ctypes.c_void_p
                )
            except TypeError:  # read-only non-bytes view: one copy
                data = bytes(data)
                ptr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p)
                n = len(data)
        rc = self._lib.b2b_update(self._ctx, ptr, n)
        if rc != 0:
            raise RuntimeError(f"b2b_update failed: {rc}")

    def digest(self) -> bytes:
        # Finalize a CLONE: hashlib semantics allow digest() mid-stream,
        # repeated digest(), and update() afterwards; native finalization
        # is destructive.
        dup = self._lib.b2b_copy(self._ctx)
        if not dup:
            raise MemoryError("b2b_copy failed")
        try:
            out = ctypes.create_string_buffer(self.digest_size)
            rc = self._lib.b2b_final(dup, out)
            if rc != 0:
                raise RuntimeError(f"b2b_final failed: {rc}")
            return out.raw
        finally:
            self._lib.b2b_free(dup)

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.b2b_free(ctx)
            self._ctx = None


def native_blake2b(digest_size: int = 32) -> NativeBlake2b:
    """A fresh native streaming BLAKE2b (raises ShimBuildError when the
    shim cannot be built or loaded)."""
    return NativeBlake2b(_load(), digest_size)


class CppReedSolomon:
    """Native-backend RS codec over contiguous (n, shard_len) buffers."""

    def __init__(self, data_shards: int, parity_shards: int, matrix: str = "cauchy"):
        if matrix not in _MATRIX_KINDS:
            raise ValueError(f"unknown matrix kind {matrix!r}")
        self.k = data_shards
        self.r = parity_shards
        self.n = data_shards + parity_shards
        self._lib = _load()
        self._enc = self._lib.rs_encoder_new(
            data_shards, parity_shards, _MATRIX_KINDS[matrix]
        )
        if not self._enc:
            raise ValueError(
                f"invalid geometry k={data_shards} r={parity_shards} "
                f"(n must be <= 256)"
            )

    def __del__(self):
        enc = getattr(self, "_enc", None)
        if enc:
            self._lib.rs_encoder_free(enc)
            self._enc = None

    @property
    def version(self) -> str:
        return self._lib.rs_shim_version().decode()

    def _buffer(self, shards: Sequence[Optional[np.ndarray]]) -> np.ndarray:
        lens = {s.shape[-1] for s in shards if s is not None}
        if len(lens) != 1:
            raise ValueError("present shards must share one length")
        (ln,) = lens
        buf = np.zeros((self.n, ln), dtype=np.uint8)
        for i, s in enumerate(shards):
            if s is not None:
                buf[i] = s
        return buf

    def encode(self, data_shards: Sequence[np.ndarray]) -> np.ndarray:
        """(k, S) data rows -> full (n, S) codeword (systematic)."""
        if len(data_shards) != self.k:
            raise ValueError(f"expected {self.k} data shards, got {len(data_shards)}")
        buf = self._buffer(list(data_shards) + [None] * self.r)
        rc = self._lib.rs_encode(self._enc, _as_u8_ptr(buf), buf.shape[1])
        if rc != 0:
            raise RuntimeError(f"rs_encode failed: {rc}")
        return buf

    def encode_into(self, codeword: np.ndarray) -> None:
        """Zero-copy encode: fill the parity rows of a contiguous
        C-order (n, S) uint8 buffer in place."""
        if codeword.shape[0] != self.n or codeword.dtype != np.uint8:
            raise ValueError(f"need a C-contiguous ({self.n}, S) uint8 buffer")
        if not codeword.flags.c_contiguous:
            raise ValueError("buffer must be C-contiguous")
        rc = self._lib.rs_encode(self._enc, _as_u8_ptr(codeword), codeword.shape[1])
        if rc != 0:
            raise RuntimeError(f"rs_encode failed: {rc}")

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shards, got {len(shards)}")
        buf = self._buffer(shards)
        rc = self._lib.rs_verify(self._enc, _as_u8_ptr(buf), buf.shape[1])
        if rc < 0:
            raise RuntimeError(f"rs_verify failed: {rc}")
        return bool(rc)

    def reconstruct(
        self,
        shards: Sequence[Optional[np.ndarray]],
        data_only: bool = False,
    ) -> np.ndarray:
        """Fill ``None`` rows; returns the full (n, S) (or repaired-data)
        buffer. Present rows are trusted (erasure-only — corruption
        detection is the signature layer's job, main.go:82-99)."""
        if len(shards) != self.n:
            raise ValueError(f"expected {self.n} shards, got {len(shards)}")
        present = np.array(
            [0 if s is None else 1 for s in shards], dtype=np.uint8
        )
        if int(present.sum()) < self.k:
            raise ValueError(
                f"need >= {self.k} present shards, have {int(present.sum())}"
            )
        buf = self._buffer(shards)
        rc = self._lib.rs_reconstruct(
            self._enc, _as_u8_ptr(buf), buf.shape[1], _as_u8_ptr(present),
            1 if data_only else 0,
        )
        if rc != 0:
            raise RuntimeError(f"rs_reconstruct failed: {rc}")
        return buf


def _selftest() -> int:
    from noise_ec_tpu_torch.golden.codec import GoldenCodec

    rng = np.random.default_rng(0)
    for k, r in [(4, 2), (10, 4), (17, 3), (50, 20), (1, 1), (2, 0)]:
        for matrix in ("cauchy", "vandermonde"):
            S = 512
            cpp = CppReedSolomon(k, r, matrix=matrix)
            gold = GoldenCodec(k, k + r, matrix=matrix)
            data = rng.integers(0, 256, size=(k, S)).astype(np.uint8)
            cw_cpp = cpp.encode(list(data))
            cw_gold = gold.encode_all(data)
            assert np.array_equal(cw_cpp, cw_gold), (k, r, matrix, "encode")
            assert cpp.verify(list(cw_cpp)), (k, r, matrix, "verify")
            if r:
                bad = cw_cpp.copy()
                bad[k, 0] ^= 1
                assert not cpp.verify(list(bad)), (k, r, matrix, "verify-neg")
                erased = [
                    None if i < min(r, k) else cw_cpp[i] for i in range(k + r)
                ]
                rec = cpp.reconstruct(erased)
                assert np.array_equal(rec, cw_cpp), (k, r, matrix, "reconstruct")
    print("shim selftest OK:", CppReedSolomon(4, 2).version)
    return 0


if __name__ == "__main__":
    if "--selftest" in sys.argv:
        sys.exit(_selftest())
    print(build_shim(force="--force" in sys.argv))
