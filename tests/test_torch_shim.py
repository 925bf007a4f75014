"""The port's native host codec (``noise_ec_tpu_torch.shim``) against the
reference's shim and the golden codec: the ``tests/test_shim.py`` cases
(encode against golden for Cauchy and Vandermonde, verify, reconstruct at
each erasure set, data-only, cross-backend, insufficient shards, bad
geometry), the GF(2^8) and GF(2^16) row kernels against the reference's,
``native_blake2b`` against ``hashlib.blake2b``, a C consumer linked against
the port's built library, where the library lands, and ``ShimBuildError``
without a compiler. The port's ``FEC`` on ``bw_route="host"`` decodes
through the shim, byte-identical to the reference's ``FEC`` on the
``tests/test_bw.py`` corruption cases. Tolerance: byte-identical
throughout."""

import hashlib
import shutil
import subprocess

import numpy as np
import pytest

from noise_ec_tpu.codec.fec import FEC as RefFEC
from noise_ec_tpu.codec.fec import Share as RefShare
from noise_ec_tpu.golden.codec import GoldenCodec as RefGolden
from noise_ec_tpu.shim import binding as ref_binding
from noise_ec_tpu_torch.codec import FEC, Share
from noise_ec_tpu_torch.gf.field import GF256, GF65536
from noise_ec_tpu_torch.golden import GoldenCodec
from noise_ec_tpu_torch.matrix import bw
from noise_ec_tpu_torch.shim import (
    CppReedSolomon,
    ShimBuildError,
    gf16_decode1_fused,
    gf16_matmul_rows,
    gf16_syndrome_rows,
    gf_decode1_fused,
    gf_matmul_rows,
    gf_syndrome_rows,
    native_blake2b,
)
from noise_ec_tpu_torch.shim import binding

REF_SHIM = ref_binding.shim_available()


# ------------------------------------------------- tests/test_shim.py cases


@pytest.mark.parametrize("k,r", [(4, 2), (10, 4), (17, 3), (1, 1), (3, 5)])
@pytest.mark.parametrize("matrix", ["cauchy", "vandermonde"])
def test_encode_matches_golden_and_reference(k, r, matrix):
    rng = np.random.default_rng(k * 100 + r)
    data = rng.integers(0, 256, size=(k, 256)).astype(np.uint8)
    got = CppReedSolomon(k, r, matrix=matrix).encode(list(data))
    assert np.array_equal(got, GoldenCodec(k, k + r, matrix=matrix)
                          .encode_all(data))
    assert np.array_equal(got, RefGolden(k, k + r, matrix=matrix)
                          .encode_all(data))
    if REF_SHIM:
        ref = ref_binding.CppReedSolomon(k, r, matrix=matrix)
        assert np.array_equal(got, ref.encode(list(data)))


def test_verify_positive_and_negative():
    rng = np.random.default_rng(1)
    cpp = CppReedSolomon(10, 4)
    cw = cpp.encode(list(rng.integers(0, 256, size=(10, 128)).astype(np.uint8)))
    assert cpp.verify(list(cw))
    cw[11, 7] ^= 0x40
    assert not cpp.verify(list(cw))


@pytest.mark.parametrize("erase", [[0], [0, 1, 2], [9, 10, 13], [0, 5, 11, 12]])
def test_reconstruct_erasures(erase):
    rng = np.random.default_rng(7)
    cpp = CppReedSolomon(10, 4)
    cw = cpp.encode(list(rng.integers(0, 256, size=(10, 200)).astype(np.uint8)))
    holes = [None if i in erase else cw[i] for i in range(14)]
    got = cpp.reconstruct(holes)
    assert np.array_equal(got, cw)
    if REF_SHIM:
        assert np.array_equal(
            got, ref_binding.CppReedSolomon(10, 4).reconstruct(holes))


def test_reconstruct_data_only_leaves_parity_unfilled():
    rng = np.random.default_rng(8)
    cpp = CppReedSolomon(4, 2)
    cw = cpp.encode(list(rng.integers(0, 256, size=(4, 64)).astype(np.uint8)))
    holes = [None, cw[1], cw[2], cw[3], None, cw[5]]
    rec = cpp.reconstruct(holes, data_only=True)
    assert np.array_equal(rec[:4], cw[:4])
    assert not rec[4].any()


def test_cross_backend_interop():
    """Encode natively, reconstruct with the golden codec, and the other
    way around."""
    rng = np.random.default_rng(9)
    k, r, S = 10, 4, 300
    cpp = CppReedSolomon(k, r)
    gold = GoldenCodec(k, k + r)
    data = rng.integers(0, 256, size=(k, S)).astype(np.uint8)
    cw = cpp.encode(list(data))
    out = gold.reconstruct([None if i in (0, 4, 12) else cw[i]
                            for i in range(k + r)])
    assert np.array_equal(np.stack(out), cw)
    cw2 = gold.encode_all(data)
    rec = cpp.reconstruct([None if i in (1, 2, 13) else cw2[i]
                           for i in range(k + r)])
    assert np.array_equal(rec, cw2)


def test_insufficient_shards_raises():
    with pytest.raises(ValueError):
        CppReedSolomon(4, 2).reconstruct(
            [None, None, None, np.zeros(8, np.uint8), None, None])


@pytest.mark.parametrize("k,r,matrix", [(200, 57, "cauchy"), (0, 2, "cauchy"),
                                        (4, 2, "bogus")])
def test_invalid_geometry_rejected(k, r, matrix):
    with pytest.raises(ValueError):
        CppReedSolomon(k, r, matrix=matrix)


# --------------------------------------------------------- the row kernels


@pytest.mark.parametrize("S", [5, 33, 4099])
def test_gf_row_kernels_match_reference_and_numpy(S):
    rng = np.random.default_rng(S)
    gf = GF256()
    r, k = 4, 6
    M = rng.integers(0, 256, size=(r, k)).astype(np.uint8)
    rows = [rng.integers(0, 256, size=S).astype(np.uint8) for _ in range(k)]
    extra = [rng.integers(0, 256, size=S).astype(np.uint8) for _ in range(r)]
    want = gf.matvec_stripes(M.astype(np.int64), np.stack(rows)).astype(np.uint8)
    got = gf_matmul_rows(M, rows, S)
    np.testing.assert_array_equal(got, want)
    s, counts = gf_syndrome_rows(M, rows, extra, S)
    np.testing.assert_array_equal(s, want ^ np.stack(extra))
    np.testing.assert_array_equal(counts, np.count_nonzero(s, axis=0))
    s2, counts2 = gf_syndrome_rows(M, rows, extra, S, want_syndrome=False)
    assert s2 is None and np.array_equal(counts2, counts)
    if REF_SHIM:
        np.testing.assert_array_equal(
            got, ref_binding.gf_matmul_rows(M, rows, S))
        rs, rc = ref_binding.gf_syndrome_rows(M, rows, extra, S)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(counts, rc)


@pytest.mark.parametrize("S", [5, 16, 4099])
def test_gf16_row_kernels_match_reference_and_numpy(S):
    rng = np.random.default_rng(S + 1)
    gf = GF65536()
    r, k = 3, 5
    M = rng.integers(0, 1 << 16, size=(r, k)).astype(np.uint16)
    rows = [rng.integers(0, 1 << 16, size=S).astype(np.uint16)
            for _ in range(k)]
    extra = [rng.integers(0, 1 << 16, size=S).astype(np.uint16)
             for _ in range(r)]
    want = gf.matvec_stripes(M.astype(np.int64), np.stack(rows)).astype(np.uint16)
    got = gf16_matmul_rows(M, rows, S)
    np.testing.assert_array_equal(got, want)
    s, counts = gf16_syndrome_rows(M, rows, extra, S)
    np.testing.assert_array_equal(s, want ^ np.stack(extra))
    np.testing.assert_array_equal(counts, np.count_nonzero(s, axis=0))
    if REF_SHIM:
        np.testing.assert_array_equal(
            got, ref_binding.gf16_matmul_rows(M, rows, S))
        rs, rc = ref_binding.gf16_syndrome_rows(M, rows, extra, S)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(counts, rc)


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_decode1_fused_matches_reference(field):
    """One corrupt basis row: the fused pass corrects it in one sweep, on
    the port's shim and the reference's alike (state and row)."""
    rng = np.random.default_rng(11)
    k, n, S = 6, 10, 3000
    gold = GoldenCodec(k, n, field=field)
    dtype = np.uint8 if field == "gf256" else np.uint16
    hi = 256 if field == "gf256" else 1 << 16
    data = rng.integers(0, hi, size=(k, S)).astype(dtype)
    cw = gold.encode_all(data).astype(dtype)
    rows = [np.ascontiguousarray(cw[i]) for i in range(n)]
    rows[2] = rows[2] ^ dtype(0x5A)
    _, A = bw._decode_plan(gold.gf, "cauchy", k, n, list(range(n)), gold.G)
    fn = gf_decode1_fused if field == "gf256" else gf16_decode1_fused
    out, state = fn(A, rows[:k], rows[k:], 2, (n - k) // 2, S)
    np.testing.assert_array_equal(out, data[2])
    assert set(np.unique(state)) <= {1}
    if REF_SHIM:
        rfn = (ref_binding.gf_decode1_fused if field == "gf256"
               else ref_binding.gf16_decode1_fused)
        rout, rstate = rfn(A, rows[:k], rows[k:], 2, (n - k) // 2, S)
        np.testing.assert_array_equal(out, rout)
        np.testing.assert_array_equal(state, rstate)


def test_syndrome_past_255_extra_rows_is_not_taken():
    """A GF(2^8) syndrome with more than 255 check rows would wrap the
    C ABI's uint8 counters: the binding returns None (NumPy runs it)."""
    M = np.ones((256, 1), np.uint8)
    rows = [np.zeros(4, np.uint8)]
    assert gf_syndrome_rows(M, rows, [np.zeros(4, np.uint8)] * 256, 4) is None


# ----------------------------------------------------------------- blake2b


def test_native_blake2b_hashlib_semantics():
    """digest() is non-destructive (mid-stream, repeated, update after),
    and every digest equals hashlib's for the same prefix."""
    h = native_blake2b(32)
    ref = hashlib.blake2b(digest_size=32)
    rng = np.random.default_rng(7)
    for n in (1, 100, 129, 5000, 1 << 18):
        part = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        h.update(part)
        ref.update(part)
        assert h.digest() == ref.digest()
        assert h.digest() == ref.digest()
    h.update(bytearray(b"writable"))
    ref.update(b"writable")
    assert h.digest() == ref.digest()
    assert native_blake2b(16).digest() == hashlib.blake2b(
        digest_size=16).digest()


# -------------------------------------------------- the build and the C ABI


def test_library_builds_only_into_build_dir():
    """The library lands under noise_ec_tpu_torch/_build/ with a hashed
    name, and nothing is written beside the sources."""
    before = sorted(p.name for p in binding._SHIM_DIR.iterdir())
    path = binding.build_shim()
    assert path.parent == binding.BUILD_DIR
    assert path.name.startswith("librs_shim-") and path.suffix == ".so"
    assert path.exists()
    after = sorted(p.name for p in binding._SHIM_DIR.iterdir()
                   if p.name != "__pycache__")
    assert after == [n for n in before if n != "__pycache__"]
    assert not any(n.endswith(".so") for n in after)


def test_missing_compiler_raises_shim_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(ShimBuildError, match="g\\+\\+ not found"):
        binding.build_shim()


def test_failing_compile_raises_with_compiler_output(monkeypatch, tmp_path):
    """A compiler that fails hands its output to ShimBuildError, and no
    library is left at the target."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\n"
                    "if [ \"$1\" = --version ]; then echo fake-gxx 0; exit 0; fi\n"
                    "echo 'fatal: no such luck' >&2; exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    target = binding.library_path()
    with pytest.raises(ShimBuildError, match="no such luck"):
        binding.build_shim()
    assert not target.exists()
    assert not list(binding.BUILD_DIR.glob(target.name + "*.tmp"))


# The C consumer of tests/test_shim_cabi.py, shaped like the Go example.
C_SRC = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "rs_shim.h"

int main(void) {
  enum { K = 4, R = 2, N = 6 };
  const size_t len = 1024;
  void* enc = rs_encoder_new(K, R, 0);
  if (!enc) { fprintf(stderr, "new failed\n"); return 1; }

  uint8_t* shards = calloc(N, len);
  uint8_t* want = malloc(N * len);
  for (size_t i = 0; i < K * len; ++i) shards[i] = (uint8_t)(i * 131u);

  if (rs_encode(enc, shards, len) != 0) return 2;
  if (rs_verify(enc, shards, len) != 1) return 3;
  memcpy(want, shards, N * len);

  uint8_t present[N] = {1, 0, 1, 1, 0, 1}; /* lose data row 1, parity row 4 */
  memset(shards + 1 * len, 0, len);
  memset(shards + 4 * len, 0, len);
  if (rs_reconstruct(enc, shards, len, present, 0) != 0) return 4;
  if (memcmp(shards, want, N * len) != 0) return 5;

  rs_encoder_free(enc);
  puts(rs_shim_version());
  puts("c-abi round-trip: OK");
  return 0;
}
"""


def test_c_consumer_links_and_round_trips(tmp_path):
    """A plain C program including rs_shim.h, linked against the port's
    built library, runs encode -> verify -> erase -> reconstruct."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    lib = binding.build_shim()
    # Link through a plainly named copy: -l needs lib<name>.so.
    link_dir = tmp_path / "lib"
    link_dir.mkdir()
    shutil.copyfile(lib, link_dir / "librs_shim.so")
    src = tmp_path / "consumer.c"
    src.write_text(C_SRC)
    exe = tmp_path / "consumer"
    subprocess.run(
        [cc, str(src), "-I", str(binding._SHIM_DIR), "-L", str(link_dir),
         "-lrs_shim", f"-Wl,-rpath,{link_dir}", "-o", str(exe)],
        check=True, capture_output=True, timeout=120,
    )
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         timeout=60, text=True)
    assert "c-abi round-trip: OK" in out.stdout
    assert "gf256" in out.stdout


def test_reload_fresh_bypasses_dlopen_cache(tmp_path):
    """The ABI check's reload: after a rebuild at the same path, the
    helper hands back a handle that sees the new symbol."""
    import ctypes

    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    src = tmp_path / "v.c"
    so = tmp_path / "libv.so"
    src.write_text("int rs_probe_old(void) { return 1; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    stale = ctypes.CDLL(str(so))
    assert not hasattr(stale, "rs16_decode1_fused")
    src.write_text("int rs_probe_old(void) { return 1; }\n"
                   "int rs16_decode1_fused(void) { return 42; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    fresh = binding._reload_fresh(stale, so)
    assert fresh.rs16_decode1_fused() == 42


# ------------------------------------- FEC's host route now runs on the shim


def _flip(shares, nums, byte=0x3C):
    return [
        Share(s.number, (np.frombuffer(s.data, np.uint8) ^ byte).tobytes())
        if s.number in nums else s
        for s in shares
    ]


def _scatter(rng, shares, cols, e):
    rows = [bytearray(s.data) for s in shares]
    for c in rng.choice(len(rows[0]), size=cols, replace=False):
        for i in rng.choice(len(rows), size=int(rng.integers(1, e + 1)),
                            replace=False):
            rows[i][c] ^= int(rng.integers(1, 256))
    return [Share(s.number, bytes(r)) for s, r in zip(shares, rows)]


@pytest.mark.parametrize("field,k,n,S", [
    ("gf256", 10, 14, 1 << 15),        # below the speculation width
    ("gf256", 10, 14, 300_000),        # the fused decode1 pass
    ("gf65536", 6, 10, 600_000),       # GF(2^16), fused at 16 bits
])
@pytest.mark.parametrize("case", ["one_corrupt", "scattered"])
def test_fec_host_route_on_shim_matches_reference(field, k, n, S, case,
                                                  monkeypatch):
    """FEC(bw_route="host") decodes through the shim (its three sites:
    syndrome, row products, decode1 fused) and returns the reference
    FEC's bytes on one corrupt share and on scattered corruption."""
    calls = []
    from noise_ec_tpu_torch import shim as port_shim

    for name in ("gf_syndrome_rows", "gf16_syndrome_rows",
                 "gf_decode1_fused", "gf16_decode1_fused",
                 "gf_matmul_rows", "gf16_matmul_rows"):
        real = getattr(port_shim, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(port_shim, name, spy)
    rng = np.random.default_rng(S + n)
    data = rng.integers(0, 256, size=k * S, dtype=np.uint8).tobytes()
    fec = FEC(k, n, field=field, backend="numpy")
    ref = RefFEC(k, n, field=field, backend="numpy")
    shares = fec.encode_shares(data)
    if case == "one_corrupt":
        bad = _flip(shares, {3})
    else:
        bad = _scatter(rng, shares, cols=200, e=(n - k) // 2)
    got = fec.decode(bad)
    want = ref.decode([RefShare(s.number, s.data) for s in bad])
    assert got == want == data
    assert any("syndrome" in c for c in calls)
    if case == "one_corrupt" and S * (1 if field == "gf256" else 2) >= 256 << 10:
        assert any("decode1" in c for c in calls)


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_numpy_backend_codec_runs_on_the_shim(field, monkeypatch):
    """``ReedSolomon(backend="numpy")``'s products run on the shim
    (``matrix/hostmath.py`` ``native_matvec``), as the reference's do, with
    the reference's bytes: encode and a 3-erasure reconstruct."""
    from noise_ec_tpu.codec.rs import ReedSolomon as RefRS
    from noise_ec_tpu_torch import shim as port_shim
    from noise_ec_tpu_torch.codec import ReedSolomon

    name = "gf_matmul_stripes" if field == "gf256" else "gf16_matmul_rows"
    calls = []
    real = getattr(port_shim, name)
    monkeypatch.setattr(port_shim, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(21)
    rs = ReedSolomon(10, 4, field=field, backend="numpy")
    ref = RefRS(10, 4, field=field, backend="numpy")
    data = [rng.integers(0, 256, 4096, dtype=np.uint8) for _ in range(10)]
    enc = rs.encode(data)
    assert all(np.array_equal(a, b) for a, b in zip(enc, ref.encode(data)))
    holes = [None if i in (0, 5, 11) else s for i, s in enumerate(enc)]
    rec = rs.reconstruct(holes)
    assert all(np.array_equal(a, b) for a, b in zip(rec, enc))
    assert len(calls) == 2  # the parity product and the recovery product
