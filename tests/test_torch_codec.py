"""The port's slice end to end on the CPU: ``ReedSolomon(device="cpu")``
byte-identical to the reference's ``backend="numpy"`` codec and its
interpreted Pallas ``DeviceCodec``; the copied host modules equal the
reference's; the package imports neither jax nor the JAX package; and
nothing falls back quietly to the host."""

import ast
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from noise_ec_tpu.codec.rs import ReedSolomon as RefRS
from noise_ec_tpu.gf.bitmatrix import expand_generator_bits as ref_expand
from noise_ec_tpu.gf.field import GF256 as RefGF256
from noise_ec_tpu.matrix.generators import generator_matrix as ref_generator
from noise_ec_tpu.matrix.linalg import reconstruction_matrix as ref_recon
from noise_ec_tpu.ops.dispatch import DeviceCodec as RefDeviceCodec
from noise_ec_tpu_torch.codec import ReedSolomon
from noise_ec_tpu_torch.gf import GF256, expand_generator_bits
from noise_ec_tpu_torch.matrix import (
    generator_matrix,
    host_matvec,
    reconstruction_matrix,
)
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.ops.coalesce import (
    coalesce_cutoff_bytes,
    configure_coalescer,
    current_qos,
    qos_lane,
)
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec, StagingPool

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "noise_ec_tpu_torch"


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None)
        or (x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a, b)
    )


def _erasures(k, r, e):
    """e lost shards spread over data and parity (data only past RS(17,3),
    where each distinct matrix is a fresh factoring on the host)."""
    if k >= 50:
        return [0, 17, 33, 49][:e]
    return sorted({0, k - 1, k, k + r - 1, 1}, key=[0, k, k - 1, k + r - 1, 1].index)[:e]


@pytest.mark.parametrize("kind", ["cauchy", "par1", "vandermonde"])
@pytest.mark.parametrize("k,n", [(4, 6), (10, 14), (17, 20), (50, 70)])
def test_host_copies_match_reference(kind, k, n):
    gf, ref_gf = GF256(), RefGF256()
    np.testing.assert_array_equal(gf.exp, ref_gf.exp)
    np.testing.assert_array_equal(gf.log, ref_gf.log)
    G = generator_matrix(gf, k, n, kind)
    np.testing.assert_array_equal(G, ref_generator(ref_gf, k, n, kind))
    np.testing.assert_array_equal(expand_generator_bits(gf, G[k:]),
                                  ref_expand(ref_gf, G[k:]))
    present = list(range(n - k, n))
    if kind == "par1":
        present = list(range(k))  # par1 minors can be singular
    np.testing.assert_array_equal(
        reconstruction_matrix(gf, G, present, [0, n - 1]),
        ref_recon(ref_gf, G, present, [0, n - 1]),
    )


@pytest.mark.parametrize("S", [1000, 32768])
@pytest.mark.parametrize("kind", ["cauchy", "par1"])
@pytest.mark.parametrize("k,r", [(4, 2), (10, 4), (17, 3), (50, 20)])
def test_slice_matches_numpy_backend(k, r, kind, S):
    rng = np.random.default_rng(k * 1000 + r * 10 + S)
    rs = ReedSolomon(k, r, matrix=kind, device="cpu")
    ref = RefRS(k, r, matrix=kind, backend="numpy")
    reset_launch_counts()

    obj = rng.integers(0, 256, size=k * S - 3, dtype=np.uint8).tobytes()
    data = rs.split(obj)  # k shards of S bytes, the last zero-padded
    assert _same(data, ref.split(obj)) and data[0].size == S
    enc = rs.encode(data)
    assert _same(enc, ref.encode(data))
    assert rs.verify(enc) and ref.verify(enc)
    bad = [s.copy() for s in enc]
    bad[k][S // 2] ^= 1
    assert not rs.verify(bad) and not ref.verify(bad)
    assert rs.join(enc, len(obj)) == ref.join(enc, len(obj)) == obj

    for e in range(1, min(4, r) + 1):
        lost = list(enc)
        for i in _erasures(k, r, e):
            lost[i] = None
        try:
            want = ref.reconstruct(lost)
        except ValueError as exc:  # a par1 shard set with no invertible basis
            with pytest.raises(type(exc)):
                rs.reconstruct(lost)
            continue
        got = rs.reconstruct(lost)
        assert _same(got, want) and _same(got, enc)
        assert _same(rs.reconstruct_data(lost), ref.reconstruct_data(lost))
        required = [i in _erasures(k, r, 1) for i in range(k + r)]
        assert _same(rs.reconstruct_some(lost, required),
                     ref.reconstruct_some(lost, required))

    new = [None] * k
    new[0] = rng.integers(0, 256, size=S, dtype=np.uint8)
    new[k - 1] = rng.integers(0, 256, size=S, dtype=np.uint8)
    updated = rs.update(enc, new)
    assert _same(updated, ref.update(enc, new))
    assert rs.verify(updated)
    # The CPU run took the plain versions: no kernel launched.
    assert all(n == 0 for n in launch_counts().values())


def test_device_codec_matches_interpreted_pallas(rng):
    """RS(10,4) through every baked tier of the port (K5 by default, K1
    and the pipeline forced) equals the reference's DeviceCodec in Pallas
    interpret mode (one interpret compile)."""
    G = ref_generator(RefGF256(), 10, 14, "cauchy")
    D = rng.integers(0, 256, size=(10, 32768), dtype=np.uint8)
    want = RefDeviceCodec(field="gf256", kernel="pallas_interpret").matmul_stripes(
        G[10:], D
    )
    codec = DeviceCodec(device="cpu")
    assert codec.plan_for(G[10:])[0] == "split"
    np.testing.assert_array_equal(codec.matmul_stripes(G[10:], D), want)
    np.testing.assert_array_equal(
        codec.matmul_stripes(G[10:], D, tier="fused"), want
    )
    np.testing.assert_array_equal(
        codec.matmul_stripes(G[10:], D, tier="pipeline"), want
    )
    words = torch.from_numpy(D.view(np.int32)[:, :5000].copy())
    np.testing.assert_array_equal(
        codec.matmul_words(G[10:], words).numpy().view(np.uint8),
        want[:, :20000],
    )


def test_matmul_many_rides_one_coalesced_batch(rng):
    co = configure_coalescer()
    try:
        rs = ReedSolomon(10, 4, device="cpu")
        Ds = [rng.integers(0, 256, size=(10, 3000), dtype=np.uint8)
              for _ in range(3)]
        outs = rs.matmul_many(rs.G[10:], Ds)
        for D, got in zip(Ds, outs):
            np.testing.assert_array_equal(got, host_matvec(rs.gf, rs.G[10:], D))
        assert co.batches == 1 and co.flush_reasons["bulk"] == 1
        assert co.batch_sizes == {3: 3}
    finally:
        configure_coalescer()


def test_concurrent_encodes_coalesce_and_stay_exact(rng):
    """Eight threads encode at once through a lingering coalescer: every
    caller gets its own parity, and the requests share batches."""
    co = configure_coalescer(linger_seconds=0.05, hot_window_seconds=1.0)
    try:
        rs = ReedSolomon(4, 2, device="cpu")
        ref = RefRS(4, 2, backend="numpy")
        datas = [list(rng.integers(0, 256, size=(4, 4096), dtype=np.uint8))
                 for _ in range(8)]
        results = [None] * 8
        start = threading.Barrier(8)

        def worker(i):
            start.wait(timeout=10)
            results[i] = rs.encode(datas[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i in range(8):
            assert _same(results[i], ref.encode(datas[i]))
        assert sum(co.batch_sizes.values()) == 8
        assert co.batches < 8
    finally:
        configure_coalescer()


def test_staging_pool_reuses_buffers_per_shape():
    pool = StagingPool(pin=False, max_per_key=1)
    a = pool.acquire(2, 8)
    assert a.shape == (2, 8) and a.dtype == torch.uint8
    pool.release(a)
    pool.release(pool.acquire(4, 8))
    assert pool.acquire(2, 8) is a  # same shape: the released buffer
    assert pool.acquire(2, 8) is not a  # handed out once
    pool.release(a)
    pool.release(torch.empty((2, 8), dtype=torch.uint8))  # over max_per_key
    assert pool.acquire(2, 8) is a


def test_coalescer_cutoff_and_qos_context():
    assert coalesce_cutoff_bytes("cuda") == 8 << 20
    assert coalesce_cutoff_bytes("cpu") == 128 << 10
    assert current_qos() == ("live", "", 1)
    with qos_lane("background", "t1", 3):
        assert current_qos() == ("background", "t1", 3)
    assert current_qos() == ("live", "", 1)
    with pytest.raises(ValueError):
        with qos_lane("bulk"):
            pass


# --------------------------------------------------------------- no fallback


def test_default_device_is_the_card():
    """With no ``device`` the codec runs on CUDA; on a box without a GPU
    that raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReedSolomon(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceCodec()
    ReedSolomon(4, 2, backend="numpy")  # the host backend needs no card


def test_unported_routes_raise(monkeypatch):
    """The panel route, GF(2^16) and the MXU route run; the one route the
    reference has no kernel for either, an "mxu" matrix on the interleaved
    GF(2^16) words entry, still raises. No RS(k, r) parity matrix over
    GF(2^8) reaches the MXU budget, so a lowered budget sends RS(100,30)
    there."""
    import noise_ec_tpu_torch.ops.dispatch as dispatch

    codec = DeviceCodec(device="cpu")
    G = generator_matrix(GF256(), 100, 130, "cauchy")
    assert codec.route_for(G[100:]) == "panel"
    rs = ReedSolomon(100, 30, device="cpu")
    rng = np.random.default_rng(100)
    data = list(rng.integers(0, 256, size=(100, 64), dtype=np.uint8))
    want = RefRS(100, 30, backend="numpy").encode(data)
    assert _same(rs.encode(data), want)
    np.testing.assert_array_equal(
        codec.matmul_stripes(G[100:], np.stack(data)), np.stack(want[100:])
    )
    rs16 = ReedSolomon(4, 2, field="gf65536", device="cpu")
    want16 = RefRS(4, 2, field="gf65536", backend="numpy").encode(data[:4])
    assert _same(rs16.encode(data[:4]), want16)
    assert DeviceCodec(field="gf65536", device="cpu").field == "gf65536"
    with pytest.raises(ValueError, match="field"):
        DeviceCodec(field="gf2", device="cpu")
    monkeypatch.setattr(dispatch, "PANEL_XOR_BUDGET", 90_000)
    mxu = DeviceCodec(device="cpu")
    assert mxu.route_for(G[100:]) == "mxu"
    np.testing.assert_array_equal(
        mxu.matmul_stripes(G[100:], np.stack(data)), np.stack(want[100:])
    )
    assert _same(ReedSolomon(100, 30, device="cpu").encode(data), want)
    wide = DeviceCodec(field="gf65536", device="cpu")
    M16 = rs16.G[4:]
    monkeypatch.setattr(dispatch, "PANEL_XOR_BUDGET", 100)
    assert wide.route_for(M16) == "mxu"
    with pytest.raises(NotImplementedError, match="byte-sliced"):
        wide.matmul_words(M16, torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="mxu"):
        wide.bits_rows_for(M16)


def test_words_on_another_device_are_refused():
    codec = DeviceCodec(device="cpu")
    G = generator_matrix(GF256(), 4, 6, "cauchy")
    with pytest.raises(ValueError, match="codec on cpu"):
        codec.matmul_words(G[4:], torch.zeros((4, 8192), dtype=torch.int32,
                                              device="meta"))
    with pytest.raises(ValueError, match="tier"):
        codec.plan_for(G[4:], "panel")


# -------------------------------------------------------------------- purity


def _is_reference(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "noise_ec_tpu" \
        or name.startswith("noise_ec_tpu.")


# The stripe store, placement and the object service: both checks below
# must reach each of their modules.
_STORAGE_MODULES = [("store", "stripe"), ("store", "scrub"), ("store", "repair"),
             ("store", "convert"), ("placement", "ring"),
             ("placement", "deliver"), ("placement", "rebalance"),
             ("service", "tenants"), ("service", "cache"),
             ("service", "objects"), ("service", "http")]

# Chaos, trace collection, federation, the flight recorder, diagnosis, the
# fleet lab and the utils shims: both checks reach each of these too.
_HOST_MODULES = [("resilience", "chaos"), ("obs", "perfetto"),
                 ("obs", "collector"), ("obs", "federate"),
                 ("obs", "recorder"), ("obs", "diagnose"),
                 ("utils", "metrics"), ("utils", "profiling"),
                 ("fleet", "__init__"), ("fleet", "profile"),
                 ("fleet", "runner"), ("fleet", "score")]


def test_no_jax_or_reference_imports_in_the_port_source():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert {PORT / "parallel" / "batch.py",
            PORT / "parallel" / "streaming.py",
            PORT / "golden" / "codec.py", PORT / "matrix" / "bw.py",
            PORT / "codec" / "fec.py",
            PORT / "tools" / "hwcheck.py"} <= set(files)
    assert {PORT / group / f"{name}.py" for group, name in _STORAGE_MODULES} \
        <= set(files)
    assert {PORT / group / f"{name}.py" for group, name in _HOST_MODULES} \
        <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not _is_reference(name), f"{path}: imports {name}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(
        "noise_ec_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    ) + sorted(
        ".".join(("noise_ec_tpu_torch",) + p.parent.relative_to(PORT).parts)
        for p in PORT.rglob("__init__.py") if p.parent != PORT
    )
    assert {"noise_ec_tpu_torch.parallel.batch",
            "noise_ec_tpu_torch.parallel.streaming",
            "noise_ec_tpu_torch.golden.codec",
            "noise_ec_tpu_torch.matrix.bw",
            "noise_ec_tpu_torch.codec.fec",
            "noise_ec_tpu_torch.tools.hwcheck"} <= set(mods)
    assert {f"noise_ec_tpu_torch.{group}.{name}"
            for group, name in _STORAGE_MODULES} <= set(mods)
    assert {f"noise_ec_tpu_torch.{group}" + ("" if name == "__init__"
                                             else f".{name}")
            for group, name in _HOST_MODULES} <= set(mods)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'noise_ec_tpu' or m.startswith('noise_ec_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
