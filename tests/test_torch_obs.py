"""The port's observability core on the CPU against the JAX package:
``obs.metrics``, ``obs.registry`` (the ``METRICS`` table and the bucket
edges), ``obs.events``, ``obs.profiling`` and ``obs.device`` (the
compile/execute split on ``DeviceCodec(device="cpu")``, plan-derived
program costs, the roofline gauge's entries, the device-memory
snapshot), and the stream chunk histogram."""

import threading

import numpy as np
import pytest
import torch

import noise_ec_tpu.obs.events as ref_events
import noise_ec_tpu.obs.metrics as ref_metrics
import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu_torch.obs.device as obs_device
import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.metrics as port_metrics
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.obs import hbm_snapshot
from noise_ec_tpu_torch.obs.device import (
    analyze_program,
    achieved_gbps,
    device_op,
    peak_hbm_gbps,
)
from noise_ec_tpu_torch.obs.profiling import (
    device_trace,
    kernel_counters,
    record_kernel,
)
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.ops import _build
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry and event log, scoped to the test
    (the reference's are reset by the shared conftest)."""
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    yield


def _value(family, **labels) -> float:
    return family.labels(**labels).value


# ------------------------------------------------------------ declarations


def test_metrics_table_is_the_references():
    """Every name, type, help string and label tuple, in order."""
    """The reference's table, whole and in order, then the families only
    the port records (the breaker's refusals, the kernels' launches, the
    words entries' pattern misses and device seconds, and how the words
    rebuild assembled its codeword)."""
    port_only = port_registry.PORT_METRICS
    assert list(port_only) == ["noise_ec_codec_refused_total",
                               "noise_ec_kernel_launches",
                               "noise_ec_batch_pattern_misses_total",
                               "noise_ec_batch_device_seconds",
                               "noise_ec_batch_assembly_total"]
    assert port_only["noise_ec_batch_assembly_total"][0] == "counter"
    assert port_only["noise_ec_batch_assembly_total"][2] == ("entry", "path")
    assert not set(port_only) & set(ref_registry.METRICS)
    assert list(port_registry.METRICS) == (list(ref_registry.METRICS)
                                           + list(port_only))
    assert {k: v for k, v in port_registry.METRICS.items()
            if k not in port_only} == ref_registry.METRICS
    assert port_registry.PIPELINE_STAGES == ref_registry.PIPELINE_STAGES


def test_bucket_edges_are_the_references():
    for name in ("LATENCY_BUCKETS", "DEVICE_LATENCY_BUCKETS",
                 "SIZE_BUCKETS"):
        assert getattr(port_metrics, name) == getattr(ref_metrics, name)
    assert (port_registry._HISTOGRAM_BUCKETS
            == ref_registry._HISTOGRAM_BUCKETS)


def test_event_vocabulary_is_the_references():
    assert port_events.PORT_EVENT_NAMES == ("codec.refused",)
    assert port_events.EVENT_NAMES == (ref_events.EVENT_NAMES
                                       + port_events.PORT_EVENT_NAMES)
    assert port_events.EVENT_FIELDS == ref_events.EVENT_FIELDS
    for name in ("codec.refused", "codec.restore", "qos.preempt",
                 "qos.linger"):
        assert name in port_events.EVENT_NAMES


# ------------------------------------------------------------ same script


def _collected(reg) -> list:
    """A registry's collect() as plain data: per family its name, type,
    help, labels, buckets and every child's value or histogram snapshot."""
    out = []
    for fam in reg.collect():
        children = []
        for key, child in sorted(fam.children(), key=lambda kc: kc[0]):
            if fam.type == "histogram":
                snap = child.snapshot()
                children.append((key, snap["counts"], snap["sum"],
                                 snap["count"], child.p50, child.p99))
            elif fam.type == "gauge":
                children.append((key, child.read()))
            else:
                children.append((key, child.value))
        out.append((fam.name, fam.type, fam.help, fam.label_names,
                    fam.buckets, children))
    return out


def _record_script(reg, rng) -> None:
    """Counters, gauges (set, add, callback) and histograms over several
    label sets and bucket sets, with values drawn from ``rng``."""
    calls = reg.counter("noise_ec_kernel_calls_total")
    hist = reg.histogram("noise_ec_device_op_seconds")
    sizes = reg.histogram("noise_ec_stream_chunk_seconds")
    fallback = reg.counter("noise_ec_codec_fallback_total")
    for _ in range(200):
        entry = ("matmul_stripes", "matmul_words", "decode1_words")[
            int(rng.integers(0, 3))]
        calls.labels(entry=entry).add(float(rng.integers(1, 4)))
        hist.labels(kernel=entry, route=("compile", "execute")[
            int(rng.integers(0, 2))]).observe(float(rng.uniform(1e-6, 2.0)))
        sizes.labels().observe(float(rng.exponential(0.01)))
    fallback.labels(reason="error").add(1)
    fallback.labels(reason="open").add(3)
    reg.gauge("noise_ec_hbm_live_bytes").labels().set(12345.0)
    reg.gauge("noise_ec_lane_queue_depth").labels(lane="live").add(2.0)
    reg.gauge("noise_ec_lane_queue_depth").set_callback(lambda: 7.0,
                                                        lane="background")
    port_or_ref_build = reg.gauge("noise_ec_build_info")
    port_or_ref_build.labels(backend="cuda", kernel="k", version="v").set(1)


def test_registry_same_script_same_collect():
    port, ref = Registry(), ref_registry.Registry()
    _record_script(port, np.random.default_rng(7))
    _record_script(ref, np.random.default_rng(7))
    assert _collected(port) == _collected(ref)
    # A reset zeroes both alike and drops the callback child.
    port.reset_values()
    ref.reset_values()
    assert _collected(port) == _collected(ref)
    with pytest.raises(KeyError):
        port.counter("noise_ec_not_declared")
    with pytest.raises(TypeError):
        port.gauge("noise_ec_kernel_calls_total")


class _StampTracer:
    """The two calls an event log makes of a tracer, with fixed stamps."""

    @staticmethod
    def node_label() -> str:
        return "n1#abcd"

    @staticmethod
    def current_trace_id() -> str:
        return "t-42"


def test_event_log_same_script_same_records():
    """The same emissions (with a burst that the per-name bucket
    suppresses) give the same records, minus the wall-clock stamp, and the
    same counters."""
    logs = []
    for mod_events, mod_reg in ((port_events, port_registry),
                                (ref_events, ref_registry)):
        reg = mod_reg.Registry()
        log = mod_events.EventLog(registry=reg, tracer=_StampTracer(),
                                  rate_per_name=1e-9, burst_per_name=3)
        for i in range(6):
            log.emit("codec.fallback", "warn", reason="error", i=i)
        log.emit("qos.preempt", lane="live", streak=2)
        log.emit("qos.linger", "bogus-severity", tenant="t",
                 obj=object.__name__)
        log.emit("codec.restore", route="device")
        recs = [{k: v for k, v in r.items() if k != "ts"}
                for r in log.dump()]
        logs.append((recs, _collected(reg), log.suppressed_total(
            "codec.fallback")))
    assert logs[0] == logs[1]
    assert logs[0][2] == 3


def test_default_tracer_hook_stamps_records():
    """A log built without a tracer stamps no node and no trace id until
    set_default_tracer installs one; None restores the empty stamps."""
    log = port_events.EventLog(registry=Registry())
    log.emit("codec.restore", route="device")
    port_events.set_default_tracer(_StampTracer())
    try:
        log.emit("codec.restore", route="device")
    finally:
        port_events.set_default_tracer(None)
    log.emit("codec.restore", route="device")
    stamps = [(r["node"], r["trace_id"]) for r in log.dump()]
    assert stamps == [("", None), ("n1#abcd", "t-42"), ("", None)]


# ------------------------------------------------------ obs/device on cpu


def _fresh_matrices(rng, n):
    mats = []
    for _ in range(n):
        M = generator_matrix(DeviceCodec(device="cpu").gf, 4, 6,
                             "cauchy")[4:].copy()
        M ^= rng.integers(1, 255, size=M.shape, dtype=np.uint8)
        mats.append(M)
    return mats


def test_compile_counter_advances_once_per_key(rng):
    """N distinct matrices -> the compile counter advances exactly N on
    the port's codec; repeats advance it zero times while the execute
    route keeps observing (tests/test_device_obs.py's churn bar)."""
    dev = DeviceCodec(device="cpu")
    reg = default_registry()
    compiles = reg.counter("noise_ec_jit_compiles_total")
    ops = reg.histogram("noise_ec_device_op_seconds")
    entry = "matmul_stripes"
    before = _value(compiles, kernel=entry)
    exec_before = ops.labels(kernel=entry, route="execute").count
    N = 3
    mats = _fresh_matrices(rng, N)
    D = rng.integers(0, 256, size=(4, 224)).astype(np.uint8)
    for M in mats:
        dev.matmul_stripes(M, D)
    assert _value(compiles, kernel=entry) - before == N
    for M in mats:
        dev.matmul_stripes(M, D)
        dev.matmul_stripes(M, D)
    assert _value(compiles, kernel=entry) - before == N
    assert ops.labels(kernel=entry,
                      route="execute").count - exec_before == 2 * N
    assert ops.labels(kernel=entry, route="compile").count >= N


def test_failed_dispatch_keeps_the_compile_slot_free(rng):
    """A dispatch that raises records nothing, and through a codec entry
    leaves the matrix unplanned: the next call is the compile."""
    reg = Registry()
    with pytest.raises(RuntimeError):
        with device_op("testfail", "compile", nbytes=1, registry=reg):
            raise RuntimeError("boom")
    assert reg.counter("noise_ec_jit_compiles_total").labels(
        kernel="testfail").value == 0
    assert reg.histogram("noise_ec_device_op_seconds").labels(
        kernel="testfail", route="compile").count == 0
    with pytest.raises(ValueError):
        device_op("testfail", "warm", registry=reg)

    dev = DeviceCodec(device="cpu")
    (M,) = _fresh_matrices(rng, 1)
    D = rng.integers(0, 256, size=(4, 96)).astype(np.uint8)
    compiles = default_registry().counter("noise_ec_jit_compiles_total")
    c0 = _value(compiles, kernel="matmul_stripes")

    def boom(*a, **k):
        raise RuntimeError("injected")

    dev._stripes = boom
    with pytest.raises(RuntimeError, match="injected"):
        dev.matmul_stripes(M, D)
    del dev._stripes
    assert _value(compiles, kernel="matmul_stripes") == c0
    dev.matmul_stripes(M, D)
    assert _value(compiles, kernel="matmul_stripes") == c0 + 1


def test_record_kernel_feeds_registry_families():
    reg = default_registry()
    calls = reg.counter("noise_ec_kernel_calls_total")
    nbytes = reg.counter("noise_ec_kernel_bytes_total")
    c0 = _value(calls, entry="regkern")
    b0 = _value(nbytes, entry="regkern")
    bag0 = kernel_counters.get("regkern_bytes")
    record_kernel("regkern", 1024)
    record_kernel("regkern", 512)
    assert _value(calls, entry="regkern") - c0 == 2
    assert _value(nbytes, entry="regkern") - b0 == 1536
    assert kernel_counters.get("regkern_bytes") - bag0 == 1536


def test_kernel_launches_are_exposed_as_a_gauge():
    """``ops.expose_launch_counts`` reads each kernel's ``LAUNCHES``
    count into ``/metrics`` at collect time, zeroed by
    ``reset_launch_counts`` (a CUDA codec calls it in its constructor)."""
    from noise_ec_tpu_torch.obs.export import render_prometheus
    from noise_ec_tpu_torch.ops import (
        expose_launch_counts, fused, launch_counts, reset_launch_counts,
    )

    expose_launch_counts()
    reset_launch_counts()
    fused.LAUNCHES["fused_split"] += 3
    try:
        text = render_prometheus()
        assert 'noise_ec_kernel_launches{kernel="fused_split"} 3' in text
        assert 'noise_ec_kernel_launches{kernel="fused_encode"} 0' in text
        family = default_registry().gauge("noise_ec_kernel_launches")
        read = {key[0]: child.read() for key, child in family.children()}
        assert read == {name: float(n) for name, n in launch_counts().items()}
    finally:
        reset_launch_counts()
    assert 'noise_ec_kernel_launches{kernel="fused_split"} 0' in (
        render_prometheus())


def test_every_public_entry_is_counted_and_timed(rng):
    """Each public DeviceCodec entry records its kernel calls and as many
    device_op observations, on both fields; an entry that is one product
    of another entry is counted under that entry's name, as in the
    reference (syndrome_stripes under matmul_stripes, the decode1 entries
    under matmul_words and matmul_words_bytesliced)."""
    reg = default_registry()
    calls = reg.counter("noise_ec_kernel_calls_total")
    ops = reg.histogram("noise_ec_device_op_seconds")

    def observed(entry):
        return sum(ops.labels(kernel=entry, route=r).count
                   for r in ("compile", "execute"))

    dev = DeviceCodec(device="cpu")
    dev16 = DeviceCodec(field="gf65536", device="cpu")
    A = np.ascontiguousarray(generator_matrix(dev.gf, 4, 7, "cauchy")[4:])
    G16 = np.ascontiguousarray(
        generator_matrix(dev16.gf, 4, 7, "cauchy")[4:])
    D = rng.integers(0, 256, size=(4, 256)).astype(np.uint8)
    full = np.concatenate([D, host_matvec(dev.gf, A, D)])
    words = torch.from_numpy(
        rng.integers(0, 256, size=(7, 1024), dtype=np.uint8)).view(
            torch.int32)
    words16 = torch.from_numpy(
        rng.integers(0, 256, size=(14, 1024), dtype=np.uint8)).view(
            torch.int32)
    cases = [
        ("matmul_stripes", 1, lambda: dev.matmul_stripes(A, D)),
        ("matmul_stripes", 1, lambda: dev.matmul_stripes_many(A, [D, D])),
        ("matmul_stripes", 1, lambda: dev.syndrome_stripes(A, full)),
        ("matmul_words", 1, lambda: dev.matmul_words(A, words[:4])),
        ("matmul_words", 1,
         lambda: dev.matmul_words_batch(A, words[None, :4])),
        ("matmul_words", 1, lambda: dev16.matmul_words(G16, words16[:4])),
        ("matmul_words", 1, lambda: dev.decode1_words(A, 1, words)),
        ("matmul_words_bytesliced", 1,
         lambda: dev16.matmul_words_bytesliced(G16, words16[:8])),
        ("matmul_words_bytesliced", 1,
         lambda: dev16.decode1_words_bytesliced(G16, 1, words16)),
    ]
    for entry, n, fn in cases:
        c0, o0 = _value(calls, entry=entry), observed(entry)
        fn()
        assert _value(calls, entry=entry) - c0 == n, entry
        assert observed(entry) - o0 == n, entry


def test_analyze_program_counts_from_the_plan(rng):
    """The program-cost gauges read the plan's own counts: bytes
    4 x (rows in + rows out) x words, operations the raw XOR terms x the
    words of one bit plane; a new key's first call exports them."""
    reg = Registry()
    got = analyze_program("k", 1000, 10, 4, 8192, registry=reg)
    assert got == {"flops": 1000 * 8192 / 8, "bytes": 4 * 14 * 8192,
                   "intensity": (1000 * 1024) / (4 * 14 * 8192)}
    assert _value(reg.gauge("noise_ec_device_program_flops"),
                  kernel="k") == got["flops"]
    assert _value(reg.gauge("noise_ec_device_program_bytes"),
                  kernel="k") == got["bytes"]
    # Unusable counts never raise.
    assert analyze_program("k", "x", 1, 1, 1, registry=reg) is None

    obs_device.set_analysis_interval(0.0)
    try:
        dev = DeviceCodec(device="cpu")
        (M,) = _fresh_matrices(rng, 1)
        D = rng.integers(0, 256, size=(4, 4096)).astype(np.uint8)
        dev.matmul_stripes(M, D)
        flops = default_registry().gauge("noise_ec_device_program_flops")
        nbytes = default_registry().gauge("noise_ec_device_program_bytes")
        assert _value(flops, kernel="matmul_stripes") == \
            dev._xor_cost_for(M) * 1024 / 8
        assert _value(nbytes, kernel="matmul_stripes") == 4 * 6 * 1024
    finally:
        obs_device.set_analysis_interval(60.0)


def test_roofline_reads_only_synced_entries(rng):
    """Only an entry whose host time covers the device's work feeds the
    achieved-bandwidth side of the roofline: matmul_stripes does, the
    words entries (timed to their submit) never do."""
    dev = DeviceCodec(device="cpu")
    dev16 = DeviceCodec(field="gf65536", device="cpu")
    (M,) = _fresh_matrices(rng, 1)
    G16 = np.ascontiguousarray(
        generator_matrix(dev16.gf, 4, 6, "cauchy")[4:])
    D = rng.integers(0, 256, size=(4, 4096)).astype(np.uint8)
    words = torch.from_numpy(D).view(torch.int32)
    for _ in range(3):
        dev.matmul_stripes(M, D)
        dev.matmul_words(M, words)
        dev16.matmul_words_bytesliced(G16, torch.cat([words, words]))
    assert achieved_gbps("matmul_stripes") > 0.0
    assert achieved_gbps("matmul_words") == 0.0
    assert achieved_gbps("matmul_words_bytesliced") == 0.0


def test_peak_bandwidth_is_the_h100s():
    assert peak_hbm_gbps() == 3350.0
    obs_device.set_peak_hbm_gbps(2000.0)
    try:
        assert peak_hbm_gbps() == 2000.0
    finally:
        obs_device.set_peak_hbm_gbps(None)


def test_hbm_snapshot(monkeypatch):
    """Empty without a CUDA device; with torch.cuda's readers patched, the
    fields read them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hbm_snapshot() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 1000)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 5000)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (30, 80))
    assert hbm_snapshot() == {"live_bytes": 1000, "peak_bytes": 5000,
                              "limit_bytes": 80, "bytes_in_use": 50}
    obs_device.install_hbm_gauges(Registry())  # installs without raising
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (_ for _ in ()).throw(RuntimeError()))
    assert hbm_snapshot() == {}


def test_set_build_info_names_the_ports_backend_and_kernels():
    reg = Registry()
    port_registry.set_build_info(registry=reg)
    (fam,) = reg.collect()
    ((key, child),) = fam.children()
    assert key[:2] == ("cuda", ",".join(_build.SOURCES))
    assert child.value == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None):
        pass
    with device_trace(str(tmp_path)):
        torch.ones(8).sum()
    (trace,) = tmp_path.iterdir()
    assert trace.suffix == ".json" and trace.stat().st_size > 0


def test_histogram_and_counters_are_thread_safe():
    hist = port_metrics.Histogram(port_metrics.DEVICE_LATENCY_BUCKETS)
    counters = port_metrics.Counters()

    def work():
        for i in range(2000):
            hist.observe(1e-5 * (i % 7 + 1))
            counters.add("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert hist.count == 16000 and counters.get("n") == 16000


# ------------------------------------------------------- stream histogram


def test_stream_chunk_histogram_one_observe_a_chunk(rng):
    from noise_ec_tpu_torch.parallel import StreamingEncoder, decode_stream

    hist = default_registry().histogram(
        "noise_ec_stream_chunk_seconds").labels()
    enc = StreamingEncoder(4, 2, chunk_bytes=4096, device="cpu")
    data = rng.integers(0, 256, size=4096 * 5 + 123,
                        dtype=np.uint8).tobytes()
    c0 = hist.count
    chunks = list(enc.encode_bytes(data, depth=2))
    assert len(chunks) == 6
    assert hist.count - c0 == 6
    assert decode_stream(chunks, 4, len(data)) == data
