"""The port's codec breaker on the CPU: the ``CircuitBreaker`` against the
reference's under random scripts, and the codec contract asserted
directly on ``device="cpu"`` — retry once, trip and refuse with
``CodecUnavailableError`` (never the host arithmetic), the counters, the
open short-circuit, and the prober's re-close after which the device
gives the golden bytes; the errors that bypass the breaker (a refused
input, ``KernelBuildError``, ``KernelLaunchError``,
``NotImplementedError``, a lost CUDA context), which propagate with the
breaker and the counters as they were; and FEC's device decode route
behind the breaker."""

import threading
import time

import numpy as np
import pytest
import torch

import noise_ec_tpu_torch.codec.rs as port_rs
import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu.resilience.breakers import CircuitBreaker as RefBreaker
from noise_ec_tpu_torch.codec import FEC, ReedSolomon
from noise_ec_tpu_torch.golden import GoldenCodec
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix
from noise_ec_tpu_torch.obs.events import default_event_log
from noise_ec_tpu_torch.ops import dispatch
from noise_ec_tpu_torch.ops._build import KernelBuildError, KernelLaunchError
from noise_ec_tpu_torch.ops.dispatch import CodecUnavailableError, DeviceCodec
from noise_ec_tpu_torch.resilience import CircuitBreaker


@pytest.fixture(autouse=True)
def _fresh_breaker_and_observability():
    """A fresh process breaker and the port's registry and event log
    scoped to the test; the breaker is replaced again afterwards, so a
    test that trips it leaves nothing open behind."""
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    dispatch.configure_codec_breaker(reset_timeout=5.0,
                                     max_reset_timeout=60.0)
    yield
    dispatch.configure_codec_breaker(reset_timeout=5.0,
                                     max_reset_timeout=60.0)


def _refusals(reason: str) -> float:
    return port_registry.default_registry().counter(
        "noise_ec_codec_refused_total").labels(reason=reason).value


def _no_fallbacks() -> bool:
    """The reference's fallback family, which the port never records."""
    fam = port_registry.default_registry().counter(
        "noise_ec_codec_fallback_total")
    return all(fam.labels(reason=r).value == 0 for r in ("error", "open"))


@pytest.fixture
def no_host_products(monkeypatch):
    """Fail the test if a device codec's product reaches the host
    arithmetic (codec/rs.py's numpy-backend path, ``native_matvec``)."""
    def refuse(*a, **k):
        raise AssertionError("a device codec ran a product on the host")

    monkeypatch.setattr(port_rs, "native_matvec", refuse)


def _events(name: str) -> list:
    return default_event_log().dump(name=name)


# ------------------------------------------------------ CircuitBreaker


@pytest.mark.parametrize("seed", range(8))
def test_breaker_matches_the_reference_under_random_scripts(seed):
    """Random allow / record_success / record_failure / clock-step
    scripts give the same states, verdicts, open_remaining and seeded
    backoff delays on the port's breaker as on the reference's."""
    rng = np.random.default_rng(seed)
    kw = dict(failure_threshold=int(rng.integers(1, 4)),
              reset_timeout=float(rng.uniform(0.1, 2.0)),
              max_reset_timeout=8.0, seed=seed)
    t = [0.0]
    port = CircuitBreaker(clock=lambda: t[0], **kw)
    ref = RefBreaker(clock=lambda: t[0], **kw)
    for _ in range(400):
        op = int(rng.integers(0, 6))
        if op == 0:
            got = (port.allow(), ref.allow())
        elif op == 1:
            got = (port.record_success(), ref.record_success())
        elif op == 2:
            got = (port.record_failure(), ref.record_failure())
        elif op == 3:
            t[0] += float(rng.exponential(1.0))
            got = (None, None)
        elif op == 4:
            a = int(rng.integers(0, 10))
            got = (port.backoff_delay(a), ref.backoff_delay(a))
        else:
            got = (port.closed, ref.closed)
        assert got[0] == got[1]
        assert port.state() == ref.state()
        assert port.state_code() == ref.state_code()
        assert port.open_remaining() == ref.open_remaining()
        assert port.snapshot() == ref.snapshot()


def test_release_probe_gives_back_only_the_holders_slot():
    t = [0.0]
    br = CircuitBreaker(failure_threshold=1, reset_timeout=1.0,
                        clock=lambda: t[0])
    br.release_probe()  # closed: nothing to give back
    assert br.state() == "closed" and br.allow()
    br.record_failure()
    t[0] = 2.0
    assert br.state() == "half_open"
    assert br.allow()  # this thread holds the probe
    assert not br.allow()
    # Another thread cannot release it.
    other = threading.Thread(target=br.release_probe)
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    assert not br.allow()
    br.release_probe()
    assert br.state() == "half_open"  # state unchanged
    assert br.allow()  # the slot is free again
    br.record_success()
    assert br.state() == "closed"


# ------------------------------------------------------ the codec contract


def test_codec_breaker_retry_trip_refuse_and_reclose(rng, monkeypatch,
                                                    no_host_products):
    """A failing batched product is tried twice, trips the breaker and
    raises CodecUnavailableError chained to the fault, with nothing run
    on the host; while open, the device is not tried and each product is
    refused at once with reason="open"; with the fault gone the prober's
    canary re-closes it on the codec's device, and encode and reconstruct
    give the golden codec's bytes on the device again.

    The breaker reads a clock the test drives: it stands still from the
    trip to the end of the fault, so the breaker cannot turn half-open
    (and hand the probe to the test's own call or race the canary) while
    the refusals are asserted, however slowly the test runs; then it is
    moved past the reset timeout, and the canary re-closes the breaker."""
    now = [time.monotonic()]
    br = dispatch.configure_codec_breaker(reset_timeout=0.2,
                                          max_reset_timeout=1.0,
                                          clock=lambda: now[0])
    rs = ReedSolomon(10, 4, device="cpu")
    data = [rng.integers(0, 256, 4096, dtype=np.uint8) for _ in range(10)]
    want = list(GoldenCodec(10, 14).encode_all(np.stack(data)))
    lost = [None if i in (0, 5, 11) else s for i, s in enumerate(want)]
    calls = {"n": 0}
    real = DeviceCodec.matmul_stripes_many

    def boom(self, M, Ds):
        if self is rs._dev:  # the prober's canary has a codec of its own
            calls["n"] += 1
        raise RuntimeError("injected device fault")

    with monkeypatch.context() as mp:
        mp.setattr(DeviceCodec, "matmul_stripes_many", boom)
        with pytest.raises(CodecUnavailableError) as info:
            rs.encode(data)
        assert str(info.value.__cause__) == "injected device fault"
        assert calls["n"] == 2
        assert br.state() == "open"
        assert _refusals("error") == 1 and _refusals("open") == 0
        (ev,) = _events("codec.refused")
        assert ev["severity"] == "warn" and ev["attrs"]["reason"] == "error"
        # Open: the device is not tried, and nothing runs in its place.
        with pytest.raises(CodecUnavailableError):
            rs.encode(data)
        assert calls["n"] == 2
        assert _refusals("open") == 1
        with pytest.raises(CodecUnavailableError):
            rs.reconstruct(lost)
        assert calls["n"] == 2
        assert _refusals("open") == 2
        assert port_registry.default_registry().gauge(
            "noise_ec_codec_circuit_state").labels().read() in (1.0, 2.0)
    assert DeviceCodec.matmul_stripes_many is real
    now[0] += 1.0  # past the reset timeout: the canary may probe
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not br.closed:
        time.sleep(0.02)
    assert br.closed, br.snapshot()
    assert _events("codec.restore")
    assert dispatch._probe_target == rs._dev.device
    device_calls = port_registry.default_registry().counter(
        "noise_ec_kernel_calls_total").labels(entry="matmul_stripes")
    c0 = device_calls.value
    enc = rs.encode(data)
    assert device_calls.value == c0 + 1
    assert all(np.array_equal(a, b) for a, b in zip(enc, want))
    rec = rs.reconstruct(lost)
    assert device_calls.value == c0 + 2
    assert all(np.array_equal(a, b) for a, b in zip(rec, want))
    assert _refusals("error") == 1 and _refusals("open") == 2
    assert _no_fallbacks() and not _events("codec.fallback")


def test_one_transient_failure_is_absorbed_by_the_retry(rng, monkeypatch):
    br = dispatch.configure_codec_breaker(reset_timeout=5.0)
    rs = ReedSolomon(4, 2, device="cpu")
    data = [rng.integers(0, 256, 512, dtype=np.uint8) for _ in range(4)]
    real = DeviceCodec.matmul_stripes_many
    calls = {"n": 0}

    def flaky(self, M, Ds):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("transient")
        return real(self, M, Ds)

    monkeypatch.setattr(DeviceCodec, "matmul_stripes_many", flaky)
    enc = rs.encode(data)
    assert calls["n"] == 2 and br.closed
    assert _refusals("error") == 0 and _refusals("open") == 0
    want = ReedSolomon(4, 2, backend="numpy").encode(data)
    assert all(np.array_equal(a, b) for a, b in zip(enc, want))


def _lost_context(monkeypatch, rs):
    """Make ``rs``'s codec look like a CUDA codec whose context is gone:
    every synchronise raises, as after a sticky CUDA error."""
    def gone(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(rs._dev, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", gone)
    return RuntimeError("CUDA error: an illegal memory access was "
                        "encountered")


RAISE_CASES = {
    "refused_input": lambda mp, rs: ValueError(
        "K9/K10 index in 32 bits: 3000000000 words"),
    "plan": lambda mp, rs: ValueError(
        "no split-kernel plan fits this matrix"),
    "assertion": lambda mp, rs: AssertionError("a wrapper's own check"),
    "build": lambda mp, rs: KernelBuildError("nvcc failed"),
    "launch": lambda mp, rs: KernelLaunchError("ec_fused_split: CUDA error 9"),
    "unported": lambda mp, rs: NotImplementedError("no kernel for this"),
    "lost_context": _lost_context,
}


@pytest.mark.parametrize("case", sorted(RAISE_CASES))
@pytest.mark.parametrize("state", ["closed", "half_open"])
def test_raise_list_propagates_and_leaves_the_breaker_alone(
        rng, monkeypatch, case, state):
    """An error that bypasses the breaker propagates from encode, once
    (no retry), with the breaker's state, the refusal counters, the
    events and the half-open probe slot as they were."""
    t = [0.0]
    br = dispatch.configure_codec_breaker(reset_timeout=1.0,
                                          max_reset_timeout=4.0,
                                          clock=lambda: t[0])
    if state == "half_open":
        br.record_failure()
        t[0] = 2.0
    assert br.state() == state
    rs = ReedSolomon(4, 2, device="cpu")
    data = [rng.integers(0, 256, 256, dtype=np.uint8) for _ in range(4)]
    exc = RAISE_CASES[case](monkeypatch, rs)
    calls = {"n": 0}

    def fail(self, M, Ds):
        calls["n"] += 1
        raise exc

    monkeypatch.setattr(DeviceCodec, "matmul_stripes_many", fail)
    with pytest.raises(type(exc)) as info:
        rs.encode(data)
    assert info.value is exc
    assert calls["n"] == 1
    assert br.state() == state
    assert _refusals("error") == 0 and _refusals("open") == 0
    assert not _events("codec.refused")
    assert br.allow()  # the probe slot (half-open) was given back


def test_a_raise_on_the_retry_still_propagates(rng, monkeypatch):
    """A transient first failure, then a refused launch on the retry:
    the launch error propagates and records no breaker failure."""
    br = dispatch.configure_codec_breaker(reset_timeout=1.0)
    rs = ReedSolomon(4, 2, device="cpu")
    data = [rng.integers(0, 256, 256, dtype=np.uint8) for _ in range(4)]
    errors = [RuntimeError("transient"), KernelLaunchError("refused")]

    def fail(self, M, Ds):
        raise errors.pop(0)

    monkeypatch.setattr(DeviceCodec, "matmul_stripes_many", fail)
    with pytest.raises(KernelLaunchError):
        rs.encode(data)
    assert br.closed and _refusals("error") == 0


def test_errors_trip_when_the_context_survives(rng, monkeypatch,
                                              no_host_products):
    """On a CUDA codec whose synchronise still works, a RuntimeError is
    not a lost context: it is retried, trips the breaker and is refused,
    as any other, and never runs on the host."""
    br = dispatch.configure_codec_breaker(reset_timeout=5.0)
    rs = ReedSolomon(4, 2, device="cpu")
    monkeypatch.setattr(rs._dev, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(dispatch, "ensure_codec_prober", lambda d: None)
    calls = {"n": 0}

    def fail(self, M, Ds):
        calls["n"] += 1
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(DeviceCodec, "matmul_stripes_many", fail)
    data = [rng.integers(0, 256, 256, dtype=np.uint8) for _ in range(4)]
    with pytest.raises(CodecUnavailableError):
        rs.encode(data)
    assert calls["n"] == 2
    assert br.state() == "open" and _refusals("error") == 1


def _geometries():
    """(field, matrix) pairs covering every route of both fields: parity
    and recovery matrices of baked and panel codes, and a matrix past the
    panel budget ("mxu")."""
    out = []
    for field, codes in (("gf256", [(4, 2), (10, 4), (50, 20), (229, 6)]),
                         ("gf65536", [(4, 2), (10, 4), (60, 20),
                                      (200, 56)])):
        dev = DeviceCodec(field=field, device="cpu")
        for k, r in codes:
            G = generator_matrix(dev.gf, k, k + r, "cauchy")
            out.append((field, np.ascontiguousarray(G[k:])))
            lost = list(range(0, min(r, k)))
            present = [i for i in range(k + r) if i not in lost][:k]
            out.append((field, reconstruction_matrix(dev.gf, G, present,
                                                     lost)))
    rng = np.random.default_rng(3)
    out.append(("gf256", rng.integers(1, 256, size=(200, 200),
                                      dtype=np.uint8)))
    return out


def test_no_supported_geometry_raises_not_implemented():
    """Every route of both fields runs through matmul_stripes_many (the
    breaker's entry) without NotImplementedError, equal to the host
    arithmetic: the raise list's NotImplementedError marks only an
    unported route, and none is reachable from it."""
    codecs = {f: DeviceCodec(field=f, device="cpu")
              for f in ("gf256", "gf65536")}
    routes = set()
    rng = np.random.default_rng(5)
    for field, M in _geometries():
        dev = codecs[field]
        routes.add((field, dev.route_for(M)))
        D = rng.integers(0, dev.gf.order, size=(M.shape[1], 8),
                         dtype=np.uint64).astype(dev.gf.dtype)
        (got,) = dev.matmul_stripes_many(M, [D])
        assert np.array_equal(got, host_matvec(dev.gf, M, D))
    assert routes >= {("gf256", "baked"), ("gf256", "panel"),
                      ("gf256", "mxu"), ("gf65536", "baked"),
                      ("gf65536", "panel"), ("gf65536", "mxu")}


def test_fec_device_route_refuses_while_open(rng, monkeypatch,
                                            no_host_products):
    """FEC(bw_route="device") decodes a corrupt share on the device while
    the breaker is closed; while it is open the decode raises
    CodecUnavailableError, counted as reason="open", with no product run
    anywhere; once it closes the device decodes again."""
    br = dispatch.configure_codec_breaker(reset_timeout=60.0)
    fec = FEC(10, 14, bw_route="device", device="cpu")
    payload = rng.integers(0, 256, 10 * 512, dtype=np.uint8).tobytes()
    shares = fec.encode_shares(payload)
    shares[3].data = bytes(
        (np.frombuffer(shares[3].data, dtype=np.uint8) ^ 0x5A).tobytes())
    syndromes = {"n": 0}
    real_mul = DeviceCodec.matmul_stripes
    real_syn = DeviceCodec.syndrome_stripes

    def count_syn(self, *a, **k):
        syndromes["n"] += 1
        return real_syn(self, *a, **k)

    def count_mul(self, *a, **k):
        syndromes["n"] += 1
        return real_mul(self, *a, **k)

    monkeypatch.setattr(DeviceCodec, "syndrome_stripes", count_syn)
    monkeypatch.setattr(DeviceCodec, "matmul_stripes", count_mul)
    assert fec.decode(shares) == payload
    assert syndromes["n"] >= 1
    br.record_failure()
    assert br.state() == "open"
    syndromes["n"] = 0
    with pytest.raises(CodecUnavailableError):
        fec.decode(shares)
    assert syndromes["n"] == 0
    assert _refusals("open") == 1
    br.record_success()
    assert fec.decode(shares) == payload
    assert syndromes["n"] >= 1


# -- empty products: the reference's arrays, and never a device failure --

_EMPTY = {
    "zero_rows": ((0, 4), (4, 64)),
    "zero_width": ((2, 4), (4, 0)),
    "both": ((0, 4), (4, 0)),
}


@pytest.mark.parametrize("case", sorted(_EMPTY))
@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_empty_products_return_the_reference_arrays(field, backend, case):
    """A product with zero rows or zero width returns the reference's
    ``(0, S)`` / ``(r, 0)`` arrays from ``matmul_many`` and ``_mul`` on
    both backends, before the gate and the breaker: the breaker stays
    closed, nothing is refused, and the next encode runs."""
    from noise_ec_tpu.codec import ReedSolomon as RefReedSolomon

    kw = {"device": "cpu"} if backend == "device" else {}
    rs = ReedSolomon(4, 2, field=field, backend=backend, **kw)
    ref = RefReedSolomon(4, 2, field=field, backend=backend)
    dt = rs.gf.dtype
    m_shape, d_shape = _EMPTY[case]
    M = np.ones(m_shape, dt)
    Ds = [np.zeros(d_shape, dt), np.ones(d_shape, dt)]
    got, want = rs.matmul_many(M, Ds), ref.matmul_many(M, Ds)
    assert [(g.shape, g.dtype) for g in got] == [
        (np.asarray(w).shape, np.asarray(w).dtype) for w in want]
    assert rs._mul(M, Ds[0]).shape == want[0].shape
    assert dispatch.codec_breaker().closed
    assert _refusals("error") == 0 and _refusals("open") == 0
    data = bytes(range(200))
    enc = rs.encode(rs.split(data))
    want_enc = ref.encode(ref.split(data))
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(enc, want_enc))


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_device_codec_empty_entries_launch_nothing(field):
    """Every ``DeviceCodec`` product entry returns its empty result for
    zero rows or zero width without a gate slot or an entry count."""
    from noise_ec_tpu_torch.obs.profiling import kernel_counters

    dev = DeviceCodec(field=field, device="cpu")
    dt = dev.gf.dtype
    before = kernel_counters.snapshot()
    gate = dispatch.configure_device_gate(capacity=1, wait_timeout=30.0)
    gate.acquire()  # a call that took a slot would wait here
    try:
        _empty_entries(dev, dt, field)
    finally:
        gate.release()
        dispatch.configure_device_gate()
    assert kernel_counters.snapshot() == before


def _empty_entries(dev, dt, field):
    assert dev.matmul_stripes(np.ones((0, 3), dt),
                              np.ones((3, 40), dt)).shape == (0, 40)
    assert dev.matmul_stripes(np.ones((2, 3), dt),
                              np.ones((3, 0), dt)).shape == (2, 0)
    outs = dev.matmul_stripes_many(np.ones((0, 3), dt),
                                   [np.ones((3, 8), dt)] * 2)
    assert [o.shape for o in outs] == [(0, 8), (0, 8)]
    w = torch.ones((2, 3, 16), dtype=torch.int32)
    assert dev.matmul_words_batch(np.ones((0, 3), dt), w).shape == (2, 0, 16)
    assert dev.matmul_words(np.ones((2, 3), dt),
                            w[0, :, :0]).shape == (2, 0)
    if field == "gf65536":
        assert dev.matmul_words_bytesliced(
            np.ones((0, 3), dt),
            torch.ones((6, 16), dtype=torch.int32)).shape == (0, 16)
