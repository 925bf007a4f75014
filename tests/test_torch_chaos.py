"""The port's chaos layer (``noise_ec_tpu_torch.resilience.chaos``) against
the reference's: the profile grammar, the seeded churn windows,
``ChaosLink``'s reproducibility and its fault decisions frame for frame
against the reference's link on the same profile and seed, the proxy's
byte stream against the reference's proxy, a port node and a reference node
exchanging lines through a port ``ChaosProxy``, the forced-reset reconnect,
and the acceptance soak (two port TCP nodes through the proxy: drop,
corruption, a directional partition and a reset, healed by reconnect,
NACK repair and announce; ``/healthz`` flips 503 -> 200; the flight
recorder writes one bundle). Codecs run on ``backend="numpy"``. Tolerance:
exact (equal plans, stats, bytes and documents)."""

import json
import socket
import struct
import threading
import time
from urllib.request import urlopen

import numpy as np
import pytest

from noise_ec_tpu.host.plugin import ShardPlugin as RefShardPlugin
from noise_ec_tpu.host.transport import TCPNetwork as RefTCPNetwork
from noise_ec_tpu.resilience.chaos import ChaosLink as RefChaosLink
from noise_ec_tpu.resilience.chaos import ChaosProfile as RefChaosProfile
from noise_ec_tpu.resilience.chaos import ChaosProxy as RefChaosProxy
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import FaultInjector, TCPNetwork
from noise_ec_tpu_torch.obs import events as port_events
from noise_ec_tpu_torch.obs import trace as port_trace
from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.resilience import ChaosLink, ChaosProfile, ChaosProxy
from noise_ec_tpu_torch.store import RepairEngine, StripeStore


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry, event log and tracer, scoped to
    the test (the shared conftest resets only the reference's)."""
    default_registry().reset_values()
    port_events.default_event_log().clear()
    port_trace.default_tracer().clear()
    yield


# A loop thread's wait for a lock that the lockgraph harness reports as a
# stall. The reference's soak asserts none past 0.2 s, but under six pytest
# workers the transport's loop waits 0.20-0.30 s on TCPNetwork._lock in the
# reference's soak and the port's alike (the same code; ROADMAP queue 3),
# so the port's soak flags waits from 1 s, five times that bound. Lock-order
# cycles and sleeps on a loop thread are asserted as the reference does.
LOOP_BLOCK_SECONDS = 1.0


@pytest.fixture
def lockgraph():
    """The reference's lockgraph harness (tests/conftest.py ``lockgraph``)
    at ``LOOP_BLOCK_SECONDS``: zero lock-order cycles and no loop thread
    blocked over the run."""
    from noise_ec_tpu.analysis import lockgraph as lg

    graph = lg.install(block_threshold=LOOP_BLOCK_SECONDS)
    try:
        yield graph
    finally:
        lg.uninstall()
    report = graph.report()
    assert report["locks"], "lockgraph engaged but saw no locks created"
    assert report["cycles"] == [], (
        f"lock-order cycles over the run: {report['cycles']}"
    )
    assert report["loop_block_events"] == [], (
        "loop threads blocked during the run: "
        f"{report['loop_block_events']}"
    )


def counter_value(name: str, **labels) -> float:
    return default_registry().counter(name).labels(**labels).value


# ------------------------------------------------------------ chaos model


def test_chaos_profile_parse_grammar():
    p = ChaosProfile.parse(
        "drop=0.05, corrupt=0.01,delay=0.002,jitter=0.001,"
        "bandwidth=1048576,partition@2:2:a2b,partition@9:1,"
        "reset@5,kill@7:1.5"
    )
    assert p.drop == 0.05 and p.corrupt == 0.01
    assert p.delay == 0.002 and p.jitter == 0.001
    assert p.bandwidth == 1048576
    assert p.partitions == ((2.0, 2.0, "a2b"), (9.0, 1.0, "both"))
    assert p.resets == (5.0,)
    assert p.kills == ((7.0, 1.5),)
    assert p.partitioned("a2b", 2.5)
    assert not p.partitioned("b2a", 2.5)
    assert not p.partitioned("a2b", 4.0)  # healed
    assert p.partitioned("a2b", 9.5) and p.partitioned("b2a", 9.5)
    assert p.partitioned("a2b", 7.5) and p.killed(7.5)
    for bad in ("drop", "partition@1", "kill@3", "frobnicate=1", "x@1",
                "churn@1", "churn@1:0:1", "churn@1:2:0", "churn@1:2:1:-1"):
        with pytest.raises(ValueError):
            ChaosProfile.parse(bad)
    c = ChaosProfile.parse("churn@2:4:0.5,churn@0:1:0.2:0.3")
    assert c.churns == ((2.0, 4.0, 0.5, 0.0), (0.0, 1.0, 0.2, 0.3))


@pytest.mark.parametrize("text", [
    "drop=0.05,corrupt=0.01,reset@0.6,partition@1.2:2:a2b",
    "drop=0.1,duplicate=0.05,corrupt=0.05,reorder=0.1,delay=0.001,"
    "jitter=0.002,bandwidth=65536,partition@1:0.5:a2b",
    "kill@7:1.5,churn@2:4:0.5,churn@0:1:0.2:0.3,partition@9:1",
])
def test_chaos_profile_equals_reference(text):
    p, ref = ChaosProfile.parse(text), RefChaosProfile.parse(text)
    fields = ("drop", "duplicate", "corrupt", "reorder", "delay", "jitter",
              "bandwidth", "partitions", "resets", "kills", "churns")
    assert {f: getattr(p, f) for f in fields} == {
        f: getattr(ref, f) for f in fields}
    for seed in (0, 7, 1234):
        for stream in (0, 3):
            assert p.churn_windows(seed, 120.0, stream=stream) == \
                ref.churn_windows(seed, 120.0, stream=stream)
    for t in np.linspace(0.0, 12.0, 97):
        for d in ("a2b", "b2a"):
            assert p.partitioned(d, float(t)) == ref.partitioned(d, float(t))
        assert p.killed(float(t)) == ref.killed(float(t))


def test_chaos_churn_windows_seeded_reproducibility():
    p = ChaosProfile.parse("churn@1:3:0.5:0.8")
    w1 = p.churn_windows(7, horizon=60.0, stream=3)
    w2 = p.churn_windows(7, horizon=60.0, stream=3)
    assert w1 == w2 and len(w1) == 20  # one cycle per interval
    assert list(w1) == sorted(w1)
    for i, (start, down) in enumerate(w1):
        assert down == 0.5
        assert abs(start - (1.0 + 3.0 * i)) <= 0.8 + 1e-9
    assert p.churn_windows(8, horizon=60.0, stream=3) != w1
    assert p.churn_windows(7, horizon=60.0, stream=4) != w1
    exact = ChaosProfile.parse("churn@0:10:1").churn_windows(1, 25.0)
    assert exact == ((0.0, 1.0), (10.0, 1.0), (20.0, 1.0))
    assert ChaosProfile().churn_windows(1, 100.0) == ()


_LINK_PROFILE = (
    "drop=0.1,duplicate=0.05,corrupt=0.05,reorder=0.1,"
    "delay=0.001,jitter=0.002,bandwidth=65536,partition@1:0.5:a2b"
)


def _frames(seed=42, n=400):
    rng = np.random.default_rng(seed)
    frames = [rng.bytes(int(rng.integers(8, 200))) for _ in range(n)]
    times = np.cumsum(rng.uniform(0.001, 0.01, size=len(frames)))
    return frames, times


def _drive(link, frames, times):
    trace = [link.admit(f, float(t)) for f, t in zip(frames, times)]
    return trace, link.flush(), link.stats()


def test_chaos_link_seeded_reproducibility():
    profile = ChaosProfile.parse(_LINK_PROFILE)
    frames, times = _frames()
    run1 = _drive(ChaosLink(profile, seed=7, conn_id=3, direction="a2b"),
                  frames, times)
    run2 = _drive(ChaosLink(profile, seed=7, conn_id=3, direction="a2b"),
                  frames, times)
    assert run1 == run2
    for key in ("dropped", "corrupted", "duplicated", "reordered",
                "partitioned"):
        assert run1[2][key] > 0, (key, run1[2])
    run3 = _drive(ChaosLink(profile, seed=8, conn_id=3, direction="a2b"),
                  frames, times)
    assert run3[2] != run1[2]


@pytest.mark.parametrize("seed,conn_id,direction", [
    (7, 3, "a2b"), (7, 3, "b2a"), (1234, 0, "a2b"), (99, 41, "b2a"),
])
def test_chaos_link_decisions_equal_reference(seed, conn_id, direction):
    """For one profile and seed the port's link makes the reference's
    decisions frame for frame: the same forwarding plan (bytes, order,
    delays) for every frame, the same released hold and the same stats."""
    frames, times = _frames(seed=seed)
    port = _drive(ChaosLink(ChaosProfile.parse(_LINK_PROFILE), seed,
                            conn_id, direction), frames, times)
    ref = _drive(RefChaosLink(RefChaosProfile.parse(_LINK_PROFILE), seed,
                              conn_id, direction), frames, times)
    assert port == ref
    assert sum(len(plan) for plan in port[0]) > 0


def test_fault_injector_duplicate_reorder_accounting():
    inj = FaultInjector(seed=5, drop=0.1, duplicate=0.4, reorder=0.4)
    rng = np.random.default_rng(1)
    inputs = 0
    out_count = 0
    for _ in range(50):
        batch = [rng.bytes(16) for _ in range(int(rng.integers(1, 6)))]
        inputs += len(batch)
        out_count += len(inj.apply(batch, link="shared"))
    s = inj.stats
    assert s["duplicated"] > 0 and s["reordered"] > 0
    assert out_count == s["delivered"]
    assert inj.pending in (0, 1)
    assert (
        s["delivered"] + s["dropped"] + inj.pending
        == inputs + s["duplicated"]
    )
    inj.flush("shared")
    assert inj.pending == 0
    assert inj.flush("shared") is None
    assert (
        inj.stats["delivered"] + inj.stats["dropped"]
        == inputs + inj.stats["duplicated"]
    )


# ---------------------------------------------------------------- proxy


class _Sink:
    """A TCP server that records every length-prefixed frame it reads."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.frames: list[bytes] = []
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        conn, _ = self.sock.accept()
        buf = b""
        with conn:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 4:
                    (ln,) = struct.unpack_from("<I", buf)
                    if len(buf) < 4 + ln:
                        break
                    self.frames.append(buf[4:4 + ln])
                    buf = buf[4 + ln:]
        self.done.set()

    def close(self):
        self.sock.close()


def _through(proxy_cls, profile_cls, frames, seed):
    sink = _Sink()
    proxy = proxy_cls("127.0.0.1", sink.port,
                      profile=profile_cls.parse(
                          "drop=0.1,duplicate=0.05,corrupt=0.05,"
                          "reorder=0.1"),
                      seed=seed).start()
    try:
        with socket.create_connection(("127.0.0.1", proxy.port)) as c:
            for f in frames:
                c.sendall(struct.pack("<I", len(f)) + f)
            c.shutdown(socket.SHUT_WR)
            assert sink.done.wait(10)
        return sink.frames, proxy.stats()
    finally:
        proxy.close()
        sink.close()


def test_chaos_proxy_stream_equals_reference():
    """The same frames through a port proxy and a reference proxy on one
    profile and seed reach the target as the same frames in the same
    order, with the same fault stats: a port node and a reference node
    behind them see the same faults."""
    frames, _ = _frames(seed=3, n=300)
    port_frames, port_stats = _through(ChaosProxy, ChaosProfile, frames, 11)
    ref_frames, ref_stats = _through(RefChaosProxy, RefChaosProfile,
                                     frames, 11)
    assert port_frames == ref_frames
    assert port_stats == ref_stats
    assert port_stats["dropped"] > 0 and port_stats["corrupted"] > 0
    assert port_frames != frames


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_port_and_reference_nodes_exchange_lines_through_port_proxy():
    """A reference node listens; a port node dials it through a port
    ``ChaosProxy`` that duplicates, delays and rate-limits frames. Lines
    go both ways and every one arrives once, verified. (A reordered
    handshake frame stalls registration in either package, so the
    profile holds no reorder.)"""
    inbox_ref, inbox_port = [], []
    ref = RefTCPNetwork(host="127.0.0.1", port=0, discovery=False)
    ref.add_plugin(RefShardPlugin(
        backend="numpy", on_message=lambda m, s: inbox_ref.append(m)))
    ref.listen()
    port = TCPNetwork(host="127.0.0.1", port=0, discovery=False)
    port.add_plugin(ShardPlugin(
        backend="numpy", on_message=lambda m, s: inbox_port.append(m)))
    port.listen()
    proxy = ChaosProxy(
        "127.0.0.1", ref.port,
        profile=ChaosProfile.parse(
            "duplicate=0.1,delay=0.001,jitter=0.002,bandwidth=4194304"),
        seed=5,
    ).start()
    try:
        port.bootstrap([proxy.address])
        assert _wait(lambda: port.peers and ref.peers, 10)
        to_ref = [f"port line {i:03d} ".encode() * 3 for i in range(12)]
        to_port = [f"ref line {i:03d}!! ".encode() * 3 for i in range(12)]
        for m in to_ref:
            port.plugins[0].shard_and_broadcast(port, m)
        for m in to_port:
            ref.plugins[0].shard_and_broadcast(ref, m)
        assert _wait(lambda: len(inbox_ref) >= len(to_ref)
                     and len(inbox_port) >= len(to_port), 20)
        time.sleep(0.2)  # a duplicate would land by now
        assert sorted(inbox_ref) == sorted(to_ref)
        assert sorted(inbox_port) == sorted(to_port)
        stats = proxy.stats()
        assert stats["delivered"] > 0 and stats["connections"] >= 1
        assert stats["duplicated"] > 0, stats
    finally:
        proxy.close()
        port.close()
        ref.close()


def _tcp_pair():
    inbox_a, inbox_b = [], []
    a = TCPNetwork(host="127.0.0.1", port=0, discovery=False)
    a.add_plugin(ShardPlugin(backend="numpy",
                             on_message=lambda m, s: inbox_a.append(m)))
    a.listen()
    b = TCPNetwork(host="127.0.0.1", port=0, discovery=False)
    b.add_plugin(ShardPlugin(backend="numpy",
                             on_message=lambda m, s: inbox_b.append(m)))
    b.listen()
    return a, b, inbox_a, inbox_b


def test_tcp_reconnect_after_forced_reset():
    """A chaos reset kills the established connection; the supervisor
    re-dials the proxy address and the pair re-registers without a new
    bootstrap call; the healed link carries verified traffic."""
    a, b, inbox_a, _ = _tcp_pair()
    proxy = ChaosProxy(
        "127.0.0.1", a.port, profile=ChaosProfile(resets=(0.6,)), seed=1
    ).start()
    ok0 = counter_value("noise_ec_reconnect_total", result="ok")
    try:
        b.bootstrap([proxy.address])
        assert _wait(lambda: b.peers and a.peers, 10)
        proxy.rebase_clock()
        assert _wait(lambda: proxy.reset_count > 0, 10)
        assert proxy.reset_count == 1
        assert _wait(lambda: counter_value(
            "noise_ec_reconnect_total", result="ok") > ok0
            and b.peers and a.peers, 20)
        assert b.supervisor.health_summary()["reconnects_ok"] >= 1
        b.plugins[0].shard_and_broadcast(b, b"post reset send!")
        assert _wait(lambda: inbox_a, 10)
        assert inbox_a == [b"post reset send!"]
    finally:
        proxy.close()
        a.close()
        b.close()


# ------------------------------------------------------ acceptance soak


def test_chaos_soak_eventual_delivery_and_health_flip(lockgraph, tmp_path):
    """Two port TCP nodes through the port's chaos proxy (5% drop, 1%
    corrupt, one 2 s directional partition, one forced reset) deliver all
    200 messages by reconnect, NACK repair and announce, accept no wrong
    object, and ``/healthz`` flips 503 -> 200. The flight recorder and the
    diagnosis engine ride the soak: the flip writes exactly one bundle,
    with the event window and a verdict inside the closed vocabulary. The
    lockgraph harness runs over it (``LOOP_BLOCK_SECONDS``)."""
    from noise_ec_tpu_torch.obs.diagnose import VERDICTS, DiagnosisEngine
    from noise_ec_tpu_torch.obs.recorder import FlightRecorder
    from noise_ec_tpu_torch.obs.server import StatsServer

    a = TCPNetwork(host="127.0.0.1", port=0, discovery=False)
    store_a = StripeStore(backend="numpy")
    engine_a = RepairEngine(
        store_a, network=a, respond_interval_seconds=0.2,
        linger_seconds=0.0, announce_interval_seconds=0.25,
        announce_window_seconds=120.0, announce_max_stripes=256,
    )
    engine_a.start()
    plugin_a = ShardPlugin(
        backend="numpy", store=store_a,
        minimum_needed_shards=5, total_shards=6,
    )
    a.add_plugin(plugin_a)
    a.listen()
    # Directions are relative to the dialer B: a2b = B->A (NACKs),
    # b2a = A->B (payloads).
    profile = ChaosProfile.parse(
        "drop=0.05,corrupt=0.01,reset@0.6,partition@1.2:2:a2b"
    )
    proxy = ChaosProxy("127.0.0.1", a.port, profile=profile,
                       seed=1234).start()
    inbox_b = []
    slo = SLOEvaluator(window_seconds=5.0, min_events=10)
    b = TCPNetwork(host="127.0.0.1", port=0, discovery=False,
                   connection_timeout=2.0)
    store_b = StripeStore(backend="numpy")
    engine_b = RepairEngine(store_b, network=b,
                            respond_interval_seconds=0.2, linger_seconds=0.0)
    engine_b.start()
    plugin_b = ShardPlugin(
        backend="numpy", store=store_b, slo=slo,
        on_message=lambda m, s: inbox_b.append(m),
    )
    plugin_b.nack_grace_seconds = 0.3
    plugin_b.nack_backoff_base = 0.3
    plugin_b.nack_max_retries = 2
    b.add_plugin(plugin_b)
    b.listen()
    server = StatsServer(slo=slo, health_details=b.supervisor.health_summary)
    recorder = FlightRecorder(
        slo=slo, incident_dir=str(tmp_path), max_bytes=256 * 1024,
        min_bundle_interval=300.0, interval=0.5,
    )
    DiagnosisEngine(slo=slo, recorder=recorder)
    recorder.start()

    def healthz() -> int:
        try:
            with urlopen(f"{server.url}/healthz", timeout=2) as resp:
                return resp.status
        except Exception as exc:  # noqa: BLE001 — 503 raises HTTPError
            return getattr(exc, "code", 0)

    saw_503 = [False]
    stop_poll = threading.Event()

    def poll_health():
        while not stop_poll.wait(0.1):
            if healthz() == 503:
                saw_503[0] = True

    poller = threading.Thread(target=poll_health, daemon=True)
    poller.start()
    sent = []
    try:
        b.bootstrap([proxy.address])
        assert _wait(lambda: b.peers and a.peers, 10), (a.errors, b.errors)
        proxy.rebase_clock()
        for i in range(200):
            payload = f"chaos soak msg {i:04d}!".encode()  # k=5 stripes
            sent.append(payload)
            plugin_a.shard_and_broadcast(a, payload)
            time.sleep(0.015)
        _wait(lambda: len(inbox_b) >= len(sent), 90)
        assert sorted(inbox_b) == sorted(sent), (
            f"delivered {len(inbox_b)}/{len(sent)}", proxy.stats(),
            plugin_b.counters.snapshot(),
        )
        assert plugin_b.counters.snapshot().get("verify_failures", 0) == 0
        stats = proxy.stats()
        assert stats["resets"] == 1
        assert stats["dropped"] > 0 and stats["corrupted"] > 0
        assert stats["partitioned"] > 0
        assert b.supervisor.health_summary()["reconnects_ok"] >= 1
        assert saw_503[0], slo.verdict()
        assert _wait(lambda: healthz() == 200, 30), slo.verdict()

        recorder.close()
        bundles = sorted(tmp_path.glob("incident-*-flip.json"))
        assert len(bundles) == 1, [p.name for p in tmp_path.iterdir()]
        assert counter_value("noise_ec_incident_bundles_total",
                             trigger="flip") >= 1
        doc = json.loads(bundles[0].read_text())
        assert doc["trigger"] == "flip"
        assert doc["verdict"]["healthy"] is False
        assert doc["timeline"]
        assert doc.get("events")
        ev_names = {e["name"] for e in doc["events"]}
        assert any(n.startswith(("peer.", "conn.", "repair."))
                   for n in ev_names), ev_names
        names = [v["verdict"] for v in doc["diagnosis"]["verdicts"]]
        assert set(names) <= set(VERDICTS), names
        assert recorder.stats()["ring_bytes"] <= 256 * 1024
    finally:
        stop_poll.set()
        recorder.close()
        server.close()
        proxy.close()
        a.close()
        b.close()
        engine_a.close()
        engine_b.close()
