"""The port's device gate on the CPU: QoS lane order (live preempts
background, the starvation floor, weighted round-robin), the governor's
escape, a capacity-1 gate through which every public ``DeviceCodec`` entry,
the codecs and an FEC decode complete (no acquire nests), concurrent
encodes from both lanes, and the coalescer's linger scaling with the
gate's depth."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.registry as port_registry
from noise_ec_tpu_torch.codec import (
    FEC,
    LocalReconstructionCode,
    ReedSolomon,
)
from noise_ec_tpu_torch.matrix import generator_matrix, host_matvec
from noise_ec_tpu_torch.obs.events import default_event_log
from noise_ec_tpu_torch.ops import dispatch
from noise_ec_tpu_torch.ops.coalesce import (
    CoalescingDispatcher,
    qos_lane,
)
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec, DeviceGate
from noise_ec_tpu_torch.parallel import BatchCodec, StreamingEncoder


@pytest.fixture(autouse=True)
def _fresh_gate_and_observability():
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    dispatch.configure_device_gate()
    yield
    dispatch.configure_device_gate()


def _grant_order(gate: DeviceGate, specs) -> list:
    """Queue one waiter per (lane, tenant, weight) spec behind a held
    gate, in arrival order, then release the slot and record the order
    grants land in (each granted waiter releases at once, so the chain
    serializes and the recorded order IS the arbitration order)."""
    order = []
    lock = threading.Lock()

    def worker(spec):
        lane, tenant, weight = spec
        with qos_lane(lane, tenant=tenant, weight=weight):
            gate.acquire()
        with lock:
            order.append(spec)
        gate.release()

    with qos_lane("live", tenant="holder"):
        gate.acquire()  # occupy the only slot: everything below queues
    threads = []
    try:
        for spec in specs:
            t = threading.Thread(target=worker, args=(spec,), daemon=True)
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 5.0
            while gate.waiters < len(threads):
                assert time.monotonic() < deadline, "waiter never queued"
                time.sleep(0.001)
    finally:
        gate.release()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert gate.in_flight == 0 and gate.waiters == 0
    return order


def test_live_lane_preempts_background():
    gate = DeviceGate(capacity=1, background_floor=50)
    specs = [("background", "repair", 1)] * 3 + [("live", "tenant", 1)] * 3
    order = _grant_order(gate, specs)
    assert [lane for lane, _, _ in order] == ["live"] * 3 + ["background"] * 3
    preempts = default_event_log().dump(name="qos.preempt")
    assert [e["attrs"]["streak"] for e in preempts] == [1, 2, 3]


def test_background_starvation_floor():
    gate = DeviceGate(capacity=1, background_floor=2)
    specs = [("live", "tenant", 1)] * 4 + [("background", "scrub", 1)] * 2
    order = _grant_order(gate, specs)
    assert [lane for lane, _, _ in order] == [
        "live", "background", "live", "background", "live", "live"
    ]


def test_weighted_round_robin_within_a_lane():
    gate = DeviceGate(capacity=1, background_floor=50)
    specs = [("live", "heavy", 3)] * 4 + [("live", "light", 1)] * 4
    order = _grant_order(gate, specs)
    assert [tenant for _, tenant, _ in order] == [
        "heavy", "heavy", "light", "heavy", "heavy",
        "light", "light", "light",
    ]


def test_lane_grants_and_depth_are_exported():
    gate = DeviceGate(capacity=1, background_floor=50)
    _grant_order(gate, [("background", "b", 1)] * 2 + [("live", "l", 1)])
    reg = port_registry.default_registry()
    grants = reg.counter("noise_ec_lane_grants_total")
    assert grants.labels(lane="live").value == 2  # the holder + one
    assert grants.labels(lane="background").value == 2
    assert reg.counter("noise_ec_backpressure_waits_total").labels(
        layer="device").value == 3
    depth = reg.gauge("noise_ec_backpressure_queue_depth").labels(
        layer="device")
    assert depth.read() == 0
    with gate:
        assert depth.read() == 1


def test_governor_escape():
    """A waiter past ``wait_timeout`` proceeds anyway (in_flight goes past
    capacity) and leaves no ticket behind."""
    gate = DeviceGate(capacity=1, wait_timeout=0.2)
    gate.acquire()
    t0 = time.monotonic()
    gate.acquire()
    waited = time.monotonic() - t0
    assert 0.15 <= waited < 5.0
    assert gate.in_flight == 2 and gate.waiters == 0 and gate.waits == 1
    assert not gate._queued()
    gate.release()
    gate.release()
    assert gate.in_flight == 0
    hist = port_registry.default_registry().histogram(
        "noise_ec_backpressure_wait_seconds").labels(layer="device")
    assert hist.count == 1 and hist.sum >= 0.15
    with pytest.raises(ValueError):
        DeviceGate(capacity=0)
    with pytest.raises(ValueError):
        DeviceGate(background_floor=1)


def test_gate_stress_never_exceeds_capacity():
    """16 threads in both lanes acquiring and releasing a capacity-3 gate
    with a short switch interval: occupancy never passes the capacity,
    every acquire is granted once, and the gate ends idle."""
    gate = DeviceGate(capacity=3)
    held = [0, 0]  # current, most seen
    lock = threading.Lock()

    def worker(i):
        with qos_lane("background" if i % 2 else "live", tenant=str(i % 3)):
            for _ in range(200):
                with gate:
                    with lock:
                        held[0] += 1
                        held[1] = max(held[1], held[0])
                    with lock:
                        held[0] -= 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert held[1] <= 3
    assert gate.in_flight == 0 and gate.waiters == 0
    grants = port_registry.default_registry().counter(
        "noise_ec_lane_grants_total")
    assert (grants.labels(lane="live").value
            + grants.labels(lane="background").value) == 16 * 200


def test_capacity_one_gate_every_entry_completes(rng):
    """Through a capacity-1 gate every public DeviceCodec entry, the RS,
    LRC and FEC codecs, the batch codec and the stream complete without a
    single wait: no acquire nests (a nested one would queue behind its
    own slot)."""
    gate = dispatch.configure_device_gate(capacity=1, wait_timeout=30.0)
    done = threading.Event()
    errors = []

    def run():
        try:
            dev = DeviceCodec(device="cpu")
            dev16 = DeviceCodec(field="gf65536", device="cpu")
            G = generator_matrix(dev.gf, 4, 7, "cauchy")
            A = np.ascontiguousarray(G[4:])
            G16 = np.ascontiguousarray(
                generator_matrix(dev16.gf, 4, 7, "cauchy")[4:])
            D = rng.integers(0, 256, size=(4, 256)).astype(np.uint8)
            words = torch.from_numpy(rng.integers(
                0, 256, size=(7, 1024), dtype=np.uint8)).view(torch.int32)
            words16 = torch.from_numpy(rng.integers(
                0, 256, size=(14, 1024), dtype=np.uint8)).view(torch.int32)
            assert np.array_equal(dev.matmul_stripes(A, D),
                                  host_matvec(dev.gf, A, D))
            dev.matmul_stripes_many(A, [D, D])
            dev.matmul_words(A, words[:4])
            dev.matmul_words_batch(A, words[None, :4])
            dev16.matmul_words(G16, words16[None, :4, :512][0])
            dev16.matmul_words_bytesliced(G16, words16[:8])
            full = np.concatenate([D, dev.matmul_stripes(A, D)])
            dev.syndrome_stripes(A, full)
            dev.decode1_words(A, 1, words)
            dev16.decode1_words_bytesliced(G16, 1, words16)

            rs = ReedSolomon(4, 2, device="cpu")
            enc = rs.encode(rs.split(b"x" * 1000))
            rs.reconstruct([None, enc[1], None, enc[3], enc[4], enc[5]])
            lrc = LocalReconstructionCode(4, 2, 2, device="cpu")
            enc = lrc.encode(lrc.split(b"y" * 1000))
            lrc.reconstruct([None] + list(enc[1:]))
            fec = FEC(4, 7, bw_route="device", device="cpu")
            shares = fec.encode_shares(b"z" * 400)
            shares[1].data = bytes(len(shares[1].data))
            assert fec.decode(shares) == b"z" * 400
            bc = BatchCodec(4, 2, device="cpu")
            bc.encode_batch_words(torch.zeros((2, 4, 256),
                                              dtype=torch.int32))
            se = StreamingEncoder(4, 2, chunk_bytes=4096, device="cpu")
            list(se.encode_bytes(b"w" * 9000))
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert done.wait(120), "a call blocked on the capacity-1 gate"
    t.join(timeout=10)
    assert not errors, errors
    assert gate.waits == 0
    assert gate.in_flight == 0 and gate.waiters == 0


def test_concurrent_lanes_through_a_small_gate(rng):
    """Eight threads of RS(10,4) encodes, four live and four background,
    through a capacity-2 gate: every result equals the host arithmetic
    and each lane's grants are counted."""
    dispatch.configure_device_gate(capacity=2)
    rs = ReedSolomon(10, 4, device="cpu")
    datas = [[rng.integers(0, 256, 2048, dtype=np.uint8)
              for _ in range(10)] for _ in range(8)]
    wants = [host_matvec(rs.gf, rs.G[10:], np.stack(d)) for d in datas]
    results = [None] * 8

    def worker(i):
        with qos_lane("live" if i < 4 else "background", tenant=str(i)):
            for _ in range(3):
                results[i] = rs.encode(datas[i])[10:]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for got, want in zip(results, wants):
        assert np.array_equal(np.stack(got), want)
    grants = port_registry.default_registry().counter(
        "noise_ec_lane_grants_total")
    assert grants.labels(lane="live").value >= 1
    assert grants.labels(lane="background").value >= 1
    gate = dispatch.device_gate()
    assert gate.in_flight == 0 and gate.waiters == 0


def test_coalescer_linger_scales_with_gate_depth():
    """The leader's linger is the base linger times the gate's in-flight
    plus waiting count, and a background leader under pressure lingers
    ``background_linger_x`` longer and says so with a qos.linger event."""
    gate = dispatch.configure_device_gate(capacity=8)
    co = CoalescingDispatcher(linger_seconds=0.001, background_linger_x=4.0)
    assert co._linger_budget() == pytest.approx(0.001)
    with qos_lane("background"):
        assert co._linger_budget() == pytest.approx(0.001)
    assert not default_event_log().dump(name="qos.linger")
    for _ in range(3):
        gate.acquire()
    try:
        assert co._linger_budget() == pytest.approx(0.003)
        with qos_lane("background"):
            assert co._linger_budget() == pytest.approx(0.012)
    finally:
        for _ in range(3):
            gate.release()
    (ev,) = default_event_log().dump(name="qos.linger")
    assert ev["attrs"] == {"lane": "background", "depth": 3,
                           "budget_ms": 12.0}
    assert CoalescingDispatcher(linger_seconds=0.0)._linger_budget() == 0.0
