"""The port's distributed trace collection and Perfetto export
(``noise_ec_tpu_torch.obs.collector``, ``obs.perfetto``) against the
reference's: the NTP-style offset estimate, skew correction against a fake
``/spans`` endpoint, the two-node collect, merge, export and
critical-path report over real port ``StatsServer`` endpoints, a peer
restart mid-collect, and the same merged spans and Chrome trace documents
as the reference's collector and exporter on the same endpoints. Codecs
run on ``backend="numpy"``. Tolerance: exact, except the clock estimates,
which hold within the measured round trip."""

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from noise_ec_tpu.obs.collector import TraceCollector as RefTraceCollector
from noise_ec_tpu.obs.collector import estimate_offset as ref_estimate_offset
from noise_ec_tpu.obs.perfetto import to_chrome_trace as ref_to_chrome_trace
from noise_ec_tpu.obs.trace import Tracer as RefTracer
from noise_ec_tpu_torch.obs import TraceCollector as ExportedCollector
from noise_ec_tpu_torch.obs import events as port_events
from noise_ec_tpu_torch.obs.collector import TraceCollector, estimate_offset
from noise_ec_tpu_torch.obs.perfetto import to_chrome_trace, write_chrome_trace
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.server import StatsServer
from noise_ec_tpu_torch.obs.trace import Tracer, clock_anchor, default_tracer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
try:
    import trace_report
finally:
    sys.path.pop(0)

_SEND_STAGES = {"prepare", "sign", "encode", "wire_encode", "broadcast"}
_RECV_STAGES = {"deliver", "reassemble", "decode", "verify"}


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry, event log and tracer, scoped to
    the test (the shared conftest resets only the reference's)."""
    default_registry().reset_values()
    port_events.default_event_log().clear()
    default_tracer().clear()
    yield


def test_exported_from_obs():
    assert ExportedCollector is TraceCollector


@pytest.mark.parametrize("args", [
    (10.0, 10.4, 1000.3), (10.0, 10.4, 10.35), (10.0, 10.4, -979.9),
    (10.0, 10.4, 1000.3, 0.05), (10.0, 10.4, 1000.3, 3.0),
])
def test_estimate_offset_equals_reference(args):
    kw = {"handshake_rtt": args[3]} if len(args) > 3 else {}
    c, r = estimate_offset(*args[:3], **kw), ref_estimate_offset(
        *args[:3], **kw)
    assert c.as_dict() == r.as_dict()
    assert c.applied_offset() == r.applied_offset()


def test_estimate_offset_midpoint_and_uncertainty():
    c = estimate_offset(10.0, 10.4, 1000.3)
    assert c.offset == pytest.approx(990.1)
    assert c.rtt == pytest.approx(0.4)
    assert c.uncertainty == pytest.approx(0.2)


def test_applied_offset_soft_thresholds_noise():
    assert estimate_offset(10.0, 10.4, 10.35).applied_offset() == 0.0
    ahead = estimate_offset(10.0, 10.4, 1000.3)
    assert ahead.applied_offset() == pytest.approx(990.1 - 0.2)
    behind = estimate_offset(10.0, 10.4, -979.9)
    assert behind.applied_offset() == pytest.approx(-(990.1 - 0.2))


def test_estimate_offset_handshake_hint_tightens_uncertainty():
    loose = estimate_offset(10.0, 10.4, 1000.3)
    tight = estimate_offset(10.0, 10.4, 1000.3, handshake_rtt=0.05)
    assert tight.offset == loose.offset
    assert tight.uncertainty == pytest.approx(0.025)
    worse = estimate_offset(10.0, 10.4, 1000.3, handshake_rtt=3.0)
    assert worse.uncertainty == pytest.approx(0.2)


class _SkewedSpanServer:
    """A fake ``/spans`` endpoint whose clock (and span timestamps) run
    ``skew`` seconds ahead of the collector's."""

    def __init__(self, skew: float, spans: list[dict], node_id: str):
        outer = [dict(s, start=s["start"] + skew) for s in spans]

        class _H(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                doc = {
                    "node": {"id": node_id, "address": "tcp://skewed:1"},
                    "clock": {"now": time.time() + skew},
                    "next_since": max((s["seq"] for s in outer), default=0),
                    "spans": outer,
                }
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _one_span(t):
    return [{"seq": 1, "trace_id": "k", "name": "decode", "start": t,
             "seconds": 0.010, "parent": None}]


def test_collector_corrects_peer_clock_skew():
    t_true = time.time() - 0.050
    srv = _SkewedSpanServer(500.0, _one_span(t_true), "tcp://skewed:1#ab")
    try:
        coll = TraceCollector([srv.url], tracer=Tracer())
        assert coll.poll() == 1
        (got,) = coll.merged_spans()
        clock = coll.clock(srv.url)
        assert abs(clock.offset - 500.0) <= clock.rtt + 0.01
        assert got["node"] == "tcp://skewed:1#ab"
        assert abs(got["start"] - t_true) <= clock.rtt + 0.01
    finally:
        srv.close()


def test_collector_merges_the_reference_spans_on_one_endpoint():
    """A port and a reference collector polling one endpoint whose clock
    agrees with theirs merge the same spans with the same node stamps
    (the soft threshold applies no correction to either)."""
    t0 = time.time() - 0.5
    spans = [{"seq": i + 1, "trace_id": f"t{i % 3}", "name": n,
              "start": t0 + 0.01 * i, "seconds": 0.002, "parent": None,
              "attrs": {"i": i}}
             for i, n in enumerate(["encode", "sign", "decode", "verify"] * 3)]
    srv = _SkewedSpanServer(0.0, spans, "tcp://same:1#cd")
    try:
        port = TraceCollector([srv.url], tracer=Tracer())
        ref = RefTraceCollector([srv.url], tracer=RefTracer())
        assert port.poll() == ref.poll() == len(spans)
        assert port.clock(srv.url).applied_offset() == 0.0
        assert ref.clock(srv.url).applied_offset() == 0.0
        assert port.merged_spans() == ref.merged_spans()
        assert port.traces() == ref.traces()
        assert port.poll() == ref.poll() == 0
    finally:
        srv.close()


def _loopback_two_node_trace():
    """One message through the port's loopback pipeline, its spans split
    into the two logical nodes (send stages, receive stages), each behind
    its own tracer with its own identity."""
    from noise_ec_tpu_torch.host.plugin import ShardPlugin
    from noise_ec_tpu_torch.host.transport import LoopbackHub, LoopbackNetwork
    from noise_ec_tpu_torch.obs.trace import trace_key

    hub = LoopbackHub()
    a = LoopbackNetwork(hub, "tcp://trace-a:1")
    b = LoopbackNetwork(hub, "tcp://trace-b:1")
    pa, pb = ShardPlugin(backend="numpy"), ShardPlugin(backend="numpy")
    a.add_plugin(pa)
    b.add_plugin(pb)
    before = default_tracer().last_seq()
    shards = pa.shard_and_broadcast(a, b"distributed tracing end to end!!")
    key = trace_key(shards[0].file_signature)
    assert pb.counters.get("verified") == 1
    run_spans = list(default_tracer().dump(trace_id=key, since=before))
    tr_a, tr_b = Tracer(registry=Registry()), Tracer(registry=Registry())
    tr_a.set_node(a.id.address, a.keys.public_key)
    tr_b.set_node(b.id.address, b.keys.public_key)
    tr_a.ingest([s for s in run_spans if s["name"] in _SEND_STAGES])
    tr_b.ingest([s for s in run_spans if s["name"] in _RECV_STAGES])
    return key, tr_a, tr_b


def test_two_node_collect_merge_export_and_report(tmp_path):
    """Collect both nodes' ``/spans``, merge them into one distributed
    trace, export valid Chrome trace-event JSON (tracks named by node),
    and have the reference's ``tools/trace_report.py`` name the dominant
    stage; the reference's exporter gives the same document."""
    key, tr_a, tr_b = _loopback_two_node_trace()
    srv_a = StatsServer(port=0, registry=Registry(), tracer=tr_a)
    srv_b = StatsServer(port=0, registry=Registry(), tracer=tr_b)
    try:
        coll = TraceCollector([srv_a.url, srv_b.url], tracer=Tracer())
        assert coll.poll() > 0
        traces = coll.traces()
        trace = traces[key]
        assert len({s["node"] for s in trace}) == 2
        assert {s["name"] for s in trace} >= (_SEND_STAGES | _RECV_STAGES)
        assert trace == sorted(trace, key=lambda s: s["start"])
        assert coll.poll() == 0

        path = tmp_path / "mesh.json"
        doc = write_chrome_trace(str(path), coll.merged_spans())
        loaded = json.loads(path.read_text())
        assert loaded["traceEvents"] == doc["traceEvents"]
        assert doc == ref_to_chrome_trace(coll.merged_spans())
        slices = [e for e in loaded["traceEvents"] if e["ph"] == "X"]
        assert len(slices) == len(trace)
        for e in slices:
            assert {"pid", "tid", "ts", "dur", "name", "args"} <= set(e)
            assert e["ts"] >= 0 and e["dur"] >= 0
        tracks = {e["args"]["name"] for e in loaded["traceEvents"]
                  if e["name"] == "process_name"}
        assert tracks == {tr_a.node_label(), tr_b.node_label()}

        report = trace_report.render_report(traces, (0.5, 0.99))
        cp = trace_report.critical_path(trace)
        assert cp["dominant"]["stage"] in (_SEND_STAGES | _RECV_STAGES)
        assert cp["e2e_seconds"] > 0
        assert "dominant:" in report and key in report
        assert sum(s["seconds"] for s in cp["stages"]) <= (
            cp["e2e_seconds"] * (1 + 1e-6))
    finally:
        srv_a.close()
        srv_b.close()


def test_trace_report_loads_port_span_dump_files(tmp_path):
    key, tr_a, tr_b = _loopback_two_node_trace()
    paths = []
    for tr, name in ((tr_a, "a.json"), (tr_b, "b.json")):
        p = tmp_path / name
        p.write_text(json.dumps({
            "node": tr.node, "clock": clock_anchor(),
            "next_since": tr.last_seq(), "spans": tr.dump(),
        }))
        paths.append(str(p))
    spans = trace_report.load_spans(paths)
    assert {s["node"] for s in spans} == {tr_a.node_label(),
                                          tr_b.node_label()}
    traces = trace_report.group_traces(spans)
    assert key in traces
    assert "dominant:" in trace_report.render_report(traces)


def test_collector_tolerates_peer_restart_mid_collect():
    tr1 = Tracer(registry=Registry())
    tr1.set_node("tcp://restart:1", b"\xab" * 32)
    with tr1.span("decode", key="before-restart"):
        pass
    srv = StatsServer(port=0, registry=Registry(), tracer=tr1)
    try:
        coll = TraceCollector([srv.url], tracer=Tracer())
        assert coll.poll() == 1
        tr2 = Tracer(registry=Registry())
        tr2.set_node("tcp://restart:1", b"\xab" * 32)
        assert tr2.epoch != tr1.epoch
        with tr2.span("verify", key="after-restart"):
            pass
        srv.tracer = tr2
        assert coll.poll() == 1
        spans = coll.merged_spans()
        assert sorted(s["name"] for s in spans) == ["decode", "verify"]
        assert {s["trace_id"] for s in spans} == {"before-restart",
                                                  "after-restart"}
        assert coll.poll() == 0
        assert len(coll.merged_spans()) == 2
    finally:
        srv.close()


@pytest.mark.parametrize("seed", range(3))
def test_chrome_trace_equals_reference(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    spans = []
    for i in range(int(rng.integers(5, 40))):
        s = {"seq": i + 1, "trace_id": f"t{int(rng.integers(0, 4))}",
             "name": str(rng.choice(["encode", "decode", "verify"])),
             "start": 1.7e9 + float(rng.uniform(0, 2)),
             "seconds": float(rng.uniform(0, 0.01)),
             "node": f"tcp://n{int(rng.integers(0, 3))}:1"}
        if rng.random() < 0.3:
            s["error"] = "boom"
        if rng.random() < 0.5:
            s["attrs"] = {"k": int(rng.integers(0, 9))}
        spans.append(s)
    assert to_chrome_trace(spans) == ref_to_chrome_trace(spans)
