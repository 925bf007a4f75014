"""The port's node observability against the reference's: the Prometheus
text of a registry filled the same way in both packages, the span tree and
trace id of a loopback round trip (and of a request around it), the event
log's trace-id and node stamps from the port's tracer, ``SLOEvaluator``
verdicts, and ``StatsServer``'s ``/metrics``, ``/healthz``, ``/spans`` and
``/events`` on an ephemeral port. Tolerance: equal text and equal
verdicts."""

import json
import urllib.error
import urllib.request

import pytest

from noise_ec_tpu.host.plugin import ShardPlugin as RefShardPlugin
from noise_ec_tpu.host.transport import LoopbackHub as RefLoopbackHub
from noise_ec_tpu.host.transport import LoopbackNetwork as RefLoopbackNetwork
from noise_ec_tpu.obs.export import parse_prometheus as ref_parse
from noise_ec_tpu.obs.export import render_prometheus as ref_render
from noise_ec_tpu.obs.health import SLOEvaluator as RefSLOEvaluator
from noise_ec_tpu.obs.metrics import Counters as RefCounters
from noise_ec_tpu.obs.registry import Registry as RefRegistry
from noise_ec_tpu.obs.trace import default_tracer as ref_default_tracer
from noise_ec_tpu.obs.trace import trace_key as ref_trace_key
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import LoopbackHub, LoopbackNetwork
from noise_ec_tpu_torch.obs import events as port_events
from noise_ec_tpu_torch.obs.events import EVENTS_DOC_FIELDS, EventLog, event
from noise_ec_tpu_torch.obs.export import parse_prometheus, render_prometheus
from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.metrics import Counters
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.server import StatsServer
from noise_ec_tpu_torch.obs.trace import Tracer, default_tracer, trace_key


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry, event log and tracer identity,
    scoped to the test (the shared conftest resets only the
    reference's)."""
    default_registry().reset_values()
    port_events.default_event_log().clear()
    tracer = default_tracer()
    node, sample_n = tracer.node, tracer.sample_n
    yield
    tracer.node, tracer.sample_n = node, sample_n


def _fill(reg, bag):
    reg.counter("noise_ec_transport_shards_in_total").labels(
        peer="tcp://a:1").add(3)
    reg.counter("noise_ec_transport_shards_in_total").labels(
        peer='tcp://"b"\\:2').add(1)
    hist = reg.histogram("noise_ec_decode_seconds").labels()
    for v in (0.0004, 0.001, 0.5, 1.5, 40.0):
        hist.observe(v)
    reg.gauge("noise_ec_event_ring_bytes").labels().set(1234)
    reg.histogram("noise_ec_stage_seconds").labels(stage="decode").observe(0.02)
    bag.add("verified", 2)
    bag.add("decodes", 7)


def test_render_prometheus_equals_reference():
    reg, ref_reg = Registry(), RefRegistry()
    bag, ref_bag = Counters(), RefCounters()
    _fill(reg, bag)
    _fill(ref_reg, ref_bag)
    text = render_prometheus(reg, {"noise_ec_plugin": bag})
    assert text == ref_render(ref_reg, {"noise_ec_plugin": ref_bag})
    assert "noise_ec_plugin_verified 2" in text
    fams = parse_prometheus(text)
    assert fams == ref_parse(text)
    assert {f["name"] for f in fams} >= {
        "noise_ec_transport_shards_in_total", "noise_ec_decode_seconds"}


def _port_roundtrip(payload):
    hub = LoopbackHub()
    a = LoopbackNetwork(hub, "tcp://obs-a:1")
    b = LoopbackNetwork(hub, "tcp://obs-b:1")
    pa = ShardPlugin(backend="device", device="cpu")
    pb = ShardPlugin(backend="device", device="cpu")
    a.add_plugin(pa)
    b.add_plugin(pb)
    shards = pa.shard_and_broadcast(a, payload)
    assert pb.counters.get("verified") == 1
    return trace_key(shards[0].file_signature)


def test_loopback_span_tree_matches_reference():
    """One message through the port's pipeline leaves the reference's
    stages under one trace id (the signature prefix), every span timed."""
    payload = b"end-to-end observability"
    key = _port_roundtrip(payload)
    tracer = default_tracer()
    stages = tracer.stages(key)
    assert stages >= {"prepare", "sign", "encode", "wire_encode",
                      "broadcast", "deliver", "reassemble", "decode",
                      "verify"}
    spans = tracer.dump(trace_id=key)
    assert all(d["trace_id"] == key and d["seconds"] >= 0.0 for d in spans)
    # The reference's loopback round trip of the same payload.
    hub = RefLoopbackHub()
    ra = RefLoopbackNetwork(hub, "tcp://obs-a:1")
    rb = RefLoopbackNetwork(hub, "tcp://obs-b:1")
    ra.add_plugin(RefShardPlugin(backend="numpy"))
    rb.add_plugin(RefShardPlugin(backend="numpy"))
    rshards = ra.plugins[0].shard_and_broadcast(ra, payload)
    assert ref_default_tracer().stages(
        ref_trace_key(rshards[0].file_signature)) == stages


def test_request_scope_stamps_spans_and_events():
    """Inside request(): the plugin's send-path spans carry the request's
    trace id, the request's own spans are kept (sample_n = 1), and an
    event recorded there carries the request id and the node label."""
    tracer = default_tracer()
    tracer.sample_n = 1
    tracer.set_node("tcp://obs-a:1", bytes(range(32)))
    with tracer.request("send") as scope:
        key = _port_roundtrip(b"request scoped obs")
        event("hedge.win", tenant="acme", peer="p1")
        rid = scope.trace_id
    assert rid.startswith("req-")
    prep = [d for d in tracer.dump(trace_id=key) if d["name"] == "prepare"]
    assert prep and prep[0]["attrs"]["request_trace"] == rid
    assert [d["name"] for d in tracer.dump(trace_id=rid)] == ["request"]
    (rec,) = port_events.default_event_log().dump(name="hedge")
    assert rec["trace_id"] == rid
    assert rec["node"] == tracer.node_label() == "tcp://obs-a:1#0001020304050607"
    event("hedge.late")  # outside the request: no trace id
    assert port_events.default_event_log().dump(name="hedge.late")[0][
        "trace_id"] is None


@pytest.mark.parametrize("outcomes,p99_target,healthy", [
    ([("ok", 0.01)] * 20, 0.0, True),
    ([("ok", 0.01)] * 18 + [("corrupt", 0.0)] * 2, 0.0, False),  # rate
    ([("ok", 0.01)] * 15 + [("ok", 2.0)] * 5, 0.5, False),       # p99
    ([("corrupt", 0.0)] * 3, 0.0, True),                # too few events
])
def test_slo_verdicts_match_reference(outcomes, p99_target, healthy):
    slo = SLOEvaluator(window_seconds=60.0, p99_target_seconds=p99_target,
                       min_events=5)
    ref = RefSLOEvaluator(window_seconds=60.0, p99_target_seconds=p99_target,
                          min_events=5)
    for outcome, secs in outcomes:
        slo.record(outcome, secs)
        ref.record(outcome, secs)
    got = slo.verdict()
    assert got == ref.verdict()
    assert got["healthy"] is healthy


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read()


def test_stats_server_metrics_healthz_spans_events():
    reg = Registry()
    hist = reg.histogram("noise_ec_decode_seconds").labels()
    for _ in range(100):
        hist.observe(0.001)
    tr = Tracer(registry=reg)
    with tr.span("decode", key="http-test"):
        pass
    log = EventLog(registry=reg, tracer=tr)
    bag = Counters()
    bag.add("verified", 2)
    slo = SLOEvaluator(window_seconds=60.0, min_events=1)
    srv = StatsServer(port=0, registry=reg, tracer=tr, slo=slo,
                      extra_counters={"noise_ec_plugin": bag})
    try:
        log.attach(srv)
        status, body = _get(srv.url + "/metrics")
        text = body.decode()
        assert status == 200
        assert "noise_ec_decode_seconds_count 100" in text.splitlines()
        assert "noise_ec_plugin_verified 2" in text
        status, body = _get(srv.url + "/spans?trace=http-test")
        assert [s["name"] for s in json.loads(body)["spans"]] == ["decode"]
        status, body = _get(srv.url + "/healthz")
        assert status == 200 and body == b"ok\n"
        log.emit("hedge.win", tenant="alice")
        log.emit("peer.down", endpoint="e3")
        _, body = _get(srv.url + "/events")
        doc = json.loads(body)
        assert tuple(sorted(doc)) == tuple(sorted(EVENTS_DOC_FIELDS))
        assert doc["epoch"] == log.epoch and doc["next_since"] == 2
        assert [e["name"] for e in doc["events"]] == ["hedge.win", "peer.down"]
        _, body = _get(srv.url + "/events?since=1&name=peer")
        assert [e["seq"] for e in json.loads(body)["events"]] == [2]
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.url + "/events?since=x")
        assert err.value.code == 400
        for _ in range(5):
            slo.record("corrupt", 0.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.url + "/healthz")
        assert err.value.code == 503
        assert json.loads(err.value.read())["healthy"] is False
    finally:
        srv.close()
