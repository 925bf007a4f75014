"""The port's diagnosis engine (``noise_ec_tpu_torch.obs.diagnose``)
against the reference's: incident bundles embedding the event window and a
verdict, the rule units (slow-peer, noisy-tenant, domain-loss,
churn-storm, verify-failure-spike), a quiet node, ``GET /diagnose`` and the
``/healthz`` fold, the reference's ``tools/diagnose.py`` rendering a port
bundle; the same ranked verdicts as the reference's engine on the same
events and metrics; and the adapted ``codec-demotion`` rule, which reads
the port breaker's refusals (``codec.refused``,
``noise_ec_codec_refused_total``, the breaker's state) and names the
culprit ``{"route": "device-refused"}``, where the reference reads host
fallbacks. Tolerance: exact."""

import io
import json
import sys
import urllib.request
from pathlib import Path

import pytest

from noise_ec_tpu.obs.diagnose import DiagnosisEngine as RefDiagnosisEngine
from noise_ec_tpu.obs.events import EventLog as RefEventLog
from noise_ec_tpu.obs.registry import Registry as RefRegistry
from noise_ec_tpu.obs.trace import Tracer as RefTracer
from noise_ec_tpu_torch.obs import DiagnosisEngine as ExportedEngine
from noise_ec_tpu_torch.obs import events as port_events
from noise_ec_tpu_torch.obs.diagnose import (
    DIAGNOSE_DOC_FIELDS,
    VERDICTS,
    DiagnosisEngine,
)
from noise_ec_tpu_torch.obs.events import EventLog
from noise_ec_tpu_torch.obs.recorder import FlightRecorder
from noise_ec_tpu_torch.obs.registry import Registry, default_registry
from noise_ec_tpu_torch.obs.server import StatsServer
from noise_ec_tpu_torch.obs.trace import Tracer


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry, event log and codec breaker,
    scoped to the test (the shared conftest resets only the
    reference's)."""
    from noise_ec_tpu_torch.ops.dispatch import configure_codec_breaker

    default_registry().reset_values()
    port_events.default_event_log().clear()
    configure_codec_breaker()
    yield
    configure_codec_breaker()


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def test_bundle_embeds_event_window_and_diagnosis():
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    rec = FlightRecorder(registry=reg, tracer=tracer)
    DiagnosisEngine(registry=reg, events=events, tracer=tracer,
                    recorder=rec)
    rec.tick()  # open the timeline window BEFORE the incident's events
    events.emit("peer.down", severity="warn", endpoint="fleet://1",
                domain="rack0")
    events.emit("peer.down", severity="warn", endpoint="fleet://2",
                domain="rack0")
    events.emit("peer.drop", endpoint="fleet://1")
    rec.tick()
    bundle = rec.capture("request")
    embedded = bundle.get("events")
    assert embedded, "bundle must embed the window's wide events"
    seqs = {e["seq"] for e in embedded}
    assert {e["name"] for e in embedded} == {"peer.down", "peer.drop"}
    diag = bundle.get("diagnosis")
    assert diag and diag["trigger"] == "bundle"
    names = [v["verdict"] for v in diag["verdicts"]]
    assert set(names) <= set(VERDICTS)
    assert "domain-loss" in names
    loss = next(v for v in diag["verdicts"] if v["verdict"] == "domain-loss")
    assert loss["culprit"] == {"domain": "rack0"}
    # evidence pointers resolve against the embedded window itself
    assert loss["evidence"]["event_ids"]
    assert set(loss["evidence"]["event_ids"]) <= seqs


# ------------------------------------------------------------ rule units


def test_slow_peer_rule_names_the_exact_peer():
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    engine = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    fam = reg.histogram("noise_ec_peer_fetch_seconds")
    for i in range(4):
        for _ in range(5):
            fam.labels(peer=f"fleet://{i}").observe(0.01)
    for _ in range(5):
        fam.labels(peer="fleet://9").observe(1.0)
    events.emit("hedge.late", peer="fleet://9")
    doc = engine.diagnose("request")
    assert tuple(sorted(doc)) == tuple(sorted(DIAGNOSE_DOC_FIELDS))
    assert doc["verdicts"], "slow-peer rule did not fire"
    top = doc["verdicts"][0]
    assert top["verdict"] == "slow-peer"
    assert top["culprit"] == {"peer": "fleet://9"}
    assert "fleet://9" in top["summary"]
    assert top["evidence"]["event_ids"], "hedge event evidence missing"
    base = engine.diagnose("request")
    # the hedge corroboration boosted the score over metrics alone
    events.clear()
    bare = engine.diagnose("request")["verdicts"][0]
    assert top["score"] > bare["score"]
    assert base["trigger"] == "request"


def test_noisy_tenant_rule_names_the_exact_tenant():
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    engine = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    fam = reg.histogram("noise_ec_object_op_seconds")
    for _ in range(9):
        fam.labels(tenant="noisy", op="get", route="peer").observe(1.0)
    fam.labels(tenant="quiet", op="get", route="cache").observe(1.0)
    events.emit("object.shed", tenant="noisy", reason="slo")
    verdicts = engine.diagnose("request")["verdicts"]
    assert verdicts and verdicts[0]["verdict"] == "noisy-tenant"
    assert verdicts[0]["culprit"] == {"tenant": "noisy"}
    assert verdicts[0]["score"] == pytest.approx(0.95)
    assert verdicts[0]["evidence"]["event_ids"]


def test_churn_storm_and_verify_spike_rules():
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    engine = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    for i in range(3):
        events.emit("rebalance.diff", moved=i + 1, examined=10)
    fam = reg.histogram("noise_ec_e2e_latency_seconds")
    for _ in range(3):
        fam.labels(outcome="verify_failed").observe(0.1)
    fam.labels(outcome="ok").observe(0.1)
    events.emit("scrub.corrupt", severity="error", shard="s0")
    names = [v["verdict"] for v in engine.diagnose("request")["verdicts"]]
    assert "churn-storm" in names
    assert "verify-failure-spike" in names


def test_rules_stay_silent_on_a_quiet_node():
    reg = Registry()
    engine = DiagnosisEngine(
        registry=reg, events=EventLog(registry=reg),
        tracer=Tracer(registry=Registry()),
    )
    doc = engine.diagnose("request")
    assert doc["verdicts"] == []
    assert doc["healthy"] is None  # no SLO wired


# ----------------------------------------------------- serving + renderer


def test_diagnose_route_and_healthz_fold():
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    engine = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    fam = reg.histogram("noise_ec_object_op_seconds")
    for _ in range(9):
        fam.labels(tenant="noisy", op="get", route="peer").observe(1.0)
    fam.labels(tenant="quiet", op="get", route="cache").observe(1.0)
    srv = StatsServer(port=0, registry=reg, tracer=tracer,
                      health_details=lambda: {"base": 1})
    try:
        engine.attach(srv)
        _, body = _get(srv.url + "/diagnose")
        doc = json.loads(body)
        assert tuple(sorted(doc)) == tuple(sorted(DIAGNOSE_DOC_FIELDS))
        assert doc["verdicts"][0]["verdict"] == "noisy-tenant"
        _, body = _get(srv.url + "/healthz?verbose=1")
        health = json.loads(body)
        details = health["details"]
        assert details["base"] == 1, "chained provider must keep running"
        fold = details["diagnosis"]
        assert fold["verdicts"][0]["verdict"] == "noisy-tenant"
        assert set(fold["verdicts"][0]) == {
            "verdict", "score", "culprit", "summary",
        }
    finally:
        srv.close()


def _diagnose_tool():
    sys.path.insert(
        0, str(Path(__file__).resolve().parent.parent / "tools")
    )
    try:
        import diagnose
    finally:
        sys.path.pop(0)
    return diagnose


def test_tools_diagnose_renders_verdicts_and_bundles():
    tool = _diagnose_tool()
    reg = Registry()
    tracer = Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    rec = FlightRecorder(registry=reg, tracer=tracer)
    DiagnosisEngine(registry=reg, events=events, tracer=tracer,
                    recorder=rec)
    rec.tick()
    events.emit("peer.down", severity="warn", endpoint="e1", domain="r0")
    events.emit("peer.down", severity="warn", endpoint="e2", domain="r0")
    rec.tick()
    bundle = rec.capture("request")
    out = io.StringIO()
    tool.render_bundle(bundle, out=out)
    text = out.getvalue()
    assert "domain-loss" in text
    assert "peer.down" in text
    out = io.StringIO()
    tool.render_verdicts(bundle["diagnosis"], out=out)
    assert "domain-loss" in out.getvalue()



# ------------------------------------------------ parity with the reference


def _scenario(reg, events, name):
    """Fill one package's registry and event log for a named incident."""
    if name == "slow-peer":
        fam = reg.histogram("noise_ec_peer_fetch_seconds")
        for i in range(4):
            for _ in range(5):
                fam.labels(peer=f"fleet://{i}").observe(0.01)
        for _ in range(5):
            fam.labels(peer="fleet://9").observe(1.0)
        events.emit("hedge.late", peer="fleet://9")
    elif name == "noisy-tenant":
        fam = reg.histogram("noise_ec_object_op_seconds")
        for _ in range(9):
            fam.labels(tenant="noisy", op="get", route="peer").observe(1.0)
        fam.labels(tenant="quiet", op="get", route="cache").observe(1.0)
        events.emit("object.shed", tenant="noisy", reason="slo")
    elif name == "domain-loss":
        for i in (1, 2, 3):
            events.emit("peer.down", severity="warn",
                        endpoint=f"fleet://{i}", domain="rack1")
        events.emit("peer.drop", endpoint="fleet://1")
    elif name == "mixed":
        for i in range(3):
            events.emit("rebalance.diff", moved=i + 1, examined=10)
        fam = reg.histogram("noise_ec_e2e_latency_seconds")
        for _ in range(3):
            fam.labels(outcome="verify_failed").observe(0.1)
        fam.labels(outcome="ok").observe(0.1)
        events.emit("scrub.corrupt", severity="error", shard="s0")
        events.emit("cache.shrink", bytes=1024)


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "at"}


@pytest.mark.parametrize("name", ["slow-peer", "noisy-tenant",
                                  "domain-loss", "mixed", "quiet"])
def test_verdicts_equal_reference(name):
    reg, tracer = Registry(), Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    ref_reg, ref_tracer = RefRegistry(), RefTracer(registry=RefRegistry())
    ref_events = RefEventLog(registry=ref_reg, tracer=ref_tracer)
    _scenario(reg, events, name)
    _scenario(ref_reg, ref_events, name)
    port = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    ref = RefDiagnosisEngine(registry=ref_reg, events=ref_events,
                             tracer=ref_tracer)
    got, want = port.diagnose("request"), ref.diagnose("request")
    assert _strip(got) == _strip(want)
    assert (got["verdicts"] != []) == (name != "quiet")


def test_exported_from_obs():
    assert ExportedEngine is DiagnosisEngine
    assert "codec-demotion" in VERDICTS


def test_codec_demotion_reads_the_breakers_refusals():
    """Refusals counted by the port's breaker (the process registry and
    event log, as ``codec/rs.py`` records them) rank ``codec-demotion``
    with the port's culprit; the evidence names the refusal events."""
    from noise_ec_tpu_torch.ops.dispatch import record_codec_refusal

    engine = DiagnosisEngine(tracer=Tracer(registry=Registry()))
    assert engine.diagnose("request")["verdicts"] == []
    record_codec_refusal("error")
    for _ in range(3):
        record_codec_refusal("open")
    doc = engine.diagnose("request")
    (v,) = [v for v in doc["verdicts"] if v["verdict"] == "codec-demotion"]
    assert v["culprit"] == {"route": "device-refused"}
    assert v["summary"].startswith("4 codec refusals in window")
    assert len(v["evidence"]["event_ids"]) == 4
    assert v["evidence"]["metrics"]["noise_ec_codec_circuit_state"] == 0.0
    assert v["score"] == pytest.approx(0.4 + 8 / 30.0, abs=1e-3)


def test_codec_demotion_fires_on_an_open_breaker_alone():
    from noise_ec_tpu_torch.ops.dispatch import configure_codec_breaker

    breaker = configure_codec_breaker(failure_threshold=1)
    breaker.record_failure()
    assert not breaker.closed
    engine = DiagnosisEngine(tracer=Tracer(registry=Registry()))
    (v,) = [v for v in engine.diagnose("request")["verdicts"]
            if v["verdict"] == "codec-demotion"]
    assert v["culprit"] == {"route": "device-refused"}
    assert v["evidence"]["metrics"]["noise_ec_codec_circuit_state"] == 1.0


def test_codec_demotion_ignores_host_fallback_events():
    """The port never demotes to the host: a ``codec.fallback`` record
    (the reference's signal) is not what its rule reads, and a breaker
    already re-closed by its canary is not a live cause."""
    reg, tracer = Registry(), Tracer(registry=Registry())
    events = EventLog(registry=reg, tracer=tracer)
    engine = DiagnosisEngine(registry=reg, events=events, tracer=tracer)
    reg.counter("noise_ec_codec_fallback_total").labels(
        reason="error").add(5)
    assert engine.diagnose("request")["verdicts"] == []
    ref_reg, ref_tracer = RefRegistry(), RefTracer(registry=RefRegistry())
    ref_events = RefEventLog(registry=ref_reg, tracer=ref_tracer)
    ref_reg.counter("noise_ec_codec_fallback_total").labels(
        reason="error").add(5)
    (want,) = RefDiagnosisEngine(registry=ref_reg, events=ref_events,
                                 tracer=ref_tracer).diagnose(
        "request")["verdicts"]
    assert want["culprit"] == {"route": "host-fallback"}
    # Refusals counted, then the canary re-closed the breaker: no live
    # cause. A refusal after the restore is one again.
    reg.counter("noise_ec_codec_refused_total").labels(reason="open").add(2)
    events.emit("codec.restore")
    assert engine.diagnose("request")["verdicts"] == []
    events.emit("codec.refused", severity="warn", reason="open")
    (got,) = engine.diagnose("request")["verdicts"]
    assert got["culprit"] == {"route": "device-refused"}
    assert got["summary"] == (
        "2 codec refusals in window, breaker state 0 (1 refusal events)")
