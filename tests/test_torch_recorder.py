"""The port's flight recorder (``noise_ec_tpu_torch.obs.recorder``)
against the reference's: delta-ring accounting (``tick``,
``flatten_registry``, the byte cap, the top-delta truncation), the SLO-flip
capture (exactly one bundle, rate-limited re-flips), bundle contents with
the spans window, the sibling Perfetto trace and the sampled request
traces, ``GET /incident``; the same flattened registry and tick deltas as
the reference's recorder on a registry filled the same way, the same
bundle keys, and a port bundle rendered by the reference's offline
``tools/trace_report.py --incident``. Tolerance: exact."""

from __future__ import annotations

import json
import sys
import urllib.request
from pathlib import Path

from noise_ec_tpu.obs.recorder import FlightRecorder as RefFlightRecorder
from noise_ec_tpu.obs.recorder import flatten_registry as ref_flatten_registry
from noise_ec_tpu.obs.registry import Registry as RefRegistry
from noise_ec_tpu.obs.trace import Tracer as RefTracer
from noise_ec_tpu_torch.obs import FlightRecorder as ExportedRecorder
from noise_ec_tpu_torch.obs.health import SLOEvaluator
from noise_ec_tpu_torch.obs.recorder import FlightRecorder, flatten_registry
from noise_ec_tpu_torch.obs.registry import Registry
from noise_ec_tpu_torch.obs.server import StatsServer
from noise_ec_tpu_torch.obs.trace import Tracer


def _trace_report():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    return trace_report


def _degrade(slo: SLOEvaluator) -> None:
    """Push the evaluator over its error budget."""
    for _ in range(max(slo.min_events, 10)):
        slo.record("corrupt", 0.001)


# -- ticking / ring ---------------------------------------------------------


def test_tick_records_deltas_and_flatten_shape():
    reg = Registry()
    ctr = reg.counter("noise_ec_dispatch_overflows_total").labels()
    hist = reg.histogram("noise_ec_decode_seconds").labels()
    rec = FlightRecorder(registry=reg, tracer=Tracer(registry=Registry()))
    rec.tick()  # baseline snapshot, no deltas yet
    ctr.add(3)
    hist.observe(0.25)
    entry = rec.tick()
    assert entry["deltas"]["noise_ec_dispatch_overflows_total"] == 3.0
    # Histograms flatten to #count/#sum (buckets would dominate the ring).
    assert entry["deltas"]["noise_ec_decode_seconds#count"] == 1.0
    assert entry["deltas"]["noise_ec_decode_seconds#sum"] == 0.25
    flat = flatten_registry(reg)
    assert flat["noise_ec_dispatch_overflows_total"] == 3.0
    assert "noise_ec_decode_seconds#count" in flat
    # A quiet tick records no deltas.
    assert rec.tick()["deltas"] == {}


def test_ring_stays_under_byte_cap():
    reg = Registry()
    fam = reg.counter("noise_ec_transport_shards_in_total")
    rec = FlightRecorder(
        registry=reg, tracer=Tracer(registry=Registry()), max_bytes=4096
    )
    for i in range(200):
        fam.labels(peer=f"tcp://p{i % 32}:1").add(i + 1)
        rec.tick()
    stats = rec.stats()
    assert stats["entries"] > 1
    assert rec.ring_bytes() <= 4096
    # Eviction happened: 200 ticks cannot fit in 4 KiB.
    assert stats["entries"] < 200
    # The ring-bytes gauge reads the live accounting.
    g = reg.gauge("noise_ec_incident_ring_bytes").labels()
    assert g.read() == rec.ring_bytes()


def test_tick_truncates_to_top_deltas():
    reg = Registry()
    fam = reg.counter("noise_ec_transport_shards_in_total")
    rec = FlightRecorder(
        registry=reg, tracer=Tracer(registry=Registry()), top_deltas=4
    )
    rec.tick()
    for i in range(10):
        fam.labels(peer=f"tcp://p{i}:1").add(i + 1)
    entry = rec.tick()
    assert len(entry["deltas"]) == 4
    assert entry["deltas_truncated"] == 6
    # Kept by |delta|: the four largest movers survive.
    assert 'noise_ec_transport_shards_in_total{peer=tcp://p9:1}' in (
        entry["deltas"]
    )


# -- SLO-flip capture -------------------------------------------------------


def test_flip_captures_exactly_one_bundle(tmp_path):
    reg = Registry()
    slo = SLOEvaluator(window_seconds=1000.0, min_events=5)
    rec = FlightRecorder(
        registry=reg, slo=slo, tracer=Tracer(registry=Registry()),
        incident_dir=str(tmp_path), min_bundle_interval=60.0,
    )
    for _ in range(5):
        slo.record("ok", 0.001)
    assert slo.verdict()["healthy"]
    rec.tick()
    _degrade(slo)
    # The flip fires listeners once; repeated degraded verdicts (the
    # healthz prober, the recorder tick) must not re-capture.
    for _ in range(5):
        assert not slo.verdict()["healthy"]
    rec.tick()
    bundles = sorted(tmp_path.glob("incident-*-flip.json"))
    assert len(bundles) == 1
    ctr = reg.counter("noise_ec_incident_bundles_total")
    assert ctr.labels(trigger="flip").value == 1
    doc = json.loads(bundles[0].read_text())
    assert doc["version"] == 1
    assert doc["trigger"] == "flip"
    assert doc["verdict"]["healthy"] is False
    assert "success rate" in doc["verdict"]["reason"]
    assert doc["timeline"], "flip bundle must carry the pre-flip ring"
    # Recovery + a second flip inside min_bundle_interval: the write is
    # rate-limited away (a flapping SLO cannot fill a disk).
    slo.reset()
    for _ in range(5):
        slo.record("ok", 0.001)
    assert slo.verdict()["healthy"]
    _degrade(slo)
    assert not slo.verdict()["healthy"]
    assert len(list(tmp_path.glob("incident-*.json"))) == 1
    assert ctr.labels(trigger="flip").value == 1


def test_capture_bundle_contents_and_spans_window(tmp_path):
    reg = Registry()
    tr = Tracer(registry=Registry())
    rec = FlightRecorder(
        registry=reg, tracer=tr, incident_dir=str(tmp_path),
        min_bundle_interval=0.0,
    )
    rec.tick()
    with tr.span("decode", key="incident-test"):
        pass
    bundle = rec.capture("request")
    assert bundle["version"] == 1
    assert bundle["trigger"] == "request"
    assert [s["name"] for s in bundle["spans"]] == ["decode"]
    assert bundle["recorder"]["ticks"] == 1
    # The sibling Perfetto trace exists and loads.
    trace_file = bundle["trace_file"]
    assert trace_file is not None
    doc = json.loads((tmp_path / trace_file).read_text())
    assert doc["traceEvents"]


def test_bundle_embeds_sampled_request_traces(tmp_path):
    """An incident bundle groups the tail-sampled
    request traces of its window under ``traces`` — whole requests
    (wire legs joined via the ``request_trace`` attr), with background
    spans and sampler-dropped requests excluded."""
    import time

    reg = Registry()
    tr = Tracer(registry=Registry())
    tr.sample_n = 1  # keep every surviving request
    rec = FlightRecorder(
        registry=reg, tracer=tr, incident_dir=str(tmp_path),
        min_bundle_interval=0.0,
    )
    rec.tick()
    with tr.request("get", tenant="t0") as scope:
        with tr.span("peer_fetch", peer="p1"):
            pass
    # A wire leg recorded under its own signature-keyed trace id in
    # another process, stamped with the originating request.
    tr.ingest([{
        "seq": 0, "trace_id": "deadbeefcafef00d", "name": "deliver",
        "start": time.time(), "seconds": 0.001, "parent": None,
        "attrs": {"request_trace": scope.trace_id},
    }])
    with tr.span("scrub"):  # background work: no request ancestor
        pass
    tr.sample_n = 10**9
    with tr.request("get") as dropped:  # sampler discards this one
        pass
    assert dropped.decision == "dropped"

    bundle = rec.capture("request")
    assert set(bundle["traces"]) == {scope.trace_id}
    names = {s["name"] for s in bundle["traces"][scope.trace_id]}
    assert {"request", "peer_fetch", "deliver"} <= names
    # The flat span list still carries the background span.
    assert "scrub" in {s["name"] for s in bundle["spans"]}


def test_incident_route_serves_bundle():
    reg = Registry()
    rec = FlightRecorder(registry=reg, tracer=Tracer(registry=Registry()))
    rec.tick()
    srv = StatsServer(port=0, registry=reg)
    try:
        rec.attach(srv)
        with urllib.request.urlopen(srv.url + "/incident", timeout=5) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert doc["trigger"] == "request"
        assert len(doc["timeline"]) == 1
    finally:
        srv.close()


def _fill(reg, step):
    reg.counter("noise_ec_dispatch_overflows_total").labels().add(3 * step)
    fam = reg.counter("noise_ec_transport_shards_in_total")
    for i in range(6):
        fam.labels(peer=f"tcp://p{i}:1").add((i + 1) * step)
    reg.gauge("noise_ec_peer_circuit_state").labels(peer="tcp://p0:1").set(
        step % 3)
    hist = reg.histogram("noise_ec_decode_seconds").labels()
    for v in (0.001 * step, 0.25, 2.0):
        hist.observe(v)


def _own(flat: dict) -> dict:
    """Drop the recorder's own families: the ring's byte count follows
    the JSON length of its timestamps."""
    return {k: v for k, v in flat.items()
            if not k.startswith("noise_ec_incident_")}


def test_exported_from_obs():
    assert ExportedRecorder is FlightRecorder


def test_flatten_and_tick_deltas_equal_reference():
    reg, ref_reg = Registry(), RefRegistry()
    rec = FlightRecorder(registry=reg, tracer=Tracer(registry=Registry()),
                         top_deltas=5)
    ref = RefFlightRecorder(registry=ref_reg,
                            tracer=RefTracer(registry=RefRegistry()),
                            top_deltas=5)
    rec.tick()
    ref.tick()
    for step in (1, 2, 5):
        _fill(reg, step)
        _fill(ref_reg, step)
        assert _own(flatten_registry(reg)) == _own(
            ref_flatten_registry(ref_reg))
        got, want = rec.tick(), ref.tick()
        assert _own(got["deltas"]) == _own(want["deltas"])
        assert got.get("deltas_truncated") == want.get("deltas_truncated")
    assert set(rec.stats()) == set(ref.stats())


def test_bundle_keys_equal_reference_and_report_renders(tmp_path):
    reg, ref_reg = Registry(), RefRegistry()
    rec = FlightRecorder(registry=reg, tracer=Tracer(registry=Registry()),
                         incident_dir=str(tmp_path / "port"),
                         min_bundle_interval=0.0)
    ref = RefFlightRecorder(registry=ref_reg,
                            tracer=RefTracer(registry=RefRegistry()),
                            incident_dir=str(tmp_path / "ref"),
                            min_bundle_interval=0.0)
    for r, g in ((rec, reg), (ref, ref_reg)):
        r.tick()
        _fill(g, 1)
        r.tick()
    got, want = rec.capture("request"), ref.capture("request")
    assert set(got) == set(want)
    assert [_own(e["deltas"]) for e in got["timeline"]] == [
        _own(e["deltas"]) for e in want["timeline"]]
    written = sorted((tmp_path / "port").glob("incident-*-request.json"))
    assert len(written) == 1
    out = _trace_report().render_incident(json.loads(written[0].read_text()))
    assert "timeline entries" in out
