"""The port's metrics federation (``noise_ec_tpu_torch.obs.federate``)
against the reference's: cross-node merge semantics (counters sum, gauge
policies, bucket-wise histograms, exemplars, the placement census's max),
the breaker-bounded scrape that serves a stale document, corrupt documents,
``GET /fleet/metrics``, and the same merged families and rendered text as
the reference's federator on the same node documents. Tolerance: exact
(equal documents)."""

from __future__ import annotations

import urllib.request

import numpy as np
import pytest

from noise_ec_tpu.obs.federate import GAUGE_POLICIES as REF_GAUGE_POLICIES
from noise_ec_tpu.obs.federate import MetricsFederator as RefMetricsFederator
from noise_ec_tpu.obs.federate import merge_documents as ref_merge_documents
from noise_ec_tpu.obs.registry import Registry as RefRegistry
from noise_ec_tpu_torch.obs import MetricsFederator as ExportedFederator
from noise_ec_tpu_torch.obs.export import (
    parse_prometheus,
    render_parsed,
    render_prometheus,
)
from noise_ec_tpu_torch.obs.federate import (
    GAUGE_POLICIES,
    MetricsFederator,
    merge_documents,
)
from noise_ec_tpu_torch.obs.registry import Registry
from noise_ec_tpu_torch.obs.server import StatsServer


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read()


def _node_doc(shards: int, circuit: int, obs: tuple[float, ...]) -> str:
    reg = Registry()
    reg.counter("noise_ec_transport_shards_in_total").labels(
        peer="tcp://a:1").add(shards)
    reg.gauge("noise_ec_peer_circuit_state").labels(
        peer="tcp://a:1").set(circuit)
    reg.gauge("noise_ec_dispatch_queue_depth").set_callback(lambda: 5)
    hist = reg.histogram("noise_ec_decode_seconds").labels()
    for v in obs:
        hist.observe(v)
    return render_prometheus(reg)


def _random_node_doc(rng) -> str:
    reg = Registry()
    for peer in ("tcp://a:1", "tcp://b:2", "tcp://c:3")[
            :int(rng.integers(1, 4))]:
        reg.counter("noise_ec_transport_shards_in_total").labels(
            peer=peer).add(int(rng.integers(0, 1000)))
        reg.gauge("noise_ec_peer_circuit_state").labels(peer=peer).set(
            int(rng.integers(0, 3)))
    g = reg.gauge("noise_ec_placement_shards")
    for d in ("rack0", "rack1"):
        g.labels(domain=d).set(int(rng.integers(0, 50)))
    hist = reg.histogram("noise_ec_object_get_seconds").labels()
    for _ in range(int(rng.integers(1, 30))):
        hist.observe(float(rng.exponential(0.01)),
                     exemplar="req-%016x" % int(rng.integers(0, 2**62))
                     if rng.random() < 0.2 else None)
    reg.histogram("noise_ec_decode_seconds").labels().observe(
        float(rng.exponential(0.001)))
    return render_prometheus(reg)


def test_exported_from_obs_and_policies_equal_reference():
    assert ExportedFederator is MetricsFederator
    assert GAUGE_POLICIES == REF_GAUGE_POLICIES


@pytest.mark.parametrize("seed", range(6))
def test_merge_documents_equals_reference(seed):
    rng = np.random.default_rng(seed)
    docs = {f"n{i}": _random_node_doc(rng)
            for i in range(int(rng.integers(1, 5)))}
    merged = merge_documents(docs)
    assert merged == ref_merge_documents(docs)
    text = render_parsed(merged)
    assert render_parsed(parse_prometheus(text)) == text


def test_federator_render_equals_reference():
    """A port and a reference federator scraping the same three sources
    (one of them failing) render the same ``/fleet/metrics`` text."""
    rng = np.random.default_rng(9)
    docs = [_random_node_doc(rng) for _ in range(2)]

    def down() -> str:
        raise OSError("down")

    def sources():
        return {"fleet://0": lambda: docs[0], "fleet://1": lambda: docs[1],
                "fleet://2": down}

    port = MetricsFederator(sources=sources(), registry=Registry())
    ref = RefMetricsFederator(sources=sources(), registry=RefRegistry())
    for _ in range(3):
        assert port.scrape() == ref.scrape() == 2
    assert port.render() == ref.render()
    assert port.merged_families() == ref.merged_families()


def test_merge_counters_sum_and_gauge_policies():
    assert GAUGE_POLICIES["noise_ec_peer_circuit_state"] == "max"
    docs = {"n0": _node_doc(3, 0, (0.001,)), "n1": _node_doc(5, 2, (0.001,))}
    fams = {f["name"]: f for f in merge_documents(docs)}
    ctr = fams["noise_ec_transport_shards_in_total"]["samples"][0]
    assert ctr[2] == "8"
    assert dict(ctr[1])["node"] == "fleet"
    assert fams["noise_ec_peer_circuit_state"]["samples"][0][2] == "2"
    assert fams["noise_ec_dispatch_queue_depth"]["samples"][0][2] == "10"


def test_merge_histograms_bucket_wise():
    docs = {"n0": _node_doc(1, 0, (0.001, 0.001, 1e9)),
            "n1": _node_doc(1, 0, (0.001,))}
    fams = {f["name"]: f for f in merge_documents(docs)}
    h = fams["noise_ec_decode_seconds"]
    buckets = [(dict(labels)["le"], raw) for sname, labels, raw
               in h["samples"] if sname.endswith("_bucket")]
    assert buckets[-1] == ("+Inf", "4")
    count = [s for s in h["samples"] if s[0].endswith("_count")][0]
    assert count[2] == "4"
    text = render_parsed([h])
    for line in text.splitlines():
        if "_bucket{" in line:
            assert line.rpartition("le=")[2].startswith('"')
            assert 'node="fleet"' in line
    assert render_parsed(parse_prometheus(text)) == text


def test_placement_census_merges_max_not_sum():
    assert GAUGE_POLICIES["noise_ec_placement_shards"] == "max"

    def doc(counts):
        reg = Registry()
        g = reg.gauge("noise_ec_placement_shards")
        for domain, n in counts.items():
            g.labels(domain=domain).set(n)
        return render_prometheus(reg)

    docs = {"n0": doc({"rack0": 7, "rack1": 3}),
            "n1": doc({"rack0": 5, "rack1": 9})}
    fams = {f["name"]: f for f in merge_documents(docs)}
    census = {dict(labels)["domain"]: raw for _, labels, raw
              in fams["noise_ec_placement_shards"]["samples"]}
    assert census == {"rack0": "7", "rack1": "9"}


def test_merge_forwards_histogram_exemplars():
    def doc(trace):
        reg = Registry()
        reg.histogram("noise_ec_object_get_seconds").labels().observe(
            0.002, exemplar=trace)
        return render_prometheus(reg)

    docs = {"n0": doc("req-00c0ffee00c0ffee"), "n1": doc(None)}
    fams = {f["name"]: f for f in merge_documents(docs)}
    text = render_parsed([fams["noise_ec_object_get_seconds"]])
    assert 'trace_id="req-00c0ffee00c0ffee"' in text
    count = [s for s in fams["noise_ec_object_get_seconds"]["samples"]
             if s[0].endswith("_count")][0]
    assert count[2] == "2"
    assert render_parsed(parse_prometheus(text)) == text


def test_federator_breaker_bounds_failures_and_serves_stale():
    reg = Registry()
    calls = {"good": 0, "bad": 0}
    state = {"fail": False}

    def good() -> str:
        calls["good"] += 1
        if state["fail"]:
            raise OSError("scrape refused")
        return _node_doc(2, 0, (0.001,))

    def bad() -> str:
        calls["bad"] += 1
        raise OSError("always down")

    fed = MetricsFederator(
        sources={"fleet://good": good, "fleet://bad": bad},
        registry=reg, failure_threshold=2, reset_timeout=60.0,
    )
    assert fed.scrape() == 1
    fed.scrape()
    for _ in range(5):
        fed.scrape()
    assert calls["bad"] == 2
    assert reg.counter("noise_ec_federate_scrapes_total").labels(
        result="skipped").value == 5
    assert reg.counter("noise_ec_federate_scrape_errors_total").labels(
        peer="fleet://bad").value == 2
    state["fail"] = True
    fed.scrape()
    fams = {f["name"]: f for f in fed.merged_families()}
    assert fams["noise_ec_transport_shards_in_total"]["samples"][0][2] == "2"


def test_federator_rejects_corrupt_documents():
    reg = Registry()
    fed = MetricsFederator(
        sources={"fleet://corrupt": lambda: 'x{peer="unterminated} 1\n'},
        registry=reg, failure_threshold=3, reset_timeout=60.0,
    )
    assert fed.scrape() == 0
    assert reg.counter("noise_ec_federate_scrapes_total").labels(
        result="error").value == 1


def test_fleet_metrics_route_serves_merged_view():
    reg = Registry()
    fed = MetricsFederator(
        sources={"fleet://0": lambda: _node_doc(3, 1, (0.001,)),
                 "fleet://1": lambda: _node_doc(4, 0, (0.002,))},
        registry=reg,
    )
    srv = StatsServer(port=0, registry=reg)
    try:
        fed.attach(srv)
        status, body = _get(srv.url + "/fleet/metrics")
        assert status == 200
        assert ('noise_ec_transport_shards_in_total{peer="tcp://a:1",'
                'node="fleet"} 7') in body.decode().splitlines()
        assert reg.gauge("noise_ec_federate_series").labels().read() > 0
    finally:
        fed.close()
        srv.close()


def test_federator_scrapes_port_nodes_over_http():
    """Peers given as URLs are scraped on ``GET /metrics`` (the CLI's
    ``-federate``): two port stats servers' counters sum in the view."""
    regs = [Registry(), Registry()]
    for i, reg in enumerate(regs):
        reg.counter("noise_ec_transport_shards_in_total").labels(
            peer="tcp://a:1").add(10 * (i + 1))
    servers = [StatsServer(port=0, registry=r) for r in regs]
    view = StatsServer(port=0, registry=Registry())
    fed = MetricsFederator(peers=[s.url for s in servers],
                           registry=Registry())
    try:
        assert fed.scrape() == 2
        fed.attach(view)
        _, body = _get(view.url + "/fleet/metrics")
        assert ('noise_ec_transport_shards_in_total{peer="tcp://a:1",'
                'node="fleet"} 30') in body.decode().splitlines()
    finally:
        fed.close()
        view.close()
        for s in servers:
            s.close()
