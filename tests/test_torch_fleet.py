"""The port's fleet lab (``noise_ec_tpu_torch.fleet``) against the
reference's: the profile grammar and equal parsed profiles, the same
identities, overlay and per-link chaos for one seed, the hot-read mix on
the cache tiers, the device gate and the dispatcher's backpressure and
fairness, shed-versus-lost scoring, the 10x talker, the small-fleet
acceptance run under named chaos, the federated per-tenant p99 against the
scorer's, the slow-peer and noisy-tenant diagnosis, and the 1k-peer soak
(``slow``, as in the reference). Peers run on ``backend="numpy"``, as the
reference's do, and on ``device="cpu"`` (the kernels' plain versions); a
lab built for the card without one raises. The port's process registry is
reset before each test, so every count read is the test's own. Tolerance:
exact for profiles, identities, scores and deliveries; the federated p99
not below the scorer's bucket less one."""

import json
import threading
import time
from urllib.request import urlopen

import numpy as np
import pytest
import torch

from noise_ec_tpu.fleet import FleetLab as RefFleetLab
from noise_ec_tpu.fleet import FleetProfile as RefFleetProfile
from noise_ec_tpu_torch.fleet import NAMED_CHAOS, FleetLab, FleetProfile
from noise_ec_tpu_torch.host.transport import _SerialDispatcher
from noise_ec_tpu_torch.obs import events as port_events
from noise_ec_tpu_torch.obs import trace as port_trace
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.server import StatsServer


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    """The port's process-wide registry, event log and tracer, scoped to
    the test (the shared conftest resets only the reference's)."""
    default_registry().reset_values()
    port_events.default_event_log().clear()
    port_trace.default_tracer().clear()
    yield


def counter_total(name: str) -> float:
    return sum(child.value for _, child
               in default_registry().counter(name).children())


def _lab(text, seed, **kw):
    kw.setdefault("backend", "numpy")
    return FleetLab(FleetProfile.parse(text), seed=seed, **kw)


# ------------------------------------------------------------- grammar


def test_fleet_profile_parse_grammar():
    p = FleetProfile.parse(
        "peers=120, fanout=5,msgs=300,chat=0.7,object=0.2,repair=0.1,"
        "chat_bytes=128,object_bytes=4096,chaos=lossy,"
        "churn@2:4:0.5:0.25,partition@1:2,churn_peers=10"
    )
    assert p.peers == 120 and p.fanout == 5 and p.msgs == 300
    assert (p.chat, p.object, p.repair) == (0.7, 0.2, 0.1)
    assert p.chaos_name == "lossy"
    assert p.chaos.drop == 0.01 and p.chaos.corrupt == 0.005
    assert p.chaos.churns == ((2.0, 4.0, 0.5, 0.25),)
    assert p.chaos.partitions == ((1.0, 2.0, "both"),)
    assert p.churn_peers == 10
    w = p.weights()
    assert abs(sum(w.values()) - 1.0) < 1e-9
    assert abs(w["chat"] - 0.7) < 1e-9
    assert p.needs_stores()
    assert not FleetProfile.parse("peers=8,chat=1").needs_stores()
    g = FleetProfile.parse("peers=8,chat=0.2,object=0.3,get=0.5,zipf_s=1.3")
    assert g.get == 0.5 and g.zipf_s == 1.3 and g.needs_stores()
    for bad in ("peers=1", "fanout=0", "peers=4,fanout=9",
                "chat=0,object=0,repair=0", "chaos=imaginary",
                "frobnicate=1", "msgs", "k=6,n=4", "get=0.5,zipf_s=1.0"):
        with pytest.raises(ValueError):
            FleetProfile.parse(bad)
    assert set(NAMED_CHAOS) >= {"clean", "lossy", "flaky", "storm"}


_PROFILES = [
    "peers=200,fanout=6,msgs=500,chat=0.9,object=0.1,chaos=lossy",
    "peers=24,fanout=4,msgs=64,object=1,get=2,object_bytes=8192,"
    "stripe_bytes=4096,k=4,n=8,chaos=clean,domains@8,slow@2:120:30",
    "peers=1000,fanout=4,msgs=400,chat=0.95,object=0.05,"
    "object_bytes=4096,chaos=lossy,churn@1:2:0.3:0.5",
    "peers=50,fanout=6,msgs=1,object=1,object_bytes=8192,"
    "stripe_bytes=4096,k=4,n=8,chaos=clean,domains@8,slow@7:120,noisy=10",
]


@pytest.mark.parametrize("text", _PROFILES)
def test_fleet_profile_equals_reference(text):
    p, ref = FleetProfile.parse(text), RefFleetProfile.parse(text)
    assert p.weights() == ref.weights()
    assert p.needs_stores() == ref.needs_stores()
    skip = {"chaos"}
    assert ({k: v for k, v in vars(p).items() if k not in skip}
            == {k: v for k, v in vars(ref).items() if k not in skip})
    assert repr(p.chaos).split("(", 1)[1] == repr(ref.chaos).split("(", 1)[1]


def test_lab_identities_overlay_and_links_equal_reference():
    """For one profile and seed the port's lab builds the reference's
    fleet: the same keys, the same bounded-degree overlay, the same
    directed links and the same per-link fault decisions."""
    text = "peers=30,fanout=4,msgs=10,chat=1,chaos=lossy"
    lab = _lab(text, 7).start()
    ref = RefFleetLab(RefFleetProfile.parse(text), seed=7).start()
    try:
        assert ([bytes(p.keys.public_key) for p in lab.peers]
                == [bytes(p.keys.public_key) for p in ref.peers])
        assert ([p.neighbors for p in lab.peers]
                == [p.neighbors for p in ref.peers])
        assert sorted(lab.hub.links) == sorted(ref.hub.links)
        rng = np.random.default_rng(0)
        frames = [rng.bytes(64) for _ in range(200)]
        for key in sorted(lab.hub.links)[:6]:
            a, b = lab.hub.links[key], ref.hub.links[key]
            assert ([a.admit(f, 0.01 * i) for i, f in enumerate(frames)]
                    == [b.admit(f, 0.01 * i) for i, f in enumerate(frames)])
    finally:
        lab.close()
        ref.close()


def test_clean_run_scores_equal_reference():
    """Under ``clean`` chaos a run's score is deterministic: the port's
    lab sends and delivers what the reference's does. Its report holds
    the reference's keys and the port's ``verify_reads``."""
    text = "peers=12,fanout=3,msgs=40,chat=0.8,object=0.2,chaos=clean"
    lab = _lab(text, 5)
    ref = RefFleetLab(RefFleetProfile.parse(text), seed=5)
    try:
        got, want = lab.run(), ref.run()
    finally:
        lab.close()
        ref.close()
    assert got["sent"] == want["sent"] == 40
    assert got["delivery"] == want["delivery"]
    assert got["delivery"]["rate"] == 1.0
    assert ({k: v["sent"] for k, v in got["by_kind"].items()}
            == {k: v["sent"] for k, v in want["by_kind"].items()})
    assert set(got) == set(want) | {"verify_reads"}
    assert set(got["gets"]) == set(want["gets"]) | {"failed"}


def test_device_cpu_lab_delivers_like_the_numpy_lab():
    """Peers on ``device="cpu"`` (every product through the kernels'
    plain versions behind the device gate and the breaker) score what the
    numpy peers score on the same clean run, and the codec refuses
    nothing."""
    text = "peers=8,fanout=3,msgs=16,chat=0.75,object=0.25,chaos=clean"
    runs = {}
    for kw in ({"backend": "numpy"}, {"device": "cpu", "backend": "device"}):
        lab = _lab(text, 4, **kw)
        try:
            runs[kw["backend"]] = lab.run()
        finally:
            lab.close()
    assert runs["device"]["delivery"] == runs["numpy"]["delivery"]
    assert runs["device"]["delivery"]["rate"] == 1.0
    assert runs["device"]["errors"] == runs["numpy"]["errors"]
    assert counter_total("noise_ec_codec_refused_total") == 0
    assert default_registry().counter("noise_ec_kernel_calls_total").labels(
        entry="matmul_stripes").value > 0


def test_lab_built_for_the_card_raises_without_one():
    """No fallback hides the card: a lab whose peers run on ``cuda``
    raises at ``start()`` on a host without one."""
    if torch.cuda.is_available():  # pragma: no cover - a card's host
        pytest.skip("a CUDA device is present")
    lab = FleetLab(FleetProfile.parse("peers=4,fanout=2,msgs=4,chat=1"),
                   seed=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            lab.start()
    finally:
        lab.close()


def test_fleet_zipfian_get_mix_rides_the_cache_tiers():
    lab = _lab("peers=8,fanout=3,msgs=120,chat=0.1,object=0.3,get=0.6,"
               "object_bytes=4096,stripe_bytes=4096", 5)
    try:
        report = lab.run()
    finally:
        lab.close()
    gets = report["gets"]
    assert gets["ok"] > 0, gets
    assert gets["bad"] == 0, gets
    assert counter_total("noise_ec_object_cache_hits_total") > 0
    assert report["delivery"]["rate"] == 1.0


@pytest.mark.parametrize("kw", [{"backend": "numpy"}, {"device": "cpu"}],
                         ids=["numpy", "cpu"])
def test_straggler_drill_hedges_and_reads_every_object_back(kw):
    """docs/fleet.md's straggler drill (a 120 ms owner): the hedged GET
    through ``placement_fetch`` is requested and wins, every put object
    reads back byte-equal from every expected receiver after the run
    (``verify_reads``), and no hot GET fails once its manifest resolves
    (``gets["failed"]``; a reader the manifest never reached is
    ``missing``, which the reference counts together with failures)."""
    lab = _lab(_PROFILES[1], 11, **kw)
    try:
        report = lab.run()
    finally:
        lab.close()
    hedge, gets, reads = report["hedge"], report["gets"], report["verify_reads"]
    assert hedge["requests"] > 0 and hedge["wins"] > 0, hedge
    assert sum(gets.values()) > 0, gets
    assert gets["bad"] == gets["failed"] == 0, gets
    objects = report["by_kind"]["object"]
    assert reads == {"ok": objects["expected"], "bad": 0, "missing": 0,
                     "failed": 0}, (reads, objects)
    assert objects["expected"] > 0
    assert report["delivery"]["rate"] == 1.0


# -------------------------------------------- backpressure in isolation


def test_device_gate_blocks_senders_without_pool_evictions():
    from noise_ec_tpu_torch.ops.dispatch import (
        DeviceCodec,
        configure_device_gate,
    )

    gate = configure_device_gate(capacity=1, wait_timeout=30.0)
    try:
        dev = DeviceCodec(field="gf256", device="cpu")
        M = np.array([[1, 1], [1, 2]], dtype=np.uint8)
        D = np.arange(2 * 64, dtype=np.uint8).reshape(2, 64)
        want = dev.matmul_stripes(M, D)
        waits0 = counter_total("noise_ec_backpressure_waits_total")
        evict0 = counter_total("noise_ec_mempool_evictions_total")
        hist = default_registry().histogram(
            "noise_ec_backpressure_wait_seconds").labels(layer="device")
        count0 = hist.count
        gate.acquire()
        done = threading.Event()
        out: list = []

        def sender():
            out.append(dev.matmul_stripes(M, D))
            done.set()

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        assert not done.wait(0.4)
        assert gate.waiters == 1
        gate.release()
        assert done.wait(10)
        t.join(timeout=5)
        assert np.array_equal(out[0], want)
        assert counter_total("noise_ec_backpressure_waits_total") == waits0 + 1
        assert hist.count == count0 + 1
        assert counter_total("noise_ec_mempool_evictions_total") == evict0
        assert default_registry().gauge(
            "noise_ec_backpressure_queue_depth").labels(
            layer="device").read() == 0
    finally:
        configure_device_gate()


def test_dispatcher_submit_wait_blocks_then_succeeds():
    release = threading.Event()
    ran: list[str] = []
    d = _SerialDispatcher(max_workers=1, max_queue=2)
    try:
        d.submit(b"blk", lambda: release.wait(10))
        assert d.submit(b"k", ran.append, "a")
        assert d.submit(b"k", ran.append, "b")
        waits0 = counter_total("noise_ec_backpressure_waits_total")
        blocked: list = []

        def producer():
            blocked.append(d.submit_wait(b"k", ran.append, "c", timeout=30.0))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        time.sleep(0.3)
        assert t.is_alive()
        assert counter_total("noise_ec_backpressure_waits_total") == waits0 + 1
        overflows0 = d.overflows
        release.set()
        t.join(timeout=10)
        assert blocked == [True]
        deadline = time.monotonic() + 5
        while ran != ["a", "b", "c"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ran == ["a", "b", "c"]
        assert d.overflows == overflows0
        blocker2 = threading.Event()
        d.submit(b"blk2", blocker2.wait, 10)
        d.submit(b"j", ran.append, "x")
        d.submit(b"j", ran.append, "y")
        assert not d.submit_wait(b"j", ran.append, "z", timeout=0.1)
        assert d.overflows == overflows0 + 1
        blocker2.set()
    finally:
        d.shutdown(wait=False)


def test_dispatcher_fair_quantum_interleaves_quiet_senders():
    order: list = []
    lock = threading.Lock()
    release = threading.Event()

    def record(tag):
        with lock:
            order.append(tag)

    d = _SerialDispatcher(max_workers=1, max_queue=4096)
    try:
        d.submit(b"blk", lambda: release.wait(10))
        for i in range(64):
            d.submit(b"spam", record, ("spam", i))
        for q in range(8):
            d.submit(b"q%d" % q, record, ("quiet", q))
        release.set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with lock:
                if len(order) >= 72:
                    break
            time.sleep(0.01)
        with lock:
            snapshot = list(order)
        assert len(snapshot) == 72
        positions = {tag[1]: i for i, tag in enumerate(snapshot)
                     if tag[0] == "quiet"}
        assert len(positions) == 8
        assert max(positions.values()) < 15, snapshot[:24]
    finally:
        d.shutdown(wait=False)


# -------------------------------------------------- scoring + admission


def test_fleet_shed_accounting_is_distinct_from_lost():
    lab = _lab("peers=4,fanout=2,msgs=4,chat=1,chaos=clean", 3)
    lab.start()
    try:
        rng = np.random.default_rng(0)
        sender = lab.peers[0]
        for _ in range(20):
            sender.slo.record("verify_failed", 0.0)
        assert lab.submit_chat(sender, rng) is None
        assert counter_total("noise_ec_fleet_shed_total") >= 1
        healthy = lab.peers[1]
        assert lab.submit_chat(healthy, rng) is not None
        lab._wait_drained(10.0)
        report = lab.scorer.report({}, duration=1.0)
        assert report["shed"]["total"] == 1
        assert report["shed"]["by_reason"] == {"slo": 1}
        assert report["shed"]["retry_after_s"] == lab.shed_retry_after
        assert report["delivery"]["expected"] == len(healthy.neighbors)
        assert report["delivery"]["lost"] == 0
        assert report["delivery"]["rate"] == 1.0
    finally:
        lab.close()


def test_fleet_fairness_10x_talker_keeps_quiet_p99_in_slo():
    lab = _lab("peers=10,fanout=3,msgs=1,chat=1,chat_bytes=64,chaos=clean",
               5, p99_target_seconds=2.0)
    lab.start()
    try:
        talker, quiet = lab.peers[0], lab.peers[1:]
        rng_t, rng_q = np.random.default_rng(1), np.random.default_rng(2)
        n_quiet_each = 12

        def talk():
            for _ in range(10 * n_quiet_each):
                lab.submit_chat(talker, rng_t)

        t = threading.Thread(target=talk, daemon=True)
        t.start()
        for _ in range(n_quiet_each):
            for peer in quiet:
                lab.submit_chat(peer, rng_q)
            time.sleep(0.02)
        t.join(timeout=60)
        lab._wait_drained(30.0)
        report = lab.scorer.report({}, duration=1.0)
        assert report["delivery"]["lost"] == 0
        assert report["by_kind"]["chat"]["sent"] == 19 * n_quiet_each
        for peer in quiet:
            p99_ms = report["per_sender_p99_ms"].get(peer.idx)
            assert p99_ms is not None
            assert p99_ms <= lab.p99_target_seconds * 1e3
    finally:
        lab.close()


# ------------------------------------------------- acceptance


def test_small_fleet_acceptance_mixed_traffic_under_named_chaos():
    """50 peers, mixed chat and object traffic under the named ``lossy``
    profile: delivery >= 99.9% with sheds counted apart from losses, the
    coalescer batching the peers' products, ``GET /fleet`` and the
    ``/healthz`` fleet block."""
    from noise_ec_tpu_torch.ops.coalesce import coalescer

    lab = _lab("peers=50,fanout=6,msgs=150,chat=0.9,object=0.1,"
               "object_bytes=6144,chaos=lossy", 11)
    lab.start()
    server = StatsServer()
    lab.attach(server)
    sizes0 = dict(coalescer().batch_sizes)
    try:
        report = lab.run()
        delivery = report["delivery"]
        assert delivery["expected"] >= 800, report
        assert delivery["rate"] >= 0.999, report
        assert report["shed"]["total"] == len(lab.scorer.shed_events)
        assert report["by_kind"]["chat"]["delivered"] > 0
        assert report["by_kind"]["object"]["delivered"] > 0
        assert report["chaos_profile"] == "lossy"
        assert report["chaos"]["dropped"] + report["chaos"]["corrupted"] > 0
        # The coalescer's own counters (the port keeps no
        # noise_ec_coalesce_* families): some requests rode a batch.
        sizes = {s: n - sizes0.get(s, 0)
                 for s, n in coalescer().batch_sizes.items()}
        assert sum(n for s, n in sizes.items() if s > 1) > 0, sizes
        with urlopen(f"{server.url}/fleet", timeout=5) as resp:
            assert resp.status == 200
            doc = json.loads(resp.read())
        assert doc["profile"]["peers"] == 50
        assert doc["live"]["sent"] == report["sent"]
        assert doc["report"]["delivery"]["rate"] == delivery["rate"]
        with urlopen(f"{server.url}/healthz?verbose=1", timeout=5) as resp:
            health = json.loads(resp.read())
        block = health["details"]["fleet"]
        assert block["peers"] == 50 and block["up"] == 50
        assert block["delivered"] > 0
    finally:
        server.close()
        lab.close()


def _tenant_get_buckets(text: str, tenant: str) -> dict:
    buckets: dict = {}
    for line in text.splitlines():
        if not line.startswith("noise_ec_object_op_seconds_bucket"):
            continue
        if f'tenant="{tenant}"' not in line or 'op="get"' not in line:
            continue
        le = line.split('le="', 1)[1].split('"', 1)[0]
        bound = float("inf") if le == "+Inf" else float(le)
        sample = line.split(" # ", 1)[0]  # drop a trace exemplar
        buckets[bound] = buckets.get(bound, 0.0) + float(
            sample.rsplit(" ", 1)[1])
    return buckets


def _p99_bound(buckets: dict) -> float:
    total = buckets[float("inf")]
    for bound in sorted(buckets):
        if buckets[bound] >= 0.99 * total:
            return bound
    return float("inf")


@pytest.mark.parametrize("chaos", ["clean", "lossy"])
def test_fleet_federation_merged_tenant_p99_matches_scorer(chaos):
    """A 50-peer run serves ``GET /fleet/metrics``; under ``clean`` its
    merged per-tenant GET histogram is exactly 50 times one node's. The
    scorer's per-tenant samples are the histogram's reads, each timed
    around the histogram's scope: as many, never faster at any bucket
    bound, and their p99 not below the merged p99's bucket less one (the
    reference's upper allowance of one bucket or 5 ms is wall-clock
    overhead that CPU contention exceeds, so it is not asserted). Scrape
    errors are zero under ``clean`` and breaker-bounded under ``lossy``,
    where a dropped scrape serves a source's last document.
    The registry was reset before the run, so the node's histogram holds
    this run's reads alone."""
    lab = _lab("peers=50,fanout=4,msgs=120,chat=0.2,object=0.2,get=0.6,"
               f"object_bytes=4096,stripe_bytes=4096,chaos={chaos}", 23)
    lab.start()
    server = StatsServer()
    lab.attach(server)
    try:
        report = lab.run()
        assert report["fleet_metrics"]["targets"] == 50
        assert report["fleet_metrics"]["series"] > 0
        gets = report["gets"]
        assert sum(gets.values()) > 0 and gets["bad"] == 0, gets
        scorer_p99_s = report["tenant_get_p99_ms"]["fleet"] / 1e3
        if chaos == "lossy":
            for _ in range(12):
                lab.federator.scrape()
        with urlopen(f"{server.url}/metrics", timeout=5) as resp:
            local = _tenant_get_buckets(resp.read().decode(), "fleet")
        # Without a background scraper the route scrapes all 50 targets
        # and merges them on request (0.75-0.8 s on an idle CPU; past 5 s
        # once under six pytest workers), so the read's timeout only
        # bounds a hang.
        with urlopen(f"{server.url}/fleet/metrics", timeout=60) as resp:
            assert resp.status == 200
            merged = _tenant_get_buckets(resp.read().decode(), "fleet")
        bounds = sorted(merged)
        b99 = _p99_bound(merged)
        if chaos == "clean":
            # Every target reachable and none stale: the merged view is
            # exactly 50 times the node's own document.
            assert merged == {b: 50 * v for b, v in local.items()}
            assert b99 == _p99_bound(local)
        else:
            # A source whose scrape the chaos dropped is served stale (its
            # last good document), so the view is no exact multiple.
            assert abs(bounds.index(b99)
                       - bounds.index(_p99_bound(local))) <= 1
        i_merged = bounds.index(b99)
        i_scorer = min(i for i, b in enumerate(bounds) if scorer_p99_s <= b)
        assert i_scorer >= i_merged - 1, (b99, scorer_p99_s)
        # The scorer times the same reads the histogram observes, around
        # the histogram's own timing scope: one sample each, and at every
        # bucket bound no more scorer samples than histogram samples.
        samples = lab.scorer.tenant_gets["fleet"]
        assert len(samples) == local[float("inf")]
        for b in bounds:
            assert sum(1 for x in samples if x <= b) <= local[b], b
        errors = counter_total("noise_ec_federate_scrape_errors_total")
        if chaos == "clean":
            assert errors == 0
        else:
            assert 0 < errors <= 3 * 50
    finally:
        server.close()
        lab.close()


@pytest.mark.slow
def test_fleet_1k_peer_soak_with_churn(tmp_path):
    lab = _lab("peers=1000,fanout=4,msgs=400,chat=0.95,object=0.05,"
               "object_bytes=4096,chaos=lossy,churn@1:2:0.3:0.5", 23)
    lab.start()
    try:
        assert len(lab.peers) == 1000 and len(lab.hub.links) == 4000
        report = lab.run(drain_timeout=120.0)
        assert report["delivery"]["expected"] >= 1000, report
        assert report["delivery"]["rate"] >= 0.999, report
        assert report["churn"]["kills_applied"] > 0
        assert report["by_kind"]["object"]["delivered"] > 0
        path = str(tmp_path / "fleet.json")
        lab.write_report(path)
        assert lab.write_trace(path + ".trace.json")["traceEvents"]
        with open(path, encoding="utf-8") as f:
            assert json.load(f)["delivery"]["rate"] == (
                report["delivery"]["rate"])
    finally:
        lab.close()


def _peer_fetch_counts() -> dict:
    fam = default_registry().histogram("noise_ec_peer_fetch_seconds")
    return {values[0]: child.snapshot()["count"]
            for values, child in fam.children()}


def test_fleet_acceptance_diagnose_names_slow_peer_and_noisy_tenant():
    """50 peers with zipfian hot reads, one slow peer (``slow@7:120``) and
    one 10x tenant (``noisy=10``): ``GET /diagnose`` ranks ``slow-peer``
    naming the peer and ``noisy-tenant`` naming the tenant, with evidence
    that resolves against ``GET /events``."""
    from noise_ec_tpu_torch.obs.diagnose import DiagnosisEngine

    lab = _lab("peers=50,fanout=6,msgs=1,object=1,object_bytes=8192,"
               "stripe_bytes=4096,k=4,n=8,chaos=clean,domains@8,"
               "slow@7:120,noisy=10", 33)
    lab.start()
    server = StatsServer()
    lab.attach(server)
    port_events.default_event_log().attach(server)
    DiagnosisEngine().attach(server)
    try:
        rng = np.random.default_rng(9)
        si = 0
        tenants: set = set()
        while len(tenants) < 2 or len(lab._put_objects) < 12:
            assert si < 400
            sender = lab.peers[si % len(lab.peers)]
            si += 1
            if lab.submit_object(sender, rng) is not None:
                with lab._obj_lock:
                    tenants = {t for t, _, _ in lab._put_objects}
        lab._wait_drained(30.0)
        reader = 0
        for _ in range(240):
            peer = lab.peers[reader % len(lab.peers)]
            reader += 1
            if peer.idx == 7 or peer.objects is None:
                continue
            for _ in range(3):
                lab.submit_get(peer, rng)
            counts = _peer_fetch_counts()
            if (counts.get("fleet://7", 0) >= 5
                    and sum(1 for c in counts.values() if c >= 4) >= 2):
                break
        assert _peer_fetch_counts().get("fleet://7", 0) >= 5
        assert lab.get_results["ok"] > 0, lab.get_results
        with urlopen(f"{server.url}/diagnose", timeout=10) as resp:
            verdicts = json.loads(resp.read())["verdicts"]
        top2 = {v["verdict"] for v in verdicts[:2]}
        assert top2 == {"slow-peer", "noisy-tenant"}, verdicts
        slow = next(v for v in verdicts if v["verdict"] == "slow-peer")
        noisy = next(v for v in verdicts if v["verdict"] == "noisy-tenant")
        assert slow["culprit"] == {"peer": "fleet://7"}
        assert noisy["culprit"] == {"tenant": "noisy"}
        assert any("fleet://7" in k for k in slow["evidence"]["metrics"])
        with urlopen(f"{server.url}/events", timeout=10) as resp:
            seqs = {e["seq"] for e in json.loads(resp.read())["events"]}
        for v in (slow, noisy):
            assert set(v["evidence"]["event_ids"]) <= seqs, v
        with urlopen(f"{server.url}/healthz?verbose=1", timeout=10) as resp:
            health = json.loads(resp.read())
        fold = health["details"]["diagnosis"]
        assert {v["verdict"] for v in fold["verdicts"][:2]} == top2
        assert health["details"]["fleet"]["peers"] == 50
    finally:
        server.close()
        lab.close()
