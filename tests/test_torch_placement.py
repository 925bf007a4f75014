"""The port's placement layer on the CPU against the JAX package's: the
topology grammar and its errors, ``required_domains``, the shard -> peer
maps of ``PlacementRing`` over random topologies, keys, selectors, seeds,
live sets and LRC codes (``owners``, ``owner_domains`` and ``moved``
after a membership change) — a port node and a reference node given the
same ``-topology`` compute the same map; ``TargetedDelivery``'s per-peer
cohorts and saved fan-out; and the ``Rebalancer``'s moves, deferrals
and destination holdings under a scripted up/down with a token bucket
on a driven clock. Every comparison is exact."""

import hashlib

import numpy as np
import pytest

import noise_ec_tpu.host.wire as ref_wire
import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu.placement as ref_placement
import noise_ec_tpu.placement.ring as ref_ring
import noise_ec_tpu.store as ref_store
import noise_ec_tpu_torch.host.wire as port_wire
import noise_ec_tpu_torch.obs.registry as port_registry
import noise_ec_tpu_torch.placement as port_placement
import noise_ec_tpu_torch.placement.ring as port_ring
import noise_ec_tpu_torch.store as port_store

PKGS = {
    "ref": (ref_placement, ref_ring, ref_store, ref_wire, ref_registry,
            {"backend": "numpy"}),
    "port": (port_placement, port_ring, port_store, port_wire,
             port_registry, {"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _isolate_port_registry():
    port_registry.default_registry().reset_values()
    yield


# ------------------------------------------------------------- grammar


@pytest.mark.parametrize("spec", [
    "domain=rack1:tcp://a:3000,tcp://b:3000;domain=rack2: tcp://c:3000*2.0 ;;",
    "domain=d0:tcp://127.0.0.1:3001",
    ";".join(f"domain=z{j}:" + ",".join(f"tcp://h{j}x{i}:9*{1 + i % 3}"
                                        for i in range(4)) for j in range(6)),
])
def test_topology_parse_matches(spec):
    ref = ref_ring.Topology.parse(spec)
    port = port_ring.Topology.parse(spec)
    assert (ref.domains, ref.weights) == (port.domains, port.weights)
    assert ref.names() == port.names() and ref.all_peers() == port.all_peers()
    for tok in ref.all_peers() + ("tcp://nobody:1",):
        assert ref.domain_of(tok) == port.domain_of(tok)


@pytest.mark.parametrize("bad", [
    "rack1:tcp://a:1", "domain=rack1", "domain=:tcp://a:1",
    "domain=r:tcp://a:1;domain=r:tcp://b:1",
    "domain=r1:tcp://a:1;domain=r2:tcp://a:1", "domain=r1:tcp://a:1*0",
    "domain=r1:,", ""])
def test_topology_errors_match(bad):
    errs = []
    for ring in (ref_ring, port_ring):
        with pytest.raises(ValueError) as info:
            ring.Topology.parse(bad)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


def test_required_domains_match():
    for k, n, code in [(4, 6, "rs"), (4, 8, "rs"), (10, 14, "rs"),
                       (8, 12, "lrc:2"), (8, 14, "lrc:4"),
                       (40, 56, "lrc:8"), (12, 16, "lrc:2")]:
        assert port_ring.required_domains(k, n, code) == \
            ref_ring.required_domains(k, n, code)
    assert port_ring.required_domains(4, 6) == 6


# ---------------------------------------------------------------- maps


def _random_topology(rng):
    """A random spec of 2-9 domains of 1-5 peers, some weighted."""
    parts = []
    for j in range(int(rng.integers(2, 10))):
        peers = []
        for i in range(int(rng.integers(1, 6))):
            tok = f"tcp://10.{j}.{i}.{int(rng.integers(1, 250))}:{3000 + i}"
            if rng.random() < 0.3:
                tok += f"*{float(rng.integers(1, 5)) / 2}"
            peers.append(tok)
        parts.append(f"domain=r{j}:" + ",".join(peers))
    return ";".join(parts)


@pytest.mark.parametrize("case", range(12))
def test_ring_maps_match_over_random_topologies(case):
    rng = np.random.default_rng(1000 + case)
    spec = _random_topology(rng)
    selector = ("ring", "straw2")[case % 2]
    seed = 0 if case < 4 else int(rng.integers(0, 1 << 31))
    rings = [mod.PlacementRing(mod.Topology.parse(spec), seed=seed,
                               selector=selector)
             for mod in (ref_ring, port_ring)]
    topo = rings[0].topology
    everyone = set(topo.all_peers())
    leaver = sorted(everyone)[int(rng.integers(0, len(everyone)))]
    shrunk = everyone - {leaver}
    nd = len(topo.names())
    maps = []
    for ring in rings:
        out = []
        for i in range(24):
            key = hashlib.blake2b(b"%d-%d" % (case, i),
                                  digest_size=8).hexdigest()
            for k, n in [(2, 3), (4, 6), (max(1, nd - 2), nd + 1)]:
                out.append((key, n, ring.owners(key, n, k=k),
                            ring.owners(key, n, k=k, alive=shrunk),
                            ring.owner_domains(key, n),
                            ring.moved(key, n, everyone, shrunk, k=k)))
            if nd >= 3:
                out.append((key, "lrc", ring.owners(key, 8, k=4,
                                                    code="lrc:2"),
                            ring.owner_domains(key, 8, k=4, code="lrc:2")))
        maps.append(out)
    assert maps[0] == maps[1]


def test_ring_errors_match():
    topo = "domain=a:x,y;domain=b:z"
    for mod in (ref_ring, port_ring):
        ring = mod.PlacementRing(mod.Topology.parse(topo))
        with pytest.raises(ValueError, match="needs k"):
            ring.owners("k0", 12, code="lrc:2")
        with pytest.raises(ValueError, match="bad LRC geometry"):
            ring.owners("k0", 12, k=7, code="lrc:2")
        with pytest.raises(ValueError, match="unknown selector"):
            mod.PlacementRing(mod.Topology.parse(topo), selector="hrw")


# ------------------------------------------------------ targeted delivery


class _DirectedNet:
    """The directed send surface ``TargetedDelivery`` probes for: a
    directory of topology tokens and a ``send_many_to`` that records each
    cohort's shard numbers (a token listed in ``refuse`` refuses)."""

    def __init__(self, tokens, refuse=()):
        self.directory = {tok: f"pk-{tok}" for tok in tokens}
        self.refuse = set(refuse)
        self.cohorts = []

    def placement_directory(self):
        return dict(self.directory)

    def send_many_to(self, handle, msgs):
        tok = handle[len("pk-"):]
        self.cohorts.append((tok, [m.shard_number for m in msgs]))
        return tok not in self.refuse


@pytest.mark.parametrize("k,n,refuse", [(4, 6, ()), (2, 3, ()),
                                        (4, 6, ("tcp://h3:3000",))])
def test_targeted_delivery_cohorts_match(k, n, refuse):
    spec = ";".join(f"domain=d{j}:tcp://h{j}:3000,tcp://g{j}:3000"
                    for j in range(6))
    results = []
    for name in ("ref", "port"):
        placement, ring_mod, _, wire, registry, _ = PKGS[name]
        ring = ring_mod.PlacementRing(ring_mod.Topology.parse(spec), seed=0)
        policy = placement.TargetedDelivery(ring, self_token="tcp://h0:3000")
        net = _DirectedNet([t for t in ring.topology.all_peers()
                            if t != "tcp://h0:3000"], refuse)
        saved = registry.default_registry().counter(
            "noise_ec_placement_fanout_saved_total").labels()
        s0 = saved.value
        out = []
        for i in range(8):
            sig = hashlib.blake2b(b"obj%d" % i, digest_size=64).digest()
            shards = [wire.Shard(file_signature=sig,
                                 shard_data=bytes([j]) * 64, shard_number=j,
                                 total_shards=n, minimum_needed_shards=k)
                      for j in range(n)]
            out.append(policy.send(net, shards))
            out.append(policy.absorbs(shards[1]))
        results.append((out, net.cohorts, saved.value - s0))
    assert results[0] == results[1]
    assert results[1][2] > 0


# ------------------------------------------------------------ rebalancer


def _rebalance_script(name) -> list:
    """Origin A holds six RS(2,3) stripes; B1/B2 and C are the remote
    owners. Cycles under a token bucket on a driven clock, then B1 down
    and back up; each cycle's stats, the bytes moved and what every
    destination holds."""
    placement, ring_mod, store_mod, _, registry, kw = PKGS[name]
    topo = ring_mod.Topology(
        domains=(("da", ("A",)), ("db", ("B1", "B2")), ("dc", ("C",))),
        weights={})
    ring = ring_mod.PlacementRing(topo, seed=2)
    stores = {tok: store_mod.StripeStore(**kw) for tok in topo.all_peers()}
    sends = []

    def send(token, msgs):
        sends.append((token, [m.shard_number for m in msgs]))
        return all(stores[token].note_placement_shard(m) for m in msgs)

    now = [0.0]
    rb = placement.Rebalancer(stores["A"], ring, self_token="A", send=send,
                              rate_bytes_per_s=4096.0, burst_bytes=4096,
                              clock=lambda: now[0])
    rng = np.random.default_rng(6)
    keys = [stores["A"].put_object(
        hashlib.blake2b(b"pl%d" % i, digest_size=64).digest(),
        rng.bytes(4096), 2, 3) for i in range(6)]
    trace = [keys]
    for step in range(12):
        trace.append((step, rb.run_cycle(), rb.bytes_moved))
        now[0] += 1.0
        if step == 5:
            rb.note_down("B1")
        if step == 9:
            rb.note_up("B1")
    trace.append(sends)
    for tok, store in sorted(stores.items()):
        trace.append((tok, {key: store.snapshot(key)[1]
                            for key in sorted(store.keys())}))
    trace.append(rb.census())
    moves = registry.default_registry().counter(
        "noise_ec_placement_moves_total")
    trace.append({reason: moves.labels(reason=reason).value
                  for reason in ("delta", "deferred", "dropped", "migrate")})
    return trace


def test_rebalancer_moves_match_under_scripted_membership():
    ref = _rebalance_script("ref")
    port = _rebalance_script("port")
    assert ref == port
    assert any(stats["deferred"] for _, stats, _ in port[1:13])
    assert port[12][1]["moved"] == 0  # converged


def test_token_bucket_matches():
    got = []
    for name in ("ref", "port"):
        now = [0.0]
        bucket = PKGS[name][0].TokenBucket(100.0, 1000, clock=lambda: now[0])
        seq = []
        for step, want in enumerate([1000, 1, 200, 1, 50, 999, 1000, 1]):
            seq.append(bucket.take(want))
            now[0] += (2.0, 0.0, 0.0, 1.5, 10.0, 1000.0, 0.0, 0.0)[step]
        got.append(seq)
    assert got[0] == got[1]
