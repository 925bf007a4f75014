"""The port's object service on the CPU against the JAX package's, each
node on its own loopback hub with the same key seed: PUT, GET, ranged
GET, degraded GET and DELETE through ``ObjectStore`` with the same
manifests and counters; tenant quotas, closed admission and the tenant
grammar with its errors; ``ObjectAPI`` over HTTP (201, 206, 400, 404,
413, 416, and 503 with ``Retry-After`` when the SLO sheds); the decoded
cache's hit, miss and eviction counts, its pressure watermark, and the
single-flight cold read; the GET that gathers a targeted object from
six nodes in six failure domains; and a port node and a reference node
on one hub, each serving byte-identically what the other PUT. The port
runs ``device="cpu"``. Every comparison is exact."""

import json
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

import noise_ec_tpu.host.crypto as ref_crypto
import noise_ec_tpu.host.plugin as ref_plugin
import noise_ec_tpu.host.transport as ref_transport
import noise_ec_tpu.obs.health as ref_health
import noise_ec_tpu.obs.registry as ref_registry
import noise_ec_tpu.obs.server as ref_server
import noise_ec_tpu.placement as ref_placement
import noise_ec_tpu.service as ref_service
import noise_ec_tpu.store as ref_store
import noise_ec_tpu_torch.host.crypto as port_crypto
import noise_ec_tpu_torch.host.plugin as port_plugin
import noise_ec_tpu_torch.host.transport as port_transport
import noise_ec_tpu_torch.obs.events as port_events
import noise_ec_tpu_torch.obs.health as port_health
import noise_ec_tpu_torch.obs.registry as port_registry
import noise_ec_tpu_torch.obs.server as port_server
import noise_ec_tpu_torch.obs.trace as port_trace
import noise_ec_tpu_torch.placement as port_placement
import noise_ec_tpu_torch.service as port_service
import noise_ec_tpu_torch.store as port_store


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    port_registry.default_registry().reset_values()
    port_events.default_event_log().clear()
    port_trace.default_tracer().clear()
    yield


class Pkg:
    """One package's node parts and registry, and where its codecs run."""

    def __init__(self, name, crypto, plugin, transport, health, registry,
                 server, placement, service, store, codec_kw):
        self.name = name
        self.crypto, self.plugin, self.transport = crypto, plugin, transport
        self.health, self.registry, self.server = health, registry, server
        self.placement, self.service, self.store = placement, service, store
        self.codec_kw = codec_kw
        self.engines = []

    def node(self, hub, port, *, seed=1, store_dir=None, cache=None,
             engine=True, **objects_kw):
        """A loopback node with a seeded key: store, repair engine,
        plugin, object service."""
        net = self.transport.LoopbackNetwork(
            hub, self.transport.format_address("tcp", "localhost", port),
            keys=self.crypto.KeyPair.from_seed(bytes([seed]) * 32))
        store = self.store.StripeStore(store_dir, **self.codec_kw)
        eng = None
        if engine:
            eng = self.store.RepairEngine(store, network=net,
                                          linger_seconds=0.0)
            self.engines.append(eng)
        plug = self.plugin.ShardPlugin(store=store, **self.codec_kw)
        net.add_plugin(plug)
        objects_kw.setdefault("stripe_bytes", 8 << 10)
        objects_kw.setdefault("k", 4)
        objects_kw.setdefault("n", 6)
        objects_kw.setdefault("fetch_timeout_seconds", 1.0)
        return self.service.ObjectStore(store, plug, net, engine=eng,
                                        cache=cache, **objects_kw)

    def counter(self, name, **labels) -> float:
        return self.registry.default_registry().counter(name).labels(
            **labels).value

    def close(self):
        for eng in self.engines:
            eng.close()


REF = ("ref", ref_crypto, ref_plugin, ref_transport, ref_health,
       ref_registry, ref_server, ref_placement, ref_service, ref_store,
       {"backend": "numpy"})
PORT = ("port", port_crypto, port_plugin, port_transport, port_health,
        port_registry, port_server, port_placement, port_service, port_store,
        {"device": "cpu"})


@pytest.fixture
def pkgs():
    pair = (Pkg(*REF), Pkg(*PORT))
    yield pair
    for p in pair:
        p.close()


def _payload(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


CLOCK = ("created", "converted", "manifest_stripe")


def _doc(doc: dict) -> dict:
    """A manifest without its clock fields (and the stripe holding them)."""
    return {k: v for k, v in doc.items() if k not in CLOCK}


OBJECT_COUNTERS = [
    ("noise_ec_object_gets_total", {"result": r})
    for r in ("ok", "degraded", "hit", "coalesced", "miss")
] + [
    ("noise_ec_object_read_route_total", {"route": r})
    for r in ("cache", "local", "peer", "gather", "decode")
] + [
    ("noise_ec_object_puts_total", {"tenant": "acme"}),
    ("noise_ec_object_deletes_total", {"tenant": "acme"}),
    ("noise_ec_store_degraded_reads_total", {}),
    ("noise_ec_object_cache_hits_total", {}),
    ("noise_ec_object_cache_misses_total", {}),
    ("noise_ec_object_cache_evictions_total", {"reason": "lru"}),
    ("noise_ec_object_cache_evictions_total", {"reason": "pressure"}),
]


def _object_counters(pkg) -> dict:
    out = {}
    for name, labels in OBJECT_COUNTERS:
        try:
            out[(name, tuple(labels.items()))] = pkg.counter(name, **labels)
        except ValueError:  # a family without these labels
            continue
    return out


# --------------------------------------------------------- the object layer


def test_put_get_range_degraded_and_delete_match(pkgs):
    got = []
    payload = _payload(7, 100_000)
    for pkg in pkgs:
        objects = pkg.node(pkg.transport.LoopbackHub(), 3610)
        doc = objects.put("acme", "blob.bin", payload)
        trace = [_doc(doc), objects.read("acme", "blob.bin") == payload]
        cap = doc["stripe_bytes"]
        for start, length in ((0, None), (1, 1), (cap - 1, 2),
                              (len(payload) - 1, 1), (50_000, 30_000),
                              (0, len(payload) + 999)):
            _, total, chunks = objects.get_range("acme", "blob.bin", start,
                                                 length)
            trace.append((total, b"".join(chunks)))
        for key in set(doc["stripes"]):
            objects.store.drop_shard(key, 0)
            objects.store.drop_shard(key, 1)
        trace.append(objects.read("acme", "blob.bin") == payload)
        trace.append(_doc(objects.resolve("acme", "blob.bin")))
        trace.append(objects.usage("acme"))
        trace.append(objects.list_objects("acme", limit=10)[0])
        objects.delete("acme", "blob.bin")
        trace.append(objects.usage("acme"))
        with pytest.raises(KeyError):
            objects.read("acme", "blob.bin")
        trace.append(_object_counters(pkg))
        got.append(trace)
    ref, port = got
    assert [_strip_clock(x) for x in ref] == [_strip_clock(x) for x in port]
    assert port[1] and port[8]


def _strip_clock(x):
    if isinstance(x, list):
        return [_strip_clock(e) for e in x]
    if isinstance(x, dict):
        return {k: _strip_clock(v) for k, v in x.items() if k not in CLOCK}
    return x


def test_manifests_persist_and_reload_across_packages(pkgs, tmp_path):
    """Objects PUT through one package's service reload in the other's
    from the same store directory, byte-identically."""
    for writer, reader in (pkgs, pkgs[::-1]):
        d = str(tmp_path / writer.name)
        objects = writer.node(writer.transport.LoopbackHub(), 3650,
                              store_dir=d)
        payload = _payload(11, 40_000)
        objects.put("acme", "keep.bin", payload)
        objects.put("acme", "small.bin", b"tiny but durable")
        again = reader.node(reader.transport.LoopbackHub(), 3651,
                            store_dir=d)
        assert again.store.manifest_count() == 2
        assert again.read("acme", "keep.bin") == payload
        assert again.read("acme", "small.bin") == b"tiny but durable"
        assert again.usage("acme")["objects"] == 2


# ---------------------------------------------------------------- tenants


def test_quotas_and_closed_admission_match(pkgs):
    got = []
    for pkg in pkgs:
        tenants = pkg.service.TenantRegistry()
        tenants.configure("small", max_bytes=10_000, max_objects=10)
        tenants.configure("few", max_objects=1)
        objects = pkg.node(pkg.transport.LoopbackHub(), 3620,
                           tenants=tenants)
        trace = [_doc(objects.put("small", "a.bin", bytes(6_000)))]
        stripes = len(objects.store)
        for tenant, name, size in (("small", "b.bin", 6_000),
                                   ("few", "only.bin", 64),
                                   ("few", "second.bin", 64)):
            try:
                trace.append(_doc(objects.put(tenant, name, bytes(size))))
            except pkg.service.QuotaExceededError as exc:
                trace.append((exc.reason, str(exc)))
        trace.append(len(objects.store) - stripes)
        objects.delete("small", "a.bin")
        trace.append(objects.usage("small"))
        closed = pkg.service.TenantRegistry(open_admission=False)
        closed.configure("known")
        shut = pkg.node(pkg.transport.LoopbackHub(), 3621, tenants=closed)
        with pytest.raises(pkg.service.UnknownTenantError):
            shut.put("stranger", "x.bin", bytes(64))
        trace.append(pkg.counter("noise_ec_object_rejects_total",
                                 reason="quota_bytes"))
        got.append(trace)
    assert got[0] == got[1]
    assert got[1][1][0] == "quota_bytes" and got[1][3][0] == "quota_objects"


@pytest.mark.parametrize("spec", [
    {"max_bytes": 1 << 30, "max_objects": 10, "replicas": 2, "k": 10,
     "n": 14, "policy": "archive=lrc:40/8+8,age=600"},
    {"policy": "archive=lrc:20/4+6,age=600,lane=background,weight=2"},
    {"policy": "lane=live,weight=3"},
    {"k": 4, "n": 6},
])
def test_tenant_grammar_matches(spec, tmp_path):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps({"open_admission": False,
                                "tenants": {"acme": spec}}))
    got = []
    for service in (ref_service, port_service):
        reg = service.TenantRegistry.from_file(str(path))
        t = reg.get("acme")
        got.append((reg.names(), reg.open_admission, vars(t).copy()
                    if hasattr(t, "__dict__") else repr(t), t.lane,
                    t.weight))
    assert got[0] == got[1]


@pytest.mark.parametrize("name,kwargs", [
    ("bad name", {}), ("acme", {"k": 5, "n": 4}), ("acme", {"replicas": 0}),
    ("acme", {"policy": "archive=lrc:20/3+6"}),
    ("acme", {"policy": "archive=ice:20+6"}),
    ("acme", {"policy": "lane=fast"}), ("acme", {"policy": "weight=0"}),
])
def test_tenant_errors_match(name, kwargs):
    errs = []
    for service in (ref_service, port_service):
        with pytest.raises(ValueError) as info:
            service.TenantRegistry().configure(name, **kwargs)
        errs.append(str(info.value))
    assert errs[0] == errs[1]


# ------------------------------------------------------------------- HTTP


def _http(method, url, data=None, headers=None):
    req = Request(url, data=data, method=method, headers=headers or {})
    try:
        with urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _http_script(pkg) -> list:
    tenants = pkg.service.TenantRegistry()
    tenants.configure("tiny", max_bytes=1_000)
    slo = pkg.health.SLOEvaluator(window_seconds=60.0, min_events=1)
    objects = pkg.node(pkg.transport.LoopbackHub(), 3640, tenants=tenants,
                       slo=slo)
    srv = pkg.server.StatsServer(registry=pkg.registry.Registry())
    pkg.service.ObjectAPI(objects).mount(srv)
    blobs = {f"obj{i}.bin": _payload(30 + i, 9_000) for i in range(3)}
    trace = []

    def call(method, path, **kw):
        status, headers, body = _http(method, srv.url + path, **kw)
        keep = {h: headers[h] for h in ("ETag", "Content-Range",
                                         "Content-Length") if h in headers}
        if "Retry-After" in headers:
            keep["Retry-After"] = float(headers["Retry-After"]) > 0
        if headers.get("Content-Type", "").startswith("application/json"):
            # Its length holds the clock fields' digits.
            keep.pop("Content-Length", None)
            body = _strip_clock(json.loads(body))
        trace.append((method, path, status, keep, body))

    try:
        for name, blob in blobs.items():
            call("PUT", f"/objects/acme/{name}", data=blob)
        call("GET", "/objects/acme?limit=2")
        call("GET", "/objects/acme/obj0.bin")
        call("GET", "/objects/acme/obj0.bin",
             headers={"Range": "bytes=100-299"})
        call("GET", "/objects/acme/obj0.bin", headers={"Range": "bytes=-500"})
        call("GET", "/objects/acme/obj0.bin",
             headers={"Range": "bytes=999999-"})
        call("DELETE", "/objects/acme/obj0.bin")
        call("GET", "/objects/acme/obj0.bin")
        call("DELETE", "/objects/acme/obj0.bin")
        call("PUT", "/objects/acme/bad/na/me", data=b"zz")
        call("PUT", "/objects/tiny/big.bin", data=bytes(5_000))
        for _ in range(10):
            slo.record("corrupt", 0.0)
        call("PUT", "/objects/acme/shed.bin", data=bytes(4096))
        trace.append(len(objects.store))
        slo.reset()
        call("PUT", "/objects/acme/shed.bin", data=bytes(4096))
    finally:
        srv.close()
    trace.append(pkg.counter("noise_ec_object_shed_total", reason="slo"))
    return trace


def test_http_api_matches(pkgs):
    ref, port = (_http_script(pkg) for pkg in pkgs)
    assert ref == port
    statuses = [t[2] for t in port if isinstance(t, tuple)]
    assert statuses == [201, 201, 201, 200, 200, 206, 206, 416, 204, 404,
                        404, 400, 413, 503, 201]


# ------------------------------------------------------------------ cache


def _cache_script(pkg) -> list:
    trace = []
    cache = pkg.service.DecodedObjectCache(max_bytes=10_000,
                                           low_fraction=0.5,
                                           pressure_interval_seconds=0.0)
    hbm = {"limit_bytes": 0, "bytes_in_use": 0}
    cache._hbm = lambda: hbm
    for i in range(4):
        trace.append(cache.put(f"addr{i}", 0, bytes(2_400)))
    trace.append(cache.get("addr0", 0) is not None)
    trace.append(cache.put("addr4", 0, bytes(2_400)))
    trace.append([cache.contains(f"addr{i}", 0) for i in range(5)])
    hbm.update({"limit_bytes": 100, "bytes_in_use": 90})
    trace.append(cache.put("addr5", 0, bytes(2_400)))
    trace.append((cache.bytes_used, len(cache)))
    trace.append(cache.put("huge", 0, bytes(4_000)))
    # The service's write-through and hit/miss accounting.
    big = pkg.service.DecodedObjectCache(max_bytes=64 << 20)
    objects = pkg.node(pkg.transport.LoopbackHub(), 4100, cache=big)
    payload = _payload(7, 50_000)
    doc = objects.put("acme", "x.bin", payload)
    trace.append((len(big), big.bytes_used, len(doc["stripes"])))
    trace.append(objects.read("acme", "x.bin") == payload)
    big.clear()
    trace.append(objects.read("acme", "x.bin") == payload)
    trace.append(objects.read("acme", "x.bin") == payload)
    _, total, chunks = objects.get_range("acme", "x.bin", 100, 9_000)
    trace.append((total, b"".join(chunks) == payload[100:9_100]))
    trace.append(_object_counters(pkg))
    return trace


def test_cache_hits_misses_and_evictions_match(pkgs):
    ref, port = (_cache_script(pkg) for pkg in pkgs)
    assert ref == port
    assert port[6] == [True, False, True, True, True]


def test_cold_stampede_is_one_decode(pkgs):
    """Six concurrent readers of one cold, degraded stripe share one
    decode through the coalescer's single-flight tier on both sides: the
    same calls, routes and coalesced gets (the port's coalescer counts
    its shared flights on itself, not in the registry)."""
    import time

    from noise_ec_tpu_torch.ops.coalesce import coalescer

    got = []
    shared0 = coalescer().flush_reasons["shared"]
    for pkg in pkgs:
        cache = pkg.service.DecodedObjectCache(max_bytes=32 << 20)
        objects = pkg.node(pkg.transport.LoopbackHub(), 4200, cache=cache)
        payload = _payload(21, 6_000)
        doc = objects.put("acme", "hot.bin", payload)
        objects.store.drop_shard(doc["stripes"][0], 0)
        cache.clear()
        calls = []
        real_read = objects.store.read

        def slow_read(key, _real=real_read, _calls=calls):
            _calls.append(key)
            time.sleep(0.5)  # long enough for every reader to join
            return _real(key)

        objects.store.read = slow_read
        outs = [None] * 6
        barrier = threading.Barrier(6)

        def reader(i, _objects=objects, _outs=outs):
            barrier.wait()
            _outs[i] = _objects.read("acme", "hot.bin")

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        got.append((all(o == payload for o in outs), len(calls),
                     pkg.counter("noise_ec_object_read_route_total",
                                 route="decode"),
                     pkg.counter("noise_ec_object_gets_total",
                                 result="coalesced") > 0))
    assert got[0] == got[1] and got[1] == (True, 1, 1.0, True)
    assert coalescer().flush_reasons["shared"] > shared0


def test_hbm_watermark_never_sheds_without_a_card():
    from noise_ec_tpu_torch.obs.device import hbm_snapshot

    import torch

    if torch.cuda.is_available():  # pragma: no cover - a card's host
        pytest.skip("a CUDA device is present")
    assert hbm_snapshot() == {}
    objects = Pkg(*PORT).node(port_transport.LoopbackHub(), 4300)
    assert objects.shed_reason() is None


# ---------------------------------------------- placement and mixed nets


class DirectedLoopback:
    """A loopback node with the directed surfaces targeted delivery and
    the gather read use: ``placement_directory`` (topology token ->
    node), ``send_many_to`` (one node's cohort) and ``placement_fetch``
    (a snapshot of the owner's store, as an owner's fetch answer)."""

    @staticmethod
    def wrap(net, nodes: dict, stores: dict):
        def directory():
            return {tok: tok for tok in nodes if tok != net.id.address}

        def send_many_to(tok, msgs):
            other = nodes.get(tok)
            if other is None:
                return False
            for m in msgs:
                other.deliver(m.marshal(), net.id)
            return True

        def fetch(tok, key):
            _, shards, _ = stores[tok].snapshot(key)
            return {i: b for i, b in enumerate(shards) if b is not None}

        net.placement_directory = directory
        net.send_many_to = send_many_to
        net.placement_fetch = fetch
        return net


def _placement_script(pkg) -> list:
    hub = pkg.transport.LoopbackHub()
    tokens = [pkg.transport.format_address("tcp", "localhost", 4400 + i)
              for i in range(6)]
    spec = ";".join(f"domain=d{i}:{tok}" for i, tok in enumerate(tokens))
    ring = pkg.placement.PlacementRing(
        pkg.placement.Topology.parse(spec), seed=0)
    nodes, stores, services = {}, {}, []
    for i in range(6):
        objects = pkg.node(hub, 4400 + i, seed=10 + i, engine=False)
        tok = objects.network.id.address
        nodes[tok], stores[tok] = objects.network, objects.store
        objects.plugin.placement = pkg.placement.TargetedDelivery(
            ring, self_token=tok)
        services.append(objects)
    for objects in services:
        DirectedLoopback.wrap(objects.network, nodes, stores)
    saved = pkg.registry.default_registry().counter(
        "noise_ec_placement_fanout_saved_total").labels()
    payload = _payload(44, 100_000)
    doc = services[0].put("acme", "placed.bin", payload)
    # Each node's slots of the object's stripes (the manifest's own
    # stripe carries its clock fields, so its key differs run to run).
    holdings = {tok: [(k, [i for i, b in enumerate(store.snapshot(k)[1])
                           if b is not None])
                      for k in doc["stripes"] if k in store.keys()]
                for tok, store in stores.items()}
    got = services[3].read("acme", "placed.bin")
    return [_doc(doc), holdings, saved.value, got == payload,
            pkg.counter("noise_ec_object_read_route_total", route="gather")]


def test_targeted_put_and_gather_get_match(pkgs):
    """RS(4,2) over six nodes in six failure domains: the origin sends
    each shard once, to its ring owner; the same holdings and saved
    fan-out on both sides; node 3 GETs the object through the gather
    tier, byte-identical."""
    ref, port = (_placement_script(pkg) for pkg in pkgs)
    assert ref == port
    assert port[3] and port[4] > 0 and port[2] > 0


def test_port_and_reference_nodes_share_objects_on_one_hub():
    """One hub, a port node and a reference node: an object PUT on
    either is served byte-identically by the other."""
    hub = port_transport.LoopbackHub()
    port_node = Pkg(*PORT)
    ref_node = Pkg(*REF)
    try:
        a = port_node.node(hub, 4500, seed=1)
        b = ref_node.node(hub, 4501, seed=2)
        one, two = _payload(50, 70_000), _payload(51, 30_001)
        a.put("acme", "from-port.bin", one)
        b.put("acme", "from-ref.bin", two)
        assert b.read("acme", "from-port.bin") == one
        assert a.read("acme", "from-ref.bin") == two
        assert _doc(a.resolve("acme", "from-ref.bin")) == \
            _doc(b.resolve("acme", "from-ref.bin"))
        assert not a.network.errors and not b.network.errors
    finally:
        port_node.close()
        ref_node.close()
