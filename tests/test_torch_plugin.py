"""The port's ``ShardPlugin`` on ``LoopbackNetwork`` clusters, on the
device backend (``device="cpu"``: the kernels' plain versions) with the
decode's products on the host (``bw_route="host"``, the shim) and on the
codec (``bw_route="device"``), and on the numpy backend: messages delivered
byte-equal, ``prepare_shards`` byte-identical to the reference plugin's for
the same key seed and message (RS(4,2) by default and RS(10,14)), a
multi-chunk object through ``stream_and_broadcast`` with shards dropped and
one corrupted by a ``FaultInjector`` and repaired, the novel-geometry caps
(counted, decided before any product, never taken by an admitted geometry),
and ``prewarm(ladder=4)`` leaving the plans cached. Tolerance:
byte-identical throughout."""

import functools

import numpy as np
import pytest

from noise_ec_tpu.host.crypto import KeyPair as RefKeyPair
from noise_ec_tpu.host.crypto import PeerID as RefPeerID
from noise_ec_tpu.host.plugin import ShardPlugin as RefShardPlugin
from noise_ec_tpu_torch.codec.fec import FEC
from noise_ec_tpu_torch.host import plugin as plugin_mod
from noise_ec_tpu_torch.host.crypto import KeyPair, PeerID, serialize_message
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import (
    FaultInjector,
    LoopbackHub,
    LoopbackNetwork,
    format_address,
)
from noise_ec_tpu_torch.host.wire import Shard
from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix

SEED = bytes(range(32))

# (backend, bw_route) of every cluster test.
CONFIGS = [("device", "host"), ("device", "device"), ("numpy", "host")]


@pytest.fixture
def routed(monkeypatch):
    """Make every FEC the plugin builds take ``bw_route``."""
    def use(bw_route):
        if bw_route != "host":
            monkeypatch.setattr(plugin_mod, "FEC",
                                functools.partial(FEC, bw_route=bw_route))
    return use


def make_cluster(n_nodes, backend, faults=None, **plugin_kwargs):
    hub = LoopbackHub(fault_injector=faults)
    nodes, inboxes = [], []
    for i in range(n_nodes):
        node = LoopbackNetwork(hub, format_address("tcp", "localhost", 5000 + i))
        inbox = []
        node.add_plugin(ShardPlugin(
            backend=backend, device="cpu",
            on_message=lambda m, s, inbox=inbox: inbox.append((m, s.address)),
            **plugin_kwargs,
        ))
        nodes.append(node)
        inboxes.append(inbox)
    return hub, nodes, inboxes


@pytest.mark.parametrize("backend,bw_route", CONFIGS)
def test_cluster_messages_delivered_byte_equal(backend, bw_route, routed):
    routed(bw_route)
    _, nodes, inboxes = make_cluster(3, backend)
    rng = np.random.default_rng(1)
    sent = []
    for i, size in enumerate((12, 16, 4000, 4003)):  # 4003 = 4003: prime
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        if size == 4003:
            payload = b"x" * 4002 + b"y"
            with pytest.raises(ValueError):  # k -> 4003 > the field order
                nodes[0].plugins[0].shard_and_broadcast(nodes[0], payload)
            continue
        nodes[i % 3].plugins[0].shard_and_broadcast(nodes[i % 3], payload)
        sent.append((i % 3, payload))
    for j, inbox in enumerate(inboxes):
        want = [p for src, p in sent if src != j]
        assert [m for m, _ in inbox] == want


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("geometry,size", [(None, 4000), (None, 12),
                                           ((10, 14), 10 * 777)])
def test_prepare_shards_byte_identical_to_reference(backend, geometry, size):
    """Same key seed and message: the port's shards marshal to the
    reference's bytes (signatures included), at the default RS(4,2) and
    at RS(10,14)."""
    msg = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    kp = KeyPair.from_seed(SEED)
    rkp = RefKeyPair.from_seed(SEED)
    addr = "tcp://127.0.0.1:3000"
    ours = ShardPlugin(backend=backend, device="cpu").prepare_shards(
        PeerID.create(addr, kp.public_key), kp, msg, geometry=geometry)
    ref = RefShardPlugin(backend="numpy").prepare_shards(
        RefPeerID.create(addr, rkp.public_key), rkp, msg, geometry=geometry)
    assert [s.marshal() for s in ours] == [s.marshal() for s in ref]
    assert len(ours) == (geometry or (4, 6))[1]


def test_adjusted_geometry_matches_reference():
    """A length not divisible by k: both plugins revise to the same
    (k, n) and emit the same bytes (main.go:185-191)."""
    kp = KeyPair.from_seed(SEED)
    rkp = RefKeyPair.from_seed(SEED)
    addr = "tcp://127.0.0.1:3000"
    ours = ShardPlugin(backend="numpy")
    ref = RefShardPlugin(backend="numpy")
    for msg in (b"abcdefghijklmnopqrstu", b"0123456789abcdef", b"x" * 35):
        a = ours.prepare_shards(PeerID.create(addr, kp.public_key), kp, msg)
        b = ref.prepare_shards(RefPeerID.create(addr, rkp.public_key), rkp, msg)
        assert [s.marshal() for s in a] == [s.marshal() for s in b]
    assert (ours.minimum_needed_shards, ours.total_shards) == (
        ref.minimum_needed_shards, ref.total_shards)


class _DropAndCorruptOne(FaultInjector):
    """Drops every 17th delivery (at most one of a chunk's 8 shards) and
    flips one byte in the middle of delivery ``corrupt_at`` (inside its
    shard data)."""

    def __init__(self, corrupt_at: int):
        super().__init__(seed=0)
        self.n = 0
        self.corrupt_at = corrupt_at

    def apply(self, deliveries, link=""):
        out = []
        for buf in deliveries:
            i, self.n = self.n, self.n + 1
            if i % 17 == 5:
                self.stats["dropped"] += 1
                continue
            if i == self.corrupt_at:
                b = bytearray(buf)
                b[len(b) // 2] ^= 0x5A
                buf = bytes(b)
                self.stats["corrupted"] += 1
            out.append(buf)
            self.stats["delivered"] += 1
        return out


@pytest.mark.parametrize("backend,bw_route", CONFIGS)
def test_stream_repairs_drops_and_one_corrupt_share(backend, bw_route, routed):
    """A multi-chunk object at RS(4,8): one shard dropped from each of
    several chunks and one corrupted; the object is repaired and
    delivered once, byte-equal."""
    routed(bw_route)
    faults = _DropAndCorruptOne(corrupt_at=2)
    _, nodes, inboxes = make_cluster(
        2, backend, faults=faults, minimum_needed_shards=4, total_shards=8)
    data = np.random.default_rng(3).integers(
        0, 256, 5 * (1 << 16) + 1234, dtype=np.uint8).tobytes()
    sent = nodes[0].plugins[0].stream_and_broadcast(
        nodes[0], data, chunk_bytes=1 << 16)
    assert sent == 6
    assert [m for m, _ in inboxes[1]] == [data]
    assert faults.stats["dropped"] >= 2 and faults.stats["corrupted"] == 1
    assert nodes[1].plugins[0].counters.get("verified") == 1


# ------------------------------------------------- novel-geometry caps


class _Ctx:
    def __init__(self, msg, sender):
        self._msg, self._sender = msg, sender

    def message(self):
        return self._msg

    def sender(self):
        return self._sender

    def client_public_key(self):
        return self._sender.public_key


def _send_object(plugin, keys, sender, k, n, payload):
    sig = keys.sign(plugin.signature_policy, plugin.hash_policy,
                    serialize_message(sender, payload))
    for s in FEC(k, n, backend="numpy").encode_shares(payload)[: k + 1]:
        plugin.receive(_Ctx(Shard(
            file_signature=sig, shard_data=s.data, shard_number=s.number,
            total_shards=n, minimum_needed_shards=k,
        ), sender))


def test_geometry_caps_counted_and_never_taken_by_admitted(monkeypatch):
    """A sender minting a fresh (k, n) per object: past the per-window
    budget its decodes go to a host-only numpy codec, chosen before any
    product runs and counted in geometry_rate_limited; every object still
    delivers, and an admitted geometry never takes the host codec, also
    after the flood."""
    plugin = ShardPlugin(backend="device", device="cpu")
    keys = KeyPair.from_seed(SEED)
    sender = PeerID.create("tcp://localhost:9999", keys.public_key)
    delivered = []
    plugin.on_message = lambda m, s: delivered.append(m)
    built = []
    real_fec = plugin_mod.FEC

    def spy(k, n, **kw):
        built.append(((k, n), kw.get("backend")))
        return real_fec(k, n, **kw)

    monkeypatch.setattr(plugin_mod, "FEC", spy)
    budget = plugin.NOVEL_GEOMETRY_PER_WINDOW
    flood = budget + 4
    for i in range(flood):
        _send_object(plugin, keys, sender, 2, 3 + i, bytes([i]) * 16)
    assert delivered == [bytes([i]) * 16 for i in range(flood)]
    limited = plugin.counters.get("geometry_rate_limited")
    assert limited == flood - budget
    admitted = set(plugin._fec_cache)
    host = set(plugin._fec_host_cache)
    assert len(admitted) == budget and len(host) == limited
    assert not admitted & host
    # Each geometry got exactly one codec, on the backend decided for it
    # before its decode: the device codec for admitted ones, numpy past
    # the cap (no device codec was ever built for those).
    assert {g for g, b in built if b == "device"} == admitted
    assert {g for g, b in built if b == "numpy"} == host
    # An admitted geometry recurring after the flood: served from the
    # device cache, not counted, no new codec.
    n_built = len(built)
    (k, n) = sorted(admitted)[0]
    _send_object(plugin, keys, sender, k, n, b"again!" * 4)
    assert delivered[-1] == b"again!" * 4
    assert plugin.counters.get("geometry_rate_limited") == limited
    assert len(built) == n_built


def test_prewarm_ladder_leaves_plans_cached():
    """prewarm(ladder=4) plans the parity matrix and each single lost data
    share's recovery matrix, and runs the batch ladder (1, 2, 4): the first
    live calls on those matrices find their plans cached."""
    from noise_ec_tpu_torch.obs.profiling import kernel_counters

    plugin = ShardPlugin(backend="device", device="cpu")
    before = kernel_counters.get("matmul_stripes_calls")
    plugin.prewarm(ladder=4)
    fec = plugin._fec_cache[(4, 6)]
    dev, G = fec._rs._dev, fec._rs.G
    assert dev._route(G[4:], None) == "execute"
    for j in range(4):
        basis = [i for i in range(5) if i != j]
        R = reconstruction_matrix(dev.gf, G, basis, [j])
        assert dev._route(R, None) == "execute"
    # Three ladder rungs ran (on top of prewarm's encode).
    assert kernel_counters.get("matmul_stripes_calls") - before >= 3
    # And the live path: a reconstruct of a lost data share plans nothing.
    shares = fec.encode_shares(bytes(range(64)))
    n_plans = len(dev._plan_cache)
    fec.rebuild([s for s in shares if s.number != 1])
    assert len(dev._plan_cache) == n_plans
