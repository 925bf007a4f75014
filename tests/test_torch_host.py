"""The port's node layers against the reference's: the wire format
(``host/wire.py``: the port's ``marshal_shard`` bytes equal the
reference's for random shards, each package unmarshals the other's bytes,
and the ``tests/test_wire_interop.py`` cases against ``google.protobuf``),
identity and signing (the same public key, signing preimage, hash and
signature bytes for the same key seed), the mempool's limits, and a KCP
and a TCP two-node exchange on the port's transport. Tolerance:
byte-identical throughout."""

import time

import numpy as np
import pytest

from noise_ec_tpu.host import crypto as ref_crypto
from noise_ec_tpu.host import wire as ref_wire
from noise_ec_tpu_torch.codec.fec import Share
from noise_ec_tpu_torch.host import crypto, wire
from noise_ec_tpu_torch.host.mempool import PoolLimitError, ShardPool
from noise_ec_tpu_torch.host.plugin import ShardPlugin
from noise_ec_tpu_torch.host.transport import TCPNetwork
from noise_ec_tpu_torch.host.wire import Shard, WireError

SEED = bytes(range(32))


# ------------------------------------------------------------------- wire


@pytest.mark.parametrize("seed", range(4))
def test_marshal_bytes_equal_reference_both_ways(seed):
    """Random shards (stream extension fields included) marshal to the
    reference's bytes, and each package unmarshals the other's."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        ref = ref_wire.Shard.populate(rng)
        if rng.integers(0, 2):
            ref.stream_chunk_index = int(rng.integers(0, 1 << 20))
            ref.stream_chunk_count = int(rng.integers(1, 1 << 20))
            ref.stream_object_bytes = int(rng.integers(1, 1 << 40))
        ours = Shard(
            file_signature=ref.file_signature, shard_data=ref.shard_data,
            shard_number=ref.shard_number, total_shards=ref.total_shards,
            minimum_needed_shards=ref.minimum_needed_shards,
            stream_chunk_index=ref.stream_chunk_index,
            stream_chunk_count=ref.stream_chunk_count,
            stream_object_bytes=ref.stream_object_bytes,
        )
        buf = wire.marshal_shard(ours)
        assert buf == ref_wire.marshal_shard(ref) == ref.marshal()
        assert len(buf) == ours.size()
        back = ref_wire.unmarshal_shard(buf)
        assert back.marshal() == buf
        assert wire.unmarshal_shard(ref.marshal()).marshal() == buf


def test_unmarshal_rejects_what_the_reference_rejects():
    """Truncated input and a known field with the wrong wire type fail in
    both packages."""
    good = Shard(file_signature=b"s", shard_data=b"data", shard_number=1,
                 total_shards=6, minimum_needed_shards=4).marshal()
    for bad in (good[:-1], bytes([1 << 3 | 0]) + b"\x05" + good):
        with pytest.raises(WireError):
            Shard.unmarshal(bad)
        with pytest.raises(ref_wire.WireError):
            ref_wire.Shard.unmarshal(bad)


@pytest.fixture(scope="module")
def ShardMsg():
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "shard_torch_interop.proto"
    fdp.package = "erasurecode"
    fdp.syntax = "proto3"
    m = fdp.message_type.add()
    m.name = "Shard"
    T = descriptor_pb2.FieldDescriptorProto
    for num, (name, typ) in enumerate([
        ("file_signature", T.TYPE_BYTES),
        ("shard_data", T.TYPE_BYTES),
        ("shard_number", T.TYPE_UINT64),
        ("total_shards", T.TYPE_UINT64),
        ("minimum_needed_shards", T.TYPE_UINT64),
    ], 1):
        f = m.field.add()
        f.name, f.number, f.type, f.label = name, num, typ, T.LABEL_OPTIONAL
    pool = descriptor_pool.DescriptorPool()
    pool.Add(fdp)
    return message_factory.GetMessageClass(
        pool.FindMessageTypeByName("erasurecode.Shard"))


def test_protobuf_interop_both_ways(ShardMsg):
    """The test_wire_interop.py cases on the port's codec: ours parses in
    protobuf, protobuf's parses in ours, and the bytes are identical,
    the all-defaults message included."""
    rng = np.random.default_rng(0x3141)
    for _ in range(50):
        s = Shard.populate(rng)
        parsed = ShardMsg.FromString(s.marshal())
        assert (parsed.file_signature, parsed.shard_data, parsed.shard_number,
                parsed.total_shards, parsed.minimum_needed_shards) == (
            s.file_signature, s.shard_data, s.shard_number, s.total_shards,
            s.minimum_needed_shards)
        ref = ShardMsg(
            file_signature=s.file_signature, shard_data=s.shard_data,
            shard_number=s.shard_number, total_shards=s.total_shards,
            minimum_needed_shards=s.minimum_needed_shards,
        )
        assert s.marshal() == ref.SerializeToString()
        back = Shard.unmarshal(ref.SerializeToString())
        assert back.marshal() == s.marshal()
    assert Shard().marshal() == ShardMsg().SerializeToString() == b""


def test_protobuf_unknown_fields_skipped(ShardMsg):
    s = Shard(file_signature=b"sig", shard_data=b"data", shard_number=3,
              total_shards=6, minimum_needed_shards=4)
    buf = s.marshal() + bytes([9 << 3 | 0]) + b"\x2a"  # field 9, varint 42
    ours = Shard.unmarshal(buf)
    theirs = ShardMsg.FromString(buf)
    assert ours.shard_data == theirs.shard_data == b"data"
    assert ours.total_shards == theirs.total_shards == 6


# ------------------------------------------------------------ crypto


@pytest.mark.parametrize("size", [0, 17, 4096, 1 << 18, (1 << 18) + 3])
def test_signature_and_hash_bytes_equal_reference(size):
    """Same key seed and message: the same public key, node id, signing
    preimage, BLAKE2b-256 (on hashlib below 256 KiB, on the shim above)
    and Ed25519 signature; each package verifies the other's."""
    rng = np.random.default_rng(size)
    msg = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    kp = crypto.KeyPair.from_seed(SEED)
    rkp = ref_crypto.KeyPair.from_seed(SEED)
    assert kp.public_key == rkp.public_key
    pid = crypto.PeerID.create("tcp://127.0.0.1:3000", kp.public_key)
    rpid = ref_crypto.PeerID.create("tcp://127.0.0.1:3000", rkp.public_key)
    assert (pid.address, pid.node_id) == (rpid.address, rpid.node_id)
    pre = crypto.serialize_message(pid, msg)
    assert pre == ref_crypto.serialize_message(rpid, msg)
    assert b"".join(crypto.serialize_message_parts(pid, msg)) == pre
    h = crypto.Blake2bPolicy()
    rh = ref_crypto.Blake2bPolicy()
    assert h.hash_bytes(pre) == rh.hash_bytes(pre)
    assert h.hash_parts([pre[:5], pre[5:]]) == h.hash_bytes(pre)
    sig = kp.sign(crypto.Ed25519Policy(), h, pre)
    rsig = rkp.sign(ref_crypto.Ed25519Policy(), rh, pre)
    assert sig == rsig
    assert crypto.verify(crypto.Ed25519Policy(), h, rkp.public_key, pre, rsig)
    assert ref_crypto.verify(ref_crypto.Ed25519Policy(), rh, kp.public_key,
                             pre, sig)
    assert not crypto.verify(crypto.Ed25519Policy(), h, kp.public_key,
                             pre + b"x", sig)


def test_ed25519_backend_is_named():
    assert crypto.ED25519_BACKEND in ("cryptography", "pure-python")


# ----------------------------------------------------------- mempool


def test_mempool_resource_limits():
    pool = ShardPool(max_pools=2, max_total_bytes=100)
    pool.add("a", Share(0, b"x" * 40), 4, 6)
    pool.add("b", Share(0, b"x" * 40), 4, 6)
    with pytest.raises(PoolLimitError):
        pool.add("c", Share(0, b"x" * 40), 4, 6)  # pool-count cap
    with pytest.raises(PoolLimitError):
        pool.add("a", Share(1, b"x" * 40), 4, 6)  # byte cap (80+40 > 100)
    assert pool.pinned_bytes == 80
    pool.evict("a")
    assert pool.pinned_bytes == 40
    pool.add("c", Share(0, b"x" * 40), 4, 6)


def test_mempool_dedups_and_pins_geometry():
    pool = ShardPool()
    assert pool.add("k", Share(1, b"ab"), 2, 3)[2]
    assert not pool.add("k", Share(1, b"ab"), 2, 3)[2]  # duplicate
    pool.add("k", Share(0, b"cd"), 2, 3)
    shares, distinct = pool.snapshot("k")
    assert [s.number for s in shares] == [0, 1] and distinct == 2
    with pytest.raises(ValueError):
        pool.add("k", Share(2, b"ef"), 3, 4)


# ------------------------------------------------- two nodes, TCP and KCP


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("protocol", ["tcp", "kcp"])
def test_two_node_exchange(protocol):
    """Two port nodes on the port's transport: bootstrap, a line each way
    and a multi-chunk stream, one node on the device backend (CPU plain
    versions) and one on numpy."""
    inbox_a, inbox_b = [], []
    a = TCPNetwork(host="127.0.0.1", port=0, protocol=protocol)
    a.add_plugin(ShardPlugin(backend="device", device="cpu",
                             on_message=lambda m, s: inbox_a.append(m)))
    a.listen()
    b = TCPNetwork(host="127.0.0.1", port=0, protocol=protocol)
    b.add_plugin(ShardPlugin(backend="numpy",
                             on_message=lambda m, s: inbox_b.append(m)))
    b.listen()
    try:
        assert a.id.address.startswith(f"{protocol}://")
        b.bootstrap([a.id.address])
        assert _wait(lambda: b.peers and a.peers), (a.errors, b.errors)
        b.plugins[0].shard_and_broadcast(b, b"port end to end!")
        assert _wait(lambda: inbox_a), (a.errors, b.errors)
        a.plugins[0].shard_and_broadcast(a, b"reply direction!")
        assert _wait(lambda: inbox_b), (a.errors, b.errors)
        obj = np.random.default_rng(5).integers(
            0, 256, 3 * 4096 + 100, dtype=np.uint8).tobytes()
        assert a.plugins[0].stream_and_broadcast(a, obj, chunk_bytes=4096) == 4
        assert _wait(lambda: len(inbox_b) == 2), (a.errors, b.errors)
        assert inbox_a == [b"port end to end!"]
        assert inbox_b == [b"reply direction!", obj]
    finally:
        a.close()
        b.close()
