"""The port's streaming slice on the CPU against the JAX package:
``StreamingEncoder``, ``StreamingDecoder``, ``decode_stream`` and the
single-device ``BatchCodec`` (the reference's "auto" kernel resolves to
its XLA fold here), byte for byte and in order."""

import numpy as np
import pytest
import torch

from noise_ec_tpu.parallel.batch import BatchCodec as RefBatchCodec
from noise_ec_tpu.parallel.streaming import (
    StreamingDecoder as RefDecoder,
    StreamingEncoder as RefEncoder,
    decode_stream as ref_decode_stream,
)
from noise_ec_tpu_torch.matrix import host_matvec
from noise_ec_tpu_torch.ops import launch_counts, reset_launch_counts
from noise_ec_tpu_torch.parallel import (
    BatchCodec,
    StreamChunk,
    StreamingDecoder,
    StreamingEncoder,
    decode_stream,
)
from noise_ec_tpu_torch.parallel.batch import mesh_router
from noise_ec_tpu_torch.parallel.mesh import MeshRouter, make_mesh

# One erasure pattern per geometry, so each recovery matrix is planned
# once for the module (RS(50,20)'s at the code's limit: 10 data and 10
# parity shards).
LOST = {
    (10, 4): [0, 5, 11, 13],
    (17, 3): [1, 16, 18],
    (50, 20): list(range(0, 20, 2)) + list(range(50, 70, 2)),
    (4, 2): [1, 4],
}


def _present(k, r):
    return [i for i in range(k + r) if i not in LOST[(k, r)]]


def _stream(rng, enc, n_full):
    """n_full whole chunks and a short tail chunk."""
    size = enc.chunk_bytes * n_full + enc.chunk_bytes // 3 + 7
    return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,r,field,depths", [
    (10, 4, "gf256", (1, 2, 3, 4)),
    (17, 3, "gf256", (1, 4)),
    (50, 20, "gf256", (2,)),
    (4, 2, "gf65536", (1, 3)),
])
def test_stream_matches_reference(rng, k, r, field, depths):
    """Parity, rebuilt rows and the reassembled stream equal the
    reference's, chunk for chunk and in order, at each window depth; the
    CPU run launches no kernel."""
    chunk = 4 * k * 80  # whole int32 words a stripe on both sides
    enc = StreamingEncoder(k, r, chunk_bytes=chunk, field=field,
                           device="cpu")
    ref = RefEncoder(k, r, chunk_bytes=chunk, field=field)
    assert (enc.chunk_bytes, enc._padded_bytes) == (chunk, chunk)
    data = _stream(rng, enc, 3)
    want = list(ref.encode_bytes(data))
    present = _present(k, r)
    degraded = [(c.index, np.asarray(c.shards)[present]) for c in want]
    want_rows = list(RefDecoder(k, r, field=field).reconstruct_stream(
        iter(degraded), present, depth=2))
    reset_launch_counts()
    for depth in depths:
        got = list(enc.encode_bytes(data, depth=depth))
        assert [c.index for c in got] == list(range(4))
        for a, b in zip(got, want):
            assert a.data_len == b.data_len
            np.testing.assert_array_equal(a.parity,
                                          np.asarray(b.parity).view(np.uint8))
            np.testing.assert_array_equal(a.shards, np.asarray(b.shards))
        assert decode_stream(iter(got), k, total_len=len(data)) == data
        rows = list(StreamingDecoder(k, r, field=field, device="cpu")
                    .reconstruct_stream(iter(degraded), present, depth=depth))
        assert [i for i, _ in rows] == [i for i, _ in want_rows]
        for (_, a), (_, b), c in zip(rows, want_rows, got):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c.shards)
        rebuilt = [StreamChunk(index=i, shards=a, data_len=c.data_len)
                   for (i, a), c in zip(rows, got)]
        assert decode_stream(iter(rebuilt), k, len(data)) == \
            ref_decode_stream(iter(rebuilt), k, len(data)) == data
    assert all(n == 0 for n in launch_counts().values())


def test_chunks_pad_to_whole_words_like_the_reference_words_path(rng):
    """A chunk of whole symbols but not whole words a stripe is zero-padded
    to words, as on the reference's words path (interpreted Pallas), and
    caller-cut chunks of that size are accepted."""
    k, r = 10, 4
    enc = StreamingEncoder(k, r, chunk_bytes=90, device="cpu")
    ref = RefEncoder(k, r, chunk_bytes=90, kernel="pallas_interpret")
    assert (enc.chunk_bytes, enc._padded_bytes) == (90, 120)
    assert (ref.chunk_bytes, ref._padded_bytes) == (90, 120)
    data = rng.integers(0, 256, size=90 * 2 + 17, dtype=np.uint8).tobytes()
    cut = [data[off: off + 90] for off in range(0, len(data), 90)]
    got = list(enc.encode_stream(iter(cut)))
    want = list(ref.encode_stream(iter(cut)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.shards, np.asarray(b.shards))
    assert decode_stream(got, k, total_len=len(data)) == data
    with pytest.raises(ValueError, match="chunk_bytes"):
        list(enc.encode_stream(iter([bytes(91)])))
    assert list(enc.encode_bytes(b"")) == []
    # 91 bytes round down to whole stripes: the reference's contract.
    assert StreamingEncoder(k, r, chunk_bytes=91, device="cpu").chunk_bytes == 90


def test_stream_chunk_split_rows_are_zero_copy():
    data = np.arange(40, dtype=np.uint8).reshape(4, 10)
    parity = np.arange(20, dtype=np.uint8).reshape(2, 10)
    c = StreamChunk(index=0, data_len=40, data=data, parity=parity)
    rows = c.rows()
    assert np.shares_memory(rows[0], data)  # no (n, stride) assembly
    assert np.shares_memory(rows[4], parity)
    np.testing.assert_array_equal(
        c.shards, np.concatenate([data, parity], axis=0)
    )
    with pytest.raises(ValueError):
        StreamChunk(index=1, data_len=1)


def test_yielded_rows_own_their_memory(rng):
    """Full chunks' data rows are views of the caller's bytes; the short
    tail's and every parity block are buffers of their own, so no later
    chunk overwrites what an earlier one yielded."""
    k, r = 10, 4
    enc = StreamingEncoder(k, r, chunk_bytes=4 * k * 64, device="cpu")
    data = _stream(rng, enc, 3)
    chunks = list(enc.encode_bytes(data, depth=1))
    frozen = [c.parity.copy() for c in chunks]
    buf = np.frombuffer(data, dtype=np.uint8)
    assert np.shares_memory(chunks[0].data, buf)
    assert not np.shares_memory(chunks[-1].data, buf)
    for a, b in zip(chunks, chunks[1:]):
        assert not np.shares_memory(a.parity, b.parity)
    for c, p in zip(chunks, frozen):
        np.testing.assert_array_equal(c.parity, p)
        np.testing.assert_array_equal(
            c.parity, host_matvec(enc.codec.gf, enc.codec.parity_matrix,
                                  c.data))


@pytest.mark.parametrize("k,r,field", [
    (10, 4, "gf256"), (17, 3, "gf256"), (50, 20, "gf256"),
    (4, 2, "gf65536"),
])
def test_batch_codec_generator_matches_reference(k, r, field):
    np.testing.assert_array_equal(
        BatchCodec(k, r, field=field, device="cpu").G,
        RefBatchCodec(k, r, field=field).G)


def test_batch_reconstruct_at_the_rs_50_20_limit_matches_reference(rng):
    """``reconstruct_batch`` and ``reconstruct_batch_words`` at 20
    erasures of RS(50,20) (K5's recovery matrix) equal the reference's."""
    import jax.numpy as jnp

    k, r, B, S = 50, 20, 2, 1024
    bc = BatchCodec(k, r, device="cpu")
    ref = RefBatchCodec(k, r)
    data = rng.integers(0, 256, size=(B, k, S), dtype=np.uint8)
    full = bc.encode_batch(data)
    np.testing.assert_array_equal(full,
                                  np.asarray(ref.encode_batch(jnp.asarray(data))))
    present = _present(k, r)
    got = bc.reconstruct_batch(full[:, present], present)
    want = np.asarray(ref.reconstruct_batch(jnp.asarray(full[:, present]),
                                            present))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)
    words = full.view(np.uint32)
    gotw = bc.reconstruct_batch_words(
        torch.from_numpy(words[:, present].view(np.int32)), present)
    wantw = np.asarray(ref.reconstruct_batch_words(
        jnp.asarray(words[:, present]), present))
    np.testing.assert_array_equal(gotw.numpy().view(np.uint32), wantw)
    np.testing.assert_array_equal(
        bc.encode_batch_words(torch.from_numpy(words[:, :k].view(np.int32)))
        .numpy().view(np.uint32), words)
    assert bc.device_codec().plan_for(
        bc.G[k:])[0] == "split"
    with pytest.raises(ValueError, match="present"):
        bc.reconstruct_batch(full[:, :k - 1], list(range(k - 1)))


def test_mesh_entries_build_and_run():
    """Every mesh entry builds and runs on a ``[cpu] * 2`` batch axis,
    equal to the single-device batch codec; the process router is there,
    disabled on the CPU."""
    bc = BatchCodec(4, 2, device="cpu")
    mesh = make_mesh(("batch",), devices=[torch.device("cpu")] * 2)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(2, 4, 64)).astype(np.uint8)
    full = bc.encode_batch(data)
    words = torch.from_numpy(data.view(np.int32))
    for fn, x, want in (
            (bc.make_sharded_matmul(mesh, bc.parity_matrix), data,
             full[:, 4:]),
            (bc.make_sharded_encoder(mesh), data, full[:, 4:]),
            (bc.make_sharded_decode1(mesh, 0), full, np.concatenate(
                [data[:, :1], np.zeros((2, 1, 64), np.uint8)], axis=1)),
            (bc.make_sharded_matmul_words(mesh, bc.parity_matrix), words,
             full[:, 4:]),
            (bc.make_sharded_encoder_words(mesh), words, full[:, 4:])):
        got = fn(x)
        if isinstance(got, torch.Tensor):
            got = got.numpy().view(np.uint8)
        np.testing.assert_array_equal(got, want)
    router = mesh_router()
    assert isinstance(router, MeshRouter) and not router.enabled


def test_streaming_defaults_to_the_card(monkeypatch):
    """With no device argument the stream runs on the card, and without
    one it raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = StreamingEncoder(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        list(enc.encode_bytes(bytes(64)))
    with pytest.raises(RuntimeError, match="CUDA"):
        list(StreamingDecoder(4, 2).reconstruct_stream(
            iter([(0, np.zeros((4, 16), np.uint8))]), [0, 1, 2, 3]))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py drives the streams "
                    "on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", [(17, 3), (50, 20)])
def test_stream_on_cuda_matches_cpu(rng, k, r):
    _require_cuda()
    enc = StreamingEncoder(k, r, chunk_bytes=4 * k * 4096)
    data = _stream(rng, enc, 3)
    reset_launch_counts()
    got = list(enc.encode_bytes(data, depth=2))
    assert launch_counts()["fused_split"] > 0
    cpu = StreamingEncoder(k, r, chunk_bytes=4 * k * 4096, device="cpu")
    for a, b in zip(got, cpu.encode_bytes(data)):
        np.testing.assert_array_equal(a.shards, b.shards)
    present = _present(k, r)
    rows = StreamingDecoder(k, r).reconstruct_stream(
        ((c.index, c.shards[present]) for c in got), present)
    for (_, a), c in zip(rows, got):
        np.testing.assert_array_equal(a, c.shards)


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_r0_stream_gives_data_only_chunks_like_the_reference(field):
    """r = 0: five data-only (4, 256) chunks, equal to the reference's on
    its XLA path (``kernel="auto"`` on a CPU), and the stream joins back."""
    data = bytes(range(256)) * 20
    enc = StreamingEncoder(4, 0, chunk_bytes=1024, field=field, device="cpu")
    got = list(enc.encode_bytes(data))
    want = list(RefEncoder(4, 0, chunk_bytes=1024,
                           field=field).encode_bytes(data))
    assert [c.shards.shape for c in got] == [(4, 256)] * 5
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.index, a.data_len) == (b.index, b.data_len)
        np.testing.assert_array_equal(a.shards, np.asarray(b.shards))
    assert decode_stream(got, 4) == data


@pytest.mark.parametrize("field", ["gf256", "gf65536"])
def test_r0_batch_encode_returns_the_data(rng, field):
    dt = np.uint8 if field == "gf256" else np.uint16
    D = rng.integers(0, 256, (3, 4, 64)).astype(dt)
    got = BatchCodec(4, 0, field=field, device="cpu").encode_batch(D)
    want = np.asarray(RefBatchCodec(4, 0, field=field).encode_batch(D))
    assert got.shape == (3, 4, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, D)
