"""The words rebuild written once (``parallel/batch.py``
``BatchCodec.reconstruct_batch_words``): the present rows copied into the
codeword in runs and K5 reading the basis rows and storing the lost rows
through its row maps (``ops/fused.py`` ``fused_split_encode_words``),
against the gathered path and the benchmark's plain reference
(``ecbench/reference``), byte for byte, with the path each call took; and
the row maps of K5 itself. Cases marked ``cuda`` run the kernel on the
card and skip without one (no JAX here: ``python -m pytest --noconftest
-m cuda tests/test_torch_rebuild_inplace.py``)."""

import itertools

import numpy as np
import pytest
import torch

from ecbench import reference
from noise_ec_tpu_torch.matrix import generator_matrix
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.ops.dispatch import DeviceCodec
from noise_ec_tpu_torch.ops.fused import fused_split_encode_words
from noise_ec_tpu_torch.parallel.batch import BatchCodec
from noise_ec_tpu_torch.parallel.mesh import (
    configure_mesh_router,
    reset_mesh_router,
)
from noise_ec_tpu_torch.parallel.streaming import StreamingDecoder

# One lane quantum: the narrowest words the rebuild writes in place.
TW = 8192
SENTINEL = 0x5EC7_1E55

# Every erasure size of both HDFS geometries: (k, r, cells lost).
SIZES = [(6, 3, e) for e in range(4)] + [(10, 4, e) for e in range(5)]

# On the CPU, K5's plain version takes ~3 ms an output row at TW: past
# this many patterns of one size (10+4 at three and four lost cells) the
# shuffled and gathered passes take a seeded sample of them; the sorted
# in-place pass, and the card, take every pattern.
CPU_PATTERNS = 100


@pytest.fixture(autouse=True)
def _isolate_port_registry():
    default_registry().reset_values()
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain products here are thousands of small tensor ops, which
    threads slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return name


def _assembled(path: str) -> float:
    return default_registry().counter(
        "noise_ec_batch_assembly_total").labels(
        entry="reconstruct_batch_words", path=path).value


def _words(shape, seed: int, device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         generator=gen).to(device)


def _code(k: int, r: int):
    return reference.load({"field": "gf256", "generator": "cauchy",
                           "field_poly": 0x11D, "data_units": k,
                           "parity_units": r})


def _gathered(monkeypatch):
    """Make every rebuild take the gathered path."""
    monkeypatch.setattr(DeviceCodec, "writes_in_place",
                        lambda self, M, words: False)


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("k,r,e", SIZES)
def test_rebuild_in_place_equals_gathered_and_reference(monkeypatch, device,
                                                        order, k, r, e):
    """Patterns of e lost cells, every survivor present (more than k where
    e < r), in sorted or shuffled order: the in-place codeword is the
    reference's, and in sorted order the gathered path's is too (every
    pattern, but on the CPU past ``CPU_PATTERNS``, module doc)."""
    device = _device(device)
    n = k + r
    B = 1 if device == "cpu" else 3
    codec = BatchCodec(k, r, device=device)
    data = _words((B, k, TW), 1000 * k + e, device)
    want = _code(k, r).encode_batch_words(data)
    assert torch.equal(codec.encode_batch_words(data), want)
    rng = np.random.default_rng(17 * k + e)
    every = list(itertools.combinations(range(n), e))
    sampled = every
    if device == "cpu" and len(every) > CPU_PATTERNS:
        sampled = [every[i] for i in sorted(
            rng.choice(len(every), CPU_PATTERNS, replace=False))]
    patterns = every if order == "sorted" else sampled
    for lost in patterns:
        present = [i for i in range(n) if i not in lost]
        if order == "shuffled":
            present = [int(i) for i in rng.permutation(present)]
        got = codec.reconstruct_batch_words(want[:, present], present)
        assert got.is_contiguous() and got.shape == (B, n, TW)
        assert torch.equal(got, want), (lost, present)
    assert (_assembled("in_place"), _assembled("gathered")) == (
        len(patterns), 0)
    if order == "shuffled" or e == 0:
        return
    _gathered(monkeypatch)
    for lost in sampled:
        present = [i for i in range(n) if i not in lost]
        got = codec.reconstruct_batch_words(want[:, present], present)
        assert torch.equal(got, want), (lost, present)
    assert _assembled("gathered") == len(sampled)


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize("lost", [(1,), (0, 7), (3, 6, 8), (0, 1, 2)])
def test_gf65536_rebuild_in_place_equals_gathered(monkeypatch, device, lost):
    """The m = 16 words entry: the maps index symbol rows."""
    device = _device(device)
    codec = BatchCodec(6, 3, field="gf65536", device=device)
    full = codec.encode_batch_words(_words((2, 6, 2 * TW), 65536, device))
    present = [i for i in range(9) if i not in lost][::-1]
    got = codec.reconstruct_batch_words(full[:, present], present)
    assert torch.equal(got, full)
    _gathered(monkeypatch)
    assert torch.equal(codec.reconstruct_batch_words(full[:, present],
                                                     present), full)
    assert (_assembled("in_place"), _assembled("gathered")) == (1, 1)


@pytest.mark.parametrize("case", ["padded", "strided", "mesh", "no_split"])
def test_rebuild_gathers_where_k5_cannot_write_in_place(monkeypatch, case):
    """A width the words path pads, words whose last axis is strided, a
    batch the mesh router shards, a plan that is not K5 (no K5 plan fits,
    so the planner takes K1): the same bytes through the gathered path."""
    codec = BatchCodec(10, 4, device="cpu")
    width = 2048 if case == "padded" else TW
    full = _code(10, 4).encode_batch_words(_words((2, 10, width), 7, "cpu"))
    present = [i for i in range(14) if i not in (2, 12)]
    survivors = full[:, present]
    if case == "strided":
        survivors = torch.stack([survivors, survivors], -1)[..., 0]
        assert survivors.stride(2) == 2
    if case == "no_split":
        monkeypatch.setattr(DeviceCodec, "_split_plan",
                            staticmethod(lambda bits_rows, C, m: None))
    if case == "mesh":
        configure_mesh_router(devices=[torch.device("cpu")] * 2, enable=True)
    try:
        got = codec.reconstruct_batch_words(survivors, present)
    finally:
        reset_mesh_router()
    assert torch.equal(got, full)
    assert (_assembled("in_place"), _assembled("gathered")) == (0, 1)
    if case == "no_split":
        # Row maps on a plan that is not K5 are refused, not misread.
        dev = codec.device_codec()
        pat = codec._pattern(present, survivors.device)
        assert dev.plan_for(pat.R)[0] == "fused"
        with pytest.raises(ValueError):
            dev.matmul_words_batch(pat.R, survivors, rows=pat.sel,
                                   out=torch.empty_like(full),
                                   out_rows=pat.lost)


def test_matmul_words_batch_reads_through_a_row_map_alone():
    """Input rows picked by ``rows`` with no ``out``: a new (B, r, TW)
    product of the rows the map names, from survivors out of order."""
    codec = BatchCodec(6, 3, device="cpu")
    full = codec.encode_batch_words(_words((2, 6, TW), 11, "cpu"))
    present = [8, 0, 5, 2, 7, 1, 3, 6]
    pat = codec._pattern(present, "cpu")
    got = codec.device_codec().matmul_words_batch(
        pat.R, full[:, present].contiguous(), rows=pat.sel)
    assert torch.equal(got, full[:, pat.lost.long()])


@pytest.mark.parametrize("stride,path", [(4 * TW, "in_place"),
                                         (4 * 2048, "gathered")])
def test_streaming_decoder_bytes_on_either_path(stride, path):
    """``StreamingDecoder`` rebuilds one chunk a call (B = 1) on the path
    its chunk width allows, with the same bytes."""
    k, r = 6, 3
    code = _code(k, r)
    data = _words((3, k, stride // 4), 63, "cpu")
    full = code.encode_batch_words(data).numpy().view(np.uint8)
    present = [0, 2, 3, 5, 7, 8]
    dec = StreamingDecoder(k, r, device="cpu")
    out = list(dec.reconstruct_stream(
        ((i, full[i, present]) for i in range(3)), present))
    assert [i for i, _ in out] == [0, 1, 2]
    for i, rows in out:
        np.testing.assert_array_equal(rows, full[i])
    assert _assembled(path) == 3 and _assembled(
        {"in_place": "gathered", "gathered": "in_place"}[path]) == 0


def _broken_mapped(fault: str):
    """``DeviceCodec.matmul_words_batch`` with the product it stores
    through row maps broken: ``unwritten`` leaves the lost rows unwritten
    (zeroed first, so they do not hold whatever the memory held), ``half``
    zeroes them in the second half of the batch, ``altered`` flips one
    byte of each of them in the first stripe."""
    real = DeviceCodec.matmul_words_batch

    def product(self, M, words, **kw):
        out, rows = kw.get("out"), kw.get("out_rows")
        if out is None:
            return real(self, M, words, **kw)
        lost = rows.long()
        if fault == "unwritten":
            out.index_fill_(1, lost, 0)
            return out
        out = real(self, M, words, **kw)
        if fault == "half":
            out[out.shape[0] // 2:].index_fill_(1, lost, 0)
        else:
            for row in lost.tolist():
                out[0, row].view(torch.uint8)[17] ^= 0x40
        return out

    return product


@pytest.mark.parametrize("name", ["hdfs-rs-6-3.read", "hdfs-rs-10-4.repair"])
@pytest.mark.parametrize("fault", ["unwritten", "half", "altered"])
def test_broken_in_place_product_is_not_correct(monkeypatch, name, fault):
    """The benchmark's rebuild cells on the CPU, with the product K5
    stores in place broken underneath: each run comes out not correct, so
    the cells' comparison sees a wrong rebuild on the in-place path."""
    from ecbench import harness
    from ecbench.tests.conftest import tiny_cell

    monkeypatch.setattr(DeviceCodec, "matmul_words_batch",
                        _broken_mapped(fault))
    res = harness.run_cell(tiny_cell(name), 2**31 + 5, 0.4, False,
                           device="cpu")
    assert _assembled("in_place") > 0 and _assembled("gathered") == 0
    assert not res["correct"]
    assert res["checks"]["mismatched_bytes"]["value"] > 0


def _split_plan(field: str, k: int, r: int, device: str):
    dev = DeviceCodec(field=field, device=device)
    M = generator_matrix(dev.gf, k, k + r, "cauchy")[k:]
    kind, threads, tiles, _ = dev.plan_for(M)
    assert kind == "split"
    return threads, tiles


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize("ksplit", ["one", "all"])
@pytest.mark.parametrize("field,k,r,m,width", [
    ("gf256", 10, 4, 8, TW), ("gf65536", 6, 3, 16, 2 * TW)])
def test_split_row_maps_match_the_contiguous_call(device, ksplit, field, k,
                                                  r, m, width):
    """K5 with input and output row maps and foreign batch strides equals
    the contiguous call on the gathered rows, and writes no row outside
    its output map."""
    device = _device(device)
    threads, tiles = _split_plan(field, k, r, device)
    ks = 1 if ksplit == "one" else tiles.NT
    assert tiles.NT > 1
    B, P, N = 3, k + 2, r + 3
    rng = np.random.default_rng(m * k)
    big = _words((B, P + 3, width), m, device)
    words = big[:, 1:1 + P]  # batch stride (P + 3) TW
    rows = rng.permutation(P)[:k]
    out_rows = rng.permutation(N)[:r]
    in_map = torch.tensor(rows, dtype=torch.int32, device=device)
    out_map = torch.tensor(out_rows, dtype=torch.int32, device=device)
    out_big = torch.full((B, N + 2, width), SENTINEL, dtype=torch.int32,
                         device=device)
    out = out_big[:, 1:1 + N]
    got = fused_split_encode_words(tiles, words, r, threads, ksplit=ks, m=m,
                                   in_rows=in_map, out=out, out_rows=out_map)
    assert got is out
    want = fused_split_encode_words(
        tiles, words[:, torch.from_numpy(rows).to(device)].contiguous(), r,
        threads, ksplit=ks, m=m)
    expect = torch.full_like(out_big, SENTINEL)
    expect[:, 1 + torch.from_numpy(out_rows).to(device)] = want
    assert torch.equal(out_big, expect)
    # No output map: rows 0..r-1 of ``out``, the rest untouched.
    out_big.fill_(SENTINEL)
    fused_split_encode_words(tiles, words, r, threads, ksplit=ks, m=m,
                             in_rows=in_map, out=out)
    expect = torch.full_like(out_big, SENTINEL)
    expect[:, 1:1 + r] = want
    assert torch.equal(out_big, expect)
    if device == "cuda":
        plain = fused_split_encode_words(
            tiles.to("cpu"), words[:, torch.from_numpy(rows).to(device)]
            .contiguous().cpu(), r, threads, m=m)
        assert torch.equal(want.cpu(), plain)


def test_split_row_maps_refuse_what_the_kernel_cannot_address():
    threads, tiles = _split_plan("gf256", 10, 4, "cpu")
    words = _words((2, 12, TW), 3, "cpu")
    rows = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):  # rows of TW words only
        fused_split_encode_words(tiles, words[..., :TW // 2], 4, threads,
                                 in_rows=rows)
    with pytest.raises(ValueError):  # int32 tables
        fused_split_encode_words(tiles, words, 4, threads,
                                 in_rows=rows.long())
    with pytest.raises(ValueError):  # k entries
        fused_split_encode_words(tiles, words, 4, threads,
                                 in_rows=rows[:9])
    with pytest.raises(ValueError):  # an output map needs an output
        fused_split_encode_words(tiles, words, 4, threads, in_rows=rows,
                                 out_rows=rows[:4])
    with pytest.raises(ValueError):  # 12 input rows without a map
        fused_split_encode_words(tiles, words, 4, threads)
