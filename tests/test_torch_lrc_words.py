"""The words rebuild of a code that is not MDS (``parallel/batch.py``
``BatchCodec.reconstruct_batch_words`` on an ``lrc:<g>`` codec): the basis
of independent rows and the local tier against the benchmark's plain
reference (``ecbench/reference``, its ``lrc`` generator), byte for byte on
every erasure pattern of up to 4 lost cells; the tier each pattern takes,
its counters and its span; and the MDS codes' patterns, which keep the
first k present rows as their basis. Cases marked ``cuda`` run K5 on the
card and skip without one (``python -m pytest --noconftest -m cuda
tests/test_torch_lrc_words.py``)."""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecbench import reference
from noise_ec_tpu_torch.matrix.linalg import reconstruction_matrix
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import default_tracer
from noise_ec_tpu_torch.parallel.batch import BatchCodec

# One lane quantum: the narrowest words the rebuild writes in place.
TW = 8192
# (k, r, g): Azure's LRC(12,2,2) (r counts the local and global rows) and
# a small one whose groups are two data cells.
LRCS = [(12, 4, 2), (4, 3, 2)]
# Every erasure size of each, up to 4 lost cells.
SIZES = [(k, r, g, e) for k, r, g in LRCS for e in range(1, min(r, 4) + 1)]
TIERS = ("local", "global")


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    default_registry().reset_values()
    default_tracer().clear()
    yield
    default_tracer().clear()


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


def _code(k: int, r: int, g: int):
    return reference.load({"field": "gf256", "field_poly": 0x11D,
                           "generator": "lrc", "generator_args": {"groups": g},
                           "data_units": k, "parity_units": r})


def _words(shape, seed: int, device: str) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         generator=gen).to(device)


def _counter(family: str, tier: str) -> float:
    return default_registry().counter(family).labels(tier=tier).value


def _assembled(path: str) -> float:
    return default_registry().counter(
        "noise_ec_batch_assembly_total").labels(
        entry="reconstruct_batch_words", path=path).value


def _local_by_hand(k: int, g: int, lost) -> bool:
    """Whether every lost cell is a data or local-parity cell and the only
    loss of its group (data cells j k/g .. (j + 1) k/g - 1, local parity
    k + j)."""
    size = k // g
    groups = [i // size if i < k else i - k for i in lost if i < k + g]
    return bool(lost) and len(groups) == len(lost) == len(set(groups))


def _patterns(n: int, e: int):
    return list(itertools.combinations(range(n), e))


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
@pytest.mark.parametrize("k,r,g,e", SIZES)
def test_lrc_rebuild_equals_the_reference(device, k, r, g, e):
    """Every pattern of e lost cells: the codeword the words entry
    rebuilds in place is the reference's, and a pattern the reference
    cannot decode raises ValueError naming its rows (265 of the 1,820
    patterns of 4 at LRC(12,2,2))."""
    device = _device(device)
    n = k + r
    B = 1 if device == "cpu" else 3
    code = _code(k, r, g)
    codec = BatchCodec(k, r, matrix=f"lrc:{g}", device=device)
    data = _words((B, k, TW), 100 * k + e, device)
    want = code.encode_batch_words(data)
    assert torch.equal(codec.encode_batch_words(data), want)
    rebuilt = undecodable = 0
    for lost in _patterns(n, e):
        present = [i for i in range(n) if i not in lost]
        try:
            code.basis(present)
        except reference.UndecodablePattern:
            undecodable += 1
            with pytest.raises(ValueError, match="undecodable"):
                codec.reconstruct_batch_words(want[:, present], present)
            continue
        got = codec.reconstruct_batch_words(want[:, present], present)
        assert got.shape == (B, n, TW) and torch.equal(got, want), lost
        rebuilt += 1
    assert (_assembled("in_place"), _assembled("gathered")) == (rebuilt, 0)
    if (k, r, e) == (12, 4, 4):
        assert (rebuilt, undecodable) == (1555, 265)
    if e < r:
        assert undecodable == 0


@pytest.mark.parametrize("k,r,g", LRCS)
def test_local_tier_where_the_least_read_set_is_local(k, r, g):
    """Every decodable pattern of up to 4 lost cells: the local tier is
    taken wherever the reference's least read set is smaller than k, and
    where each lost cell is the only loss of its group (one loss in every
    group reads k cells, all of them local); its basis is then the least
    read set and R the groups' all-ones rows, block-diagonal. Every other
    pattern takes the reference's basis of independent rows."""
    n = k + r
    code = _code(k, r, g)
    codec = BatchCodec(k, r, matrix=f"lrc:{g}", device="cpu")
    size = k // g
    seen = {"local": 0, "global": 0}
    for e in range(1, min(r, 4) + 1):
        for lost in _patterns(n, e):
            present = [i for i in range(n) if i not in lost]
            try:
                basis = code.basis(present)
            except reference.UndecodablePattern:
                continue
            pat = codec._pattern(present)
            seen[pat.tier] += 1
            assert pat.lost == lost
            assert (pat.tier == "local") == _local_by_hand(k, g, lost)
            if code.least_read(lost) < k:
                assert pat.tier == "local", lost
            if pat.tier == "global":
                assert [present[i] for i in pat.sel] == basis
                continue
            assert len(pat.sel) == code.least_read(lost) == size * e
            block = np.kron(np.eye(e, dtype=np.uint8),
                            np.ones((1, size), np.uint8))
            assert np.array_equal(pat.R, block), lost
            # Each lost cell's row reads exactly its group's other cells.
            for row, i in enumerate(lost):
                cells = {present[pat.sel[c]] for c in range(row * size,
                                                             (row + 1) * size)}
                j = i // size if i < k else i - k
                assert cells == (set(range(j * size, (j + 1) * size))
                                 | {k + j}) - {i}
    # LRC(12,2,2): 14 single losses and 49 pairs across the groups heal
    # locally (the pairs read k cells).
    if (k, r, g) == (12, 4, 2):
        assert seen["local"] == 14 + 49


@pytest.mark.parametrize("k,r,g", LRCS)
def test_tier_counters_add_up(k, r, g):
    """Each rebuild adds stripes x lost rows to its tier's
    ``noise_ec_lrc_repairs_total`` and stripes x basis rows to its
    ``noise_ec_lrc_repair_shards_read_total``."""
    n = k + r
    codec = BatchCodec(k, r, matrix=f"lrc:{g}", device="cpu")
    full = codec.encode_batch_words(_words((3, k, TW), 31 * k, "cpu"))
    want = {(f, t): 0 for f in ("repairs", "reads") for t in TIERS}
    rng = np.random.default_rng(k)
    for stripes, lost in [(3, (0,)), (2, (k,)), (1, (n - 1,)), (3, (0, 1)),
                          (2, (0, k + 1)), (1, (1, k // 2 + 1)), (3, ())]:
        present = [int(i) for i in rng.permutation(
            [i for i in range(n) if i not in lost])]
        got = codec.reconstruct_batch_words(full[:stripes, present], present)
        assert torch.equal(got, full[:stripes])
        pat = codec._pattern(present)
        if pat.tier is not None:
            want["repairs", pat.tier] += stripes * len(lost)
            want["reads", pat.tier] += stripes * len(pat.sel)
    assert want["repairs", "local"] and want["repairs", "global"]
    for tier in TIERS:
        assert _counter("noise_ec_lrc_repairs_total", tier) == \
            want["repairs", tier]
        assert _counter("noise_ec_lrc_repair_shards_read_total", tier) == \
            want["reads", tier]


def test_an_mds_codec_counts_no_tier():
    codec = BatchCodec(6, 3, device="cpu")
    full = codec.encode_batch_words(_words((2, 6, TW), 5, "cpu"))
    present = [1, 2, 3, 4, 5, 6, 7, 8]
    assert torch.equal(codec.reconstruct_batch_words(full[:, present],
                                                     present), full)
    assert codec._pattern(present).tier == "global"
    for tier in TIERS:
        assert _counter("noise_ec_lrc_repairs_total", tier) == 0
        assert _counter("noise_ec_lrc_repair_shards_read_total", tier) == 0


@pytest.mark.parametrize("k,r", [(10, 4), (6, 3)])
def test_mds_patterns_keep_the_first_k_present(k, r):
    """Every pattern of up to r lost cells of RS(10,4) and RS(6,3), in
    sorted and in shuffled order: ``sel``, R and ``order`` are those of
    the first k of sorted ``present``, the basis before the search for
    independent rows."""
    n = k + r
    codec = BatchCodec(k, r, device="cpu")
    rng = np.random.default_rng(k)
    for e in range(r + 1):
        for lost in _patterns(n, e):
            present = [i for i in range(n) if i not in lost]
            for order in (present, [int(i) for i in rng.permutation(present)]):
                pat = codec._pattern(order)
                pos = {p: i for i, p in enumerate(order)}
                pos.update((i, n - e + j) for j, i in enumerate(lost))
                basis = sorted(order)[:k]
                assert pat.sel == tuple(pos[i] for i in basis)
                assert pat.order == tuple(pos[i] for i in range(n))
                if not lost:
                    assert pat.R is None and pat.tier is None
                    continue
                assert pat.tier == "global"
                assert np.array_equal(pat.R, reconstruction_matrix(
                    codec.gf, codec.G, basis, list(lost)))


def test_too_few_independent_rows_name_the_pattern():
    codec = BatchCodec(12, 4, matrix="lrc:2", device="cpu")
    present = list(range(3, 16))  # data cells 0-2 lost, and one more
    present.remove(12)
    with pytest.raises(ValueError, match=r"rank 11, 12 needed"):
        codec._pattern(present)


def _children(events, root):
    """{child name: parent name} of the spans under each ``root`` event."""
    out = {}
    for ev in events:
        if ev.name != root:
            continue
        for child in ev.cpu_children:
            if "." in child.name and not child.name.startswith("aten"):
                out[child.name] = root
    return out


def test_a_local_heal_opens_its_span_around_the_launch():
    """In a capture, a local heal's product runs under ``batch.heal_local``
    inside ``batch.reconstruct_words``; a global rebuild opens none. Both
    write their codeword in place."""
    codec = BatchCodec(12, 4, matrix="lrc:2", device="cpu")
    full = codec.encode_batch_words(_words((2, 12, TW), 9, "cpu"))
    local = [i for i in range(16) if i != 3]
    glob = [i for i in range(16) if i != 14]
    for present in (local, glob):  # plan outside the capture
        codec.reconstruct_batch_words(full[:, present], present)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for present in (local, glob):
            assert torch.equal(
                codec.reconstruct_batch_words(full[:, present], present),
                full)
    events = prof.events()
    assert _children(events, "batch.reconstruct_words") == {
        "batch.pattern": "batch.reconstruct_words",
        "batch.heal_local": "batch.reconstruct_words",
        "codec.plan": "batch.reconstruct_words",
        "codec.gate": "batch.reconstruct_words",
        "codec.launch": "batch.reconstruct_words",
        "batch.assemble": "batch.reconstruct_words"}
    assert _children(events, "batch.heal_local") == {
        "codec.plan": "batch.heal_local",
        "codec.gate": "batch.heal_local",
        "codec.launch": "batch.heal_local"}
    heals = [s for s in default_tracer().dump()
             if s["name"] == "batch.heal_local"]
    assert [s["parent"] for s in heals] == ["batch.reconstruct_words"]
    assert (_assembled("in_place"), _assembled("gathered")) == (4, 0)


@pytest.mark.parametrize("lost", [(5,), (12,), (2, 13), (0, 11)])
def test_local_heals_plan_k5_and_share_its_plan(lost):
    """The all-ones R of a local heal (1 x 6, or 2 x 12 block-diagonal)
    plans K5 and writes in place; every pattern of one size shares one
    matrix, so one plan."""
    codec = BatchCodec(12, 4, matrix="lrc:2", device="cpu")
    full = codec.encode_batch_words(_words((2, 12, TW), 13, "cpu"))
    present = [i for i in range(16) if i not in lost]
    pat = codec._pattern(present, "cpu")
    dev = codec.device_codec()
    survivors = full[:, present].contiguous()
    assert pat.tier == "local" and dev.writes_in_place(pat.R, survivors)
    assert dev.plan_for(pat.R)[0] == "split"
    other = codec._pattern([i for i in range(16) if i not in (
        (1,) if len(lost) == 1 else (7, 12))])
    assert np.array_equal(pat.R, other.R)
