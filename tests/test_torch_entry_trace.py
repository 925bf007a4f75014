"""Spans, the pattern-cache counter and the device time of the port's
words entries (``parallel/batch.py`` ``BatchCodec.encode_batch_words`` /
``reconstruct_batch_words``): spans reach a ``torch.profiler`` capture,
nested as the entries run them, and nothing is opened or recorded outside
one; the pattern cache counts its misses; the entry's CUDA events resolve
into ``noise_ec_batch_device_seconds`` (on the card); and a traced run of
the benchmark's repair cell on the CPU reads the metrics built on them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from noise_ec_tpu_torch.obs import device as obs_device
from noise_ec_tpu_torch.obs.device import entry_scope, resolve_entry_events
from noise_ec_tpu_torch.obs.registry import default_registry
from noise_ec_tpu_torch.obs.trace import _NOOP, default_tracer, span
from noise_ec_tpu_torch.parallel import batch as batch_mod
from noise_ec_tpu_torch.parallel.batch import BatchCodec

ENCODE = {
    "codec.plan": "batch.encode_words",
    "codec.gate": "batch.encode_words",
    "codec.launch": "batch.encode_words",
    "batch.cat": "batch.encode_words",
}
# A rebuild that writes its codeword in place (K5's row maps), and one that
# gathers (here: a width the words path pads).
RECONSTRUCT = {
    "batch.pattern": "batch.reconstruct_words",
    "codec.plan": "batch.reconstruct_words",
    "codec.gate": "batch.reconstruct_words",
    "codec.launch": "batch.reconstruct_words",
    "batch.assemble": "batch.reconstruct_words",
}
RECONSTRUCT_GATHERED = {
    "batch.pattern": "batch.reconstruct_words",
    "batch.select": "batch.reconstruct_words",
    "codec.plan": "batch.reconstruct_words",
    "codec.gate": "batch.reconstruct_words",
    "codec.launch": "batch.reconstruct_words",
    "batch.cat": "batch.reconstruct_words",
}
# The narrowest words the rebuild writes in place: one lane quantum.
TW_IN_PLACE = 8192


@pytest.fixture(autouse=True)
def _isolate_port_observability():
    default_registry().reset_values()
    default_tracer().clear()
    yield
    default_tracer().clear()


def _words(B, k, TW=2048, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (B, k, TW), dtype=torch.int32,
                         generator=gen)


def _codec():
    return BatchCodec(4, 2, device="cpu")


def _misses(entry="reconstruct_batch_words"):
    return default_registry().counter(
        "noise_ec_batch_pattern_misses_total").labels(entry=entry).value


def _assembled(path):
    return default_registry().counter(
        "noise_ec_batch_assembly_total").labels(
        entry="reconstruct_batch_words", path=path).value


def _device_hist(entry):
    return default_registry().histogram(
        "noise_ec_batch_device_seconds").labels(entry=entry)


def _parents(events, root):
    """{child name: parent name} of the profiler events under each
    ``root`` event."""
    out = {}
    for ev in events:
        if ev.name != root:
            continue
        for child in ev.cpu_children:
            if "." in child.name and not child.name.startswith("aten"):
                out[child.name] = root
    return out


def test_words_entries_open_their_spans_in_a_capture():
    codec = _codec()
    words = _words(2, 4, TW=TW_IN_PLACE)
    full = codec.encode_batch_words(words)  # plans outside the capture
    present = [0, 2, 3, 4, 5]
    codec.reconstruct_batch_words(full[:, present], present)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = codec.encode_batch_words(words)
        back = codec.reconstruct_batch_words(out[:, present], present)
    assert torch.equal(out, full) and torch.equal(back, full)
    assert (_assembled("in_place"), _assembled("gathered")) == (2, 0)
    events = prof.events()
    assert _parents(events, "batch.encode_words") == ENCODE
    assert _parents(events, "batch.reconstruct_words") == RECONSTRUCT
    spans = default_tracer().dump()
    assert {s["name"]: s["parent"] for s in spans
            if s["parent"] == "batch.encode_words"} == ENCODE
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["batch.encode_words",
                                          "batch.reconstruct_words"]
    # One trace id a call, which every span of the call carries.
    by_id = {}
    for s in spans:
        by_id.setdefault(s["trace_id"], set()).add(s["name"])
    assert sorted(map(sorted, by_id.values())) == sorted([
        sorted(set(ENCODE) | {"batch.encode_words"}),
        sorted(set(RECONSTRUCT) | {"batch.reconstruct_words"})])


def test_a_gathered_rebuild_opens_select_and_cat():
    """Where the words path pads the width, the rebuild gathers its basis
    rows and concatenates: ``batch.select`` and ``batch.cat``, no
    ``batch.assemble``."""
    codec = _codec()
    full = codec.encode_batch_words(_words(2, 4))
    present = [0, 2, 3, 4, 5]
    codec.reconstruct_batch_words(full[:, present], present)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        back = codec.reconstruct_batch_words(full[:, present], present)
    assert torch.equal(back, full)
    assert (_assembled("in_place"), _assembled("gathered")) == (0, 2)
    assert _parents(prof.events(),
                    "batch.reconstruct_words") == RECONSTRUCT_GATHERED
    assert {s["name"] for s in default_tracer().dump()} == (
        set(RECONSTRUCT_GATHERED) | {"batch.reconstruct_words"})


def test_a_plan_miss_plans_under_the_launch():
    codec = _codec()
    with profile(activities=[ProfilerActivity.CPU]):
        codec.encode_batch_words(_words(1, 4))
    spans = default_tracer().dump()
    assert ("codec.plan", "codec.launch") in {
        (s["name"], s["parent"]) for s in spans}


def test_no_capture_opens_no_span_and_records_nothing():
    codec = _codec()
    words = _words(2, 4)
    tracer = default_tracer()
    assert tracer.device_span("codec.launch") is _NOOP
    assert entry_scope("batch.encode_words", "encode_batch_words",
                       words.device) is _NOOP
    full = codec.encode_batch_words(words)
    codec.reconstruct_batch_words(full[:, [1, 2, 3, 5]], [1, 2, 3, 5])
    assert tracer.dump() == []
    for entry in ("encode_batch_words", "reconstruct_batch_words"):
        assert _device_hist(entry).count == 0
    assert not obs_device._entry_pending


def test_a_node_span_enters_the_capture():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("decode", key="abcd"):
            torch.ones(4).add_(1)
    names = [ev.name for ev in prof.events()]
    assert "decode" in names
    (dec,) = [ev for ev in prof.events() if ev.name == "decode"]
    assert any(c.name.startswith("aten::") for c in dec.cpu_children)
    with span("decode"):  # after the capture: the ring alone
        pass
    assert [s["name"] for s in default_tracer().dump()] == ["decode",
                                                            "decode"]


def _patterns(n_total, k):
    """Present lists of distinct erasure patterns of a (k + 4)-row code:
    every single erasure, then doubles."""
    n = k + 4
    out = [[i for i in range(n) if i != a] for a in range(n)]
    out += [[i for i in range(n) if i not in (a, b)]
            for a in range(n) for b in range(a + 1, n)]
    return out[:n_total]


def test_pattern_cache_counts_its_misses():
    codec = BatchCodec(10, 4, device="cpu")
    words = _words(1, 10, TW=512)
    full = codec.encode_batch_words(words)
    present = [i for i in range(14) if i != 3]
    assert _misses() == 0
    assert torch.equal(codec.reconstruct_batch_words(
        full[:, present], present), full)
    assert _misses() == 1  # a cold miss
    codec.reconstruct_batch_words(full[:, present], present)
    assert _misses() == 1  # a hit
    cap = batch_mod._PATTERNS
    pats = _patterns(cap + 1, 10)
    assert pats[3] == present
    dev = full.device
    for p in pats:
        codec._pattern(p, dev)
    # The 64 patterns filled the cache (one already held); the 65th
    # cleared it.
    assert _misses() == cap + 1
    for p in pats[:cap]:
        codec._pattern(p, dev)
    assert _misses() == 2 * cap + 1  # each misses again after the clear
    assert _misses("reconstruct_batch") == 0
    sym = codec.encode_batch(np.random.default_rng(5).integers(
        0, 256, (1, 10, 64), dtype=np.uint8))
    assert np.array_equal(
        codec.reconstruct_batch(sym[:, present], present), sym)
    assert _misses("reconstruct_batch") == 1


@pytest.mark.cuda
def test_entry_device_time_resolves_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec = BatchCodec(10, 4, device="cuda")
    words = _words(8, 10, TW=65536).cuda()
    codec.encode_batch_words(words)
    torch.cuda.synchronize()
    hist = _device_hist("encode_batch_words")
    n0 = hist.count
    N = 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(N):
            codec.encode_batch_words(words)
    torch.cuda.synchronize()
    codec.encode_batch_words(words)  # resolves every pending pair
    resolve_entry_events()
    assert hist.count - n0 >= N and hist.sum > 0
    assert not obs_device._entry_pending


def test_traced_cpu_repair_cell_reads_the_entry_metrics(monkeypatch):
    """On the CPU the device's work is PyTorch's CPU ops: the trace counts
    them as its device operations, so that the idle share has a device
    to read."""
    from ecbench import harness
    from ecbench import trace as ec_trace
    from ecbench.tests.conftest import tiny_cell

    read = ec_trace.read

    def read_cpu_ops_as_device(prof):
        tr = read(prof)
        if tr is not None:
            tr.device = [(name, "kernel", ts, dur)
                         for name, ts, dur in tr.host
                         if name.startswith("aten::")
                         and ts < tr.t1 and ts + dur > tr.t0]
        return tr

    monkeypatch.setattr(ec_trace, "read", read_cpu_ops_as_device)
    res = harness.run_cell(tiny_cell("hdfs-rs-10-4.repair"), 2**31 + 11,
                           0.4, True, device="cpu")
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["pattern_misses.repair"]["value"] >= 0
    assert 0 <= metrics["entry_idle.repair"]["value"] <= 100
    assert "entry_device_ms.repair" not in metrics  # no CUDA events here
    assert metrics["inplace_share.repair"]["value"] == 100
    labels = {name for name, _ in res["breakdown"]["idle_gaps"]}
    assert labels & {"batch.reconstruct_words", "batch.pattern",
                     "batch.select", "codec.plan", "codec.gate",
                     "codec.launch", "batch.cat", "batch.assemble"}
