"""The harness driven on the CPU at tiny sizes (the kernels' plain
versions), the look for a chip skipped: sound runs come out correct, and
runs with the timed path broken underneath, or the control in the
program's place, come out not correct."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from ecbench import harness, spec
from ecbench import control
from ecbench.tests.conftest import tiny_cell
from ecbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads(spec.BENCHMARK.read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(name, seed=2**31 + 5, trace=False, system=None):
    return harness.run_cell(tiny_cell(name), seed, 0.4, trace,
                            device="cpu", system=system)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    cell = spec.load_cell(name)
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    assert list(res)[-1] == "checks"


def _broken(kind):
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    real = DeviceCodec.matmul_words_batch

    def product(self, M, words, **kw):
        out = real(self, M, words, **kw)
        if kind == "unchanged":
            return torch.zeros_like(out)
        if kind == "half":
            out = out.clone()
            out[out.shape[0] // 2:] = 0
            return out
        out = out.clone()
        # A byte of a row the product wrote: on the in-place rebuild, one of
        # the lost rows of the codeword (``out_rows``), which the copy of the
        # present rows leaves as it is.
        rows = kw.get("out_rows")
        row = out[0, int(rows[0])] if rows is not None else out[0, 0]
        row.view(torch.uint8)[17] ^= 0x40
        return out

    return product


@pytest.mark.parametrize("name", ["hdfs-rs-10-4.write", "hdfs-rs-6-3.read",
                                  "hdfs-rs-10-4.repair"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    from noise_ec_tpu_torch.ops.dispatch import DeviceCodec

    monkeypatch.setattr(DeviceCodec, "matmul_words_batch", _broken(fault))
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["mismatched_bytes"]["value"] > 0


@pytest.mark.parametrize("name", ["hdfs-rs-10-4.write", "hdfs-rs-6-3.read",
                                  "hdfs-rs-10-4.repair"])
def test_control_is_not_correct(name):
    res = control.run(tiny_cell(name), 2**31 + 5, 0.4, device="cpu")
    assert not res["correct"]
    assert res["checks"]["mismatched_bytes"]["value"] > 0
    assert res["checks"]["answers_checked"]["value"] == 3


def test_failed_requests_are_not_correct(monkeypatch):
    from noise_ec_tpu_torch.parallel.batch import BatchCodec

    def refuse(self, words_present, present):
        raise RuntimeError("refused")

    monkeypatch.setattr(BatchCodec, "reconstruct_batch_words", refuse)
    with pytest.raises(RuntimeError):
        _run("hdfs-rs-6-3.read")  # warm-up already fails


def test_traced_run_on_the_cpu_reads_no_device_metric():
    res = _run("hdfs-rs-10-4.write", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"submit_ms.write"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0


def test_reader_falls_back_to_the_base_name():
    assert spec.reader_path("gf_roofline.read").name == "gf_roofline.py"
    assert spec.reader_path("encode_GBps").name == "encode_GBps.py"
    with pytest.raises(FileNotFoundError):
        spec.reader_path("no_such_metric.read")


def test_unknown_driver_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.load_driver("no_such_driver")


def test_closed_loop_sees_each_request_when_it_ends(monkeypatch):
    """The loop stamps a request when its own event is done, not when the
    older requests in flight on other streams are: one slow request delays
    no other."""
    cell = tiny_cell("hdfs-rs-6-3.read")
    job = harness.Job(cell, 7, 0.6, "cpu", None)
    driver = cell.driver.Driver(job)
    driver.setup()
    delays = iter([0.3] + [0.01] * 10**6)

    class Event:
        def __init__(self):
            self.at = harness.clock() + next(delays)

        def query(self):
            return harness.clock() >= self.at

    monkeypatch.setattr(job.dev, "event", Event)
    run = harness.Run(cell.name, cell.config, cell.traffic, "cpu")
    driver.window(run)
    late = [d.t1 - d.t0 for d in run.done if d.t1 - d.t0 >= 0.25]
    assert len(run.done) > 10 and len(late) == 1


def test_open_loop_keeps_the_arrivals_and_counts_the_wait(monkeypatch):
    """Requests arrive at the mix's times whatever comes back; one that
    finds no stream free waits, and its latency counts the wait."""
    cell = tiny_cell("hdfs-rs-6-3.read")
    cell.driver = spec.load_driver("open_loop")
    cell.traffic.update(driver="open_loop", rate_per_s=40.0,
                        arrival_stratum=50, streams=1)
    job = harness.Job(cell, 7, 0.6, "cpu", None)
    driver = cell.driver.Driver(job)
    driver.setup()

    class Event:
        def __init__(self):
            self.at = harness.clock() + 0.05

        def query(self):
            return harness.clock() >= self.at

    monkeypatch.setattr(job.dev, "event", Event)
    run = harness.Run(cell.name, cell.config, cell.traffic, "cpu")
    driver.window(run)
    due = sum(job.mix.arrival(i) - job.mix.arrival(0) < 0.6
              for i in range(100))
    assert run.attempted == len(run.done) == due
    lat = [d.t1 - d.t0 for d in run.done]
    assert min(lat) >= 0.05 and lat[-1] > lat[0] + 0.2


def test_setup_time_leaves_out_the_reference(monkeypatch):
    """The reference's parity of the resident stripes is not set-up: a
    reference slower by a second leaves ``setup_s`` as it was."""
    from ecbench import reference

    plain = _run("hdfs-rs-6-3.read")["metrics"]["setup_s"]["value"]
    fast = reference.Code.parity

    def parity(self, data):
        time.sleep(1.0)
        return fast(self, data)

    monkeypatch.setattr(reference.Code, "parity", parity)
    res = _run("hdfs-rs-6-3.read")
    assert res["correct"]
    assert res["metrics"]["setup_s"]["value"] < plain + 0.5


def test_trace_reductions():
    us = 1e6
    tr = Trace(0.0, 1.0 * us, [
        ("void noise_ec::split_kernel<8>", "kernel", 0.1 * us, 0.2 * us),
        ("void at::native::index_select", "kernel", 0.2 * us, 0.2 * us),
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 0.7 * us, 0.1 * us),
        ("void noise_ec::split_kernel<8>", "kernel", 0.95 * us, 0.2 * us),
    ], [("ecbench.window", 0.0, 1.0 * us), ("ecbench.sync", 0.4 * us, 0.3 * us)])
    assert tr.window_s == 1.0
    assert tr.seconds(torch_own=False) == pytest.approx(0.25)
    assert tr.seconds(torch_own=True) == pytest.approx(0.3)
    assert tr.busy_s() == pytest.approx(0.3 + 0.1 + 0.05)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "void noise_ec::split_kernel<8>"
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"ecbench.sync": 0.3, "ecbench.window": 0.1 + 0.15})


def test_benchmark_json_follows_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("ecbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert spec.reader_path(m["name"]).is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        cell = spec.load_cell(w["name"])
        assert callable(cell.driver.Driver)
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {x.name for x in spec.load_cell(w).end_to_end}


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda_device, name):
    """A short run of each cell at its own size on the card, and the
    control in the program's place."""
    cell = spec.load_cell(name)
    res = harness.run_cell(cell, 2**31 + 99, 2.0, False)
    assert res["correct"], res["checks"]
    bad = control.run(spec.load_cell(name), 2**31 + 99, 3.0)
    assert not bad["correct"]
    assert bad["checks"]["mismatched_bytes"]["value"] > 0
