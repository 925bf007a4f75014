"""Runs one cell: set-up, the measured window, and the check of what the
timed path produced against the plain reference.

The system under test is the port's ``BatchCodec``. The cell's traffic mix
names its driver, ``ecbench/drivers/<driver>.py``: a class ``Driver(job)``
that sets the cell up (``setup()``: the resident stripes, the codec, the
warm-up), drives the window (``window(run)``), drops the program's state
(``drop()``) and, once the window has closed, hands over each checked
answer beside the reference's (``answers()``). This module holds what every
driver shares (:class:`Job`): the resident stripes made on the device from
the seed, the buffers that keep the checked answers, the host spans, and
the check, which runs once the window has closed, the memory peak has been
read and the program's state has been dropped.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from ecbench import reference
from ecbench import trace as tr
from ecbench.traffic import BLOCK, Mix, block_stripes

FORBIDDEN = ("jax", "jaxlib", "flax", "noise_ec_tpu")
# Stripes a block of the reference's parity in set-up.
RESIDENT_CHUNK = 32
# Blocks of requests drawn in set-up; a window that reaches past them
# draws the next block inside it (some ms once per BLOCK requests).
PREDRAWN_BLOCKS = 2
clock = time.perf_counter


@dataclass
class Done:
    """One request (for encode, one call) that came back."""
    op: str             # what the request was: the mix's ``request``
    t0: float
    t1: float
    useful_bytes: int
    least_bytes: int


@dataclass
class Run:
    """What the metric readers read (``ecbench/metrics/*.py``)."""
    cell: str
    config: dict
    traffic: dict
    device_kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    done: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    trace: object = None
    traced: list = field(default_factory=list)


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_codec(config: dict, device: str):
    """The system under test: the port's batch codec for ``config``, its
    matrix kind ``program_matrix`` where the configuration names the port's
    kind apart from the reference's generator (``lrc:2`` for ``lrc`` with
    two groups), else ``generator``."""
    from noise_ec_tpu_torch.parallel.batch import BatchCodec

    return BatchCodec(int(config["data_units"]), int(config["parity_units"]),
                      field=config["field"],
                      matrix=config.get("program_matrix", config["generator"]),
                      device=device)


def read_counters(specs: dict) -> dict:
    """Program counters by key: ``{key: (type, family, labels, attr)}``,
    read from the port's default registry."""
    if not specs:
        return {}
    from noise_ec_tpu_torch.obs.registry import default_registry

    reg = default_registry()
    return {key: float(getattr(getattr(reg, mtype)(family).labels(**labels),
                               attr))
            for key, (mtype, family, labels, attr) in specs.items()}


class _Device:
    """The few device calls that differ between the card and the CPU (the
    tests drive the harness on the CPU with the kernels' plain versions)."""

    def __init__(self, device: str):
        self.device = device
        self.cuda = device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def stream(self):
        return torch.cuda.Stream() if self.cuda else None

    def on(self, stream):
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def event(self):
        """An event recorded on the current stream (None on the CPU, where
        the work is done when the call returns)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(event) -> None:
        if event is not None:
            event.synchronize()

    @staticmethod
    def done(event) -> bool:
        return event is None or event.query()


def mismatched_bytes(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.contiguous().view(torch.uint8)
                != b.contiguous().view(torch.uint8)).sum().item())


class Job:
    """One run of one cell: the parts every driver shares (module doc)."""

    def __init__(self, cell, seed: int, seconds: float, device: str,
                 system):
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seconds = float(seconds)
        self.dev = _Device(device)
        self.device = device
        self.system = system or program_codec
        self.code = reference.load(self.cfg)
        self.k, self.r, self.n = self.code.k, self.code.r, self.code.n
        self.cell_bytes = int(self.cfg["cell_bytes"])
        self.tw = self.cell_bytes // 4
        self.stripes = block_stripes(self.cfg)
        self.mix = Mix(self.traffic, self.cfg, seed)
        self.seed = seed
        self.checked = sorted(set(self.mix.checked()))
        self.slot = {i: s for s, i in enumerate(self.checked)}
        self.got: dict = {}
        self.failures: list = []
        self.phases: dict = {}
        self.reference_s = 0.0
        self._idx: dict = {}
        self.host_spans: list = []
        self.slice = tr.Slice(False, device)
        for b in range(PREDRAWN_BLOCKS):
            self.mix.request(b * BLOCK)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times one phase of set-up (printed on standard error)."""
        t = clock()
        try:
            yield
        finally:
            self.dev.sync()
            self.phases[name] = clock() - t

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span on the harness's clock, kept while the trace runs
        and added to it: it names what the host was doing in the idle
        gaps."""
        if not self.slice.live:
            yield
            return
        t0 = clock()
        try:
            yield
        finally:
            self.host_spans.append((name, t0, clock()))

    def add_span(self, name: str, t0: float, t1: float) -> None:
        if self.slice.live:
            self.host_spans.append((name, t0, t1))

    def idx(self, rows: tuple) -> torch.Tensor:
        """A device index tensor of ``rows``, uploaded once."""
        t = self._idx.get(rows)
        if t is None:
            t = self._idx[rows] = torch.tensor(rows, dtype=torch.long,
                                               device=self.device)
        return t

    def make_resident(self, rows: int) -> None:
        """``self.res``, the resident stripes (stripes, rows, words): data
        cells drawn from the seed by a generator on the device in one call;
        where ``rows`` takes parity cells too, their parity, computed by the
        reference in blocks of stripes. The reference's seconds are kept
        in ``reference_s`` and left out of the set-up time."""
        stripes = self.stripes * int(self.cfg["resident_block_groups"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.seed) % (1 << 64))
        self.res = torch.empty((stripes, rows, self.tw), dtype=torch.int32,
                               device=self.device)
        self.res.view(torch.uint8)[:, :self.k].random_(0, 256, generator=gen)
        if rows == self.k:
            return
        self.dev.sync()
        t = clock()
        for s0 in range(0, stripes, RESIDENT_CHUNK):
            s1 = min(stripes, s0 + RESIDENT_CHUNK)
            self.res[s0:s1, self.k:] = self.code.parity(
                self.res[s0:s1, :self.k])
        self.dev.sync()
        self.reference_s += clock() - t

    def make_hold(self, words) -> None:
        """The buffers that keep each checked answer, filled as the window
        produces them: ``words(i)`` int32 words for checked request i."""
        self.hold = [torch.empty(int(words(i)), dtype=torch.int32,
                                 device=self.device) for i in self.checked]

    def drop_program(self) -> None:
        gc.collect()
        if self.dev.cuda:
            torch.cuda.empty_cache()

    def check(self, run: Run, answers) -> dict:
        """Compare every held answer with the reference's: ``answers``
        yields (held, expected) pairs."""
        bad = 0
        for got, expect in answers:
            bad += mismatched_bytes(got, expect)
        due = {i for i in self.checked if i < run.attempted}
        return {
            "mismatched_bytes": {"value": bad, "limit": 0, "rule": "<="},
            "answers_missing": {"value": len(due - set(self.got)),
                                "limit": 0, "rule": "<="},
            "failed_requests": {"value": len(self.failures), "limit": 0,
                                "rule": "<="},
            "answers_checked": {"value": len(self.got), "limit": 1,
                                "rule": ">="},
        }


def passes(check: dict) -> bool:
    if check["rule"] == "<=":
        return check["value"] <= check["limit"]
    return check["value"] >= check["limit"]


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             system=None) -> dict:
    """One run of ``cell`` (a :class:`ecbench.spec.Cell`); returns the
    result object that ``ecbench.run`` prints. ``system(config, device)``
    makes the codec under test (default: the port's)."""
    t_start = clock() if t_start is None else t_start
    job = Job(cell, seed, seconds, device, system)
    driver = cell.driver.Driver(job)
    kind = (torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu")
    run = Run(cell.name, cell.config, cell.traffic, kind)
    job.phases["start"] = clock() - t_start
    driver.setup()
    specs = {}
    for m in cell.end_to_end + cell.per_layer:
        specs.update(getattr(m.reader, "COUNTERS", {}))
    before = read_counters(specs)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_stats()
    # What exists now (the drawn requests, the program's state) is left
    # out of the cyclic collector's scans during the window.
    gc.collect()
    gc.freeze()
    try:
        job.slice = tr.Slice(trace, device)
        run.setup_s = clock() - t_start - job.reference_s
        driver.window(run)
    finally:
        gc.unfreeze()
    after = read_counters(specs)
    run.counters = {key: after[key] - before[key] for key in specs}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        # The allocator's work inside the window: segments the device
        # allocated and freed, and allocations it retried after freeing
        # its cache. None of them is expected once set-up has warmed up.
        alloc1 = torch.cuda.memory_stats()
        job.phases.update({
            f"window_{key}": alloc1.get(key, 0) - alloc0.get(key, 0)
            for key in ("num_device_alloc", "num_device_free",
                        "num_alloc_retries")})
        job.phases["window_reserved_peak_bytes"] = (
            torch.cuda.max_memory_reserved())
    if job.slice.prof is not None:
        run.trace = tr.read(job.slice.prof)
        if run.trace is not None:
            run.trace.add_host(job.host_spans, job.slice.t0)
            run.traced = [d for d in run.done
                          if job.slice.t0 <= d.t1 <= job.slice.t1]
    driver.drop()
    job.drop_program()
    checks = job.check(run, driver.answers())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {
        "correct": all(passes(c) for c in checks.values()),
        "attempted": run.attempted,
        "failed": len(job.failures),
        "metrics": metrics,
        "device": dev,
    }
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    job.phases["reference_parity"] = job.reference_s
    job.phases["held_answers_bytes"] = sum(
        h.numel() * 4 for h in getattr(job, "hold", ()))
    print("ecbench set-up: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in job.phases.items()), file=sys.stderr)
    for i, exc in job.failures[:5]:
        print(f"ecbench: request {i} failed: {exc}", file=sys.stderr)
    result["checks"] = checks
    return result
