"""Finds a cell's parts by the names in ``BENCHMARK.json``.

A configuration is the file its entry names, a traffic mix is
``ecbench/traffic/<traffic>.json``, whose ``driver`` names
``ecbench/drivers/<driver>.py``, and a metric is the reader
``ecbench/metrics/<name>.py``, or, where there is none, that of the part
of its name before the first dot (``gf_roofline.read`` falls back to
``metrics/gf_roofline.py``): a module with ``read(run)``, which returns a
number or None (nothing to read), and optionally ``COUNTERS``, the program
counters it reads (``harness.read_counters``). A new cell, driver or metric
is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Metric:
    name: str
    unit: str
    reader: object


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: its own file, else its base's."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader under {HERE / 'metrics'} for "
                            f"metric {name!r}")


def load_reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "ecbench.metrics." + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise TypeError(f"{path} has no read(run)")
    return module


def load_driver(name: str):
    path = HERE / "drivers" / f"{name}.py"
    if not path.is_file() or not name.isidentifier():
        raise FileNotFoundError(f"no driver {path}")
    module = importlib.import_module(f"ecbench.drivers.{name}")
    if not callable(getattr(module, "Driver", None)):
        raise TypeError(f"{path} has no Driver")
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    spec = json.loads(Path(benchmark).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        driver=load_driver(traffic["driver"]),
        end_to_end=[Metric(m["name"], m["unit"], load_reader(m["name"]))
                    for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], load_reader(m["name"]))
                   for m in layer],
    )
