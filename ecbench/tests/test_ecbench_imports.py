"""Nothing the harness runs or imports loads JAX or the JAX package,
compared by whole top-level module names."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import importlib, json, pkgutil, sys
import ecbench
from ecbench import harness, spec
for m in pkgutil.walk_packages(ecbench.__path__, "ecbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
bench = json.loads(spec.BENCHMARK.read_text())
for w in bench["workloads"]:
    spec.load_cell(w["name"])
harness.program_codec(spec.load_cell(bench["workloads"][0]["name"]).config,
                      "cpu")
print(json.dumps(harness.forbidden_modules()))
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    from ecbench import harness

    monkeypatch.setitem(sys.modules, "noise_ec_tpu_torch_probe",
                        types.ModuleType("noise_ec_tpu_torch_probe"))
    assert "noise_ec_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
