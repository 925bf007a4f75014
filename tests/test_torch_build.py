"""The kernel build's cache (``ops/_build.py``), with a stand-in for
``nvcc`` that writes its outputs and prints one ptxas line per source: a
cached library brings back what ptxas printed when it was built, and a
library whose log is missing is built again."""

import sys

import pytest

from noise_ec_tpu_torch.ops import _build

FAKE_NVCC = """\
import pathlib, sys
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
with open(pathlib.Path(__file__).with_name("calls"), "a") as f:
    f.write(" ".join(args) + "\\n")
if "-c" in args:
    src = pathlib.Path(args[-1]).stem
    print(f"ptxas info    : Function properties for {src}_kernel")
    print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
out.write_bytes(b"built")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    tool = tmp_path / "tool"
    tool.mkdir()
    script = tool / "fake_nvcc.py"
    script.write_text(FAKE_NVCC)
    nvcc = tool / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_log", {})
    return tool / "calls"


def _compiles(calls):
    return sum(" -c " in line for line in calls.read_text().splitlines())


def test_cached_build_brings_back_its_ptxas_log(fake_tree):
    first = _build.build(("a", "b"), "libtest")
    assert first.read_bytes() == b"built" and _compiles(fake_tree) == 2
    assert set(_build.build_log) == {"a", "b"}
    assert "a_kernel" in _build.build_log["a"]
    logged = dict(_build.build_log)
    _build.build_log.clear()
    # Warm: nothing compiles, and the log is what the build printed.
    assert _build.build(("a", "b"), "libtest") == first
    assert _compiles(fake_tree) == 2 and _build.build_log == logged
    # Without its log the library counts as not built.
    first.with_suffix(".ptxas.json").unlink()
    _build.build_log.clear()
    assert _build.build(("a", "b"), "libtest") == first
    assert _compiles(fake_tree) == 4 and _build.build_log == logged


def test_each_source_set_builds_its_own_library(fake_tree):
    main = _build.build(("a", "b"), "libtest")
    probe = _build.build(("b",), "libprobe")
    assert main != probe and probe.name.startswith("libprobe-")
    assert _compiles(fake_tree) == 3
    # An edited source rebuilds.
    (_build.CSRC / "a.cu").write_text("// a, edited\n")
    assert _build.build(("a", "b"), "libtest") != main
    assert _compiles(fake_tree) == 5
