"""The port's hardware check (``noise_ec_tpu_torch.tools.hwcheck``) on the
CPU, where every kernel wrapper runs its plain version: every check passes,
and its checks are the reference's, under the reference's names, in the
reference's order, except the near-limit route check, which asserts the
port's own routes."""

import ast
import json
from pathlib import Path

import pytest

from noise_ec_tpu_torch.tools import hwcheck

REPO = Path(__file__).resolve().parent.parent
REF_ROUTE_CHECK = "'near-limit RS(200,56) route=mxu, planning bounded'"
PORT_ROUTE_CHECK = \
    "'near-limit RS(200,56) routes=(panel, baked), planning bounded'"


def _yielded_names(path: Path) -> list[str]:
    """The check names ``_checks`` yields, in source order, as source text
    (an f-string keeps its fields: ``f'encode {field} RS({k},{r}) S={S}'``).
    A ``yield from`` of another function of the module yields that
    function's names in its place."""
    tree = ast.parse(path.read_text())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}

    def names_of(fn: ast.FunctionDef) -> list[str]:
        nodes = [node for node in ast.walk(fn)
                 if isinstance(node, ast.YieldFrom)
                 or (isinstance(node, ast.Yield)
                     and isinstance(node.value, ast.Tuple))]
        nodes.sort(key=lambda n: (n.lineno, n.col_offset))
        out = []
        for node in nodes:
            if isinstance(node, ast.YieldFrom):
                out += names_of(funcs[node.value.func.id])
            else:
                out.append(ast.unparse(node.value.elts[0]))
        return out

    return names_of(funcs["_checks"])


def test_check_names_are_the_references():
    ref = _yielded_names(REPO / "noise_ec_tpu" / "tools" / "hwcheck.py")
    port = _yielded_names(REPO / "noise_ec_tpu_torch" / "tools" /
                          "hwcheck.py")
    assert REF_ROUTE_CHECK in ref and PORT_ROUTE_CHECK in port
    assert [PORT_ROUTE_CHECK if n == REF_ROUTE_CHECK else n
            for n in ref] == port


@pytest.fixture(scope="module")
def cpu_report():
    """The report without the near-limit block (minutes on a CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hwcheck, "_near_limit_checks", lambda rig: iter(()))
        return hwcheck.run("cpu")


def test_hwcheck_passes_on_cpu_without_the_near_limit_block(cpu_report):
    failed = [c["check"] for c in cpu_report["checks"] if not c["ok"]]
    assert not failed
    assert cpu_report["ok"] and cpu_report["device"] == "cpu"
    names = [c["check"] for c in cpu_report["checks"]]
    # 34 sweep checks, tiers 2 and 3, batched, par1, the four decode
    # checks, and the two MXU encodes: the reference's 51 less its seven
    # near-limit checks.
    assert len(names) == len(set(names)) == 44
    assert "tier3 sublane kernels gf256 RS(10,4)" in names
    assert not any(n.startswith("near-limit") for n in names)
    assert names[-1] == "mxu int8 encode gf256 RS(50,20)"


def test_hwcheck_main_writes_the_report(tmp_path, monkeypatch, cpu_report,
                                        capsys):
    monkeypatch.setattr(hwcheck, "run", lambda device, log=None: cpu_report)
    out = tmp_path / "hw.json"
    assert hwcheck.main(["--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["checks"] == cpu_report["checks"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"hwcheck": "ok", "n": 44, "device": "cpu"}
    failing = dict(cpu_report, ok=False)
    monkeypatch.setattr(hwcheck, "run", lambda device, log=None: failing)
    assert hwcheck.main(["--out", str(out), "--device", "cpu"]) == 1
