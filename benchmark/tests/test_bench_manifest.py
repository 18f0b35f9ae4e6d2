"""The benchmark's manifest and files: names and units, the files each cell
needs, the metrics each cell reports, and what its modules may import.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark.common import BENCH, FORBIDDEN, ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "sph_sm_monodomain_tpu_torch"


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in _metrics()])
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(m["bound"] <= 0.25 for m in MAN["end_to_end"])
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    confs = {c["name"]: c for c in MAN["configs"]}
    conf = json.loads((ROOT / confs[cell["config"]]["file"]).read_text())
    assert (ROOT / conf["cloud"]).is_file()
    traffic = json.loads((BENCH / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    checks = json.loads((BENCH / "checks"
                         / f"{cell['name']}.json").read_text())
    assert checks["limits"]


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_reports_what_its_layers_move(cell):
    name = cell["name"]
    e2e = {m["name"] for m in MAN["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in MAN["per_layer"]
              if name in m.get("workloads", [name])]
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_a_reference_apart(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN), tops
    if "reference" in path.relative_to(BENCH).parts:
        assert PORT not in tops and "benchmark" not in tops


def test_a_run_loads_no_jax():
    """Everything a run imports, the package's modules included, loads no
    module whose top-level name is forbidden (names compared whole)."""
    code = ("import sys, benchmark.run, benchmark.control, "
            "benchmark.drivers.protocol, benchmark.drivers.wave, "
            f"{PORT}.models.monodomain, {PORT}.models.variants, "
            f"{PORT}.utils.io; from benchmark.common import "
            "forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_nothing(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cell = MAN["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
