"""Whole runs of each cell, small on the CPU: sound, the control, planted faults, and no card."""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from conftest import bench

from portbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
CELLS = ("complex48.batch16", "ligand64.batch64")
SEED = 2**31 + 4242


def driver_of(cell):
    w = {x["name"]: x for x in bench()["workloads"]}[cell]
    return harness.load_json(BENCH / "traffic" / f"{w['traffic']}.json")["driver"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(cell, trace, small):
    result, checks = harness.run_cell(cell, SEED, 0.3, bool(trace), device="cpu", overrides=small[cell],
                                      bench=bench())
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] > 0 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench()[kind] if harness.applies(m, cell)}
    if not trace:
        assert set(result["metrics"]) == names
    else:  # no device on the CPU: the readers of the card's trace return nothing
        assert set(result["metrics"]) <= names and result["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, small):
    result, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small[cell], variant="control",
                                 bench=bench())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.APPLIES[driver_of(c)]])
def test_planted_fault_is_not_correct(cell, fault, small):
    with faults.FAULTS[fault](driver_of(cell)):
        result, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small[cell], bench=bench())
    assert not result["correct"], result["checks"]


def test_run_without_a_card_fails():
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "complex48.batch16", "--seed",
                           str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and "{" not in proc.stdout


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_and_the_reference_imports_no_port():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "molvoxel_torch" not in _imports(path), path


def test_a_run_loads_no_jax(small):
    code = ("import json, sys; sys.path[:0] = [%r, %r]; from portbench import harness; from conftest import bench; "
            "harness.run_cell('complex48.batch16', 3, 0.3, True, device='cpu', overrides=json.loads(%r), "
            "bench=bench()); print(json.dumps(harness.forbidden_modules()))") % (str(ROOT), str(Path(__file__).parent),
                                                                 json.dumps(small["complex48.batch16"]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_ends_its_window_at_the_trace(cell, small, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    t0 = time.perf_counter()
    result, _ = harness.run_cell(cell, SEED, 30.0, True, device="cpu", overrides=small[cell], bench=bench())
    assert result["correct"], result["checks"]
    assert 0.2 <= result["device"]["window_s"] < 2.0 and time.perf_counter() - t0 < 25.0
