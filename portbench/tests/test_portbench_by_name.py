"""A configuration, a traffic mix, a cell and a per-layer metric added as new files are found by name."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def digests(top: Path) -> dict:
    return {p.relative_to(top): hashlib.sha1(p.read_bytes()).hexdigest() for p in top.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = digests(copy / "portbench")
    pb = copy / "portbench"
    cfg = json.loads((pb / "configs" / "mv10gs_complex48.json").read_text())
    cfg.update(dimension=12, out_dtype="bfloat16", random_translation=0.5)
    (pb / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "new_mix.json").write_text(json.dumps({"driver": "batch_loop", "batch": 3, "check_calls": 1}))
    (pb / "limits" / "new_cfg.new_mix.json").write_text(json.dumps({"grid_err": 0.02}))
    (pb / "metrics" / "calls_seen.new.py").write_text("def read(run):\n    return float(run.window.attempted)\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new_cfg", "source": "a test", "file": "portbench/configs/new_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg", "traffic": "new_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_seen.new", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "API (api/voxelizer.py)", "moves": "grids_per_s",
                               "workloads": ["new_cfg.new_mix"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path[:0] = [%r, %r]; from portbench import harness; "
            "assert harness.ROOT == __import__('pathlib').Path(%r); "
            "r, _ = harness.run_cell('new_cfg.new_mix', 5, 0.3, True, device='cpu'); print(json.dumps(r))"
            ) % (str(copy), str(ROOT), str(copy))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["calls_seen.new"]["value"] == result["attempted"]
    after = digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before  # no file that was there changed
