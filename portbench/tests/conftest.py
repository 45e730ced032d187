"""The benchmark's own tests, on the CPU: ``python -m pytest portbench/tests -q``.

Cells run here at a small size (``small``): the harness's look for a card
is skipped and the program runs on the CPU (its plain versions)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LIBRARY = {"kind": "library", "records": 40, "template": "portbench/data/lig_types_gaussian.npz",
           "symbols": ["C", "N", "O", "S"], "min_atoms": 20, "jitter": 0.3, "all_h_record": 7, "empty_record": 30}
SMALL = {
    "complex48.batch16": {"config": {"dimension": 16}, "traffic": {"batch": 2, "check_calls": 2}},
    "ligand64.batch64": {"config": {"dimension": 16, "molecules": LIBRARY}, "traffic": {"batch": 4, "check_calls": 2}},
}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def small():
    return SMALL
