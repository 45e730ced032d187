"""The whole-protein cell ``protein128.batch16``, small on the CPU: its source, a sound run, the control and the
planted faults."""

import numpy as np
import pytest

from conftest import bench

from portbench import faults, harness

CELL = "protein128.batch16"
SEED = 2**31 + 4242
# the same 64 A box as the cell's 128^3 at 0.5 A, at a CPU's size
SMALL = {"config": {"dimension": 32, "resolution": 2.0}, "traffic": {"batch": 2, "check_calls": 2}}


def test_protein_source_is_one_whole_protein_centered_on_its_mean():
    config = harness.load_json(harness.ROOT / "portbench" / "configs" / "mv10gs_protein128.json")
    source = harness.load_module(harness.BENCH_DIR / "sources" / "protein.py")
    (mol,) = source.molecules(harness.ROOT, config, SEED)
    coords, types, center = mol
    assert coords.shape == (3262, 3) and coords.dtype == np.float32
    assert types.dtype == np.int64 and not types.any() and center.dtype == np.float32
    np.testing.assert_allclose(center, coords.astype(np.float64).mean(0), atol=1e-5)
    assert source.molecules(harness.ROOT, config, SEED + 1)[0][0].tobytes() == coords.tobytes()


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    result, _ = harness.run_cell(CELL, SEED, 0.3, bool(trace), device="cpu", overrides=SMALL, bench=bench())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in bench()["per_layer" if trace else "end_to_end"] if harness.applies(m, CELL)}
    if trace:  # no device on the CPU: the readers of the card's trace return nothing
        assert set(result["metrics"]) <= names
    else:
        assert set(result["metrics"]) == names


def test_control_is_not_correct():
    result, _ = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=SMALL, variant="control",
                                 bench=bench())
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.APPLIES["batch_loop"])
def test_planted_fault_is_not_correct(fault):
    with faults.FAULTS[fault]("batch_loop"):
        result, _ = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=SMALL, bench=bench())
    assert not result["correct"], result["checks"]
