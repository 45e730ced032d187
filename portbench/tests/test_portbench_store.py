"""Whole runs of the grid store cell, small on the CPU: sound, the control, the store's planted faults."""

import ast
import types

import pytest

from conftest import ROOT, bench

from portbench import harness, store_faults, store_spans

CELL = "ligand64.store"
SEED = 2**31 + 4545
LIBRARY = {"kind": "library_sdf", "records": 72, "template": "portbench/data/lig_types_gaussian.npz",
           "symbols": ["C", "N", "O", "S"], "min_atoms": 20, "jitter": 0.3, "all_h_record": 7, "empty_record": 30}
SMALL = {"config": {"dimension": 16, "molecules": LIBRARY}, "traffic": {"batch": 16, "check_records": 4}}
NO_KERNEL = {"deposit_roofline_pct.store"}  # the CPU runs no kernel, so the roofline reader has nothing to read


def run(trace=False, variant="program"):
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu", overrides=SMALL, bench=bench(), variant=variant)


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    result, _ = run(bool(trace))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"grid_err", "store_err"}
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench()[kind] if harness.applies(m, CELL)}
    assert set(result["metrics"]) == (names - NO_KERNEL if trace else names)
    if trace:
        # every record's grid once (the padded tail's virtual grids trimmed) over the 5 batches
        assert result["metrics"]["store_mib.store"]["value"] == pytest.approx(72 * 4 * 16**3 * 2 / 5 / 2**20)


def test_control_is_not_correct():
    result, _ = run(variant="control")
    assert not result["correct"] and result["checks"]["grid_err"]["value"] > result["checks"]["grid_err"]["limit"]


@pytest.mark.parametrize("fault", sorted(store_faults.FAULTS))
def test_planted_store_fault_is_not_correct(fault):
    with store_faults.FAULTS[fault]():
        result, _ = run()
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def test_raised_voxel_is_caught_by_the_grid_comparison_alone():
    with store_faults.raised_voxel():
        result, _ = run()
    checks = result["checks"]
    assert checks["store_err"]["value"] == 0, checks
    assert checks["grid_err"]["value"] > checks["grid_err"]["limit"], checks


def test_a_short_warm_up_pass_leaves_the_run_correct():
    result, _ = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", bench=bench(),
                                 overrides={**SMALL, "traffic": {**SMALL["traffic"], "warmup_records": 20}})
    assert result["correct"] and result["failed"] == 0, result["checks"]


def test_idle_share_counts_only_the_entry_spans():
    idle = harness.load_module(ROOT / "portbench" / "metrics" / "device_idle_pct.store.py")
    # window 0-100 us; passes 10-40 and 60-90; the card busy 20-30, 35-65 and 95-100 (after the passes)
    tl = types.SimpleNamespace(window=(0.0, 100.0), spans={"api": [(10.0, 40.0, 1), (60.0, 90.0, 1)],
                                                           "readback": [(40.0, 60.0, 1)]},
                               busy=[[20.0, 30.0], [35.0, 65.0], [95.0, 100.0]])
    run_ = types.SimpleNamespace(timeline=tl, entry_spans=("api",))
    assert idle.read(run_) == pytest.approx(100.0 * (1 - (10 + 5 + 5) / 60))
    tl.spans = {}
    assert idle.read(run_) is None
    assert idle.read(types.SimpleNamespace(timeline=None, entry_spans=("api",))) is None


def test_readers_need_one_dispatch_a_batch(monkeypatch):
    import molvoxel_torch.utils.timing as timing

    run_ = types.SimpleNamespace(timeline=True, extra={"batches": 4})
    snap = {"spans": {store_spans.DISPATCH: {"count": 4, "total_s": 0.4, "self_s": 0.1},
                      "molvoxel.store.write": {"count": 5, "total_s": 0.2, "self_s": 0.2}},
            "counters": {"molvoxel.store_bytes": 4 << 20}}
    monkeypatch.setattr(timing, "snapshot", lambda: snap)
    assert store_spans.span_ms(run_, "molvoxel.store.write") == pytest.approx(50.0)
    assert store_spans.counter_per_batch(run_, "molvoxel.store_bytes") == 1 << 20
    assert store_spans.span_ms(run_, "molvoxel.stream.next") is None
    snap["spans"][store_spans.DISPATCH]["count"] = 3
    assert store_spans.span_ms(run_, "molvoxel.store.write") is None
    assert store_spans.record(types.SimpleNamespace(timeline=None, extra={"batches": 4})) is None
    monkeypatch.delattr(timing, "snapshot")  # a port without the tracer
    assert store_spans.record(run_) is None


def test_the_store_reference_imports_no_port():
    tree = ast.parse((ROOT / "portbench" / "reference" / "store.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"molvoxel_torch", *harness.FORBIDDEN}, names
