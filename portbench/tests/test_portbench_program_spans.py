"""The readers of the port's own spans and counters, in whole runs of each cell, small on the CPU."""

import types

import pytest

from conftest import bench

from portbench import harness, program_spans

CELLS = ("complex48.batch16", "ligand64.batch64")
SEED = 2**31 + 4343
TIMES = ("api_channels_ms.grids", "api_pad_ms.grids", "api_copy_in_ms.grids", "api_self_ms.grids",
         "batch_host_ms.grids")
NEW = TIMES + ("copy_in_kb.grids", "kernels_host_ms.grids")


def read(name, run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py").read(run)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_spans(cell, small):
    result, _ = harness.run_cell(cell, SEED, 0.3, True, device="cpu", overrides=small[cell], bench=bench())
    metrics = result["metrics"]
    assert result["correct"], result["checks"]
    for name in TIMES + ("copy_in_kb.grids",):
        assert metrics[name]["value"] > 0, name
    assert "kernels_host_ms.grids" not in metrics  # no kernel runs on the CPU
    snap = program_spans.record(types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(
        attempted=result["attempted"])))
    entry_ms = snap["spans"][program_spans.ENTRY]["total_s"] / result["attempted"] * 1e3
    assert sum(metrics[n]["value"] for n in TIMES) == pytest.approx(entry_ms, rel=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_none_of_them(cell, small):
    result, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small[cell], bench=bench())
    assert result["correct"] and not set(result["metrics"]) & set(NEW)


def test_readers_return_none_without_the_tracer_or_on_a_count_that_disagrees(monkeypatch):
    run = types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(attempted=3))
    monkeypatch.setattr(program_spans, "record", lambda r: None)
    assert all(read(n, run) is None for n in NEW)
    monkeypatch.undo()
    import molvoxel_torch.utils.timing as timing

    monkeypatch.setattr(timing, "snapshot", lambda: {"spans": {program_spans.ENTRY: {
        "count": 2, "total_s": 1.0, "self_s": 0.5}}, "counters": {"molvoxel.copy_in_bytes": 2048}})
    assert all(read(n, run) is None for n in NEW)
    monkeypatch.delattr(timing, "snapshot")  # a port without the tracer, as the parent of the tracer is
    assert all(read(n, run) is None for n in NEW)
