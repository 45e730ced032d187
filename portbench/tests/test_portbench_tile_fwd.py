"""The reader of the port's tile route, ``tile_fwd_pct.grids``, on hand-made records and on the CPU."""

import types

import torch

from portbench import harness, program_spans

NAME = "tile_fwd_pct.grids"


def read(run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py").read(run)


def snap(deposits, tiles=None):
    counters = {} if tiles is None else {"molvoxel.fwd_tile_launches": tiles}
    spans = {program_spans.ENTRY: {"count": 4, "total_s": 1.0, "self_s": 0.1}}
    if deposits is not None:
        spans["molvoxel.deposit"] = {"count": deposits, "total_s": 0.5, "self_s": 0.5}
    return {"spans": spans, "counters": counters}


def test_share_of_the_forwards_on_the_tile_kernel(monkeypatch):
    run = types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(attempted=4))
    for record, want in ((snap(4, 4), 100.0), (snap(4, 1), 25.0), (snap(4), 0.0), (snap(None, 4), None),
                         (snap(0), None), (None, None)):
        monkeypatch.setattr(program_spans, "record", lambda r, record=record: record)
        assert read(run) == want


def test_none_on_a_port_without_the_tile_route(monkeypatch):
    import molvoxel_torch.ops.deposit as deposit

    run = types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(attempted=4))
    monkeypatch.setattr(program_spans, "record", lambda r: snap(4, 4))
    monkeypatch.delattr(deposit, "fwd_tiles")  # as the port before it
    assert read(run) is None


def test_counted_at_each_tile_launch_while_a_profiler_records(monkeypatch):
    """``_launch_fwd`` counts a tile launch, and no brick launch, only while
    a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    from molvoxel_torch.ops import deposit
    from molvoxel_torch.utils import timing

    monkeypatch.setattr(deposit, "_kernel_lib", lambda name: types.SimpleNamespace(
        deposit_fwd=lambda *a: 0, deposit_fwd_tile=lambda *a: 0))
    monkeypatch.setattr(deposit, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    out = torch.empty((1, 1, 2, 4), device="meta")
    spec = deposit.GridSpec(0.5, 2)

    def launches():
        deposit._launch_fwd(0, deposit.fwd_launch(1, 128, 1, 2, spec, True), out, 0, 0, 0)
        deposit._launch_fwd(0, deposit.fwd_launch(1, 64, 1, 2, spec, True), out, 0, 0, 0)

    launches()  # untraced: counted nowhere
    with timing.span("molvoxel.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        launches()
        launches()
    assert timing.snapshot()["counters"]["molvoxel.fwd_tile_launches"] == 2
