"""The reader of the port's launch plans, ``plan_launch_pct.grids``, on hand-made records."""

import types

from portbench import harness, program_spans

NAME = "plan_launch_pct.grids"


def read(run):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py").read(run)


def snap(prepares, launches=None):
    counters = {} if launches is None else {"molvoxel.plan_launches": launches}
    spans = {program_spans.ENTRY: {"count": 4, "total_s": 1.0, "self_s": 0.1}}
    if prepares is not None:
        spans["molvoxel.prepare"] = {"count": prepares, "total_s": 0.5, "self_s": 0.5}
    return {"spans": spans, "counters": counters}


def test_share_of_the_preparations_launched_by_plans(monkeypatch):
    run = types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(attempted=4))
    for record, want in ((snap(4, 4), 100.0), (snap(4, 1), 25.0), (snap(4), 0.0), (snap(None, 4), None),
                         (snap(0), None), (None, None)):
        monkeypatch.setattr(program_spans, "record", lambda r, record=record: record)
        assert read(run) == want


def test_none_on_a_port_without_launch_plans(monkeypatch):
    import molvoxel_torch.ops.deposit as deposit

    run = types.SimpleNamespace(timeline=True, window=types.SimpleNamespace(attempted=4))
    monkeypatch.setattr(program_spans, "record", lambda r: snap(4, 4))
    monkeypatch.delattr(deposit, "LaunchPlan")  # as the port before them
    assert read(run) is None
