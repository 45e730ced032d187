"""The port's host spans and counters (molvoxel_torch/utils/timing.py), on the CPU.

Spans record only while a torch profiler records: then each is a
``record_function`` range in the profiler's trace and a count, total and
self time in ``timing.snapshot()``; otherwise a span checks one flag and
does nothing else.
"""

import contextlib
import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import molvoxel_torch
from molvoxel_torch.core.config import GridSpec, small_atom_bucket
from molvoxel_torch.ops import deposit
from molvoxel_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
API_SPANS = ("molvoxel.forward_batch", "molvoxel.channels", "molvoxel.pad", "molvoxel.copy_in")
BENCHMARK_SPANS = {"api", "sync", "inputs", "window"}  # portbench/spans.py matches these by name
B, V, C, DIM = 3, 32, 3, 16


def clouds(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(scale=1.5, size=(V, 3)).astype(np.float32), rng.integers(0, C, V)) for _ in range(B)]


def voxelizer():
    return molvoxel_torch.create_voxelizer(resolution=0.5, dimension=DIM, device="cpu")


def call(vox, k=0, centers=True):
    return vox.forward_batch(clouds(k), random_rotation=True, random_translation=0.5, key=k, num_channels=C,
                             centers=[np.zeros(3)] * B if centers else None)


@contextlib.contextmanager
def cpu_profile():
    """A CPU profiler session with a record of its own: the span before it
    finds no profiler, so the session's first span starts a new record."""
    with timing.span("molvoxel.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


class FakeClock:
    """``perf_counter`` of a clock that moves only when told."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def test_no_profiler_records_nothing_and_builds_no_range(monkeypatch):
    vox = voxelizer()
    call(vox)
    before, launches = timing.snapshot(), dict(deposit.launches)

    def forbidden(*a, **k):
        raise AssertionError("a span did work while no profiler recorded")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(timing, "_range_enter", forbidden)
    monkeypatch.setattr(timing, "time", type("NoClock", (), {"perf_counter": staticmethod(forbidden)}))
    assert not timing.recording()
    out = call(vox, 1)
    assert out.shape == (B, C, DIM, DIM, DIM)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(torch.zeros(1, 64, 3), torch.ones(1, 64, 1), 1.0,
                                                           spec=GridSpec(0.5, 8))
    from molvoxel_torch.ops.autodiff import deposit as autodiff_deposit

    autodiff_deposit(rows, wt, ranges, spec=GridSpec(0.5, 8), dl=dl, gaussian=gaussian)
    timing.count("molvoxel.copy_in_bytes", 5)
    assert timing.snapshot() == before and deposit.launches == launches


def test_profiled_calls_count_each_api_span():
    vox = voxelizer()
    with cpu_profile():
        call(vox, 0)
        call(vox, 1)
    spans = timing.snapshot()["spans"]
    for name in API_SPANS + ("molvoxel.voxelize_batch",):
        assert spans[name]["count"] == 2, name
        assert 0.0 <= spans[name]["self_s"] <= spans[name]["total_s"], name
    top = spans["molvoxel.forward_batch"]
    children = sum(spans[n]["total_s"] for n in API_SPANS[1:] + ("molvoxel.voxelize_batch",))
    assert top["self_s"] == pytest.approx(top["total_s"] - children, abs=1e-9)
    assert "molvoxel.prepare" not in spans  # the CPU batch runs the plain dense path


def test_kernel_host_spans_on_the_plain_preparation_and_deposit():
    """``prepare_batch`` and the differentiable deposit (CPU tensors run
    their plain versions) open ``molvoxel.prepare`` and ``molvoxel.deposit``
    beside each other inside the batch layer's span."""
    coords = torch.randn(2, 64, 3)
    with cpu_profile():
        with timing.span("molvoxel.voxelize_batch"):
            deposit.voxelize_deposit_batch(coords, torch.ones(2, 64, 1), 1.0, spec=GridSpec(0.5, 8))
    spans = timing.snapshot()["spans"]
    assert spans["molvoxel.prepare"]["count"] == spans["molvoxel.deposit"]["count"] == 1
    outer = spans["molvoxel.voxelize_batch"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - spans["molvoxel.prepare"]["total_s"] - spans["molvoxel.deposit"]["total_s"], abs=1e-9)


def test_chrome_trace_holds_the_spans_inside_the_callers_range(tmp_path):
    vox = voxelizer()
    with cpu_profile() as prof:
        with record_function("caller"):
            call(vox)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    caller = [e for e in events if e["name"] == "caller"]
    ours = {e["name"]: e for e in events if e["name"].startswith("molvoxel.")}
    assert set(ours) == set(API_SPANS) | {"molvoxel.voxelize_batch"}
    assert len(caller) == 1 and all(e["cat"] == "user_annotation" for e in ours.values())

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    top = ours["molvoxel.forward_batch"]
    assert inside(top, caller[0]) and all(inside(e, top) for e in ours.values())


def test_no_program_span_takes_a_benchmark_name():
    vox = voxelizer()
    with cpu_profile():
        call(vox)
        deposit.voxelize_deposit_batch(torch.randn(1, 64, 3), torch.ones(1, 64, 1), 1.0, spec=GridSpec(0.5, 8))
    names = set(timing.snapshot()["spans"])
    written = set()
    for path in (ROOT / "molvoxel_torch").rglob("*.py"):
        written |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", path.read_text()))
    assert names <= written and len(written) >= 7
    for name in written:
        assert name.startswith("molvoxel.") and name not in BENCHMARK_SPANS and name.split(".")[-1] not in (
            BENCHMARK_SPANS), name


def test_self_time_of_nested_spans(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    with cpu_profile():
        with timing.span("molvoxel.a"):
            clock.t += 2.0
            with timing.span("molvoxel.b"):
                clock.t += 3.0
                with timing.span("molvoxel.c"):
                    clock.t += 1.0
                clock.t += 0.5
            with timing.span("molvoxel.c"):
                clock.t += 0.25
    spans = timing.snapshot()["spans"]
    assert spans["molvoxel.a"] == {"count": 1, "total_s": 6.75, "self_s": 2.0}
    assert spans["molvoxel.b"] == {"count": 1, "total_s": 4.5, "self_s": 3.5}
    assert spans["molvoxel.c"] == {"count": 2, "total_s": 1.25, "self_s": 1.25}


def test_snapshot_covers_the_newest_session_alone(tmp_path):
    vox = voxelizer()
    call(vox, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        call(vox, 0)
        call(vox, 1)
        timing.count("molvoxel.test_only", 3)
    assert timing.snapshot()["spans"]["molvoxel.forward_batch"]["count"] == 2
    call(vox, 2)  # untraced, between the sessions
    assert timing.snapshot()["spans"]["molvoxel.forward_batch"]["count"] == 2  # readable after its session
    with profile(activities=[ProfilerActivity.CPU]):
        call(vox, 3)
    snap = timing.snapshot()
    assert snap["spans"]["molvoxel.forward_batch"]["count"] == 1 and "molvoxel.test_only" not in snap["counters"]
    with timing.trace(str(tmp_path / "trace.json")):  # trace() starts a record of its own, with no call before it
        call(vox, 4)
        call(vox, 5)
    assert timing.snapshot()["spans"]["molvoxel.forward_batch"]["count"] == 2


def test_copy_in_bytes_of_a_known_batch():
    assert small_atom_bucket(V) == V
    vox = voxelizer()
    with cpu_profile():
        call(vox, 0, centers=True)
    with_centers = timing.snapshot()["counters"]["molvoxel.copy_in_bytes"]
    # coords (B, V, 3) f32, one-hot weights (B, V, C) f32, radii (V,) f32, mask (B, V) bool, centers (B, 3) f32,
    # the drawn transforms' table (B, 12) f32
    assert with_centers == B * V * 3 * 4 + B * V * C * 4 + V * 4 + B * V + B * 3 * 4 + B * 12 * 4
    call(vox, 1)
    with cpu_profile():
        call(vox, 0, centers=False)
        call(vox, 1, centers=False)
    assert timing.snapshot()["counters"]["molvoxel.copy_in_bytes"] == 2 * (with_centers - B * 3 * 4)


def test_spans_on_two_threads_do_not_parent_each_other():
    with cpu_profile():
        with timing.span("molvoxel.main"):
            def work():
                with timing.span("molvoxel.worker"):
                    time.sleep(0.05)

            t = threading.Thread(target=work)
            t.start()
            t.join()
    spans = timing.snapshot()["spans"]
    assert spans["molvoxel.worker"]["count"] == 1 and spans["molvoxel.worker"]["total_s"] >= 0.05
    main = spans["molvoxel.main"]
    assert main["self_s"] == main["total_s"] >= 0.05


def test_spans_and_counts_from_many_threads_lose_no_update():
    """Many threads, switching often, each opening spans and counting: the
    record's counts add up."""
    import sys

    threads, rounds = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            def work():
                for _ in range(rounds):
                    with timing.span("molvoxel.outer"):
                        with timing.span("molvoxel.inner"):
                            timing.count("molvoxel.events", 2)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    snap = timing.snapshot()
    assert snap["spans"]["molvoxel.outer"]["count"] == snap["spans"]["molvoxel.inner"]["count"] == threads * rounds
    assert snap["counters"]["molvoxel.events"] == 2 * threads * rounds
    outer, inner = snap["spans"]["molvoxel.outer"], snap["spans"]["molvoxel.inner"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], rel=1e-6, abs=1e-9)


def test_the_profiler_flag_follows_a_cpu_session():
    """The tracer reads ``torch.autograd.profiler._is_profiler_enabled``; a
    torch that moves it fails here rather than leaving tracing off."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert torch.autograd.profiler._is_profiler_enabled is False and timing.recording() is False
    with cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled is True and timing.recording() is True
    assert torch.autograd.profiler._is_profiler_enabled is False and timing.recording() is False


def test_launches_are_the_tracers_counters():
    """``deposit.launches`` is the tracer's one launch counter, under its old
    names; a profiler session keeps no second count of launches."""
    assert deposit.launches is timing.launches and deposit.reset_launches is timing.reset_launches
    assert set(deposit.launches) == {"deposit_prep", "deposit_fwd", "deposit_bwd", "deposit_fwd_tile",
                                     "deposit_bwd_notrunc"}
    saved = dict(deposit.launches)
    try:
        with cpu_profile():
            call(voxelizer())
        assert not any(name.startswith("molvoxel.launches") for name in timing.snapshot()["counters"])
        deposit.launches["deposit_fwd"] += 2
        deposit.reset_launches()
        assert set(deposit.launches.values()) == {0}
    finally:
        deposit.launches.update(saved)


def test_span_idle_tool_splits_idle_time_by_the_innermost_span():
    """tools/torch_span_idle.py on a hand-made trace: two calls inside the
    benchmark's ``api`` span, three device operations, one of them launched
    outside every ``molvoxel.*`` range."""
    import importlib.util

    from portbench.timeline import Timeline

    spec = importlib.util.spec_from_file_location("torch_span_idle", ROOT / "tools" / "torch_span_idle.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def x(cat, name, ts, end, tid=1, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}
        return ev if corr is None else dict(ev, args={"correlation": corr})

    events = [x("user_annotation", "window", 0, 100), x("user_annotation", "api", 10, 40),
              x("user_annotation", "api", 50, 90), x("user_annotation", "molvoxel.forward_batch", 11, 39),
              x("user_annotation", "molvoxel.channels", 12, 15),
              x("user_annotation", "molvoxel.voxelize_batch", 20, 38),
              x("user_annotation", "molvoxel.prepare", 21, 30), x("user_annotation", "molvoxel.forward_batch", 51, 89),
              x("cuda_runtime", "cudaMemcpyAsync", 16, 16.2, corr=2), x("gpu_memcpy", "Memcpy HtoD", 16.5, 18, 7, 2),
              x("cuda_runtime", "cudaLaunchKernel", 25, 25.5, corr=1), x("kernel", "prep", 26, 35, 7, 1),
              x("cuda_runtime", "cudaLaunchKernel", 45, 45.5, corr=3), x("kernel", "stray", 60, 70, 7, 3)]
    out = tool.split(events, Timeline(events))
    us = {k: round(v * 1e6, 6) for k, v in out["idle_in_api_s_by_span"].items()}
    assert us == {"molvoxel.forward_batch": 33.5, "molvoxel.channels": 3.0, "molvoxel.voxelize_batch": 4.0,
                  "molvoxel.prepare": 5.0, "none": 4.0}
    assert round(out["idle_in_api_s"] * 1e6, 6) == 49.5 and round(out["busy_s"] * 1e6, 6) == 20.5
    assert out["device_ops"] == {"total": 3, "inside_molvoxel": 2, "share": 2 / 3, "outside_by_name": {"stray": 1}}
    assert round(out["host_s"]["molvoxel.prepare"] * 1e6, 6) == 9.0
