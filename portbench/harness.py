"""One run of one cell of the port's benchmark, driven by the files that name it.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
harness finds every file by name:

- ``configs/<config>.json``: the deployment (molecules, grid, channels,
  density, output dtype, augmentation);
- ``traffic/<mix>.json``: the traffic, read by ``drivers/<driver>.py``;
- ``sources/<kind>.py``: where the molecules come from;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``.

A run: set-up (imports, card, build, inputs, warm-up), the measured window,
the device's peak memory, the program's state freed, the reference's check,
and one JSON line.  ``run.py`` is the command; this module is what it and
the tests call.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
import sys
import tempfile
import time
from pathlib import Path

from . import roofline
from .spans import WINDOW, Spans

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "molvoxel_tpu")
LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}  # the control's precision
# A traced run's window lasts TRACE_SECONDS at the most: the per-layer
# metrics are means and shares that thousands of calls give steadily, and
# the trace of a whole 51 s window takes minutes and gigabytes to read.
TRACE_SECONDS = 10.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path (names may hold dots, as metric names do)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    name = f"portbench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Reservoir:
    """A sample of ``k`` items drawn from a stream of unknown length by a
    seeded generator (Algorithm R): the same seed and stream give the same
    sample."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Window:
    seconds: float  # the window's length by the host clock
    units: int  # grids completed
    calls_s: list  # each call's or step's time, entry to result ready
    attempted: int  # calls
    work: roofline.Work  # the least work of the window's calls


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Verdict:
    checks: list  # [Check]
    failed: int  # answers compared that were wrong
    pairs_per_atom: float | None  # in-cutoff pairs per atom, counted by the reference


class Context:
    """What a driver is given: the cell's files, the seed, the device, the
    spans, a scratch directory under TMPDIR and the set-up clock."""

    def __init__(self, cell: dict, config: dict, traffic: dict, limits: dict, seed: int, device: str,
                 variant: str, spans: Spans, tmpdir: Path, marks: dict, t_start: float):
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.seed, self.device, self.variant, self.spans, self.tmpdir = seed, device, variant, spans, tmpdir
        self.root, self.marks, self._last = ROOT, marks, time.perf_counter()

    def mark(self, part: str) -> None:
        """Close the set-up part ``part`` (its seconds since the last mark)."""
        now = time.perf_counter()
        self.marks[part] = self.marks.get(part, 0.0) + now - self._last
        self._last = now

    def source(self):
        return load_module(BENCH_DIR / "sources" / f"{self.config['molecules']['kind']}.py")

    def out_dtype(self) -> str:
        """The configuration's output dtype; the next lower one in a control run."""
        dt = self.config["out_dtype"]
        return LOWER[dt] if self.variant == "control" else dt

    def synchronize(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    window: Window
    timeline: object  # timeline.Timeline, or None in an untraced run
    entry_spans: tuple
    pairs_per_atom: float | None
    extra: dict


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def prepare_card(chips: int) -> None:
    """Set up the card; exits when there is no CUDA device or too few."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(2)
    torch.cuda.init()
    torch.empty(1, device="cuda")


def enable_cache() -> None:
    """Build the port's kernels and parser into one fixed directory of the checkout."""
    from molvoxel_torch.utils.timing import enable_compilation_cache

    enable_compilation_cache(CACHE_DIR / "molvoxel_torch")
    try:  # compile every missing kernel now, in parallel, rather than at first use
        from molvoxel_torch.native import build as native_build
        from molvoxel_torch.ops import _build
    except ImportError:
        return
    _build.build_all()
    native_build.build()


def power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", variant: str = "program",
             overrides: dict | None = None, bench: dict | None = None, t_start: float | None = None,
             marks: dict | None = None) -> tuple[dict, list]:
    """Run one cell; returns (result line, checks).  ``device="cpu"``,
    ``overrides`` ({"config": {...}, "traffic": {...}}) and ``bench`` (in
    place of BENCHMARK.json) serve the tests, which run a cell small on the
    CPU; ``variant`` "control" runs the configuration's next lower
    precision in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = {} if marks is None else marks
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cell, cfg_entry = find_cell(bench, name)
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[key].update(part)
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py")

    import torch

    spans = Spans(trace)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(cell, config, traffic, limits, seed, device, variant, spans, Path(tmp), marks, t_start)
        state = driver.setup(ctx)
        setup_s = time.perf_counter() - t_start
        timeline = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            from .timeline import Timeline

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
            with profile(activities=activities) as prof:
                with record_function(WINDOW):
                    window = driver.window(state, min(seconds, TRACE_SECONDS))
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
            timeline = Timeline.load(path)
            path.unlink()
        else:
            window = driver.window(state, seconds)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        extra = driver.after(state, trace)
        verdict = driver.check(state)
        del state
    run = Run(setup_s, window, timeline, driver.ENTRY_SPANS, verdict.pairs_per_atom, extra)

    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, name):
            continue
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "cpu" if device == "cpu" else "gpu",
           "kind": "cpu" if device == "cpu" else torch.cuda.get_device_name(0),
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
    if device != "cpu":
        dev["power_limit"] = power_limit()
    checks = verdict.checks
    result = {"correct": bool(checks) and all(c.ok for c in checks), "attempted": window.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = timeline.breakdown()
        result["untied_kernels"] = timeline.untied_kernels()
    if verdict.pairs_per_atom is not None:
        result["roofline_bound"] = roofline.least_seconds(window.work, verdict.pairs_per_atom)[1]
    result["setup_parts_s"] = dict(marks)
    calls = sorted(window.calls_s)
    result["calls_ms"] = {q: calls[min(len(calls) - 1, int(f * len(calls)))] * 1e3
                          for q, f in (("p10", 0.1), ("p50", 0.5), ("p90", 0.9), ("max", 1.0))} if calls else {}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    marks = {}

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _ = find_cell(bench, args.workload)
    import torch  # noqa: F401
    import molvoxel_torch  # noqa: F401

    marks["import"] = time.perf_counter() - t_start
    t = time.perf_counter()
    prepare_card(int(cell.get("chips", 1)))
    marks["card"] = time.perf_counter() - t
    t = time.perf_counter()
    enable_cache()
    marks["build"] = time.perf_counter() - t
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start, marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port's benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
