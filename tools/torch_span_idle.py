"""The card's idle time by the port's innermost span, from one traced run of a benchmark cell.

    python3 tools/torch_span_idle.py --workload complex48.batch16 --seed 7 [--out build/span_idle.json]

Runs the cell as ``portbench/run.py --trace 1`` does (set-up, a traced window
of at most 10 s, the check), keeps the window's ``torch.profiler`` trace and
reads it with ``portbench/timeline.py``:

- ``idle_in_api_s``: the device's idle time while the benchmark's ``api``
  span (its call of ``forward_batch``) is open, split by the innermost
  ``molvoxel.*`` span open on that thread then (``none`` where none is);
- ``device_ops``: how many of the window's device operations (kernels,
  copies, sets) were launched inside a ``molvoxel.*`` range on the
  launching thread, with the names of those that were not;
- ``host_s``: the window's host time by innermost ``molvoxel.*`` span;
- ``counters``: the port's counters in the window (``timing.snapshot``):
  the bytes copied in, the grids' bytes, the slots sorted, ...;
- ``staging_and_plans``: the staging ring's allocations and waits and the
  launch plans built and launched in the window (0 where none counted),
  beside the window's preparations (span ``molvoxel.prepare``).

Prints one JSON line (``result`` is the run's own result line) and writes it
to ``--out`` when given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "molvoxel."


def innermost(ranges) -> list:
    """Nested (start, end, name) ranges of one thread -> disjoint sorted
    (start, end, name) pieces, each named by the innermost range over it."""
    out, stack, at = [], [], None

    def close(upto):
        nonlocal at
        if stack and at is not None and upto > at:
            out.append((at, upto, stack[-1][1]))
        at = upto if at is None else max(at, upto)

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            close(stack[-1][0])
            stack.pop()
        close(s)
        stack.append((e, name))
    while stack:
        close(stack[-1][0])
        stack.pop()
    return out


def intersect(a, b) -> list:
    """Two sorted lists of disjoint (start, end, ...) -> their overlaps
    (start, end, *a's rest)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi, *a[i][2:]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def split(events: list, tl) -> dict:
    """The idle split, the launches' share and the host time of a window's
    trace events, read beside ``tl`` (``portbench.timeline.Timeline``)."""
    from portbench.timeline import _merge

    w0, w1 = tl.window
    ours = defaultdict(list)  # tid -> [(start, end, name)]
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and ev.get("name", "").startswith(PREFIX):
            ts = float(ev["ts"])
            ours[ev.get("tid")].append((ts, ts + float(ev.get("dur", 0.0)), ev["name"]))
    api = tl.spans.get("api", [])
    tids = {tid for _, _, tid in api}
    gaps, prev = [], w0
    for s, e in tl.busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    idle_api = intersect(gaps, _merge((s, e) for s, e, _ in api))
    by_span = defaultdict(float)
    host = defaultdict(float)
    for tid in tids:
        pieces = [(max(s, w0), min(e, w1), n) for s, e, n in innermost(ours.get(tid, [])) if e > w0 and s < w1]
        for s, e, name in pieces:
            host[name] += (e - s) * 1e-6
        named = intersect(pieces, idle_api)
        for s, e, name in named:
            by_span[name] += (e - s) * 1e-6
    total_idle_api = sum(e - s for s, e in idle_api) * 1e-6
    by_span["none"] = total_idle_api - sum(by_span.values())
    outer = {tid: _merge((s, e) for s, e, _ in iv) for tid, iv in ours.items()}
    starts = {tid: [s for s, _ in iv] for tid, iv in outer.items()}
    inside, outside = 0, defaultdict(int)
    for _, name, _, _, corr in tl.device:
        launch = tl.launches.get(corr)
        ok = False
        if launch is not None and launch[1] in outer:
            ts, tid = launch
            k = bisect.bisect_right(starts[tid], ts) - 1
            ok = k >= 0 and ts <= outer[tid][k][1]
        if ok:
            inside += 1
        else:
            outside[name[:80]] += 1
    n = len(tl.device)
    return {"window_s": tl.window_s, "busy_s": tl.busy_s, "idle_s": sum(e - s for s, e in gaps) * 1e-6,
            "idle_in_api_s": total_idle_api,
            "idle_in_api_s_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "device_ops": {"total": n, "inside_molvoxel": inside, "share": inside / n if n else None,
                           "outside_by_name": dict(outside)},
            "host_s": dict(sorted(host.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import portbench.run  # noqa: F401  (its build and kernel caches under build/portbench/, as a benchmark run's)
    from portbench import harness, timeline

    kept = {}
    load = timeline.Timeline.load.__func__

    def keep(cls, path):
        with open(path) as f:
            kept["events"] = json.load(f)["traceEvents"]
        kept["timeline"] = cls(kept["events"])
        return kept["timeline"]

    timeline.Timeline.load = classmethod(keep)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _ = harness.find_cell(bench, args.workload)
    harness.prepare_card(int(cell.get("chips", 1)))
    harness.enable_cache()
    result, _ = harness.run_cell(args.workload, args.seed, args.seconds, True, t_start=t_start)
    timeline.Timeline.load = classmethod(load)
    from molvoxel_torch.utils.timing import snapshot

    snap = snapshot()
    named = ("staging_allocs", "staging_waits", "plan_builds", "plan_launches")
    line = {"workload": args.workload, "seed": args.seed, **split(kept["events"], kept["timeline"]),
            "counters": snap["counters"],
            "staging_and_plans": {**{n: snap["counters"].get(PREFIX + n, 0) for n in named},
                                  "preparations": snap["spans"].get(PREFIX + "prepare", {}).get("count", 0)},
            "result": result}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
