"""Reads a ``torch.profiler`` Chrome trace of the measured window.

- ``busy_s``: the union of every device operation (kernels, copies, sets)
  inside the window; ``window_s``: the window's length.
- ``kernel_seconds_in(spans)``: the device time of every kernel whose launch
  (the runtime or driver call with the same correlation id) lies inside one
  of the named host spans on the launching thread, whatever the kernel's
  name.
- ``mean_span_ms(name)``: the mean host time of a span.
- ``breakdown()``: the device operations that took most time, by name, and
  the device's idle time by the host span open during it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .spans import NAMES, WINDOW

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    def __init__(self, events: list[dict]):
        spans = defaultdict(list)  # name -> [(start, end, tid)]
        launches = {}  # correlation id -> (ts, tid)
        device = []  # (cat, name, start, end, correlation)
        window = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            ts = float(ev.get("ts", 0.0))
            end = ts + float(ev.get("dur", 0.0))
            if cat == "user_annotation":
                name = ev.get("name")
                if name == WINDOW:
                    window = (ts, end)
                elif name in NAMES:
                    spans[name].append((ts, end, ev.get("tid")))
            elif cat in LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, ev.get("tid"))
            elif cat in DEVICE_CATS:
                device.append((cat, ev.get("name", ""), ts, end, (ev.get("args") or {}).get("correlation")))
        if window is None:
            raise ValueError("the trace holds no window span")
        self.window = window
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.launches = launches
        w0, w1 = window
        self.device = [d for d in device if d[3] > w0 and d[2] < w1]
        self.busy = _merge((max(s, w0), min(e, w1)) for _, _, s, e, _ in self.device)

    @classmethod
    def load(cls, path) -> "Timeline":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def mean_span_ms(self, name: str) -> float | None:
        w0, w1 = self.window
        durs = [e - s for s, e, _ in self.spans.get(name, ()) if s >= w0 and e <= w1]
        return sum(durs) / len(durs) * 1e-3 if durs else None

    def kernel_seconds_in(self, names) -> float:
        by_tid = defaultdict(list)
        for name in names:
            for s, e, tid in self.spans.get(name, ()):
                by_tid[tid].append((s, e))
        starts = {tid: sorted(iv) for tid, iv in by_tid.items()}
        keys = {tid: [s for s, _ in iv] for tid, iv in starts.items()}
        total = 0.0
        for cat, _, s, e, corr in self.device:
            launch = self.launches.get(corr)
            if cat != "kernel" or launch is None or launch[1] not in starts:
                continue
            ts, tid = launch
            i = bisect.bisect_right(keys[tid], ts) - 1
            if i >= 0 and ts <= starts[tid][i][1]:
                total += e - s
        return total * 1e-6

    def untied_kernels(self) -> int:
        """Kernels in the window whose launch the trace does not show."""
        return sum(1 for cat, _, _, _, corr in self.device if cat == "kernel" and corr not in self.launches)

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for _, name, s, e, _ in self.device:
            by_name[name] += (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        # idle time, by the host span open during it (spans of every thread)
        gaps, prev = [], self.window[0]
        for s, e in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if prev < self.window[1]:
            gaps.append((prev, self.window[1]))
        # the benchmark's spans follow one another on its one thread
        host = sorted((s, e, name) for name, iv in self.spans.items() for s, e, _ in iv)
        idle = defaultdict(float)
        first = 0
        for g0, g1 in gaps:
            while first < len(host) and host[first][1] <= g0:
                first += 1
            covered = []
            j = first
            while j < len(host) and host[j][0] < g1:
                s, e, name = host[j]
                j += 1
                lo, hi = max(s, g0), min(e, g1)
                if hi > lo:
                    idle[name] += (hi - lo) * 1e-6
                    covered.append((lo, hi))
            idle["other"] += ((g1 - g0) - sum(e - s for s, e in _merge(covered))) * 1e-6
        gap_list = sorted(((k, v) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gap_list]}
