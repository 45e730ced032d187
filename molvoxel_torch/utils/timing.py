"""Device timing helpers on CUDA events, a torch.profiler trace, the port's
host spans and counters, and the build directory.

``measure_device_fn`` times a warmed function with CUDA events around it:
CUDA launches return before the card finishes, so a host clock without a
synchronize measures only the enqueue.  ``trace`` records a
``torch.profiler`` Chrome trace of a block.

``span`` and ``count`` are the port's own tracing: named host ranges
(``molvoxel.*``) around the stages of its entry points, and counters.  They
are on exactly while a torch profiler records (``trace``, or any
``torch.profiler.profile``), and then each span is also a range in the
profiler's trace (a ``user_annotation``, as ``record_function`` makes), on
its clock, beside the kernels and copies it launched.  With no profiler recording a span checks
one flag and returns a shared no-op: it builds no range, reads no clock and
records nothing.  ``snapshot`` returns the newest profiler session's
record: each span's count, total and self seconds (the total less the part
its child spans on the same thread cover) and each counter.  ``launches``
counts every kernel launch by entry point whether or not a profiler
records (ops/deposit.py).

``enable_compilation_cache`` is the JAX package's name for where compiled
code persists.  Here that is the directory the CUDA kernels are built into
by nvcc (ops/_build.py) and the host parser by g++ (native/build.py); a
library there is reused until its source or flags change.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections.abc import Callable
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler


def enable_compilation_cache(path: str | Path | None = None) -> Path:
    """Build (and look for) the CUDA kernels and the host parser in
    ``path``; None points both back at the default, ``build/molvoxel_torch/``
    beside the package (listed in .gitignore).  Returns the directory.
    Libraries already loaded in this process stay loaded."""
    from ..native import build as native_build
    from ..ops import _build

    target = _build.DEFAULT_BUILD_DIR if path is None else Path(path)
    _build.BUILD_DIR = native_build.BUILD_DIR = target
    return target


def measure_device_fn(step: Callable, *, iters: int = 33, repeats: int = 3, key=None) -> float:
    """Seconds per call of ``step(i)`` on the card: after two warm-up calls,
    ``repeats`` runs of ``iters`` back-to-back calls, each run timed with a
    CUDA event pair; the median run's time over ``iters``.

    ``step`` gets the call's index (so it can draw fresh inputs, as the JAX
    package's fresh PRNG keys do) and its output is not read back.  ``key``
    is an int offset for those indices.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_device_fn times on the card: no CUDA device is available")
    base = 0 if key is None else int(key)
    step(base)
    step(base + 1)
    torch.cuda.synchronize()
    times = []
    for r in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            step(base + 2 + r * iters + i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(times)


@contextlib.contextmanager
def trace(path: str = "molvoxel_torch_trace.json"):
    """Context manager: profile the block on the CPU and the card and write
    a Chrome trace (chrome://tracing, Perfetto) to ``path``.  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` for sums); the
    port's spans and counters record inside it, from a fresh record
    (``snapshot``)."""
    from torch.profiler import ProfilerActivity, profile

    global _idle
    _idle = True
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


# ------------------------------------------------------------------ tracing

def recording() -> bool:
    """True while a torch profiler records: the flag the spans read
    (``torch.autograd.profiler._is_profiler_enabled``, the one torch's own
    ``record_function`` reads)."""
    return _profiler._is_profiler_enabled


# A span's range in the profiler's trace: the user-scope range
# ``record_function`` opens, without its trip through the dispatcher
# (``profiler::_record_function_enter_new``, itself a profiled op), which
# costs a range several times over under a profiler.
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


launches: dict[str, int] = {}  # kernel launches by entry point, counted whether or not a profiler records

_lock = threading.Lock()
_local = threading.local()  # each thread's open spans, innermost last
_record = ({}, {})  # the newest session's spans {name: [count, total_s, self_s]} and counters {name: n}
_idle = True  # the last span or count found no profiler: the next that finds one starts a session


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _session() -> tuple[dict, dict]:
    """The record to add to, a fresh one at a session's first event."""
    global _record, _idle
    if _idle:
        with _lock:
            if _idle:
                _record, _idle = ({}, {}), False
    return _record


class _Span:
    """A recording span.  Its clock runs from before its range opens to after
    it closes, so its own cost of tracing falls in its total and not in its
    parent's self time."""

    __slots__ = ("name", "handle", "start", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = time.perf_counter()
        _session()
        self.inner = 0.0
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.handle = _range_enter(self.name)
        return self

    def __exit__(self, *exc):
        _range_exit(self.handle)
        stack = _local.stack
        stack.pop()
        total = time.perf_counter() - self.start
        if stack:
            stack[-1].inner += total
        spans = _record[0]
        with _lock:
            entry = spans.get(self.name)
            if entry is None:
                entry = spans[self.name] = [0, 0.0, 0.0]
            entry[0] += 1
            entry[1] += total
            entry[2] += total - self.inner
        return False


def span(name: str):
    """Context manager: the host range ``name`` while a torch profiler
    records (a user range in its trace, and its count, total and self
    seconds in the session's record); a shared no-op otherwise.  Spans nest
    per thread: a span's parent is the innermost span open on its own
    thread."""
    global _idle
    if not _profiler._is_profiler_enabled:
        _idle = True
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the session's counter ``name`` while a torch profiler
    records; nothing otherwise."""
    global _idle
    if not _profiler._is_profiler_enabled:
        _idle = True
        return
    counters = _session()[1]
    with _lock:
        counters[name] = counters.get(name, 0) + int(n)


def reset_launches() -> None:
    """Set every kernel's count in ``launches`` to 0."""
    for name in launches:
        launches[name] = 0


def snapshot() -> dict:
    """The newest profiler session's record: ``{"spans": {name: {"count",
    "total_s", "self_s"}}, "counters": {name: n}}``.  A record starts at
    the first span or count that finds a profiler recording after one that
    found none (or inside ``trace``), and stays readable after the profiler
    stops: two sessions with no span or count between them share one."""
    spans, counters = _record
    with _lock:
        return {"spans": {k: {"count": c, "total_s": t, "self_s": s} for k, (c, t, s) in spans.items()},
                "counters": dict(counters)}
