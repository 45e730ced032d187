"""Device timing helpers on CUDA events, a torch.profiler trace, and the build directory.

``measure_device_fn`` times a warmed function with CUDA events around it:
CUDA launches return before the card finishes, so a host clock without a
synchronize measures only the enqueue.  ``trace`` records a
``torch.profiler`` Chrome trace of a block.

``enable_compilation_cache`` is the JAX package's name for where compiled
code persists.  Here that is the directory the CUDA kernels are built into
by nvcc (ops/_build.py) and the host parser by g++ (native/build.py); a
library there is reused until its source or flags change.
"""

from __future__ import annotations

import contextlib
import statistics
from collections.abc import Callable
from pathlib import Path


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
    import torch

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
    ``torch.profiler.profile`` object (``key_averages()`` for sums)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
