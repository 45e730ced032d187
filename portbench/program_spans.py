"""Reading the port's own spans and counters (``molvoxel_torch.utils.timing``).

While a torch profiler records, the port keeps each of its ``molvoxel.*``
spans' count, total and self host seconds, and its counters;
``snapshot()`` returns the newest profiler session's record, which in a
traced run is the measured window's.  A reader returns None in an untraced
run, on a port without that tracer, and unless the entry span
``molvoxel.forward_batch`` opened exactly once a call of the window.
"""

from __future__ import annotations

ENTRY = "molvoxel.forward_batch"


def record(run) -> dict | None:
    """The port's record of the traced window, or None."""
    if run.timeline is None or not run.window.attempted:
        return None
    try:
        from molvoxel_torch.utils.timing import snapshot
    except ImportError:
        return None
    snap = snapshot()
    entry = snap["spans"].get(ENTRY)
    if entry is None or entry["count"] != run.window.attempted:
        return None
    return snap


def span_ms(run, names, part: str = "total_s") -> float | None:
    """The spans' summed ``part`` ("total_s" or "self_s") in ms a call; None
    when none of them opened."""
    snap = record(run)
    found = [] if snap is None else [snap["spans"][n][part] for n in names if n in snap["spans"]]
    return sum(found) / run.window.attempted * 1e3 if found else None


def counter_per_call(run, name: str) -> float | None:
    """The counter's count a call; None when it never counted."""
    snap = record(run)
    if snap is None or name not in snap["counters"]:
        return None
    return snap["counters"][name] / run.window.attempted
