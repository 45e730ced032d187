"""Reading the port's spans and counters of the library store path, a batch at a time.

While a torch profiler records, ``StreamingVoxelizer.run_batches`` opens
``molvoxel.stream.next``, ``.dispatch`` and ``.consume`` around each batch
(``parallel/stream.py``) and ``GridShardWriter`` opens
``molvoxel.store.copy_out`` and ``molvoxel.store.write`` and counts
``molvoxel.store_bytes`` (``data/gridstore.py``); ``snapshot()`` returns the
newest profiler session's record, in a traced run the measured window's.  A
reader returns None in an untraced run, on a port without those spans, and
unless ``molvoxel.stream.dispatch`` opened exactly once a batch of the
window (``extra["batches"]``, counted by ``drivers/store_pass.py``).
"""

from __future__ import annotations

DISPATCH = "molvoxel.stream.dispatch"


def record(run) -> dict | None:
    """The port's record of the traced window, or None."""
    batches = run.extra.get("batches")
    if run.timeline is None or not batches:
        return None
    try:
        from molvoxel_torch.utils.timing import snapshot
    except ImportError:
        return None
    snap = snapshot()
    entry = snap["spans"].get(DISPATCH)
    if entry is None or entry["count"] != batches:
        return None
    return snap


def span_ms(run, name: str) -> float | None:
    """The span's total host ms a batch; None when it never opened."""
    snap = record(run)
    if snap is None or name not in snap["spans"]:
        return None
    return snap["spans"][name]["total_s"] / run.extra["batches"] * 1e3


def counter_per_batch(run, name: str) -> float | None:
    """The counter's count a batch; None when it never counted."""
    snap = record(run)
    if snap is None or name not in snap["counters"]:
        return None
    return snap["counters"][name] / run.extra["batches"]
