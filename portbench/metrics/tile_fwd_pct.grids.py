"""tile_fwd_pct: the share of the window's forward launches (the port's span ``molvoxel.deposit``) that took
the tile kernel of deposit_fwd.cu (its counter ``molvoxel.fwd_tile_launches``, ops/deposit.py ``_launch_fwd``:
molecules of more than one chunk), in %.  None untraced, where no forward opened, and on a port without the
tile route.
"""

from portbench.program_spans import record


def read(run):
    snap = record(run)
    deposits = None if snap is None else snap["spans"].get("molvoxel.deposit", {}).get("count")
    if not deposits:
        return None
    try:
        from molvoxel_torch.ops.deposit import fwd_tiles  # noqa: F401  (the port routes forwards by chunks)
    except ImportError:
        return None
    return 100.0 * snap["counters"].get("molvoxel.fwd_tile_launches", 0) / deposits
