"""plan_launch_pct: the share of the window's preparations (the port's span ``molvoxel.prepare``) launched
through a launch plan (its counter ``molvoxel.plan_launches``, ops/deposit.py ``LaunchPlan``: the kernels'
launches for inputs that need no gradient, with no autograd Function), in %.  None untraced, where no
preparation opened, and on a port without launch plans.
"""

from portbench.program_spans import record


def read(run):
    snap = record(run)
    prepared = None if snap is None else snap["spans"].get("molvoxel.prepare", {}).get("count")
    if not prepared:
        return None
    try:
        from molvoxel_torch.ops.deposit import LaunchPlan  # noqa: F401  (the port has launch plans)
    except ImportError:
        return None
    return 100.0 * snap["counters"].get("molvoxel.plan_launches", 0) / prepared
