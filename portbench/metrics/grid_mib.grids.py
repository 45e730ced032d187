"""grid_mib: the MiB of grids a call's forward launches allocate and write (the port's
counter ``molvoxel.grid_bytes``, ops/deposit.py).
"""

from portbench.program_spans import counter_per_call


def read(run):
    n = counter_per_call(run, "molvoxel.grid_bytes")
    return None if n is None else n / 2**20
