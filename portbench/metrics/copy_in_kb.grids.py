"""copy_in_kb: the KiB a call that the port's entry copies to the device (its counter
``molvoxel.copy_in_bytes``: coordinates, weights, radii, mask and centers).
"""

from portbench.program_spans import counter_per_call


def read(run):
    n = counter_per_call(run, "molvoxel.copy_in_bytes")
    return None if n is None else n / 1024
