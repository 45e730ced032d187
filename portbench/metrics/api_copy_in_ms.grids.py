"""api_copy_in_ms: the mean host ms a call in the port's span ``molvoxel.copy_in``: the
host-to-device copies of the batch's coordinates, weights, radii, mask and centers.
"""

from portbench.program_spans import span_ms


def read(run):
    return span_ms(run, ("molvoxel.copy_in",))
