"""api_pad_ms: the mean host ms a call in the port's span ``molvoxel.pad``: padding the
clouds into one batch (``pad_point_clouds``).
"""

from portbench.program_spans import span_ms


def read(run):
    return span_ms(run, ("molvoxel.pad",))
