"""api_channels_ms: the mean host ms a call in the port's span ``molvoxel.channels``: the
clouds' host conversions and one-hot channels (api/voxelizer.py).
"""

from portbench.program_spans import span_ms


def read(run):
    return span_ms(run, ("molvoxel.channels",))
