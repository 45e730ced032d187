"""store_dispatch_ms: the host ms a batch in the port's span ``molvoxel.stream.dispatch``: staging the
batch through the stream's pinned ring and the launches of ``voxelize_batch`` (parallel/stream.py).
"""

from portbench.store_spans import span_ms


def read(run):
    return span_ms(run, "molvoxel.stream.dispatch")
