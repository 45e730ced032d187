"""batch_host_ms: the mean host ms a call of ``molvoxel.voxelize_batch`` (ops/batch.py) outside
its child spans: the batching and dispatch layer, with the transforms' draw.
"""

from portbench.program_spans import span_ms


def read(run):
    return span_ms(run, ("molvoxel.voxelize_batch",), "self_s")
