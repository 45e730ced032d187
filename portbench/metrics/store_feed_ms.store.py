"""store_feed_ms: the host ms a batch that the library stream waits for its next batch (the port's span
``molvoxel.stream.next``: the SDF feeder's parse threads, assembly and queue, from the stream's side).
"""

from portbench.store_spans import span_ms


def read(run):
    return span_ms(run, "molvoxel.stream.next")
