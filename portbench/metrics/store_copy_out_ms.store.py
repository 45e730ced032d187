"""store_copy_out_ms: the host ms a batch in the port's span ``molvoxel.store.copy_out``: the grid
store's copy of a batch to host memory (``host_array``'s ``.cpu()``, data/gridstore.py), with its wait
for the kernels queued before it.
"""

from portbench.store_spans import span_ms


def read(run):
    return span_ms(run, "molvoxel.store.copy_out")
