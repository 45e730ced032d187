"""store_write_ms: the host ms a batch in the port's span ``molvoxel.store.write``: the files the grid
store writes (each shard, ``num_atoms.npy`` and the manifest; data/gridstore.py).
"""

from portbench.store_spans import span_ms


def read(run):
    return span_ms(run, "molvoxel.store.write")
