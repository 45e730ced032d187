"""store_mib: the MiB of shards the grid store writes a batch (the port's counter
``molvoxel.store_bytes``, data/gridstore.py).
"""

from portbench.store_spans import counter_per_batch


def read(run):
    n = counter_per_batch(run, "molvoxel.store_bytes")
    return None if n is None else n / 2**20
