"""Faults planted in the grid store's writer, each in a ``with`` block, for the store cells.

Each breaks one guarantee of the configuration; the tests plant them in
small runs on the CPU, and ``tools/torch_store_faults.py`` at the cell's own
size on the card, and ``correct`` must come out false:

- ``raised_voxel``: one voxel of every grid with an atom raised by 1 in
  ``append`` (every such grid, since the check reads records drawn from the
  seed); the records with no atom stay zero grids, so the store's structure
  holds and only the grid comparison can catch it;
- ``last_batch_lost``: every batch appended one call late, so the last batch
  is never written;
- ``empty_slot_dropped``: the slots of records with no atom dropped from
  ``num_atoms``;
- ``manifest_not_final``: every manifest written with ``final: false``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(name, make):
    from molvoxel_torch.data.gridstore import GridShardWriter

    old = getattr(GridShardWriter, name)
    setattr(GridShardWriter, name, make(old))
    try:
        yield
    finally:
        setattr(GridShardWriter, name, old)


def raised_voxel():
    def make(old):
        def append(self, images, num_atoms=None):
            c = images.shape[-1] // 2
            images = images.clone()
            images[torch.as_tensor(np.asarray(num_atoms) > 0, device=images.device), 0, c, c, c] += 1
            old(self, images, num_atoms)
        return append
    return _patched("append", make)


def last_batch_lost():
    def make(old):
        def append(self, images, num_atoms=None):
            held = getattr(self, "_held_batch", None)
            self._held_batch = (images, num_atoms)
            if held is not None:
                old(self, *held)
        return append
    return _patched("append", make)


def empty_slot_dropped():
    def make(old):
        def append(self, images, num_atoms=None):
            atoms = np.asarray(num_atoms)
            old(self, images, atoms[atoms > 0])
        return append
    return _patched("append", make)


def manifest_not_final():
    return _patched("_write_manifest", lambda old: lambda self, n, *, final: old(self, n, final=False))


FAULTS = {"raised_voxel": raised_voxel, "last_batch_lost": last_batch_lost,
          "empty_slot_dropped": empty_slot_dropped, "manifest_not_final": manifest_not_final}
