"""Faults planted under the timed path, each in a ``with`` block.

The tests plant them in small runs on the CPU and see ``correct`` come out
false; ``calibrate.py`` can plant them at a cell's own size on the card.

- ``half_batch``: half of the batch left out: the second half of every
  batch's grids is zero;
- ``altered_answer``: one voxel of every batch's first grid is raised by 1.
"""

from __future__ import annotations

import contextlib

import torch

APPLIES = {"batch_loop": ("half_batch", "altered_answer")}


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _outputs():
    """(class, method) whose returned grids a forward cell's window takes."""
    from molvoxel_torch.api.voxelizer import Voxelizer

    return Voxelizer, "forward_batch"


def _bump(grid):
    c = grid.shape[-1] // 2
    bump = torch.zeros_like(grid)
    bump[0, 0, c, c, c] = 1.0
    return grid + bump


def half_batch(driver: str):
    def make(old):
        def call(*args, **kw):
            out = old(*args, **kw)
            out[out.shape[0] - out.shape[0] // 2:] = 0
            return out
        return call
    return _patched(*_outputs(), make)


def altered_answer(driver: str):
    return _patched(*_outputs(), lambda old: lambda *a, **kw: _bump(old(*a, **kw)))


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer}
