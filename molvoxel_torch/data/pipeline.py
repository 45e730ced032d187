"""Host-side batching: ragged molecules -> padded fixed-shape batches.

A numpy copy of ``molvoxel_tpu/data/pipeline.py``: variable-size point
clouds are padded into bucketed (B, Vp, ...) arrays plus validity masks that
feed ``ops.batch.voxelize_batch``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from ..core.config import small_atom_bucket


@dataclasses.dataclass
class PaddedBatch:
    """A fixed-shape molecule batch ready for device transfer."""

    coords: np.ndarray  # (B, Vp, 3) f32
    weights: np.ndarray  # (B, Vp, C) f32 one-hot / feature rows
    mask: np.ndarray  # (B, Vp) bool
    centers: np.ndarray | None  # (B, 3) f32
    num_atoms: np.ndarray  # (B,) int32 true sizes

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def padded_atoms(self) -> int:
        return self.coords.shape[1]


def pad_point_clouds(
    clouds: Sequence[tuple[np.ndarray, np.ndarray]],
    *,
    centers: Sequence[np.ndarray] | None = None,
) -> PaddedBatch:
    """Pad a list of (coords (V_i, 3), weights (V_i, C)) to one batch.

    Vp is ``small_atom_bucket(max V_i)``.  Padded atoms get zero weights and
    mask False: they deposit nothing.
    """
    if len(clouds) == 0:
        raise ValueError("pad_point_clouds needs at least one cloud")
    c = clouds[0][1].shape[1]
    vp = small_atom_bucket(max(crd.shape[0] for crd, _ in clouds))
    b = len(clouds)

    coords = np.zeros((b, vp, 3), np.float32)
    weights = np.zeros((b, vp, c), np.float32)
    mask = np.zeros((b, vp), bool)
    num_atoms = np.zeros((b,), np.int32)

    for i, (crd, w) in enumerate(clouds):
        v = crd.shape[0]
        coords[i, :v] = crd
        weights[i, :v] = w
        mask[i, :v] = True
        num_atoms[i] = v

    centers_arr = None
    if centers is not None:
        centers_arr = np.stack([np.asarray(ce, np.float32).reshape(3) for ce in centers])

    return PaddedBatch(coords, weights, mask, centers_arr, num_atoms)


def types_to_onehot(types: np.ndarray, num_channels: int) -> np.ndarray:
    """(V,) int types -> (V, C) one-hot float32 weights."""
    out = np.zeros((types.shape[0], num_channels), np.float32)
    out[np.arange(types.shape[0]), np.asarray(types, np.int64)] = 1.0
    return out
