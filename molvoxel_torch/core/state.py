"""Carrying state across from the JAX package.

The deposit has no learned weights: its whole state is the configuration
and the rigid transform.  These two functions take what the JAX package
exposes as plain Python / numpy values, so both packages compute the same
grid from the same augmentation:

    cfg = config_from_dict(jax_voxelizer.config.to_dict())
    tf = transform_from_arrays(np.asarray(jax_tf.quaternion), np.asarray(jax_tf.translation))
"""

from __future__ import annotations

import numpy as np
import torch

from .config import VoxelizerConfig
from .transform import Transform


def config_from_dict(d: dict) -> VoxelizerConfig:
    """``VoxelizerConfig`` from the dict that ``VoxelizerConfig.to_dict()`` gives."""
    return VoxelizerConfig.from_dict(d)


def transform_from_arrays(quaternion, translation, device="cpu") -> Transform:
    """``Transform`` from numpy quaternion (4,) and translation (3,) arrays;
    either may be None for an identity component."""

    def conv(a, n):
        if a is None:
            return None
        arr = np.array(a, np.float32).reshape(n)
        return torch.as_tensor(arr, device=device)

    return Transform(translation=conv(translation, 3), quaternion=conv(quaternion, 4))
