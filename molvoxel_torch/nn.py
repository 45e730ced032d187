"""Neural-network integration: the voxelizer as a differentiable layer.

Counterpart of ``molvoxel_tpu/nn.py`` (flax), in ``torch.nn``:

- ``VoxelizeLayer``: renders padded molecule batches to grids inside the
  network; gradients flow back to coordinates and weights (on CUDA through
  the backward kernel, ops/autodiff.py).  An explicit ``torch.Generator``
  takes the place of the flax ``"voxelize"`` RNG stream.
- ``VoxelCNN``: a compact 3-D convolutional encoder over (B, C, D, H, W)
  grids, the same network as the JAX package's, with flax's ``SAME``
  padding.
- ``load_flax_params``: carries the JAX package's VoxelCNN parameters
  (numpy arrays) into a ``VoxelCNN``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .core.config import GridSpec
from .ops.batch import voxelize_batch


class VoxelizeLayer(nn.Module):
    """Differentiable molecule -> grid layer.

    Inputs: coords (B, V, 3), weights (B, V, C), mask (B, V) bool.
    Output: (B, C, D, H, W) float32 grids.

    When ``augment`` is True and a ``generator`` is passed, each molecule
    gets a fresh random rotation and translation drawn from it; without a
    generator the layer is deterministic (no transform)."""

    def __init__(self, spec: GridSpec, density_type: str = "gaussian", sigma: float = 0.5, radii: float = 1.0,
                 augment: bool = False, random_translation: float = 0.0):
        super().__init__()
        self.spec = spec
        self.density_type = density_type
        self.sigma = sigma
        self.radii = radii
        self.augment = augment
        self.random_translation = random_translation

    def forward(self, coords: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        augment = self.augment and generator is not None
        radii = torch.full((coords.shape[1],), float(self.radii), dtype=torch.float32, device=coords.device)
        return voxelize_batch(
            coords, weights, radii, mask, None, generator if augment else None,
            self.random_translation if augment else 0.0, spec=self.spec, density_type=self.density_type,
            sigma=self.sigma, random_rotation=augment,
        )


def _same_pad(size: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of one axis: low is the
    smaller half, so an even input pads (0, 1) at stride 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class VoxelCNN(nn.Module):
    """Small 3-D CNN encoder: (B, C, D, H, W) -> (B, features).

    Stride-2 3x3x3 convolutions with ReLU, a global mean and a ReLU dense
    layer, as the JAX package's VoxelCNN."""

    def __init__(self, in_channels: int, features: int = 64, widths: tuple[int, ...] = (16, 32, 64)):
        super().__init__()
        chans = (in_channels,) + tuple(widths)
        self.convs = nn.ModuleList(nn.Conv3d(chans[i], chans[i + 1], 3, stride=2) for i in range(len(widths)))
        self.dense = nn.Linear(chans[-1], features)

    def forward(self, grids: torch.Tensor) -> torch.Tensor:
        x = grids
        for conv in self.convs:
            pads = []
            for size in reversed(x.shape[2:]):  # F.pad takes the last axis first
                pads.extend(_same_pad(size))
            x = F.relu(conv(F.pad(x, pads)))
        return F.relu(self.dense(x.mean(dim=(2, 3, 4))))


def load_flax_params(module: VoxelCNN, params) -> VoxelCNN:
    """Load the JAX package's VoxelCNN parameters into ``module``.

    ``params`` is the flax variable dict (with or without its ``"params"``
    level) of arrays: ``Conv_i`` kernels (kd, kh, kw, in, out) and biases,
    and the ``Dense_0`` kernel (in, out) and bias."""
    params = params.get("params", params)
    state = {}
    for i in range(len(module.convs)):
        conv = params[f"Conv_{i}"]
        state[f"convs.{i}.weight"] = torch.as_tensor(np.asarray(conv["kernel"]).transpose(4, 3, 0, 1, 2).copy())
        state[f"convs.{i}.bias"] = torch.as_tensor(np.asarray(conv["bias"]).copy())
    dense = params["Dense_0"]
    state["dense.weight"] = torch.as_tensor(np.asarray(dense["kernel"]).T.copy())
    state["dense.bias"] = torch.as_tensor(np.asarray(dense["bias"]).copy())
    module.load_state_dict(state)
    return module
