"""Voxelization ops: the CUDA deposit kernels and their plain versions
(ops/deposit.py), the differentiable deposit (ops/autodiff.py), the plain
dense path (ops/dense.py), the no-cutoff separable product
(ops/separable.py), dispatch (ops/voxelize.py) and batching (ops/batch.py)."""

from .batch import voxelize_batch
from .dense import voxelize_dense, voxelize_dense_channelwise
from .deposit import (
    deposit_bwd,
    deposit_bwd_plain,
    deposit_fwd,
    deposit_plain,
    voxelize_deposit_batch,
    voxelize_deposit_batch_channelwise,
)
from .separable import voxelize_separable, voxelize_separable_batch, voxelize_separable_batch_channelwise
from .voxelize import voxelize

__all__ = [
    "voxelize_batch",
    "voxelize_dense",
    "voxelize_dense_channelwise",
    "deposit_bwd",
    "deposit_bwd_plain",
    "deposit_fwd",
    "deposit_plain",
    "voxelize_deposit_batch",
    "voxelize_deposit_batch_channelwise",
    "voxelize_separable",
    "voxelize_separable_batch",
    "voxelize_separable_batch_channelwise",
    "voxelize",
]
