"""Voxelization ops: the CUDA deposit (ops/deposit.py), the plain dense
path (ops/dense.py), dispatch (ops/voxelize.py) and batching (ops/batch.py)."""

from .batch import voxelize_batch
from .dense import voxelize_dense, voxelize_dense_channelwise
from .deposit import deposit_fwd, deposit_plain, voxelize_deposit_batch, voxelize_deposit_batch_channelwise
from .voxelize import voxelize

__all__ = [
    "voxelize_batch",
    "voxelize_dense",
    "voxelize_dense_channelwise",
    "deposit_fwd",
    "deposit_plain",
    "voxelize_deposit_batch",
    "voxelize_deposit_batch_channelwise",
    "voxelize",
]
