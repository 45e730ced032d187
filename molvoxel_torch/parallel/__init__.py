"""Streaming, data-parallel, depth-sharded and multi-process voxelization on torch.distributed."""

from .mesh import (
    DATA_AXIS,
    DEPTH_AXIS,
    data_sharding,
    initialize_distributed,
    make_mesh,
    pad_batch_to_mesh,
    replicated_sharding,
)
from .multihost import globalize_batch, stream_dp_multiprocess
from .sharded import voxelize_batch_2d, voxelize_batch_dp, voxelize_depth_sharded
from .stream import StreamingVoxelizer, StreamStats, stream_checksum

__all__ = [
    "DATA_AXIS",
    "DEPTH_AXIS",
    "data_sharding",
    "initialize_distributed",
    "make_mesh",
    "pad_batch_to_mesh",
    "replicated_sharding",
    "globalize_batch",
    "stream_dp_multiprocess",
    "voxelize_batch_2d",
    "voxelize_batch_dp",
    "StreamingVoxelizer",
    "StreamStats",
    "stream_checksum",
    "voxelize_depth_sharded",
]
