from .stream import StreamingVoxelizer, StreamStats, stream_checksum

__all__ = ["StreamingVoxelizer", "StreamStats", "stream_checksum"]
