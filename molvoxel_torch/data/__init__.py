"""Host-side data layer (numpy)."""

from .pipeline import PaddedBatch, pad_point_clouds, types_to_onehot

__all__ = ["PaddedBatch", "pad_point_clouds", "types_to_onehot"]
