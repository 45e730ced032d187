"""Public API."""

from .voxelizer import Voxelizer, create_random_transform, create_voxelizer

__all__ = ["Voxelizer", "create_random_transform", "create_voxelizer"]
