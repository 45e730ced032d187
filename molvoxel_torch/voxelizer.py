"""Top-level factories (same module path as the JAX package's ``voxelizer.py``)."""

from .api.voxelizer import Voxelizer, create_random_transform, create_voxelizer

__all__ = ["Voxelizer", "create_random_transform", "create_voxelizer"]
