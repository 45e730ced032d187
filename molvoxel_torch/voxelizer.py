"""Top-level factories and transform types (same module path as the JAX package's ``voxelizer.py``)."""

from .api.voxelizer import Voxelizer, create_random_transform, create_voxelizer
from .core.transform import RandomTransform, Transform

__all__ = ["Voxelizer", "RandomTransform", "Transform", "create_voxelizer", "create_random_transform"]
