"""Configuration, density functions and rigid transforms."""

from .config import GridSpec, VoxelizerConfig, atom_bucket, round_up, small_atom_bucket
from .density import binary_sq, density_sq, gaussian_sq
from .state import config_from_dict, transform_from_arrays
from .transform import (
    RandomTransform,
    Transform,
    apply_quaternion,
    do_random_transform,
    do_transform,
    quaternion_to_matrix,
    random_quaternion,
)

__all__ = [
    "GridSpec",
    "VoxelizerConfig",
    "atom_bucket",
    "round_up",
    "small_atom_bucket",
    "binary_sq",
    "density_sq",
    "gaussian_sq",
    "config_from_dict",
    "transform_from_arrays",
    "RandomTransform",
    "Transform",
    "apply_quaternion",
    "do_random_transform",
    "do_transform",
    "quaternion_to_matrix",
    "random_quaternion",
]
