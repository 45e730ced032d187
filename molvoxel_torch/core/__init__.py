"""Configuration, density functions and rigid transforms."""

from .config import (
    DENSITY_TYPE_LIST,
    RADII_TYPE_LIST,
    GridSpec,
    VoxelizerConfig,
    atom_bucket,
    grid_flat_padding,
    round_up,
    small_atom_bucket,
)
from .density import binary_sq, density_sq, gaussian_notrunc_sq, gaussian_sq
from .state import config_from_dict, transform_from_arrays
from .transform import (
    RandomTransform,
    Transform,
    apply_quaternion,
    do_random_transform,
    do_transform,
    quaternion_to_matrix,
    random_quaternion,
    random_translation_vector,
)

__all__ = [
    "DENSITY_TYPE_LIST",
    "RADII_TYPE_LIST",
    "GridSpec",
    "VoxelizerConfig",
    "atom_bucket",
    "grid_flat_padding",
    "round_up",
    "small_atom_bucket",
    "binary_sq",
    "density_sq",
    "gaussian_sq",
    "gaussian_notrunc_sq",
    "config_from_dict",
    "transform_from_arrays",
    "RandomTransform",
    "Transform",
    "apply_quaternion",
    "do_random_transform",
    "do_transform",
    "quaternion_to_matrix",
    "random_quaternion",
    "random_translation_vector",
]
