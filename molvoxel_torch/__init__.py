"""molvoxel_torch: molecular voxelization in PyTorch, with hand-written CUDA kernels for Hopper.

Point clouds (atom coordinates plus types or features) become 4-D density
grids (C, D, H, W).  The deposit runs in ``csrc/deposit_fwd.cu`` and its
gradient in ``csrc/deposit_bwd.cu``, both built with nvcc at first use; on
the CPU (``device="cpu"``) the plain PyTorch versions run instead.

    from molvoxel_torch import create_voxelizer
    vox = create_voxelizer(dimension=48)            # device="cuda"
    grid = vox.forward_features(coords, center, features, radii=1.0)

For gradients (training, pose refinement) use ``ops.voxelize.voxelize``,
``ops.batch.voxelize_batch`` or ``nn.VoxelizeLayer``.
"""

from .core.config import GridSpec, VoxelizerConfig
from .core.transform import RandomTransform, Transform
from .voxelizer import Voxelizer, create_random_transform, create_voxelizer

__all__ = [
    "GridSpec",
    "VoxelizerConfig",
    "RandomTransform",
    "Transform",
    "Voxelizer",
    "create_random_transform",
    "create_voxelizer",
]
