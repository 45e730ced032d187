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

import torch as _torch

# torch's CPU exp sets itself up on its first call.  When that first call
# runs on several threads at once, part of its output can come back wrong
# (seen with torch 2.13.0+cpu on an AVX-512 host: in 6 of 40 processes, up
# to 1.5e-4 relative, in the first call only; tools/torch_first_exp_probe.py
# counts them).  One call on one element, on this thread, does the set-up;
# the CPU paths' densities call exp on large tensors, which torch splits
# over threads.
_torch.exp(_torch.zeros(1))
_torch.exp(_torch.zeros(1, dtype=_torch.float64))

from .core.config import GridSpec, VoxelizerConfig  # noqa: E402
from .core.transform import RandomTransform, Transform  # noqa: E402
from .voxelizer import Voxelizer, create_random_transform, create_voxelizer  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "GridSpec",
    "VoxelizerConfig",
    "RandomTransform",
    "Transform",
    "Voxelizer",
    "create_random_transform",
    "create_voxelizer",
    "__version__",
]
