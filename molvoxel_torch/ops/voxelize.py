"""Dispatch for the single-molecule voxelization op.

- ``cuda``: the hand-written deposit kernel (ops/deposit.py, csrc/deposit_fwd.cu),
  float32, for CUDA tensors.
- ``dense``: plain PyTorch (ops/dense.py), float32 or float64, any device.

``impl="auto"`` picks by device alone: ``cuda`` for CUDA tensors, ``dense``
for CPU tensors.  The kernel is float32, so float64 CUDA tensors raise
unless the caller asks for ``impl="dense"``.  Counterpart of
``molvoxel_tpu/ops/voxelize.py``.
"""

from __future__ import annotations

import torch

from ..core.config import GridSpec
from .deposit import check_density, check_kernel_dtype, voxelize_deposit, voxelize_deposit_channelwise
from .dense import voxelize_dense, voxelize_dense_channelwise

IMPLS = ("auto", "cuda", "dense")


def default_impl(coords: torch.Tensor) -> str:
    return "cuda" if coords.is_cuda else "dense"


def resolve_impl(impl: str, coords: torch.Tensor) -> str:
    """Concrete implementation for ``coords``; raises for a bad request."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        impl = default_impl(coords)
    if impl == "cuda":
        if not coords.is_cuda:
            raise ValueError(f"impl='cuda' needs CUDA tensors, got a tensor on {coords.device}")
        check_kernel_dtype(True, coords.dtype)
    return impl


def voxelize(
    coords: torch.Tensor,
    weights: torch.Tensor,
    radii: torch.Tensor,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: torch.Tensor | None = None,
    channelwise_radii: bool = False,
    impl: str = "auto",
    d_offset=0,
    d_count: int | None = None,
) -> torch.Tensor:
    """Voxelize one point cloud -> (C, Dl, H, W); see ops/dense.py.

    radii is (V,) normally, (C,) when ``channelwise_radii`` is True.
    d_offset/d_count select a depth slab."""
    check_density(density_type)
    impl = resolve_impl(impl, coords)
    kw = dict(spec=spec, density_type=density_type, sigma=sigma, mask=mask, d_offset=d_offset, d_count=d_count)
    if impl == "cuda":
        if channelwise_radii:
            return voxelize_deposit_channelwise(coords, weights, radii, **kw)
        return voxelize_deposit(coords, weights, radii, **kw)
    if channelwise_radii:
        return voxelize_dense_channelwise(coords, weights, radii, **kw)
    return voxelize_dense(coords, weights, radii, **kw)
