"""Dispatch for the single-molecule voxelization op.

- ``cuda``: the hand-written deposit kernels (ops/deposit.py,
  csrc/deposit_fwd.cu forward and csrc/deposit_bwd.cu backward), float32,
  for CUDA tensors.
- ``dense``: plain PyTorch (ops/dense.py), float32 or float64, any device.

``impl="auto"`` picks by device alone: ``cuda`` for CUDA tensors, ``dense``
for CPU tensors.  The kernel is float32, so float64 CUDA tensors raise
unless the caller asks for ``impl="dense"``.  ``gaussian_notrunc`` runs on
the dense path when the caller asks for ``impl="dense"``; otherwise on the
CPU, and for channel-wise radii, on the separable product
(ops/separable.py); and on the card on the kernels with the notrunc
threshold row (``notrunc_separable``).
Every path is differentiable.  Counterpart of ``molvoxel_tpu/ops/voxelize.py``.
"""

from __future__ import annotations

import torch

from ..core.config import GridSpec
from .deposit import (
    check_density,
    check_kernel_dtype,
    voxelize_deposit,
    voxelize_deposit_channelwise,
)
from .dense import voxelize_dense, voxelize_dense_channelwise
from .separable import voxelize_separable

IMPLS = ("auto", "cuda", "dense")

def default_impl(coords: torch.Tensor) -> str:
    return "cuda" if coords.is_cuda else "dense"


def default_batch_impl(coords: torch.Tensor) -> str:
    """Implementation for batched calls: the same rule as ``default_impl``
    (the kernels take the batch as their leading grid axis)."""
    return default_impl(coords)


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


def notrunc_separable(density_type: str, impl: str, resolved: str, channelwise: bool) -> bool:
    """True when a request runs on the separable product: gaussian_notrunc,
    not an explicit ``impl="dense"``, and not a CUDA request with one
    radius per atom, which runs on the kernels (the threshold row).  On an
    H100 the kernel route was the faster, or within 3.5% of the faster, at
    all 100 shapes of tools/torch_notrunc_sweep.py (PERF.md §6).
    Counterpart of notrunc_use_pallas."""
    if density_type != "gaussian_notrunc" or impl == "dense":
        return False
    return not (resolved == "cuda" and not channelwise)


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
    d_offset/d_count select a depth slab.  Differentiable in coords,
    weights and radii on every path."""
    check_density(density_type)
    resolved = resolve_impl(impl, coords)
    if notrunc_separable(density_type, impl, resolved, channelwise_radii):
        return voxelize_separable(coords, weights, radii, spec=spec, sigma=sigma, mask=mask, d_offset=d_offset,
                                  d_count=d_count, channelwise_radii=channelwise_radii)
    kw = dict(spec=spec, density_type=density_type, sigma=sigma, mask=mask, d_offset=d_offset, d_count=d_count)
    if resolved == "cuda":
        if channelwise_radii:
            return voxelize_deposit_channelwise(coords, weights, radii, **kw)
        return voxelize_deposit(coords, weights, radii, **kw)
    if channelwise_radii:
        return voxelize_dense_channelwise(coords, weights, radii, **kw)
    return voxelize_dense(coords, weights, radii, **kw)
