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
(ops/separable.py); and on the card on the kernels (with the notrunc
threshold row) or the separable product, as ``notrunc_use_kernel`` picks
from the separable product's FLOPs by thresholds measured on an H100.
Every path is differentiable.  Counterpart of ``molvoxel_tpu/ops/voxelize.py``.
"""

from __future__ import annotations

import torch

from ..core.config import GridSpec
from .deposit import (
    check_density,
    check_kernel_dtype,
    out_torch_dtype,
    voxelize_deposit,
    voxelize_deposit_channelwise,
)
from .dense import voxelize_dense, voxelize_dense_channelwise
from .separable import voxelize_separable

IMPLS = ("auto", "cuda", "dense")

# gaussian_notrunc routing on CUDA: the kernel route when the separable
# product's bmm (2 B C Dl Vp HW FLOPs) reaches a threshold per grid lane, or
# one for a training step.  Fitted to the notrunc_routing lines of
# tools/torch_notrunc_sweep.py: 84 forward and 16 forward + backward shapes,
# both routes timed by CUDA-graph replay on an "NVIDIA H100 80GB HBM3,
# 700.00 W" (as nvidia-smi names the card and its power limit; PERF.md §6),
# where this rule takes the faster route, or one within 7.6% of it, at all
# 100.  The sweep held radii at 1 A and sigma at 0.5, and timed training in
# the f32 lane only; its rows are tests/data/torch_notrunc_sweep_h100.jsonl.
NOTRUNC_KERNEL_MIN_FLOPS = {"float32": 8e9, "bfloat16": 12e9, "grad": 5e8}


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


def notrunc_use_kernel(num_atoms: int, dim: int = 0, dl: int | None = None, *, channels: int = 1, batch: int = 1,
                       out_dtype="float32", grad: bool = False) -> bool:
    """True when gaussian_notrunc on CUDA should run on the deposit kernels
    (the threshold row) rather than the separable product: when the
    separable product's bmm reaches ``NOTRUNC_KERNEL_MIN_FLOPS``.  Reads
    Python numbers only, never a tensor, so it makes no host sync.
    ``num_atoms`` is the padded atom count of a molecule, ``dl`` the planes
    of a depth slab (the whole depth by default).  Counterpart of
    notrunc_use_pallas."""
    dl = dim if dl is None else dl
    lane = "grad" if grad else "float32" if out_torch_dtype(out_dtype) == torch.float32 else "bfloat16"
    return 2 * batch * channels * dl * num_atoms * dim * dim >= NOTRUNC_KERNEL_MIN_FLOPS[lane]


def notrunc_separable(density_type: str, impl: str, resolved: str, num_atoms: int, spec: GridSpec,
                      d_count: int | None, channelwise: bool, *, channels: int = 1, batch: int = 1,
                      out_dtype="float32", grad: bool = False) -> bool:
    """True when a request runs on the separable product: gaussian_notrunc,
    not an explicit ``impl="dense"``, and not a kernel request that
    ``notrunc_use_kernel`` sends to the kernels (it gets the keywords)."""
    if density_type != "gaussian_notrunc" or impl == "dense":
        return False
    return not (resolved == "cuda" and not channelwise and notrunc_use_kernel(
        num_atoms, spec.dimension, d_count, channels=channels, batch=batch, out_dtype=out_dtype, grad=grad))


def needs_grad(*tensors) -> bool:
    """Whether autograd will record a call on these tensors (Python
    attributes only: nothing is read from the device)."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


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
    if notrunc_separable(density_type, impl, resolved, coords.shape[0], spec, d_count, channelwise_radii,
                         channels=weights.shape[1], grad=needs_grad(coords, weights, radii)):
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
