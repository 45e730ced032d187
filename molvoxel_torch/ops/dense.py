"""Plain PyTorch voxelization: the CPU lane and the oracle for every kernel.

    out[c, d, h, w] = sum_v weights[v, c] * f(|coords_v - g_dhw|^2, r_v^2, sigma)

Distances are computed separably: per-axis squared deltas dx2 (V, Dl),
dy2 (V, H), dz2 (V, W) are formed once (difference first, so no
cancellation in f32), then combined per depth slab as a broadcast sum and
contracted against the weights.  Works in the dtype of ``coords`` (float32
or float64).  Counterpart of ``molvoxel_tpu/ops/dense.py``.
"""

from __future__ import annotations

import torch

from ..core.config import GridSpec
from ..core.density import density_sq

_SLAB_BUDGET = 1 << 24  # elements of the (V, slab, H, W) temporary


def _axis_positions(spec: GridSpec, dtype, offset=0, count: int | None = None, device=None) -> torch.Tensor:
    """Voxel-center positions for axis indices [offset, offset + count):
    ``idx * res - width / 2`` in the working dtype.  The scalars go in as
    Python numbers, which the ops round to ``dtype`` as a tensor of them
    would be rounded, so no host-to-device copy (a stream sync) is made."""
    count = spec.dimension if count is None else count
    idx = torch.arange(count, dtype=dtype, device=device) + offset
    return idx * spec.resolution - spec.width / 2.0


def _per_axis_sq_deltas(coords: torch.Tensor, spec: GridSpec, d_offset=0, d_count: int | None = None):
    """(V, Dl), (V, H), (V, W) squared per-axis distances to voxel centers."""
    ax = _axis_positions(spec, coords.dtype, device=coords.device)
    axd = ax if d_count is None else _axis_positions(spec, coords.dtype, d_offset, d_count, device=coords.device)
    dx = coords[:, 0:1] - axd[None, :]
    dy = coords[:, 1:2] - ax[None, :]
    dz = coords[:, 2:3] - ax[None, :]
    return dx * dx, dy * dy, dz * dz


def _slab_size(num_atoms: int, dim: int, dloc: int) -> int:
    return max(1, min(dloc, _SLAB_BUDGET // max(num_atoms * dim * dim, 1)))


def voxelize_dense(
    coords: torch.Tensor,
    weights: torch.Tensor,
    radii: torch.Tensor,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: torch.Tensor | None = None,
    d_offset=0,
    d_count: int | None = None,
) -> torch.Tensor:
    """Voxelize one point cloud with per-atom radii.

    coords (V, 3); weights (V, C); radii (V,); mask optional (V,) bool, False
    entries contribute nothing; d_offset/d_count select the depth slab
    [d_offset, d_offset + d_count).  Returns (C, Dl, H, W) in coords' dtype.
    """
    v, c = weights.shape
    dim = spec.dimension
    dloc = dim if d_count is None else d_count
    dtype = coords.dtype
    weights = weights.to(dtype)
    r2 = radii.to(dtype) * radii.to(dtype)
    if mask is not None:
        weights = torch.where(mask[:, None], weights, torch.zeros((), dtype=dtype, device=weights.device))
        r2 = torch.where(mask, r2, torch.ones((), dtype=dtype, device=r2.device))

    dx2, dy2, dz2 = _per_axis_sq_deltas(coords, spec, d_offset, d_count)
    out = torch.empty((c, dloc, dim, dim), dtype=dtype, device=coords.device)
    slab = _slab_size(v, dim, dloc)
    wt = weights.t()
    for d0 in range(0, dloc, slab):
        d1 = min(d0 + slab, dloc)
        d2 = dx2[:, d0:d1, None, None] + dy2[:, None, :, None] + dz2[:, None, None, :]
        dens = density_sq(d2, r2[:, None, None, None], density_type, sigma)
        out[:, d0:d1] = (wt @ dens.reshape(v, -1)).reshape(c, d1 - d0, dim, dim)
    return out


def voxelize_dense_channelwise(
    coords: torch.Tensor,
    weights: torch.Tensor,
    radii: torch.Tensor,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: torch.Tensor | None = None,
    d_offset=0,
    d_count: int | None = None,
) -> torch.Tensor:
    """Voxelize with channel-wise radii: channel c uses radius radii[c] for
    every atom.  coords (V, 3); weights (V, C); radii (C,).  Returns
    (C, Dl, H, W)."""
    v, c = weights.shape
    dim = spec.dimension
    dloc = dim if d_count is None else d_count
    dtype = coords.dtype
    weights = weights.to(dtype)
    r2c = radii.to(dtype) * radii.to(dtype)
    if mask is not None:
        weights = torch.where(mask[:, None], weights, torch.zeros((), dtype=dtype, device=weights.device))

    dx2, dy2, dz2 = _per_axis_sq_deltas(coords, spec, d_offset, d_count)
    out = torch.empty((c, dloc, dim, dim), dtype=dtype, device=coords.device)
    slab = _slab_size(v, dim, dloc)
    for d0 in range(0, dloc, slab):
        d1 = min(d0 + slab, dloc)
        d2 = (dx2[:, d0:d1, None, None] + dy2[:, None, :, None] + dz2[:, None, None, :]).reshape(v, -1)
        for ci in range(c):
            dens = density_sq(d2, r2c[ci], density_type, sigma)
            out[ci, d0:d1] = (weights[:, ci] @ dens).reshape(d1 - d0, dim, dim)
    return out
