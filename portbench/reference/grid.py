"""The plain deposit: every (atom, voxel) pair inside the cutoff, summed in float64.

    grid[m, c, i, j, k] = sum over atoms a of molecule m in channel c of
        w_a * exp(-0.5 * d2 / (r^2 sigma^2))   where d2 = |x_a - g_ijk|^2 <= r^2

with voxel centers ``g = lower + (i, j, k) * res`` and ``lower = -res (dim - 1) / 2``,
so that the grid is centered on the origin (the upstream project's geometry).

A pair whose d2 lies within ``band`` of r^2 may fall on either side of the
cutoff in the port's float32 arithmetic, where it adds ``w exp(-0.5 / sigma^2)``
or nothing.  ``deposit`` therefore returns two grids, ``lo`` without such
pairs and ``hi`` with them; a correct grid lies between the two, up to its
own rounding.  With ``band=0`` it returns one grid, differentiable in the
coordinates.
"""

from __future__ import annotations

import math

import torch

BAND = 1e-4  # A^2 about r^2: far wider than float32's error in placing an atom and squaring its distance


def _offsets(radius: float, res: float, device) -> torch.Tensor:
    n = int(math.floor(2 * radius / res)) + 3
    ar = torch.arange(n, device=device)
    return torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3)


def deposit(coords, mol, chan, weight, *, batch: int, channels: int, dim: int, res: float, sigma: float,
            radius: float, band: float = 0.0, block_atoms: int = 8192):
    """(lo, hi, pairs): grids (batch, channels, dim, dim, dim) in the dtype of
    ``coords`` (hi is None when ``band`` is 0) and the number of (atom, voxel)
    pairs inside the cutoff.

    coords (N, 3) placed coordinates; mol, chan (N,) int64 molecule and
    channel of each atom; weight (N,) its weight."""
    dev, dt = coords.device, coords.dtype
    lower = -res * (dim - 1) / 2.0
    r2 = radius * radius
    k = -0.5 / (r2 * sigma * sigma)
    off = _offsets(radius, res, dev)
    size = batch * channels * dim**3
    lo = torch.zeros(size, dtype=dt, device=dev)
    hi = torch.zeros(size, dtype=dt, device=dev) if band > 0 else None
    pairs = 0
    for s in range(0, coords.shape[0], block_atoms):
        x = coords[s:s + block_atoms]
        first = torch.floor((x.detach() - radius - lower) / res).long()
        idx = first[:, None, :] + off[None]
        valid = ((idx >= 0) & (idx < dim)).all(-1)
        pos = lower + idx.to(dt) * res
        d2 = ((pos - x[:, None, :]) ** 2).sum(-1)
        val = weight[s:s + block_atoms, None].to(dt) * torch.exp(k * d2)
        base = mol[s:s + block_atoms] * channels + chan[s:s + block_atoms]
        flat = ((base[:, None] * dim + idx[..., 0]) * dim + idx[..., 1]) * dim + idx[..., 2]
        pairs += int((valid & (d2.detach() <= r2)).sum())
        inside = valid & (d2.detach() <= r2 - band)
        lo = lo.index_add(0, flat[inside], val[inside])
        if hi is not None:
            amb = valid & ((d2.detach() - r2).abs() <= band)
            hi = hi.index_add(0, flat[amb], val[amb].detach())
    shape = (batch, channels, dim, dim, dim)
    lo = lo.reshape(shape)
    return lo, None if hi is None else (lo.detach() + hi.reshape(shape)), pairs


def interval_excess(grid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> float:
    """How far the largest voxel of ``grid`` lies outside [lo, hi]."""
    g = grid.to(lo.dtype)
    return float(torch.maximum((lo - g).clamp(min=0).amax(), (g - hi).clamp(min=0).amax()))
