"""Density functions on *squared* distances.

- gaussian: ``exp(-0.5 * d2 / (r2 * sigma^2))`` for ``d2 <= r2`` (inclusive
  boundary), 0 outside.
- binary: ``1.0`` where ``d2 <= r2`` (inclusive), else 0.
- gaussian_notrunc: the gaussian without the cutoff (the reference torch
  backend's semantics).

Working on squared distances avoids the sqrt: all three only need ``d^2``
and ``r^2``.
"""

from __future__ import annotations

import torch

GAUSSIAN = "gaussian"
BINARY = "binary"
GAUSSIAN_NOTRUNC = "gaussian_notrunc"


def gaussian_sq(d2: torch.Tensor, r2: torch.Tensor, sigma: float) -> torch.Tensor:
    """exp(-0.5 * d2 / (r2 * sigma^2)) masked to d2 <= r2 (inclusive boundary)."""
    inv_two_sigma_sq = 0.5 / (sigma * sigma)
    val = torch.exp(-inv_two_sigma_sq * d2 / r2)
    return torch.where(d2 <= r2, val, torch.zeros((), dtype=val.dtype, device=val.device))


def binary_sq(d2: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """1.0 inside the (inclusive) radius, else 0.0."""
    return (d2 <= r2).to(d2.dtype)


def gaussian_notrunc_sq(d2: torch.Tensor, r2: torch.Tensor, sigma: float) -> torch.Tensor:
    """exp(-0.5 * d2 / (r2 * sigma^2)) with no cutoff."""
    inv_two_sigma_sq = 0.5 / (sigma * sigma)
    return torch.exp(-inv_two_sigma_sq * d2 / r2)


def density_sq(d2: torch.Tensor, r2: torch.Tensor, density_type: str, sigma: float) -> torch.Tensor:
    if density_type == GAUSSIAN:
        return gaussian_sq(d2, r2, sigma)
    if density_type == BINARY:
        return binary_sq(d2, r2)
    if density_type == GAUSSIAN_NOTRUNC:
        return gaussian_notrunc_sq(d2, r2, sigma)
    raise ValueError(f"unknown density_type {density_type!r}")
