"""No-cutoff gaussian deposit (``gaussian_notrunc``) as one matrix product.

Counterpart of ``molvoxel_tpu/ops/separable.py``.  Without the radius
cutoff the gaussian factorizes along the three axes,

    exp(coef * d^2) = exp(coef*dx^2) * exp(coef*dy^2) * exp(coef*dz^2),

so the whole grid is one product per molecule:

    U[(c, d), v]    = w[v, c] * ex[v, d]
    out[(c, d), hw] = U @ eyz[v, hw]

This is a plain large product that the JAX package leaves to XLA, so here
it is ``torch.bmm``, and autograd differentiates it.  The float32 lane runs
in full float32 (the float32 matmul precision is "highest" for the call:
no TF32); the bfloat16 and float8 lanes multiply bf16 inputs with f32
accumulation into a bf16 result (then cast for fp8), as the JAX package
does.  Its ``materialize`` flag only fences XLA's algebraic folding of the
grid; eager torch always materializes the grid, so the port has none.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.config import GridSpec
from .dense import _axis_positions
from .deposit import out_torch_dtype


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _axis_factor(pos: torch.Tensor, axis_pts: torch.Tensor, coef) -> torch.Tensor:
    """(B, V) positions, (L,) axis -> (B, V, L) exp(coef * delta^2)."""
    delta = pos[:, :, None] - axis_pts[None, None, :]
    return torch.exp(delta * delta * coef)


def voxelize_separable_batch(coords: torch.Tensor, weights: torch.Tensor, radii, *, spec: GridSpec,
                             sigma: float = 0.5, mask: torch.Tensor | None = None, d_offset=0,
                             d_count: int | None = None, out_dtype="float32") -> torch.Tensor:
    """Batched no-cutoff gaussian -> (B, C, Dl, H, W) of ``out_dtype``.

    coords (B, V, 3); weights (B, V, C); radii (V,) shared or (B, V); mask
    (B, V) bool or None."""
    b, v, c = weights.shape
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    dt = torch.float32
    dev = coords.device
    odt = out_torch_dtype(out_dtype)
    coords = coords.to(dt)
    weights = weights.to(dt)
    radii = torch.as_tensor(radii, dtype=dt, device=dev)
    if radii.ndim == 1:
        radii = radii[None, :].expand(b, v)
    r2 = radii * radii
    if mask is not None:
        weights = torch.where(mask[:, :, None], weights, torch.zeros((), dtype=dt, device=dev))
        r2 = torch.where(mask, r2, torch.ones((), dtype=dt, device=dev))
    coef = ((-(0.5 / (sigma * sigma))) / r2)[:, :, None]

    ax = _axis_positions(spec, dt, device=dev)
    axd = ax if d_count is None else _axis_positions(spec, dt, d_offset, d_count, device=dev)
    ex = _axis_factor(coords[:, :, 0], axd, coef)  # (B, V, Dl)
    ey = _axis_factor(coords[:, :, 1], ax, coef)  # (B, V, H)
    ez = _axis_factor(coords[:, :, 2], ax, coef)  # (B, V, W)
    eyz = (ey[:, :, :, None] * ez[:, :, None, :]).reshape(b, v, dim * dim)
    u = (weights[:, :, :, None] * ex[:, :, None, :]).reshape(b, v, c * dl)
    if odt == torch.float32:
        with _full_f32_matmul():
            out = torch.bmm(u.transpose(1, 2), eyz)
    else:
        out = torch.bmm(u.transpose(1, 2).to(torch.bfloat16), eyz.to(torch.bfloat16)).to(odt)
    return out.reshape(b, c, dl, dim, dim)


def voxelize_separable_batch_channelwise(coords: torch.Tensor, weights: torch.Tensor, radii, *, spec: GridSpec,
                                         sigma: float = 0.5, mask: torch.Tensor | None = None, d_offset=0,
                                         d_count: int | None = None, out_dtype="float32") -> torch.Tensor:
    """Channel-wise radii (C,): channel c's axis factors use radius r_c.
    Each channel's product runs in float32 and is cast to ``out_dtype``."""
    b, v, c = weights.shape
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    dt = torch.float32
    dev = coords.device
    odt = out_torch_dtype(out_dtype)
    coords = coords.to(dt)
    weights = weights.to(dt)
    if mask is not None:
        weights = torch.where(mask[:, :, None], weights, torch.zeros((), dtype=dt, device=dev))
    radii = torch.as_tensor(radii, dtype=dt, device=dev)
    coefc = (-(0.5 / (sigma * sigma))) / (radii * radii)  # (C,)

    ax = _axis_positions(spec, dt, device=dev)
    axd = ax if d_count is None else _axis_positions(spec, dt, d_offset, d_count, device=dev)
    outs = []
    with _full_f32_matmul():
        for ci in range(c):
            ex = _axis_factor(coords[:, :, 0], axd, coefc[ci])
            ey = _axis_factor(coords[:, :, 1], ax, coefc[ci])
            ez = _axis_factor(coords[:, :, 2], ax, coefc[ci])
            eyz = (ey[:, :, :, None] * ez[:, :, None, :]).reshape(b, v, dim * dim)
            u = weights[:, :, ci:ci + 1] * ex  # (B, V, Dl)
            outs.append(torch.bmm(u.transpose(1, 2), eyz).to(odt))
    return torch.stack(outs, dim=1).reshape(b, c, dl, dim, dim)


def voxelize_separable(coords, weights, radii, *, spec: GridSpec, sigma: float = 0.5, mask=None, d_offset=0,
                       d_count: int | None = None, channelwise_radii: bool = False) -> torch.Tensor:
    """Single-molecule no-cutoff gaussian -> (C, Dl, H, W)."""
    radii = torch.as_tensor(radii, dtype=torch.float32, device=coords.device)
    kw = dict(spec=spec, sigma=sigma, mask=None if mask is None else mask[None], d_offset=d_offset, d_count=d_count)
    if channelwise_radii:
        return voxelize_separable_batch_channelwise(coords[None], weights[None], radii, **kw)[0]
    return voxelize_separable_batch(coords[None], weights[None], radii if radii.ndim == 1 else radii[None], **kw)[0]
