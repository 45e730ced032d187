"""Differentiable deposit: two ``torch.autograd.Function``s at the kernel boundaries.

Counterpart of ``molvoxel_tpu/ops/autodiff.py``.  There a ``jax.custom_vjp``
wraps the whole Pallas deposit, and its backward writes three things by
hand: the inverse of the Morton permutation, the batch sum of shared radii
and the fold of the channel-wise virtual atoms.  Here two Functions cover
the two steps that have kernels:

- ``PrepareFunction``: (coords, weights, radii, centers, transform table)
  -> (atom rows, weights, plane ranges, permutation).  Its forward is the
  preparation launch of the batch shape's ``deposit.LaunchPlan`` on the
  card, ``deposit_prep`` without one (``prepare_plain`` on the CPU); its
  backward is one explicit torch function on both devices,
  ``prepare_backward``: the slab shift, the threshold row and coef back to
  the radii, the mask, the channel-wise fold, the inverse permutation, the
  padding, the transform (the table's gradient, and the coordinates'
  gradient times R) and the center.  Autograd carries the table's
  gradient on to the quaternions and translations it was made from
  (``deposit.transform_table``).
- ``DepositFunction``: (atom rows, weights) -> grid, ``deposit_fwd``
  forward and ``deposit_bwd`` backward, both told whether the rows are
  threshold rows (``notrunc``: gaussian_notrunc), which take their own
  launches.

The gradient is the almost-everywhere one: the cutoff's boundary term is
dropped, as ``jnp.where`` autodiff drops it in the JAX package, so the
threshold row gets none, and binary density gives only the weights a
gradient.  A bf16 or fp8 grid's cotangent arrives in that dtype; the
kernel reads bf16 (fp8 is widened to bf16 exactly), the counterpart of the
JAX package's ``lowp`` backward lane, and accumulates in f32.  There is no
dense fallback: the CUDA backward takes every grid the forward takes.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.config import GridSpec
from ..utils.timing import span
from .deposit import PrepPlan, Transforms, deposit_bwd, deposit_fwd, deposit_prep, notrunc_factor


def prepare_backward(g_rows, g_wt, perm, radii, mask, transforms: Transforms, plan: PrepPlan, v: int,
                     needs=(True, True, True, True, True), coords=None, centers=None):
    """The VJP of a preparation at the cotangents of its rows (B, 8, Vo)
    and weights (B, C, Vo) -> (coords (B, V, 3), weights (B, V, C), radii
    as given, centers (B, 3), transform table (B, 12)); each None where
    ``needs`` says so.  ``perm`` (B, Vp) is the preparation's permutation,
    the rest its inputs (``coords`` and ``centers`` are read only for the
    table's gradient).

    Rows 0-2 are the placed coordinates q = R p + t with p the centered
    ones (the slab shift has slope 1), row 3 is r^2 or r^2 times the
    notrunc factor, row 4 coef = reciprocal(r^2) * (-0.5 / sigma^2)
    (gaussian), with r^2 = 1 for masked atoms, which get no radius or
    weight gradient; d r^2 / d r = 2 r."""
    b, _, vo = g_rows.shape
    vp = perm.shape[1]
    c = g_wt.shape[1]
    order = perm.long()
    pad = vp - v
    live = None if mask is None else torch.nn.functional.pad(mask, (0, pad), value=False).gather(1, order)
    if plan.channelwise:
        r = radii.repeat_interleave(vp)[None].expand(b, -1)
        live = None if live is None else live.repeat(1, c)
    else:
        r_atoms = radii if radii.ndim == 2 else radii[None].expand(b, -1)
        r = torch.nn.functional.pad(r_atoms, (0, pad), value=1.0).gather(1, order)
    g_r2 = g_rows[:, 3] * notrunc_factor(plan.sigma) if plan.notrunc else g_rows[:, 3]
    if plan.gaussian:
        r2 = r * r if live is None else torch.where(live, r * r, 1.0)
        rcp = torch.reciprocal(r2)
        g_r2 = g_r2 - (g_rows[:, 4] * (-(0.5 / (plan.sigma * plan.sigma)))) * (rcp * rcp)
    g_r = 2.0 * r * (g_r2 if live is None else torch.where(live, g_r2, 0.0))  # (B, Vo)
    g_w = g_wt if live is None else torch.where(live[:, None, :], g_wt, 0.0)  # (B, C, Vo)
    g_pos = g_rows[:, :3].transpose(1, 2)  # (B, Vo, 3)
    if plan.channelwise:  # fold virtual atom c * Vp + v onto sorted atom v
        g_pos = g_pos.reshape(b, c, vp, 3).sum(dim=1)
        g_w = torch.diagonal(g_w.reshape(b, c, c, vp), dim1=1, dim2=2)  # (B, Vp, C)
    else:
        g_w = g_w.transpose(1, 2)

    def unsort(x):  # sorted atom i back to padded input atom perm[i], then unpadded
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2)).expand_as(x)
        return torch.empty_like(x).scatter_(1, idx, x)[:, :v]

    g_placed = unsort(g_pos) if needs[0] or needs[3] or needs[4] else None  # dL/dq (B, V, 3)
    g_table = None
    if needs[4]:  # dL/dR = sum over atoms of dL/dq p^T, dL/dt = sum of dL/dq
        p = coords.to(g_placed.dtype) if centers is None else coords.to(g_placed.dtype) - centers[:, None, :]
        zero = g_placed.new_zeros(())
        g_rot = torch.einsum("bvi,bvj->bij", g_placed, p).reshape(b, 9) if transforms.rot else zero.expand(b, 9)
        g_trans = g_placed.sum(dim=1) if transforms.trans else zero.expand(b, 3)
        g_table = torch.cat([g_rot, g_trans], dim=1).to(transforms.table.dtype)
    g_coords = g_placed
    if transforms.rot and (needs[0] or needs[3]):  # q = R p + t  ->  dL/dp = dL/dq R
        rot = transforms.table[:, :9].reshape(b, 1, 3, 3).to(g_pos.dtype)
        g_coords = (g_placed[..., 0:1] * rot[..., 0, :] + g_placed[..., 1:2] * rot[..., 1, :]
                    + g_placed[..., 2:3] * rot[..., 2, :])
    g_weights = unsort(g_w.contiguous()) if needs[1] else None
    g_radii = None
    if needs[2]:
        if plan.channelwise:
            g_radii = g_r.reshape(b, c, vp).sum(dim=(0, 2))
        else:
            g_radii = unsort(g_r)
            g_radii = g_radii if radii.ndim == 2 else g_radii.sum(dim=0)
    g_centers = -g_coords.sum(dim=1) if needs[3] else None
    return (g_coords if needs[0] else None), g_weights, g_radii, g_centers, g_table


class PrepareFunction(torch.autograd.Function):
    """(coords (B, V, 3), weights (B, V, C), radii, centers (B, 3) or None,
    transform table (B, 12) or None) -> (rows (B, 8, Vo), weights (B, C,
    Vo), ranges, permutation (B, Vp)); ``lp``, the batch shape's launch
    plan, launches the preparation where given."""

    @staticmethod
    def forward(ctx, coords, weights, radii, centers, table, mask, transforms, plan, lp):
        if lp is None:
            out = deposit_prep(coords, weights, radii, mask, centers, transforms, plan)
        else:
            out = lp.outputs(lp.prepare(coords, weights, radii, mask, centers, table))
        ctx.mark_non_differentiable(out.ranges, out.perm)
        ctx.save_for_backward(radii, mask, out.perm, coords, centers)
        ctx.transforms, ctx.plan, ctx.v = transforms, plan, coords.shape[1]
        return out.rows, out.weights, out.ranges, out.perm

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rows, g_wt, _ranges, _perm):
        radii, mask, perm, coords, centers = ctx.saved_tensors
        grads = prepare_backward(g_rows, g_wt, perm, radii, mask, ctx.transforms, ctx.plan, ctx.v,
                                 needs=tuple(ctx.needs_input_grad[:5]), coords=coords, centers=centers)
        return (*grads, None, None, None, None)


def prepare(coords, weights, radii, mask, centers, transforms: Transforms, plan: PrepPlan):
    """``deposit_prep``, differentiable in coords, weights, radii, centers
    and the transform table -> (rows, weights, ranges, Dl)."""
    rows, wt, ranges, _ = PrepareFunction.apply(coords, weights, radii, centers, transforms.table, mask, transforms,
                                                plan, None)
    return rows, wt, ranges, plan.spec.dimension if plan.d_count is None else plan.d_count


class DepositFunction(torch.autograd.Function):
    """(rows (B, 8, Vp), weights (B, C, Vp)) -> grid (B, C, Dl, H*W)."""

    @staticmethod
    def forward(ctx, rows, weights, ranges, spec, dl, gaussian, out_dtype, notrunc):
        ctx.save_for_backward(rows, weights)
        ctx.geometry = (spec, dl, gaussian, notrunc)
        return deposit_fwd(rows, weights, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_dtype,
                           notrunc=notrunc)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        rows, weights = ctx.saved_tensors
        spec, dl, gaussian, notrunc = ctx.geometry
        grad_rows, grad_w = deposit_bwd(rows, weights, grad.contiguous(), spec=spec, dl=dl, gaussian=gaussian,
                                        notrunc=notrunc)
        return grad_rows, grad_w, None, None, None, None, None, None


def deposit(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
            gaussian: bool, out_dtype=torch.float32, notrunc: bool = False) -> torch.Tensor:
    """``deposit_fwd``, differentiable in ``rows`` and ``weights``;
    ``notrunc``: threshold rows (gaussian_notrunc), which take the
    threshold-row launches forward and backward."""
    with span("molvoxel.deposit"):
        return DepositFunction.apply(rows, weights, ranges, spec, dl, gaussian, out_dtype, notrunc)
