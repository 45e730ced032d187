"""Differentiable deposit: a ``torch.autograd.Function`` at the kernel boundary.

Counterpart of ``molvoxel_tpu/ops/autodiff.py``.  There a ``jax.custom_vjp``
wraps the whole Pallas deposit, and its backward writes three things by
hand: the inverse of the Morton permutation, the batch sum of shared radii
and the fold of the channel-wise virtual atoms.  Here the Function wraps
only the step that has kernels, (atom rows, weights) -> grid: its forward
is ``deposit_fwd`` and its backward ``deposit_bwd``.  Everything before it
(padding, the Morton sort, the mask, r^2, the threshold row, coef, the
depth-slab shift, the channel-wise expansion) is torch ops, so autograd
supplies those three itself.

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
from .deposit import deposit_bwd, deposit_fwd


class DepositFunction(torch.autograd.Function):
    """(rows (B, 8, Vp), weights (B, C, Vp)) -> grid (B, C, Dl, H*W)."""

    @staticmethod
    def forward(ctx, rows, weights, ranges, spec, dl, gaussian, out_dtype):
        ctx.save_for_backward(rows, weights)
        ctx.geometry = (spec, dl, gaussian)
        return deposit_fwd(rows, weights, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        rows, weights = ctx.saved_tensors
        spec, dl, gaussian = ctx.geometry
        grad_rows, grad_w = deposit_bwd(rows, weights, grad.contiguous(), spec=spec, dl=dl, gaussian=gaussian)
        return grad_rows, grad_w, None, None, None, None, None


def deposit(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
            gaussian: bool, out_dtype=torch.float32) -> torch.Tensor:
    """``deposit_fwd``, differentiable in ``rows`` and ``weights``."""
    return DepositFunction.apply(rows, weights, ranges, spec, dl, gaussian, out_dtype)
