"""Batched voxelization over padded molecule batches.

center shift -> Morton presort -> per-molecule random rigid transform ->
deposit.  On CUDA the batch is the kernels' leading grid axis; on the CPU
the plain dense op runs per molecule; ``gaussian_notrunc`` routes as in
ops/voxelize.py.  Every path is differentiable (the training path).
Counterpart of ``molvoxel_tpu/ops/batch.py``; its small-molecule packing
and the sliced full-grid assembly are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch

from ..core.config import GridSpec
from ..core.transform import quaternion_to_matrix, random_quaternion, random_translation_vector, rotate
from .deposit import (
    CHUNK,
    check_density,
    out_torch_dtype,
    sort_atoms_spatially,
    voxelize_deposit_batch,
    voxelize_deposit_batch_channelwise,
)
from .dense import voxelize_dense, voxelize_dense_channelwise
from .separable import voxelize_separable_batch, voxelize_separable_batch_channelwise
from .voxelize import notrunc_separable, resolve_impl


def random_transform_batch(generator: torch.Generator | None, coords: torch.Tensor, random_translation: float,
                           random_rotation: bool) -> torch.Tensor:
    """Apply an independent random rotation (about the origin) and
    translation to every molecule of (B, V, 3) coords."""
    b = coords.shape[0]
    if random_rotation:
        q = random_quaternion(generator, (b,))
        coords = rotate(coords, quaternion_to_matrix(q).to(coords.device))
    if random_translation > 0.0:
        t = random_translation_vector(generator, random_translation, (b,))
        coords = coords + t.to(device=coords.device, dtype=coords.dtype)[:, None, :]
    return coords


def voxelize_batch(
    coords: torch.Tensor,
    weights: torch.Tensor,
    radii: torch.Tensor,
    mask: torch.Tensor | None,
    centers: torch.Tensor | None,
    generator: torch.Generator | None = None,
    random_translation: float = 0.0,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
    radii_batched: bool = False,
    d_offset=0,
    d_count: int | None = None,
    out_dtype="float32",
    presorted: bool = False,
) -> torch.Tensor:
    """Voxelize a padded batch of point clouds -> (B, C, Dl, H, W) of ``out_dtype``.

    Args:
      coords: (B, V, 3).  weights: (B, V, C).
      radii: (V,)/(C,) shared, or (B, V) when ``radii_batched``.
      mask: (B, V) bool or None.  centers: (B, 3) or None (origin).
      generator: ``torch.Generator`` for the augmentation (drawn on the host).
      random_translation: magnitude; random_rotation: bool.
      d_offset/d_count: optional depth slab.
      out_dtype: "float32", "bfloat16" or "float8_e4m3fn"; accumulation is f32.
      presorted: atoms already arrive in Morton order, so no sort is needed.
    """
    check_density(density_type)
    odt = out_torch_dtype(out_dtype)
    resolved = resolve_impl(impl, coords)
    separable = notrunc_separable(density_type, impl, resolved, coords.shape[1], spec, d_count, channelwise)
    if centers is not None:
        coords = coords - centers[:, None, :].to(coords.dtype)

    # Morton sort BEFORE the random transform: rigid transforms preserve
    # locality, so one sort serves every augmented sample.
    if resolved == "cuda" and not separable and not channelwise and coords.shape[1] > CHUNK and not presorted:
        r_atoms = radii if radii.ndim == 2 else torch.as_tensor(radii, dtype=torch.float32).expand(coords.shape[:2])
        coords, weights, radii, mask = sort_atoms_spatially(coords, weights, r_atoms, mask, spec)
        presorted = True

    coords = random_transform_batch(generator, coords, float(random_translation), random_rotation)

    if separable:
        fn = voxelize_separable_batch_channelwise if channelwise else voxelize_separable_batch
        return fn(coords, weights, radii, spec=spec, sigma=sigma, mask=mask, d_offset=d_offset, d_count=d_count,
                  out_dtype=odt)

    kw = dict(spec=spec, density_type=density_type, sigma=sigma, d_offset=d_offset, d_count=d_count)
    if resolved == "cuda":
        fn = voxelize_deposit_batch_channelwise if channelwise else voxelize_deposit_batch
        return fn(coords, weights, radii, mask=mask, out_dtype=odt, presorted=presorted, **kw)

    fn = voxelize_dense_channelwise if channelwise else voxelize_dense
    outs = [
        fn(coords[i], weights[i], radii[i] if radii_batched else radii, mask=None if mask is None else mask[i], **kw)
        for i in range(coords.shape[0])
    ]
    return torch.stack(outs).to(odt)
