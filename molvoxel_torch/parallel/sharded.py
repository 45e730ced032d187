"""Sharded voxelization: data-parallel batches and depth-sharded grids.

Counterpart of ``molvoxel_tpu/parallel/sharded.py``.  Three schemes over a
(data, depth) mesh (parallel/mesh.py), one process per device:

1. ``voxelize_batch_dp``: the molecule batch split over "data"; each rank
   voxelizes its rows.  No communication in the forward path.
2. ``voxelize_depth_sharded``: one big molecule, the grid's depth split over
   "depth": every rank holds all atoms and deposits only its slab of planes
   (the kernel's ``d_offset`` / ``d_count``), so no halo is needed.
3. ``voxelize_batch_2d``: both at once; the step's collective is a sum of
   the deposited mass over both axes.

Each takes either the full batch (every rank takes its own rows) or a
``DTensor`` sharded on dim 0 over "data", and returns a ``DTensor`` with the
JAX package's output partition: ``.full_tensor()`` is the whole result,
``.to_local()`` this rank's rows or slab.

Augmentation: the generator replaces the JAX package's per-molecule keys.
Every rank draws the whole batch's transforms, in the order
``ops.batch.voxelize_batch`` draws them, and takes its rows, so a sharded
call equals one ``voxelize_batch`` call under the same generator.  The
ranks of one depth group must rotate their slabs alike, or the slabs of a
grid come from differently rotated molecules: the draws of depth-rank 0 are
broadcast over the depth group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.config import GridSpec
from ..core.transform import do_random_transform  # noqa: F401  (the JAX package's name here)
from ..ops.batch import apply_transforms, draw_transforms, voxelize_batch
from ..ops.voxelize import voxelize
from .mesh import DATA_AXIS, DEPTH_AXIS


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must live: the card for NCCL, the host
    for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_from_first(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` as the group's first rank holds it (no-op for one rank)."""
    if dist.get_world_size(group) == 1:
        return tensor
    buf = tensor.to(_comm_device(group)).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(tensor.device)


def _all_reduce_sum(tensor: torch.Tensor, groups) -> torch.Tensor:
    for group in groups:
        if dist.get_world_size(group) > 1:
            buf = tensor.to(_comm_device(group)).contiguous()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            tensor = buf.to(tensor.device)
    return tensor


def _shared_transforms(generator, b: int, random_translation: float, random_rotation: bool, mesh: DeviceMesh):
    """The whole batch's (quaternions, translations), as depth-rank 0 drew them."""
    q, t = draw_transforms(generator, b, float(random_translation), random_rotation)
    if mesh.size(1) > 1:
        group = mesh.get_group(DEPTH_AXIS)
        q, t = (None if x is None else _broadcast_from_first(x, group) for x in (q, t))
    return q, t


def _row_slice(mesh: DeviceMesh, b: int) -> slice:
    """This data rank's rows of a batch of ``b``."""
    n = b // mesh.size(0)
    r = mesh.get_local_rank(DATA_AXIS)
    return slice(r * n, (r + 1) * n)


def _rows(mesh: DeviceMesh, x, b: int):
    """This data rank's rows of ``x``: a full (b, ...) tensor, or a DTensor
    sharded on dim 0 over "data"."""
    if x is None:
        return None
    if isinstance(x, DTensor):
        if x.placements[0] != Shard(0):
            raise ValueError(f"a DTensor input must be sharded on dim 0 over {DATA_AXIS!r}, got {x.placements}")
        return x.to_local()
    return x[_row_slice(mesh, b)]


def _global_batch(mesh: DeviceMesh, coords) -> int:
    b = coords.shape[0]  # a DTensor's shape is the global one
    if b % mesh.size(0):
        raise ValueError(f"batch {b} not divisible by the {DATA_AXIS!r} axis size {mesh.size(0)}")
    return b


def _slab(mesh: DeviceMesh, spec: GridSpec) -> tuple[int, int]:
    """(first plane, planes) of this rank's depth slab."""
    nd = mesh.size(1)
    if spec.dimension % nd != 0:
        raise ValueError(f"dimension {spec.dimension} not divisible by depth shards {nd}")
    local_d = spec.dimension // nd
    return mesh.get_local_rank(DEPTH_AXIS) * local_d, local_d


def _from_local(local: torch.Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape), stride=stride)


def _batch_rows(mesh, coords, weights, mask, centers, generator, random_translation, random_rotation):
    """(b, local coords, weights, mask, centers, local transforms) of a batch call."""
    b = _global_batch(mesh, coords)
    sl = _row_slice(mesh, b)
    q, t = _shared_transforms(generator, b, random_translation, random_rotation, mesh)
    transforms = (None if q is None else q[sl], None if t is None else t[sl])
    return (b, *(_rows(mesh, x, b) for x in (coords, weights, mask, centers)), transforms)


def voxelize_batch_dp(
    coords,  # (B, V, 3), B divisible by the mesh's data axis
    weights,  # (B, V, C)
    radii: torch.Tensor,  # (V,) or (C,) shared
    mask,  # (B, V) or None
    centers,  # (B, 3) or None
    generator: torch.Generator | None = None,
    random_translation: float = 0.0,
    *,
    mesh: DeviceMesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
    out_dtype: str = "float32",
    presorted: bool = False,
) -> DTensor:
    """Data-parallel batched voxelization -> (B, C, D, H, W) sharded on B.

    Placements ``[Shard(0), Replicate()]``: the ranks of one depth group
    hold the same rows."""
    b, crd, w, m, cen, transforms = _batch_rows(mesh, coords, weights, mask, centers, generator,
                                                 random_translation, random_rotation)
    out = voxelize_batch(crd, w, radii, m, cen, None, 0.0, spec=spec, density_type=density_type, sigma=sigma,
                         random_rotation=random_rotation, channelwise=channelwise, impl=impl, out_dtype=out_dtype,
                         presorted=presorted, transforms=transforms)
    return _from_local(out, mesh, [Shard(0), Replicate()], (b,) + tuple(out.shape[1:]))


def voxelize_depth_sharded(
    coords: torch.Tensor,  # (V, 3) replicated
    weights: torch.Tensor,  # (V, C)
    radii: torch.Tensor,
    mask: torch.Tensor | None,
    center: torch.Tensor | None,
    generator: torch.Generator | None = None,
    random_translation: float = 0.0,
    *,
    mesh: DeviceMesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
) -> DTensor:
    """Depth-sharded single voxelization -> (C, D, H, W) sharded on D.

    ``spec.dimension`` must divide by the mesh's depth axis.  Every depth
    rank applies the transform depth-rank 0 drew, so the slabs assemble one
    grid."""
    d0, local_d = _slab(mesh, spec)
    crd = coords if center is None else coords - center.to(coords.dtype).reshape(1, 3)
    q, t = _shared_transforms(generator, 1, random_translation, random_rotation, mesh)
    crd = apply_transforms(crd[None], (q, t))[0]
    out = voxelize(crd, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
                   channelwise_radii=channelwise, impl=impl, d_offset=d0, d_count=local_d)
    return _from_local(out, mesh, [Replicate(), Shard(1)], (out.shape[0], spec.dimension) + tuple(out.shape[2:]))


def voxelize_batch_2d(
    coords,  # (B, V, 3)
    weights,  # (B, V, C)
    radii: torch.Tensor,
    mask,
    centers,
    generator: torch.Generator | None = None,
    random_translation: float = 0.0,
    *,
    mesh: DeviceMesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
) -> tuple[DTensor, DTensor]:
    """Batch sharded over "data" AND grid depth sharded over "depth".

    Returns (grids (B, C, D, H, W) placed ``[Shard(0), Shard(2)]``, the
    total deposited mass: an f32 sum over every rank's grids, replicated)."""
    d0, local_d = _slab(mesh, spec)
    b, crd, w, m, cen, transforms = _batch_rows(mesh, coords, weights, mask, centers, generator,
                                                 random_translation, random_rotation)
    out = voxelize_batch(crd, w, radii, m, cen, None, 0.0, spec=spec, density_type=density_type, sigma=sigma,
                         random_rotation=random_rotation, channelwise=channelwise, impl=impl, d_offset=d0,
                         d_count=local_d, transforms=transforms)
    mass = _all_reduce_sum(out.sum(dtype=torch.float32), [mesh.get_group(DATA_AXIS), mesh.get_group(DEPTH_AXIS)])
    grids = _from_local(out, mesh, [Shard(0), Shard(2)], (b, out.shape[1], spec.dimension) + tuple(out.shape[3:]))
    return grids, _from_local(mass, mesh, [Replicate(), Replicate()], ())
