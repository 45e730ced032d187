"""Device meshes over ``torch.distributed``, and the process group behind them.

Counterpart of ``molvoxel_tpu/parallel/mesh.py``.  The JAX package runs one
process over many devices and names a ``jax.sharding.Mesh``'s axes; the
PyTorch idiom is one process per device, joined in a process group, with a
``torch.distributed.device_mesh.DeviceMesh`` over the processes.  The axes
keep their names:

- ``"data"``: data parallelism over molecules (each rank voxelizes its rows);
- ``"depth"``: the grid's depth (D) axis split into slabs for protein-scale
  volumes: atoms are replicated (they are tiny), voxels are partitioned, so
  no halo exchange is needed.

Sharded results are ``DTensor``s whose placements follow the JAX package's
partition specs: ``data_sharding`` is ``Shard(0)`` over "data" (replicated
over "depth"), ``replicated_sharding`` is replicated over both.

The collective backend is the caller's choice or follows the device (NCCL
for "cuda", gloo for "cpu"); it is never swapped for another.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
DEPTH_AXIS = "depth"


def _device_type(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh runs on CUDA by default and no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev.type


def initialize_distributed(backend: str | None = None, *, device="cuda", **kwargs) -> None:
    """Join this process to the default process group (one process per device).

    A no-op when a group exists.  ``backend``: the caller's, else NCCL for a
    "cuda" ``device`` and gloo for "cpu".  ``kwargs`` go to
    ``torch.distributed.init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``timeout``, ...); a launcher such as
    ``torchrun`` sets them through the environment instead.  With neither,
    the group is this process alone on an in-memory store, so a one-rank
    mesh needs no launcher.  On CUDA each rank takes the card
    ``LOCAL_RANK`` (else its rank modulo the cards it sees).
    """
    if dist.is_initialized():
        return
    dev_type = _device_type(device)
    if backend is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
    if "init_method" not in kwargs and "store" not in kwargs and "MASTER_ADDR" not in os.environ:
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group(backend=backend, **kwargs)
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))


def make_mesh(data: int | None = None, depth: int = 1, *, device="cuda") -> DeviceMesh:
    """A (data, depth) mesh over every rank of the default process group
    (started by ``initialize_distributed(device=device)`` if there is none).

    With defaults, all ranks go to the data axis.  ``depth`` splits the
    grid's D axis that many ways (it must divide the world size).  Every
    rank must call this (it creates the axes' process groups, with the
    default group's backend)."""
    dev_type = _device_type(device)
    initialize_distributed(device=device)
    n = dist.get_world_size()
    if data is None:
        if n % depth != 0:
            raise ValueError(f"depth={depth} does not divide device count {n}")
        data = n // depth
    if data * depth != n:
        raise ValueError(f"mesh {data}x{depth} != device count {n}")
    backend = dist.get_backend()
    return DeviceMesh(dev_type, torch.arange(n).reshape(data, depth), mesh_dim_names=(DATA_AXIS, DEPTH_AXIS),
                      backend_override=((backend, None), (backend, None)))


def data_sharding(mesh: DeviceMesh) -> list:
    """DTensor placements for batch-leading tensors: dim 0 over "data",
    replicated over "depth"."""
    return [Shard(0), Replicate()]


def replicated_sharding(mesh: DeviceMesh) -> list:
    return [Replicate()] * mesh.ndim


def pad_batch_to_mesh(batch_size: int, mesh: DeviceMesh) -> int:
    """Batch size padded up to a multiple of the data-axis size."""
    d = mesh.size(0)
    return int(math.ceil(batch_size / d) * d)
