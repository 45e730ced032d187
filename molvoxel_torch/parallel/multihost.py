"""Multi-process streaming voxelization: one process per device, each on its stripe of a library.

Counterpart of ``molvoxel_tpu/parallel/multihost.py``:

1. every rank reads a disjoint stripe of the SDF through the feeder's span
   striping (``span_offset=rank, span_stride=ranks``), so the file is covered
   exactly once with no coordination;
2. each rank's padded batch is its rows of one global data-parallel batch
   (``globalize_batch``: a DTensor sharded on dim 0 over "data", built from
   the local rows with no communication);
3. the compute is the same ``voxelize_batch_dp`` the single-process path
   uses;
4. each rank stores its rows in its own grid store ``proc-NNN`` whose
   manifest records ``process_index`` and ``num_processes``, so the library
   is reassembled by reading ``proc-*/`` in rank order.

Ranks may run out of stripe at different steps: a per-step MAX all-reduce of
a one-element flag keeps them in lockstep, and a drained rank feeds
all-padding batches until every stripe is done.  A one-rank mesh needs no
collective at all.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.config import GridSpec
from .mesh import DATA_AXIS
from .sharded import _comm_device, _from_local, voxelize_batch_dp
from .stream import StreamStats


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def globalize_batch(mesh: DeviceMesh, arr) -> DTensor:
    """This rank's rows (numpy or a tensor) -> a DTensor of the global batch,
    sharded on dim 0 over "data" and replicated over "depth", on the mesh's
    device.  Every rank passes the same row count; no communication."""
    local = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    local = local.to(_mesh_device(mesh))
    return _from_local(local, mesh, [Shard(0), Replicate()], (local.shape[0] * mesh.size(0),) + tuple(local.shape[1:]))


def _any_process(mesh: DeviceMesh, flag: bool) -> bool:
    """Global OR of a per-rank flag over the data axis (keeps the ranks in lockstep)."""
    if mesh.size(0) == 1:
        return flag
    group = mesh.get_group(DATA_AXIS)
    t = torch.tensor([1.0 if flag else 0.0], device=_comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0.0)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of stream step ``step``: a function of (seed, step)
    alone, so a resumed run draws what the uninterrupted run drew."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]))


def stream_dp_multiprocess(
    path: str | Path,
    symbols: Sequence[str],
    spec: GridSpec,
    *,
    mesh: DeviceMesh,
    batch_size: int = 64,
    bucket: int = 128,
    unknown: bool = False,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    radii: float = 1.0,
    random_translation: float = 0.0,
    random_rotation: bool = False,
    out_dtype: str = "float32",
    seed: int = 0,
    store_root: str | Path | None = None,
    presort: bool = False,
    feeder_kwargs: dict | None = None,
    consumer=None,
    resume: bool = False,
    store_target_bytes: int = 64 << 20,
) -> StreamStats:
    """Stream an SDF library across all ranks of the mesh (called by every rank).

    ``batch_size`` is the PER-RANK batch (global batch = batch_size x
    ranks); the mesh's depth axis must be 1.  ``bucket`` fixes the atom
    padding.  With ``store_root`` each rank writes ``store_root/proc-NNN``
    (manifest carries process_index / num_processes); its rows are its
    stripe's records in file order, zero-atom records included.
    ``consumer(images, batch)`` receives this rank's rows (a tensor on the
    mesh's device) and its PaddedBatch.

    Augmentation: step k's transforms come from ``step_generator(seed, k)``,
    drawn for the whole global batch, of which each rank takes its rows; so
    a molecule's transform depends on (seed, step, rank, row).

    ``resume=True`` (needs ``store_root``) restarts an interrupted run:
    every flush leaves a provisional manifest, so each rank skips the whole
    batches its store already holds, re-feeds the rest, and starts the step
    counter past the skipped batches, so its augmentation is the
    uninterrupted run's.  Ranks may resume at different offsets; the
    lockstep flag handles the uneven tails as it does uneven stripes.

    Returns this rank's StreamStats (molecules = molecules fed here, with
    atoms; ``skipped`` = rows already durable from the prior run).
    """
    from ..data.feed import SDFBatchFeeder
    from ..data.pipeline import PaddedBatch

    if mesh.size(1) != 1:
        raise ValueError(f"stream_dp_multiprocess shards molecules only: make_mesh(depth=1), "
                         f"got depth {mesh.size(1)}")
    rank = mesh.get_local_rank(DATA_AXIS)
    nproc = mesh.size(0)
    dev = _mesh_device(mesh)

    feeder = SDFBatchFeeder(
        path, list(symbols),
        batch_size=batch_size, bucket=bucket, unknown=unknown,
        span_offset=rank, span_stride=nproc,
        presort=presort, spec=spec if presort else None,
        **(feeder_kwargs or {}),
    )
    nch = feeder.num_channels

    writer = None
    resumed_rows = 0
    if store_root is not None:
        from ..data.gridstore import GridShardWriter

        writer = GridShardWriter(
            Path(store_root) / f"proc-{rank:03d}", list(symbols) + (["*"] if unknown else []),
            resolution=spec.resolution, dimension=spec.dimension,
            extra_manifest={"process_index": rank, "num_processes": nproc},
            resume=resume, target_bytes=store_target_bytes,
        )
        if resume:
            # flushed rows are whole batches (appends are batch-sized until
            # the final tail); skip exactly those batches from the stripe
            resumed_rows = writer.rows
    elif resume:
        raise ValueError("resume=True needs store_root (the store holds the progress)")

    radii_dev = torch.full((bucket,), float(radii), dtype=torch.float32, device=dev)
    stats = StreamStats()
    t0 = time.time()

    empty = None  # an all-padding batch for a drained stripe, built at first need
    source = iter(feeder)
    skip_batches = resumed_rows // batch_size
    for _ in range(skip_batches):
        if next(source, None) is None:
            break
    stats.skipped = resumed_rows
    step = skip_batches
    while True:
        batch = next(source, None)
        has = batch is not None
        if not _any_process(mesh, has):
            break
        if not has:
            if empty is None:
                empty = PaddedBatch(
                    coords=np.zeros((batch_size, bucket, 3), np.float32),
                    weights=np.zeros((batch_size, bucket, nch), np.float32),
                    mask=np.zeros((batch_size, bucket), bool),
                    radii=None,
                    centers=np.zeros((batch_size, 3), np.float32),
                    num_atoms=np.zeros((batch_size,), np.int32),
                )
            batch = empty
        centers = batch.centers if batch.centers is not None else np.zeros((batch_size, 3), np.float32)
        with torch.no_grad():
            out = voxelize_batch_dp(
                globalize_batch(mesh, batch.coords),
                globalize_batch(mesh, batch.weights),
                radii_dev,
                globalize_batch(mesh, batch.mask),
                globalize_batch(mesh, centers),
                step_generator(seed, step),
                random_translation,
                mesh=mesh, spec=spec, density_type=density_type, sigma=sigma,
                random_rotation=random_rotation, out_dtype=out_dtype, presorted=presort,
            )
        if has:
            stats.batches += 1
            stats.molecules += int((batch.num_atoms > 0).sum())
            local = out.to_local()
            if writer is not None:
                writer.append(local, batch.num_atoms)
            if consumer is not None:
                consumer(local, batch)
        step += 1

    if writer is not None:
        # every record of the stripe (zero-atom ones keep their slots); the
        # padded tail of the last batch is cut
        writer.finalize(feeder.records_fed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats.wall_seconds = time.time() - t0
    return stats
