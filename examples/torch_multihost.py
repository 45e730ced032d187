"""Multi-process data-parallel voxelization in PyTorch.

The torch counterpart of examples/multihost.py.  One process per card,
joined in a ``torch.distributed`` process group: launch it with

    torchrun --nproc-per-node <cards> examples/torch_multihost.py

or run it alone for a one-rank group that needs no launcher.
``parallel.initialize_distributed`` joins the group (NCCL on the card, gloo
with ``--device cpu``) and ``make_mesh`` puts every rank on the "data" axis.

Each process builds its LOCAL rows of the global batch (32 molecules of 40
atoms, 4 channels, from numpy's ``default_rng(rank)``), ``globalize_batch``
makes them a DTensor of the global batch, and ``voxelize_batch_dp``
voxelizes them at 32^3 with a random rotation and 0.5 A translation for
each molecule, drawn from one seed for the whole batch.  Then
``stream_dp_multiprocess`` streams a 64-record demo library across the
ranks into per-rank grid stores, and a ``StreamingVoxelizer`` streams the
local rows.  Rank 0 writes the library into a temporary directory that the
other ranks learn by broadcast (ranks on one host; across hosts a library
lives on shared storage).

Run:  python examples/torch_multihost.py                     (one card)
      python examples/torch_multihost.py --device cpu
      torchrun --nproc-per-node 2 examples/torch_multihost.py --device cpu
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from molvoxel_torch.core import GridSpec  # noqa: E402
from molvoxel_torch.data import SimpleMolecule  # noqa: E402
from molvoxel_torch.data.parsers import write_sdf  # noqa: E402
from molvoxel_torch.parallel import (  # noqa: E402
    StreamingVoxelizer,
    globalize_batch,
    initialize_distributed,
    make_mesh,
    stream_dp_multiprocess,
    voxelize_batch_dp,
)

SPEC = GridSpec(resolution=0.5, dimension=32)
LOCAL_B, VP, V, C = 32, 128, 40, 4
SEED = 0  # the global batch's transforms: the same generator on every rank


def local_rows(rank: int):
    """(coords, weights, mask, rng): this rank's rows as numpy arrays, and
    the generator they were drawn from (the demo library continues it)."""
    rng = np.random.default_rng(rank)
    coords = np.zeros((LOCAL_B, VP, 3), np.float32)
    coords[:, :V] = rng.uniform(-5, 5, (LOCAL_B, V, 3))
    weights = np.zeros((LOCAL_B, VP, C), np.float32)
    weights[:, :V] = rng.uniform(size=(LOCAL_B, V, C))
    mask = np.zeros((LOCAL_B, VP), bool)
    mask[:, :V] = True
    return coords, weights, mask, rng


def write_demo_library(path: Path, rng, n: int = 64) -> None:
    """n records of 24 atoms (C, N, O) at U(-4, 4) A; a stand-in for a real library."""
    tmp = path.with_suffix(".tmp")
    parts = []
    for i in range(n):
        write_sdf(SimpleMolecule(coords=rng.uniform(-4, 4, (24, 3)), symbols=["C", "N", "O"] * 8, bonds=[],
                                 name=f"demo-{i}"), tmp)
        parts.append(tmp.read_text())
    tmp.unlink()
    path.write_text("".join(parts))


def main(device="cuda") -> tuple[float, int, int]:
    """Returns (the global batch's mass, molecules this rank streamed from
    the library, local molecules streamed)."""
    initialize_distributed(device=device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        print(f"process {rank}/{world}, {world} global devices (1 local), backend {dist.get_backend()}")
        mesh = make_mesh(data=world, device=device)

        coords, weights, mask, rng = local_rows(rank)
        dev = torch.device(device)
        grids = voxelize_batch_dp(
            globalize_batch(mesh, coords),
            globalize_batch(mesh, weights),
            torch.ones(VP, device=dev),
            globalize_batch(mesh, mask),
            globalize_batch(mesh, np.zeros((LOCAL_B, 3), np.float32)),
            torch.Generator().manual_seed(SEED),
            0.5,
            mesh=mesh, spec=SPEC, random_rotation=True,
        )
        mass = grids.to_local().double().sum().reshape(1)
        dist.all_reduce(mass)  # every rank of the data axis holds its own rows
        mass = float(mass)
        print(f"grids {tuple(grids.shape)} sharded over {tuple(mesh.shape)}; global mass = {mass:.6f}")

        # streaming an SDF library across every process: disjoint file stripes ->
        # global DP batches -> per-rank grid stores (parallel/multihost.py)
        box = [tempfile.mkdtemp(prefix="molvoxel_torch_multihost_") if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        work = Path(box[0])
        lib = work / "library.sdf"
        if rank == 0:
            write_demo_library(lib, rng)
        dist.barrier()  # the library is written before any rank reads it
        stats = stream_dp_multiprocess(lib, ["C", "N", "O"], SPEC, mesh=mesh, batch_size=16, bucket=128,
                                       unknown=True, store_root=work / "store")
        streamed = stats.molecules
        print(f"process {rank}: streamed {stats.molecules} molecules in {stats.batches} "
              f"batches -> {work / 'store' / f'proc-{rank:03d}'}")

        # the in-process StreamingVoxelizer, for host-local workloads
        def clouds():
            for i in range(LOCAL_B):
                yield coords[i, :V], weights[i, :V]

        sv = StreamingVoxelizer(SPEC, batch_size=16, mesh=mesh if world == 1 else None, device=device)
        stats = sv.run(clouds())
        print(f"streamed {stats.molecules} local molecules in {stats.batches} batches")
        dist.barrier()  # every rank is done with the directory
        if rank == 0:
            shutil.rmtree(work)
        return mass, streamed, stats.molecules
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
