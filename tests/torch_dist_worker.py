"""One rank of a gloo process group on the CPU, for tests/test_torch_parallel.py
and tests/test_torch_multiprocess.py.

    python tests/torch_dist_worker.py <suite> <rank> <world> <init file> <inputs.npz or sdf> <out dir> [args]

It joins the group through ``file://<init file>``, runs one suite of
molvoxel_torch.parallel calls, writes what the test compares under
``<out dir>`` (rank 0 the whole results, every rank its local shards) and
prints ``DONE rank=<rank>``.  It imports torch and molvoxel_torch only.

Suites:
- ``world2``: a (2, 1) mesh: voxelize_batch_dp plain, augmented, bf16 and on
  DTensor inputs, and the mesh stream; a (1, 2) mesh: voxelize_depth_sharded
  plain, and rotated with a different generator seed on each depth rank;
  the meshes and calls that must raise.
- ``world4``: a (2, 2) mesh: voxelize_batch_2d (the depth ranks seeded
  differently), voxelize_depth_sharded and voxelize_batch_dp.
- ``stream``: stream_dp_multiprocess over an SDF into ``<out dir>/plain``
  (no augmentation) and ``<out dir>/aug`` (rotation and translation).
- ``crash``: the augmented stream into ``<out dir>/aug``, aborted after
  ``args[0]`` batches have been flushed (prints CRASHED).
- ``resume``: the augmented stream resumed from ``<out dir>/aug``.
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from molvoxel_torch.core.config import GridSpec  # noqa: E402
from molvoxel_torch.parallel import (  # noqa: E402
    StreamingVoxelizer,
    globalize_batch,
    initialize_distributed,
    make_mesh,
    stream_dp_multiprocess,
    voxelize_batch_2d,
    voxelize_batch_dp,
    voxelize_depth_sharded,
)

SPEC = GridSpec(0.5, 16)
SYMBOLS = ["C", "N", "O", "S"]


class _Crash(Exception):
    """Stands for a crash anywhere in the stream."""


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def world2(rank, inputs):
    t = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "sdf_path"}
    crd, w, r, m, cen = t["coords"], t["weights"], t["radii"], t["mask"], t["centers"]
    res, local = {}, {}
    mesh = make_mesh(2, 1, device="cpu")
    dp = voxelize_batch_dp(crd, w, r, m, cen, None, 0.0, mesh=mesh, spec=SPEC)
    res["dp_plain"], local["dp_plain"] = dp.full_tensor(), dp.to_local()
    res["dp_aug"] = voxelize_batch_dp(crd, w, r, m, cen, torch.Generator().manual_seed(5), 0.5, mesh=mesh, spec=SPEC,
                                      random_rotation=True).full_tensor()
    res["dp_bf16"] = voxelize_batch_dp(crd, w, r, m, cen, None, 0.0, mesh=mesh, spec=SPEC,
                                       out_dtype="bfloat16").full_tensor().float()
    rows = slice(rank * 2, rank * 2 + 2)
    res["dp_dtensor"] = voxelize_batch_dp(*(globalize_batch(mesh, x[rows]) for x in (crd, w)), r,
                                          *(globalize_batch(mesh, x[rows]) for x in (m, cen)), None, 0.0, mesh=mesh,
                                          spec=SPEC).full_tensor()
    res["raises_mesh_3x1"] = torch.tensor(_raises(lambda: make_mesh(3, 1, device="cpu")))
    res["raises_depth_3"] = torch.tensor(_raises(lambda: make_mesh(depth=3, device="cpu")))
    res["raises_odd_batch"] = torch.tensor(_raises(
        lambda: voxelize_batch_dp(crd[:3], w[:3], r, m[:3], cen[:3], mesh=mesh, spec=SPEC)))
    sdf = Path(str(inputs["sdf_path"]))
    from molvoxel_torch.data.feed import SDFBatchFeeder

    for label, sv_mesh in (("stream_mesh", mesh), ("stream_plain", None)):
        grids = []
        sv = StreamingVoxelizer(SPEC, batch_size=8, device="cpu", mesh=sv_mesh, random_rotation=True,
                                random_translation=0.4, seed=2)
        sv.run_batches(SDFBatchFeeder(sdf, SYMBOLS, batch_size=8),
                       lambda im, b: grids.append(im.full_tensor() if sv_mesh is not None else im))
        res[label] = torch.cat(grids)

    mesh12 = make_mesh(1, 2, device="cpu")
    mol = {k: t[k][0] for k in ("coords", "weights", "mask", "centers")}
    args = (mol["coords"], mol["weights"], r, mol["mask"], mol["centers"])
    dep = voxelize_depth_sharded(*args, None, 0.0, mesh=mesh12, spec=SPEC)
    res["depth_plain"], local["depth_plain"] = dep.full_tensor(), dep.to_local()
    # each depth rank seeded differently: the slabs must still share rank 0's transform
    res["depth_rot"] = voxelize_depth_sharded(*args, torch.Generator().manual_seed(100 + rank), 0.5, mesh=mesh12,
                                              spec=SPEC, random_rotation=True).full_tensor()
    res["raises_depth_dim"] = torch.tensor(_raises(
        lambda: voxelize_depth_sharded(*args, mesh=mesh12, spec=GridSpec(0.5, 15))))
    return res, local


def world4(rank, inputs):
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    crd, w, r, m, cen = t["coords"], t["weights"], t["radii"], t["mask"], t["centers"]
    mesh = make_mesh(2, 2, device="cpu")
    depth_rank = mesh.get_local_rank("depth")
    res, local = {}, {}
    grids, mass = voxelize_batch_2d(crd, w, r, m, cen, None, 0.0, mesh=mesh, spec=SPEC)
    res["twod_plain"], local["twod_plain"] = grids.full_tensor(), grids.to_local()
    res["twod_mass"] = mass.full_tensor()
    grids, mass = voxelize_batch_2d(crd, w, r, m, cen, torch.Generator().manual_seed(7 + 1000 * depth_rank), 0.5,
                                    mesh=mesh, spec=SPEC, random_rotation=True)
    res["twod_rot"], res["twod_rot_mass"] = grids.full_tensor(), mass.full_tensor()
    res["depth22"] = voxelize_depth_sharded(crd[0], w[0], r, m[0], cen[0], None, 0.0, mesh=mesh,
                                            spec=SPEC).full_tensor()
    res["dp22"] = voxelize_batch_dp(crd, w, r, m, cen, None, 0.0, mesh=mesh, spec=SPEC).full_tensor()
    return res, local


def stream(rank, sdf, out: Path, mode, crash_after=0):
    mesh = make_mesh(device="cpu")
    kw = dict(mesh=mesh, batch_size=4, bucket=64, store_target_bytes=1,  # flush (and checkpoint) every batch
              feeder_kwargs={"target_shard_bytes": 512})  # many spans: real striping
    lines = []
    if mode == "stream":
        stats = stream_dp_multiprocess(sdf, SYMBOLS, SPEC, store_root=out / "plain", **kw)
        lines.append(f"plain molecules={stats.molecules} batches={stats.batches}")
    done = [0]

    def crashing(images, batch):
        done[0] += 1
        if done[0] >= crash_after:
            raise _Crash

    try:
        stats = stream_dp_multiprocess(sdf, SYMBOLS, SPEC, store_root=out / "aug", random_rotation=True,
                                       random_translation=0.5, seed=11, resume=mode == "resume",
                                       consumer=crashing if mode == "crash" else None, **kw)
    except _Crash:
        print(f"CRASHED rank={rank} after={done[0]}", flush=True)
        return
    lines.append(f"aug molecules={stats.molecules} batches={stats.batches} skipped={stats.skipped}")
    print(f"STREAM rank={rank} " + " ".join(lines), flush=True)


def run_ranks(suite: str, world: int, data, out: Path, *extra, timeout: float = 240.0) -> list[str]:
    """Start ``world`` ranks of ``suite`` (fresh interpreters) and wait for
    them; returns each rank's output.  A rank that has not ended within
    ``timeout`` seconds is killed, with the others, and the call fails."""
    import subprocess

    out.mkdir(parents=True, exist_ok=True)
    init_file = out / f"pg-{suite}"
    init_file.unlink(missing_ok=True)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), suite, str(rank), str(world),
                               str(init_file), str(data), str(out), *map(str, extra)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT))
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DONE rank={rank}" not in text:
            raise AssertionError(f"rank {rank} of {suite} failed (exit {p.returncode}):\n{text}")
    return outs


def main() -> int:
    suite, rank, world, init_file, data, out = sys.argv[1:7]
    rank, world, out = int(rank), int(world), Path(out)
    initialize_distributed(backend="gloo", device="cpu", init_method=f"file://{init_file}", world_size=world,
                           rank=rank)
    if suite in ("stream", "crash", "resume"):
        stream(rank, data, out, suite, int(sys.argv[7]) if len(sys.argv) > 7 else 0)
    else:
        inputs = dict(np.load(data))
        res, local = {"world2": world2, "world4": world4}[suite](rank, inputs)
        if rank == 0:
            np.savez(out / f"{suite}.npz", **{k: v.numpy() for k, v in res.items()})
        np.savez(out / f"{suite}_local{rank}.npz", **{k: v.numpy() for k, v in local.items()})
    dist.barrier()
    dist.destroy_process_group()
    print(f"DONE rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
