"""Command-line interface of the PyTorch / CUDA port.

    python -m molvoxel_torch info
    python -m molvoxel_torch voxelize ligands.sdf -o grids.npz --channels C,N,O,S
    python -m molvoxel_torch voxelize library.sdf -o store/ --out-dtype bfloat16
    python -m molvoxel_torch voxelize library.sdf --throughput --wire --trials 3
    python -m molvoxel_torch voxelize complex.pdb --dx out_dx/ --dimension 48 --device cpu
    python -m molvoxel_torch bench

``voxelize`` runs on the card (``--device cuda``, the default) unless asked
for the CPU (``--device cpu``).  The flags are the JAX package's
(``molvoxel_tpu/cli.py``); ``bench`` runs this port's own headline (64
ligands through ``Voxelizer.forward_batch``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _version(cmd: list[str]) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "no"
    lines = [ln for ln in (out.stdout + out.stderr).splitlines() if ln.strip()]
    return lines[-1].strip() if out.returncode == 0 and lines else "no"


def _cmd_info(args) -> int:
    import torch

    from .native import NATIVE_AVAILABLE, build
    from .ops import _build

    print(f"molvoxel-torch (torch {torch.__version__}, CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"cuda: {len(names)} device(s): {', '.join(names)}")
    else:
        print("cuda: no device (voxelize needs --device cpu)")
    try:
        nvcc = _build._nvcc()
        print(f"nvcc: {nvcc} ({_version([nvcc, '--version'])})")
    except RuntimeError:
        print("nvcc: no (the CUDA kernels cannot build)")
    cxx = shutil.which("g++")
    print(f"g++: {cxx} ({_version([cxx, '-dumpfullversion'])})" if cxx else "g++: no")
    lib = build.library_path()
    print(f"native fast parser: {'yes, ' + str(lib) if NATIVE_AVAILABLE else 'no (pure-python fallback)'}")
    print("formats: sdf/.sdf.gz (V2000+V3000), pdb (+multi-MODEL), xyz, mol2")
    try:
        import rdkit  # noqa: F401

        print("rdkit: yes")
    except ImportError:
        print("rdkit: no (built-in SDF/PDB parsers active)")
    return 0


def _is_sdf(path: Path) -> bool:
    return path.suffix in (".sdf", ".mol") or path.suffixes[-2:] == [".sdf", ".gz"]


def _load_molecules(path: Path, hydrogens: bool):
    from .data.parsers import iter_mol2, iter_xyz, read_pdb
    from .native import parse_sdf_buffer, parse_sdf_file

    if path.suffixes[-2:] == [".sdf", ".gz"]:
        import gzip

        mols = parse_sdf_buffer(gzip.decompress(path.read_bytes()))
    elif path.suffix in (".sdf", ".mol"):
        mols = parse_sdf_file(path)
    elif path.suffix in (".pdb", ".ent"):
        mols = [read_pdb(path)]
    elif path.suffix == ".xyz":
        mols = list(iter_xyz(path))
    elif path.suffix == ".mol2":
        mols = list(iter_mol2(path))
    else:
        raise SystemExit(f"unsupported input type: {path}")
    if not hydrogens:
        mols = [m.without_hydrogens() for m in mols]
    return mols


def _cmd_voxelize(args) -> int:
    from .core.config import GridSpec
    from .ops.batch import pick_slab_depth
    from .parallel import StreamingVoxelizer

    paths = [Path(p) for p in args.input]
    path = paths[0]
    symbols = [s.strip() for s in args.channels.split(",")]
    spec = GridSpec(resolution=args.resolution, dimension=args.dimension)

    # Fast lane: SDF + atom-type channels goes through the vectorized feeder
    # (native parse -> columnar batch assembly, data/feed.py) with no
    # per-molecule Python.  Bond channels / PDB / several files use the
    # maker path (each feeder pads its own tail).
    use_feeder = len(paths) == 1 and _is_sdf(path) and not args.bonds and args.center == "auto"

    if args.throughput:
        if not all(_is_sdf(p) for p in paths) or args.bonds or args.center != "auto":
            raise SystemExit("--throughput needs the SDF fast lane (no --bonds, --center auto)")
        return _run_throughput(args, spec, paths, symbols)

    # --batch default is mode-dependent (64 for grids, 4096 for --throughput).
    # Depths beyond one launch (--dimension 256+) assemble the full grid
    # from depth slabs on the host (ops/batch.py); the default batch drops
    # so that a batch of 256^3 grids fits.
    slab_depth = pick_slab_depth(spec, len(symbols) + (1 if args.unknown else 0))
    batch_size = args.batch if args.batch is not None else (4 if slab_depth else 64)
    sv = StreamingVoxelizer(
        spec,
        batch_size=batch_size,
        slab_depth=slab_depth,
        density_type=args.density,
        sigma=args.sigma,
        radii=args.radii,
        random_translation=args.random_translation,
        random_rotation=args.random_rotation,
        seed=args.seed,
        out_dtype=args.out_dtype,
        presorted=args.presort and use_feeder,  # maker-path batches are unsorted
        device=args.device,
    )

    feeder = None
    mols = None
    if use_feeder:
        from .data.feed import SDFBatchFeeder

        feeder = SDFBatchFeeder(
            path, symbols,
            batch_size=batch_size, unknown=args.unknown,
            keep_hydrogens=args.hydrogens, workers=args.workers,
            presort=args.presort, spec=spec if args.presort else None,
        )
    else:
        mols = [m for p in paths for m in _load_molecules(p, args.hydrogens)]

    def batches():
        if feeder is not None:
            yield from feeder
        else:
            from .data import AtomTypeGetter, BondTypeGetter, MolPointCloudMaker
            from .data.pipeline import iter_batches

            atom_getter = AtomTypeGetter(symbols, unknown=args.unknown)
            bond_getter = BondTypeGetter.default() if args.bonds else None
            maker = MolPointCloudMaker(atom_getter, bond_getter, channel_type="features")

            def clouds():
                for mol in mols:
                    coords, feats = maker.run(mol)
                    center = coords.mean(0) if args.center == "auto" else np.zeros(3)
                    yield (coords - center).astype(np.float32), feats.astype(np.float32)

            yield from iter_batches(clouds(), batch_size)

    channel_names = symbols + (["Unknown"] if args.unknown else [])
    if args.bonds:
        channel_names += ["SingleBond", "DoubleBond", "TripleBond", "AromaticBond"]

    if args.output:
        return _run_grids_streamed(args, sv, batches, feeder, mols, channel_names)

    import torch

    results = []
    t0 = time.time()
    stats = sv.run_batches(batches(), lambda images, batch: results.append(images.cpu()))
    if not results:
        raise SystemExit("no molecules parsed")
    # Truncate by real record slots, not by non-empty-molecule count: a 0-atom
    # record (e.g. all-H after filtering) occupies a mid-stream slot; only
    # the feeder's tail padding is virtual.
    n_real = feeder.records_fed if feeder is not None else len(mols)
    grids = torch.cat(results, dim=0)[:n_real]
    print(
        f"voxelized {stats.molecules} molecules ({n_real} records) in {time.time() - t0:.2f}s "
        f"-> grids {tuple(grids.shape)}",
        file=sys.stderr,
    )
    _maybe_dx(args, grids[0] if len(grids) else None, channel_names)
    if not args.dx:
        print(json.dumps({"molecules": int(stats.molecules), "shape": list(grids.shape)}))
    return 0


def _run_grids_streamed(args, sv, batches, feeder, mols, channel_names) -> int:
    """Write grids as a sharded store with bounded host memory.

    Each batch is flushed to its own ``.npy`` shard as soon as it lands, so
    peak memory is O(batch); ``manifest.json`` describes the store and
    ``data.gridstore.read_grid_shards`` / ``GridShardReader`` read it.  A
    single ``.npz`` stays available for small runs (< --npz-limit
    molecules).  bfloat16 / float8 grids are stored as raw 2- / 1-byte
    items, as the JAX package stores them.
    """
    import torch

    from .data.gridstore import GridShardWriter, host_array

    t0 = time.time()
    out = Path(args.output)
    as_shards = out.suffix != ".npz" or args.shards
    if not as_shards:
        results = []
        count = 0

        def consume(images, batch):
            nonlocal count
            results.append(images.cpu())
            count += images.shape[0]
            if count > args.npz_limit:
                raise SystemExit(
                    f"more than --npz-limit={args.npz_limit} molecules; "
                    "write a sharded store instead (-o outdir/ or --shards)"
                )

        stats = sv.run_batches(batches(), consume)
        if not results:
            raise SystemExit("no molecules parsed")
        n_real = feeder.records_fed if feeder is not None else len(mols)
        grids = torch.cat(results, dim=0)[:n_real]
        np.savez_compressed(
            args.output,
            grids=host_array(grids)[0],
            channels=np.asarray(channel_names),
            resolution=np.float32(args.resolution),
            dimension=np.int32(args.dimension),
        )
        print(
            f"voxelized {stats.molecules} molecules ({n_real} records) in "
            f"{time.time() - t0:.2f}s -> {args.output}",
            file=sys.stderr,
        )
        _maybe_dx(args, grids[0] if len(grids) else None, channel_names)
        return 0

    writer = GridShardWriter(out, channel_names, resolution=args.resolution, dimension=args.dimension)
    with writer:
        stats = sv.run_batches(batches(), lambda images, batch: writer.append(images, batch.num_atoms))
        n_real = feeder.records_fed if feeder is not None else len(mols)
        writer.finalize(n_real)
    print(
        f"voxelized {stats.molecules} molecules ({n_real} records) in "
        f"{time.time() - t0:.2f}s -> {writer.num_shards} shards under {out}",
        file=sys.stderr,
    )
    if args.dx and n_real:
        from .data.gridstore import GridShardReader

        _maybe_dx(args, GridShardReader(out)[0], channel_names)
    return 0


def _maybe_dx(args, grid0, channel_names) -> None:
    """Write the first molecule's channels as OpenDX volumes (``--dx``)."""
    if not args.dx or grid0 is None:
        return
    from .viz.dx import write_channels_dx

    grid0 = grid0.float().cpu().numpy()
    channel_dict = {name: grid0[i] for i, name in enumerate(channel_names)}
    paths = write_channels_dx(args.dx, channel_dict, [0, 0, 0], args.resolution)
    print(f"wrote {len(paths)} .dx volumes to {args.dx}", file=sys.stderr)


def _run_throughput(args, spec, paths, symbols) -> int:
    """End-to-end stream-from-disk throughput: parse + batch + copy to the
    card + voxelize.

    The vectorized feeder emits COMPACT superbatches (int8 types; with
    ``--wire`` one int16 array assembled in C); ``stream_checksum`` stages
    each onto the card from a prefetch thread and voxelizes it chunk by
    chunk, summing each chunk's grids on the card (the witness read unless
    ``--full-read``).  The timed window ends at the one final read of the
    checksum.  A first pass warms up (kernel build, allocator); then
    ``--trials`` timed passes: the best, the median, the minimum and the
    maximum are reported.
    """
    import torch

    from .data.feed import SDFBatchFeeder
    from .parallel.stream import stream_checksum

    nch = len(symbols) + (1 if args.unknown else 0)
    rbt = None
    if args.radii_by_type:
        rbt = tuple(float(x) for x in args.radii_by_type.split(","))
        if len(rbt) != nch:
            raise SystemExit(f"--radii-by-type needs {nch} values (one per channel incl. Unknown), got {len(rbt)}")

    batch = args.batch if args.batch is not None else 4096
    chunk = min(args.chunk, batch)
    superbatch = max(batch, chunk) // chunk * chunk

    def one_pass(seed):
        feeders = [
            SDFBatchFeeder(
                p, symbols,
                batch_size=superbatch, unknown=args.unknown,
                keep_hydrogens=args.hydrogens, workers=args.workers, compact=True,
                presort=args.presort, spec=spec if args.presort else None,
            )
            for p in paths
        ]
        t0 = time.time()

        # several input files chain (each pads its own tail); the staging
        # thread of stream_checksum overlaps assembly with the launches
        def chained():
            for f in feeders:
                yield from (f.iter_wire(spec) if args.wire else iter(f))

        stats, checksum = stream_checksum(
            chained(), spec,
            chunk=chunk, density_type=args.density, sigma=args.sigma,
            radii=args.radii, radii_by_type=rbt,
            random_translation=args.random_translation,
            random_rotation=args.random_rotation, out_dtype=args.out_dtype,
            seed=seed, presorted=args.presort, wire=args.wire,
            witness=not args.full_read, prefetch_depth=args.prefetch_depth, device=args.device,
        )
        return stats, time.time() - t0, checksum, sum(f.native_shards for f in feeders)

    print("warmup pass ...", file=sys.stderr)
    one_pass(0)
    results = [one_pass(1 + t) for t in range(max(args.trials, 1))]
    rates = [s.molecules / w for s, w, _, _ in results]
    best = int(np.argmax(rates))
    stats, wall, checksum, native_shards = results[best]
    device = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    payload = {
        "metric": "stream_from_disk_mols_per_s",
        "value": round(stats.molecules / wall, 1),
        "unit": "mols/s",
        "device": device,
        "molecules": int(stats.molecules),
        "superbatches": int(stats.batches),
        "superbatch": superbatch,
        "chunk": chunk,
        "wall_s": round(wall, 3),
        "out_dtype": args.out_dtype,
        "density": args.density,
        "dimension": args.dimension,
        "workers": args.workers,
        "wire": bool(args.wire),
        "presort": bool(args.presort),
        "native_shards": int(native_shards),
        "checksum": checksum,
    }
    if len(results) > 1:
        payload["trials"] = [round(r, 1) for r in rates]
        payload["median_mols_per_s"] = round(float(np.median(rates)), 1)
        payload["min_mols_per_s"] = round(float(min(rates)), 1)
        payload["max_mols_per_s"] = round(float(max(rates)), 1)
    print(json.dumps(payload))
    return 0


def _cmd_bench(args) -> int:
    """The port's headline: 64 copies of the 61-atom golden ligand, each with
    its own random rotation and 0.5 A translation, through
    ``Voxelizer.forward_batch`` into 64^3 x 4 gaussian bf16 grids; host
    clock around each call ending in a synchronize, median (min, max) of 7
    after 2 warm-ups.  Needs the card and ``tests/goldens``."""
    import torch

    from . import create_voxelizer

    if not torch.cuda.is_available():
        raise SystemExit("bench runs on the card: no CUDA device is available")
    golden = ROOT / "tests" / "goldens" / "lig_features_gaussian.npz"
    if not golden.exists():
        raise SystemExit(f"bench needs the golden ligand {golden}")
    lig = np.load(golden)
    coords = (lig["coords"] - lig["center"]).astype(np.float32)
    weights = (np.random.default_rng(0).uniform(size=(64, coords.shape[0], 4)) < 0.3).astype(np.float32)
    clouds = [(coords, weights[i]) for i in range(64)]
    vox = create_voxelizer(resolution=0.5, dimension=64, device="cuda")
    times = []
    for i in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vox.forward_batch(clouds, radii=1.0, random_translation=0.5, random_rotation=True, key=1234,
                          out_dtype="bfloat16")
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    print(json.dumps({"metric": "forward_batch_64lig_dim64_c4_bf16_ms", "value": med, "unit": "ms",
                      "min": min(times), "max": max(times), "mols_per_s": 64 / (med / 1e3),
                      "device": torch.cuda.get_device_name(0)}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="molvoxel-torch", description="molecular voxelization on CUDA (PyTorch)")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="environment report: torch, CUDA, card, nvcc, g++, native parser, rdkit")

    pv = sub.add_parser("voxelize", help="voxelize molecules from SDF/PDB/XYZ/MOL2")
    pv.add_argument("input", nargs="+", help="input file(s): .sdf/.sdf.gz (multi-record ok), .pdb, .xyz, .mol2")
    pv.add_argument("-o", "--output", help="output .npz (grids, channel names), or a directory for a sharded store")
    pv.add_argument("--dx", help="directory for per-channel OpenDX volumes (first molecule)")
    pv.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to voxelize (default: the card)")
    pv.add_argument("--dimension", type=int, default=64)
    pv.add_argument("--resolution", type=float, default=0.5)
    pv.add_argument("--density", default="gaussian", choices=["gaussian", "binary", "gaussian_notrunc"])
    pv.add_argument("--sigma", type=float, default=0.5)
    pv.add_argument("--radii", type=float, default=1.0)
    pv.add_argument("--radii-by-type", default=None, metavar="R1,R2,...",
                    help="per-channel radii for --throughput (one per channel incl. "
                    "Unknown); gathered on the card from the type lane, zero extra "
                    "wire bytes")
    pv.add_argument("--channels", default="C,N,O,S", help="comma-separated element channels")
    pv.add_argument("--unknown", action="store_true", help="add a catch-all Unknown channel")
    pv.add_argument("--bonds", action="store_true", help="add bond-midpoint channels")
    pv.add_argument("--hydrogens", action="store_true", help="keep hydrogens")
    pv.add_argument("--center", default="auto", choices=["auto", "origin"])
    pv.add_argument("--batch", type=int, default=None,
                    help="batch size (default: 64 for grids output, 4096 superbatch for --throughput)")
    pv.add_argument("--random-translation", type=float, default=0.0)
    pv.add_argument("--random-rotation", action="store_true")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--workers", type=int, default=2, help="parser threads for the vectorized SDF feeder")
    pv.add_argument("--chunk", type=int, default=1024, help="molecules a launch for --throughput")
    pv.add_argument("--prefetch-depth", type=int, default=4,
                    help="--throughput: staged superbatches in flight ahead of the launches")
    pv.add_argument("--out-dtype", default="float32", choices=["float32", "bfloat16", "float8_e4m3fn"],
                    help="grid dtype: f32 = parity lane, bf16 = training lane (2^-8 rel), "
                    "fp8 e4m3 = low-precision training lane (2^-4 rel)")
    pv.add_argument("--presort", action="store_true",
                    help="Morton-sort atoms on the host (skips the device sort; pays off for >128-atom buckets)")
    pv.add_argument("--shards", action="store_true",
                    help="force the sharded bounded-memory grid store even for .npz-suffixed -o paths")
    pv.add_argument("--npz-limit", type=int, default=20000,
                    help="max molecules for single-.npz output; larger runs must use the sharded store")
    pv.add_argument("--throughput", action="store_true",
                    help="measure end-to-end stream-from-disk mols/s (grids consumed on the card, not saved)")
    pv.add_argument("--wire", action="store_true",
                    help="--throughput: ship superbatches as ONE int16 fixed-point array (~0.5 mÅ) "
                    "assembled in C (8 B/atom, 1 transfer)")
    pv.add_argument("--full-read", action="store_true",
                    help="--throughput: sum every grid on the card instead of one grid per chunk (the witness read)")
    pv.add_argument("--trials", type=int, default=1,
                    help="--throughput: timed passes after warmup; reports the best plus the spread")

    sub.add_parser("bench", help="run the port's headline forward_batch timing on the card")

    args = parser.parse_args(argv)
    if args.command == "info":
        return _cmd_info(args)
    if args.command == "voxelize":
        return _cmd_voxelize(args)
    if args.command == "bench":
        return _cmd_bench(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
