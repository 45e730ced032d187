#!/usr/bin/env python3
"""Time the entry points on the host clock in two checkouts, in alternating processes, on one card.

    python3 tools/torch_host_ab.py <parent checkout> <new checkout> [--pairs 10]

Each run is a fresh process that imports ``molvoxel_torch`` (and
``chip_smoke.load_golden``) from one checkout, builds its kernels there, and
times calls on the host clock, each ending in ``torch.cuda.synchronize()``:
``chip_smoke.py``'s headline ``forward_batch`` (64 ligands of 61 atoms,
64^3 x 4, bf16, random rotation and 0.5 A translation), ``forward_single``
of the 3262-atom protein at 48^3 (f32), and ``forward_batch`` at the two
benchmark cells' shapes (this tool's ``chip_smoke.staging_cells``: 16
complexes of 3,323 atoms at 48^3 x 1, f32; 64 ligands of 20-61 atoms at
64^3 x 4, bf16; 32 calls of each cell in turn); the median of 30 calls
after 3 warm-ups.  Each run also hashes the grids of the headline call
and of the cells' 32 calls (SHA-256 of their bytes, one call at a time),
so that the two checkouts' grids are held bit for bit.  The pairs
alternate which checkout runs first (parent, new; new, parent; ...).  One
JSON line per run, then one per call with both sides' runs, their
medians, the parent runs' spread (the distance between their quartiles)
and the pairs the new checkout won; for the headline call and each cell
the sum of the API spans ``molvoxel.channels``, ``pad`` and ``copy_in`` a
call under a torch.profiler session (CPU and CUDA) of 64 calls, as a
traced benchmark run reads them; and last whether every run's grids
agreed.  The card's ``nvidia-smi`` name and
power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOOL_ROOT = Path(__file__).resolve().parents[1]
CALLS = ("forward_batch_64lig_dim64_c4_bf16", "forward_single_protein_dim48_f32", "complex48.batch16",
         "ligand64.batch64")


def cells():
    """This checkout's ``chip_smoke.staging_cells``, whichever checkout the
    package comes from (goldens and numpy only)."""
    spec = importlib.util.spec_from_file_location("staging_inputs", TOOL_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.staging_cells()


API_SPANS = ("molvoxel.channels", "molvoxel.pad", "molvoxel.copy_in", "molvoxel.forward_batch")


def traced_spans(fns, calls: int = 64) -> dict:
    """Each call's mean host ms in the API layer's spans under a
    torch.profiler session (CPU and CUDA, as a traced benchmark run), over
    ``calls`` calls each ending in a synchronize, and their wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from molvoxel_torch.utils import timing

    out = {}
    for name, fn in fns.items():
        with timing.span("molvoxel.untraced"):  # the session below starts a record of its own
            pass
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = timing.snapshot()["spans"]
        out[name] = {"call_ms": wall / calls * 1e3,
                     **{k: spans[k]["total_s"] / calls * 1e3 for k in API_SPANS if k in spans}}
    return out


def child(root: Path) -> int:
    """One run in the checkout ``root``: prints {call: median host ms}."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from chip_smoke import load_golden
    from molvoxel_torch import create_voxelizer
    from molvoxel_torch.ops import _build

    _build.build_all()
    lig, prot = load_golden("lig_features_gaussian"), load_golden("protein_single_gaussian")
    lig_np = (lig["coords"] - lig["center"]).astype(np.float32)
    weights = (np.random.default_rng(0).uniform(size=(64, 61, 4)) < 0.3).astype(np.float32)
    clouds = [(lig_np, weights[i]) for i in range(64)]
    vox64 = create_voxelizer(device="cuda", resolution=0.5, dimension=64)
    vox48 = create_voxelizer(device="cuda", resolution=0.5, dimension=48)
    fns = {CALLS[0]: lambda i: vox64.forward_batch(clouds, radii=1.0, random_translation=0.5, random_rotation=True,
                                                   key=1234, out_dtype="bfloat16"),
           CALLS[1]: lambda i: vox48.forward_single(prot["coords"], prot["center"], 1.0)}
    headline = fns[CALLS[0]](0)  # a fixed key: its grids are held too
    digests = {CALLS[0]: hashlib.sha256(headline.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()}
    for name, (vox_kw, calls) in cells().items():
        vox = create_voxelizer(device="cuda", **vox_kw)
        fns[name] = lambda i, vox=vox, calls=calls: vox.forward_batch(**calls[i % len(calls)])
        h = hashlib.sha256()
        for kw in calls:
            grid = vox.forward_batch(**kw)
            h.update(grid.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
    out = {}
    for name, fn in fns.items():
        times = []
        for i in range(33):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    out["grids_sha256"] = digests
    out["traced"] = traced_spans({name: fns[name] for name in digests})
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(Path(sys.argv[2]).resolve())
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"phase": "card", "nvidia_smi": smi}), flush=True)
    runs = {"parent": [], "new": []}
    for pair in range(args.pairs):
        for side in ("parent", "new") if pair % 2 == 0 else ("new", "parent"):
            done = subprocess.run([sys.executable, __file__, "--child", str(getattr(args, side).resolve())],
                                  capture_output=True, text=True, timeout=600)
            if done.returncode != 0:
                print(done.stdout + done.stderr, file=sys.stderr)
                return 1
            got = json.loads(done.stdout.strip().splitlines()[-1])
            runs[side].append(got)
            print(json.dumps({"phase": "host_run", "pair": pair, "side": side, **got}), flush=True)
    for name in CALLS:
        par = [r[name] for r in runs["parent"]]
        new = [r[name] for r in runs["new"]]
        q = statistics.quantiles(par, n=4)
        print(json.dumps({"phase": "host_ab", "call": name, "parent_ms": par, "new_ms": new,
                          "parent_median_ms": statistics.median(par), "new_median_ms": statistics.median(new),
                          "parent_quartile_spread_ms": q[2] - q[0],
                          "new_won_pairs": sum(n < p for n, p in zip(new, par)), "pairs": len(par)}), flush=True)
    for name in (CALLS[0], *CALLS[2:]):
        sums = {side: [sum(v for k, v in r["traced"][name].items() if k in API_SPANS[:3]) for r in rs]
                for side, rs in runs.items()}
        print(json.dumps({"phase": "host_ab_traced", "call": name, "spans": list(API_SPANS[:3]),
                          "parent_sum_ms": sums["parent"], "new_sum_ms": sums["new"],
                          "parent_median_ms": statistics.median(sums["parent"]),
                          "new_median_ms": statistics.median(sums["new"])}), flush=True)
    digests = {json.dumps(r["grids_sha256"], sort_keys=True) for side in runs.values() for r in side}
    print(json.dumps({"phase": "host_ab_grids", "bit_for_bit": len(digests) == 1,
                      "sha256": [json.loads(d) for d in sorted(digests)]}), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
