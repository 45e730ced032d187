#!/usr/bin/env python3
"""Time the entry points on the host clock in two checkouts, in alternating processes, on one card.

    python3 tools/torch_host_ab.py <parent checkout> <new checkout> [--pairs 10]

Each run is a fresh process that imports ``molvoxel_torch`` (and
``chip_smoke.load_golden``) from one checkout, builds its kernels there, and
times two calls of ``chip_smoke.py``'s main path on the host clock, each
ending in ``torch.cuda.synchronize()``: the headline ``forward_batch`` (64
ligands of 61 atoms, 64^3 x 4, bf16, random rotation and 0.5 A translation)
and ``forward_single`` of the 3262-atom protein at 48^3 (f32); the median
of 30 calls after 3 warm-ups.  The pairs alternate which checkout runs
first (parent, new; new, parent; ...).  One JSON line per run, then one per
call with both sides' runs, their medians, the parent runs' spread (the
distance between their quartiles) and the pairs the new checkout won.
The card's ``nvidia-smi`` name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = ("forward_batch_64lig_dim64_c4_bf16", "forward_single_protein_dim48_f32")


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
    fns = {CALLS[0]: lambda: vox64.forward_batch(clouds, radii=1.0, random_translation=0.5, random_rotation=True,
                                                 key=1234, out_dtype="bfloat16"),
           CALLS[1]: lambda: vox48.forward_single(prot["coords"], prot["center"], 1.0)}
    out = {}
    for name, fn in fns.items():
        times = []
        for i in range(33):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
