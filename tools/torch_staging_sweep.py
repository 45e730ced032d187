#!/usr/bin/env python3
"""Time forward_batch's two placements of a padded batch against each other on this host.

    python3 tools/torch_staging_sweep.py [--reps 300] [--out build/staging_sweep.jsonl]

``data/staging.stage_batch`` writes a batch into its pinned slot either by
per-molecule slices or by one concatenate and one gather, and picks the
gather where a batch holds at most ``GATHER_MAX_ATOMS`` atoms a molecule.
This times both on the same inputs, in turns, into one pinned buffer (as
the card's path does): batches of 16 and 64 molecules of U(m/2, 3m/2)
atoms for mean sizes m from 16 to 3,323, 4 typed channels, centers and a
scalar radius; the median microseconds of ``--reps`` calls each.  One JSON
line per shape, then the largest mean at which the gather won at both batch
sizes beside the constant in use.  Runs on the CPU alone (a pinned buffer
where a CUDA device is present).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from molvoxel_torch.core.config import small_atom_bucket  # noqa: E402
from molvoxel_torch.data import staging  # noqa: E402

MEANS = (16, 24, 32, 48, 64, 96, 128, 192, 256, 320, 384, 512, 768, 1024, 2048, 3323)


def batch(b: int, mean: int, rng):
    sizes = rng.integers(max(1, mean // 2), mean + mean // 2 + 1, b)
    coords = [rng.normal(scale=5.0, size=(int(v), 3)).astype(np.float32) for v in sizes]
    types = [rng.integers(0, 4, int(v)) for v in sizes]
    centers = rng.normal(size=(b, 3)).astype(np.float32)
    return coords, types, np.asarray(sizes, np.int64), centers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    pinned = torch.cuda.is_available()
    in_use = staging.GATHER_MAX_ATOMS
    rng = np.random.default_rng(0)
    lines, won = [], {}
    for b in (16, 64):
        for mean in MEANS:
            coords, types, counts, centers = batch(b, mean, rng)
            vp = small_atom_bucket(int(counts.max()))
            layout = staging.batch_layout(b, vp, 4, (vp,), True)
            buf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=pinned)
            arrays = layout.host(buf.numpy())
            times = {"slices": [], "gather": []}
            for rep in range(args.reps + 5):
                for name, limit in (("slices", -1), ("gather", 10**9)) if rep % 2 else (("gather", 10**9),
                                                                                       ("slices", -1)):
                    staging.GATHER_MAX_ATOMS = limit
                    t0 = time.perf_counter()
                    staging.stage_batch(arrays, coords, types, counts, True, 1.0, centers)
                    if rep >= 5:
                        times[name].append((time.perf_counter() - t0) * 1e6)
            line = {"batch": b, "mean_atoms": mean, "vp": vp, "pinned": pinned,
                    **{f"{k}_us": statistics.median(v) for k, v in times.items()}}
            line["gather_wins"] = line["gather_us"] < line["slices_us"]
            won.setdefault(b, []).append((mean, line["gather_wins"]))
            lines.append(line)
            print(json.dumps(line), flush=True)
    # the largest mean up to which the gather won every shape, at both batch sizes
    upto = min(max([0] + [m for m, _ in ws[:next((i for i, (_, w) in enumerate(ws) if not w), len(ws))]])
               for ws in won.values())
    staging.GATHER_MAX_ATOMS = in_use
    summary = {"phase": "staging_sweep", "gather_won_up_to_mean_atoms": upto, "GATHER_MAX_ATOMS": in_use}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
