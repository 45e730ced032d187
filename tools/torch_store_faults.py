"""Readings of a grid store cell with each of the store's planted faults, many seeds in one process, on the card.

    python3 tools/torch_store_faults.py --workload ligand64.store --seconds 5 --seeds <n> [<n> ...] \
        [--faults raised_voxel last_batch_lost empty_slot_dropped manifest_not_final]

Each seed is a whole run of the cell (``portbench.harness.run_cell``: set-up,
a window of ``--seconds``, the check) with one fault of
``portbench/store_faults.py`` planted, and prints one JSON line; every run
must read ``correct`` false.  The program's and the control's readings come
from ``portbench/calibrate.py``.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from portbench import harness, store_faults  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ligand64.store")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=sorted(store_faults.FAULTS), choices=sorted(store_faults.FAULTS))
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, _ = harness.find_cell(bench, args.workload)
    harness.prepare_card(int(cell.get("chips", 1)))
    harness.enable_cache()
    import torch

    caught = True
    for fault in args.faults:
        for seed in args.seeds:
            t0 = time.perf_counter()
            with store_faults.FAULTS[fault]():
                result, checks = harness.run_cell(args.workload, seed, args.seconds, False)
            torch.cuda.empty_cache()
            caught &= not result["correct"]
            print(json.dumps({"workload": args.workload, "variant": fault, "seed": seed,
                              "seconds": time.perf_counter() - t0, "correct": result["correct"],
                              "failed": result["failed"], "attempted": result["attempted"],
                              "checks": {c.name: c.value for c in checks}, "device": result["device"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    raise SystemExit(main())
