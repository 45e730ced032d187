"""The readings the check's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] \
        [--variant program|control|half_batch|altered_answer]

``program`` reads the compared numbers of sound runs (the lower readings);
``control`` runs the configuration's next lower precision in the program's
place; the other variants plant a fault (``faults.py``).  Each seed is a
whole run of the cell (set-up, a window of ``--seconds``, the check) and
prints one JSON line.  Not run by the benchmark's own runs.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from portbench import faults, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", default="program")
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, _ = harness.find_cell(bench, args.workload)
    harness.prepare_card(int(cell.get("chips", 1)))
    harness.enable_cache()
    driver = harness.load_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")["driver"]
    import torch

    for seed in args.seeds:
        plant = faults.FAULTS[args.variant](driver) if args.variant in faults.FAULTS else contextlib.nullcontext()
        t0 = time.perf_counter()
        with plant:
            result, checks = harness.run_cell(args.workload, seed, args.seconds, False,
                                              variant="control" if args.variant == "control" else "program")
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "seconds": time.perf_counter() - t0, "correct": result["correct"],
                          "checks": {c.name: c.value for c in checks}, "metrics": result["metrics"],
                          "device": result["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
