"""How often the first torch.exp of a process returns wrong values, on the CPU.

    python tools/torch_first_exp_probe.py [--runs 40] [--dtype float32|float64] [--warm]

Each run is a fresh interpreter that draws a (61, 48, 48, 48) tensor (the
size of a dense-path density slab, which torch splits over its threads),
calls ``torch.exp`` on it twice, and reports whether the two results differ
and the first one's largest relative error against the second.  With
``--warm`` each process first calls exp on one element, as importing
molvoxel_torch does.  Prints one JSON line: runs, runs whose first call was
wrong, the largest relative error seen, torch's version and thread count.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = """
import json, sys, torch
dtype = getattr(torch, sys.argv[1])
if sys.argv[2] == "warm":
    torch.exp(torch.zeros(1, dtype=dtype))
x = -torch.rand(61, 48, 48, 48, generator=torch.Generator().manual_seed(0), dtype=dtype) * 4
first, second = torch.exp(x), torch.exp(x)
print(json.dumps({"differ": not torch.equal(first, second),
                  "max_rel_err": float(((first - second).abs() / second).max()),
                  "torch": torch.__version__, "threads": torch.get_num_threads()}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--warm", action="store_true", help="call exp on one element first")
    args = ap.parse_args()
    results = []
    for _ in range(args.runs):
        out = subprocess.run([sys.executable, "-c", CHILD, args.dtype, "warm" if args.warm else "cold"],
                             capture_output=True, text=True, check=True, timeout=300)
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"runs": args.runs, "dtype": args.dtype, "warm": args.warm,
                      "first_call_wrong": sum(r["differ"] for r in results),
                      "max_rel_err": max(r["max_rel_err"] for r in results),
                      "torch": results[0]["torch"], "threads": results[0]["threads"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
