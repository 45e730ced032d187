"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output, and each number the check
compared beside its limit last on standard error.  Exits non-zero, and
prints no result, without a CUDA device (it never falls back to the CPU),
or when the run loaded JAX or the JAX package.  Every build and kernel
cache goes to ``build/portbench/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
sys.path[0] = str(ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
