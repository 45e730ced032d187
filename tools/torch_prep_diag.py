#!/usr/bin/env python3
"""Where a block of molvoxel_torch's preparation kernel spends its time, on one card.

    python3 tools/torch_prep_diag.py

Builds a copy of ``molvoxel_torch/csrc/deposit_prep.cu`` into
``build/diag/`` in which thread 0 of every block reads ``clock64`` at the
kernel's phase boundaries (and ``%globaltimer`` at its entry and exit)
into a device array, and loads it in place of the kernel's own library.
The source is patched by exact lines; the tool stops if one is gone.

At the shapes of ``tools/torch_prep_ab.py`` it launches the preparation
once and reads every block's marks, by the path the molecule takes.  For
shares of up to ``PREP_SEARCH_SHARE`` atoms (search_sort): the keys and
the ranks in the block's share, the wait for the cluster to start, the share stored into
every block and the barrier after it, the searches, the words stored to
their ranks and the barrier.  Above (radix_sort): the keys, and in each
digit pass the ranks, the counts stored over the cluster and the barrier,
the digit offsets, the scatter and the barrier.  Then the gather of the
first slice of output atoms, the plane ranges and any later slices, and
the last cluster barrier.  One JSON line per shape: each phase's cycles
averaged over blocks and for the block that took longest, the spread of
the blocks' entry times and the span from the first entry to the last exit
on the global timer (ns), and the patched kernel's time by CUDA-graph
replay (the marks cost a little).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
SOURCE = ROOT / "molvoxel_torch" / "csrc" / "deposit_prep.cu"
OUT = ROOT / "build" / "diag"
SLOTS = 32  # marks a block: clock64 at the points of MARKS, then %globaltimer at entry and exit (slots 30, 31)
MAX_BLOCKS = 16384

HEADER = """
__device__ long long g_marks[%d * %d];
__device__ __forceinline__ long long gtime_() {
  long long v;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(v));
  return v;
}
#define MARK_(k) do { if (threadIdx.x == 0 && blockIdx.x < %d) g_marks[blockIdx.x * %d + (k)] = clock64(); } while (0)
#define GMARK_(k) do { if (threadIdx.x == 0 && blockIdx.x < %d) g_marks[blockIdx.x * %d + (k)] = gtime_(); } while (0)
""" % (MAX_BLOCKS, SLOTS, MAX_BLOCKS, SLOTS, MAX_BLOCKS, SLOTS)
ACCESS = """
extern "C" int deposit_prep_marks(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_marks, sizeof(long long) * n));
}
extern "C" int deposit_prep_clear_marks() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_marks);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) * %d * %d);
  return static_cast<int>(e);
}
""" % (MAX_BLOCKS, SLOTS)
# (line of the kernel, text before it, text after it)
MARKS = (
    ("namespace cg = cooperative_groups;", "", HEADER),
    ("  extern __shared__ __align__(16) uint32_t smem[];", "", "  MARK_(0);\n  GMARK_(30);"),
    # search_sort: 1-7
    ("  cluster_wait();", "  MARK_(1);", "  MARK_(2);"),
    ("  cluster.sync();  // every share is in every block", "  MARK_(3);", "  MARK_(4);"),
    ("  for (int k = threadIdx.x; k < len; k += blockDim.x) {", "  MARK_(5);", ""),
    ("  cluster.sync();  // every sorted word is in place", "  MARK_(6);", "  MARK_(7);"),
    # radix_sort: 8-16, pass p at 9 + 4 p ... 12 + 4 p
    ("  for (int pass = 0; pass < 2; ++pass) {", "  MARK_(8);", ""),
    ("    int n = rank_words(word, order, sm.hist, items, swarps, len, shift);", "", "    MARK_(9 + 4 * pass);"),
    ("    cluster.sync();  // every block's counts are in place, and its words are in registers", "",
     "    MARK_(10 + 4 * pass);"),
    ("    // the scatter", "    MARK_(11 + 4 * pass);", ""),
    ("    cluster.sync();  // every word of this pass is in place, and the counts of this pass are read", "",
     "    MARK_(12 + 4 * pass);"),
    ("    __syncthreads();  // the staged atoms are read below", "", "    if (s0 == vc0) MARK_(20);"),
    ("  if (sorted_here && remote_ranks) cluster.sync();  // no block exits while another may still read its "
     "sort words", "  MARK_(21);", "  MARK_(22);\n  GMARK_(31);"),
)
# (slot, the phase that ends there), for each path
TAIL = ((20, "gather_first_slice"), (21, "ranges_and_later_slices"), (22, "last_cluster_sync"))
PATHS = {
    "none": TAIL,
    "search": ((1, "keys_and_share_ranks"), (2, "start_wait"), (3, "share_stores"), (4, "cluster_sync_shares"),
               (5, "searches"), (6, "rank_stores"), (7, "cluster_sync_words")) + TAIL,
    "radix": ((8, "keys"),) + tuple((9 + 4 * p + k, f"{d}_{n}") for p, d in enumerate(("lo", "hi"))
                                    for k, n in enumerate(("rank", "counts_and_sync", "base", "scatter_and_sync")))
    + TAIL,
}


# name: the lines it replaces (timing only: the ablations give wrong outputs)
PAIR_MATH = "        if (!(s2 < 0.0f)) {  // else the atom misses the tile: (Dl, 0), the bounds lo and hi start from"
PAIRS = "    for (int pair = warp; pair < npairs; pair += nwarps) {"
VARIANTS = {
    "base": {},
    "ablate_pair_math": {PAIR_MATH: "        if (false) {"},
    "ablate_pairs": {PAIRS: PAIRS.replace("int pair = warp;", "int pair = npairs;")},
}


def patched_source() -> str:
    lines = SOURCE.read_text().splitlines()
    for anchor, before, after in MARKS:
        hits = [i for i, ln in enumerate(lines) if ln == anchor]
        if len(hits) != 1:
            raise SystemExit(f"torch_prep_diag: {anchor!r} is in deposit_prep.cu {len(hits)} times, not once")
        i = hits[0]
        lines[i:i + 1] = ([before] if before else []) + [anchor] + ([after] if after else [])
    return "\n".join(lines) + "\n"


def patched(subs: dict[str, str]) -> str:
    """deposit_prep.cu with each line of ``subs`` replaced (exact lines)."""
    lines = SOURCE.read_text().splitlines()
    for old, new in subs.items():
        hits = [i for i, ln in enumerate(lines) if ln == old]
        if len(hits) != 1:
            raise SystemExit(f"torch_prep_diag: {old!r} is in deposit_prep.cu {len(hits)} times, not once")
        lines[hits[0]] = new
    return "\n".join(lines) + "\n"


def build(name: str, source: str) -> ctypes.CDLL:
    from molvoxel_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"deposit_prep_{name}.cu"
    src.write_text(source)
    lib_path = OUT / f"libdeposit_prep_{name}.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise SystemExit(f"nvcc failed for deposit_prep.cu ({name}):\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.ptxas = [ln.strip() for ln in run.stdout.splitlines() if "registers" in ln or "spill" in ln]
    return lib


def use(lib):
    """Make the wrapper launch ``lib`` (readied on the card at its next launch)."""
    from molvoxel_torch.ops import _build, deposit

    _build._loaded["deposit_prep"] = lib
    deposit._WIDE_CLUSTERS.clear()


def variants(dev, names):
    """Each variant built once and timed by CUDA-graph replay in turns (the
    listed order, then reversed) at every shape; one line per shape."""
    import statistics

    from chip_smoke import emit, time_graph_ms
    from molvoxel_torch.ops import deposit
    from torch_prep_ab import shapes

    libs = {name: build(name, patched(VARIANTS[name])) for name in names}
    for name, lib in libs.items():
        emit({"phase": "variant_build", "variant": name, "ptxas": lib.ptxas})
    for label, inputs, plan in shapes(dev):
        times = {name: [] for name in names}
        for name in list(names) + list(reversed(names)):
            use(libs[name])
            times[name].append(time_graph_ms(lambda: deposit.deposit_prep(*inputs, plan)))
        emit({"phase": "variants", "case": label, "ms": {n: statistics.median(t) for n, t in times.items()}})


def phases(dev):
    import numpy as np
    import torch

    from chip_smoke import emit, time_graph_ms
    from molvoxel_torch.ops import deposit
    from torch_prep_ab import shapes

    src = patched_source() + ACCESS
    lib = build("marks", src)
    lib.deposit_prep_marks.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    lib.deposit_prep_marks.restype = ctypes.c_int
    lib.deposit_prep_clear_marks.restype = ctypes.c_int
    use(lib)
    for label, inputs, plan in shapes(dev):
        got = deposit.deposit_prep(*inputs, plan)  # plans the launch and readies the kernel
        b, vp, vo = inputs[0].shape[0], got.perm.shape[1], got.rows.shape[2]
        sort = plan.sort and vp > deposit.CHUNK
        launch = deposit.prep_launch(b, vp, vo, got.ranges.shape[1], sort, deposit._WIDE_CLUSTERS[inputs[0].device])
        blocks = min(b * launch.split, MAX_BLOCKS)
        torch.cuda.synchronize()
        if lib.deposit_prep_clear_marks() != 0:
            raise SystemExit("torch_prep_diag: clearing the marks failed")
        deposit.deposit_prep(*inputs, plan)
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * (MAX_BLOCKS * SLOTS))()
        if lib.deposit_prep_marks(host, MAX_BLOCKS * SLOTS) != 0:
            raise SystemExit("torch_prep_diag: reading the marks failed")
        marks = np.ctypeslib.as_array(host).reshape(MAX_BLOCKS, SLOTS)[:blocks].astype(np.int64)
        path = "none" if not sort else "search" if launch.seg <= deposit.PREP_SEARCH_SHARE else "radix"
        slots = [0] + [k for k, _ in PATHS[path]]
        clock = marks[:, slots].copy()
        for k in range(1, len(slots)):  # a mark a block did not pass (no last barrier) takes no time
            clock[:, k] = np.where(clock[:, k] == 0, clock[:, k - 1], clock[:, k])
        phase = np.diff(clock, axis=1)
        total = clock[:, -1] - clock[:, 0]
        slow = int(np.argmax(total))
        names = [n for _, n in PATHS[path]]
        gtime = marks[:, 30:32]
        emit({"phase": "prep_diag", "case": label, "batch": b, "padded_atoms": vp, "launch": launch._asdict(),
              "blocks": blocks, "sort": path, "cycles_mean": dict(zip(names, phase.mean(0).tolist())),
              "cycles_slowest_block": dict(zip(names, phase[slow].tolist())),
              "cycles_total_mean": float(total.mean()), "cycles_total_max": int(total.max()),
              "entry_spread_ns": int(gtime[:, 0].max() - gtime[:, 0].min()),
              "first_entry_to_last_exit_ns": int(gtime[:, 1].max() - gtime[:, 0].min()),
              "block_ns_median": float(statistics.median((gtime[:, 1] - gtime[:, 0]).tolist())),
              "patched_kernel_ms": time_graph_ms(lambda: deposit.deposit_prep(*inputs, plan))})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_prep_diag: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import emit, nvidia_smi

    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    if len(sys.argv) > 1 and sys.argv[1] == "variants":
        variants(dev, sys.argv[2:] or list(VARIANTS))
    else:
        phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
