#!/usr/bin/env python3
"""Diagnostics of molvoxel_torch's forward kernel on one card: where a block's time goes, and build variants.

    python3 tools/torch_fwd_diag.py phases     # per-block phase times
    python3 tools/torch_fwd_diag.py variants   # compile-time variants, timed in turns

Both build patched copies of ``molvoxel_torch/csrc/deposit_fwd.cu`` into
``build/diag/`` (nvcc, as ``ops/_build.py`` does) and load them in place of
the kernel's own library, at the five main-path shapes of
``tools/torch_fwd_ab.py``.

``phases``: thread 0 of every block reads %globaltimer at the kernel's phase
boundaries and adds the nanoseconds to per-block sums: the range row and
active-chunk list, the wait for a staged chunk, the box test, the factor
tables, the pair loop, the store; with the active chunks and kept atoms.
One line per shape: the means over blocks, and the block with the longest
total.

``variants``: the kernel with other constants (accumulator budget, blocks
per SM in the launch bounds, cp.async ring depth), each built once and timed
by CUDA-graph replay in turns (A, B, ..., ..., B, A); one line per shape
with the median of each.  Each line carries the variant's ptxas registers
and spills first.
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
SOURCE = ROOT / "molvoxel_torch" / "csrc" / "deposit_fwd.cu"
OUT = ROOT / "build" / "diag"

ACC = "constexpr int kAccMax = 32;"
BOUNDS = "__launch_bounds__(kMaxThreads, 3)"
STAGES = "constexpr int kStages = 4;"
# name: (source substitutions, the accumulator budget the Python side plans with)
VARIANTS = {
    "acc32_3_per_sm": ({}, 32),
    "acc64_2_per_sm": ({ACC: ACC.replace("32", "64"), BOUNDS: BOUNDS.replace("3)", "2)")}, 64),
    "acc32_4_per_sm": ({BOUNDS: BOUNDS.replace("3)", "4)")}, 32),
    "acc32_2_per_sm": ({BOUNDS: BOUNDS.replace("3)", "2)")}, 32),
    "acc32_3_per_sm_ring2": ({STAGES: STAGES.replace("4", "2")}, 32),
}

PHASES = ("ranges", "wait", "box_test", "tables", "pairs", "store")
MARK = "if (threadIdx.x == 0) { const long long t_ = gtime(); prof[%d] += t_ - last_; last_ = t_; }"
# (line of the kernel, what to put after it; None: the range row's mark, put before it)
PHASE_MARKS = (
    ("      for (int k = 0; k < kCT; ++k) acc[p][i][k] = 0.0f;",
     "  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long last_ = gtime();"),
    ("    if (n_act == 0) continue;  // uniform across the block", None),
    ("    for (int n = 0; n < n_act; ++n) {", MARK % 4),
    ("      __syncthreads();  // chunk n has landed; the previous chunk's readers are done", MARK % 1),
    ("      const int per = a.dt + kh + kw;  // table entries of one atom: ex[dt], ey[kh], ez[kw]",
     (MARK % 2) + " prof[7] += nk;"),
    ("            s_tab[e] = d2 <= s_keep[3 * kChunk + j] ? expf(d2 * s_keep[4 * kChunk + j]) : 0.0f;\n"
     "          }\n          __syncthreads();", MARK % 3),
)


def patched(subs: dict[str, str]) -> str:
    src = SOURCE.read_text()
    for old, new in subs.items():
        if src.count(old) != 1:
            raise SystemExit(f"torch_fwd_diag: the kernel source no longer has exactly one {old!r}")
        src = src.replace(old, new)
    return src


def phase_source() -> str:
    subs = {old: f"{old}\n{new}" if new else f"{MARK % 0} prof[6] += n_act;\n{old}" for old, new in PHASE_MARKS}
    subs["namespace {\n"] = (
        "namespace {\n__device__ long long g_prof[1 << 20];\n"
        "__device__ __forceinline__ long long gtime() {\n  long long v;\n"
        "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(v));\n  return v;\n}\n"
    )
    store = "  OutT* out = static_cast<OutT*>(a.out);"
    subs[store] = (MARK % 4) + "\n" + store
    end = "          if (w0 + i < a.dim) dst[i] = cast_out<OutT>(v[i]);\n      }\n    }\n  }\n"
    subs[end] = end + (MARK % 5) + "\n  if (threadIdx.x == 0 && blockIdx.x < (1 << 17)) {\n" \
        "    for (int q = 0; q < 8; ++q) g_prof[blockIdx.x * 8 + q] = prof[q];\n  }\n"
    return patched(subs) + '\nextern "C" int diag_read(long long* h, int n) {\n' \
        '  return static_cast<int>(cudaMemcpyFromSymbol(h, g_prof, n * sizeof(long long)));\n}\n'


def build(sources: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile each named source in parallel -> {name: (library, ptxas report)}."""
    from molvoxel_torch.ops import _build

    procs = []
    for name, src in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "deposit_fwd.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libdeposit_fwd.so"), str(d / "deposit_fwd.cu")]
        procs.append((name, d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{report}")
        libs[name] = (ctypes.CDLL(str(d / "libdeposit_fwd.so")), report)
    return libs


def use(lib, acc_max):
    from molvoxel_torch.ops import _build, deposit

    deposit.ACC_MAX = acc_max
    _build._loaded["deposit_fwd"] = lib


def prepared(dev):
    from molvoxel_torch.ops import deposit
    from torch_fwd_ab import shapes

    for label, coords, w, radii, mask, spec, density, odt in shapes(dev):
        def prep():
            return deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask, density_type=density)
        yield label, spec, odt, prep


def phases(dev):
    import numpy as np
    import torch

    from chip_smoke import emit
    from molvoxel_torch.ops import deposit

    lib, _ = build({"phases": phase_source()})["phases"]
    use(lib, deposit.ACC_MAX)
    lib.diag_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for label, spec, odt, prep in prepared(dev):
        rows, wt, ranges, dl, gaussian = prep()
        info = deposit.fwd_launch_info(wt.shape[0], wt.shape[1], wt.shape[2], dl, spec.dimension, gaussian, odt)
        deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)
        torch.cuda.synchronize()
        n = min(info["blocks"], 1 << 17)
        buf = np.zeros(n * 8, np.int64)
        if lib.diag_read(buf.ctypes.data, n * 8) != 0:
            raise SystemExit("torch_fwd_diag: reading the phase sums failed")
        buf = buf.reshape(n, 8)
        total = buf[:, :6].sum(axis=1)
        worst = int(np.argmax(total))
        names = PHASES + ("active_chunks", "kept_atoms")
        emit({"phase": "phases", "case": label, "blocks": n, "brick": info,
              "mean_ns": {k: float(buf[:, i].mean()) for i, k in enumerate(names)},
              "longest_block_ns": {k: int(buf[worst, i]) for i, k in enumerate(names)},
              "median_block_total_ns": float(np.median(total)), "longest_block_total_ns": int(total.max())})


def variants(dev):
    from chip_smoke import emit, time_graph_ms
    from molvoxel_torch.ops import deposit

    default_acc = deposit.ACC_MAX
    libs = build({name: patched(subs) for name, (subs, _) in VARIANTS.items()})
    for name, (_, report) in libs.items():
        regs = sorted({int(ln.split("Used ")[1].split(" registers")[0]) for ln in report.splitlines()
                       if "registers" in ln})
        spills = sorted({ln.strip() for ln in report.splitlines()
                         if "spill" in ln and not ln.strip().startswith("0 bytes stack")})
        emit({"phase": "variant_build", "variant": name, "registers": regs, "spills": spills})
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for label, spec, odt, prep in prepared(dev):
        times = {name: [] for name in VARIANTS}
        for name in order:
            use(libs[name][0], VARIANTS[name][1])
            rows, wt, ranges, dl, gaussian = prep()
            times[name].append(time_graph_ms(lambda: deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl,
                                                                         gaussian=gaussian, out_dtype=odt)))
        emit({"phase": "variants", "case": label, **{name: statistics.median(t) for name, t in times.items()}})
    deposit.ACC_MAX = default_acc


def main() -> int:
    import torch

    if len(sys.argv) != 2 or sys.argv[1] not in ("phases", "variants"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_fwd_diag: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import emit, nvidia_smi

    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    (phases if sys.argv[1] == "phases" else variants)(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
