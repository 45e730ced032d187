#!/usr/bin/env python3
"""Diagnostics of molvoxel_torch's backward kernel on one card: where a warp's time goes, and build variants.

    python3 tools/torch_bwd_diag.py phases              # per-warp phase times
    python3 tools/torch_bwd_diag.py variants [name ...] # compile-time variants, timed in turns

Both build patched copies of ``molvoxel_torch/csrc/deposit_bwd.cu`` into
``build/diag_bwd/`` (nvcc, as ``ops/_build.py`` does) and load them in place
of the kernel's own library, at the seven shapes of ``tools/torch_bwd_ab.py``.

``phases``: lane 0 of every warp reads %globaltimer at the kernel's phase
boundaries and adds the nanoseconds to per-warp sums: staging the block's
atoms, the box and the ez table, the planes' h-spans, the rows' terms and
w-spans, the walk over the pairs (loads and arithmetic), and the reductions
with the gradients' stores; with the rows and the walk's batches.
One line per shape: the means over warps, and the warp with the longest
total.

``variants``: the kernel with other constants (blocks per SM in the launch
bounds, pairs a lane loads before it uses any, warps a block), or with a part cut out
(``ablate_*``: wrong gradients, for the time of what is left), each built
once and timed by CUDA-graph replay in turns (A, B, ..., ..., B, A); one
line per shape with the median of each, and each variant's gradients
against the first's.
Each variant's ptxas registers and spills come first.  With names, only
those variants run.  Needs one CUDA card.
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
SOURCE = ROOT / "molvoxel_torch" / "csrc" / "deposit_bwd.cu"
OUT = ROOT / "build" / "diag_bwd"

BOUNDS = "constexpr int kMinBlocks = 4;"
WIDE = "constexpr int kMinBlocksWide = 2;"
PAIRS = "constexpr int kPairs = kCT == 4 ? 1 : 2;"
VARIANTS = {
    "default": {},
    "3_per_sm": {BOUNDS: BOUNDS.replace("4", "3")},
    "wide_3_per_sm": {WIDE: WIDE.replace("2", "3")},
    "pairs_x2": {PAIRS: "constexpr int kPairs = kCT == 4 ? 2 : 4;"},
    "blocks_128": {"constexpr int kLgWarps = 3;": "constexpr int kLgWarps = 2;"},
    # ablations (wrong gradients, for timing only): no pair walk; no rows or
    # walk; no planes, rows or walk (staging, box, table, reductions, stores)
    "ablate_pairs": {"        for (int p0 = 0; p0 < total; p0 += 32 * kPairs) {":
                     "        for (int p0 = 0; p0 < 0; p0 += 32 * kPairs) {"},
    "ablate_rows": {"      for (int q0 = part * share; q0 < rend; q0 += 32) {": "      for (int q0 = 0; q0 < 0; q0 += 32) {"},
    "ablate_planes": {"    for (int pc = 0; pc < nd; pc += 32) {": "    for (int pc = 0; pc < 0; pc += 32) {"},
}


PHASES = ("stage", "box_table", "planes", "rows", "walk", "reduce_store")
MARK = "if (lane == 0) { const long long t_ = gtime(); prof[%d] += t_ - last_; last_ = t_; }"
# (line of the kernel, what to put after it)
PHASE_MARKS = (
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;",
     "  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long last_ = gtime();"),
    ("  __syncthreads();\n\n  const int j = warp >> lg_wpa", None),
    ("    s_ez[warp][e] = expf(dz2 * cf);\n  }\n  __syncwarp();", MARK % 1),
    ("      const int rend = min(prows, (part + 1) * share);", (MARK % 2) + " prof[6] += prows;"),
    ("          s_voff[warp][slot] = voff;\n        }\n        __syncwarp();", MARK % 3),
    ("              for (int c = 0; c < kCT; ++c) gw[c] += g[k][c];\n            }\n          }\n        }",
     (MARK % 4) + " prof[7] += (total + 32 * kPairs - 1) / (32 * kPairs);"),
)


def patched(subs: dict[str, str]) -> str:
    src = SOURCE.read_text()
    for old, new in subs.items():
        if src.count(old) != 1:
            raise SystemExit(f"torch_bwd_diag: the kernel source no longer has exactly one {old!r}")
        src = src.replace(old, new)
    return src


def phase_source() -> str:
    subs = {}
    for old, new in PHASE_MARKS:
        if new is None:  # the staging barrier: mark between it and the atom's terms
            first, rest = old.split("\n\n")
            subs[old] = f"{first}\n{MARK % 0}\n{rest}"
        else:
            subs[old] = f"{old}\n{new}"
    subs["namespace {\n"] = (
        "namespace {\n__device__ long long g_prof[1 << 22];\n"
        "__device__ __forceinline__ long long gtime() {\n  long long v;\n"
        "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(v));\n  return v;\n}\n"
    )
    end = "      a.grad_rows[(static_cast<size_t>(b) * 8 + row) * a.vp + v0 + jj] = g;\n    }\n  }\n"
    subs[end] = end + (MARK % 5) + "\n  if (lane == 0 && blockIdx.x < (1 << 16)) {\n" \
        "    for (int q = 0; q < 8; ++q) g_prof[(blockIdx.x * kWarps + warp) * 8 + q] = prof[q];\n  }\n"
    return patched(subs) + '\nextern "C" int diag_read(long long* h, int n) {\n' \
        '  return static_cast<int>(cudaMemcpyFromSymbol(h, g_prof, n * sizeof(long long)));\n}\n'


def build(sources: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile each named source in parallel -> {name: (library, ptxas report)}."""
    from molvoxel_torch.ops import _build

    procs = []
    for name, src in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "deposit_bwd.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libdeposit_bwd.so"), str(d / "deposit_bwd.cu")]
        procs.append((name, d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, d, proc in procs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{report}")
        libs[name] = (ctypes.CDLL(str(d / "libdeposit_bwd.so")), report)
    return libs


def prepared(dev):
    import torch

    from molvoxel_torch.ops import deposit
    from torch_bwd_ab import shapes

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, coords, w, radii, mask, spec, sigma, ct_dt in shapes(dev):
        rows, wt, _, dl, gaussian = deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask, sigma=sigma)
        ct = torch.randn((wt.shape[0], wt.shape[1], dl, spec.dimension ** 2), generator=gen, device=dev).to(ct_dt)
        yield label, rows, wt, ct, dict(spec=spec, dl=dl, gaussian=gaussian)


def phases(dev):
    import numpy as np
    import torch

    from chip_smoke import emit
    from molvoxel_torch.ops import _build, deposit

    lib, _ = build({"phases": phase_source()})["phases"]
    _build._loaded["deposit_bwd"] = lib
    lib.diag_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for label, rows, wt, ct, kw in prepared(dev):
        info = deposit.bwd_launch_info(*wt.shape, kw["gaussian"], ct.dtype)
        deposit.deposit_bwd(rows, wt, ct, **kw)
        torch.cuda.synchronize()
        n = min(info["blocks"], 1 << 16) * (deposit.BWD_THREADS // 32)
        buf = np.zeros(n * 8, np.int64)
        if lib.diag_read(buf.ctypes.data, n * 8) != 0:
            raise SystemExit("torch_bwd_diag: reading the phase sums failed")
        buf = buf.reshape(n, 8)
        total = buf[:, :6].sum(axis=1)
        worst = int(np.argmax(total))
        names = PHASES + ("row_count", "walk_batches")
        emit({"phase": "phases", "case": label, "warps": n, "launch": info,
              "mean_ns": {k: float(buf[:, i].mean()) for i, k in enumerate(names)},
              "longest_warp_ns": {k: int(buf[worst, i]) for i, k in enumerate(names)},
              "median_warp_total_ns": float(np.median(total)), "longest_warp_total_ns": int(total.max())})
    _build._loaded.pop("deposit_bwd", None)


def variants(dev, names):
    from chip_smoke import emit, grad_err, time_graph_ms
    from molvoxel_torch.ops import _build, deposit

    default_threads = deposit.BWD_THREADS
    sources = {name: patched(VARIANTS[name]) for name in names}
    threads = {name: 32 << int(src.split("constexpr int kLgWarps = ")[1][0]) for name, src in sources.items()}
    libs = build(sources)
    for name, (_, report) in libs.items():
        regs = sorted({int(ln.split("Used ")[1].split(" registers")[0]) for ln in report.splitlines()
                       if "registers" in ln})
        spills = sorted({ln.strip() for ln in report.splitlines()
                         if "spill" in ln and not ln.strip().startswith("0 bytes stack")})
        emit({"phase": "variant_build", "variant": name, "registers": regs, "spills": spills})
    order = names + names[::-1]
    for label, rows, wt, ct, kw in prepared(dev):
        times = {name: [] for name in names}
        grads = {}
        for name in order:
            _build._loaded["deposit_bwd"] = libs[name][0]
            deposit.BWD_THREADS = threads[name]  # the Python side plans warps per atom with it
            grads[name] = deposit.deposit_bwd(rows, wt, ct, **kw)
            times[name].append(time_graph_ms(lambda: deposit.deposit_bwd(rows, wt, ct, **kw)))
        deposit.BWD_THREADS = default_threads
        diffs = {name: grad_err(grads[name], grads[names[0]])[0] for name in names}
        emit({"phase": "variants", "case": label, "ms": {name: statistics.median(t) for name, t in times.items()},
              "max_abs_diff_vs_first": diffs})
    _build._loaded.pop("deposit_bwd", None)


def main() -> int:
    import torch

    mode, names = (sys.argv[1] if len(sys.argv) > 1 else ""), sys.argv[2:]
    if mode not in ("phases", "variants") or any(n not in VARIANTS for n in names) or (mode == "phases" and names):
        print(__doc__, f"variants: {', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_bwd_diag: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import emit, nvidia_smi

    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    dev = torch.device("cuda")
    if mode == "phases":
        phases(dev)
    else:
        variants(dev, names or list(VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
