#!/usr/bin/env python3
"""Diagnostics of molvoxel_torch's forward kernel on one card: where a block's time goes, and build variants.

    python3 tools/torch_fwd_diag.py phases     # per-block phase times
    python3 tools/torch_fwd_diag.py variants   # compile-time variants, timed in turns
    python3 tools/torch_fwd_diag.py tile       # the threshold-row kernel's phases, in cycles
    python3 tools/torch_fwd_diag.py tile_variants  # the tile kernel with other constants, in turns
    python3 tools/torch_fwd_diag.py routes [--parent build/parent/deposit_fwd.cu]  # brick against tiles

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

``tile``: the tile kernel (``deposit_fwd_tile_kernel``) on threshold rows
at the shapes of ``chip_smoke.NOTRUNC_CASES`` that take it: thread 0 of every
block (its warp's view) reads clock64 at its phase boundaries and adds the
cycles to per-block sums: the range rows and active-chunk mask, the
culling rounds (loads, box test, barrier, writes), the warp's list from the
block's (with the barrier after it), the factor tables, the pairs, the
store; with the active chunks and the block's kept atoms.  One line per
shape: the means over blocks, the block with the longest total, and the
launch.  ``tile_variants``: the kernel built with other constants (blocks
an SM in its launch bounds, atoms a warp's list holds), timed in turns at
those shapes.

``routes``: the two routes of the exact-cutoff forward on molecules of more
than one chunk, at the benchmark cells' shapes (16 whole 10gs proteins at
128^3, and 8, 4 and 2 of them, and 16 10gs complexes at 48^3 on the
ligand's mean, f32, prepared as
``forward_batch`` prepares them: the 4,096-atom bucket, centers, and a
rotation and a 0.5 A translation a molecule drawn by
``draw_transform_table``) and the single protein at 48^3 and 128^3 (batch 1,
no transform): the brick kernel (``deposit_fwd``, ranges at its rows from
``deposit.plane_ranges``), the tile kernel at the code's launch
(``deposit_fwd_tile``, ranges at ``range_rows`` from the preparation), the
tile kernel at other lane widths and blocks (``ROUTE_BLOCKS``), at the
brick's range rows and built with other constants (``TILE_VARIANTS``), and with
``--parent`` the brick entry of an earlier ``deposit_fwd.cu`` (built into
``build/parent/``) on the brick's ranges.  Every grid must equal the brick's
bit for bit.  For the brick and the code's tile: blocks, and per block the
active chunks (mean, max) and kept atoms (mean, max), from the ``phases``
and ``tile`` builds; then every launch timed by CUDA-graph replay in turns
(each in order, then in reverse; the median of both).
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


TILE_PHASES = ("list", "cull", "warp_lists", "tables", "pairs", "store")
TILE_MARK = "if (threadIdx.x == 0) { const long long t_ = clock64(); prof[%d] += t_ - last_; last_ = t_; }"
# (line of the threshold-row kernel, where its mark goes: "I" the sums' start, "before" or "after" the line)
TILE_MARKS = (
    ("  unsigned my_mask = 0u;", "I", None),
    ("  float acc[kLW][kCT];", "before", (TILE_MARK % 0) + " prof[6] += n_act;"),
    ("    __syncthreads();  // the block's list is written", "before", (TILE_MARK % 1) + " prof[7] += nk;"),
    ("    __syncwarp();  // the list is written", "after", TILE_MARK % 2),
    ("    for (int k = 0; k < n; ++k) {\n      const float4 at = wat[k];", "before", TILE_MARK % 3),
    ("    __syncwarp();  // the tables and the list are read; the next list may overwrite them", "after",
     TILE_MARK % 4),
    ("    __syncthreads();  // every warp has read the block's list; the next round may overwrite it", "after",
     TILE_MARK % 2),
    ("  if (!warp_live || d >= a.dl || h >= a.dim || wl >= a.dim) return;", "before", TILE_MARK % 1),
)


def tile_phase_source() -> str:
    subs = {}
    for old, where, new in TILE_MARKS:
        if where == "I":
            subs[old] = f"  long long prof[8] = {{0, 0, 0, 0, 0, 0, 0, 0}};\n  long long last_ = clock64();\n{old}"
        elif where == "before":
            subs[old] = f"{new}\n{old}"
        else:
            subs[old] = f"{old}\n{new}"
    subs["namespace {\n"] = "namespace {\n__device__ long long g_prof[1 << 20];\n"
    end = ("          if (wl + r0 + i < a.dim) dst[r0 + i] = cast_out<OutT>(v[i]);  // the ragged edge\n"
           "      }\n    }\n  }\n")
    subs[end] = end + (TILE_MARK % 5) + "\n  if (threadIdx.x == 0 && blockIdx.x < (1 << 17)) {\n" \
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
    deposit._PLANS.clear()  # the plans of the old constant
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


TILE_BOUNDS = "__launch_bounds__(kMaxThreads, 3) deposit_fwd_tile_kernel"
TILE_VARIANTS = {
    "code": {},
    "min_blocks_2": {TILE_BOUNDS: TILE_BOUNDS.replace("3)", "2)")},
    "min_blocks_4": {TILE_BOUNDS: TILE_BOUNDS.replace("3)", "4)")},
}


def tile_cases(dev):
    """(name, spec, out dtype, prepare) of the NOTRUNC_CASES that take the tiles."""
    import torch

    from chip_smoke import NOTRUNC_CASES, notrunc_inputs, notrunc_molecules
    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import deposit

    mols = notrunc_molecules()
    for name, mol, b, dim, res, slab, out_dtype in NOTRUNC_CASES:
        coords, w, mask = notrunc_inputs(mols[mol], b, dev)
        if not deposit.fwd_tiles(w.shape[1]):
            continue
        spec = GridSpec(res, dim)
        d0, d_count = (0, None) if slab is None else slab

        def prep(coords=coords, w=w, mask=mask, spec=spec, d0=d0, d_count=d_count):
            return deposit.prepare_batch(coords, w, torch.ones(w.shape[1], device=dev), spec=spec,
                                         density_type="gaussian_notrunc", sigma=0.5, mask=mask, d_offset=d0,
                                         d_count=d_count)
        yield name, spec, getattr(torch, out_dtype), prep


def tile_variants(dev):
    from chip_smoke import emit, time_graph_ms
    from molvoxel_torch.ops import deposit

    libs = build({name: patched(subs) for name, subs in TILE_VARIANTS.items()})
    for name, (_, report) in libs.items():
        lines = report.splitlines()
        tile_regs = sorted({int(ln.split("Used ")[1].split(" registers")[0]) for i, ln in enumerate(lines)
                            if "registers" in ln and any("tile_kernel" in x for x in lines[max(0, i - 3):i])})
        emit({"phase": "tile_variant_build", "variant": name, "tile_registers": tile_regs})
    order = list(TILE_VARIANTS) + list(TILE_VARIANTS)[::-1]
    for label, spec, odt, prep in tile_cases(dev):
        times = {name: [] for name in TILE_VARIANTS}
        for name in order:
            use(libs[name][0], deposit.ACC_MAX)
            rows, wt, ranges, dl, _ = prep()
            times[name].append(time_graph_ms(lambda: deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl,
                                                                         gaussian=True, out_dtype=odt,
                                                                         notrunc=True)))
        emit({"phase": "tile_variants", "case": label, **{name: statistics.median(t) for name, t in times.items()}})


def tile(dev):
    import numpy as np
    import torch

    from chip_smoke import emit
    from molvoxel_torch.ops import deposit

    lib, _ = build({"tile": tile_phase_source()})["tile"]
    use(lib, deposit.ACC_MAX)
    lib.diag_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name, spec, odt, prep in tile_cases(dev):
        rows, wt, ranges, dl, _ = prep()
        dim = spec.dimension
        info = deposit.fwd_launch_info(wt.shape[0], wt.shape[1], wt.shape[2], dl, dim, True, odt, notrunc=True)
        deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=True, out_dtype=odt, notrunc=True)
        torch.cuda.synchronize()
        n = min(info["blocks"], 1 << 17)
        buf = np.zeros(n * 8, np.int64)
        if lib.diag_read(buf.ctypes.data, n * 8) != 0:
            raise SystemExit("torch_fwd_diag: reading the phase sums failed")
        buf = buf.reshape(n, 8)
        total = buf[:, :6].sum(axis=1)
        worst = int(np.argmax(total))
        names = TILE_PHASES + ("active_chunks", "kept_atoms")
        emit({"phase": "tile_phases", "case": name, "blocks": n, "tile": info,
              "mean_cycles": {k: float(buf[:, i].mean()) for i, k in enumerate(names)},
              "longest_block_cycles": {k: int(buf[worst, i]) for i, k in enumerate(names)},
              "median_block_total_cycles": float(np.median(total)), "longest_block_total_cycles": int(total.max())})


# the batches of the protein cell's 128^3 shape the routes run (16: the cell; 2-8: the narrow and wide
# lanes between one protein and the cell, for TILE_WIDE_WAVES)
ROUTE_PROTEIN_BATCHES = (16, 8, 4, 2)
# the tile launches the routes time beside the code's: (w a lane owns, f32), warps along d, h and w
ROUTE_BLOCKS = ((8, 2, 2, 2), (8, 2, 2, 1), (8, 1, 2, 2), (16, 2, 2, 2), (16, 2, 2, 1), (16, 1, 2, 2),
                (16, 2, 1, 2), (16, 1, 2, 4))


def route_cases(dev):
    """(label, prepare, spec) of the routes' shapes; ``prepare()`` gives
    ``prepare_batch``'s tuple."""
    import numpy as np
    import torch

    from chip_smoke import load_golden
    from molvoxel_torch.core.config import GridSpec, small_atom_bucket
    from molvoxel_torch.core.transform import draw_transform_table
    from molvoxel_torch.ops import deposit

    prot = load_golden("protein_single_gaussian")["coords"].astype(np.float32)
    lig = load_golden("lig_types_gaussian")
    prot_center = prot.astype(np.float64).mean(0).astype(np.float32)
    cells = tuple((f"protein128_b{b}_f32", prot, prot_center, 128, b) for b in ROUTE_PROTEIN_BATCHES) + (
        ("complex48_b16_f32", np.concatenate([lig["coords"].astype(np.float32), prot]),
         lig["center"].astype(np.float32), 48, 16),)
    for label, xyz, center, dim, b in cells:
        v = len(xyz)
        vp = small_atom_bucket(v)
        coords = torch.zeros((b, vp, 3), device=dev)
        coords[:, :v] = torch.as_tensor(xyz, device=dev)
        mask = (torch.arange(vp, device=dev) < v)[None].expand(b, vp).contiguous()
        table = torch.as_tensor(draw_transform_table(torch.Generator().manual_seed(dim), b, 0.5, True), device=dev)
        centers = torch.as_tensor(center, device=dev)[None].expand(b, 3).contiguous()

        def prep(coords=coords, mask=mask, table=table, centers=centers, dim=dim):
            return deposit.prepare_batch(coords, mask[..., None].float(), torch.ones(coords.shape[1], device=dev),
                                         spec=GridSpec(0.5, dim), mask=mask, centers=centers,
                                         transforms=deposit.Transforms(table, True, True))
        yield label, prep, GridSpec(0.5, dim)
    vp = small_atom_bucket(len(prot))
    p_coords = torch.zeros((1, vp, 3), device=dev)
    p_coords[0, :len(prot)] = torch.as_tensor(prot - load_golden("protein_single_gaussian")["center"], device=dev)
    p_mask = torch.arange(vp, device=dev)[None] < len(prot)
    for dim in (48, 128):
        def prep(dim=dim):
            return deposit.prepare_batch(p_coords, p_mask[..., None].float(), torch.ones(vp, device=dev),
                                         spec=GridSpec(0.5, dim), mask=p_mask)
        yield f"protein{dim}_b1_f32", prep, GridSpec(0.5, dim)


def block_counts(lib, launch, out, ptrs, blocks: int, phases) -> dict:
    """Blocks, and per block the active chunks and kept atoms (mean, max)
    and the mean of each of ``phases`` (thread 0's clock), of one launch on
    an instrumented build (``phases`` or ``tile``)."""
    import numpy as np
    import torch

    from molvoxel_torch.ops import _build, deposit

    saved = _build._loaded["deposit_fwd"]
    _build._loaded["deposit_fwd"] = lib
    try:
        deposit._launch_fwd(out.get_device(), launch, out, *ptrs)
        torch.cuda.synchronize()
    finally:
        _build._loaded["deposit_fwd"] = saved
    n = min(blocks, 1 << 17)
    buf = np.zeros(n * 8, np.int64)
    if lib.diag_read(buf.ctypes.data, n * 8) != 0:
        raise SystemExit("torch_fwd_diag: reading the block sums failed")
    buf = buf.reshape(n, 8)
    return {"blocks": blocks, "active_chunks_mean": float(buf[:, 6].mean()), "active_chunks_max": int(buf[:, 6].max()),
            "kept_atoms_mean": float(buf[:, 7].mean()), "kept_atoms_max": int(buf[:, 7].max()),
            "blocks_with_no_chunk_pct": 100.0 * float((buf[:, 6] == 0).mean()),
            "phase_means": {k: float(buf[:, i].mean()) for i, k in enumerate(phases)}}


def routes(dev, parent_src):
    import torch

    from chip_smoke import emit, same_bits, time_graph_ms
    from molvoxel_torch.ops import _build, deposit

    _build.build_all(("deposit_fwd",))
    libs = build({"phases": phase_source(), "tile": tile_phase_source(),
                  **{f"tile_{k}": patched(subs) for k, subs in TILE_VARIANTS.items() if subs}})
    for name in ("phases", "tile"):
        libs[name][0].diag_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    parent = None
    if parent_src is not None:
        from torch_notrunc_ab import build_parent  # an earlier deposit_fwd.cu with the brick's C interface

        parent = build_parent("deposit_fwd", Path(parent_src))
    for label, prep, spec in route_cases(dev):
        rows, wt, ranges, dl, gaussian = prep()
        b, c, vp = wt.shape
        dim = spec.dimension
        brick_plan = deposit.brick(b, c, dl, dim)
        brick_ranges = deposit.plane_ranges(rows[:, :3].transpose(1, 2), rows[:, 3], spec, dl, brick_plan.ht)
        ptrs = (rows.data_ptr(), wt.data_ptr())
        tile = deposit.tile_launch(b, vp, c, dl, spec, gaussian)
        launches = {"brick": (deposit.brick_launch(b, vp, c, dl, spec, gaussian), brick_ranges),
                    "tile": (tile, ranges)}
        for lw, bd, bh, bw in ROUTE_BLOCKS:
            alt = (tile[0], tile[1][:-5] + (lw, bd, bh, bw, tile[1][-1]))
            if alt != tile:
                launches[f"tile_w{lw}_{bd}{bh}{bw}"] = (alt, ranges)
        launches["tile_brick_rows"] = ((tile[0], tile[1][:-1] + (brick_plan.ht,)), brick_ranges)
        outs = {k: torch.empty((b, c, dl, dim * dim), device=dev) for k in launches}
        fns = {k: (lambda k=k: deposit._launch_fwd(dev.index or 0, launches[k][0], outs[k], *ptrs,
                                                    launches[k][1].data_ptr())) for k in launches}
        for name in (k for k in libs if k.startswith("tile_")):  # the code's tile launch on a build variant
            outs[name] = torch.empty_like(outs["tile"])

            def run_variant(name=name):
                saved = _build._loaded["deposit_fwd"]
                _build._loaded["deposit_fwd"] = libs[name][0]
                try:
                    deposit._launch_fwd(dev.index or 0, tile, outs[name], *ptrs, ranges.data_ptr())
                finally:
                    _build._loaded["deposit_fwd"] = saved
            fns[name] = run_variant
        if parent is not None:
            outs["parent"] = torch.empty_like(outs["brick"])
            pa = launches["brick"][0][1]

            def run_parent():
                rc = parent.deposit_fwd(*ptrs, brick_ranges.data_ptr(), outs["parent"].data_ptr(), *pa,
                                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"parent launch failed with cudaError {rc}")
            fns["parent"] = run_parent
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        bits = {k: same_bits(outs[k], outs["brick"]) for k in outs}
        counts = {"brick": block_counts(libs["phases"][0], launches["brick"][0], outs["brick"],
                                        ptrs + (brick_ranges.data_ptr(),),
                                        b * -(-c // brick_plan.kct) * -(-dl // brick_plan.dt) * -(-dim // brick_plan.ht),
                                        [f"{k}_ns" for k in PHASES]),
                  "tile": block_counts(libs["tile"][0], tile, outs["tile"], ptrs + (ranges.data_ptr(),),
                                       deposit.fwd_launch_info(b, c, vp, dl, dim, gaussian)["blocks"],
                                       [f"{k}_cycles" for k in TILE_PHASES])}
        times = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            times[k].append(time_graph_ms(fns[k]))
        ms = {k: statistics.median(t) for k, t in times.items()}
        out_bytes = outs["brick"].numel() * outs["brick"].element_size()
        emit({"phase": "routes", "case": label, "ms": ms, "runs_ms": times, "bit_equal_brick": bits,
              "per_block": counts, "tile_plan": deposit.fwd_launch_info(b, c, vp, dl, dim, gaussian),
              "brick_plan": brick_plan._asdict(), "write_bound_ms": out_bytes / 3.35e12 * 1e3,
              "ok": all(bits.values())})
        del outs
        torch.cuda.empty_cache()


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
    deposit._PLANS.clear()


def main() -> int:
    import torch

    modes = ("phases", "variants", "tile", "tile_variants", "routes")
    parent = None
    if len(sys.argv) == 4 and sys.argv[1] == "routes" and sys.argv[2] == "--parent":
        parent = sys.argv[3]
    elif len(sys.argv) != 2 or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_fwd_diag: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import emit, nvidia_smi

    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    dev = torch.device("cuda", torch.cuda.current_device())
    if sys.argv[1] == "routes":
        routes(dev, parent)
    else:
        {"phases": phases, "variants": variants, "tile": tile, "tile_variants": tile_variants}[sys.argv[1]](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
