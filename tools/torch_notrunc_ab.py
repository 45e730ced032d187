#!/usr/bin/env python3
"""Time molvoxel_torch's threshold-row (gaussian_notrunc) kernels against an earlier version, on one card.

    mkdir -p build/parent
    git show <rev>:molvoxel_torch/csrc/deposit_fwd.cu > build/parent/deposit_fwd.cu
    git show <rev>:molvoxel_torch/csrc/deposit_bwd.cu > build/parent/deposit_bwd.cu
    python3 tools/torch_notrunc_ab.py [--sweep] [--out FILE]

The earlier version is a pair of sources with the brick kernel's C
interface (``deposit_fwd(atoms, weights, ranges, out, batch, vp, channels,
dl, dim, res, half_width, gaussian, out_kind, kct, threads, dt, ht, passes,
stream)`` and ``deposit_bwd(atoms, weights, ct, grad_rows, grad_w, batch,
vp, channels, dl, dim, res, half_width, gaussian, ct_kind, warps_per_atom,
stream)``), which ran threshold rows on the exact-cutoff launch.  Both are
built with nvcc into ``build/parent/``.

At the 12 forward shapes of ``chip_smoke.NOTRUNC_CASES`` both forwards run
on the same threshold rows and plane ranges; the grids must be equal bit
for bit (the threshold-row kernel sums the same terms in the same order).
Where the port keeps the brick launch (molecules of one chunk), the
threshold-row kernel is also timed there, forced, and must give the same
bits.  At the 2 ``NOTRUNC_TRAIN_CASES`` both backwards run on the same
rows and a seeded cotangent, gradients within 1e-4 x max(1, scale).  Each
is timed by CUDA-graph replay (``chip_smoke.time_graph_ms``) in turns:
parent, new, new, parent.  Route times, in the same turns: the forward
route is the preparation plus the forward launch; the training route adds
the backward launch.  Then the
exact-cutoff launches at the forward main path's five shapes and the
backward's training batch, which this code did not change: the same
launch arguments, so the same bits and times within noise.

``--sweep`` times the new kernels at other plans instead (the forward's
tile blocks and lane widths, ``sweep_fwd``; the backward's
``BWD_TARGET_WARPS``, which sets its warps an atom), each against the
plan in the code, in turns.  One JSON line per measurement; the card's
``nvidia-smi`` name and power limit first; ``--out`` also writes them to a
file.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_OUT = []


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    _OUT.append(line)


def build_parent(name: str, src: Path) -> ctypes.CDLL:
    from molvoxel_torch.ops import _build

    lib_path = ROOT / "build" / "parent" / f"lib{name}_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    if name == "deposit_fwd":
        lib.deposit_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.deposit_fwd.restype = ctypes.c_int
    else:
        lib.deposit_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.deposit_bwd.restype = ctypes.c_int
    return lib


def parent_fwd(lib, rows, wt, ranges, spec, dl, odt):
    """The parent's forward launch on threshold rows: ``brick``'s plan,
    ``ranges`` at its rows (ranges at the tiles' rows are computed anew at
    the brick's, by ``deposit.plane_ranges``)."""
    import torch

    from molvoxel_torch.ops import deposit

    b, c, vp = wt.shape
    dim = spec.dimension
    plan = deposit.brick(b, c, dl, dim, odt)
    if ranges.shape[1] != -(-dim // plan.ht):
        ranges = deposit.plane_ranges(rows[:, :3].transpose(1, 2), rows[:, 3], spec, dl, plan.ht)
    out = torch.empty((b, c, dl, dim * dim), dtype=odt, device=rows.device)
    rc = lib.deposit_fwd(rows.data_ptr(), wt.data_ptr(), ranges.data_ptr(), out.data_ptr(), b, vp, c, dl, dim,
                         float(spec.resolution), float(spec.width / 2.0), 1, deposit._OUT_KINDS[odt], plan.kct,
                         plan.threads, plan.dt, plan.ht, plan.passes, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent forward launch failed with cudaError {rc}")
    return out


def parent_bwd(lib, rows, wt, ct, spec, dl):
    import torch

    from molvoxel_torch.ops import deposit

    b, c, vp = wt.shape
    g_rows, g_w = torch.empty_like(rows), torch.empty_like(wt)
    rc = lib.deposit_bwd(rows.data_ptr(), wt.data_ptr(), ct.data_ptr(), g_rows.data_ptr(), g_w.data_ptr(), b, vp, c,
                         dl, spec.dimension, float(spec.resolution), float(spec.width / 2.0), 1,
                         deposit._CT_KINDS[ct.dtype], deposit.bwd_warps_per_atom(b, vp),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent backward launch failed with cudaError {rc}")
    return g_rows, g_w


def turns(fns: dict) -> dict:
    """{name: median ms} of each fn timed by graph replay in the order
    parent, new, new, parent (per name), with every run kept."""
    from chip_smoke import time_graph_ms

    runs = {k: [] for k in fns}
    for who in ("parent", "new", "new", "parent"):
        for k, fn in fns.items():
            if k.startswith(who):
                runs[k].append(time_graph_ms(fn))
    return {k: statistics.median(v) for k, v in runs.items()}, runs


def forward_cases(dev, fwd_lib, bwd_lib, sweep):
    import torch

    from chip_smoke import NOTRUNC_CASES, bar, bound, notrunc_inputs, notrunc_molecules, same_bits, time_graph_ms
    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import deposit

    mols = notrunc_molecules()
    ok = True
    for name, mol, b, dim, res, slab, out_dtype in NOTRUNC_CASES:
        spec = GridSpec(res, dim)
        odt = getattr(torch, out_dtype)
        coords, w, mask = notrunc_inputs(mols[mol], b, dev)
        vp, c = w.shape[1], w.shape[2]
        d0, d_count = (0, None) if slab is None else slab
        radii = torch.ones(vp, device=dev)
        kw = dict(spec=spec, density_type="gaussian_notrunc", sigma=0.5, mask=mask, d_offset=d0, d_count=d_count)
        rows, wt, ranges, dl, _ = deposit.prepare_batch(coords, w, radii, **kw)

        def new_fwd():
            return deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=True, out_dtype=odt, notrunc=True)

        def par_fwd():
            return parent_fwd(fwd_lib, rows, wt, ranges, spec, dl, odt)

        if sweep:
            if deposit.fwd_tiles(vp):
                line = sweep_fwd(name, rows, wt, ranges, spec, dl, odt, dev)
                emit(line)
                ok = ok and line["ok"]
            continue

        new = new_fwd()
        par = par_fwd()
        again = new_fwd()
        torch.cuda.synchronize()
        identical = same_bits(new, par)
        err = float((new.float() - par.float()).abs().max())
        tol = bar(odt, par.float())

        def new_route():
            r, ww, rg, d, _ = deposit.prepare_batch(coords, w, radii, **kw)
            return deposit.deposit_fwd(r, ww, rg, spec=spec, dl=d, gaussian=True, out_dtype=odt, notrunc=True)

        def par_route():
            r, ww, rg, d, _ = deposit.prepare_batch(coords, w, radii, **kw)
            return parent_fwd(fwd_lib, r, ww, rg, spec, d, odt)

        pr = par_route()
        torch.cuda.synchronize()
        route_same = same_bits(new_route(), pr)
        ms, runs = turns({"parent_kernel": par_fwd, "new_kernel": new_fwd, "parent_route": par_route,
                          "new_route": new_route})
        b_ms, b_by = bound(rows, wt, ranges, new, spec, dl, True)
        line = {"phase": "ab_fwd", "case": name, "parent_ms": ms["parent_kernel"], "new_ms": ms["new_kernel"],
                "new_vs_parent": ms["new_kernel"] / ms["parent_kernel"],
                "parent_route_ms": ms["parent_route"], "new_route_ms": ms["new_route"],
                "route_new_vs_parent": ms["new_route"] / ms["parent_route"], "runs_ms": runs,
                "bound_ms": b_ms, "bound_by": b_by, "bit_equal_parent": identical, "route_bit_equal": route_same,
                "two_launches_equal": same_bits(new, again), "max_abs_diff": err, "tol": tol,
                "plan": deposit.fwd_launch_info(b, c, vp, dl, dim, True, odt, notrunc=True),
                "parent_plan": deposit.brick(b, c, dl, dim, odt)._asdict()}
        line["ok"] = bool(err <= tol and line["two_launches_equal"])
        if not deposit.fwd_tiles(vp):
            # a molecule of one chunk keeps the brick launch: the tile kernel
            # timed on it all the same (on ranges at the tiles' rows), for
            # the routing rule
            saved = deposit.fwd_tiles
            deposit.fwd_tiles = lambda vp_: True
            deposit._PLANS.clear()
            try:
                t_rows, t_wt, t_ranges, t_dl, _ = deposit.prepare_batch(coords, w, radii, **kw)

                def tile_fwd():
                    return deposit.deposit_fwd(t_rows, t_wt, t_ranges, spec=spec, dl=t_dl, gaussian=True,
                                               out_dtype=odt, notrunc=True)

                alt = tile_fwd()
                line["threshold_row_kernel_ms"] = time_graph_ms(tile_fwd)
                line["threshold_row_kernel_bit_equal_parent"] = same_bits(alt, par)
                line["threshold_row_plan"] = deposit.fwd_launch_info(b, c, vp, dl, dim, True, odt, notrunc=True)
                line["ok"] = line["ok"] and line["threshold_row_kernel_bit_equal_parent"]
                del alt
            finally:
                deposit.fwd_tiles = saved
                deposit._PLANS.clear()
        emit(line)
        ok = ok and line["ok"]
        del new, par, again, pr
        torch.cuda.empty_cache()
    return ok


# the tile blocks the sweep times (warps along d, h and w), each at narrow and wide lanes
SWEEP_BLOCKS = ((2, 2, 2), (2, 2, 1), (1, 2, 2), (1, 1, 2), (1, 1, 1))


def sweep_fwd(name, rows, wt, ranges, spec, dl, odt, dev) -> dict:
    """The tile launch of threshold rows at the code's plan and at every
    ``SWEEP_BLOCKS`` block with narrow and wide lanes (where the channel
    group fits their accumulators), on the same rows and ranges, timed by
    CUDA-graph replay in turns (each in order, then in reverse); every grid
    bit for bit with the code's.  ``exact_rule``: the launch the same
    shapes take at the exact cutoff (``tile_brick`` without ``notrunc``)."""
    import torch

    from chip_smoke import same_bits, time_graph_ms
    from molvoxel_torch.ops import deposit

    b, c, vp = wt.shape
    dim = spec.dimension
    code = deposit.tile_launch(b, vp, c, dl, spec, True, odt, notrunc=True)
    entry, args = code
    narrow = 16 if odt.itemsize == 1 else 8
    kct = args[-6]

    def key(lw, bd, bh, bw):
        return f"w{lw}_{bd}{bh}{bw}"

    launches = {"code": code}
    for lw in (narrow, 2 * narrow):
        if lw * kct > deposit.ACC_MAX:
            continue
        for bd, bh, bw in SWEEP_BLOCKS:
            alt = (entry, args[:-5] + (lw, bd, bh, bw, args[-1]))
            if alt != code:
                launches[key(lw, bd, bh, bw)] = alt
    outs = {k: torch.empty((b, c, dl, dim * dim), dtype=odt, device=dev) for k in launches}
    fns = {k: (lambda k=k: deposit._launch_fwd(dev.index or 0, launches[k], outs[k], rows.data_ptr(),
                                               wt.data_ptr(), ranges.data_ptr())) for k in launches}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    bits = {k: same_bits(outs[k], outs["code"]) for k in outs}
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(time_graph_ms(fns[k]))
    exact = deposit.tile_brick(b, c, dl, dim, odt)
    exact_key = key(exact.cols // 2, exact.bd, exact.bh, exact.bw)
    return {"phase": "sweep_fwd", "case": name, "code": key(*args[-5:-1]),
            "exact_rule": "code" if exact_key == key(*args[-5:-1]) else exact_key,
            "ms": {k: statistics.median(t) for k, t in times.items()}, "runs_ms": times,
            "bit_equal_code": bits, "ok": all(bits.values())}


def train_cases(dev, fwd_lib, bwd_lib, sweep):
    import torch

    from chip_smoke import NOTRUNC_TRAIN_CASES, bound_bwd, grad_err, notrunc_inputs, notrunc_molecules, time_graph_ms
    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import deposit

    mols = notrunc_molecules()
    ok = True
    for name, mol, b, dim, _entry in NOTRUNC_TRAIN_CASES:
        spec = GridSpec(0.5, dim)
        coords, w, mask = notrunc_inputs(mols[mol], b, dev)
        vp, c = w.shape[1], w.shape[2]
        radii = torch.ones(vp, device=dev)
        kw = dict(spec=spec, density_type="gaussian_notrunc", sigma=0.5, mask=mask)
        rows, wt, ranges, dl, _ = deposit.prepare_batch(coords, w, radii, **kw)
        for ct_dt in (torch.float32, torch.bfloat16):
            ct = torch.randn((b, c, dl, dim * dim), generator=torch.Generator(device=dev).manual_seed(b),
                             device=dev).to(ct_dt)
            label = f"{name}_ct_{'bf16' if ct_dt == torch.bfloat16 else 'f32'}"

            def new_bwd():
                return deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=True, notrunc=True)

            def par_bwd():
                return parent_bwd(bwd_lib, rows, wt, ct, spec, dl)

            if sweep:
                # the threshold-row launch at more warps an atom, in turns
                def with_target(target):
                    saved = deposit.BWD_TARGET_WARPS
                    deposit.BWD_TARGET_WARPS = target
                    try:
                        return time_graph_ms(new_bwd)
                    finally:
                        deposit.BWD_TARGET_WARPS = saved

                targets = [deposit.BWD_TARGET_WARPS, 2 * deposit.BWD_TARGET_WARPS, 4 * deposit.BWD_TARGET_WARPS]
                times = {}
                for target in targets + targets[::-1]:
                    times.setdefault(str(target), []).append(with_target(target))
                emit({"phase": "sweep_bwd", "case": label,
                      "ms": {k: statistics.median(v) for k, v in times.items()}})
                continue

            new = new_bwd()
            par = par_bwd()
            again = new_bwd()
            torch.cuda.synchronize()
            err, scale = grad_err(new, par)
            same = all(torch.equal(x, y) for x, y in zip(new, again))

            def new_route():
                r, ww, rg, d, _ = deposit.prepare_batch(coords, w, radii, **kw)
                deposit.deposit_fwd(r, ww, rg, spec=spec, dl=d, gaussian=True, notrunc=True)
                return deposit.deposit_bwd(r, ww, ct, spec=spec, dl=d, gaussian=True, notrunc=True)

            def par_route():
                r, ww, rg, d, _ = deposit.prepare_batch(coords, w, radii, **kw)
                parent_fwd(fwd_lib, r, ww, rg, spec, d, torch.float32)
                return parent_bwd(bwd_lib, r, ww, ct, spec, d)

            ms, runs = turns({"parent_kernel": par_bwd, "new_kernel": new_bwd, "parent_route": par_route,
                              "new_route": new_route})
            live = wt.abs().amax(dim=1) > 0
            b_ms, b_by = bound_bwd(rows, wt, ct, live, spec, dl, True)
            line = {"phase": "ab_bwd", "case": label, "parent_ms": ms["parent_kernel"], "new_ms": ms["new_kernel"],
                    "new_vs_parent": ms["new_kernel"] / ms["parent_kernel"],
                    "parent_route_ms": ms["parent_route"], "new_route_ms": ms["new_route"],
                    "route_new_vs_parent": ms["new_route"] / ms["parent_route"], "runs_ms": runs,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_diff": err, "tol": 1e-4 * scale,
                    "two_launches_equal": same,
                    "plan": deposit.bwd_launch_info(b, c, vp, True, ct_dt, notrunc=True),
                    "parent_plan": deposit.bwd_launch_info(b, c, vp, True, ct_dt)}
            line["ok"] = bool(err <= 1e-4 * scale and same)
            emit(line)
            ok = ok and line["ok"]
    return ok


def exact_cases(dev, fwd_lib, bwd_lib):
    """The exact-cutoff launches, which this code did not change: the
    forward main path's five shapes and the backward's training batch,
    parent and new on the same inputs, bit for bit, timed in turns."""
    import numpy as np
    import torch

    from chip_smoke import load_golden, same_bits
    from molvoxel_torch.core.config import GridSpec, small_atom_bucket
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.ops.batch import random_transform_batch

    lig, prot = load_golden("lig_features_gaussian"), load_golden("protein_single_gaussian")
    lig_xyz = torch.as_tensor(lig["coords"] - lig["center"], device=dev)
    prot_xyz = torch.as_tensor(prot["coords"] - prot["center"], device=dev)
    rng = np.random.default_rng(0)
    b_coords = torch.zeros((64, 64, 3), device=dev)
    b_coords[:, :61] = lig_xyz
    b_mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    b_mask[:, :61] = True
    xyz_t = random_transform_batch(torch.Generator().manual_seed(1234), b_coords, 0.5, True)
    b_w = torch.zeros((64, 64, 4), device=dev)
    b_w[:, :61] = torch.as_tensor((rng.uniform(size=(64, 61, 4)) < 0.3).astype(np.float32), device=dev)
    vp = small_atom_bucket(prot_xyz.shape[0])
    p_coords = torch.zeros((1, vp, 3), device=dev)
    p_coords[0, : prot_xyz.shape[0]] = prot_xyz
    p_mask = torch.arange(vp, device=dev)[None] < prot_xyz.shape[0]
    lig_w = torch.as_tensor(lig["channels"][:, :4].astype(np.float32), device=dev)[None]
    cases = [("headline_64lig_dim64_c4_bf16", xyz_t, b_w, torch.ones(64, device=dev), b_mask, GridSpec(0.5, 64),
              "gaussian", torch.bfloat16),
             ("protein_dim48_c1_f32", p_coords, p_mask[..., None].float(), torch.ones(vp, device=dev), p_mask,
              GridSpec(0.5, 48), "gaussian", torch.float32),
             ("protein_dim128_c1_f32", p_coords, p_mask[..., None].float(), torch.ones(vp, device=dev), p_mask,
              GridSpec(0.5, 128), "gaussian", torch.float32),
             ("ligand_dim256_c4_f32", lig_xyz[None], lig_w, torch.ones(61, device=dev), None, GridSpec(0.25, 256),
              "gaussian", torch.float32),
             ("ligand_dim256_c4_binary_f32", lig_xyz[None], lig_w, torch.ones(61, device=dev), None,
              GridSpec(0.25, 256), "binary", torch.float32)]
    ok = True
    for label, coords, w, radii, mask, spec, density, odt in cases:
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask,
                                                               density_type=density)

        def new_fwd():
            return deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)

        def par_fwd():
            b, c, vp_ = wt.shape
            plan = deposit.brick(b, c, dl, spec.dimension, odt)
            out = torch.empty((b, c, dl, spec.dimension ** 2), dtype=odt, device=dev)
            rc = fwd_lib.deposit_fwd(rows.data_ptr(), wt.data_ptr(), ranges.data_ptr(), out.data_ptr(), b, vp_, c,
                                     dl, spec.dimension, float(spec.resolution), float(spec.width / 2.0),
                                     int(gaussian), deposit._OUT_KINDS[odt], plan.kct, plan.threads, plan.dt,
                                     plan.ht, plan.passes, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent forward launch failed with cudaError {rc}")
            return out

        same = same_bits(new_fwd(), par_fwd())
        ms, runs = turns({"parent": par_fwd, "new": new_fwd})
        line = {"phase": "ab_exact_fwd", "case": label, "parent_ms": ms["parent"], "new_ms": ms["new"],
                "new_vs_parent": ms["new"] / ms["parent"], "runs_ms": runs, "bit_equal_parent": same, "ok": same}
        emit(line)
        ok = ok and same
        if label.startswith("headline"):
            ct = torch.randn((64, 4, 64, 64 * 64), generator=torch.Generator(device=dev).manual_seed(0), device=dev)

            def new_bwd():
                return deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=True)

            def par_bwd():
                return parent_bwd(bwd_lib, rows, wt, ct, spec, dl)

            same = all(torch.equal(x, y) for x, y in zip(new_bwd(), par_bwd()))
            ms, runs = turns({"parent": par_bwd, "new": new_bwd})
            emit({"phase": "ab_exact_bwd", "case": "train_64lig_dim64_c4_f32", "parent_ms": ms["parent"],
                  "new_ms": ms["new"], "new_vs_parent": ms["new"] / ms["parent"], "runs_ms": runs,
                  "bit_equal_parent": same, "ok": same})
            ok = ok and same
    return ok


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-dir", type=Path, default=ROOT / "build" / "parent")
    ap.add_argument("--sweep", action="store_true", help="time other plans of the new kernels instead")
    ap.add_argument("--out", type=Path, default=None, help="also write every line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_notrunc_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi
    from molvoxel_torch.ops import _build

    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    _build.build_all(("deposit_prep", "deposit_fwd", "deposit_bwd"))
    fwd_lib = build_parent("deposit_fwd", args.parent_dir / "deposit_fwd.cu")
    bwd_lib = build_parent("deposit_bwd", args.parent_dir / "deposit_bwd.cu")
    try:
        ok = forward_cases(dev, fwd_lib, bwd_lib, args.sweep)
        ok = train_cases(dev, fwd_lib, bwd_lib, args.sweep) and ok
        if not args.sweep:
            ok = exact_cases(dev, fwd_lib, bwd_lib) and ok
    finally:
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("\n".join(_OUT) + "\n")
    emit({"phase": "done", "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
