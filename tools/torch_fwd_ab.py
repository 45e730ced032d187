#!/usr/bin/env python3
"""Time molvoxel_torch's forward kernel against an earlier version of it, on one card.

    git show <rev>:molvoxel_torch/csrc/deposit_fwd.cu > build/parent/deposit_fwd.cu
    python3 tools/torch_fwd_ab.py [--parent build/parent/deposit_fwd.cu]

The earlier version is a ``deposit_fwd.cu`` with the C interface of the
first port of the kernel (256-thread blocks of 128 flat h*w voxels x 2
planes; ``deposit_fwd(atoms, weights, ranges, out, batch, vp, channels, dl,
dim, res, half_width, gaussian, out_kind, stream)``, ranges per 128-voxel
tile).  It is built with nvcc into ``build/parent/``.  Both kernels run on
the same prepared atom rows and weights, each with its own plane ranges, at
the five shapes of the forward main path: the ``forward_batch`` headline
(64 ligands, 64^3 x 4, bf16), the 3262-atom protein at 48^3 and 128^3
(f32), and the 61-atom ligand at 256^3, gaussian and binary (f32).

Each kernel is timed by CUDA-graph replay (``chip_smoke.time_graph_ms``) in
turns: parent, new, new, parent; the line gives both medians.  The two
grids must agree within the bars of ``chip_smoke.bar``.  Then the new
kernel is timed at other brick sizes (``deposit.TARGET_BLOCKS``), to show
what the brick choice buys.  One JSON line per measurement; the card's
``nvidia-smi`` name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARENT_TILE_HW = 128  # the earlier kernel's flat h*w voxels per block


def parent_ranges(rows, spec, dl):
    """The earlier kernel's plane ranges: (B, nhwt, nvc, 2) per 128-voxel
    flat tile, the same closed form as ``deposit.plane_ranges``."""
    import torch

    from molvoxel_torch.ops.deposit import CHUNK

    b, _, vp = rows.shape
    dev = rows.device
    dim = spec.dimension
    hw = dim * dim
    nhwt = -(-hw // PARENT_TILE_HW)
    res, lb, ub = float(spec.resolution), float(spec.lower_bound), float(spec.upper_bound)
    first = torch.arange(nhwt, device=dev) * PARENT_TILE_HW
    last = torch.clamp(first + PARENT_TILE_HW, max=hw) - 1
    row_lo, row_hi = first // dim, last // dim
    h_lo = lb + row_lo.to(torch.float32) * res
    h_hi = h_lo + ((row_hi - row_lo).to(torch.float64) * res).to(torch.float32)
    x, y, z, r2 = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dy = torch.maximum(torch.maximum(h_lo[None, :, None] - y[:, None, :], y[:, None, :] - h_hi[None, :, None]), zero)
    dz = torch.maximum(torch.maximum(lb - z, z - ub), zero)
    s2 = r2[:, None, :] - (dy * dy + (dz * dz)[:, None, :])
    s = torch.sqrt(torch.maximum(s2, zero)) * 1.000002 + 1e-6
    lo = torch.clamp(torch.ceil((x[:, None, :] - s - lb) / res), 0.0, float(dl))
    hi = torch.clamp(torch.floor((x[:, None, :] + s - lb) / res) + 1.0, 0.0, float(dl))
    lo = torch.where(s2 < 0.0, float(dl), lo).to(torch.int32).reshape(b, nhwt, vp // CHUNK, CHUNK).amin(dim=3)
    hi = torch.where(s2 < 0.0, 0.0, hi).to(torch.int32).reshape(b, nhwt, vp // CHUNK, CHUNK).amax(dim=3)
    return torch.stack([lo, torch.maximum(hi, lo)], dim=-1).contiguous()


def build_parent(src: Path) -> ctypes.CDLL:
    from molvoxel_torch.ops import _build

    lib_path = ROOT / "build" / "parent" / "libdeposit_fwd_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.deposit_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.deposit_fwd.restype = ctypes.c_int
    lib.deposit_fwd_tile_hw.restype = ctypes.c_int
    if lib.deposit_fwd_tile_hw() != PARENT_TILE_HW:
        raise SystemExit("the parent kernel's tiles are not 128 flat voxels")
    return lib


def shapes(dev):
    """(label, coords, weights, radii, mask, spec, density, out dtype) of the five main-path shapes."""
    import numpy as np
    import torch

    from chip_smoke import load_golden
    from molvoxel_torch.core.config import GridSpec, small_atom_bucket
    from molvoxel_torch.ops.batch import random_transform_batch

    lig, prot = load_golden("lig_features_gaussian"), load_golden("protein_single_gaussian")
    lig_xyz = torch.as_tensor(lig["coords"] - lig["center"], device=dev)
    prot_xyz = torch.as_tensor(prot["coords"] - prot["center"], device=dev)
    rng = np.random.default_rng(0)
    # the headline batch as forward_batch builds it: 64-atom bucket, masked, seeded transforms
    b_coords = torch.zeros((64, 64, 3), device=dev)
    b_coords[:, :61] = lig_xyz
    b_w = torch.zeros((64, 64, 4), device=dev)
    b_w[:, :61] = torch.as_tensor((rng.uniform(size=(64, 61, 4)) < 0.3).astype(np.float32), device=dev)
    b_mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    b_mask[:, :61] = True
    xyz_t = random_transform_batch(torch.Generator().manual_seed(1234), b_coords, 0.5, True)
    out = [("headline_64lig_dim64_c4_bf16", xyz_t, b_w, torch.ones(64, device=dev), b_mask, GridSpec(0.5, 64),
            "gaussian", torch.bfloat16)]
    vp = small_atom_bucket(prot_xyz.shape[0])
    p_coords = torch.zeros((1, vp, 3), device=dev)
    p_coords[0, : prot_xyz.shape[0]] = prot_xyz
    p_mask = torch.arange(vp, device=dev)[None] < prot_xyz.shape[0]
    for dim in (48, 128):
        out.append((f"protein_dim{dim}_f32", p_coords, p_mask[..., None].float(), torch.ones(vp, device=dev), p_mask,
                    GridSpec(0.5, dim), "gaussian", torch.float32))
    lig_w = torch.as_tensor(lig["channels"][:, :4].astype(np.float32), device=dev)[None]
    for density in ("gaussian", "binary"):
        out.append((f"ligand_dim256_{density}_f32", lig_xyz[None], lig_w, torch.ones(61, device=dev), None,
                    GridSpec(0.25, 256), density, torch.float32))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent" / "deposit_fwd.cu")
    ap.add_argument("--targets", default="528,1056,4224", help="other TARGET_BLOCKS to time the new kernel at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import bar, emit, nvidia_smi, time_graph_ms
    from molvoxel_torch.ops import _build, deposit

    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    _build.build_all(("deposit_fwd",))
    parent = build_parent(args.parent)
    out_kinds = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
    default_target = deposit.TARGET_BLOCKS
    lines = []
    for label, coords, w, radii, mask, spec, density, odt in shapes(dev):
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask,
                                                               density_type=density)
        p_ranges = parent_ranges(rows, spec, dl)
        b, c, vp = wt.shape
        p_out = torch.empty((b, c, dl, spec.dimension ** 2), dtype=odt, device=dev)

        def run_parent():
            rc = parent.deposit_fwd(rows.data_ptr(), wt.data_ptr(), p_ranges.data_ptr(), p_out.data_ptr(), b, vp, c,
                                    dl, spec.dimension, float(spec.resolution), float(spec.width / 2.0),
                                    int(gaussian), out_kinds[odt], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent launch failed with cudaError {rc}")

        def run_new():
            return deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)

        new_out = run_new()
        run_parent()
        torch.cuda.synchronize()
        err = float((new_out.float() - p_out.float()).abs().max())
        tol = bar(odt, p_out.float())
        times = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            times[who].append(time_graph_ms(run_parent if who == "parent" else run_new))
        info = deposit.fwd_launch_info(b, c, vp, dl, spec.dimension, gaussian, odt)
        out_bytes = new_out.numel() * new_out.element_size()
        line = {"phase": "ab", "case": label, "parent_ms": statistics.median(times["parent"]),
                "new_ms": statistics.median(times["new"]), "parent_runs_ms": times["parent"],
                "new_runs_ms": times["new"], "new_vs_parent": statistics.median(times["new"]) /
                statistics.median(times["parent"]), "max_abs_diff": err, "tol": tol, "ok": err <= tol,
                "brick": info, "parent_blocks": -(-spec.dimension ** 2 // PARENT_TILE_HW) * -(-dl // 2) * b *
                -(-c // (1 if c <= 1 else 4 if c <= 4 else 8)), "out_bytes": out_bytes,
                "new_write_tb_s": out_bytes / (statistics.median(times["new"]) * 1e-3) / 1e12}
        emit(line)
        lines.append(line)
        for target in (int(t) for t in args.targets.split(",") if t):
            deposit.TARGET_BLOCKS = target
            deposit._PLANS.clear()  # the plans of the old constant
            try:
                rows_t, wt_t, ranges_t, dl_t, _ = deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask,
                                                                        density_type=density)
                got = deposit.deposit_fwd(rows_t, wt_t, ranges_t, spec=spec, dl=dl_t, gaussian=gaussian, out_dtype=odt)
                ms = time_graph_ms(lambda: deposit.deposit_fwd(rows_t, wt_t, ranges_t, spec=spec, dl=dl_t,
                                                               gaussian=gaussian, out_dtype=odt))
                emit({"phase": "brick_sweep", "case": label, "target_blocks": target, "ms": ms,
                      "max_abs_diff_vs_default": float((got.float() - new_out.float()).abs().max()),
                      "brick": deposit.fwd_launch_info(b, c, vp, dl, spec.dimension, gaussian, odt)})
            finally:
                deposit.TARGET_BLOCKS = default_target
                deposit._PLANS.clear()
    return 0 if all(ln["ok"] for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
