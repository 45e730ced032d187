#!/usr/bin/env python3
"""Time molvoxel_torch's backward kernel against an earlier version of it, on one card.

    git show <rev>:molvoxel_torch/csrc/deposit_bwd.cu > build/parent/deposit_bwd.cu
    python3 tools/torch_bwd_ab.py [--parent build/parent/deposit_bwd.cu]

The earlier version is a ``deposit_bwd.cu`` with the C interface of the
first port of the kernel (one warp per atom over its cutoff box, channel
groups on a second grid axis; ``deposit_bwd(atoms, weights, ct, grad_rows,
grad_w, batch, vp, channels, dl, dim, res, half_width, gaussian, ct_kind,
stream)``).  It is built with nvcc into ``build/parent/``.  Both kernels run
on the same prepared atom rows, weights and cotangent, at seven shapes:

- the training step's deposit (64 ligands of 61 atoms, each with its own
  random rotation and 0.5 A translation, 64^3 x 4, radius 1.0, sigma 0.5),
  with a float32 and with a bfloat16 cotangent, and at C = 16;
- the 3262-atom protein at 48^3 and at 128^3 (C = 1, the 4,096-atom bucket
  with 834 masked atoms);
- the 61-atom ligand at 256^3, res 0.25, C = 4 (its features), radius 1.0;
- the pose-refinement ligand at 32^3 (C = 1, sigma 1.0).

Each kernel is timed by CUDA-graph replay (``chip_smoke.time_graph_ms``) in
turns: parent, new, new, parent; the line gives both medians, the bound
(``chip_smoke.bound_bwd``) and the new launch's warps per atom, blocks and
waves.  The two kernels' gradients must agree within the bar of
``chip_smoke.py``'s bwd_vs_plain (1e-4 x max(1, gradient scale)).  The
launch floor on the same card (``chip_smoke.launch_floor_ms``) comes first.
One JSON line per measurement; the card's ``nvidia-smi`` name and power
limit first.  Needs one CUDA card.
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


def build_parent(src: Path) -> ctypes.CDLL:
    from molvoxel_torch.ops import _build

    lib_path = ROOT / "build" / "parent" / "libdeposit_bwd_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.deposit_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.deposit_bwd.restype = ctypes.c_int
    return lib


def shapes(dev):
    """(label, coords, weights, radii, mask, spec, sigma, cotangent dtype) of the seven shapes."""
    import numpy as np
    import torch

    from chip_smoke import load_golden
    from molvoxel_torch.core.config import GridSpec, small_atom_bucket
    from molvoxel_torch.ops.batch import random_transform_batch

    lig, prot = load_golden("lig_features_gaussian"), load_golden("protein_single_gaussian")
    lig_xyz = torch.as_tensor(lig["coords"] - lig["center"], device=dev)
    prot_xyz = torch.as_tensor(prot["coords"] - prot["center"], device=dev)
    rng = np.random.default_rng(0)
    # the training batch as VoxelizeLayer builds it: 64-atom molecules, masked, seeded transforms
    b_coords = torch.zeros((64, 64, 3), device=dev)
    b_coords[:, :61] = lig_xyz
    b_mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    b_mask[:, :61] = True
    xyz_t = random_transform_batch(torch.Generator().manual_seed(1234), b_coords, 0.5, True)
    spec64, ones64 = GridSpec(0.5, 64), torch.ones(64, device=dev)
    out = []
    for c, ct_dt in ((4, torch.float32), (4, torch.bfloat16), (16, torch.float32)):
        b_w = torch.zeros((64, 64, c), device=dev)
        b_w[:, :61] = torch.as_tensor((rng.uniform(size=(64, 61, c)) < 0.3).astype(np.float32), device=dev)
        name = "bf16" if ct_dt == torch.bfloat16 else "f32"
        out.append((f"train_64lig_dim64_c{c}_{name}", xyz_t, b_w, ones64, b_mask, spec64, 0.5, ct_dt))
    vp = small_atom_bucket(prot_xyz.shape[0])
    p_coords = torch.zeros((1, vp, 3), device=dev)
    p_coords[0, : prot_xyz.shape[0]] = prot_xyz
    p_mask = torch.arange(vp, device=dev)[None] < prot_xyz.shape[0]
    for dim in (48, 128):
        out.append((f"protein_dim{dim}_c1_f32", p_coords, p_mask[..., None].float(), torch.ones(vp, device=dev),
                    p_mask, GridSpec(0.5, dim), 0.5, torch.float32))
    lig_w = torch.as_tensor(lig["channels"][:, :4].astype(np.float32), device=dev)[None]
    out.append(("ligand_dim256_c4_f32", lig_xyz[None], lig_w, torch.ones(61, device=dev), None, GridSpec(0.25, 256),
                0.5, torch.float32))
    centred = torch.as_tensor((lig["coords"] - lig["coords"].mean(0)).astype(np.float32), device=dev)[None]
    out.append(("pose_lig_dim32_c1_sigma1_f32", centred, torch.ones((1, 61, 1), device=dev),
                torch.ones(61, device=dev), None, GridSpec(0.5, 32), 1.0, torch.float32))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent" / "deposit_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import bound_bwd, emit, grad_err, launch_floor_ms, nvidia_smi, time_graph_ms
    from molvoxel_torch.ops import _build, deposit

    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    _build.build_all(("deposit_bwd",))
    parent = build_parent(args.parent)
    emit({"phase": "launch_floor", "ms": launch_floor_ms()})
    ct_kinds = {torch.float32: 0, torch.bfloat16: 1}
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for label, coords, w, radii, mask, spec, sigma, ct_dt in shapes(dev):
        rows, wt, _, dl, gaussian = deposit.prepare_batch(coords, w, radii, spec=spec, mask=mask, sigma=sigma)
        b, c, vp = wt.shape
        ct = torch.randn((b, c, dl, spec.dimension ** 2), generator=gen, device=dev).to(ct_dt)
        p_rows = torch.empty_like(rows)
        p_w = torch.empty_like(wt)

        def run_parent():
            rc = parent.deposit_bwd(rows.data_ptr(), wt.data_ptr(), ct.data_ptr(), p_rows.data_ptr(), p_w.data_ptr(),
                                    b, vp, c, dl, spec.dimension, float(spec.resolution), float(spec.width / 2.0),
                                    int(gaussian), ct_kinds[ct_dt], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"parent launch failed with cudaError {rc}")

        def run_new():
            return deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian)

        new = run_new()
        run_parent()
        torch.cuda.synchronize()
        err, scale = grad_err(new, (p_rows, p_w))
        times = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            times[who].append(time_graph_ms(run_parent if who == "parent" else run_new))
        # live atoms: the unsorted batches keep their mask's order; the protein's live atoms carry weight 1
        live = wt[:, 0] > 0 if vp > deposit.CHUNK else (
            torch.ones((b, vp), dtype=torch.bool, device=dev) if mask is None else mask)
        live = live & (rows[:, 0].abs() < deposit.FAR / 2)
        b_ms, b_by = bound_bwd(rows, wt, ct, live, spec, dl, gaussian)
        parent_ms, new_ms = statistics.median(times["parent"]), statistics.median(times["new"])
        line = {"phase": "ab", "case": label, "parent_ms": parent_ms, "new_ms": new_ms,
                "parent_runs_ms": times["parent"], "new_runs_ms": times["new"], "new_vs_parent": new_ms / parent_ms,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_diff": err, "tol": 1e-4 * scale,
                "ok": err <= 1e-4 * scale, **deposit.bwd_launch_info(b, c, vp, gaussian, ct_dt)}
        emit(line)
        ok = ok and line["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
