#!/usr/bin/env python3
"""Time gaussian_notrunc's two CUDA routes over a grid of shapes, on one card.

    python3 tools/torch_notrunc_sweep.py [--out FILE]

The routes are the deposit kernel with the notrunc threshold row
(``ops/deposit.voxelize_deposit_batch``) and the separable product
(``ops/separable.voxelize_separable_batch``).  Each shape runs through
``chip_smoke.notrunc_case`` (forward) or ``chip_smoke.notrunc_train_case``
(one forward and one backward), the functions behind ``chip_smoke.py``'s
notrunc_routing phase: both routes on the same inputs, timed end to end by
CUDA-graph replay, the two results held against each other, the kernel
launch alone, its bound, the pairs inside the threshold sphere and the
separable product's FLOPs and bytes.  The shapes are the phase's own and a
grid around them: the golden ligand (61 atoms, C = 4) in batches of 1 to
1,024 at 32^3 to 128^3 and in 64-plane slabs at 256^3, res 0.25; the golden
complex (468 atoms, C = 8); the golden protein and its first 128 to 2,048
atoms (C = 1) at 32^3 to 256^3; f32 and bf16.  The thresholds of
``ops/voxelize.notrunc_use_kernel`` are read off this sweep; its output,
kept under ``tests/data/``, holds the rule in the CPU tests.  Unlike the
phase, it fails no shape for its route; it stops only when the two routes
disagree.
One JSON line per shape on standard output, and into ``--out`` if given;
the card's ``nvidia-smi`` name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROT_ATOMS = (128, 256, 512, 1024, 2048)


def forward_cases():
    """(name, molecule, batch, dim, res, slab, out dtype) of the sweep, then the phase's own."""
    import chip_smoke

    cases = []
    for odt in ("float32", "bfloat16"):
        short = "f32" if odt == "float32" else "bf16"
        for b in (1, 4, 16, 64, 256, 1024):
            cases.append((f"lig61_b{b}_dim64_c4_{short}", "lig", b, 64, 0.5, None, odt))
        for b, dim in ((1, 32), (1, 96), (64, 32), (64, 48), (64, 96)):
            cases.append((f"lig61_b{b}_dim{dim}_c4_{short}", "lig", b, dim, 0.5, None, odt))
        for b in (1, 16):
            cases.append((f"lig61_b{b}_dim256_res025_slab128_64_c4_{short}", "lig", b, 256, 0.25, (128, 64), odt))
    for dim in (32, 64, 96, 128):
        cases.append((f"complex468_b1_dim{dim}_c8_f32", "complex", 1, dim, 0.5, None, "float32"))
    for mol in [f"prot{n}" for n in PROT_ATOMS] + ["prot"]:
        label = "prot3262" if mol == "prot" else mol
        for dim in (32, 48, 64, 96, 128, 192):
            cases.append((f"{label}_b1_dim{dim}_c1_f32", mol, 1, dim, 0.5, None, "float32"))
        for dim in (48, 64):
            cases.append((f"{label}_b1_dim{dim}_c1_bf16", mol, 1, dim, 0.5, None, "bfloat16"))
    names = {c[0] for c in cases}
    return cases + [c for c in chip_smoke.NOTRUNC_CASES if c[0] not in names]


def train_cases():
    """(name, molecule, batch, dim, entry point) of the sweep, then the phase's own."""
    import chip_smoke

    cases = [(f"train_layer_lig61_b{b}_dim{dim}_c4_f32", "lig", b, dim, "VoxelizeLayer")
             for b, dim in ((1, 64), (16, 64), (256, 64), (64, 32), (64, 48))]
    cases += [(f"train_voxelize_{'prot3262' if mol == 'prot' else mol}_dim{dim}_c1_f32", mol, 1, dim, "voxelize")
              for mol, dims in (("prot512", (48, 128)), ("prot1024", (48, 128)), ("prot", (32, 64, 96, 128)))
              for dim in dims]
    cases.append(("train_voxelize_lig61_dim48_c4_f32", "lig", 1, 48, "voxelize"))
    return cases + list(chip_smoke.NOTRUNC_TRAIN_CASES)


def main() -> int:
    import torch

    import chip_smoke
    from molvoxel_torch.ops import _build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_notrunc_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    mols = chip_smoke.notrunc_molecules(PROT_ATOMS)
    bad = []
    out = None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        out = open(args.out, "w")

    def emit(line):
        chip_smoke.emit(line)
        if out is not None:
            out.write(json.dumps(line) + "\n")
            out.flush()

    try:
        emit({"nvidia_smi": chip_smoke.nvidia_smi(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        for name, mol, b, dim, res, slab, odt in forward_cases():
            line = chip_smoke.notrunc_case(name, mols[mol], b, dim, res, slab, odt, dev)
            emit(line)
            if line["max_abs_diff"] > line["tol"]:
                bad.append(name)
        for name, mol, b, dim, entry in train_cases():
            line = chip_smoke.notrunc_train_case(name, mols[mol], b, dim, entry, dev)
            emit(line)
            if line["max_abs_diff"] > line["tol"]:
                bad.append(name)
    finally:
        if out is not None:
            out.close()
    if bad:
        print(f"torch_notrunc_sweep: the routes disagree at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
