#!/usr/bin/env python3
"""Time molvoxel_torch's preparation kernel against an earlier version of it, on one card.

    git show b07506d:molvoxel_torch/csrc/deposit_prep.cu > build/parent/deposit_prep.cu
    python3 tools/torch_prep_ab.py [--parent build/parent/deposit_prep.cu]

The earlier version is a ``deposit_prep.cu`` with the C interface of the
first port of the kernel: ``deposit_prep`` takes an ``order_in`` pointer
after the transform table and 40 arguments in all, each block sorts the
whole molecule in its shared memory up to 16,384 atoms, and above that
``deposit_prep_keys`` writes the keys that ``torch.argsort`` sorts before
the preparation launches with their order.  Its wrapper (a copy of the
earlier ``ops.deposit.deposit_prep``: up to 132 blocks a molecule, threads
sized by the sort) is ``parent_prep`` below.  It is built with nvcc into
``build/parent/``.

Both run on the same raw inputs (``chip_smoke.prep_inputs``) at the shapes
``chip_smoke.py``'s prep_timing times (the headline batch, which is the
``ligand64.batch64`` cell's shape: 64 molecules of one chunk, 4 channels,
64^3, placed; the protein at 48^3, 8 complexes at 48^3, 20,000 and 65,536
atoms at 64^3), at 1, 8 and 64 proteins and complexes at 48^3, and at the
``protein128.batch16`` cell's shape (16 placed proteins at 128^3).  Each is timed by CUDA-graph replay
(``chip_smoke.time_graph_ms``) in turns: parent, new, new, parent; the line
gives both medians, the new launch's plan, the bound (``chip_smoke.prep_bound``)
and the launch floor.  The two must agree bit for bit (rows, weights,
ranges, permutation).  Then each shape is timed again at other
``deposit.PREP_MIN_SHARE`` (the fewest atoms a block of a sorting cluster
takes; sorted shapes) and ``deposit.PREP_PAIR_THREADS`` (the threads a
block takes for each pair of its plane ranges), to show what the cluster
width and the block size buy, each value in turns with the code's
(code, value, value, code).  One JSON line per
measurement; the card's ``nvidia-smi`` name and power limit first.  Needs
one CUDA card.
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

PARENT_SORT_MAX = 16384  # atoms the earlier kernel sorts in one block's shared memory
PARENT_TARGET_BLOCKS = 132  # the earlier wrapper split a small batch's chunks until a launch had this many

# (label, molecule, batch, channels, dim, options) beyond the PREP_CASES rows
EXTRA_SHAPES = [(f"prot_b{b}_dim48", "prot", b, 1, 48, {"bucket"}) for b in (1, 8, 64)] + \
    [(f"complex_b{b}_dim48_c8", "complex", b, 8, 48, {"bucket"}) for b in (1, 8, 64)] + \
    [("prot_b16_dim128_placed", "prot", 16, 1, 128, {"bucket", "place"})]
PREP_ROWS = ("headline_64lig_dim64_c4", "prot_dim48_c1", "complex8_dim48", "prot20000_dim64", "prot65536_dim64")


def build_parent(src: Path) -> ctypes.CDLL:
    from molvoxel_torch.ops import _build

    lib_path = ROOT / "build" / "parent" / "libdeposit_prep_parent.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.deposit_prep.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 18 + [ctypes.c_float] * 9 + \
        [ctypes.c_int, ctypes.c_void_p]
    lib.deposit_prep.restype = ctypes.c_int
    lib.deposit_prep_keys.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + \
        [ctypes.c_void_p]
    lib.deposit_prep_keys.restype = ctypes.c_int
    lib.deposit_prep_sort_max.restype = ctypes.c_int
    if lib.deposit_prep_sort_max() != PARENT_SORT_MAX:
        raise SystemExit("the parent kernel does not sort 16,384 atoms in shared memory")
    return lib


def parent_prep(lib, coords, weights, radii, mask, centers, transforms, plan):
    """The earlier wrapper: the keys launch and torch.argsort above 16,384
    atoms, then the preparation launch, each molecule's chunks split over
    blocks that each sort it again."""
    import numpy as np
    import torch

    from molvoxel_torch.core.config import round_up
    from molvoxel_torch.ops.deposit import CHUNK, Prepared, notrunc_factor, range_rows

    def ptr(t):
        return None if t is None else t.data_ptr()

    table = None if transforms.table is None else transforms.table.to(torch.float32)
    b, v, _ = coords.shape
    c = weights.shape[2]
    spec, dev = plan.spec, coords.device
    dim = spec.dimension
    vp = round_up(v, CHUNK)
    vo = c * vp if plan.channelwise else vp
    dl = dim if plan.d_count is None else plan.d_count
    ht = range_rows(b, c, dl, dim, vo)
    nht = -(-dim // ht)
    sort = plan.sort and vp > CHUNK
    radii_mode = 2 if plan.channelwise else 1 if radii.ndim == 2 else 0
    lb, res = float(spec.lower_bound), float(spec.resolution)
    scale = ((1 << 5) - 1) / max(spec.width, 1e-6)
    stream = torch.cuda.current_stream(dev).cuda_stream
    order = None
    if sort and vp > PARENT_SORT_MAX:
        keys = torch.empty((b, vp), dtype=torch.int32, device=dev)
        rc = lib.deposit_prep_keys(coords.data_ptr(), ptr(mask), ptr(centers), ptr(table), keys.data_ptr(), b, v, vp,
                                   int(transforms.rot), int(transforms.trans), int(plan.channelwise), lb, scale, stream)
        if rc != 0:
            raise RuntimeError(f"parent keys launch failed with cudaError {rc}")
        order = torch.argsort(keys, dim=1, stable=True).to(torch.int32)
    rows = torch.empty((b, 8, vo), dtype=torch.float32, device=dev)
    wt = torch.empty((b, c, vo), dtype=torch.float32, device=dev)
    ranges = torch.empty((b, nht, vo // CHUNK, 2), dtype=torch.int32, device=dev)
    perm = torch.empty((b, vp), dtype=torch.int32, device=dev)
    words = 1 << (vp - 1).bit_length() if sort and order is None else 0
    nvc = vo // CHUNK
    want = min(nvc, max(1, -(-PARENT_TARGET_BLOCKS // b)))
    cpb = -(-nvc // want)
    split = -(-nvc // cpb)
    threads = min(1024, max(128, round_up(max(cpb * CHUNK, words // 2), 32)))
    rc = lib.deposit_prep(
        coords.data_ptr(), weights.data_ptr(), radii.data_ptr(), ptr(mask), ptr(centers), ptr(table), ptr(order),
        rows.data_ptr(), wt.data_ptr(), ranges.data_ptr(), perm.data_ptr(), b, v, vp, c, vo, dl, dim, ht, nht, split,
        cpb, radii_mode, int(transforms.rot), int(transforms.trans), int(sort), int(plan.channelwise),
        int(plan.gaussian), int(plan.notrunc), lb, float(spec.upper_bound), scale, res,
        float(np.float32(1.0) / np.float32(res)), float(np.float32(plan.d_offset) * np.float32(res)),
        float((ht - 1) * res), -(0.5 / (plan.sigma * plan.sigma)), notrunc_factor(plan.sigma), threads, stream)
    if rc != 0:
        raise RuntimeError(f"parent launch failed with cudaError {rc}")
    return Prepared(rows, wt, ranges, perm, dl), {"split": split, "cpb": cpb, "threads": threads,
                                                  "launches": 2 if order is not None else 1}


def shapes(dev):
    """(label, inputs, plan): the PREP_ROWS rows of PREP_CASES, then EXTRA_SHAPES."""
    from chip_smoke import PREP_CASES, prep_case, prep_inputs, prep_plan
    from molvoxel_torch.ops import deposit

    out = [(name, *prep_case(name, dev)) for name in PREP_ROWS]
    for k, (label, mol, b, c, dim, opts) in enumerate(EXTRA_SHAPES):
        coords, w, radii, mask, centers, transforms, _ = prep_inputs(mol, b, c, opts, dev, seed=len(PREP_CASES) + k)
        out.append((label, (coords, w, radii, mask, centers, deposit.transform_table(transforms, dev)),
                    prep_plan("gaussian", dim, 0.5, None, opts)))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=ROOT / "build" / "parent" / "deposit_prep.cu")
    ap.add_argument("--shares", default="64,128,512,1024", help="other PREP_MIN_SHARE to time the new kernel at")
    ap.add_argument("--pair-threads", default="0,4,32", help="other PREP_PAIR_THREADS to time the new kernel at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prep_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from chip_smoke import emit, launch_floor_ms, nvidia_smi, prep_bound, same_bits, time_graph_ms
    from molvoxel_torch.ops import _build, deposit

    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0)})
    _build.build_all(("deposit_prep",))
    parent = build_parent(args.parent)
    floor_ms = launch_floor_ms()
    lines = []
    for label, inputs, plan in shapes(dev):
        new = deposit.deposit_prep(*inputs, plan)
        old, old_launch = parent_prep(parent, *inputs, plan)
        torch.cuda.synchronize()
        fields = ("rows", "weights", "ranges", "perm")
        equal = {f: same_bits(getattr(new, f), getattr(old, f)) for f in fields}
        times = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            fn = (lambda: parent_prep(parent, *inputs, plan)) if who == "parent" else \
                (lambda: deposit.deposit_prep(*inputs, plan))
            times[who].append(time_graph_ms(fn))
        b, vp, vo = inputs[0].shape[0], new.perm.shape[1], new.rows.shape[2]
        sort = plan.sort and vp > deposit.CHUNK
        b_ms, b_by = prep_bound(new, inputs[0], inputs[1], inputs[2], inputs[3], plan)
        p_ms, n_ms = statistics.median(times["parent"]), statistics.median(times["new"])
        line = {"phase": "prep_ab", "case": label, "batch": b, "atoms": inputs[0].shape[1], "padded_atoms": vp,
                "sorted": bool(sort), "parent_ms": p_ms, "new_ms": n_ms, "new_vs_parent": n_ms / p_ms,
                "parent_runs_ms": times["parent"], "new_runs_ms": times["new"], "bound_ms": b_ms, "bound_by": b_by,
                "launch_floor_ms": floor_ms,
                "new_launch": deposit.prep_launch(b, vp, vo, new.ranges.shape[1], sort,
                                                  deposit._WIDE_CLUSTERS[inputs[0].device])._asdict(),
                "parent_launch": old_launch, "bitwise_equal": equal, "ok": all(equal.values())}
        emit(line)
        lines.append(line)
        sweeps = [("PREP_MIN_SHARE", int(x)) for x in args.shares.split(",") if x and sort]
        sweeps += [("PREP_PAIR_THREADS", int(x)) for x in args.pair_threads.split(",") if x]
        for knob, value in sweeps:
            default = getattr(deposit, knob)
            runs = {default: [], value: []}
            try:
                for v in (default, value, value, default):  # in turns
                    setattr(deposit, knob, v)
                    deposit._PLANS.clear()  # the plans of the other constant
                    got = deposit.deposit_prep(*inputs, plan)
                    if v == value:
                        same = all(same_bits(getattr(got, f), getattr(new, f)) for f in fields)
                        launch = deposit.prep_launch(b, vp, vo, new.ranges.shape[1], sort,
                                                     deposit._WIDE_CLUSTERS[inputs[0].device])._asdict()
                    runs[v].append(time_graph_ms(lambda: deposit.deposit_prep(*inputs, plan)))
            finally:
                setattr(deposit, knob, default)
                deposit._PLANS.clear()
            emit({"phase": "sweep", "case": label, "knob": knob, "value": value, "bitwise_equal_default": same,
                  "ms": statistics.median(runs[value]), "default": default,
                  "default_ms": statistics.median(runs[default]), "runs_ms": {str(k): t for k, t in runs.items()},
                  "launch": launch})
        del new, old
    return 0 if all(ln["ok"] for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
