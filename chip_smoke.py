#!/usr/bin/env python3
"""Smoke run of molvoxel_torch on one CUDA card: build, check, drive, time.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run with a non-zero
exit code:

1. card: ``nvidia-smi`` name and power limit, CUDA and torch versions.
2. build: compile every kernel from ``molvoxel_torch/csrc`` (one nvcc for
   each source, all started together).
3. kernel_vs_plain: each forward case against ``deposit_plain`` on the
   card, on the same prepared inputs, in the working type (f32 1e-5, bf16
   2^-7*max, fp8 2^-3*max): aligned grids (dims 48, 64), ragged grids (dims
   20, 33, 40, 50), a 256^3 grid, the 61-atom ligand and the 3262-atom
   protein of tests/goldens, depth slabs (one at planes 5..31, not a whole
   number of bricks), channel-wise radii, C = 1, 6, 9 and 12 (more than one
   channel group), a batch of 512 ligands at 32^3 and the notrunc
   threshold row; every case is launched twice and the two grids must be
   bitwise equal.  An all-masked batch at the headline shape must give an
   exact zero grid; it is timed as it is and with its atoms parked off the
   grid (the kernel's store floor).  Then bwd_vs_plain: the backward kernel against
   ``deposit_bwd_plain`` on the same inputs and cotangent: the headline
   batch (f32 and bf16 cotangent, and C = 16), the protein at 48^3 and
   128^3, dims 20 and 40, the ligand at 256^3, a depth slab, channel-wise
   radii (9 channels), binary density and the notrunc threshold row.  Bars:
   f32 1e-4 x max(1, gradient scale), since the kernel sums in another
   order; a bf16 cotangent is held at that bar against the plain version on
   the same bf16 values, and at 3e-2 x scale against the f32 cotangent.
   Every case is launched twice, and the two launches' gradients must be
   bitwise equal.  A batch of 70,000 one-chunk molecules at 8^3 (more than
   a grid axis holds) must equal, bit for bit, the same kernel run on its
   two halves.
4. goldens: all 22 goldens through ``create_voxelizer`` on CUDA, at their
   own bars (1e-5; 5e-5 for the two *_torchref goldens, gaussian_notrunc).
5. main_path: the entry points at full width, with the launch counts set
   to 0 just before and read just after each path:
   - row 1 (whole-row grids): ``forward_batch`` on 64 ligands of 61 atoms,
     each with its own random rotation and 0.5 A translation, into a 64^3 x 4
     gaussian grid in bfloat16; the 3262-atom protein at 48^3 and 128^3, f32
     (and gaussian_notrunc at 128^3 against the dense path at 1e-5, on the
     route ``notrunc_use_kernel`` names: one launch on the kernel, none on
     the separable product);
   - row 2 (gaussian, ragged or 256^3): the ligand at dims 20 and 40 and at 256^3;
   - row 3 (binary, ragged or 256^3): the ligand at dim 40 and at 256^3;
   - row 4 (backward): the training step, the headline batch through
     ``nn.VoxelizeLayer`` (seeded random rotation and 0.5 A translation, f32
     grids), ``nn.VoxelCNN(4, 64, (16, 32, 64))`` and a ``Linear(64, 1)``,
     MSE on per-molecule labels, Adam over the CNN and per-molecule rigid
     poses (quaternion and shift): 2 warm-up and 7 timed steps, one forward
     and one backward launch each.
   Each path's output is checked against the plain path, and each kernel
   is timed (CUDA-graph replay of 10 launches, median of 7; and back to
   back) beside its plain version at that path's shapes; the backward's
   line adds its warps per atom, blocks and waves, and the launch floor
   (an ``add_(1)`` on one element, timed the same way).  Forward lines
   carry the launch's brick, blocks, waves (blocks / (resident blocks per
   SM x SMs)) and write rate (grid bytes / kernel time).  The headline
   ``forward_batch`` call and the training step are also timed on the host
   clock (median, minimum and maximum of 7).
   notrunc_routing (after the main paths): gaussian_notrunc's two CUDA
   routes from the same inputs (golden molecules padded as the entry points
   pad them, radii 1.0, sigma 0.5): the kernel route
   (``voxelize_deposit_batch``: padding, Morton sort, threshold row, plane
   ranges, launch) and the separable product (``voxelize_separable_batch``),
   each timed end to end by CUDA-graph replay (the lower of two medians of
   7, in turns), the kernel launch alone and its plain version.  Shapes
   (NOTRUNC_CASES): the 61-atom ligand in a batch of 64 at 64^3 x 4 (f32,
   bf16), alone at 48^3 and 128^3, 4 of them in the 64-plane slab 128..191
   of 256^3 at res 0.25; the 468-atom golden complex at 48^3 x 8; the
   protein's first 1,024 atoms at 48^3 and 128^3; the 3262-atom protein at
   48^3, 128^3, 256^3 (f32) and 128^3 (bf16).  The grids agree at 2e-5
   (f32) or 2^-7 max (bf16); each line has both times, the kernel's bound,
   the pairs inside the threshold sphere, the separable product's FLOPs,
   bytes and bound, and the route the port takes.  Then one forward and one
   backward through each route (NOTRUNC_TRAIN_CASES: the headline batch as
   ``VoxelizeLayer`` takes it, the protein at 48^3 through
   ``ops.voxelize.voxelize`` with radii gradients), gradients within 5e-3 x
   max(1, scale), the backward launch alone, its plain version and its
   bound; the entry point itself must take the port's route.  The phase
   fails if the port's route is more than 10% slower than the other
   anywhere.
6. convergence: examples/pose_optimize.py through the kernel backward, the
   61-atom golden ligand at 32^3, sigma 1.0, 400 Adam steps at 3e-2 on
   (quaternion, shift) from a hidden pose drawn from a numpy seed; it must
   end below 0.05 A RMSD.
7. sliced_256: 4 ligands at 256^3, res 0.25, 4 channels, f32, each with a
   random rotation and 0.5 A translation, through ``pick_slab_depth`` (64)
   and ``voxelize_batch_sliced`` into a ``np.memmap``: 4 launches, held
   against one full-depth launch under the same transform at 1e-5; host
   clock of the call.  packing: 64 molecules at 64^3 packed
   (``_packed_batch``) and unpacked, through the CUDA deposit and through
   the separable product (gaussian_notrunc), at Vp 32 and 64 and C 1 and 4:
   equal at 1e-5 (f32), both timed by CUDA-graph replay in turns; the route
   ``voxelize_batch`` takes on both: unpacked, or for gaussian_notrunc where
   ``notrunc_use_kernel`` names the kernel, one launch and the separable
   product's grid at 2e-5.
8. library_store: a library of LIBRARY_RECORDS records synthesized from the
   golden ligand (``write_library``, one all-hydrogen and one empty record
   among them); the CLI writes its first 512 records to a bf16 grid store
   at 48^3 with .dx volumes: every record slot, 16 sampled grids within
   2^-7*max of the dense path, four .dx files.
9. library_stream: the CLI's ``--throughput --trials 3`` (random rotation,
   0.5 A translation, bf16, 64^3, superbatch 4096, chunk 1024, 2 parser
   threads) on the whole library, plain, ``--wire`` and ``--presort``:
   mols/s (median, min, max), 4 launches per superbatch, the native parser
   used; the device's busy share of one pass (torch.profiler); the feeder
   alone; and, on the first 4096 records without augmentation in f32,
   ``stream_checksum`` against the sum of ``run_batches``' grids at rtol
   1e-5, the wire checksum against the dequantized coordinates at 1e-5 and
   against f32 at 2e-3, and the chunk loop under sync-debug "error".
   The native parser's g++ build (native_build) runs after phase 2.
10. wrappers (before the library phases): ComplexWrapper over the golden
   ligand (61 atoms) and pocket (407) of tests/goldens/pocket_types_gaussian.npz
   at 48^3, res 0.5, on the card: against the dense path at 1e-5 with and
   without a seeded random rotation and 0.5 A translation, against the
   golden; ``visualize`` writes the fallback without PyMOL, and its eight
   .dx volumes read back within 1e-5.
11. interop_dataset: VoxelGridDataset over the whole library (64^3 x 4,
   bf16, batch 64, random rotation and 0.5 A translation) through
   DataLoader(batch_size=None, num_workers=0): one warm and two timed
   passes (mols/s, molecules = records with atoms, one launch a batch);
   its first 8 batches without augmentation against voxelize_batch at
   2^-7*max; 20 steps of VoxelCNN(4, 64, (16, 32, 64)) + Linear(64, 1) +
   Adam fed by it (finite loss, host-clock step ms).  interop_store:
   GridStoreDataset over library_store's store through a shuffling
   DataLoader with two spawned workers: 64 sampled items equal the reader's,
   bit for bit.
12. parallel (one rank, NCCL, no launcher): voxelize_batch_dp on the
   headline batch bit for bit voxelize_batch under the same draws;
   voxelize_depth_sharded for the ligand at 256^3 (gaussian, binary) and
   the protein at 128^3 against one full-depth call at 1e-5;
   voxelize_batch_2d's mass against its grids' sum at rtol 1e-5;
   StreamingVoxelizer(mesh=...) over the first 4,096 records, augmented,
   bit for bit the meshless stream.
13. multiprocess: two spawned ranks over gloo, both on the one card:
   stream_dp_multiprocess on the whole library (64^3 x 4, bf16, augmented;
   per-rank molecules sum to the library's; mols/s), the first 512 records
   into per-rank stores at 48^3 bf16 whose rows in rank order equal a
   single-process stream's (2^-7*max; bitwise reported), and each rank's
   depth slab of the rotated ligand at 256^3 over a (1, 2) mesh, the two
   seeded apart, assembled against one full-depth call at 1e-5.
14. kernels: one line {"kernels": [...]} with each kernel's launches (the
   main paths' and, by phase, notrunc_routing's and phases 10-13's), error,
   times and bound; rows 1, 2 and 4 carry a "notrunc" entry: a timed
   notrunc_routing case with the kernel launch's ms, its plain version's ms
   and its bound, the kernel route's ms, and the separable product's ms as
   its library_ms.
Then the nvidia-smi line again, and last {"ok": true, "device": {...}}.

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
REPLACES = {
    1: "molvoxel_tpu/ops/pallas_deposit.py:407 (_kernel_v5, launched at :813)",
    2: "molvoxel_tpu/ops/pallas_deposit.py:295 (_kernel_gaussian, launched at :716)",
    3: "molvoxel_tpu/ops/pallas_deposit.py:344 (_kernel_binary, launched at :726)",
    4: "molvoxel_tpu/ops/pallas_deposit.py:903 (_kernel_v5_bwd, launched at :1190)",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
DEVICE = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_golden(stem):
    import numpy as np

    return dict(np.load(GOLDENS / f"{stem}.npz", allow_pickle=False))


def _fixed_width(values, width: int, decimals: int):
    """(N,) floats -> (N, width) uint8 text, right-aligned like '%10.4f'."""
    import numpy as np

    q = np.rint(np.asarray(values, np.float64) * 10**decimals).astype(np.int64)
    a = np.abs(q)
    frac, ipart = a % 10**decimals, a // 10**decimals
    out = np.full((len(q), width), ord(" "), np.uint8)
    for k in range(decimals):
        out[:, width - 1 - k] = ord("0") + (frac // 10**k) % 10
    out[:, width - 1 - decimals] = ord(".")
    ndig = np.floor(np.log10(np.maximum(ipart, 1))).astype(np.int64) + 1
    pos = width - 2 - decimals
    for k in range(int(ndig.max(initial=1))):
        has = k < ndig
        out[has, pos - k] = ord("0") + (ipart[has] // 10**k) % 10
    neg = np.nonzero(q < 0)[0]
    out[neg, pos - ndig[neg]] = ord("-")
    return out


def write_library(path, n_records: int, seed: int = 0, all_h_at: int = 7, empty_at: int = 300):
    """Write an SDF V2000 library of ``n_records`` ligands, formatted by numpy.

    Each record is the golden ligand of tests/goldens/lig_types_gaussian.npz
    (types 0-3 as C, N, O, S), rotated by a random quaternion about its
    centroid, each coordinate jittered by U(-0.3, 0.3) A, and cut to a random
    subset of 20-61 of its atoms; all drawn from ``seed``.  Record
    ``all_h_at`` holds five hydrogens and record ``empty_at`` no atom (both
    voxelize to empty grids but keep their slots).  Returns the path."""
    import numpy as np

    g = np.load(GOLDENS / "lig_types_gaussian.npz")
    base = g["coords"].astype(np.float64)
    centroid = base.mean(0)
    base = base - centroid
    symbols = np.array([b"C  ", b"N  ", b"O  ", b"S  ", b"H  "])
    types = g["channels"].astype(np.int64)
    rng = np.random.default_rng(seed)
    n = n_records
    counts = rng.integers(20, base.shape[0] + 1, n)
    counts[[i for i in (all_h_at, empty_at) if i < n]] = 0
    counts[all_h_at] = 5 if all_h_at < n else 0
    u = rng.uniform(size=(n, 3))
    a, b = np.sqrt(1 - u[:, 0]), np.sqrt(u[:, 0])
    q = np.stack([a * np.sin(2 * np.pi * u[:, 1]), a * np.cos(2 * np.pi * u[:, 1]),
                  b * np.sin(2 * np.pi * u[:, 2]), b * np.cos(2 * np.pi * u[:, 2])], -1)
    w, x, y, z = q.T
    rot = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                    np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                    np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)
    pick = np.argsort(rng.uniform(size=(n, base.shape[0])), axis=1)  # a random atom order per record
    rec = np.repeat(np.arange(n), counts)
    slot = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    atom = pick[rec, slot]
    xyz = np.einsum("nij,nj->ni", rot[rec], base[atom]) + centroid
    xyz += rng.uniform(-0.3, 0.3, size=xyz.shape)
    sym = types[atom]
    if all_h_at < n:
        sym[rec == all_h_at] = 4
    tail = np.frombuffer(b"  0  0  0  0  0  0  0  0  0  0  0  0\n", np.uint8)
    lines = np.concatenate([_fixed_width(xyz[:, 0], 10, 4), _fixed_width(xyz[:, 1], 10, 4),
                            _fixed_width(xyz[:, 2], 10, 4), np.full((len(sym), 1), ord(" "), np.uint8),
                            symbols[sym].view(np.uint8).reshape(-1, 3), tail[None].repeat(len(sym), 0)], axis=1)
    width = lines.shape[1]
    text = lines.tobytes()
    starts = (np.cumsum(counts) - counts) * width
    parts = []
    for i in range(n):
        parts.append(f"lig{i}\n  molvoxel\n\n{counts[i]:3d}  0  0  0  0  0  0  0  0999 V2000\n".encode())
        parts.append(text[starts[i]:starts[i] + counts[i] * width])
        parts.append(b"M  END\n$$$$\n")
    Path(path).write_bytes(b"".join(parts))
    return Path(path)


def bar(out_dtype, ref):
    """Tolerance for a grid of ``out_dtype`` against the f32 reference ``ref``."""
    import torch

    scale = max(float(ref.abs().max()), 1.0)
    return {torch.float32: 1e-5, torch.bfloat16: 2**-7 * scale, torch.float8_e4m3fn: 2**-3 * scale}[out_dtype]


def time_ms(fn, reps=7, inner=10):
    """Milliseconds per call of fn(): the median over ``reps`` of CUDA-event
    timings of ``inner`` back-to-back calls, after two warm-ups.  Calls run
    back to back so that the host's enqueue overlaps the device's work."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_graph_ms(fn, reps=7, inner=10):
    """Device milliseconds per call of fn(): ``inner`` calls captured in one
    CUDA graph, replayed ``reps`` times under CUDA events (median).  No host
    time sits between the launches, so a kernel shorter than its wrapper's
    host cost is timed by the card, not by the host."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def launch_floor_ms():
    """Device milliseconds of the smallest launch: ``add_(1)`` on a
    one-element tensor, timed as ``time_graph_ms`` times a kernel."""
    import torch

    one = torch.zeros(1, device=DEVICE)
    return time_graph_ms(lambda: one.add_(1))


def cutoff_pairs(rows, live, spec, dl):
    """(pairs, voxels) for these kernel inputs, counting only the ``live``
    (B, Vp) atoms: the (atom, voxel) pairs inside the cutoff (the pair work
    this data needs), and the distinct (molecule, voxel) cells they reach
    (the cotangent cells a backward must read)."""
    import torch

    res = float(spec.resolution)
    half = spec.width / 2.0
    dim = spec.dimension
    mol = torch.nonzero(live)[:, 0]
    x, y, z, r2 = (rows[:, k][live].double() for k in range(4))
    if x.numel() == 0:
        return 0, 0
    r = torch.sqrt(r2)
    n = int(torch.ceil(r.max() / res)) * 2 + 3
    offs = torch.arange(n, device=rows.device, dtype=torch.float64)
    seen = torch.zeros(rows.shape[0] * dl * dim * dim, dtype=torch.bool, device=rows.device)
    total = 0
    for i in range(0, x.numel(), 4096):
        sl = slice(i, i + 4096)
        d2 = 0
        flat = mol[sl].reshape(-1, 1, 1, 1)
        for k, (p, size) in enumerate(((x[sl], dl), (y[sl], dim), (z[sl], dim))):
            first = torch.floor((p - r[sl] + half) / res) - 1
            idx = first[:, None] + offs
            dk2 = (idx * res - half - p[:, None]) ** 2
            dk2 = torch.where((idx >= 0) & (idx < size), dk2, torch.full_like(dk2, float("inf")))
            shape = [-1, 1, 1, 1]
            shape[1 + k] = n
            d2 = d2 + dk2.reshape(shape)
            flat = flat * size + idx.clamp(0, size - 1).to(torch.int64).reshape(shape)
        hit = d2 <= r2[sl, None, None, None]
        total += int(hit.sum())
        seen[flat.expand(hit.shape)[hit]] = True
    return total, int(seen.sum())


def bound(rows, wt, ranges, out, spec, dl, gaussian):
    """Least time (ms) the card could take: max(bytes / HBM rate, FP32 ops /
    FP32 rate).  Bytes: inputs read once, output written once; the inputs
    are the five rows the kernel reads ([x, y, z, r^2, coef]) and the C
    weights of each atom with a nonzero weight (padding and masked atoms
    carry none), plus the plane ranges.  Ops per in-cutoff pair: 8 for the
    cutoff, then 3 exp + 2 mul + 2 per channel (gaussian) or 1 per channel
    (binary)."""
    c = wt.shape[1]
    live = wt.abs().amax(dim=1) > 0
    n_live = int(live.sum())
    n_bytes = n_live * (5 + c) * 4 + sum(t.numel() * t.element_size() for t in (ranges, out))
    per_pair = 8 + (3 + 2 + 2 * c if gaussian else c)
    ops = cutoff_pairs(rows, live, spec, dl)[0] * per_pair
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_bwd(rows, wt, ct, live, spec, dl, gaussian):
    """The backward's bound on the terms of ``bound``: the cotangent cells
    the live atoms reach, read once, in place of the grid written, and the
    gradients written (grad_rows (B, 8, Vp) and grad_weights (B, C, Vp),
    f32) in place of nothing; the five rows and C weights of the live atoms
    are read as before.  Live atoms are the unmasked ones (``live``, (B,
    Vp)): one whose weights are all zero still has a weight gradient.  Ops
    per in-cutoff pair, from deposit_bwd.cu: 8 for the cutoff, then 3 exp +
    2 mul for f, 4 per channel (two FMAs: the weight gradient and Q) and 10
    for the coordinate and coef sums (gaussian), or 1 per channel
    (binary)."""
    b, c, vp = wt.shape
    n_live = int(live.sum())
    pairs, voxels = cutoff_pairs(rows, live, spec, dl)
    n_bytes = n_live * (5 + c) * 4 + voxels * c * ct.element_size() + b * vp * (8 + c) * 4
    per_pair = 8 + (3 + 2 + 4 * c + 10 if gaussian else c)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * per_pair / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(x, y):
    """Whether two tensors hold the same bytes."""
    import torch

    return x.shape == y.shape and torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))


def grad_err(got, want):
    """(max abs error, gradient scale max(1, max |want|)) over both gradients."""
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    return err, max([float(w.abs().max()) for w in want] + [1.0])


class KernelTimer:
    """Replaces the kernel wrappers that ``module`` calls by ones that record
    a CUDA event pair around each call and keep the last call's arguments;
    the originals come back on exit.  The launches still go through the
    originals, so they count."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.events = {name: [] for name in names}
        self.last = {}

    def __enter__(self):
        import torch

        self.saved = {name: getattr(self.module, name) for name in self.names}

        def wrap(name, fn):
            def timed(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events[name].append((start, end))
                self.last[name] = (args, kw)
                return out
            return timed

        for name, fn in self.saved.items():
            setattr(self.module, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def median_ms(self, name):
        return statistics.median(start.elapsed_time(end) for start, end in self.events[name])


LIBRARY_RECORDS = 50_000  # the JAX package's production stream (docs/DESIGN.md:254-268)
SYMBOLS = ["C", "N", "O", "S"]


def first_records(src: Path, n: int, dst: Path) -> Path:
    """Copy the first ``n`` records of an SDF file to ``dst``."""
    data = src.read_bytes()
    end = 0
    for _ in range(n):
        end = data.index(b"$$$$\n", end) + 5
    dst.write_bytes(data[:end])
    return dst


def phase_native_build():
    """native_build: build the host parser with g++ into build/molvoxel_torch/ and load it."""
    from molvoxel_torch import native
    from molvoxel_torch.native import build

    t0 = time.perf_counter()
    path = build.build(force=True)
    seconds = time.perf_counter() - t0
    available = bool(native.NATIVE_AVAILABLE)
    ok = path is not None and available and path.parent == build.BUILD_DIR
    emit({"phase": "native_build", "seconds": seconds,
          "library": None if path is None else str(path.relative_to(ROOT)),
          "native_available": available, "ok": bool(ok)})
    if not ok:
        raise SystemExit("native_build failed: the host parser did not build or load")


def phase_sliced_256(lig_xyz, tmp: Path, rng):
    """sliced_256: 4 ligands at 256^3, res 0.25, 4 channels, f32, a random
    rotation and 0.5 A translation each, through pick_slab_depth and
    voxelize_batch_sliced into a np.memmap; held against one full-depth
    launch under the same transform.  Returns its kernels-line fields."""
    import numpy as np
    import torch

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import batch, deposit

    spec = GridSpec(0.25, 256)
    b, c = 4, 4
    slab = batch.pick_slab_depth(spec, c)
    dev = lig_xyz.device
    coords = lig_xyz[None].expand(b, -1, -1).contiguous()
    w = torch.as_tensor(rng.uniform(0.0, 1.0, size=(b, lig_xyz.shape[0], c)).astype(np.float32), device=dev)
    radii = torch.ones(lig_xyz.shape[0], device=dev)
    out = np.memmap(tmp / "sliced_256.f32", dtype=np.float32, mode="w+", shape=(b, c, 256, 256, 256))

    def sliced():
        return batch.voxelize_batch_sliced(coords, w, radii, None, None, torch.Generator().manual_seed(5), 0.5,
                                           spec=spec, slab_depth=slab, out=out, random_rotation=True)

    torch.cuda.synchronize()
    deposit.reset_launches()
    t0 = time.perf_counter()
    got = sliced()
    first_s = time.perf_counter() - t0
    launches = deposit.launches["deposit_fwd"]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sliced()
        times.append(time.perf_counter() - t0)
    full = batch.voxelize_batch(coords, w, radii, None, None, torch.Generator().manual_seed(5), 0.5, spec=spec,
                                random_rotation=True)
    err = max(float((full[i] - torch.from_numpy(np.asarray(got[i])).to(dev)).abs().max()) for i in range(b))
    ok = got is out and slab == 64 and launches == 256 // slab and err <= 1e-5 and bool(torch.isfinite(full).all())
    line = {"phase": "sliced_256", "case": "4lig_dim256_res025_c4_f32_rot_trans05_memmap", "slab_depth": slab,
            "launches": launches, "max_abs_err_vs_full_depth": err, "tol": 1e-5, "first_call_s": first_s,
            "call_s_median": statistics.median(times), "call_s_min": min(times), "call_s_max": max(times),
            "grid_gib": out.nbytes / 2**30, "ok": bool(ok)}
    emit(line)
    del full, out, got
    if not ok:
        raise SystemExit("sliced_256 failed")
    return line


def phase_packing(lig_xyz, rng):
    """packing: 64 small molecules at 64^3 packed (``_packed_batch``) and
    unpacked, at Vp 32 and 64 and C 1 and 4, on both paths that the JAX
    package packs: the CUDA deposit (packed as ``_choose_pack`` says) and
    the separable product of gaussian_notrunc (as ``_choose_pack_separable``
    says).  Grids equal at 1e-5 (f32), both timed by CUDA-graph replay in
    turns (unpacked, packed, packed, unpacked); and the route that
    ``voxelize_batch`` takes on the card: unpacked (its grid is the
    unpacked one, bit for bit, with one kernel launch on the kernel path
    and none on the separable one), or, where ``notrunc_use_kernel`` sends
    a gaussian_notrunc shape to the kernel, one kernel launch and a grid
    within 2e-5 of the separable product's."""
    import numpy as np
    import torch

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import batch, deposit
    from molvoxel_torch.ops.deposit import voxelize_deposit_batch
    from molvoxel_torch.ops.separable import voxelize_separable_batch
    from molvoxel_torch.ops.voxelize import notrunc_use_kernel

    spec = GridSpec(0.5, 64)
    dev = lig_xyz.device

    def batch_route(density, crd, ww, r, mask, unpacked):
        """The route voxelize_batch takes: "unpacked", "kernel" (the rule's
        kernel route for notrunc) or "other"."""
        vp, c = ww.shape[1:]
        kernel = density == "gaussian" or notrunc_use_kernel(vp, spec.dimension, channels=c, batch=ww.shape[0])
        deposit.reset_launches()
        got = batch.voxelize_batch(crd, ww, r, mask, None, spec=spec, density_type=density)
        torch.cuda.synchronize()
        if deposit.launches["deposit_fwd"] != int(kernel):
            return "other"
        if density == "gaussian_notrunc" and kernel:
            return "kernel" if float((got - unpacked).abs().max()) <= 2e-5 else "other"
        return "unpacked" if torch.equal(got, unpacked) else "other"

    paths = {  # path: (unpacked op, pack table, density that voxelize_batch takes there)
        "kernel": (lambda crd, ww, r, mask=None: voxelize_deposit_batch(crd, ww, r, spec=spec, mask=mask),
                   batch._choose_pack, "gaussian"),
        "separable": (lambda crd, ww, r, mask=None: voxelize_separable_batch(crd, ww, r, spec=spec, mask=mask),
                      batch._choose_pack_separable, "gaussian_notrunc"),
    }
    lines = []
    for vp in (32, 64):
        n = min(vp, lig_xyz.shape[0])
        xyz = lig_xyz[:n] - lig_xyz[:n].mean(0)
        posed = batch.random_transform_batch(torch.Generator().manual_seed(vp), xyz[None].expand(64, -1, -1),
                                             0.5, True)
        coords = torch.zeros((64, vp, 3), device=dev)
        coords[:, :n] = posed
        mask = torch.zeros((64, vp), dtype=torch.bool, device=dev)
        mask[:, :n] = True
        radii = torch.ones(vp, device=dev)
        for c in (1, 4):
            w = torch.zeros((64, vp, c), device=dev)
            w[:, :n] = torch.as_tensor(rng.uniform(0.2, 1.0, size=(64, n, c)).astype(np.float32), device=dev)
            for path, (op, table, density) in paths.items():
                pack = table(vp, c)
                runs = {False: lambda: op(coords, w, radii, mask=mask),
                        True: lambda: batch._packed_batch(op, coords, w, radii, mask, pack)}
                grids, ms = {}, {False: [], True: []}
                for packed in (False, True, True, False):
                    grids[packed] = runs[packed]()
                    ms[packed].append(time_graph_ms(runs[packed]))
                err = float((grids[True] - grids[False]).abs().max())
                route = batch_route(density, coords, w, radii, mask, grids[False])
                line = {"phase": "packing", "path": path, "case": f"64mol_vp{vp}_c{c}_dim64_f32", "pack": pack,
                        "packed_ms": statistics.mean(ms[True]), "unpacked_ms": statistics.mean(ms[False]),
                        "packed_over_unpacked": statistics.mean(ms[True]) / statistics.mean(ms[False]),
                        "max_abs_err": err, "tol": 1e-5, "route": route, "ok": err <= 1e-5 and route != "other"}
                emit(line)
                lines.append(line)
                del grids
    for path in paths:
        mine = [ln for ln in lines if ln["path"] == path]
        emit({"phase": "packing_route", "path": path, "routes": sorted({ln["route"] for ln in mine}),
              "shapes_where_packing_is_faster": sum(ln["packed_ms"] < ln["unpacked_ms"] for ln in mine),
              "shapes": len(mine)})
    if not all(ln["ok"] for ln in lines):
        raise SystemExit("packing failed: packed and unpacked grids differ, or voxelize_batch took another route")


def separable_work(b: int, vp: int, c: int, dl: int, dim: int, out_dtype="float32") -> tuple[int, int, int]:
    """(bmm FLOPs, other FLOPs, bytes) of ``voxelize_separable_batch`` as
    written, from shapes alone: the bmm is 2 B (C Dl) Vp HW; the three axis
    factors take 4 operations an entry (the exp counted as one), and the
    eyz and U products one; bytes are each f32 temporary (factors, eyz, U
    and, in the bf16 and fp8 lanes, their bf16 copies) written once and read
    once, plus the grid written once."""
    import torch

    from molvoxel_torch.ops.deposit import out_torch_dtype

    odt = out_torch_dtype(out_dtype)
    hw = dim * dim
    bmm = 2 * b * c * dl * vp * hw
    other = 4 * b * vp * (dl + 2 * dim) + b * vp * hw + b * vp * c * dl
    temps = b * vp * (dl + 2 * dim + hw + c * dl) * 4
    if odt != torch.float32:
        temps += b * vp * (hw + c * dl) * 2
    return bmm, other, 2 * temps + b * c * dl * hw * odt.itemsize


# gaussian_notrunc: the shapes at which notrunc_routing times the kernel
# route against the separable product.
NOTRUNC_CASES = (
    # name, molecule, batch, dim, res, depth slab (d_offset, planes) or None, out dtype
    ("lig61_b64_dim64_c4_f32", "lig", 64, 64, 0.5, None, "float32"),
    ("lig61_b64_dim64_c4_bf16", "lig", 64, 64, 0.5, None, "bfloat16"),
    ("lig61_b1_dim48_c4_f32", "lig", 1, 48, 0.5, None, "float32"),
    ("lig61_b1_dim128_c4_f32", "lig", 1, 128, 0.5, None, "float32"),
    ("lig61_b4_dim256_res025_slab128_64_c4_f32", "lig", 4, 256, 0.25, (128, 64), "float32"),
    ("complex468_b1_dim48_c8_f32", "complex", 1, 48, 0.5, None, "float32"),
    ("prot1024_b1_dim48_c1_f32", "prot1024", 1, 48, 0.5, None, "float32"),
    ("prot1024_b1_dim128_c1_f32", "prot1024", 1, 128, 0.5, None, "float32"),
    ("prot3262_b1_dim48_c1_f32", "prot", 1, 48, 0.5, None, "float32"),
    ("prot3262_b1_dim128_c1_f32", "prot", 1, 128, 0.5, None, "float32"),
    ("prot3262_b1_dim256_c1_f32", "prot", 1, 256, 0.5, None, "float32"),
    ("prot3262_b1_dim128_c1_bf16", "prot", 1, 128, 0.5, None, "bfloat16"),
)
NOTRUNC_TRAIN_CASES = (
    # name, molecule, batch, dim, entry point
    ("train_layer_lig61_b64_dim64_c4_f32", "lig", 64, 64, "VoxelizeLayer"),
    ("train_voxelize_prot3262_dim48_c1_f32", "prot", 1, 48, "voxelize"),
)


def notrunc_molecules(prot_atoms=(1024,)):
    """name -> (coords (V, 3) about the golden center, weights (V, C)), numpy
    float32: "lig", the 61-atom ligand of lig_types_gaussian with its four
    types one-hot; "complex", the 61 ligand and 407 pocket atoms of
    pocket_types_gaussian with their eight types one-hot; "prot", the
    3262-atom protein of protein_single_gaussian (C = 1); and "protN", its
    first N atoms for each N of ``prot_atoms``."""
    import numpy as np

    mols = {}
    for name, stem in (("lig", "lig_types_gaussian"), ("complex", "pocket_types_gaussian")):
        g = load_golden(stem)
        types = g["channels"].astype(np.int64)
        mols[name] = ((g["coords"] - g["center"]).astype(np.float32),
                      np.eye(int(types.max()) + 1, dtype=np.float32)[types])
    g = load_golden("protein_single_gaussian")
    xyz = (g["coords"] - g["center"]).astype(np.float32)
    mols["prot"] = (xyz, np.ones((len(xyz), 1), np.float32))
    for n in prot_atoms:
        mols[f"prot{n}"] = (xyz[:n], np.ones((n, 1), np.float32))
    return mols


def notrunc_inputs(mol, b: int, dev):
    """A batch as the entry points hand it to the deposit: the atoms padded
    to ``small_atom_bucket`` with zero coordinates and a mask; for b > 1
    each molecule gets its own random rotation and 0.5 A translation (from
    a generator seeded with b).  Returns (coords, weights, mask) on ``dev``."""
    import torch

    from molvoxel_torch.core.config import small_atom_bucket
    from molvoxel_torch.ops.batch import random_transform_batch

    xyz, w = mol
    v = len(xyz)
    vp = small_atom_bucket(v)
    coords = torch.zeros((b, vp, 3), device=dev)
    coords[:, :v] = torch.as_tensor(xyz, device=dev)
    if b > 1:
        coords = random_transform_batch(torch.Generator().manual_seed(b), coords, 0.5, True)
    weights = torch.zeros((b, vp, w.shape[1]), device=dev)
    weights[:, :v] = torch.as_tensor(w, device=dev)
    mask = torch.zeros((b, vp), dtype=torch.bool, device=dev)
    mask[:, :v] = True
    return coords.contiguous(), weights, mask


def notrunc_case(name, mol, b: int, dim: int, res: float, slab, out_dtype: str, dev) -> dict:
    """One notrunc_routing line: the kernel route (``voxelize_deposit_batch``
    with the threshold row: padding, Morton sort, plane ranges and the
    launch) and the separable route (``voxelize_separable_batch``) on the
    same inputs, each timed end to end by CUDA-graph replay (the lower of
    two medians of 7, taken in turns: kernel, separable, separable, kernel),
    and the kernel launch alone on the route's own prepared inputs (and its
    plain version, ``deposit_plain``, on the same inputs); the two grids held
    against each other (f32 2e-5, bf16 2^-7 max); the kernel's bound,
    the pairs inside the threshold sphere, the separable product's FLOPs and
    bytes (``separable_work``) and its bound (the bmm at the f32 rate, or
    the bf16 tensor-core rate in the bf16 lane); which route is faster and
    which one the port takes (``notrunc_use_kernel``)."""
    import torch

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import deposit, separable
    from molvoxel_torch.ops.batch import pick_slab_depth
    from molvoxel_torch.ops.voxelize import notrunc_use_kernel

    spec = GridSpec(res, dim)
    odt = getattr(torch, out_dtype)
    coords, w, mask = notrunc_inputs(mol, b, dev)
    _, vp, c = w.shape
    d0, d_count = (0, None) if slab is None else slab
    dl = dim if d_count is None else d_count
    radii = torch.ones(vp, device=dev)
    kw = dict(spec=spec, sigma=0.5, mask=mask, d_offset=d0, d_count=d_count, out_dtype=odt)
    routes = {"kernel": lambda: deposit.voxelize_deposit_batch(coords, w, radii, density_type="gaussian_notrunc",
                                                               **kw),
              "separable": lambda: separable.voxelize_separable_batch(coords, w, radii, **kw)}
    deposit.reset_launches()
    got = routes["kernel"]()
    torch.cuda.synchronize()
    launches = deposit.launches["deposit_fwd"]
    ref = routes["separable"]().float()
    err = float((got.float() - ref).abs().max())
    tol = 2e-5 if odt == torch.float32 else 2**-7 * max(float(ref.abs().max()), 1.0)
    finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(ref).all())
    del got, ref
    ms = {route: [] for route in routes}
    for route in ("kernel", "separable", "separable", "kernel"):
        ms[route].append(time_graph_ms(routes[route]))
    ms = {route: min(t) for route, t in ms.items()}
    rows, wt, ranges, kdl, gaussian = deposit.prepare_batch(coords, w, radii, spec=spec,
                                                            density_type="gaussian_notrunc", sigma=0.5, mask=mask,
                                                            d_offset=d0, d_count=d_count)
    launch_ms = time_graph_ms(lambda: deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=kdl, gaussian=gaussian,
                                                          out_dtype=odt))
    plain_ms = time_ms(lambda: deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=kdl, gaussian=gaussian,
                                                     out_dtype=odt), reps=3, inner=1)
    out = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=kdl, gaussian=gaussian, out_dtype=odt)
    b_ms, b_by = bound(rows, wt, ranges, out, spec, kdl, gaussian)
    pairs = cutoff_pairs(rows, wt.abs().amax(dim=1) > 0, spec, kdl)[0]
    del out, rows, wt, ranges
    bmm, other_ops, n_bytes = separable_work(b, vp, c, dl, dim, odt)
    bmm_rate = FP32_OPS_PER_S if odt == torch.float32 else BF16_TC_OPS_PER_S
    sep_bound = max((bmm / bmm_rate + other_ops / FP32_OPS_PER_S) * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3)
    port = "kernel" if notrunc_use_kernel(vp, dim, d_count, channels=c, batch=b, out_dtype=out_dtype) else "separable"
    other = "separable" if port == "kernel" else "kernel"
    line = {"phase": "notrunc_routing", "case": name, "row": 2 if pick_slab_depth(spec) else 1, "batch": b,
            "atoms": int(mask[0].sum()), "padded_atoms": vp,
            "channels": c, "dim": dim, "planes": dl, "res": res, "out_dtype": out_dtype,
            "kernel_route_ms": ms["kernel"], "kernel_launch_ms": launch_ms, "kernel_plain_ms": plain_ms,
            "separable_ms": ms["separable"],
            "kernel_bound_ms": b_ms, "kernel_bound_by": b_by, "threshold_pairs": pairs,
            "separable_flops": bmm + other_ops, "separable_bytes": n_bytes, "separable_bound_ms": sep_bound,
            "faster": min(ms, key=ms.get), "port_route": port, "port_over_other": ms[port] / ms[other],
            "launches": launches, "max_abs_diff": err, "tol": tol}
    line["ok"] = bool(finite and err <= tol and launches == 1 and ms[port] <= 1.1 * ms[other])
    torch.cuda.empty_cache()
    return line


def notrunc_train_case(name, mol, b: int, dim: int, entry: str, dev) -> dict:
    """One notrunc_routing training line: one forward and one backward
    (``torch.autograd.grad`` at a fixed random cotangent) through each
    route, timed as ``notrunc_case`` times the forward, gradients held
    against each other at 5e-3 x max(1, gradient scale); the backward launch
    alone and its plain version on the kernel route's prepared inputs; then
    the entry point (``VoxelizeLayer`` on the batch, or
    ``ops.voxelize.voxelize`` on one molecule, both with gradients on) once,
    which must take the route ``notrunc_use_kernel`` names and give that
    route's gradients.  The layer's radii are its own constant 1.0;
    ``voxelize`` also differentiates the per-atom radii."""
    import torch

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.nn import VoxelizeLayer
    from molvoxel_torch.ops import deposit, separable
    from molvoxel_torch.ops.voxelize import notrunc_use_kernel, voxelize

    spec = GridSpec(0.5, dim)
    coords, w, mask = notrunc_inputs(mol, b, dev)
    _, vp, c = w.shape
    ct = torch.randn((b, c, dim, dim, dim), generator=torch.Generator(device=dev).manual_seed(b), device=dev)
    if entry == "VoxelizeLayer":
        radii = torch.ones(vp, device=dev)
        leaves = [coords.clone().requires_grad_(), w.clone().requires_grad_()]
        kw = dict(spec=spec, sigma=0.5, mask=mask)
        fns = {"kernel": lambda x, ww: deposit.voxelize_deposit_batch(x, ww, radii, density_type="gaussian_notrunc",
                                                                      **kw),
               "separable": lambda x, ww: separable.voxelize_separable_batch(x, ww, radii, **kw)}
        layer = VoxelizeLayer(spec, density_type="gaussian_notrunc")

        def entry_fn(x, ww):
            return layer(x, ww, mask)
    else:
        leaves = [coords[0].clone().requires_grad_(), w[0].clone().requires_grad_(),
                  torch.ones(vp, device=dev, requires_grad=True)]
        ct = ct[0]
        kw = dict(spec=spec, sigma=0.5, mask=mask[0])
        fns = {"kernel": lambda x, ww, r: deposit.voxelize_deposit(x, ww, r, density_type="gaussian_notrunc", **kw),
               "separable": lambda x, ww, r: separable.voxelize_separable(x, ww, r, **kw)}

        def entry_fn(x, ww, r):
            return voxelize(x, ww, r, density_type="gaussian_notrunc", **kw)

    def step(fn):
        return torch.autograd.grad(fn(*leaves), leaves, grad_outputs=ct)

    grads = {route: step(fn) for route, fn in fns.items()}
    err, scale = grad_err(grads["kernel"], grads["separable"])
    ms = {route: [] for route in fns}
    for route in ("kernel", "separable", "separable", "kernel"):
        ms[route].append(time_graph_ms(lambda: step(fns[route])))
    ms = {route: min(t) for route, t in ms.items()}
    port = "kernel" if notrunc_use_kernel(vp, dim, None, channels=c, batch=b, grad=True) else "separable"
    # the backward launch alone on the kernel route's prepared inputs, and its bound
    rows, wt, _, kdl, gaussian = deposit.prepare_batch(coords, w, torch.ones(vp, device=dev), spec=spec,
                                                       density_type="gaussian_notrunc", sigma=0.5, mask=mask)
    ct_k = ct.reshape(b, c, dim, dim * dim)
    bwd_ms = time_graph_ms(lambda: deposit.deposit_bwd(rows, wt, ct_k, spec=spec, dl=kdl, gaussian=gaussian))
    bwd_plain_ms = time_ms(lambda: deposit.deposit_bwd_plain(rows, wt, ct_k, spec=spec, dl=kdl, gaussian=gaussian),
                           reps=3, inner=1)
    bwd_bound, bwd_by = bound_bwd(rows, wt, ct_k, wt.abs().amax(dim=1) > 0, spec, kdl, gaussian)
    del rows, wt
    other = "separable" if port == "kernel" else "kernel"
    deposit.reset_launches()
    got = step(entry_fn)
    torch.cuda.synchronize()
    launches = dict(deposit.launches)
    taken = "kernel" if launches["deposit_fwd"] == 1 and launches["deposit_bwd"] == 1 else (
        "separable" if launches == {"deposit_fwd": 0, "deposit_bwd": 0} else "other")
    entry_err = grad_err(got, grads[port])[0]
    line = {"phase": "notrunc_routing", "case": name, "entry": entry, "batch": b, "atoms": int(mask[0].sum()),
            "padded_atoms": vp, "channels": c, "dim": dim, "out_dtype": "float32",
            "kernel_fwd_bwd_ms": ms["kernel"], "separable_fwd_bwd_ms": ms["separable"],
            "kernel_bwd_launch_ms": bwd_ms, "kernel_bwd_plain_ms": bwd_plain_ms, "kernel_bwd_bound_ms": bwd_bound,
            "kernel_bwd_bound_by": bwd_by,
            "faster": min(ms, key=ms.get), "port_route": port, "port_over_other": ms[port] / ms[other],
            "entry_route": taken, "entry_launches": launches, "grad_scale": scale, "max_abs_diff": err,
            "tol": 5e-3 * scale, "entry_vs_route_err": entry_err}
    line["ok"] = bool(err <= 5e-3 * scale and taken == port and entry_err <= 5e-3 * scale
                      and ms[port] <= 1.1 * ms[other] and all(torch.isfinite(g).all() for g in got))
    torch.cuda.empty_cache()
    return line


def phase_notrunc_routing(dev) -> dict:
    """notrunc_routing: every case of NOTRUNC_CASES and NOTRUNC_TRAIN_CASES;
    fails the run if the routes disagree or the port's route is more than
    10% slower than the other one anywhere.  Returns the kernels-line fields:
    by table row, the launches of the phase's driven calls (each route run
    once before it is timed) and one timed case."""
    from molvoxel_torch.ops import deposit

    t_start = time.perf_counter()
    mols = notrunc_molecules()
    lines = {}
    for name, mol, b, dim, res, slab, odt in NOTRUNC_CASES:
        lines[name] = notrunc_case(name, mols[mol], b, dim, res, slab, odt, dev)
        emit(lines[name])
    launches = {row: sum(ln["launches"] for ln in lines.values() if ln["row"] == row) for row in (1, 2)}
    launches[4] = 0
    for name, mol, b, dim, entry in NOTRUNC_TRAIN_CASES:
        lines[name] = notrunc_train_case(name, mols[mol], b, dim, entry, dev)
        emit(lines[name])
        launches[1] += lines[name]["entry_launches"]["deposit_fwd"]
        launches[4] += lines[name]["entry_launches"]["deposit_bwd"]
    deposit.reset_launches()
    emit({"phase": "notrunc_routing_seconds", "total_s": time.perf_counter() - t_start})
    failed = [name for name, ln in lines.items() if not ln["ok"]]
    if failed:
        raise SystemExit(f"notrunc_routing failed: {failed}")

    def entry(row, case, prefix, route_key, lib_key):
        ln = lines[case]
        return {"timed_case": case, "launches": launches[row], "kernel_ms": ln[f"kernel_{prefix}launch_ms"],
                "plain_ms": ln[f"kernel_{prefix}plain_ms"], "route_ms": ln[route_key], "library_ms": ln[lib_key],
                "bound_ms": ln[f"kernel_{prefix}bound_ms"], "bound_by": ln[f"kernel_{prefix}bound_by"],
                "port_route": ln["port_route"]}

    return {1: entry(1, "lig61_b64_dim64_c4_bf16", "", "kernel_route_ms", "separable_ms"),
            2: entry(2, "lig61_b4_dim256_res025_slab128_64_c4_f32", "", "kernel_route_ms", "separable_ms"),
            4: entry(4, "train_layer_lig61_b64_dim64_c4_f32", "bwd_", "kernel_fwd_bwd_ms", "separable_fwd_bwd_ms")}


def phase_library(tmp: Path, dev):
    """library_store and library_stream: the CLI on a synthesized library
    of LIBRARY_RECORDS records.  Returns the kernels-line fields."""
    import contextlib
    import io

    import numpy as np
    import torch

    from molvoxel_torch import cli
    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.data.feed import SDFBatchFeeder, map_symbols, wire_scale
    from molvoxel_torch.data.gridstore import GridShardReader
    from molvoxel_torch.data.pipeline import PaddedBatch
    from molvoxel_torch.native import parse_sdf_file
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.ops.dense import voxelize_dense
    from molvoxel_torch.parallel.stream import StreamingVoxelizer, _scan_chunks, stream_checksum

    t_start = time.perf_counter()
    lib = write_library(tmp / "lib.sdf", LIBRARY_RECORDS)
    emit({"phase": "library", "records": LIBRARY_RECORDS, "bytes": lib.stat().st_size,
          "write_s": time.perf_counter() - t_start})

    # library_store: the first 512 records into a bf16 grid store at 48^3, with .dx volumes
    t0 = time.perf_counter()
    lib512 = first_records(lib, 512, tmp / "lib512.sdf")
    store, dx = tmp / "store", tmp / "dx"
    deposit.reset_launches()
    rc = cli.main(["voxelize", str(lib512), "-o", str(store), "--dimension", "48", "--out-dtype", "bfloat16",
                   "--dx", str(dx)])
    launches = deposit.launches["deposit_fwd"]
    reader = GridShardReader(store)
    num_atoms = reader.num_atoms()
    mols = [m.without_hydrogens() for m in parse_sdf_file(lib512)]
    spec48 = GridSpec(0.5, 48)
    sample = sorted({7, 300, *np.random.default_rng(1).choice(512, 14, replace=False).tolist()})
    worst = 0.0
    for i in sample:
        m = mols[i]
        got = reader[i]
        if m.num_atoms == 0:
            ok_i = num_atoms[i] == 0 and bool((got.float() == 0).all())
            worst = max(worst, 0.0 if ok_i else float("inf"))
            continue
        crd = m.coords.astype(np.float32)
        center = crd.astype(np.float64).mean(0).astype(np.float32)  # the feeder's center
        types = map_symbols(np.array([s.encode() for s in m.symbols], dtype="|S4"),
                            {s: k for k, s in enumerate(SYMBOLS)})
        onehot = torch.eye(4, device=dev)[torch.as_tensor(types, device=dev).long()]
        ref = voxelize_dense(torch.as_tensor(crd - center, device=dev), onehot, torch.ones(len(types), device=dev),
                             spec=spec48)
        err = float((got.float().to(dev) - ref.to(torch.bfloat16).float()).abs().max())
        worst = max(worst, err / (2**-7 * max(float(ref.abs().max()), 1.0)))
    dx_files = sorted(p.name for p in dx.glob("*.dx"))
    ok = (rc == 0 and len(reader) == 512 and len(num_atoms) == 512 and num_atoms[7] == 0 and num_atoms[300] == 0
          and reader.manifest["dtype"] == "bfloat16" and worst <= 1.0 and len(dx_files) == 4 and launches > 0)
    emit({"phase": "library_store", "records": len(reader), "shards": len(reader.manifest["shards"]),
          "zero_atom_slots": int((num_atoms == 0).sum()), "launches": launches, "sampled": len(sample),
          "worst_err_over_bar": worst, "bar": "2^-7*max(1, max |ref|)", "dx_files": dx_files,
          "seconds": time.perf_counter() - t0, "ok": bool(ok)})
    if not ok:
        raise SystemExit("library_store failed")

    # library_stream: the production stream through the CLI, plain, --wire and --presort
    t0 = time.perf_counter()
    stream_lines = {}
    base = ["voxelize", str(lib), "--throughput", "--trials", "3", "--random-rotation", "--random-translation", "0.5",
            "--out-dtype", "bfloat16", "--dimension", "64"]
    for label, flags in (("plain", []), ("wire", ["--wire"]), ("presort", ["--presort"])):
        deposit.reset_launches()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(base + flags)
        launches = deposit.launches["deposit_fwd"]
        payload = json.loads(text.getvalue().strip().splitlines()[-1])
        passes = 1 + 3  # the warm-up pass and three trials
        per_sb = launches / (payload["superbatches"] * passes)
        ok = (rc == 0 and per_sb == 4 and payload["molecules"] == LIBRARY_RECORDS - 2 and payload["native_shards"] > 0)
        line = {"phase": "library_stream", "case": label, "mols_per_s_median": payload["median_mols_per_s"],
                "mols_per_s_min": payload["min_mols_per_s"], "mols_per_s_max": payload["max_mols_per_s"],
                "trials": payload["trials"], "molecules": payload["molecules"],
                "superbatches": payload["superbatches"], "launches": launches,
                "launches_per_superbatch": per_sb, "native_shards": payload["native_shards"], "ok": bool(ok)}
        if label == "presort":  # the feeder and the deposit sort only records above 128 atoms
            line.update(same_work_as_plain=True, why="presort acts above 128 atoms a record; these have 20-61")
        emit(line)
        stream_lines[label] = line
        if not ok:
            raise SystemExit(f"library_stream {label} failed")
    spec64 = GridSpec(0.5, 64)
    # the device's busy share of one plain pass (torch.profiler, device-kernel rows)
    from torch.profiler import ProfilerActivity, profile

    feeder = SDFBatchFeeder(lib, SYMBOLS, batch_size=4096, compact=True, workers=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        stats, _ = stream_checksum(iter(feeder), spec64, chunk=1024, random_rotation=True, random_translation=0.5,
                                   out_dtype="bfloat16", witness=True, prefetch_depth=4, seed=9)
        pass_s = time.perf_counter() - tp
    by_name = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy_s = sum(us for us, _ in by_name) / 1e6
    emit({"phase": "library_stream_profile", "case": "plain", "pass_s_profiled": pass_s, "device_busy_s": busy_s,
          "device_busy_share": busy_s / pass_s, "molecules": stats.molecules,
          "top": [{"name": name[:90], "ms": us / 1e3} for us, name in by_name[:8]]})
    # the feeder alone: parse and assemble, no device
    for label, make in (("compact", lambda f: iter(f)), ("wire", lambda f: f.iter_wire(spec64))):
        f = SDFBatchFeeder(lib, SYMBOLS, batch_size=4096, compact=True, workers=2)
        tf = time.perf_counter()
        for _ in make(f):
            pass
        feed_s = time.perf_counter() - tf
        emit({"phase": "library_feeder_alone", "case": label, "molecules": f.molecules_fed, "seconds": feed_s,
              "mols_per_s": f.molecules_fed / feed_s, "native_shards": f.native_shards})

    # checksums on the first 4096 records, no augmentation, f32, full read
    lib4096 = first_records(lib, 4096, tmp / "lib4096.sdf")
    batches = list(SDFBatchFeeder(lib4096, SYMBOLS, batch_size=4096, compact=True))
    _, cs = stream_checksum(iter(batches), spec64, chunk=1024, out_dtype="float32")
    want = torch.zeros((), dtype=torch.float64, device=dev)
    sv = StreamingVoxelizer(spec64, batch_size=1024, out_dtype="float32")
    sv.run_batches(SDFBatchFeeder(lib4096, SYMBOLS, batch_size=1024),
                   lambda im, b: want.add_(im.sum(dtype=torch.float64)))
    want = float(want)
    wires = list(SDFBatchFeeder(lib4096, SYMBOLS, batch_size=4096).iter_wire(spec64))
    _, cs_wire = stream_checksum(iter(wires), spec64, chunk=1024, out_dtype="float32", wire=True)
    scale = wire_scale(spec64)
    want_wire = torch.zeros((), dtype=torch.float64, device=dev)

    def dequantized():
        for wire, num_atoms, _ in wires:
            types = wire[..., 3]
            onehot = (types[..., None] == np.arange(4)).astype(np.float32)
            for s in range(0, wire.shape[0], 1024):
                sl = slice(s, s + 1024)
                yield PaddedBatch(wire[sl, :, :3].astype(np.float32) / scale, onehot[sl], types[sl] >= 0, None, None,
                                  num_atoms[sl])

    sv.run_batches(dequantized(), lambda im, b: want_wire.add_(im.sum(dtype=torch.float64)))
    want_wire = float(want_wire)
    rel = abs(cs - want) / abs(want)
    rel_wire = abs(cs_wire - want_wire) / abs(want_wire)
    rel_quant = abs(cs_wire - want) / abs(want)
    # no host sync in the chunk loop: one superbatch under sync-debug "error"
    b0 = batches[0]
    crd, typ, cen = (torch.as_tensor(a).to(dev) for a in (b0.coords, b0.types, b0.centers))
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _scan_chunks(crd, typ, cen, gen, acc, chunk=1024, num_channels=4, radii=torch.ones(64, device=dev), rtab=None,
                     random_translation=0.5, spec=spec64, density_type="gaussian", sigma=0.5, random_rotation=True,
                     out_dtype="bfloat16", impl="auto", presorted=False, witness=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ok = rel <= 1e-5 and rel_wire <= 1e-5 and rel_quant <= 2e-3 and float(acc) > 0
    emit({"phase": "library_stream_checksum", "records": 4096, "stream_checksum": cs, "run_batches_sum": want,
          "rel_err": rel, "tol": 1e-5, "wire_checksum": cs_wire, "run_batches_sum_dequantized": want_wire,
          "wire_rel_err_vs_dequantized": rel_wire, "wire_rel_err_vs_f32": rel_quant, "wire_tol_vs_f32": 2e-3,
          "chunk_loop_host_syncs": 0, "seconds_after_stream": time.perf_counter() - t0, "ok": bool(ok)})
    if not ok:
        raise SystemExit("library_stream checksums disagree")
    emit({"phase": "library_seconds", "total_s": time.perf_counter() - t_start})
    return stream_lines


def golden_complex():
    """(ligand, pocket, center, expected) of tests/goldens/pocket_types_gaussian.npz:
    its first 61 atoms are the golden ligand (types 0-3) and the other 407 the
    pocket (types 4-7), as SimpleMolecules of C, N, O and S."""
    import numpy as np

    from molvoxel_torch.data import SimpleMolecule

    g = load_golden("pocket_types_gaussian")
    sym = np.asarray(SYMBOLS)
    t = g["channels"].astype(np.int64)
    lig = SimpleMolecule(g["coords"][:61].astype(np.float64), list(sym[t[:61]]), [], "ligand")
    pocket = SimpleMolecule(g["coords"][61:].astype(np.float64), list(sym[t[61:] - 4]), [], "pocket")
    return lig, pocket, g["center"], g["expected"]


def phase_wrappers(tmp: Path):
    """wrappers: ComplexWrapper over the golden ligand and pocket at 48^3,
    res 0.5, on the card, against the same wrapper on the dense path at
    1e-5, with and without a seeded random rotation and 0.5 A translation
    (and against the golden, unrotated); then ``visualize`` writes the
    fallback without PyMOL and its .dx volumes read back.  Returns the
    forward launches."""
    import numpy as np
    import torch

    from molvoxel_torch import create_voxelizer
    from molvoxel_torch.data import AtomTypeGetter, ComplexPointCloudMaker, ComplexWrapper
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.viz import Visualizer, read_dx

    t0 = time.perf_counter()
    lig, pocket, center, expected = golden_complex()
    ag = AtomTypeGetter(SYMBOLS)
    maker = ComplexPointCloudMaker(ag, None, ag, None, channel_type="types")
    wrapper = ComplexWrapper(maker, create_voxelizer(resolution=0.5, dimension=48, device=DEVICE), Visualizer())
    dense = ComplexWrapper(maker, create_voxelizer(resolution=0.5, dimension=48, device=DEVICE, impl="dense"))
    grids, errs = {}, {}
    deposit.reset_launches()
    for rotate in (False, True):
        kw = dict(center=center, radii=1.0, random_translation=0.5 if rotate else 0.0, random_rotation=rotate, key=7)
        grids[rotate] = wrapper.run(lig, pocket, **kw)
    torch.cuda.synchronize()
    launches = deposit.launches["deposit_fwd"]
    for rotate in (False, True):
        kw = dict(center=center, radii=1.0, random_translation=0.5 if rotate else 0.0, random_rotation=rotate, key=7)
        errs[rotate] = float((grids[rotate] - dense.run(lig, pocket, **kw)).abs().max())
    golden_err = float(np.abs(grids[False].cpu().numpy() - expected).max())
    image = grids[False]
    result = wrapper.visualize(str(tmp / "wrappers" / "complex.pse"), lig, pocket, image, center)
    dx_errs = {}
    host = image.cpu().numpy()
    for f in sorted(result.parent.glob("*.dx")):
        group, cname = f.stem.split("_", 1)
        channel = SYMBOLS.index(cname) + (4 if group == "Protein" else 0)
        values, _, res = read_dx(f)
        dx_errs[f.stem] = float(np.abs(values - host[channel]).max()) if values.shape == host[channel].shape else 1.0
    ok = (launches == 2 and max(errs.values()) <= 1e-5 and golden_err <= 1e-5 and result.suffix == ".pml"
          and len(dx_errs) == 8 and max(dx_errs.values()) <= 1e-5 and not torch.equal(grids[False], grids[True]))
    emit({"phase": "wrappers", "case": "complex_lig61_pocket407_dim48_c8", "launches": launches,
          "max_abs_err_vs_dense": errs[False], "max_abs_err_vs_dense_rot_trans05": errs[True],
          "max_abs_err_vs_golden": golden_err, "tol": 1e-5, "visualize": result.name,
          "dx_files": len(dx_errs), "dx_max_abs_err": max(dx_errs.values(), default=None),
          "seconds": time.perf_counter() - t0, "ok": bool(ok)})
    if not ok:
        raise SystemExit("wrappers failed")
    return launches


def phase_interop(lib: Path, store: Path, dev):
    """interop_dataset: VoxelGridDataset over the whole library in the
    production stream configuration (64^3 x 4, bf16, batch 64, random
    rotation and 0.5 A translation) through DataLoader(batch_size=None,
    num_workers=0) on the card: mols/s of one warm pass and two timed; its
    first 8 batches without augmentation against voxelize_batch on the same
    PaddedBatch at 2^-7 x max; 20 training steps of VoxelCNN(4, 64, (16, 32,
    64)) + Linear(64, 1) + Adam fed by it; and GridStoreDataset over the
    library_store store through a shuffling DataLoader with two workers: 64
    sampled items equal GridShardReader's bit for bit.  Returns the forward
    launches."""
    import hashlib

    import torch
    from torch.utils.data import DataLoader

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.data.feed import SDFBatchFeeder
    from molvoxel_torch.data.gridstore import GridShardReader
    from molvoxel_torch.interop import GridStoreDataset, VoxelGridDataset
    from molvoxel_torch.nn import VoxelCNN
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.ops.batch import voxelize_batch

    spec64 = GridSpec(0.5, 64)
    ds = VoxelGridDataset(lib, SYMBOLS, spec64, batch_size=64, out_dtype="bfloat16", augment=True,
                          random_translation=0.5, seed=0, device=DEVICE)
    loader = DataLoader(ds, batch_size=None, num_workers=0)

    def one_pass():
        molecules = 0
        t0 = time.perf_counter()
        for grids, counts in loader:
            molecules += int((counts > 0).sum())
        torch.cuda.synchronize()
        return molecules, time.perf_counter() - t0

    deposit.reset_launches()
    passes = [one_pass() for _ in range(3)]  # one warm pass, two timed
    launches = deposit.launches["deposit_fwd"]
    timed = [s for _, s in passes[1:]]
    molecules = passes[0][0]
    batches_per_pass = -(-LIBRARY_RECORDS // 64)
    rate = molecules / statistics.median(timed)
    ok = all(m == LIBRARY_RECORDS - 2 for m, _ in passes) and launches == 3 * batches_per_pass
    emit({"phase": "interop_dataset", "case": "voxel_grid_dataset_50k_dim64_c4_bf16_rot_trans05_batch64",
          "molecules": molecules, "passes": len(passes), "launches": launches,
          "launches_per_pass": launches / len(passes), "pass_s": [s for _, s in passes],
          "mols_per_s_median": rate, "mols_per_s_min": molecules / max(timed),
          "mols_per_s_max": molecules / min(timed), "ok": bool(ok)})
    if not ok:
        raise SystemExit("interop_dataset failed: molecule count or launches")

    # the first 8 batches without augmentation against voxelize_batch on the feeder's batches
    deposit.reset_launches()
    plain = VoxelGridDataset(lib, SYMBOLS, spec64, batch_size=64, out_dtype="bfloat16", device=DEVICE)
    worst = 0.0
    for k, ((grids, _), batch) in enumerate(zip(plain, SDFBatchFeeder(lib, SYMBOLS, batch_size=64))):
        if k == 8:
            break
        ref = voxelize_batch(*(torch.as_tensor(a, device=dev) for a in (batch.coords, batch.weights)),
                             torch.ones(batch.padded_atoms, device=dev),
                             *(torch.as_tensor(a, device=dev) for a in (batch.mask, batch.centers)), None, 0.0,
                             spec=spec64)
        worst = max(worst, float((grids.float() - ref).abs().max()) / (2**-7 * max(float(ref.abs().max()), 1.0)))
    launches += deposit.launches["deposit_fwd"]

    # streamed into training: 20 steps fed by the augmented dataset
    torch.manual_seed(0)
    cnn = VoxelCNN(in_channels=4, features=64, widths=(16, 32, 64)).to(dev)
    head = torch.nn.Linear(64, 1).to(dev)
    opt = torch.optim.Adam([*cnn.parameters(), *head.parameters()], lr=1e-3)
    feed = iter(DataLoader(ds, batch_size=None, num_workers=0))
    losses, step_ms = [], []
    deposit.reset_launches()
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids, counts = next(feed)
        label = counts.to(dev, non_blocking=True).float() / 61.0  # the atom fraction, a label the grid carries
        loss = torch.nn.functional.mse_loss(head(cnn(grids.float()))[:, 0], label)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_launches = deposit.launches["deposit_fwd"]
    launches += train_launches
    del feed
    ok = worst <= 1.0 and all(torch.isfinite(torch.tensor(losses))) and train_launches >= 20
    emit({"phase": "interop_dataset_train", "case": "voxelcnn16_32_64_dim64_c4_fed_by_dataset", "steps": 20,
          "first_loss": losses[0], "last_loss": losses[-1], "step_ms_median_after_2": statistics.median(step_ms[2:]),
          "step_ms_min": min(step_ms[2:]), "step_ms_max": max(step_ms[2:]), "launches": train_launches,
          "plain_8_batches_worst_err_over_bar": worst, "bar": "2^-7*max(1, max |ref|)", "ok": bool(ok)})
    if not ok:
        raise SystemExit("interop_dataset failed: the plain batches disagree or the loss is not finite")

    # the precomputed store through a shuffling DataLoader with two spawned workers
    reader = GridShardReader(store)
    num_atoms = reader.num_atoms()

    def digest(grid):
        return hashlib.sha1(grid.contiguous().view(torch.int16).numpy().tobytes()).hexdigest()

    index = {digest(reader[i]): i for i in range(len(reader))}
    sampled, matched = 0, 0
    items = DataLoader(GridStoreDataset(store), batch_size=8, shuffle=True, num_workers=2,
                       multiprocessing_context="spawn", generator=torch.Generator().manual_seed(3))
    for grids, counts in items:
        for grid, n in zip(grids, counts):
            j = index.get(digest(grid))
            matched += j is not None and same_bits(grid, reader[j]) and int(n) == int(num_atoms[j])
            sampled += 1
        if sampled >= 64:
            break
    del items
    ok = sampled == 64 and matched == 64
    emit({"phase": "interop_store", "case": "grid_store_dataset_512_dim48_bf16_shuffle_2_workers",
          "sampled": sampled, "bitwise_equal_to_reader": matched, "ok": bool(ok)})
    if not ok:
        raise SystemExit("interop_store failed: sampled items differ from the store")
    return launches


def phase_parallel(lig_xyz, prot_xyz, lig_w, b_coords, b_w, b_mask, seed, lib4096: Path):
    """parallel (one rank, NCCL): voxelize_batch_dp on the headline batch
    against voxelize_batch under the same draws, bit for bit;
    voxelize_depth_sharded for the ligand at 256^3 (gaussian and binary) and
    the protein at 128^3 against one full-depth call under the same
    transform at 1e-5; voxelize_batch_2d's mass against its grids' sum at
    rtol 1e-5; StreamingVoxelizer(mesh=...) over the first 4,096 records
    against the meshless stream under the same seed, bit for bit.  Returns
    the forward launches by table row."""
    import torch
    import torch.distributed as dist

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.core.transform import do_random_transform
    from molvoxel_torch.data.feed import SDFBatchFeeder
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.ops.batch import voxelize_batch
    from molvoxel_torch.ops.voxelize import voxelize
    from molvoxel_torch.parallel import (
        StreamingVoxelizer,
        initialize_distributed,
        make_mesh,
        voxelize_batch_2d,
        voxelize_batch_dp,
        voxelize_depth_sharded,
    )

    t_start = time.perf_counter()
    dev = b_coords.device
    initialize_distributed(device=DEVICE)  # one rank, no launcher
    mesh = make_mesh(device=DEVICE)
    launches = {1: 0, 2: 0, 3: 0}
    lines = []
    try:
        spec64 = GridSpec(0.5, 64)
        ones = torch.ones(b_coords.shape[1], device=dev)
        deposit.reset_launches()
        dp = voxelize_batch_dp(b_coords, b_w, ones, b_mask, None, torch.Generator().manual_seed(seed), 0.5,
                               mesh=mesh, spec=spec64, random_rotation=True, out_dtype="bfloat16")
        full = dp.full_tensor()
        torch.cuda.synchronize()
        n = deposit.launches["deposit_fwd"]
        launches[1] += n
        ref = voxelize_batch(b_coords, b_w, ones, b_mask, None, torch.Generator().manual_seed(seed), 0.5,
                             spec=spec64, random_rotation=True, out_dtype="bfloat16")
        bitwise = same_bits(full, ref)
        lines.append({"case": "dp_headline_64lig_dim64_c4_bf16_rot_trans05", "launches": n,
                      "placements": [str(p) for p in dp.placements], "bitwise_equal_to_voxelize_batch": bitwise,
                      "ok": bitwise and n == 1})
        del dp, full, ref
        prot_w = torch.ones((prot_xyz.shape[0], 1), device=dev)
        for label, xyz, w, spec, density, row in (
            ("depth_lig_dim256_gaussian_f32_rot_trans05", lig_xyz, lig_w, GridSpec(0.25, 256), "gaussian", 2),
            ("depth_lig_dim256_binary_f32_rot_trans05", lig_xyz, lig_w, GridSpec(0.25, 256), "binary", 3),
            ("depth_prot3262_dim128_gaussian_f32_rot_trans05", prot_xyz, prot_w, GridSpec(0.5, 128), "gaussian", 1),
        ):
            radii = torch.ones(xyz.shape[0], device=dev)
            deposit.reset_launches()
            out = voxelize_depth_sharded(xyz, w, radii, None, None, torch.Generator().manual_seed(11), 0.5, mesh=mesh,
                                         spec=spec, density_type=density, random_rotation=True)
            full = out.full_tensor()
            torch.cuda.synchronize()
            n = deposit.launches["deposit_fwd"]
            launches[row] += n
            placed = do_random_transform(torch.Generator().manual_seed(11), xyz, None, 0.5, True)
            err = float((full - voxelize(placed, w, radii, spec=spec, density_type=density)).abs().max())
            lines.append({"case": label, "row": row, "launches": n, "placements": [str(p) for p in out.placements],
                          "max_abs_err_vs_full_depth": err, "tol": 1e-5, "ok": err <= 1e-5 and n >= 1})
            del out, full
        deposit.reset_launches()
        grids, mass = voxelize_batch_2d(b_coords, b_w, ones, b_mask, None, torch.Generator().manual_seed(seed), 0.5,
                                        mesh=mesh, spec=spec64, random_rotation=True)
        total = float(grids.full_tensor().double().sum())
        n = deposit.launches["deposit_fwd"]
        launches[1] += n
        rel = abs(float(mass.full_tensor()) - total) / abs(total)
        lines.append({"case": "2d_headline_64lig_dim64_c4_f32_rot_trans05", "launches": n, "mass": float(
            mass.full_tensor()), "grid_sum": total, "rel_err": rel, "tol": 1e-5, "ok": rel <= 1e-5 and n == 1})
        del grids, mass

        kept = []
        kw = dict(batch_size=64, out_dtype="bfloat16", random_rotation=True, random_translation=0.5, seed=21,
                  device=DEVICE)
        deposit.reset_launches()
        t0 = time.perf_counter()
        stats = StreamingVoxelizer(spec64, mesh=mesh, **kw).run_batches(
            SDFBatchFeeder(lib4096, SYMBOLS, batch_size=64), lambda im, b: kept.append(im.full_tensor()))
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        n = deposit.launches["deposit_fwd"]
        launches[1] += n
        equal = [0]

        def compare(im, b):
            equal[0] += same_bits(im, kept[0])
            kept.pop(0)

        StreamingVoxelizer(spec64, **kw).run_batches(SDFBatchFeeder(lib4096, SYMBOLS, batch_size=64), compare)
        lines.append({"case": "mesh_stream_4096_dim64_c4_bf16_rot_trans05", "launches": n, "batches": stats.batches,
                      "molecules": stats.molecules, "mesh_stream_s": mesh_s,
                      "batches_bitwise_equal_to_meshless": equal[0],
                      "ok": equal[0] == stats.batches == 64 and n == 64})
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    for line in lines:
        emit({"phase": "parallel", "world_size": 1, "backend": backend, **line})
    emit({"phase": "parallel_seconds", "total_s": time.perf_counter() - t_start})
    if not all(line["ok"] for line in lines):
        raise SystemExit("parallel failed")
    return launches


def multiprocess_rank(rank: int, world: int, init_file: str, lib: str, lib512: str, out: str):
    """One rank of the multiprocess phase (a spawned process): a warm-up
    stream of 512 records, the whole library with no store (timed), the 512
    records into ``out/store/proc-NNN`` at 48^3 bf16 with no augmentation,
    and its depth slab of the rotated ligand at 256^3 over a (1, 2) mesh
    (``out/slab<rank>.npy``).  Writes ``out/rank<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops import deposit
    from molvoxel_torch.parallel import (
        initialize_distributed,
        make_mesh,
        stream_dp_multiprocess,
        voxelize_depth_sharded,
    )

    initialize_distributed(backend="gloo", device=DEVICE, init_method=f"file://{init_file}", world_size=world,
                           rank=rank)
    try:
        mesh = make_mesh(device=DEVICE)
        spec64, spec48 = GridSpec(0.5, 64), GridSpec(0.5, 48)
        kw = dict(mesh=mesh, batch_size=64, out_dtype="bfloat16")
        aug = dict(random_rotation=True, random_translation=0.5)
        stream_dp_multiprocess(lib512, SYMBOLS, spec64, **kw, **aug)  # warm-up
        deposit.reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        stats = stream_dp_multiprocess(lib, SYMBOLS, spec64, **kw, **aug)
        wall = time.perf_counter() - t0
        lib_launches = deposit.launches["deposit_fwd"]
        deposit.reset_launches()
        store = stream_dp_multiprocess(lib512, SYMBOLS, spec48, store_root=Path(out) / "store", **kw)
        store_launches = deposit.launches["deposit_fwd"]
        # the ligand at 256^3 over a (1, 2) mesh, each rank's generator seeded apart: its slab
        lig = load_golden("lig_features_gaussian")
        xyz = torch.as_tensor(lig["coords"] - lig["center"], device=DEVICE)
        w = torch.as_tensor(lig["channels"][:, :4].astype(np.float32), device=DEVICE)
        deposit.reset_launches()
        slab = voxelize_depth_sharded(xyz, w, torch.ones(xyz.shape[0], device=DEVICE), None, None,
                                      torch.Generator().manual_seed(100 + rank), 0.5,
                                      mesh=make_mesh(1, 2, device=DEVICE), spec=GridSpec(0.25, 256),
                                      random_rotation=True)
        np.save(Path(out) / f"slab{rank}.npy", slab.to_local().cpu().numpy())
        result = {"rank": rank, "device": str(mesh.device_type), "backend": dist.get_backend(),
                  "molecules": stats.molecules, "batches": stats.batches, "wall_s": wall,
                  "mols_per_s": stats.molecules / wall, "launches": lib_launches,
                  "store_molecules": store.molecules, "store_launches": store_launches,
                  "depth_launches": deposit.launches["deposit_fwd"]}
        (Path(out) / f"rank{rank}.json").write_text(json.dumps(result))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_multiprocess(lib: Path, lib512: Path, tmp: Path, dev):
    """multiprocess: stream_dp_multiprocess on two spawned ranks over gloo,
    both on the one card: the whole library with no store (per-rank
    molecules summing to the library's, and mols/s), then the first 512
    records into per-rank stores at 48^3 bf16 whose rows, in rank order,
    equal a single-process stream's grids; each rank's depth slab of the
    rotated ligand, assembled, against one full-depth call.  Returns the
    forward launches by table row."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.core.transform import do_random_transform
    from molvoxel_torch.data.feed import SDFBatchFeeder
    from molvoxel_torch.data.gridstore import GridShardReader, read_grid_shards
    from molvoxel_torch.ops.voxelize import voxelize
    from molvoxel_torch.parallel import StreamingVoxelizer

    out = tmp / "multiprocess"
    out.mkdir()
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=multiprocess_rank, args=(r, 2, str(out / "pg"), str(lib), str(lib512), str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"multiprocess failed: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    molecules = sum(r["molecules"] for r in ranks)
    wall = max(r["wall_s"] for r in ranks)
    # a rank whose stripe has run dry launches all-padding steps until the other's is done
    ok = molecules == LIBRARY_RECORDS - 2 and all(r["launches"] >= r["batches"] > 0 for r in ranks)
    emit({"phase": "multiprocess", "case": "stream_dp_multiprocess_2_ranks_gloo_1_card_50k_dim64_c4_bf16_rot_trans05",
          "ranks": ranks, "molecules": molecules, "mols_per_s": molecules / wall, "wall_s": wall,
          "seconds_with_spawn": seconds, "ok": bool(ok)})
    if not ok:
        raise SystemExit("multiprocess failed: per-rank molecules do not sum to the library's")

    # the two stores in rank order against one single-process stream of the same records
    manifests, rows = [], []
    for r in range(2):
        grids, manifest = read_grid_shards(out / "store" / f"proc-{r:03d}")
        manifests.append(manifest)
        rows.append(grids)
    got = torch.cat(rows)
    want = []
    StreamingVoxelizer(GridSpec(0.5, 48), batch_size=64, bucket=128, out_dtype="bfloat16", device=DEVICE).run_batches(
        SDFBatchFeeder(lib512, SYMBOLS, batch_size=64, bucket=128), lambda im, b: want.append(im.cpu()))
    want = torch.cat(want)[:512]
    err = float((got.float() - want.float()).abs().max()) if got.shape == want.shape else float("inf")
    tol = 2**-7 * max(float(want.float().abs().max()), 1.0)
    num_atoms = np.concatenate([GridShardReader(out / "store" / f"proc-{r:03d}").num_atoms() for r in range(2)])
    ok = (got.shape[0] == 512 and err <= tol and [m["process_index"] for m in manifests] == [0, 1]
          and all(m["num_processes"] == 2 and m["final"] for m in manifests) and int((num_atoms == 0).sum()) == 2)
    emit({"phase": "multiprocess_store", "case": "512_records_dim48_c4_bf16_2_ranks",
          "rows_per_rank": [int(g.shape[0]) for g in rows], "zero_atom_rows": int((num_atoms == 0).sum()),
          "max_abs_err_vs_single_process": err, "tol": tol, "bitwise_equal": same_bits(got, want),
          "launches": sum(r["store_launches"] for r in ranks), "ok": bool(ok)})
    if not ok:
        raise SystemExit("multiprocess_store failed")

    # the two ranks' depth slabs of the rotated ligand against one full-depth call under rank 0's draw
    lig = load_golden("lig_features_gaussian")
    xyz = torch.as_tensor(lig["coords"] - lig["center"], device=dev)
    w = torch.as_tensor(lig["channels"][:, :4].astype(np.float32), device=dev)
    placed = do_random_transform(torch.Generator().manual_seed(100), xyz, None, 0.5, True)
    full = voxelize(placed, w, torch.ones(xyz.shape[0], device=dev), spec=GridSpec(0.25, 256)).cpu()
    slabs = [torch.from_numpy(np.load(out / f"slab{r}.npy")) for r in range(2)]
    err = float((torch.cat(slabs, dim=1) - full).abs().max()) if sum(x.shape[1] for x in slabs) == full.shape[1] \
        else float("inf")
    launches = [r["depth_launches"] for r in ranks]
    ok = err <= 1e-5 and launches == [1, 1]
    emit({"phase": "multiprocess_depth", "case": "lig_dim256_c4_f32_rot_trans05_mesh_1x2_seeded_apart",
          "slab_planes": [int(x.shape[1]) for x in slabs], "launches": launches, "max_abs_err_vs_full_depth": err,
          "tol": 1e-5, "ok": bool(ok)})
    if not ok:
        raise SystemExit("multiprocess_depth failed")
    return {1: sum(r["launches"] + r["store_launches"] for r in ranks), 2: sum(launches)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from molvoxel_torch import create_voxelizer
    from molvoxel_torch.core.config import GridSpec, small_atom_bucket
    from molvoxel_torch.core.transform import apply_quaternion, quaternion_to_matrix, rotate
    from molvoxel_torch.nn import VoxelCNN, VoxelizeLayer
    from molvoxel_torch.ops import _build, autodiff, deposit
    from molvoxel_torch.ops.batch import random_transform_batch, voxelize_batch
    from molvoxel_torch.ops.dense import voxelize_dense
    from molvoxel_torch.ops.voxelize import notrunc_use_kernel, voxelize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi()

    # 1. card
    emit({"phase": "card", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "cuda": torch.version.cuda, "torch": torch.__version__, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    report = [ln.strip() for name in _build.SOURCES for ln in _build.build_log(name).splitlines()
              if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source, "ptxas": report})
    phase_native_build()

    lig = load_golden("lig_features_gaussian")
    prot = load_golden("protein_single_gaussian")
    lig_xyz = torch.as_tensor(lig["coords"] - lig["center"], device=dev)
    prot_xyz = torch.as_tensor(prot["coords"] - prot["center"], device=dev)
    rng = np.random.default_rng(0)

    def inputs(xyz, b, c):
        w = rng.uniform(0.0, 1.0, size=(b, xyz.shape[0], c)).astype(np.float32)
        coords = xyz[None].expand(b, -1, -1).contiguous()
        if b > 1:  # a different orientation for every molecule
            coords = random_transform_batch(torch.Generator().manual_seed(b), coords, 0.5, True)
        return coords, torch.as_tensor(w, device=dev)

    # 3. kernel against plain
    cases = [
        # name, coords, C, B, dim, res, density, out dtype, slab, channel-wise
        ("lig_dim48_gauss_f32", lig_xyz, 4, 2, 48, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim48_binary_f32", lig_xyz, 4, 2, 48, 0.5, "binary", torch.float32, None, False),
        ("lig_dim64_gauss_bf16", lig_xyz, 4, 8, 64, 0.5, "gaussian", torch.bfloat16, None, False),
        ("lig_dim64_gauss_fp8", lig_xyz, 4, 8, 64, 0.5, "gaussian", torch.float8_e4m3fn, None, False),
        ("lig_dim64_binary_bf16", lig_xyz, 4, 8, 64, 0.5, "binary", torch.bfloat16, None, False),
        ("lig_dim64_slab16_32", lig_xyz, 4, 2, 64, 0.5, "gaussian", torch.float32, (16, 32), False),
        ("lig_dim48_channelwise", lig_xyz, 4, 2, 48, 0.5, "gaussian", torch.float32, None, True),
        ("lig_dim48_channelwise6_binary", lig_xyz, 6, 2, 48, 0.5, "binary", torch.float32, None, True),
        ("lig_dim20_gauss_f32", lig_xyz, 4, 2, 20, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim20_binary_f32", lig_xyz, 4, 2, 20, 0.5, "binary", torch.float32, None, False),
        ("lig_dim40_gauss_bf16", lig_xyz, 4, 2, 40, 0.5, "gaussian", torch.bfloat16, None, False),
        ("lig_dim40_binary_f32", lig_xyz, 4, 2, 40, 0.5, "binary", torch.float32, None, False),
        ("lig_dim256_gauss_f32", lig_xyz, 4, 1, 256, 0.25, "gaussian", torch.float32, None, False),
        ("lig_dim256_binary_fp8", lig_xyz, 4, 1, 256, 0.25, "binary", torch.float8_e4m3fn, None, False),
        ("prot_dim48_gauss_f32", prot_xyz, 1, 1, 48, 0.5, "gaussian", torch.float32, None, False),
        ("prot_dim48_binary_f32", prot_xyz, 1, 1, 48, 0.5, "binary", torch.float32, None, False),
        ("prot_dim128_gauss_f32", prot_xyz, 1, 1, 128, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim48_notrunc_f32", lig_xyz, 4, 2, 48, 0.5, "gaussian_notrunc", torch.float32, None, False),
        ("prot_dim128_notrunc_f32", prot_xyz, 1, 1, 128, 0.5, "gaussian_notrunc", torch.float32, None, False),
        # brick edges: ragged dims, a slab that is not a whole number of bricks
        ("lig_dim33_gauss_f32", lig_xyz, 4, 2, 33, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim33_binary_bf16", lig_xyz, 4, 2, 33, 0.5, "binary", torch.bfloat16, None, False),
        ("lig_dim50_gauss_bf16", lig_xyz, 4, 2, 50, 0.5, "gaussian", torch.bfloat16, None, False),
        ("lig_dim50_gauss_fp8", lig_xyz, 4, 2, 50, 0.5, "gaussian", torch.float8_e4m3fn, None, False),
        ("lig_dim64_slab5_27_f32", lig_xyz, 4, 2, 64, 0.5, "gaussian", torch.float32, (5, 27), False),
        ("lig_dim64_slab5_27_bf16", lig_xyz, 4, 8, 64, 0.5, "gaussian", torch.bfloat16, (5, 27), False),
        # channel groups
        ("lig_dim48_c1_f32", lig_xyz, 1, 2, 48, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim48_c6_bf16", lig_xyz, 6, 2, 48, 0.5, "gaussian", torch.bfloat16, None, False),
        ("lig_dim48_c6_fp8", lig_xyz, 6, 2, 48, 0.5, "gaussian", torch.float8_e4m3fn, None, False),
        ("lig_dim48_c9_f32", lig_xyz, 9, 2, 48, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim48_c9_binary_f32", lig_xyz, 9, 2, 48, 0.5, "binary", torch.float32, None, False),
        ("lig_dim40_c12_bf16", lig_xyz, 12, 2, 40, 0.5, "gaussian", torch.bfloat16, None, False),
        # a large batch of small grids
        ("lig512_dim32_gauss_bf16", lig_xyz, 4, 512, 32, 0.5, "gaussian", torch.bfloat16, None, False),
    ]

    def prepared(xyz, c, b, dim, res, density, slab, channelwise):
        spec = GridSpec(resolution=res, dimension=dim)
        coords, w = inputs(xyz, b, c)
        kw = dict(spec=spec, density_type=density, sigma=0.5)
        if slab is not None:
            kw.update(d_offset=slab[0], d_count=slab[1])
        if channelwise:
            radii = torch.linspace(0.8, 1.6, c, device=dev)
            coords, w, radii, _ = deposit.expand_channelwise(coords, w, radii, None)
        else:
            radii = torch.as_tensor(rng.uniform(0.8, 1.6, size=(b, xyz.shape[0])).astype(np.float32), device=dev)
        return (spec,) + deposit.prepare_batch(coords, w, radii, **kw)

    failed = []
    for name, xyz, c, b, dim, res, density, odt, slab, channelwise in cases:
        spec, rows, wt, ranges, dl, gaussian = prepared(xyz, c, b, dim, res, density, slab, channelwise)
        got = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)
        again = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)
        torch.cuda.synchronize()
        ref32 = deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian)
        ref = ref32.to(odt).float()
        err = float((got.float() - ref).abs().max())
        tol = bar(odt, ref32)
        bitwise = same_bits(got, again)
        ok = bool(np.isfinite(err) and err <= tol and torch.isfinite(got.float()).all() and bitwise)
        emit({"phase": "kernel_vs_plain", "case": name, "shape": list(got.shape), "out_dtype": str(odt),
              "max_abs_err": err, "tol": tol, "two_launches_bitwise_equal": bitwise,
              "brick": deposit.brick(b, wt.shape[1], dl, dim, odt)._asdict(), "ok": ok})
        if not ok:
            failed.append(name)
    # an all-masked batch at the headline shape: an exact zero grid.  Masked
    # atoms keep their places and r^2 = 1, so their chunks are staged and
    # rejected; parked off the grid (as padding atoms are), no chunk is
    # active, and the time is the kernel's store floor
    spec64 = GridSpec(0.5, 64)
    lig64 = torch.zeros((64, 64, 3), device=dev)
    lig64[:, :61] = lig_xyz
    w64 = torch.ones((64, 64, 4), device=dev)
    none = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    for name, xyz in (("all_masked_64lig_dim64_c4_bf16", lig64),
                      ("all_masked_parked_64lig_dim64_c4_bf16", torch.full_like(lig64, deposit.FAR))):
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(xyz, w64, torch.ones(64, device=dev), spec=spec64,
                                                               mask=none, presorted=True)
        got = deposit.deposit_fwd(rows, wt, ranges, spec=spec64, dl=dl, gaussian=gaussian, out_dtype=torch.bfloat16)
        zero = bool((got.float() == 0).all()) and not bool(torch.signbit(got.float()).any())
        ms = time_graph_ms(lambda: deposit.deposit_fwd(rows, wt, ranges, spec=spec64, dl=dl, gaussian=gaussian,
                                                       out_dtype=torch.bfloat16))
        out_bytes = got.numel() * got.element_size()
        emit({"phase": "kernel_vs_plain", "case": name, "shape": list(got.shape), "exact_zero": zero,
              "active_chunk_tiles": int((ranges[..., 1] > ranges[..., 0]).sum()), "kernel_ms": ms,
              "write_tb_s": out_bytes / (ms * 1e-3) / 1e12, "byte_bound_ms": out_bytes / HBM_BYTES_PER_S * 1e3,
              "ok": zero})
        if not zero:
            failed.append(name)
    if failed:
        raise SystemExit(f"kernel_vs_plain failed: {failed}")

    # 3b. backward kernel against its plain version, on the same inputs and cotangent
    bwd_cases = [
        # name, coords, C, B, dim, res, density, cotangent dtype, slab, channel-wise
        ("headline_64lig_dim64_c4_f32", lig_xyz, 4, 64, 64, 0.5, "gaussian", torch.float32, None, False),
        ("headline_64lig_dim64_c4_bf16", lig_xyz, 4, 64, 64, 0.5, "gaussian", torch.bfloat16, None, False),
        ("prot_dim48_f32", prot_xyz, 1, 1, 48, 0.5, "gaussian", torch.float32, None, False),
        ("prot_dim128_f32", prot_xyz, 1, 1, 128, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim20_f32", lig_xyz, 4, 2, 20, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim40_f32", lig_xyz, 4, 2, 40, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim256_f32", lig_xyz, 4, 1, 256, 0.25, "gaussian", torch.float32, None, False),
        ("lig_dim64_slab16_32", lig_xyz, 4, 2, 64, 0.5, "gaussian", torch.float32, (16, 32), False),
        ("lig_dim48_channelwise9", lig_xyz, 9, 2, 48, 0.5, "gaussian", torch.float32, None, True),
        ("headline_64lig_dim64_c16_f32", lig_xyz, 16, 64, 64, 0.5, "gaussian", torch.float32, None, False),
        ("lig_dim48_binary_f32", lig_xyz, 4, 2, 48, 0.5, "binary", torch.float32, None, False),
        ("lig_dim40_binary_bf16", lig_xyz, 4, 2, 40, 0.5, "binary", torch.bfloat16, None, False),
        ("lig_dim48_notrunc_f32", lig_xyz, 4, 2, 48, 0.5, "gaussian_notrunc", torch.float32, None, False),
        ("prot_dim128_notrunc_f32", prot_xyz, 1, 1, 128, 0.5, "gaussian_notrunc", torch.float32, None, False),
    ]
    ct_gen = torch.Generator(device=dev).manual_seed(0)
    bwd_errs = []
    for name, xyz, c, b, dim, res, density, ct_dt, slab, channelwise in bwd_cases:
        spec, rows, wt, ranges, dl, gaussian = prepared(xyz, c, b, dim, res, density, slab, channelwise)
        ct32 = torch.randn((b, wt.shape[1], dl, dim * dim), generator=ct_gen, device=dev)
        ct = ct32.to(ct_dt)
        got = deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian)
        again = deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian)
        torch.cuda.synchronize()
        err, scale = grad_err(got, deposit.deposit_bwd_plain(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian))
        tol = 1e-4 * scale
        bitwise = all(same_bits(g, a) for g, a in zip(got, again))
        line = {"phase": "bwd_vs_plain", "case": name, "ct_dtype": str(ct_dt), "grad_scale": scale,
                "max_abs_err": err, "tol": tol, "two_launches_bitwise_equal": bitwise,
                "warps_per_atom": deposit.bwd_warps_per_atom(b, wt.shape[2])}
        ok = err <= tol and bitwise
        if ct_dt != torch.float32:  # the low-precision lane against the f32 cotangent
            lane_err, lane_scale = grad_err(got, deposit.deposit_bwd_plain(rows, wt, ct32, spec=spec, dl=dl,
                                                                           gaussian=gaussian))
            line.update(max_abs_err_vs_f32_ct=lane_err, tol_vs_f32_ct=3e-2 * lane_scale)
            ok = ok and lane_err <= 3e-2 * lane_scale
        line["ok"] = bool(ok and all(torch.isfinite(t).all() for t in got))
        emit(line)
        bwd_errs.append(err)
        if not line["ok"]:
            failed.append(name)
    # 70,000 one-chunk molecules at 8^3: more than a grid axis holds (65,535).
    # Held bitwise against the same kernel on the two halves of the batch, and
    # its first molecules against the plain version
    big, half = 70_000, 35_000
    spec8 = GridSpec(0.5, 8)
    big_gen = torch.Generator(device=dev).manual_seed(1)
    big_xyz = (torch.rand((big, 64, 3), generator=big_gen, device=dev) - 0.5) * spec8.width
    big_w = torch.rand((big, 64, 1), generator=big_gen, device=dev)
    rows, wt, _, dl, gaussian = deposit.prepare_batch(big_xyz, big_w, torch.ones(64, device=dev), spec=spec8)
    ct = torch.randn((big, 1, dl, 64), generator=big_gen, device=dev)
    got = deposit.deposit_bwd(rows, wt, ct, spec=spec8, dl=dl, gaussian=gaussian)
    halves = [deposit.deposit_bwd(rows[s], wt[s], ct[s], spec=spec8, dl=dl, gaussian=gaussian)
              for s in (slice(0, half), slice(half, big))]
    torch.cuda.synchronize()
    bitwise = all(same_bits(g, torch.cat([h[k] for h in halves])) for k, g in enumerate(got))
    err, scale = grad_err([g[:4] for g in got], deposit.deposit_bwd_plain(rows[:4], wt[:4], ct[:4], spec=spec8, dl=dl,
                                                                          gaussian=gaussian))
    ok = bitwise and err <= 1e-4 * scale and all(torch.isfinite(g).all() for g in got)
    emit({"phase": "bwd_vs_plain", "case": "batch70000_dim8_c1_f32", "batch": big, "halves_bitwise_equal": bitwise,
          "max_abs_err_first4": err, "tol": 1e-4 * scale, "warps_per_atom": deposit.bwd_warps_per_atom(big, 64),
          "ok": bool(ok)})
    if not ok:
        failed.append("batch70000_dim8_c1_f32")
    del big_xyz, big_w, rows, wt, ct, got, halves
    if failed:
        raise SystemExit(f"bwd_vs_plain failed: {failed}")

    # 4. goldens on CUDA through the public API
    deposit.reset_launches()
    golden_failed = []
    n_goldens = 0
    for path in sorted(GOLDENS.glob("*.npz")):
        g = dict(np.load(path, allow_pickle=False))
        n_goldens += 1
        vox = create_voxelizer(device=DEVICE, resolution=float(g["resolution"]), dimension=int(g["dimension"]),
                               radii_type=str(g["radii_type"]), density_type=str(g["density"]),
                               sigma=float(g["sigma"]))
        center = g["center"] if g["center"].size else None
        radii = float(g["radii"]) if g["radii"].ndim == 0 else g["radii"]
        mode = str(g["mode"])
        if mode == "features":
            out = vox.forward_features(g["coords"], center, g["channels"].astype(np.float32), radii)
        elif mode == "types":
            out = vox.forward_types(g["coords"], center, g["channels"].astype(np.int32), radii)
        else:
            out = vox.forward_single(g["coords"], center, radii)
        err = float(np.abs(out.cpu().numpy() - g["expected"]).max())
        tol = 5e-5 if path.stem.endswith("torchref") else 1e-5
        ok = out.device.type == dev.type and tuple(out.shape) == g["expected"].shape and err <= tol
        emit({"phase": "golden", "golden": path.stem, "max_abs_err": err, "tol": tol, "ok": bool(ok)})
        if not ok:
            golden_failed.append(path.stem)
    golden_launches = deposit.launches["deposit_fwd"]
    emit({"phase": "goldens", "count": n_goldens, "failed": golden_failed, "launches": golden_launches})
    if golden_failed or n_goldens != 22 or golden_launches <= 0:
        raise SystemExit(f"goldens failed: {golden_failed}, count {n_goldens}, launches {golden_launches}")

    # 5. full-width main paths through the public API
    kernels = {}
    lig_feat = lig["channels"][:, :4].astype(np.float32)  # (61, 4)

    def check_and_time(row, label, out, ref, rows, wt, ranges, spec, dl, gaussian, odt, launches):
        err = float((out.float() - ref.to(odt).float()).abs().max())
        tol = bar(odt, ref)
        ok = bool(torch.isfinite(out.float()).all()) and err <= tol and launches > 0
        def launch():
            return deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)

        ms = time_graph_ms(launch)
        ms_back_to_back = time_ms(launch)
        plain_ms = time_ms(lambda: deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian,
                                                         out_dtype=odt), reps=5, inner=1)
        kout = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt)
        kerr = float((kout.float() - deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian,
                                                           out_dtype=odt).float()).abs().max())
        b_ms, b_by = bound(rows, wt, ranges, kout, spec, dl, gaussian)
        out_bytes = kout.numel() * kout.element_size()
        info = deposit.fwd_launch_info(wt.shape[0], wt.shape[1], wt.shape[2], dl, spec.dimension, gaussian, odt)
        line = {"phase": "main_path", "row": row, "case": label, "shape": list(out.shape), "out_dtype": str(odt),
                "launches": launches, "max_abs_err_vs_dense": err, "tol": tol, "ok": ok,
                "kernel_ms": ms, "kernel_ms_back_to_back": ms_back_to_back, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "kernel_vs_plain_err": kerr, "out_bytes": out_bytes,
                "blocks": info["blocks"], "resident_blocks_per_sm": info["resident_per_sm"], "waves": info["waves"],
                "brick": {k: info[k] for k in ("dt", "ht", "kct", "run", "threads", "passes")},
                "write_tb_s": out_bytes / (ms * 1e-3) / 1e12}
        emit(line)
        if not ok or kerr > tol:
            raise SystemExit(f"main path {label} failed")
        return line

    def dense_ref(coords, w, radii, spec, density, mask=None):
        return torch.stack([voxelize_dense(coords[i], w[i], radii, spec=spec, density_type=density, sigma=0.5,
                                           mask=None if mask is None else mask[i]) for i in range(coords.shape[0])])

    # row 1: the headline batch, then the protein
    spec64 = GridSpec(0.5, 64)
    vox = create_voxelizer(device=DEVICE, resolution=0.5, dimension=64)
    weights64 = (rng.uniform(size=(64, 61, 4)) < 0.3).astype(np.float32)
    lig_np = lig_xyz.cpu().numpy()
    clouds = [(lig_np, weights64[i]) for i in range(64)]
    seed = 1234

    def headline():
        return vox.forward_batch(clouds, radii=1.0, random_translation=0.5, random_rotation=True, key=seed,
                                 out_dtype="bfloat16")

    deposit.reset_launches()
    out = headline()
    torch.cuda.synchronize()
    launches = deposit.launches["deposit_fwd"]
    e2e = []
    for i in range(9):  # two warm-ups, then seven timed calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        headline()
        torch.cuda.synchronize()
        if i >= 2:
            e2e.append((time.perf_counter() - t0) * 1e3)
    # the same batch, the same transforms, through the plain dense path
    b_coords = torch.zeros((64, 64, 3), device=dev)
    b_coords[:, :61] = lig_xyz
    b_w = torch.zeros((64, 64, 4), device=dev)
    b_w[:, :61] = torch.as_tensor(weights64, device=dev)
    b_mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    b_mask[:, :61] = True
    ones = torch.ones(64, device=dev)
    ref = voxelize_batch(b_coords, b_w, ones, b_mask, None, torch.Generator().manual_seed(seed), 0.5,
                         spec=spec64, random_rotation=True, impl="dense")
    xyz_t = random_transform_batch(torch.Generator().manual_seed(seed), b_coords, 0.5, True)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(xyz_t, b_w, ones, spec=spec64, mask=b_mask)
    row1 = [check_and_time(1, "forward_batch_64lig_dim64_c4_bf16", out, ref, rows, wt, ranges, spec64, dl,
                           gaussian, torch.bfloat16, launches)]
    e2e_ms = statistics.median(e2e)
    emit({"phase": "main_path_e2e", "case": row1[0]["case"], "forward_batch_ms_median": e2e_ms,
          "forward_batch_ms_min": min(e2e), "forward_batch_ms_max": max(e2e), "calls": len(e2e),
          "mols_per_s": 64 / (e2e_ms / 1e3)})
    prot_np = prot["coords"]
    for dim in (48, 128):
        spec = GridSpec(0.5, dim)
        vox = create_voxelizer(device=DEVICE, resolution=0.5, dimension=dim)
        deposit.reset_launches()
        out = vox.forward_single(prot_np, prot["center"], 1.0)
        torch.cuda.synchronize()
        launches = deposit.launches["deposit_fwd"]
        ref = dense_ref(prot_xyz[None], torch.ones((1, prot_xyz.shape[0], 1), device=dev),
                        torch.ones(prot_xyz.shape[0], device=dev), spec, "gaussian")[0]
        # the kernel inputs as forward_single builds them: atom bucket 4096, masked
        vp = small_atom_bucket(prot_xyz.shape[0])
        p_coords = torch.zeros((1, vp, 3), device=dev)
        p_coords[0, : prot_xyz.shape[0]] = prot_xyz
        p_mask = torch.arange(vp, device=dev)[None] < prot_xyz.shape[0]
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(p_coords, p_mask[..., None].float(),
                                                               torch.ones(vp, device=dev), spec=spec, mask=p_mask)
        row1.append(check_and_time(1, f"forward_single_protein_dim{dim}_f32", out, ref, rows, wt, ranges, spec, dl,
                                   gaussian, torch.float32, launches))
    # gaussian_notrunc on the protein at 128^3, on the route the routing rule
    # names: one launch (the kernel with the notrunc threshold row) or none
    # (the separable product)
    nt_route = "kernel" if notrunc_use_kernel(small_atom_bucket(prot_xyz.shape[0]), 128) else "separable"
    vox = create_voxelizer(device=DEVICE, resolution=0.5, dimension=128, density_type="gaussian_notrunc")
    deposit.reset_launches()
    out = vox.forward_single(prot_np, prot["center"], 1.0)
    torch.cuda.synchronize()
    nt_launches = deposit.launches["deposit_fwd"]
    ref = dense_ref(prot_xyz[None], torch.ones((1, prot_xyz.shape[0], 1), device=dev),
                    torch.ones(prot_xyz.shape[0], device=dev), GridSpec(0.5, 128), "gaussian_notrunc")[0]
    err = float((out - ref).abs().max())
    emit({"phase": "main_path_check", "row": 1, "case": "forward_single_protein_dim128_notrunc_f32",
          "route": nt_route, "launches": nt_launches, "max_abs_err_vs_dense": err, "tol": 1e-5})
    if err > 1e-5 or nt_launches != (1 if nt_route == "kernel" else 0):
        raise SystemExit("main path protein notrunc failed")
    # row 1 is timed on the headline batch; its launches count all four calls
    kernels[1] = dict(row1[0], launches=sum(ln["launches"] for ln in row1) + nt_launches,
                      max_abs_err=max(ln["kernel_vs_plain_err"] for ln in row1))

    # rows 2 and 3: ragged and 256^3 grids, gaussian then binary
    lig_w = torch.as_tensor(lig_feat, device=dev)[None]
    lig_ones = torch.ones(61, device=dev)
    for row, density, grids in ((2, "gaussian", ((20, 0.5), (40, 0.5), (256, 0.25))),
                                (3, "binary", ((40, 0.5), (256, 0.25)))):
        deposit.reset_launches()
        outs = []
        for dim, res in grids:
            vox = create_voxelizer(device=DEVICE, resolution=res, dimension=dim, density_type=density)
            outs.append(vox.forward_features(lig["coords"], lig["center"], lig_feat, 1.0))
        torch.cuda.synchronize()
        launches = deposit.launches["deposit_fwd"]
        dim, res = grids[-1]
        spec = GridSpec(res, dim)
        ref = dense_ref(lig_xyz[None], lig_w, lig_ones, spec, density)[0]
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(lig_xyz[None], lig_w, lig_ones, spec=spec,
                                                               density_type=density)
        line = check_and_time(row, f"forward_features_lig_dim{dim}_{density}_f32", outs[-1], ref, rows, wt, ranges,
                              spec, dl, gaussian, torch.float32, launches)
        for (dim_i, res_i), out_i in zip(grids[:-1], outs[:-1]):
            spec_i = GridSpec(res_i, dim_i)
            err = float((out_i - dense_ref(lig_xyz[None], lig_w, lig_ones, spec_i, density)[0]).abs().max())
            emit({"phase": "main_path_check", "row": row, "dim": dim_i, "max_abs_err_vs_dense": err, "tol": 1e-5})
            if err > 1e-5:
                raise SystemExit(f"main path row {row} dim {dim_i} failed")
        kernels[row] = dict(line, max_abs_err=line["kernel_vs_plain_err"])

    # row 4: the training step at full width, through the backward kernel
    torch.manual_seed(0)  # the CNN's initial weights
    layer = VoxelizeLayer(spec64, augment=True, random_translation=0.5)
    cnn = VoxelCNN(in_channels=4, features=64, widths=(16, 32, 64)).to(dev)
    head = torch.nn.Linear(64, 1).to(dev)
    labels = torch.as_tensor(rng.uniform(0.0, 5.0, size=64).astype(np.float32), device=dev)
    quat = torch.zeros((64, 4), device=dev)
    quat[:, 0] = 1.0
    quat.requires_grad_()
    shift = torch.zeros((64, 3), device=dev, requires_grad=True)
    opt = torch.optim.Adam([*cnn.parameters(), *head.parameters(), quat, shift], lr=1e-3)
    aug = torch.Generator().manual_seed(seed)

    def train_step():
        opt.zero_grad(set_to_none=True)
        posed = rotate(b_coords, quaternion_to_matrix(quat / quat.norm(dim=-1, keepdim=True))) + shift[:, None, :]
        grids = layer(posed, b_w, b_mask, generator=aug)
        loss = torch.nn.functional.mse_loss(head(cnn(grids))[:, 0], labels)
        loss.backward()
        opt.step()
        return float(loss.detach())

    deposit.reset_launches()
    losses, step_ms = [], []
    with KernelTimer(autodiff, ("deposit_fwd", "deposit_bwd")) as timer:
        for i in range(9):  # two warm-ups, then seven timed steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step())
            torch.cuda.synchronize()
            if i >= 2:
                step_ms.append((time.perf_counter() - t0) * 1e3)
    train_launches = dict(deposit.launches)
    steps = len(losses)
    ok = (all(np.isfinite(losses)) and train_launches["deposit_fwd"] == steps
          and train_launches["deposit_bwd"] == steps)
    emit({"phase": "main_path_train", "row": 4, "case": "train_step_64lig_dim64_c4_f32_cnn16_32_64",
          "steps": steps, "losses": losses, "launches": train_launches,
          "fwd_launches_per_step": train_launches["deposit_fwd"] / steps,
          "bwd_launches_per_step": train_launches["deposit_bwd"] / steps,
          "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
          "in_step_fwd_ms_median": timer.median_ms("deposit_fwd"),
          "in_step_bwd_ms_median": timer.median_ms("deposit_bwd"), "ok": bool(ok)})
    if not ok:
        raise SystemExit("main path training step failed")
    # where the step's device time goes: torch.profiler over two more steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            train_step()
        torch.cuda.synchronize()
    # only the device-side rows: a CPU op's row repeats the device time of the kernels it launched
    by_name = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy_ms = sum(us for us, _ in by_name) / 2 / 1e3
    emit({"phase": "train_step_profile", "steps": 2, "device_busy_ms_per_step": busy_ms,
          "device_busy_share_of_median_step": busy_ms / statistics.median(step_ms),
          "top": [{"name": name[:90], "ms_per_step": us / 2 / 1e3} for us, name in by_name[:12]]})
    # kernel 4 against its plain version and timed, on the last step's own inputs
    (rows, wt, ct), bkw = timer.last["deposit_bwd"]
    got = deposit.deposit_bwd(rows, wt, ct, **bkw)
    kerr, scale = grad_err(got, deposit.deposit_bwd_plain(rows, wt, ct, **bkw))
    # the layer's 64-atom molecules fill one chunk each and are not sorted, so the mask keeps its order
    b_ms, b_by = bound_bwd(rows, wt, ct, b_mask, bkw["spec"], bkw["dl"], bkw["gaussian"])
    info = deposit.bwd_launch_info(*wt.shape, bkw["gaussian"], ct.dtype)
    line = {"phase": "main_path", "row": 4, "case": "train_step_64lig_dim64_c4_f32 (deposit_bwd)",
            "launches": train_launches["deposit_bwd"], "grad_scale": scale, "kernel_vs_plain_err": kerr,
            "tol": 1e-4 * scale, "kernel_ms": time_graph_ms(lambda: deposit.deposit_bwd(rows, wt, ct, **bkw)),
            "kernel_ms_back_to_back": time_ms(lambda: deposit.deposit_bwd(rows, wt, ct, **bkw)),
            "launch_floor_ms": launch_floor_ms(),
            "plain_ms": time_ms(lambda: deposit.deposit_bwd_plain(rows, wt, ct, **bkw), reps=5, inner=1),
            "bound_ms": b_ms, "bound_by": b_by, **info}
    emit(line)
    if kerr > 1e-4 * scale:
        raise SystemExit("main path training step: backward kernel disagrees with its plain version")
    kernels[4] = dict(line, max_abs_err=max([kerr] + bwd_errs))

    # 5b. gaussian_notrunc: the kernel route against the separable product
    notrunc = phase_notrunc_routing(dev)

    # 6. convergence: examples/pose_optimize.py through the kernel backward
    coords0 = torch.as_tensor((lig["coords"] - lig["coords"].mean(0)).astype(np.float32), device=dev)
    spec32 = GridSpec(0.5, 32)
    n_atoms = coords0.shape[0]
    pose_w, pose_r = torch.ones((n_atoms, 1), device=dev), torch.ones(n_atoms, device=dev)
    prng = np.random.default_rng(0)
    u = prng.uniform(size=3)
    q = np.array([np.sqrt(1 - u[0]) * np.sin(2 * np.pi * u[1]), np.sqrt(1 - u[0]) * np.cos(2 * np.pi * u[1]),
                  np.sqrt(u[0]) * np.sin(2 * np.pi * u[2]), np.sqrt(u[0]) * np.cos(2 * np.pi * u[2])])
    q = q * 0.25 + np.array([1.0, 0.0, 0.0, 0.0]) * 0.75  # a refinement-scale rotation, as in the example
    q_true = torch.as_tensor((q / np.linalg.norm(q)).astype(np.float32), device=dev)
    t_true = torch.as_tensor(prng.uniform(-0.8, 0.8, 3).astype(np.float32), device=dev)
    target_coords = apply_quaternion(coords0, q_true) + t_true

    def pose_grid(crd):
        return voxelize(crd, pose_w, pose_r, spec=spec32, sigma=1.0)

    target = pose_grid(target_coords)
    q_p = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev, requires_grad=True)
    t_p = torch.zeros(3, device=dev, requires_grad=True)
    pose_opt = torch.optim.Adam([q_p, t_p], lr=3e-2)

    def pose_coords():
        return apply_quaternion(coords0, q_p / q_p.norm()) + t_p

    def rmsd():
        with torch.no_grad():
            return float(((pose_coords() - target_coords) ** 2).sum(-1).mean().sqrt())

    r0 = rmsd()
    deposit.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(400):
        pose_opt.zero_grad(set_to_none=True)
        loss = ((pose_grid(pose_coords()) - target) ** 2).mean() * 1e4
        loss.backward()
        pose_opt.step()
    torch.cuda.synchronize()
    pose_s = time.perf_counter() - t0
    r1 = rmsd()
    final_loss = float(loss.detach())
    ok = r1 < 0.05 and deposit.launches["deposit_bwd"] == 400 and np.isfinite(final_loss)
    emit({"phase": "convergence", "case": "pose_optimize_lig61_dim32_sigma1", "steps": 400, "rmsd_start": r0,
          "rmsd_end": r1, "bar": 0.05, "final_loss": final_loss, "launches": dict(deposit.launches),
          "ms_per_step": pose_s / 400 * 1e3, "ok": bool(ok)})
    if not ok:
        raise SystemExit(f"pose refinement did not converge: RMSD {r0:.4f} -> {r1:.4f}")

    # 7-9. the library path: sliced 256^3 assembly, packing, the grid store and the stream;
    # 10-13. the wrappers, the torch datasets, the sharded calls and two ranks on the card
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        sliced = phase_sliced_256(lig_xyz, tmp, rng)
        phase_packing(lig_xyz, rng)
        by_phase = {row: {} for row in (1, 2, 3, 4)}
        for row, entry in notrunc.items():
            by_phase[row]["notrunc_routing"] = entry["launches"]
        by_phase[1]["wrappers"] = phase_wrappers(tmp)
        stream = phase_library(tmp, dev)
        by_phase[1]["interop_dataset"] = phase_interop(tmp / "lib.sdf", tmp / "store", dev)
        for row, n in phase_parallel(lig_xyz, prot_xyz, lig_w[0], b_coords, b_w, b_mask, seed,
                                     tmp / "lib4096.sdf").items():
            by_phase[row]["parallel"] = n
        for row, n in phase_multiprocess(tmp / "lib.sdf", tmp / "lib512.sdf", tmp, dev).items():
            by_phase[row]["multiprocess"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels[1]["launches_per_superbatch"] = stream["plain"]["launches_per_superbatch"]
    kernels[2]["launches_per_sliced_call"] = sliced["launches"]
    for row, counts in by_phase.items():
        kernels[row]["launches_by_phase"] = {"main_path": kernels[row]["launches"], **counts}
        kernels[row]["launches"] += sum(counts.values())

    # 14. kernels line
    emit({"kernels": [
        {"name": f"{'deposit_bwd' if row == 4 else 'deposit_fwd'} (table row {row})", "route": "cuda",
         "source": f"molvoxel_torch/csrc/{'deposit_bwd' if row == 4 else 'deposit_fwd'}.cu",
         "replaces": REPLACES[row], "launches": k["launches"], "max_abs_err": k["max_abs_err"],
         "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": None, "timed_case": k["case"],
         **{key: k[key] for key in ("launches_by_phase", "launches_per_superbatch", "launches_per_sliced_call")
            if key in k},
         **({"notrunc": notrunc[row]} if row in notrunc else {})}
        for row, k in sorted(kernels.items())
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
