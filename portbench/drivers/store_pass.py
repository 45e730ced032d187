"""Whole passes of the CLI's grid store over one SDF file: ``voxelize lib.sdf -o store/``.

Set-up writes the configuration's library as one SDF file into the run's
scratch directory and runs one warm-up pass over its first
``warmup_records`` records.  Pass ``p`` runs the user's command in this process,
``molvoxel_torch.cli.main(["voxelize", sdf, "-o", store, ...])``, with the
configuration's grid, channels and output dtype, the traffic's batch and
parser threads, and the augmentation drawn from ``--seed key(seed, p)``: one
augmented epoch of the file into a fresh store.  A pass's time runs from the
call to its return, when the store's last file is written (no fsync, as the
CLI makes none); the pass runs inside the benchmark's span ``api``, the
port's entry, to which the device trace ties its kernels.

Outside that time, in span ``readback``, the plain reader
(``reference/store.py``) holds the store to the configuration's guarantees
(a final manifest, every record in its slot, ``num_atoms`` equal to the
heavy atoms, each record without one a zero grid) and reads
``readback_per_pass`` records drawn from the seed into a reservoir of
``check_records``; in span ``cleanup`` the store is deleted, so that scratch
holds one store at a time.

The check: ``store_err`` counts the passes whose store broke a guarantee;
``grid_err`` is how far the worst voxel of a kept record lies outside the
reference's interval (``reference/grid.py``).  The reference replays pass
``p``'s draws from ``recipe.generator(key(seed, p))``: one
``recipe.draw(gen, batch, ...)`` a batch in file order, up to the record's
batch, and places the record's heavy atoms, held in memory, about their mean.
"""

from __future__ import annotations

import contextlib
import io
import shutil
import sys
import time

import numpy as np
import torch

from portbench import roofline
from portbench.harness import Check, Reservoir, Verdict, Window
from portbench.reference import grid as ref_grid
from portbench.reference import recipe
from portbench.reference import store as ref_store

ENTRY_SPANS = ("api",)


def key(seed: int, p: int) -> int:
    """The augmentation key of pass ``p``, as ``batch_loop`` keys its calls."""
    return (seed * 1000003 + 7919 * p + 104729) % (1 << 62)


def replay(cfg: dict, mol, pass_key: int, batch: int, i: int) -> tuple:
    """(lo, hi, pairs) of ``reference/grid.deposit`` for record ``i`` of a pass
    keyed ``pass_key`` in batches of ``batch``: (1, C, D, H, W) float64."""
    gen = recipe.generator(pass_key)
    for _ in range(i // batch + 1):
        rot, shift = recipe.draw(gen, batch, float(cfg["random_translation"]), bool(cfg["random_rotation"]))
    coords, types, center = mol
    j = i % batch
    xyz = torch.as_tensor(recipe.place(coords, center, rot[j], shift[j]), dtype=torch.float64)
    return ref_grid.deposit(xyz, torch.zeros(len(types), dtype=torch.int64), torch.as_tensor(types),
                            torch.ones(len(types), dtype=torch.float64), batch=1,
                            channels=int(cfg["num_channels"]), dim=int(cfg["dimension"]),
                            res=float(cfg["resolution"]), sigma=float(cfg["sigma"]), radius=float(cfg["radii"]),
                            band=ref_grid.BAND)


class State:
    def __init__(self, ctx, sdf, mols):
        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.sdf, self.mols = ctx, sdf, mols
        self.batch, self.out_dtype = int(tr["batch"]), ctx.out_dtype()
        self.heavy = np.array([len(m[1]) for m in mols], np.int32)
        c, d = int(cfg["num_channels"]), int(cfg["dimension"])
        self.grid_shape = [c, d, d, d]
        self.kept = Reservoir(int(tr["check_records"]), ctx.seed)
        self.store_err, self.problems, self.window_batches = 0, [], 0
        self.batches_per_pass = -(-len(mols) // self.batch)
        itemsize = getattr(torch, self.out_dtype).itemsize
        self.pass_work = roofline.Work()
        for b in range(self.batches_per_pass):
            atoms = int(self.heavy[b * self.batch:(b + 1) * self.batch].sum())
            self.pass_work += roofline.forward(atoms, atoms, self.batch, self.batch * c * d**3, itemsize)

    def argv(self, sdf, store, p: int) -> list[str]:
        cfg, tr = self.ctx.config, self.ctx.traffic
        argv = ["voxelize", str(sdf), "-o", str(store), "--out-dtype", self.out_dtype]
        argv += ["--random-rotation"] if cfg["random_rotation"] else []
        argv += ["--random-translation", str(cfg["random_translation"]), "--seed", str(key(self.ctx.seed, p)),
                 "--dimension", str(cfg["dimension"]), "--resolution", str(cfg["resolution"]),
                 "--sigma", str(cfg["sigma"]), "--radii", str(cfg["radii"]),
                 "--channels", ",".join(cfg["molecules"]["symbols"]), "--batch", str(tr["batch"]),
                 "--workers", str(tr["workers"])]
        return argv + (["--device", "cpu"] if self.ctx.device == "cpu" else [])

    def run_pass(self, p: int, name: str, sdf=None):
        """Run pass ``p`` over ``sdf`` (the library) into a fresh store; returns (store, seconds)."""
        from molvoxel_torch import cli

        store = self.ctx.tmpdir / name
        said = io.StringIO()  # the command's one line a pass
        t0 = time.perf_counter()
        with self.ctx.spans("api"), contextlib.redirect_stderr(said):
            rc = cli.main(self.argv(self.sdf if sdf is None else sdf, store, p))
        dt = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"pass {p} returned {rc}: {said.getvalue()[-2000:]}")
        return store, dt

    def readback(self, p: int, store) -> None:
        with self.ctx.spans("readback"):
            bad = ref_store.problems(store, records=len(self.mols), dtype=self.out_dtype,
                                     grid_shape=self.grid_shape, heavy_counts=self.heavy)
            if bad:
                self.store_err += 1
                self.problems.append((p, bad[:4]))
                return
            reader = ref_store.Store(store)
            rng = np.random.default_rng([self.ctx.seed, p])
            for i in rng.choice(len(self.mols), int(self.ctx.traffic["readback_per_pass"]), replace=False).tolist():
                self.kept.offer((p, i, reader.grid(i)))

    def cleanup(self, store) -> None:
        with self.ctx.spans("cleanup"):
            shutil.rmtree(store)


def setup(ctx) -> State:
    sdf = ctx.tmpdir / "library.sdf"
    mols = ctx.source().write(ctx.root, ctx.config, ctx.seed, sdf)
    ctx.mark("inputs")
    state = State(ctx, sdf, mols)
    # the warm-up pass over the file's first ``warmup_records`` records: the batches of a library file of
    # one-chunk ligands share one shape, so two batches build the kernels' plans, the ring, the parser's
    # threads and the caching allocator's blocks as a whole pass does
    warm = int(ctx.traffic["warmup_records"])
    if warm < len(mols):
        records = sdf.read_text().split("$$$$\n")
        warm_sdf = ctx.tmpdir / "library_warmup.sdf"
        warm_sdf.write_text("$$$$\n".join(records[:warm]) + "$$$$\n")
    else:
        warm_sdf = sdf
    store, _ = state.run_pass(-1, "store_warmup", warm_sdf)
    state.cleanup(store)
    ctx.synchronize()
    ctx.mark("warmup")
    return state


def window(state: State, seconds: float) -> Window:
    calls_s, p = [], 0
    while True:
        store, dt = state.run_pass(p, f"store_{p}")
        calls_s.append(dt)
        state.readback(p, store)
        state.cleanup(store)
        p += 1
        if sum(calls_s) >= seconds:
            break
    state.window_batches = p * state.batches_per_pass
    return Window(sum(calls_s), p * len(state.mols), calls_s, p, state.pass_work * p)


def after(state: State, traced: bool) -> dict:
    return {"batches": state.window_batches}


def check(state: State) -> Verdict:
    ctx, cfg = state.ctx, state.ctx.config
    limit = float(ctx.limits["grid_err"])
    worst, failed, pairs, atoms = 0.0, state.store_err, 0, 0
    for p, i, grid in state.kept.items:
        lo, hi, n_pairs = replay(cfg, state.mols[i], key(ctx.seed, p), state.batch, i)
        err = ref_grid.interval_excess(grid[None], lo, hi) if list(grid.shape) == state.grid_shape else float("inf")
        worst = max(worst, err)
        failed += not err <= limit
        pairs += n_pairs
        atoms += len(state.mols[i][1])
    for p, bad in state.problems:
        print(f"store_pass: pass {p}: {'; '.join(bad)}", file=sys.stderr)
    return Verdict([Check("grid_err", worst, limit), Check("store_err", float(state.store_err),
                                                           float(ctx.limits["store_err"]))],
                   failed, pairs / atoms if atoms else None)
