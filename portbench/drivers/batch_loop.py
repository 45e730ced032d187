"""A closed loop over ``Voxelizer.forward_batch``: one caller, each call ending with its grids ready on the card.

Call ``k`` voxelizes the next ``batch`` molecules of the source, cycling
through it (the complex source holds one molecule, so a call is ``batch``
copies of it), typed, with the configuration's augmentation drawn from the
key ``key(seed, k)``.  A call's time runs from the entry to the end of the
``synchronize`` after it.

The check: ``check_calls`` calls drawn from the seed among those of the
window keep their grids; the reference deposits each again and
``grid_err`` is how far the worst voxel lies outside the reference's
interval (``reference/grid.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import roofline
from portbench.harness import Check, Reservoir, Verdict, Window
from portbench.reference import grid as ref_grid
from portbench.reference import recipe

ENTRY_SPANS = ("api",)


def key(seed: int, k: int) -> int:
    """The augmentation key of call ``k`` (warm-up calls have k < 0)."""
    return (seed * 1000003 + 7919 * k + 104729) % (1 << 62)


class State:
    def __init__(self, ctx, mols):
        import molvoxel_torch

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.mols, self.batch = ctx, mols, int(tr["batch"])
        self.vox = molvoxel_torch.create_voxelizer(resolution=cfg["resolution"], dimension=cfg["dimension"],
                                                   density_type=cfg["density"], sigma=cfg["sigma"],
                                                   device=ctx.device)
        self.out_dtype = ctx.out_dtype()
        self.kept = Reservoir(int(tr["check_calls"]), ctx.seed)
        c, d = int(cfg["num_channels"]), int(cfg["dimension"])
        self.channels, self.voxels = c, c * d**3

    def members(self, k: int) -> list[int]:
        return [(k * self.batch + j) % len(self.mols) for j in range(self.batch)]

    def call(self, k: int):
        cfg, spans = self.ctx.config, self.ctx.spans
        with spans("inputs"):
            picked = [self.mols[i] for i in self.members(k)]
            clouds = [(m[0], m[1]) for m in picked]
            centers = [m[2] for m in picked]
        t0 = time.perf_counter()
        with spans("api"):
            out = self.vox.forward_batch(clouds, radii=float(cfg["radii"]), centers=centers,
                                         random_translation=float(cfg["random_translation"]),
                                         random_rotation=bool(cfg["random_rotation"]),
                                         key=key(self.ctx.seed, k), num_channels=self.channels,
                                         out_dtype=self.out_dtype)
        with spans("sync"):
            self.ctx.synchronize()
        return out, time.perf_counter() - t0

    def work(self, k: int) -> roofline.Work:
        atoms = sum(len(self.mols[i][1]) for i in self.members(k))
        return roofline.forward(atoms, atoms, self.batch, self.batch * self.voxels,
                                getattr(torch, self.out_dtype).itemsize)


def setup(ctx) -> State:
    mols = ctx.source().molecules(ctx.root, ctx.config, ctx.seed)
    ctx.mark("inputs")
    state = State(ctx, mols)
    # warm up on the window's shapes: every molecule bucket the cycle meets, holding as
    # many grids as the window keeps, so that the window allocates nothing new
    sizes = {}
    for k in range(-(-len(mols) // state.batch) + 1):
        sizes.setdefault(_bucket(max(len(mols[i][1]) for i in state.members(k))), k)
    held = [state.call(k)[0] for k in sizes.values()]
    held += [state.call(-1 - i)[0] for i in range(state.kept.k + 2)]
    del held
    ctx.synchronize()
    ctx.mark("warmup")
    return state


def _bucket(n: int) -> int:
    return 32 if n <= 32 else 64 if n <= 64 else n


def window(state: State, seconds: float) -> Window:
    calls_s, k = [], 0
    t0 = time.perf_counter()
    while True:
        out, dt = state.call(k)
        calls_s.append(dt)
        state.kept.offer((k, out))
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    work = sum((state.work(i) for i in range(k)), roofline.Work())
    return Window(elapsed, k * state.batch, calls_s, k, work)


def after(state: State, traced: bool) -> dict:
    state.vox = None
    return {}


def check(state: State) -> Verdict:
    ctx, cfg = state.ctx, state.ctx.config
    dev = "cpu" if ctx.device == "cpu" else "cuda"
    worst, failed, pairs, atoms = 0.0, 0, 0, 0
    limit = float(ctx.limits["grid_err"])
    d = int(cfg["dimension"])
    for k, out in state.kept.items:
        rot, shift = recipe.draw(recipe.generator(key(ctx.seed, k)), state.batch,
                                 float(cfg["random_translation"]), bool(cfg["random_rotation"]))
        xyz, mol, chan = [], [], []
        for j, i in enumerate(state.members(k)):
            coords, types, center = state.mols[i]
            xyz.append(recipe.place(coords, center, rot[j], shift[j]))
            mol.append(np.full(len(types), j))
            chan.append(types)
        xyz = torch.as_tensor(np.concatenate(xyz), dtype=torch.float64, device=dev)
        lo, hi, n_pairs = ref_grid.deposit(
            xyz, torch.as_tensor(np.concatenate(mol), device=dev), torch.as_tensor(np.concatenate(chan), device=dev),
            torch.ones(xyz.shape[0], dtype=torch.float64, device=dev), batch=state.batch,
            channels=state.channels, dim=d, res=float(cfg["resolution"]), sigma=float(cfg["sigma"]),
            radius=float(cfg["radii"]), band=ref_grid.BAND)
        err = ref_grid.interval_excess(out, lo, hi) if tuple(out.shape) == tuple(lo.shape) else float("inf")
        worst = max(worst, err)
        failed += not err <= limit
        pairs += n_pairs
        atoms += xyz.shape[0]
        del lo, hi
    return Verdict([Check("grid_err", worst, limit)], failed, pairs / atoms if atoms else None)
