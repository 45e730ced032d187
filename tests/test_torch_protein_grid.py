"""The whole 10gs protein through the port, on the CPU.

``Voxelizer.forward_batch`` on the 3,262-atom protein, the box on its own
mean, against the benchmark's plain float64 reference
(``portbench/reference``: the augmentation redrawn from the call's key,
every (atom, voxel) pair deposited again).  And the kernels' work counters,
``molvoxel.grid_bytes`` and ``molvoxel.sort_slots`` (ops/deposit.py),
under a profiler and outside one.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import molvoxel_torch
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.ops import deposit
from molvoxel_torch.utils import timing
from portbench.reference import grid as ref_grid
from portbench.reference import recipe

ROOT = Path(__file__).resolve().parents[1]
# A 64 A box, the protein's whole extent under any rotation, at a CPU's size.
DIM, RES, SIGMA, RADIUS, SHIFT = 32, 2.0, 0.5, 1.0, 0.5
# float32 rounding of sums of overlapping gaussians; the whole complex's highest
# reading on the card is 1.7e-5.  bf16's half unit at a voxel of 1 is 2e-3.
TOLERANCE = 1e-4
KEYS = (2**31 + 4242, 3758096417)


def molecule(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(coords (n, 3), their mean (3,)), float32, of a frozen molecule of the benchmark."""
    coords = np.load(ROOT / "portbench" / "data" / f"{name}.npz")["coords"].astype(np.float32)
    return coords, coords.astype(np.float64).mean(0).astype(np.float32)


def excess(b: int, key: int, out_dtype: str) -> float:
    """How far the worst voxel of ``b`` augmented proteins from
    ``forward_batch`` lies outside the reference's interval."""
    coords, center = molecule("protein_single_gaussian")
    types = np.zeros(len(coords), np.int64)
    vox = molvoxel_torch.create_voxelizer(resolution=RES, dimension=DIM, density_type="gaussian", sigma=SIGMA,
                                          device="cpu")
    out = vox.forward_batch([(coords, types)] * b, radii=RADIUS, centers=[center] * b, random_translation=SHIFT,
                            random_rotation=True, key=key, num_channels=1, out_dtype=out_dtype)
    rot, shift = recipe.draw(recipe.generator(key), b, SHIFT, True)
    xyz = torch.as_tensor(np.concatenate([recipe.place(coords, center, rot[j], shift[j]) for j in range(b)]))
    n = len(coords)
    lo, hi, pairs = ref_grid.deposit(xyz, torch.arange(b).repeat_interleave(n), torch.zeros(b * n, dtype=torch.int64),
                                     torch.ones(b * n, dtype=torch.float64), batch=b, channels=1, dim=DIM, res=RES,
                                     sigma=SIGMA, radius=RADIUS, band=ref_grid.BAND)
    assert tuple(out.shape) == tuple(lo.shape) and pairs > 0
    return ref_grid.interval_excess(out, lo, hi)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("b", [2, 3])
def test_forward_batch_on_the_whole_protein_matches_the_reference(b, key):
    assert excess(b, key, "float32") <= TOLERANCE


@pytest.mark.parametrize("key", KEYS)
def test_bf16_grids_of_the_whole_protein_exceed_the_tolerance(key):
    assert excess(2, key, "bfloat16") > TOLERANCE


@contextlib.contextmanager
def cpu_profile():
    """A CPU profiler session with a record of its own (the span before it
    finds no profiler, so the session's first event starts a new record)."""
    with timing.span("molvoxel.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        yield


SPEC = GridSpec(4.0, 16)
# (molecule, b, channels, out dtype, slots sorted): the protein's 3,262 atoms pad to 3,264 and sort; the
# ligand's 61 fill one chunk and do not
PROTEINS = ("protein_single_gaussian", 2, 1, "float32", 2 * 3264)
LIGANDS = ("lig_types_gaussian", 5, 4, "bfloat16", 0)


def prepare_and_deposit(name: str, b: int, c: int, out_dtype: str) -> torch.Tensor:
    coords = torch.as_tensor(molecule(name)[0])[None].repeat(b, 1, 1)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, torch.ones(b, coords.shape[1], c), 1.0,
                                                           spec=SPEC, centers=coords.mean(1))
    return deposit.deposit_fwd(rows, wt, ranges, spec=SPEC, dl=dl, gaussian=gaussian, out_dtype=out_dtype)


@pytest.mark.parametrize("batch", [PROTEINS, LIGANDS], ids=["proteins", "ligands"])
def test_work_counters_count_grid_bytes_and_sorted_slots(batch):
    name, b, c, out_dtype, sorted_slots = batch
    with cpu_profile():
        for _ in range(2):
            out = prepare_and_deposit(name, b, c, out_dtype)
    counters = timing.snapshot()["counters"]
    assert out.shape == (b, c, 16, 16 * 16)
    assert counters["molvoxel.grid_bytes"] == 2 * b * c * 16**3 * out.element_size()
    assert counters["molvoxel.sort_slots"] == 2 * sorted_slots


def test_work_counters_stay_unset_outside_a_profiler():
    with cpu_profile():
        timing.count("molvoxel.marker")
    prepare_and_deposit(*PROTEINS[:4])
    assert timing.snapshot()["counters"] == {"molvoxel.marker": 1}
