"""The tile forward kernel against the brick kernel, on the card.

Molecules of more than one chunk take the tile launch (``deposit_fwd_tile``,
ranges at ``deposit.range_rows``); the brick launch (``deposit_fwd``) still
computes the same function on them from ranges at its own rows.  Both entry
points run here on the same prepared atom rows and weights: the grids must be
equal bit for bit (the same arithmetic in the same order), and so must two
tile launches, and the plan route (the preparation kernel writing the ranges
at the tile rows, then the tile launch); and the grids lie within the
working type's bar of ``deposit_plain`` on the same rows and ranges.
Cases: gaussian, binary and threshold rows; f32, bf16 and fp8 grids; dims
20, 33, 48 and 128 (20 and 33 with ragged rows); batches of 1 and 16; 1, 3
and 8 channels; 16 proteins at 128^3 with 1 and 2 channels, a launch that
takes wide lanes; atom-wise radii and masked atoms in every case; and the
10gs complex in a 48^3 box on its ligand, most of its atoms outside.

Marked ``card``: each test skips without a CUDA card.  On the card, with no
JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_tile_card.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.ops import deposit

pytestmark = pytest.mark.card

GOLDENS = Path(__file__).parent / "goldens"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
DENSITIES = ["gaussian", "binary", "gaussian_notrunc"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m card tests/test_torch_tile_card.py)")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(name: str, b: int, c: int, dev, seed: int):
    """(coords (B, V, 3), weights (B, V, C), radii (B, V), mask (B, V),
    centers (B, 3), (quaternions, translations)) on ``dev``: the 10gs protein
    on its own mean ("protein"), or the 10gs ligand and protein on the
    ligand's mean ("complex"); each molecule under its own rotation and a
    translation of up to 0.5 A, atom-wise radii, one atom in eight masked,
    and weights that leave some atoms out of some channels."""
    rng = np.random.default_rng(seed)
    prot = np.load(GOLDENS / "protein_single_gaussian.npz")["coords"].astype(np.float32)
    if name == "complex":
        lig = np.load(GOLDENS / "lig_types_gaussian.npz")
        xyz, center = np.concatenate([lig["coords"].astype(np.float32), prot]), lig["center"].astype(np.float32)
    else:
        xyz, center = prot, prot.astype(np.float64).mean(0).astype(np.float32)
    v = len(xyz)
    weights = (rng.uniform(size=(b, v, c)) < 0.6) * rng.uniform(0.5, 1.0, (b, v, c))
    q = rng.normal(size=(b, 4))
    arrays = (np.broadcast_to(xyz, (b, v, 3)), weights, rng.uniform(0.7, 1.6, (b, v)),
              np.broadcast_to(center, (b, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
              rng.uniform(-0.5, 0.5, (b, 3)))
    coords, weights, radii, centers, quat, shift = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                                                    device=dev) for a in arrays)
    mask = torch.as_tensor(rng.uniform(size=(b, v)) >= 0.125, device=dev)
    return coords, weights, radii, mask, centers, (quat, shift)


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def _bar(odt, ref: torch.Tensor) -> float:
    """How far a grid of ``odt`` may lie from the f32 plain grid: 1e-5 in
    f32, half a unit of the largest value in bf16 (2^-7) and fp8 (2^-3)."""
    scale = max(float(ref.abs().max()), 1.0)
    return {torch.float32: 1e-5, torch.bfloat16: 2**-7 * scale, torch.float8_e4m3fn: 2**-3 * scale}[odt]


def _check(card, name, density, odt, dim, b, c, seed, wide=None):
    spec = GridSpec(0.5, dim)
    coords, weights, radii, mask, centers, transforms = _inputs(name, b, c, card, seed)
    kw = dict(spec=spec, density_type=density, mask=mask, centers=centers, transforms=transforms)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, weights, radii, **kw)
    vp = rows.shape[2]
    assert deposit.fwd_tiles(vp) and ranges.shape[1] == -(-dim // deposit.TILE_RANGE_ROWS)
    if wide is not None:  # the lanes the launch takes: wide ones span twice a narrow lane's w
        lanes = deposit.tile_launch(b, vp, c, dl, spec, gaussian, odt, density == "gaussian_notrunc")[1][-5]
        assert lanes == (2 if wide else 1) * (16 if odt.itemsize == 1 else 8)
    before = deposit.launches["deposit_fwd_tile"]
    notrunc = density == "gaussian_notrunc"
    tile = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt, notrunc=notrunc)
    again = deposit.deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=odt,
                                notrunc=notrunc)
    assert deposit.launches["deposit_fwd_tile"] == before + 2
    # the brick kernel's entry point on the same rows, from ranges at its own rows
    ht = deposit.brick_rows(b, c, dl, dim)[1]
    brick_ranges = deposit.plane_ranges(rows[:, :3].transpose(1, 2), rows[:, 3], spec, dl, ht)
    brick = torch.empty_like(tile)
    deposit._launch_fwd(card.index, deposit.brick_launch(b, vp, c, dl, spec, gaussian, odt), brick, rows.data_ptr(),
                        wt.data_ptr(), brick_ranges.data_ptr())
    planned = deposit.voxelize_deposit_batch(coords, weights, radii, out_dtype=odt, **kw)
    torch.cuda.synchronize()
    assert _same_bits(tile, brick), float((tile.float() - brick.float()).abs().max())
    assert _same_bits(tile, again) and _same_bits(planned.reshape(tile.shape), tile)
    assert float(tile.float().abs().amax()) > 0
    # and against the kernel's function in torch ops, on the same rows and ranges
    ref = deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian)
    err = float((tile.float() - ref.to(odt).float()).abs().max())
    assert err <= _bar(odt, ref), err


@pytest.mark.parametrize("b,c", [(1, 1), (16, 3), (16, 8)])
@pytest.mark.parametrize("dim", [20, 33, 48, 128])
@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("density", DENSITIES)
def test_tile_grids_equal_the_brick_kernels(card, density, out, dim, b, c):
    _check(card, "protein", density, DTYPES[out], dim, b, c, seed=1000 * dim + 10 * b + c)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("density", DENSITIES)
def test_tile_grids_equal_the_brick_kernels_on_wide_lanes(card, density, out, c):
    # 16 proteins at 128^3 (the protein cell's launch): wide lanes wherever
    # the channel group fits their accumulators (all but fp8 at C = 2), at
    # the exact reach; threshold rows keep narrow lanes
    odt = DTYPES[out]
    lane_w = 16 if odt.itemsize == 1 else 8
    _check(card, "protein", density, odt, 128, 16, c, seed=2000 + c,
           wide=c * 2 * lane_w <= deposit.ACC_MAX and density != "gaussian_notrunc")


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("density", DENSITIES)
def test_tile_grids_equal_the_brick_kernels_on_a_complex_mostly_outside(card, density, out):
    _check(card, "complex", density, DTYPES[out], 48, 16, 1, seed=7)
