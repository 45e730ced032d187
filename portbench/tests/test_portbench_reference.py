"""The plain reference against brute force, and its frozen recipe against the draws it copies."""

import numpy as np
import pytest
import torch

from portbench.reference import grid, recipe


def brute(xyz, mol, chan, w, *, batch, channels, dim, res, sigma, radius):
    """Every (atom, voxel) pair, one by one."""
    lower = -res * (dim - 1) / 2.0
    out = np.zeros((batch, channels, dim, dim, dim))
    for a in range(len(xyz)):
        for i in range(dim):
            for j in range(dim):
                for k in range(dim):
                    d2 = sum((xyz[a][n] - (lower + (i, j, k)[n] * res)) ** 2 for n in range(3))
                    if d2 <= radius * radius:
                        out[mol[a], chan[a], i, j, k] += w[a] * np.exp(-0.5 * d2 / (radius**2 * sigma**2))
    return out


@pytest.mark.parametrize("radius,sigma,res", [(1.0, 0.5, 0.5), (1.3, 0.7, 0.4)])
def test_deposit_matches_brute_force(radius, sigma, res):
    rng = np.random.default_rng(3)
    dim, n = 8, 12
    xyz = rng.uniform(-2.2, 2.2, (n, 3))
    mol, chan, w = rng.integers(0, 2, n), rng.integers(0, 3, n), rng.uniform(0.5, 1.5, n)
    kw = dict(batch=2, channels=3, dim=dim, res=res, sigma=sigma, radius=radius)
    want = brute(xyz, mol, chan, w, **kw)
    lo, hi, pairs = grid.deposit(torch.as_tensor(xyz), torch.as_tensor(mol), torch.as_tensor(chan),
                                 torch.as_tensor(w), **kw)
    assert hi is None
    np.testing.assert_allclose(lo.numpy(), want, rtol=1e-12, atol=1e-14)
    assert pairs == int(sum((brute(xyz[a:a + 1], [0], [0], [1.0], **{**kw, "batch": 1, "channels": 1}) > 0).sum()
                            for a in range(n)))
    lo2, hi2, _ = grid.deposit(torch.as_tensor(xyz), torch.as_tensor(mol), torch.as_tensor(chan),
                               torch.as_tensor(w), band=1e-4, **kw)
    assert grid.interval_excess(torch.as_tensor(want), lo2, hi2) <= 1e-12


def test_interval_admits_a_pair_on_the_cutoff():
    """An atom exactly one radius from a voxel: both sides of the cutoff pass,
    anything else fails."""
    xyz = torch.tensor([[0.25 + 1.0, 0.25, 0.25]], dtype=torch.float64)
    kw = dict(batch=1, channels=1, dim=4, res=0.5, sigma=0.5, radius=1.0, band=1e-4)
    one = torch.zeros(1, dtype=torch.long)
    lo, hi, _ = grid.deposit(xyz, one, one, torch.ones(1, dtype=torch.float64), **kw)
    voxel = (0, 0, 2, 2, 2)  # at (0.25, 0.25, 0.25)
    assert lo[voxel] == 0.0 and hi[voxel] == pytest.approx(np.exp(-2.0))
    for value, excess in ((0.0, 0.0), (float(np.exp(-2.0)), 0.0), (0.5, 0.5 - np.exp(-2.0))):
        g = lo.clone()
        g[voxel] = value
        assert grid.interval_excess(g, lo, hi) == pytest.approx(excess)


def test_recipe_draws_as_the_port():
    """The frozen recipe reproduces the port's transforms from one key."""
    from molvoxel_torch.ops.batch import draw_transforms
    from molvoxel_torch.core.transform import quaternion_to_matrix

    q, t = draw_transforms(torch.Generator().manual_seed(77), 5, 0.5, True)
    rot, shift = recipe.draw(recipe.generator(77), 5, 0.5, True)
    np.testing.assert_allclose(rot, quaternion_to_matrix(q).double().numpy(), atol=1e-6)
    np.testing.assert_allclose(shift, t.double().numpy(), atol=1e-7)
