"""molvoxel_torch.core against molvoxel_tpu.core: geometry, buckets, densities,
transforms and the state carried across (inputs made with numpy, on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core import config as tcfg
from molvoxel_torch.core import density as tden
from molvoxel_torch.core import state as tstate
from molvoxel_torch.core import transform as ttf
from molvoxel_torch.ops.dense import _axis_positions as t_axis
from molvoxel_tpu.core import config as jcfg
from molvoxel_tpu.core import density as jden
from molvoxel_tpu.core import transform as jtf
from molvoxel_tpu.ops.dense import _axis_positions as j_axis

SPECS = [(0.5, 48), (0.5, 64), (0.25, 32), (0.375, 20), (1.0, 7)]


@pytest.mark.parametrize("res,dim", SPECS)
def test_axis_positions_bitwise(res, dim):
    for offset, count in ((0, None), (5, 9), (dim - 3, 3)):
        want = np.asarray(j_axis(jcfg.GridSpec(res, dim), jnp.float32, offset, count))
        got = t_axis(tcfg.GridSpec(res, dim), torch.float32, offset, count).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res,dim", SPECS)
def test_gridspec_geometry(res, dim):
    t, j = tcfg.GridSpec(res, dim), jcfg.GridSpec(res, dim)
    assert (t.width, t.lower_bound, t.upper_bound, t.num_voxels) == (j.width, j.lower_bound, j.upper_bound,
                                                                     j.num_voxels)
    assert t.grid_dimension(5) == j.grid_dimension(5)
    np.testing.assert_array_equal(t.axis(), j.axis())


def test_buckets_match():
    for n in list(range(0, 300)) + [383, 384, 385, 767, 768, 769, 3262, 4096, 4097, 10000]:
        assert tcfg.atom_bucket(n) == jcfg.atom_bucket(n)
        assert tcfg.small_atom_bucket(n) == jcfg.small_atom_bucket(n)
        assert tcfg.round_up(n, 64) == jcfg.round_up(n, 64)


def test_config_validation():
    with pytest.raises(ValueError):
        tcfg.VoxelizerConfig(radii_type="bogus")
    with pytest.raises(ValueError):
        tcfg.GridSpec(0.5, 0)


@pytest.mark.parametrize("sigma", [0.5, 1.0])
def test_densities_match(rng, sigma):
    d2 = rng.uniform(0.0, 4.0, size=(500,)).astype(np.float32)
    r2 = rng.uniform(0.5, 3.0, size=(500,)).astype(np.float32)
    d2[:20] = r2[:20]  # on the boundary: inclusive
    got = tden.gaussian_sq(torch.as_tensor(d2), torch.as_tensor(r2), sigma).numpy()
    want = np.asarray(jden.gaussian_sq(jnp.asarray(d2), jnp.asarray(r2), sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert (got[:20] > 0).all()
    got_b = tden.binary_sq(torch.as_tensor(d2), torch.as_tensor(r2)).numpy()
    np.testing.assert_array_equal(got_b, np.asarray(jden.binary_sq(jnp.asarray(d2), jnp.asarray(r2))))
    with pytest.raises(ValueError):
        tden.density_sq(torch.as_tensor(d2), torch.as_tensor(r2), "bogus", sigma)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quaternion_to_matrix(rng):
    for q in _unit_quats(rng, 10):
        got = ttf.quaternion_to_matrix(torch.as_tensor(q)).numpy()
        want = np.asarray(jtf.quaternion_to_matrix(jnp.asarray(q)))
        np.testing.assert_allclose(got, want, atol=1e-6)
    qs = _unit_quats(rng, 4)
    batched = ttf.quaternion_to_matrix(torch.as_tensor(qs)).numpy()
    for i in range(4):
        np.testing.assert_allclose(batched[i], np.asarray(jtf.quaternion_to_matrix(jnp.asarray(qs[i]))), atol=1e-6)


@pytest.mark.parametrize("with_center", [False, True])
def test_do_transform(rng, with_center):
    coords = rng.uniform(-5, 5, size=(40, 3)).astype(np.float32)
    q = _unit_quats(rng, 1)[0]
    t = rng.uniform(-1, 1, size=(3,)).astype(np.float32)
    center = rng.uniform(-2, 2, size=(3,)).astype(np.float32) if with_center else None
    got = ttf.do_transform(torch.as_tensor(coords), None if center is None else torch.as_tensor(center),
                           torch.as_tensor(t), torch.as_tensor(q)).numpy()
    want = np.asarray(jtf.do_transform(jnp.asarray(coords), None if center is None else jnp.asarray(center),
                                       jnp.asarray(t), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_random_transforms_follow_the_generator():
    q = ttf.random_quaternion(torch.Generator().manual_seed(3), (100,))
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    a = ttf.Transform.create(torch.Generator().manual_seed(5), 0.5, True)
    b = ttf.Transform.create(torch.Generator().manual_seed(5), 0.5, True)
    assert torch.equal(a.quaternion, b.quaternion) and torch.equal(a.translation, b.translation)
    assert float(a.translation.abs().max()) <= 0.5
    ident = ttf.RandomTransform(0.0, False).get_transform(torch.Generator().manual_seed(1))
    assert ident.quaternion is None and ident.translation is None
    coords = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    moved = ttf.RandomTransform(0.5, True)(torch.Generator().manual_seed(9), coords)
    # a rigid motion keeps pairwise distances
    np.testing.assert_allclose(torch.cdist(moved, moved).numpy(), torch.cdist(coords, coords).numpy(), atol=1e-5)


def test_config_from_dict_takes_jax_config():
    jc = jcfg.VoxelizerConfig(grid=jcfg.GridSpec(0.375, 40), radii_type="atom-wise", density_type="binary",
                              sigma=0.7, precision=64)
    tc = tstate.config_from_dict(jc.to_dict())
    assert tc.to_dict() == jc.to_dict()
    assert tc == tcfg.VoxelizerConfig.from_dict(jc.to_dict())


def test_transform_from_arrays_takes_jax_transform(rng):
    jt = jtf.Transform.create(jax.random.PRNGKey(11), random_translation=0.5, random_rotation=True)
    tt = tstate.transform_from_arrays(np.asarray(jt.quaternion), np.asarray(jt.translation))
    coords = rng.uniform(-5, 5, size=(30, 3)).astype(np.float32)
    center = rng.uniform(-1, 1, size=(3,)).astype(np.float32)
    want = np.asarray(jt(jnp.asarray(coords), jnp.asarray(center)))
    got = tt(torch.as_tensor(coords), torch.as_tensor(center)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    only_t = tstate.transform_from_arrays(None, np.asarray(jt.translation))
    assert only_t.quaternion is None
