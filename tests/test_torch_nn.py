"""molvoxel_torch.nn against molvoxel_tpu.nn (flax) on the CPU: the voxelize
layer, the CNN with its parameters carried across by load_flax_params, and
the gradient to coordinates through both, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.nn import VoxelCNN, VoxelizeLayer, _same_pad, load_flax_params
from molvoxel_tpu.core.config import GridSpec as JSpec

flax_nn = pytest.importorskip("molvoxel_tpu.nn")

WIDTHS, FEATURES = (4, 8, 8), 8


def _batch(rng, b=2, vp=128, v=12, c=3):
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-2, 2, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    return coords, weights, mask


def _jax_cnn(grids):
    cnn = flax_nn.VoxelCNN(features=FEATURES, widths=WIDTHS)
    return cnn, cnn.init(jax.random.PRNGKey(0), jnp.asarray(grids))


def test_same_padding_is_flax_same():
    assert _same_pad(16) == (0, 1) and _same_pad(8) == (0, 1) and _same_pad(15) == (1, 1) and _same_pad(1) == (1, 1)


def test_voxelize_layer_matches_jax_and_is_deterministic(rng):
    coords, weights, mask = _batch(rng)
    layer = VoxelizeLayer(TSpec(0.5, 16))
    args = tuple(map(torch.as_tensor, (coords, weights, mask)))
    got = layer(*args)
    assert got.shape == (2, 3, 16, 16, 16) and torch.equal(got, layer(*args))
    jlayer = flax_nn.VoxelizeLayer(spec=JSpec(0.5, 16))
    want = jlayer.apply({}, jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # augmentation only with a generator: seeded, reproducible, and a real transform
    aug = VoxelizeLayer(TSpec(0.5, 16), augment=True, random_translation=0.5)
    assert torch.equal(aug(*args), got)
    a = aug(*args, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, aug(*args, generator=torch.Generator().manual_seed(1)))
    assert not torch.allclose(a, aug(*args, generator=torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("dim", [16, 15])
def test_cnn_with_flax_params_matches_jax(rng, dim):
    grids = rng.uniform(0, 1, size=(2, 3, dim, dim, dim)).astype(np.float32)
    cnn, params = _jax_cnn(grids)
    want = np.asarray(cnn.apply(params, jnp.asarray(grids)))
    model = load_flax_params(VoxelCNN(in_channels=3, features=FEATURES, widths=WIDTHS), params)
    got = model(torch.as_tensor(grids))
    assert got.shape == (2, FEATURES)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_gradients_flow_through_layer_and_cnn_as_in_jax(rng):
    """tests/test_nn.py:49-61 on both packages: d sum(cnn(layer(coords))) /
    d coords, at the backward bar 5e-3."""
    coords, weights, mask = _batch(rng)
    jlayer = flax_nn.VoxelizeLayer(spec=JSpec(0.5, 16))
    cnn, params = _jax_cnn(jlayer.apply({}, jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(mask)))

    def jloss(crd):
        return jnp.sum(cnn.apply(params, jlayer.apply({}, crd, jnp.asarray(weights), jnp.asarray(mask))))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(coords)))
    model = load_flax_params(VoxelCNN(in_channels=3, features=FEATURES, widths=WIDTHS), params)
    c_t = torch.tensor(coords, requires_grad=True)
    loss = model(VoxelizeLayer(TSpec(0.5, 16))(c_t, torch.as_tensor(weights), torch.as_tensor(mask))).sum()
    (got,) = torch.autograd.grad(loss, (c_t,))
    assert np.all(np.isfinite(got.numpy())) and float(got[:, :12].abs().max()) > 0
    assert not got[:, 12:].any()  # masked atoms
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)


def test_load_flax_params_accepts_the_inner_dict(rng):
    grids = rng.uniform(0, 1, size=(1, 2, 8, 8, 8)).astype(np.float32)
    _, params = _jax_cnn(grids)
    a = load_flax_params(VoxelCNN(2, FEATURES, WIDTHS), params)
    b = load_flax_params(VoxelCNN(2, FEATURES, WIDTHS), params["params"])
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.convs[0].weight.shape == (WIDTHS[0], 2, 3, 3, 3) and a.dense.weight.shape == (FEATURES, WIDTHS[-1])


def test_readme_training_snippet(rng):
    """The README's training snippet, on CPU tensors at 16^3."""
    coords, weights, mask = _batch(rng, c=4)
    coords = torch.tensor(coords, requires_grad=True)
    weights = torch.tensor(weights, requires_grad=True)
    layer = VoxelizeLayer(TSpec(0.5, 16), augment=True, random_translation=0.5)
    cnn = VoxelCNN(in_channels=4)
    grids = layer(coords, weights, torch.as_tensor(mask), generator=torch.Generator().manual_seed(0))
    assert grids.shape == (2, 4, 16, 16, 16)
    loss = cnn(grids).square().mean()
    loss.backward()
    assert float(coords.grad[:, :12].abs().max()) > 0 and float(weights.grad[:, :12].abs().max()) > 0
