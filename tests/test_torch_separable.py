"""gaussian_notrunc in molvoxel_torch against molvoxel_tpu on the CPU: the
separable product, the notrunc threshold row on the deposit kernels' plain
versions, the routing rule, the two torch-reference goldens through the
public API, on the same numpy inputs."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch import create_voxelizer
from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.ops import deposit, separable
from molvoxel_torch.ops.voxelize import (
    NOTRUNC_KERNEL_MIN_ATOMS,
    NOTRUNC_KERNEL_MIN_DEPTH,
    NOTRUNC_KERNEL_MIN_DIM,
    notrunc_use_kernel,
)
from molvoxel_torch.ops.voxelize import voxelize as torch_voxelize
from molvoxel_torch.ops.batch import voxelize_batch
from molvoxel_torch.ops.dense import voxelize_dense
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.ops.voxelize import (
    NOTRUNC_PALLAS_MIN_ATOMS,
    NOTRUNC_PALLAS_MIN_DEPTH,
    NOTRUNC_PALLAS_MIN_DIM,
    notrunc_use_pallas,
)
from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch
from molvoxel_tpu.ops.separable import voxelize_separable_batch as jax_separable_batch
from molvoxel_tpu.ops.separable import voxelize_separable_batch_channelwise as jax_separable_batch_channelwise

ROOT = Path(__file__).resolve().parents[1]
TORCHREF = sorted(p for p in (ROOT / "tests" / "goldens").glob("*.npz")
                  if str(np.load(p)["density"]) == "gaussian_notrunc")


def _cloud(rng, b=2, v=90, c=3, box=3.0, n_pad=10):
    coords = rng.uniform(-box, box, size=(b, v, 3)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=(b, v, c)).astype(np.float32)
    mask = np.ones((b, v), bool)
    mask[:, v - n_pad:] = False
    return coords, weights, mask


@pytest.mark.parametrize("variant", ["shared", "batched", "slab", "bf16"])
def test_separable_batch_matches_jax(rng, variant):
    coords, weights, mask = _cloud(rng)
    radii = rng.uniform(0.8, 1.5, size=(2, 90) if variant == "batched" else (90,)).astype(np.float32)
    kw = dict(sigma=0.5)
    if variant == "slab":
        kw.update(d_offset=4, d_count=6)
    out_dtype = "bfloat16" if variant == "bf16" else "float32"
    got = separable.voxelize_separable_batch(torch.as_tensor(coords), torch.as_tensor(weights),
                                             torch.as_tensor(radii), spec=TSpec(0.5, 16), mask=torch.as_tensor(mask),
                                             out_dtype=out_dtype, **kw)
    want = np.asarray(jax_separable_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
                                          spec=JSpec(0.5, 16), mask=jnp.asarray(mask), out_dtype=out_dtype, **kw),
                      np.float32)
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == want.shape
    tol = 2**-7 * max(np.abs(want).max(), 1.0) if variant == "bf16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_separable_channelwise_matches_jax(rng):
    coords, weights, mask = _cloud(rng)
    radii = np.asarray([0.8, 1.1, 1.6], np.float32)
    got = separable.voxelize_separable_batch_channelwise(torch.as_tensor(coords), torch.as_tensor(weights),
                                                         torch.as_tensor(radii), spec=TSpec(0.5, 16),
                                                         mask=torch.as_tensor(mask), d_offset=2, d_count=9)
    want = jax_separable_batch_channelwise(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
                                           spec=JSpec(0.5, 16), mask=jnp.asarray(mask), d_offset=2, d_count=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("channelwise", [False, True])
def test_separable_gradients_match_jax(rng, channelwise):
    coords, weights, mask = _cloud(rng, b=1, v=20, c=2, n_pad=4)
    radii = np.asarray([0.9, 1.3], np.float32) if channelwise else rng.uniform(0.8, 1.5, (20,)).astype(np.float32)
    target = rng.normal(size=(1, 2, 12, 12, 12)).astype(np.float32)
    fn_t = separable.voxelize_separable_batch_channelwise if channelwise else separable.voxelize_separable_batch
    fn_j = jax_separable_batch_channelwise if channelwise else jax_separable_batch
    leaves = [torch.tensor(a, requires_grad=True) for a in (coords, weights, radii)]
    out = fn_t(*leaves, spec=TSpec(0.5, 12), mask=torch.as_tensor(mask))
    got = torch.autograd.grad((out * torch.as_tensor(target)).sum(), leaves)

    def loss(c, w, r):
        return jnp.sum(fn_j(c, w, r, spec=JSpec(0.5, 12), mask=jnp.asarray(mask)) * target)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii))
    for g, w in zip(got, want):
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4 * scale)


def test_notrunc_threshold_row_matches_pallas_and_separable(rng):
    """The notrunc threshold row on the deposit kernels' plain version
    against the JAX package's pruned Pallas kernel, and against the
    separable product (tools/round_gate.py:189-204), at 2e-5."""
    b, v, c, dim = 1, 300, 4, 24
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask = _cloud(rng, b, v, c, spec_t.width / 2, n_pad=44)
    radii = np.ones((v,), np.float32)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(
        torch.as_tensor(coords), torch.as_tensor(weights), torch.as_tensor(radii), spec=spec_t,
        density_type="gaussian_notrunc", mask=torch.as_tensor(mask))
    got = deposit.deposit_plain(rows, wt, ranges, spec=spec_t, dl=dl, gaussian=gaussian).reshape(b, c, dl, dim, dim)
    want = voxelize_pallas_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), spec=spec_j,
                                 density_type="gaussian_notrunc", sigma=0.5, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    sep = jax_separable_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), spec=spec_j,
                              mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(sep), rtol=0, atol=2e-5)


def test_notrunc_routing_rule_matches_jax():
    assert (NOTRUNC_KERNEL_MIN_ATOMS, NOTRUNC_KERNEL_MIN_DEPTH, NOTRUNC_KERNEL_MIN_DIM) == (
        NOTRUNC_PALLAS_MIN_ATOMS, NOTRUNC_PALLAS_MIN_DEPTH, NOTRUNC_PALLAS_MIN_DIM)
    for atoms in (61, 1023, 1024, 4096):
        for dim in (32, 96, 128, 192, 256):
            for dl in (None, 16, 95, 96):
                assert notrunc_use_kernel(atoms, dim, dl) == notrunc_use_pallas(atoms, dim, dl)


def test_notrunc_routes_separable_on_auto_and_dense_on_request(rng):
    coords, weights, mask = _cloud(rng, b=2, v=40, c=2, n_pad=5)
    c_t, w_t, m_t = map(torch.as_tensor, (coords, weights, mask))
    spec = TSpec(0.5, 12)
    radii = torch.ones(40)
    kw = dict(spec=spec, density_type="gaussian_notrunc")
    auto = voxelize_batch(c_t, w_t, radii, m_t, None, **kw)
    assert torch.equal(auto, separable.voxelize_separable_batch(c_t, w_t, radii, spec=spec, mask=m_t))
    dense = voxelize_batch(c_t, w_t, radii, m_t, None, impl="dense", **kw)
    assert torch.equal(dense[1], voxelize_dense(c_t[1], w_t[1], radii, mask=m_t[1], **kw))
    single = torch_voxelize(c_t[0], w_t[0], radii, mask=m_t[0], **kw)
    assert torch.equal(single, separable.voxelize_separable(c_t[0], w_t[0], radii, spec=spec, mask=m_t[0]))
    np.testing.assert_allclose(auto.numpy(), dense.numpy(), rtol=0, atol=2e-5)


def test_torchref_golden_set_is_the_two_notrunc_goldens():
    assert [p.stem for p in TORCHREF] == ["lig_features_gaussian_torchref", "lig_types_gaussian_torchref"]


@pytest.mark.parametrize("golden_path", TORCHREF, ids=[p.stem for p in TORCHREF])
def test_torchref_golden_parity_cpu(golden_path):
    g = np.load(golden_path, allow_pickle=False)
    vox = create_voxelizer(resolution=float(g["resolution"]), dimension=int(g["dimension"]),
                           radii_type=str(g["radii_type"]), density_type=str(g["density"]),
                           sigma=float(g["sigma"]), device="cpu")
    radii = float(g["radii"]) if g["radii"].ndim == 0 else g["radii"]
    center = g["center"] if g["center"].size else None
    if str(g["mode"]) == "features":
        out = vox.forward_features(g["coords"], center, g["channels"].astype(np.float32), radii)
    else:
        out = vox.forward_types(g["coords"], center, g["channels"].astype(np.int32), radii)
    assert out.dtype == torch.float32 and tuple(out.shape) == g["expected"].shape
    np.testing.assert_allclose(out.numpy(), g["expected"], rtol=0, atol=5e-5)


def test_notrunc_through_every_public_forward(rng):
    """forward_single / _types / _features / _batch with gaussian_notrunc
    against the JAX package's separable product on the same padded inputs."""
    coords = rng.uniform(-3, 3, size=(30, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, size=(30, 2)).astype(np.float32)
    types = np.asarray([0, 1] * 15)
    vox = create_voxelizer(resolution=0.5, dimension=12, density_type="gaussian_notrunc", device="cpu")
    spec_j = JSpec(0.5, 12)

    def jax_ref(w):
        return np.asarray(jax_separable_batch(jnp.asarray(coords)[None], jnp.asarray(w)[None],
                                              jnp.ones((30,), jnp.float32), spec=spec_j))[0]

    np.testing.assert_allclose(vox.forward_single(coords, None, 1.0).numpy(), jax_ref(np.ones((30, 1), np.float32)),
                               atol=2e-5)
    np.testing.assert_allclose(vox.forward_types(coords, None, types, 1.0).numpy(),
                               jax_ref(np.eye(2, dtype=np.float32)[types]), atol=2e-5)
    np.testing.assert_allclose(vox.forward_features(coords, None, feats, 1.0).numpy(), jax_ref(feats), atol=2e-5)
    batch = vox.forward_batch([(coords, feats), (coords, feats)], radii=1.0)
    np.testing.assert_allclose(batch[1].numpy(), jax_ref(feats), atol=2e-5)
