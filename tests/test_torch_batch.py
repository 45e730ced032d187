"""molvoxel_torch.ops.batch's packing and sliced assembly against the JAX package, on the CPU.

``_choose_pack`` / ``_choose_pack_separable`` and ``pick_slab_depth`` equal
the JAX package's tables; ``_packed_batch`` equals JAX's and the unpacked
batch at 1e-5; ``voxelize_batch_sliced`` equals JAX's without augmentation
at 1e-5 and, with rotation on, the port's own full-depth grid under the
same generator (the transform is drawn once for all slabs) exactly.  Dims
16-24, a few molecules from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.ops import batch as tbatch
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.ops import batch as jbatch


@pytest.mark.parametrize("vp", [32, 64, 96, 128, 200, 256])
def test_choose_pack_tables_equal_jax(vp):
    for c in range(1, 21):
        assert tbatch._choose_pack(vp, c) == jbatch._choose_pack(vp, c), (vp, c)
        assert tbatch._choose_pack_separable(vp, c) == jbatch._choose_pack_separable(vp, c), (vp, c)


@pytest.mark.parametrize("channels", range(1, 9))
def test_pick_slab_depth_equal_jax(channels):
    for dim in range(16, 513):
        got = tbatch.pick_slab_depth(GridSpec(0.5, dim), channels)
        assert got == jbatch.pick_slab_depth(JSpec(0.5, dim), channels), dim
    assert tbatch.pick_slab_depth(GridSpec(0.25, 256), channels) == 64
    assert tbatch.pick_slab_depth(GridSpec(0.5, 128), channels) is None


def _cloud(rng, b, vp, v, c, dim=16):
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-dim / 5, dim / 5, size=(b, v, 3))
    w = np.zeros((b, vp, c), np.float32)
    w[:, :v] = rng.uniform(0.1, 1.0, size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    mask[-1, v // 2:] = False  # a ragged molecule
    return coords, w, mask


@pytest.mark.parametrize("vp,c,b,batched", [(32, 1, 5, False), (32, 4, 3, True), (64, 2, 4, False),
                                            (64, 3, 2, True)])
def test_packed_batch_equals_jax_and_unpacked(vp, c, b, batched, rng):
    """Tolerance 1e-5 (f32) against the JAX package's _packed_batch and
    against the unpacked batch, on the dense path of both packages."""
    spec, jspec = GridSpec(0.5, 16), JSpec(0.5, 16)
    coords, w, mask = _cloud(rng, b, vp, vp - 7, c)
    radii = (rng.uniform(0.8, 1.5, size=(b, vp)) if batched else np.full((vp,), 1.2)).astype(np.float32)
    pack = tbatch._choose_pack(vp, c)
    assert pack > 1

    def tfn(crd, ww, r, mask=None):
        return tbatch.voxelize_batch(crd, ww, r, mask, None, spec=spec, impl="dense", radii_batched=r.ndim == 2)

    def jfn(crd, ww, r, mask=None):
        keys = jax.random.split(jax.random.PRNGKey(0), crd.shape[0])
        return jbatch.voxelize_batch(crd, ww, r, mask, None, keys, spec=jspec, impl="dense",
                                     radii_batched=r.ndim == 2)

    t = [torch.as_tensor(a) for a in (coords, w, radii, mask)]
    got = tbatch._packed_batch(tfn, *t, pack)
    want = jbatch._packed_batch(jfn, *(jnp.asarray(a) for a in (coords, w, radii, mask)), pack)
    unpacked = tfn(*t[:3], mask=t[3])
    assert got.shape == unpacked.shape == (b, c, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), rtol=0, atol=1e-5)


def test_separable_path_packs_and_equals_jax(rng):
    """gaussian_notrunc on the CPU runs the separable product, packed as
    _choose_pack_separable says (4 molecules of Vp 32 at C = 1), in both
    packages; 2e-5 (the notrunc bar)."""
    spec, jspec = GridSpec(0.5, 16), JSpec(0.5, 16)
    coords, w, mask = _cloud(rng, 6, 32, 25, 1)
    radii = np.full((32,), 1.0, np.float32)
    assert tbatch._choose_pack_separable(32, 1) == 4
    got = tbatch.voxelize_batch(*(torch.as_tensor(a) for a in (coords, w, radii, mask)), None, spec=spec,
                                density_type="gaussian_notrunc")
    keys = jax.random.split(jax.random.PRNGKey(0), 6)
    want = jbatch.voxelize_batch(*(jnp.asarray(a) for a in (coords, w, radii, mask)), None, keys, spec=jspec,
                                 density_type="gaussian_notrunc")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("vp,c", [(32, 1), (32, 4), (64, 1), (64, 4)])
def test_separable_deposit_packs_on_cpu_only(vp, c, rng, monkeypatch):
    """The separable half of ``_deposit`` packs by _choose_pack_separable
    on the CPU route and never on the CUDA route (the CUDA route is given
    CPU tensors here; the product runs the same).  Unpacked grids are bit
    for bit the plain separable call; packed within 1e-5 (f32) of it."""
    from molvoxel_torch.ops.separable import voxelize_separable_batch

    spec = GridSpec(0.5, 16)
    coords, w, mask = (torch.as_tensor(a) for a in _cloud(rng, 5, vp, vp - 7, c))
    radii = torch.ones(vp)
    packs = []
    real_packed = tbatch._packed_batch
    monkeypatch.setattr(tbatch, "_packed_batch", lambda *a: packs.append(a[-1]) or real_packed(*a))
    kw = dict(spec=spec, density_type="gaussian_notrunc", sigma=0.5, channelwise=False, separable=True,
              radii_batched=False, d_offset=0, d_count=None, odt=torch.float32, presorted=False)
    plain = voxelize_separable_batch(coords, w, radii, spec=spec, mask=mask)
    on_cuda = tbatch._deposit(coords, w, radii, mask, resolved="cuda", **kw)
    assert packs == [] and torch.equal(on_cuda, plain)
    on_cpu = tbatch._deposit(coords, w, radii, mask, resolved="dense", **kw)
    assert packs == [tbatch._choose_pack_separable(vp, c)] and packs[0] > 1
    np.testing.assert_allclose(on_cpu.numpy(), plain.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dim,slab,dtype", [(16, 8, "float32"), (24, 8, "float32"), (16, 4, "bfloat16")])
def test_sliced_equals_jax_without_augmentation(dim, slab, dtype, rng):
    """Tolerance 1e-5 (f32) / 2^-7 x max (bf16) against the JAX package's
    voxelize_batch_sliced; the result lands in the given numpy array (bf16
    grids in an int16 array of the same bits)."""
    spec, jspec = GridSpec(0.5, dim), JSpec(0.5, dim)
    coords, w, mask = _cloud(rng, 3, 32, 20, 2, dim)
    radii = np.full((32,), 1.0, np.float32)
    centers = rng.uniform(-0.5, 0.5, size=(3, 3)).astype(np.float32)
    out = np.zeros((3, 2, dim, dim, dim), np.float32 if dtype == "float32" else np.int16)
    got = tbatch.voxelize_batch_sliced(*(torch.as_tensor(a) for a in (coords, w, radii, mask, centers)), spec=spec,
                                       slab_depth=slab, out=out, out_dtype=dtype)
    assert got is out
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    want = np.asarray(jbatch.voxelize_batch_sliced(*(jnp.asarray(a) for a in (coords, w, radii, mask, centers)),
                                                   keys, spec=jspec, slab_depth=slab, out_dtype=dtype), np.float32)
    grid = torch.from_numpy(out).view(getattr(torch, dtype)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2**-7 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(grid, want, rtol=0, atol=tol)


@pytest.mark.parametrize("rotation,translation", [(True, 0.0), (True, 0.7), (False, 0.7)])
def test_sliced_with_augmentation_equals_full_depth(rotation, translation, rng, tmp_path):
    """The transform is drawn once for all slabs: with rotation on, the
    assembled grid equals the full-depth grid under the same generator
    (exactly; both are the same dense arithmetic), written into a memmap."""
    spec = GridSpec(0.5, 16)
    coords, w, mask = _cloud(rng, 3, 32, 24, 3)
    radii = np.full((32,), 1.1, np.float32)
    t = [torch.as_tensor(a) for a in (coords, w, radii, mask)]
    full = tbatch.voxelize_batch(*t, None, torch.Generator().manual_seed(11), translation, spec=spec,
                                 random_rotation=rotation)
    out = np.memmap(tmp_path / "grid.f32", dtype=np.float32, mode="w+", shape=(3, 3, 16, 16, 16))
    tbatch.voxelize_batch_sliced(*t, None, torch.Generator().manual_seed(11), translation, spec=spec, slab_depth=4,
                                 out=out, random_rotation=rotation)
    np.testing.assert_array_equal(np.asarray(out), full.numpy())
    # one slab per call with the generator drawn each time would differ
    g = torch.Generator().manual_seed(11)
    per_call = torch.cat([tbatch.voxelize_batch(*t, None, g, translation, spec=spec, random_rotation=rotation,
                                                d_offset=d0, d_count=4) for d0 in range(0, 16, 4)], dim=2)
    assert not torch.equal(per_call, full)


def test_sliced_rejects_bad_arguments(rng):
    spec = GridSpec(0.5, 16)
    coords, w, mask = _cloud(rng, 2, 32, 10, 1)
    t = [torch.as_tensor(a) for a in (coords, w, np.ones(32, np.float32), mask)]
    with pytest.raises(ValueError, match="not divisible"):
        tbatch.voxelize_batch_sliced(*t, None, spec=spec, slab_depth=5)
    with pytest.raises(ValueError, match="out must be"):
        tbatch.voxelize_batch_sliced(*t, None, spec=spec, slab_depth=8, out=np.zeros((2, 1, 8, 16, 16), np.float32))
    with pytest.raises(ValueError, match="2-byte items"):
        tbatch.voxelize_batch_sliced(*t, None, spec=spec, slab_depth=8, out_dtype="bfloat16",
                                     out=np.zeros((2, 1, 16, 16, 16), np.float32))
    with pytest.raises(TypeError, match="unexpected keywords"):
        tbatch.voxelize_batch_sliced(*t, None, spec=spec, slab_depth=8, d_count=4)
