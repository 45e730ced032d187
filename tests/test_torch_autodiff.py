"""Gradients of molvoxel_torch against molvoxel_tpu on the CPU.

The plain backward (``deposit_bwd_plain``, the CUDA backward kernel's plain
version) is held against autograd of the plain forward; the differentiable
deposit (the autograd.Function running both plain versions on CPU tensors)
against the JAX package's Pallas backward (interpret mode) and the VJP of its
``voxelize(impl="pallas")``, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.core.transform import apply_quaternion, do_transform
from molvoxel_torch.ops import deposit
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.core.config import atom_bucket
from molvoxel_tpu.core.transform import Transform as JTransform
from molvoxel_tpu.core.transform import apply_quaternion as jax_apply_quaternion
from molvoxel_tpu.core.transform import do_random_transform as jax_do_random_transform
from molvoxel_tpu.ops.dense import voxelize_dense as jax_voxelize_dense
from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_bwd_batch, voxelize_pallas_bwd_batch_channelwise
from molvoxel_tpu.ops.voxelize import voxelize as jax_voxelize
from tests.test_fuzz import BWD_CASES

GRAD_BAR = 5e-3  # the gate's backward bar (tools/round_gate.py:230)


def _cloud(rng, b, vp, v, c, box):
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-box, box, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(0.1, 1.0, (b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    return coords, weights, mask


def _leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _grads(out, inputs, ct):
    return [g.numpy() for g in torch.autograd.grad(out, inputs, grad_outputs=ct, materialize_grads=True)]


def _scale(*arrays):
    return max(max(float(np.abs(a).max()) for a in arrays), 1.0)


PLAIN_CASES = [
    # density, dim, C, slab
    ("gaussian", 16, 4, None),
    ("binary", 16, 4, None),
    ("gaussian_notrunc", 16, 1, None),
    ("gaussian", 20, 9, None),
    ("binary", 20, 1, (3, 7)),
    ("gaussian", 32, 1, None),
    ("gaussian_notrunc", 20, 4, (5, 9)),
    ("gaussian", 32, 4, (8, 12)),
]


@pytest.mark.parametrize("density,dim,c,slab", PLAIN_CASES, ids=[f"{d}-dim{n}-c{c}-{'slab' if s else 'full'}"
                                                                 for d, n, c, s in PLAIN_CASES])
def test_deposit_bwd_plain_matches_autograd_of_deposit_plain(rng, density, dim, c, slab):
    """The backward's plain version is the VJP of the forward's plain
    version (same prepared inputs, V = 150 so three 64-atom chunks), at
    1e-5 of the gradient scale: the two sum in different orders."""
    coords, weights, mask = _cloud(rng, 2, 150, 130, c, dim * 0.25)
    radii = rng.uniform(0.7, 1.6, size=(2, 150)).astype(np.float32)
    spec = TSpec(0.5, dim)
    kw = dict(density_type=density, sigma=0.5)
    if slab is not None:
        kw.update(d_offset=slab[0], d_count=slab[1])
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(*map(torch.as_tensor, (coords, weights, radii)), spec=spec,
                                                           mask=torch.as_tensor(mask), **kw)
    rows, wt = rows.requires_grad_(), wt.requires_grad_()
    ct = torch.as_tensor(rng.normal(size=(2, c, dl, dim * dim)).astype(np.float32))
    out = deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian)
    want_rows, want_w = _grads(out, (rows, wt), ct)
    got_rows, got_w = deposit.deposit_bwd_plain(rows.detach(), wt.detach(), ct, spec=spec, dl=dl, gaussian=gaussian)
    tol = 1e-5 * _scale(want_rows, want_w)
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=0, atol=tol)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=tol)
    assert not got_rows[:, [3, 5, 6, 7]].any()  # the almost-everywhere gradient: no threshold term
    if density == "binary":
        assert not got_rows.any()
    else:
        assert float(got_rows[:, :3].abs().max()) > 0 and float(got_rows[:, 4].abs().max()) > 0


def _port_batch(coords, weights, radii, mask, ct, spec, **kw):
    c_t, w_t, r_t = _leaf(coords), _leaf(weights), _leaf(radii)
    out = deposit.voxelize_deposit_batch(c_t, w_t, r_t, spec=spec, mask=torch.as_tensor(mask), **kw)
    return out, _grads(out, (c_t, w_t, r_t), torch.as_tensor(ct).to(out.dtype))


def _assert_grads(got, want, bar):
    for g, w, name in zip(got, want, ("dcoords", "dweights", "dradii")):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=bar, err_msg=name)


@pytest.mark.parametrize("variant", ["multichunk_v512", "shared_radii", "slab"])
def test_differentiable_batch_matches_pallas_backward(rng, variant):
    """voxelize_deposit_batch's gradients (the autograd.Function, the Morton
    sort, the mask, r^2 -> coef, the slab shift and the shared-radii batch
    sum all by autograd) against voxelize_pallas_bwd_batch."""
    if variant == "multichunk_v512":  # sorted, 8 chunks, per-atom radii
        b, vp, v, c, dim, slab = 1, 512, 400, 3, 16, None
        radii = rng.uniform(0.8, 1.6, (b, vp)).astype(np.float32)
    elif variant == "shared_radii":  # (V,) radii: their gradient sums over the batch
        b, vp, v, c, dim, slab = 2, 256, 200, 2, 16, None
        radii = rng.uniform(0.8, 1.6, (vp,)).astype(np.float32)
    else:  # tools/round_gate.py:252-271
        b, vp, v, c, dim, slab = 1, 256, 256, 4, 32, (8, 16)
        radii = np.ones((vp,), np.float32)
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask = _cloud(rng, b, vp, v, c, spec_t.width / 2)
    dl = dim if slab is None else slab[1]
    ct = rng.normal(size=(b, c, dl, dim, dim)).astype(np.float32)
    kw = {} if slab is None else dict(d_offset=slab[0], d_count=slab[1])
    _, got = _port_batch(coords, weights, radii, mask, ct, spec_t, **kw)
    dc, dw, dr = voxelize_pallas_bwd_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
                                           jnp.asarray(ct), spec=spec_j, density_type="gaussian", sigma=0.5,
                                           mask=jnp.asarray(mask), **kw)
    _assert_grads(got, (dc, dw, dr), GRAD_BAR)


@pytest.mark.parametrize("variant", ["multichunk_v512", "shared_radii", "slab"])
def test_notrunc_differentiable_batch_matches_pallas_backward(rng, variant):
    """gaussian_notrunc's kernel route for training (the threshold row, both
    plain versions behind the autograd.Function) against
    voxelize_pallas_bwd_batch with density_type="gaussian_notrunc", on the
    same inputs as the gaussian test above."""
    if variant == "multichunk_v512":
        b, vp, v, c, dim, slab = 1, 512, 400, 3, 16, None
        radii = rng.uniform(0.8, 1.6, (b, vp)).astype(np.float32)
    elif variant == "shared_radii":
        b, vp, v, c, dim, slab = 2, 256, 200, 2, 16, None
        radii = rng.uniform(0.8, 1.6, (vp,)).astype(np.float32)
    else:
        b, vp, v, c, dim, slab = 1, 256, 256, 4, 32, (8, 16)
        radii = np.ones((vp,), np.float32)
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask = _cloud(rng, b, vp, v, c, spec_t.width / 2)
    dl = dim if slab is None else slab[1]
    ct = rng.normal(size=(b, c, dl, dim, dim)).astype(np.float32)
    kw = {} if slab is None else dict(d_offset=slab[0], d_count=slab[1])
    _, got = _port_batch(coords, weights, radii, mask, ct, spec_t, density_type="gaussian_notrunc", **kw)
    want = voxelize_pallas_bwd_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(ct),
                                     spec=spec_j, density_type="gaussian_notrunc", sigma=0.5, mask=jnp.asarray(mask),
                                     **kw)
    _assert_grads(got, want, GRAD_BAR * _scale(*want))


def test_channelwise_gradients_match_pallas_backward(rng):
    """Channel-wise radii: the virtual-atom expansion is torch ops, so
    autograd folds the virtual gradients back (V = 512 -> 1536 virtual)."""
    b, vp, v, c, dim = 1, 512, 400, 3, 16
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask = _cloud(rng, b, vp, v, c, 3.5)
    radii = np.array([0.9, 1.2, 1.5], np.float32)
    ct = rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)
    c_t, w_t, r_t = _leaf(coords), _leaf(weights), _leaf(radii)
    out = deposit.voxelize_deposit_batch_channelwise(c_t, w_t, r_t, spec=spec_t, mask=torch.as_tensor(mask))
    got = _grads(out, (c_t, w_t, r_t), torch.as_tensor(ct))
    want = voxelize_pallas_bwd_batch_channelwise(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
                                                 jnp.asarray(ct), spec=spec_j, density_type="gaussian", sigma=0.5,
                                                 mask=jnp.asarray(mask))
    _assert_grads(got, want, GRAD_BAR)


def test_masked_atoms_get_zero_gradients(rng):
    """Masked atoms inside the grid: the kernel's own grad_weights for them
    is not zero (their rows still reach voxels), but the mask's
    torch.where in prepare_deposit zeroes every gradient they receive."""
    b, vp, v, c, dim = 1, 64, 40, 2, 16
    coords, weights, mask = _cloud(rng, b, vp, vp, c, 3.0)
    mask[:, v:] = False
    radii = rng.uniform(0.8, 1.4, (b, vp)).astype(np.float32)
    ct = rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)
    spec = TSpec(0.5, dim)
    _, (dc, dw, dr) = _port_batch(coords, weights, radii, mask, ct, spec)
    assert not dc[:, v:].any() and not dw[:, v:].any() and not dr[:, v:].any()
    assert np.abs(dc[:, :v]).max() > 0 and np.abs(dw[:, :v]).max() > 0 and np.abs(dr[:, :v]).max() > 0
    rows, wt, _, dl, gaussian = deposit.prepare_batch(*map(torch.as_tensor, (coords, weights, radii)), spec=spec,
                                                      mask=torch.as_tensor(mask))
    _, kernel_w = deposit.deposit_bwd(rows, wt, torch.as_tensor(ct), spec=spec, dl=dl, gaussian=gaussian)
    assert float(kernel_w[:, :, v:].abs().max()) > 0


@pytest.mark.parametrize("density", ["gaussian", "binary"])
def test_low_precision_cotangent_matches_jax_lowp(rng, density):
    """A bf16 grid hands autograd a bf16 cotangent: within 3e-2 of the
    gradient scale of the JAX package's lowp backward lane."""
    b, vp, v, c, dim = 1, 128, 100, 2, 16
    coords, weights, mask = _cloud(rng, b, vp, v, c, 2.5)
    radii = np.ones((vp,), np.float32)
    ct = rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)
    out, got = _port_batch(coords, weights, radii, mask, ct, TSpec(0.5, dim), density_type=density,
                           out_dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    want = voxelize_pallas_bwd_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(ct),
                                     spec=JSpec(0.5, dim), density_type=density, sigma=0.5, mask=jnp.asarray(mask),
                                     lowp=True)
    _assert_grads(got, want, 3e-2 * _scale(*want))


def test_fp8_grid_cotangent_reaches_the_backward(rng):
    """An fp8 grid's cotangent arrives in fp8; the backward widens it exactly,
    so its gradients equal the f32 lane's at the fp8-rounded cotangent."""
    b, vp, v, c, dim = 1, 64, 50, 2, 12
    coords, weights, mask = _cloud(rng, b, vp, v, c, 2.0)
    radii = np.ones((vp,), np.float32)
    ct8 = torch.as_tensor(rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)).to(torch.float8_e4m3fn)
    out8, got = _port_batch(coords, weights, radii, mask, ct8, TSpec(0.5, dim), out_dtype="float8_e4m3fn")
    _, want = _port_batch(coords, weights, radii, mask, ct8.float(), TSpec(0.5, dim))
    assert out8.dtype == torch.float8_e4m3fn
    _assert_grads(got, want, 1e-5 * _scale(*want))


@pytest.mark.parametrize("case", BWD_CASES, ids=[f"bwd{c['seed']}" for c in BWD_CASES])
def test_fuzz_backward_matches_jax_pallas_vjp(case):
    """tests/test_fuzz.py's ten backward configurations: the single-molecule
    differentiable deposit against the VJP of the JAX package's
    voxelize(impl="pallas"), at its own bar (1e-4 of the gradient scale)."""
    rng = np.random.default_rng(case["seed"])
    spec_j = JSpec(resolution=case["res"], dimension=case["dim"])
    spec_t = TSpec(resolution=case["res"], dimension=case["dim"])
    v, c = case["v"], case["c"]
    vp = atom_bucket(v)
    extent = spec_j.width / 2 + 0.5
    coords = np.zeros((vp, 3), np.float32)
    coords[:v] = rng.uniform(-extent, extent, (v, 3))
    weights = np.zeros((vp, c), np.float32)
    weights[:v] = rng.uniform(-1.0, 1.0, (v, c))
    mask = np.zeros((vp,), bool)
    mask[:v] = True
    channelwise = case["radii_mode"] == "channel"
    if channelwise:
        radii = rng.uniform(0.6, 1.8, (c,)).astype(np.float32)
    elif case["radii_mode"] == "atom":
        radii = np.ones((vp,), np.float32)
        radii[:v] = rng.uniform(0.6, 1.8, (v,))
    else:
        radii = np.full((vp,), float(rng.uniform(0.6, 1.8)), np.float32)
    dl = case["d_count"] if case["d_count"] is not None else case["dim"]
    ct = rng.normal(size=(c, dl, case["dim"], case["dim"])).astype(np.float32)
    kw = dict(density_type="gaussian", sigma=case["sigma"], d_offset=case["d_offset"], d_count=case["d_count"])

    def f(cd, w, r):
        return jax_voxelize(cd, w, r, spec=spec_j, mask=jnp.asarray(mask), channelwise_radii=channelwise,
                            impl="pallas", **kw)

    want_out, vjp = jax.vjp(f, jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii))
    want = vjp(jnp.asarray(ct))
    fn = deposit.voxelize_deposit_channelwise if channelwise else deposit.voxelize_deposit
    c_t, w_t, r_t = _leaf(coords), _leaf(weights), _leaf(radii)
    out = fn(c_t, w_t, r_t, spec=spec_t, mask=torch.as_tensor(mask), **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=2e-5)
    got = _grads(out, (c_t, w_t, r_t), torch.as_tensor(ct))
    for g, w, name in zip(got, want, ("dcoords", "dweights", "dradii")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4 * _scale(w), err_msg=name)
        assert np.all(np.isfinite(g)), name


def test_gradients_through_the_random_transform(rng):
    """The JAX package's random rigid transform, carried across as an
    explicit quaternion and translation (tests/test_autodiff.py:120):
    gradients reach the untransformed coordinates and the quaternion."""
    v, c, dim = 6, 2, 12
    coords = rng.uniform(-1.5, 1.5, (v, 3)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, (v, c)).astype(np.float32)
    radii = rng.uniform(0.9, 1.4, (v,)).astype(np.float32)
    target = rng.normal(size=(c, dim, dim, dim)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    spec_j, spec_t = JSpec(0.5, dim), TSpec(0.5, dim)
    jt = JTransform.create(key, random_translation=0.5, random_rotation=True)

    def jloss(moved):
        out = jax_voxelize_dense(moved, jnp.asarray(weights), jnp.asarray(radii), spec=spec_j, sigma=0.5)
        return jnp.sum(out * target)

    want_c = np.asarray(jax.grad(lambda crd: jloss(jax_do_random_transform(key, crd, None, 0.5, True)))(
        jnp.asarray(coords)))
    want_q = np.asarray(jax.grad(lambda q: jloss(jax_apply_quaternion(jnp.asarray(coords), q) + jt.translation))(
        jt.quaternion))
    c_t = _leaf(coords)
    q_t = _leaf(np.array(jt.quaternion))
    moved = do_transform(c_t, None, torch.as_tensor(np.array(jt.translation)), q_t)
    out = deposit.voxelize_deposit(moved, torch.as_tensor(weights), torch.as_tensor(radii), spec=spec_t, sigma=0.5)
    got_c, got_q = _grads(out, (c_t, q_t), torch.as_tensor(target))
    assert np.abs(got_c).max() > 0 and np.abs(got_q).max() > 0
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=GRAD_BAR)
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=GRAD_BAR)


def test_pose_refinement_converges_through_the_plain_backward():
    """examples/pose_optimize.py through the port on the CPU: the 61-atom
    golden ligand in a hidden pose (numpy seed), 32^3, sigma 1.0, Adam at
    3e-2 on (quaternion, shift) through the differentiable deposit; the
    example's own bar, RMSD < 0.05 A (150 steps here, 400 there)."""
    g = np.load("tests/goldens/lig_features_gaussian.npz")
    coords0 = torch.as_tensor((g["coords"] - g["coords"].mean(0)).astype(np.float32))
    v = coords0.shape[0]
    spec = TSpec(0.5, 32)
    weights, radii = torch.ones(v, 1), torch.ones(v)
    rng = np.random.default_rng(0)
    u = rng.uniform(size=3)
    q = np.array([np.sqrt(1 - u[0]) * np.sin(2 * np.pi * u[1]), np.sqrt(1 - u[0]) * np.cos(2 * np.pi * u[1]),
                  np.sqrt(u[0]) * np.sin(2 * np.pi * u[2]), np.sqrt(u[0]) * np.cos(2 * np.pi * u[2])])
    q = q * 0.25 + np.array([1.0, 0.0, 0.0, 0.0]) * 0.75
    q_true = torch.as_tensor((q / np.linalg.norm(q)).astype(np.float32))
    t_true = torch.as_tensor(rng.uniform(-0.8, 0.8, 3).astype(np.float32))
    target_coords = apply_quaternion(coords0, q_true) + t_true

    def grid(crd):
        return deposit.voxelize_deposit(crd, weights, radii, spec=spec, sigma=1.0)

    target = grid(target_coords)
    q_p = torch.tensor([1.0, 0.0, 0.0, 0.0], requires_grad=True)
    t_p = torch.zeros(3, requires_grad=True)
    opt = torch.optim.Adam([q_p, t_p], lr=3e-2)

    def rmsd():
        pose = apply_quaternion(coords0, q_p / q_p.norm()) + t_p
        return float(((pose - target_coords) ** 2).sum(-1).mean().sqrt())

    with torch.no_grad():
        r0 = rmsd()
    for _ in range(150):
        opt.zero_grad()
        loss = ((grid(apply_quaternion(coords0, q_p / q_p.norm()) + t_p) - target) ** 2).mean() * 1e4
        loss.backward()
        opt.step()
    with torch.no_grad():
        r1 = rmsd()
    assert r0 > 1.0 and r1 < 0.05, f"pose RMSD {r0:.3f} -> {r1:.4f}"


def test_backward_wrapper_on_cpu_runs_the_plain_version_and_rejects_other_devices(rng):
    coords, weights, mask = _cloud(rng, 1, 64, 40, 2, 2.0)
    spec = TSpec(0.5, 12)
    rows, wt, _, dl, gaussian = deposit.prepare_batch(torch.as_tensor(coords), torch.as_tensor(weights),
                                                      torch.ones(64), spec=spec, mask=torch.as_tensor(mask))
    ct = torch.as_tensor(rng.normal(size=(1, 2, dl, 144)).astype(np.float32))
    before = dict(deposit.launches)
    got = deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian)
    want = deposit.deposit_bwd_plain(rows, wt, ct, spec=spec, dl=dl, gaussian=gaussian)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert deposit.launches == before  # no kernel launch on CPU tensors
    with pytest.raises(ValueError, match="CUDA or CPU"):
        deposit.deposit_bwd(rows.to("meta"), wt.to("meta"), ct.to("meta"), spec=spec, dl=dl, gaussian=gaussian)
