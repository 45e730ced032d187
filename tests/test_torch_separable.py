"""gaussian_notrunc in molvoxel_torch against molvoxel_tpu on the CPU: the
separable product, the notrunc threshold row on the deposit kernels' plain
versions, the routing rule, the two torch-reference goldens through the
public API, on the same numpy inputs."""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch import create_voxelizer
from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.ops import deposit, separable
from molvoxel_torch.nn import VoxelizeLayer
from molvoxel_torch.ops import batch as tbatch
from molvoxel_torch.ops.voxelize import notrunc_separable
from molvoxel_torch.ops.voxelize import voxelize as torch_voxelize
from molvoxel_torch.ops.batch import voxelize_batch, voxelize_batch_sliced
from molvoxel_torch.ops.dense import voxelize_dense
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch
from molvoxel_tpu.ops.separable import voxelize_separable_batch as jax_separable_batch
from molvoxel_tpu.ops.separable import voxelize_separable_batch_channelwise as jax_separable_batch_channelwise

tvoxelize = importlib.import_module("molvoxel_torch.ops.voxelize")  # ops.voxelize is also the function's name
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


# Both CUDA routes of gaussian_notrunc timed on one card (NVIDIA H100 80GB
# HBM3, 700.00 W; milliseconds by CUDA-graph replay, forward or forward +
# backward), with the deposit's preparation as one kernel: the shapes of
# chip_smoke.py's notrunc_routing phase, from its run, then the shapes the
# earlier FLOP-threshold rule found nearest its crossover, from the first
# sweep of tools/torch_notrunc_sweep.py
# (tests/data/torch_notrunc_sweep_h100_3.jsonl).
# Atoms are padded counts; planes None is the whole depth.
NOTRUNC_MEASURED = [
    # case, atoms, dim, planes, channels, batch, out dtype, gradient, kernel route ms, separable ms
    ("lig61_b64_dim64_c4_f32", 64, 64, None, 4, 64, "float32", False, 0.1616, 0.3441),
    ("lig61_b64_dim64_c4_bf16", 64, 64, None, 4, 64, "bfloat16", False, 0.1277, 0.1823),
    ("lig61_b1_dim48_c4_f32", 64, 48, None, 4, 1, "float32", False, 0.0228, 0.0422),
    ("lig61_b1_dim128_c4_f32", 64, 128, None, 4, 1, "float32", False, 0.0251, 0.0818),
    ("lig61_b4_dim256_res025_slab128_64_c4_f32", 64, 256, 64, 4, 4, "float32", False, 0.0966, 0.3470),
    ("complex468_b1_dim48_c8_f32", 512, 48, None, 8, 1, "float32", False, 0.0559, 0.0714),
    ("prot1024_b1_dim48_c1_f32", 1024, 48, None, 1, 1, "float32", False, 0.0476, 0.0642),
    ("prot1024_b1_dim128_c1_f32", 1024, 128, None, 1, 1, "float32", False, 0.0603, 0.1819),
    ("prot3262_b1_dim48_c1_f32", 4096, 48, None, 1, 1, "float32", False, 0.0750, 0.1100),
    ("prot3262_b1_dim128_c1_f32", 4096, 128, None, 1, 1, "float32", False, 0.1262, 0.5706),
    ("prot3262_b1_dim256_c1_f32", 4096, 256, None, 1, 1, "float32", False, 0.2330, 3.4049),
    ("prot3262_b1_dim128_c1_bf16", 4096, 128, None, 1, 1, "bfloat16", False, 0.1292, 0.4021),
    ("train_layer_lig61_b64_dim64_c4_f32", 64, 64, None, 4, 64, "float32", True, 0.2680, 1.0781),
    ("train_voxelize_prot3262_dim48_c1_f32", 4096, 48, None, 1, 1, "float32", True, 0.1542, 0.4224),
    ("lig61_b16_dim64_c4_f32", 64, 64, None, 4, 16, "float32", False, 0.0589, 0.1239),
    ("lig61_b64_dim48_c4_f32", 64, 48, None, 4, 64, "float32", False, 0.1168, 0.1895),
    ("lig61_b256_dim64_c4_bf16", 64, 64, None, 4, 256, "bfloat16", False, 0.4695, 0.6248),
    ("lig61_b1024_dim64_c4_bf16", 64, 64, None, 4, 1024, "bfloat16", False, 1.8491, 2.3864),
    ("lig61_b64_dim96_c4_bf16", 64, 96, None, 4, 64, "bfloat16", False, 0.2391, 0.4156),
    ("lig61_b1_dim256_res025_slab128_64_c4_f32", 64, 256, 64, 4, 1, "float32", False, 0.0410, 0.1166),
    ("complex468_b1_dim96_c8_f32", 512, 96, None, 8, 1, "float32", False, 0.0631, 0.2310),
    ("complex468_b1_dim128_c8_f32", 512, 128, None, 8, 1, "float32", False, 0.0645, 0.4108),
    ("prot2048_b1_dim128_c1_f32", 2048, 128, None, 1, 1, "float32", False, 0.0907, 0.3076),
    ("prot3262_b1_dim96_c1_f32", 4096, 96, None, 1, 1, "float32", False, 0.1270, 0.3426),
    ("prot1024_b1_dim192_c1_f32", 1024, 192, None, 1, 1, "float32", False, 0.0870, 0.5040),
    ("train_layer_lig61_b1_dim64_c4_f32", 64, 64, None, 4, 1, "float32", True, 0.0596, 0.1127),
    ("train_voxelize_prot3262_dim32_c1_f32", 4096, 32, None, 1, 1, "float32", True, 0.1467, 0.2839),
    ("train_voxelize_prot1024_dim48_c1_f32", 1024, 48, None, 1, 1, "float32", True, 0.1130, 0.2432),
    ("train_voxelize_prot3262_dim64_c1_f32", 4096, 64, None, 1, 1, "float32", True, 0.1715, 0.6055),
]


@pytest.mark.parametrize("case,atoms,dim,planes,c,b,odt,grad,kernel_ms,separable_ms", NOTRUNC_MEASURED,
                         ids=[row[0] for row in NOTRUNC_MEASURED])
def test_notrunc_rule_takes_the_measured_faster_route(case, atoms, dim, planes, c, b, odt, grad, kernel_ms,
                                                      separable_ms):
    """At every measured shape the rule's route (on the card, one radius per
    atom: the kernel) was the faster one, or within 10% of it."""
    kernel = not notrunc_separable("gaussian_notrunc", "auto", "cuda", False)
    taken, other = (kernel_ms, separable_ms) if kernel else (separable_ms, kernel_ms)
    assert taken <= 1.1 * other, (case, "kernel" if kernel else "separable", kernel_ms, separable_ms)


# Both sweeps of tools/torch_notrunc_sweep.py on the same card, as the tool
# wrote them: a header line (the card, its power limit and the software),
# then one line per shape.  Their port_route column is the rule the sweep
# ran under; the test reads only the shapes and the two routes' times.
SWEEPS = [[json.loads(ln) for ln in (ROOT / "tests" / "data" / f"torch_notrunc_sweep_h100_{i}.jsonl").open()]
          for i in (3, 4)]
SWEPT = [ln["case"] for ln in SWEEPS[0][1:]]


def test_notrunc_sweeps_cover_the_same_shapes_on_one_card():
    assert len(SWEPT) == 100 and len(set(SWEPT)) == 100
    assert [ln["case"] for ln in SWEEPS[1][1:]] == SWEPT
    assert {sweep[0]["nvidia_smi"] for sweep in SWEEPS} == {"NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.mark.parametrize("case", SWEPT)
def test_notrunc_rule_takes_the_faster_route_at_every_swept_shape(case):
    """At each of the 100 swept shapes, in both sweeps, the rule's route was
    the faster one or within 10% of it: forward lines at their depth slab
    and grid dtype, training lines (one forward and one backward) in f32."""
    for sweep in SWEEPS:
        ln = next(ln for ln in sweep[1:] if ln["case"] == case)
        grad = "entry" in ln
        kernel = not notrunc_separable("gaussian_notrunc", "auto", "cuda", False)
        times = ((ln["kernel_fwd_bwd_ms"], ln["separable_fwd_bwd_ms"]) if grad
                 else (ln["kernel_route_ms"], ln["separable_ms"]))
        taken, other = times if kernel else times[::-1]
        assert taken <= 1.1 * other, (case, "kernel" if kernel else "separable", times)


def test_notrunc_routing_keeps_the_cpu_and_dense_routes():
    """CPU requests run the separable product (impl auto) or the dense path
    (impl dense); on the card one radius per atom runs on the kernel and
    channel-wise radii on the separable product; other densities never
    take the separable product."""
    for channelwise in (False, True):
        assert notrunc_separable("gaussian_notrunc", "auto", "dense", channelwise)
        assert notrunc_separable("gaussian_notrunc", "auto", "cuda", channelwise) == channelwise
        assert notrunc_separable("gaussian_notrunc", "cuda", "cuda", channelwise) == channelwise
        for resolved in ("dense", "cuda"):
            assert not notrunc_separable("gaussian_notrunc", "dense", resolved, channelwise)
            for density in ("gaussian", "binary"):
                assert not notrunc_separable(density, "auto", resolved, channelwise)


def test_notrunc_call_sites_hand_the_rule_their_shapes(monkeypatch, rng):
    """voxelize, voxelize_batch (also through VoxelizeLayer) and
    voxelize_batch_sliced pass the rule the density, the impl asked for,
    the impl it resolved to and whether the radii are channel-wise."""
    seen = []

    def record(*args, **kw):
        seen.append((args, kw))
        return True

    monkeypatch.setattr(tvoxelize, "notrunc_separable", record)
    monkeypatch.setattr(tbatch, "notrunc_separable", record)
    coords, weights, mask = map(torch.as_tensor, _cloud(rng, b=3, v=20, c=2, n_pad=2))
    spec = TSpec(0.5, 8)
    radii = torch.ones(20)
    kw = dict(spec=spec, density_type="gaussian_notrunc")
    voxelize_batch(coords, weights, radii, mask, None, sigma=0.7, out_dtype="bfloat16", **kw)
    VoxelizeLayer(spec, density_type="gaussian_notrunc")(coords.clone().requires_grad_(), weights, mask)
    voxelize_batch_sliced(coords, weights, radii, mask, None, slab_depth=4, **kw)
    torch_voxelize(coords[0], weights[0], radii.clone().requires_grad_(), mask=mask[0], d_offset=2, d_count=4, **kw)
    voxelize_batch(coords, weights, torch.ones(2), mask, None, channelwise=True, impl="dense", **kw)
    assert [k for _, k in seen] == [{}] * 5
    assert [a for a, _ in seen] == [("gaussian_notrunc", "auto", "dense", False)] * 4 + [
        ("gaussian_notrunc", "dense", "dense", True)]


@pytest.mark.parametrize("variant", ["full", "slab", "batched_radii"])
def test_threshold_row_backward_matches_jax_separable_grad(rng, variant):
    """The threshold row's backward (``deposit_bwd_plain``, behind the
    deposit's autograd Function on the CPU) against the VJP of the JAX
    package's separable product, the unpruned function, on the same inputs,
    at the backward bar 5e-3 x max(1, gradient scale)."""
    b, v, c, dim = 2, 90, 3, 16
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask = _cloud(rng, b, v, c, spec_t.width / 2, n_pad=10)
    radii = rng.uniform(0.8, 1.4, size=(b, v) if variant == "batched_radii" else (v,)).astype(np.float32)
    slab = dict(d_offset=3, d_count=7) if variant == "slab" else {}
    dl = slab.get("d_count", dim)
    ct = rng.normal(size=(b, c, dl, dim, dim)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (coords, weights, radii)]
    out = deposit.voxelize_deposit_batch(*leaves, spec=spec_t, density_type="gaussian_notrunc", sigma=0.5,
                                         mask=torch.as_tensor(mask), **slab)
    got = torch.autograd.grad(out, leaves, grad_outputs=torch.as_tensor(ct))
    _, vjp = jax.vjp(lambda *a: jax_separable_batch(*a, spec=spec_j, sigma=0.5, mask=jnp.asarray(mask), **slab),
                     *map(jnp.asarray, (coords, weights, radii)))
    want = vjp(jnp.asarray(ct))
    for g, w, name in zip(got, want, ("dcoords", "dweights", "dradii")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-3 * scale, err_msg=name)


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
