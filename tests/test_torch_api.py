"""molvoxel_torch's public API on the CPU: the goldens, batches against
molvoxel_tpu, the device contract, and the package's import boundary."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molvoxel_torch
from molvoxel_torch import create_voxelizer
from molvoxel_torch.core.state import config_from_dict, transform_from_arrays
from molvoxel_torch.ops import deposit
from molvoxel_tpu import create_voxelizer as jax_create_voxelizer
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.core.transform import Transform as JTransform
from molvoxel_tpu.data.pipeline import pad_point_clouds as jax_pad
from molvoxel_tpu.ops.batch import voxelize_batch as jax_voxelize_batch

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_FILES = [p for p in sorted((ROOT / "tests" / "goldens").glob("*.npz"))
                if str(np.load(p)["density"]) != "gaussian_notrunc"]
X64_FILES = sorted((ROOT / "tests" / "goldens_x64").glob("*.npz"))


def _forward(vox, g, mode, center, radii):
    if mode == "features":
        return vox.forward_features(g["coords"], center, g["channels"], radii)
    if mode == "types":
        return vox.forward_types(g["coords"], center, g["channels"].astype(np.int32), radii)
    return vox.forward_single(g["coords"], center, radii)


def test_golden_set_is_the_twenty_exact_cutoff_goldens():
    assert len(GOLDEN_FILES) == 20


@pytest.mark.parametrize("golden_path", GOLDEN_FILES, ids=[p.stem for p in GOLDEN_FILES])
def test_golden_parity_cpu(golden_path):
    g = np.load(golden_path, allow_pickle=False)
    vox = create_voxelizer(resolution=float(g["resolution"]), dimension=int(g["dimension"]),
                           radii_type=str(g["radii_type"]), density_type=str(g["density"]),
                           sigma=float(g["sigma"]), device="cpu")
    radii = float(g["radii"]) if g["radii"].ndim == 0 else g["radii"]
    center = g["center"] if g["center"].size else None
    channels = g["channels"].astype(np.float32) if str(g["mode"]) == "features" else g["channels"]
    out = _forward(vox, dict(g, channels=channels), str(g["mode"]), center, radii)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu" and out.dtype == torch.float32
    atol = 5e-5 if golden_path.stem.endswith("torchref") else 1e-5
    np.testing.assert_allclose(out.numpy(), g["expected"], atol=atol)


@pytest.mark.parametrize("golden_path", X64_FILES, ids=[p.stem for p in X64_FILES])
def test_x64_golden_parity_cpu(golden_path):
    g = np.load(golden_path, allow_pickle=False)
    vox = create_voxelizer(resolution=0.5, dimension=48, radii_type=str(g["radii_type"]),
                           density_type=str(g["density"]), sigma=0.5, precision=64, device="cpu")
    radii = float(g["radii"]) if g["radii"].ndim == 0 else g["radii"]
    out = _forward(vox, dict(g), str(g["mode"]), g["center"], radii)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), g["expected"], rtol=0, atol=1e-9)


def _molecules(rng, sizes=(40, 61, 90), c=3):
    mols = []
    for v in sizes:
        mols.append((rng.uniform(-3.5, 3.5, size=(v, 3)).astype(np.float32),
                     rng.uniform(0.0, 1.0, size=(v, c)).astype(np.float32)))
    return mols


@pytest.mark.parametrize("variant", ["features", "types", "channelwise", "atomwise", "bf16"])
def test_forward_batch_matches_jax_dense(rng, variant):
    """No random augmentation: the port's forward_batch (CPU) against
    molvoxel_tpu's voxelize_batch(impl="dense") on the same padded batch."""
    dim = 16
    mols = _molecules(rng)
    centers = [rng.uniform(-0.5, 0.5, size=(3,)).astype(np.float32) for _ in mols]
    radii_type = {"channelwise": "channel-wise", "atomwise": "atom-wise"}.get(variant, "scalar")
    vox = create_voxelizer(resolution=0.5, dimension=dim, radii_type=radii_type, device="cpu")
    if variant == "types":
        types = [rng.integers(0, 4, size=(crd.shape[0],)) for crd, _ in mols]
        clouds = [(crd, t) for (crd, _), t in zip(mols, types)]
        jax_clouds = [(crd, np.eye(4, dtype=np.float32)[t]) for (crd, _), t in zip(mols, types)]
    else:
        clouds = jax_clouds = mols
    radii, jax_radii, radii_batched = 1.0, None, False
    if variant == "channelwise":
        radii = jax_radii = np.asarray([0.8, 1.1, 1.5], np.float32)
    elif variant == "atomwise":
        radii = [rng.uniform(0.7, 1.6, size=(crd.shape[0],)).astype(np.float32) for crd, _ in mols]
        radii_batched = True
    out_dtype = "bfloat16" if variant == "bf16" else "float32"
    got = vox.forward_batch(clouds, radii=radii, centers=centers, out_dtype=out_dtype)

    batch = jax_pad(jax_clouds, centers=centers, radii=radii if radii_batched else None)
    if jax_radii is None:
        jax_radii = batch.radii if radii_batched else np.full((batch.padded_atoms,), 1.0, np.float32)
    want = np.asarray(jax_voxelize_batch(
        jnp.asarray(batch.coords), jnp.asarray(batch.weights), jnp.asarray(jax_radii), jnp.asarray(batch.mask),
        jnp.asarray(batch.centers), jax.random.split(jax.random.PRNGKey(0), batch.batch_size), 0.0,
        spec=JSpec(0.5, dim), channelwise=variant == "channelwise", impl="dense", radii_batched=radii_batched,
    ))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == want.shape
    tol = 2**-7 * max(np.abs(want).max(), 1.0) if variant == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_forward_with_jax_augmentation_carried_across(rng):
    """The same random rigid transform in both packages (through
    transform_from_arrays) gives the same grid."""
    coords = rng.uniform(-3, 3, size=(50, 3)).astype(np.float32)
    feats = rng.uniform(0, 1, size=(50, 4)).astype(np.float32)
    center = coords.mean(0)
    key = jax.random.PRNGKey(21)
    jvox = jax_create_voxelizer(resolution=0.5, dimension=20, impl="dense")
    want = np.asarray(jvox.forward_features(coords, center, feats, 1.0, 0.5, True, key=key))
    jt = JTransform.create(key, random_translation=0.5, random_rotation=True)
    tt = transform_from_arrays(np.asarray(jt.quaternion), np.asarray(jt.translation))
    cfg = config_from_dict(jvox.config.to_dict())
    vox = create_voxelizer(resolution=cfg.grid.resolution, dimension=cfg.grid.dimension, device="cpu")
    moved = tt(torch.as_tensor(coords - center))
    got = vox.forward_features(moved, None, feats, 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_random_augmentation_is_reproducible_from_a_seed(rng):
    coords = rng.uniform(-3, 3, size=(30, 3)).astype(np.float32)
    vox = create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    a = vox.forward_single(coords, None, 1.0, 0.5, True, key=7)
    b = vox.forward_single(coords, None, 1.0, 0.5, True, key=torch.Generator().manual_seed(7))
    c = vox.forward_single(coords, None, 1.0, 0.5, True, key=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, vox.forward_single(coords, None, 1.0))


def test_out_grid_contract(rng):
    coords = rng.uniform(-3, 3, size=(20, 3)).astype(np.float32)
    types = np.asarray([0, 1, 2] * 6 + [0, 1])
    vox = create_voxelizer(resolution=0.5, dimension=12, device="cpu")
    host = np.full((5, 12, 12, 12), 7.0, np.float32)
    out = vox.forward_types(coords, None, types, 1.0, out_grid=host)
    assert out is host and (host[3:] == 0).all()
    ref = vox.forward_types(coords, None, types, 1.0)
    assert ref.shape[0] == 3  # C = max(types) + 1
    np.testing.assert_array_equal(host[:3], ref.numpy())
    dev_grid = vox.get_empty_grid(3)
    assert dev_grid.shape == (3, 12, 12, 12) and dev_grid.device.type == "cpu"
    assert vox.forward(coords, None, types, 1.0, out_grid=dev_grid) is dev_grid
    assert torch.equal(dev_grid, ref)
    with pytest.raises(ValueError):
        vox.forward_features(coords, None, np.ones((20, 2), np.float32), 1.0, out_grid=host)


def test_default_device_is_cuda_and_a_forward_never_falls_back(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vox = create_voxelizer(dimension=16)
    assert vox.device == torch.device("cuda")
    coords = rng.uniform(-3, 3, size=(10, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vox.forward_single(coords, None, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vox.forward_batch([(coords, np.ones((10, 2), np.float32))])
    assert vox.cpu().device == torch.device("cpu")
    assert vox.forward_single(coords, None, 1.0).device.type == "cpu"
    assert vox.cuda().device == torch.device("cuda")


def test_precision64_on_cuda_raises_rather_than_leaving_the_kernel(monkeypatch, rng):
    """The kernel is float32: precision=64 on the card names the CPU parity
    lane instead of quietly running the plain path or casting down."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    vox = create_voxelizer(dimension=16, precision=64)
    coords = rng.uniform(-3, 3, size=(10, 3))
    with pytest.raises(ValueError, match="precision=64"):
        vox.forward_single(coords, None, 1.0)
    with pytest.raises(ValueError, match="precision=64"):
        vox.forward_batch([(coords, np.ones((10, 2)))])


@pytest.mark.parametrize("channelwise", [False, True])
def test_auto_impl_picks_by_device_and_float64_cuda_raises(monkeypatch, rng, channelwise):
    from molvoxel_torch.core.config import GridSpec
    from molvoxel_torch.ops.voxelize import default_impl, voxelize

    coords = torch.as_tensor(rng.uniform(-3, 3, size=(10, 3)))  # float64
    assert default_impl(coords) == "dense"
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert default_impl(coords) == "cuda" and default_impl(coords.float()) == "cuda"
    radii = torch.ones(2 if channelwise else 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="precision=64"):
        voxelize(coords, torch.ones((10, 2), dtype=torch.float64), radii, spec=GridSpec(0.5, 16),
                 channelwise_radii=channelwise)


@pytest.mark.parametrize("arg", ["coords", "features", "center", "batch"])
def test_inputs_that_require_grad_raise(rng, arg):
    """The public forward_* are not differentiable (as in the JAX package):
    they raise rather than cutting a tensor from the graph, naming the
    differentiable entry points."""
    vox = create_voxelizer(dimension=16, device="cpu")
    coords = torch.as_tensor(rng.uniform(-3, 3, size=(10, 3)).astype(np.float32))
    features = torch.as_tensor(rng.uniform(0, 1, size=(10, 2)).astype(np.float32))
    center = torch.zeros(3)
    {"coords": coords, "features": features, "center": center, "batch": features}[arg].requires_grad_()
    with pytest.raises(NotImplementedError, match="ops.batch.voxelize_batch or molvoxel_torch.nn.VoxelizeLayer"):
        if arg == "batch":
            vox.forward_batch([(coords.detach(), features)])
        else:
            vox.forward_features(coords, center, features, 1.0)


def test_cuda_impl_on_cpu_tensors_raises(rng):
    vox = create_voxelizer(dimension=16, device="cpu", impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        vox.forward_single(rng.uniform(-3, 3, size=(10, 3)).astype(np.float32), None, 1.0)


def test_gaussian_notrunc_names_its_roadmap_item(rng):
    """gaussian_notrunc, which raised before it was ported, runs on the CPU
    through the separable product, and impl="dense" runs the dense path."""
    from molvoxel_torch.ops.dense import voxelize_dense

    coords = rng.uniform(-3, 3, size=(10, 3)).astype(np.float32)
    vox = create_voxelizer(dimension=16, density_type="gaussian_notrunc", device="cpu")
    out = vox.forward_single(coords, None, 1.0)
    dense = create_voxelizer(dimension=16, density_type="gaussian_notrunc", device="cpu", impl="dense")
    want = voxelize_dense(torch.as_tensor(coords), torch.ones(10, 1), torch.ones(10), spec=vox.spec,
                          density_type="gaussian_notrunc")
    np.testing.assert_allclose(dense.forward_single(coords, None, 1.0).numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_public_exports():
    for name in ("create_voxelizer", "create_random_transform", "Voxelizer", "GridSpec", "VoxelizerConfig",
                 "Transform", "RandomTransform", "__version__"):
        assert hasattr(molvoxel_torch, name) and name in molvoxel_torch.__all__
    assert deposit.launches["deposit_fwd"] >= 0


# the JAX package's names whose counterpart in the port has another name
RENAMED = {"notrunc_use_pallas": "notrunc_separable"}
# the Pallas kernels' module: its counterpart is ops/deposit.py
PALLAS_ONLY = ("molvoxel_tpu.ops.pallas_deposit",)


def _public_surface(package):
    """{module path below the package: {public class / function name: object}},
    counting names defined in the package (its own or re-exported)."""
    import importlib
    import inspect
    import pkgutil

    root = importlib.import_module(package)
    out = {}
    for name in [package] + [m.name for m in pkgutil.walk_packages(root.__path__, package + ".")]:
        if name in PALLAS_ONLY or any(part.startswith("_") for part in name.split(".")[1:]):
            continue
        mod = importlib.import_module(name)
        out[name[len(package):]] = {
            k: v for k, v in vars(mod).items()
            if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", "").startswith(package)
        }
    return out


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """Every public module, class and function of molvoxel_tpu has one at
    the same module path in molvoxel_torch, but for the Pallas kernels'
    module (ops/pallas_deposit.py, whose counterpart is ops/deposit.py) and
    the renamed notrunc_use_pallas (notrunc_separable: the same decision,
    asked the other way round)."""
    import importlib

    jax_side, port = _public_surface("molvoxel_tpu"), _public_surface("molvoxel_torch")
    missing = []
    for path, names in sorted(jax_side.items()):
        if path not in port:
            missing.append(f"module molvoxel_torch{path}")
            continue
        mod = importlib.import_module("molvoxel_torch" + path)
        for name, obj in sorted(names.items()):
            target = RENAMED.get(name, name)
            home = importlib.import_module(obj.__module__.replace("molvoxel_tpu", "molvoxel_torch", 1))
            if not (hasattr(mod, target) or (name in RENAMED and hasattr(home, target))):
                missing.append(f"molvoxel_torch{path}.{target}")
    assert not missing, missing
    for path in (".interop", ".data.wrapper", ".data.rdkit_adapter", ".parallel.mesh", ".parallel.sharded",
                 ".parallel.multihost", ".viz.atom_colors", ".viz.pymol_session"):
        assert path in port


def test_small_surface_counterparts(rng, tmp_path):
    """__version__, default_backend_impl, default_batch_impl, grid_flat_padding,
    the voxelizer module's re-exports and voxelize_batch(materialize=)."""
    import molvoxel_torch.voxelizer as tvox
    import molvoxel_tpu
    from molvoxel_torch.api.voxelizer import default_backend_impl
    from molvoxel_torch.core.config import GridSpec, grid_flat_padding
    from molvoxel_torch.core.transform import RandomTransform, Transform
    from molvoxel_torch.ops.batch import voxelize_batch
    from molvoxel_torch.ops.voxelize import default_batch_impl
    from molvoxel_tpu.core.config import grid_flat_padding as jax_grid_flat_padding

    assert molvoxel_torch.__version__ == molvoxel_tpu.__version__ == "0.1.0"
    assert default_backend_impl() == "cuda" and default_backend_impl("cpu") == "dense"
    assert default_batch_impl(torch.zeros(2, 3)) == "dense"
    for dim in (1, 16, 48, 50, 64):
        assert grid_flat_padding(GridSpec(0.5, dim)) == jax_grid_flat_padding(JSpec(0.5, dim))
    assert grid_flat_padding(GridSpec(0.5, 20), lane=64) == (400, 448)
    assert tvox.RandomTransform is RandomTransform and tvox.Transform is Transform
    coords = torch.as_tensor(rng.uniform(-3, 3, size=(2, 10, 3)).astype(np.float32))
    w = torch.ones(2, 10, 2)
    plain = voxelize_batch(coords, w, torch.ones(10), None, None, spec=GridSpec(0.5, 12))
    assert torch.equal(voxelize_batch(coords, w, torch.ones(10), None, None, spec=GridSpec(0.5, 12),
                                      materialize=True), plain)


def test_enable_compilation_cache_moves_the_build_directories(tmp_path):
    from molvoxel_torch.native import build as native_build
    from molvoxel_torch.ops import _build
    from molvoxel_torch.utils import enable_compilation_cache

    default = _build.BUILD_DIR
    assert default == _build.DEFAULT_BUILD_DIR == native_build.BUILD_DIR
    assert default.parts[-2:] == ("build", "molvoxel_torch")
    try:
        assert enable_compilation_cache(tmp_path / "cache") == tmp_path / "cache"
        assert _build.library_path("deposit_fwd").parent == tmp_path / "cache"
        assert native_build.library_path().parent == tmp_path / "cache"
    finally:
        assert enable_compilation_cache() == default
    assert _build.BUILD_DIR == native_build.BUILD_DIR == default


def test_import_loads_no_jax_and_no_molvoxel_tpu():
    """Every module of the port imports without JAX, ml_dtypes or the JAX
    package (the card machine has neither of the first two)."""
    code = (
        "import sys, molvoxel_torch, molvoxel_torch.ops.deposit, molvoxel_torch.ops.batch, "
        "molvoxel_torch.ops.autodiff, molvoxel_torch.ops.separable, molvoxel_torch.nn, "
        "molvoxel_torch.data.pipeline, molvoxel_torch.core.state, molvoxel_torch.data, molvoxel_torch.data.feed, "
        "molvoxel_torch.data.parsers, molvoxel_torch.data.getter, molvoxel_torch.data.pointcloud, "
        "molvoxel_torch.data.gridstore, molvoxel_torch.native, molvoxel_torch.native.fastparse, "
        "molvoxel_torch.native.build, molvoxel_torch.parallel, molvoxel_torch.parallel.stream, "
        "molvoxel_torch.cli, molvoxel_torch.utils.timing, molvoxel_torch.viz, molvoxel_torch.viz.dx, "
        "molvoxel_torch.viz.atom_colors, molvoxel_torch.viz.pymol_session, molvoxel_torch.data.wrapper, "
        "molvoxel_torch.data.rdkit_adapter, molvoxel_torch.interop, molvoxel_torch.parallel.mesh, "
        "molvoxel_torch.parallel.sharded, molvoxel_torch.parallel.multihost, molvoxel_torch.voxelizer; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'molvoxel_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_torch_examples_load_no_jax_and_no_molvoxel_tpu():
    """The example programs examples/torch_*.py import torch, numpy and
    molvoxel_torch only."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py"))
    assert names == ["torch_multihost", "torch_pose_optimize", "torch_screen_library", "torch_train_cnn",
                     "torch_voxelize_complex"]
    code = (
        f"import sys; sys.path.insert(0, 'examples'); import {', '.join(names)}; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'molvoxel_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_readme_port_snippet(rng):
    vox = create_voxelizer(resolution=0.5, dimension=16, device="cpu")
    coords = rng.uniform(-3, 3, size=(30, 3)).astype(np.float32)
    features = rng.uniform(0, 1, size=(30, 5)).astype(np.float32)
    grid = vox.forward_features(coords, coords.mean(0), features, 1.0)
    assert grid.shape == (5, 16, 16, 16)
    clouds = [(coords, features), (coords[:20], features[:20])]
    grids = vox.forward_batch(clouds, radii=1.0, random_rotation=True, random_translation=0.5,
                              out_dtype="bfloat16")
    assert grids.shape == (2, 5, 16, 16, 16) and grids.dtype == torch.bfloat16
    assert bool(torch.isfinite(grids.float()).all()) and float(grids.float().sum()) > 0
