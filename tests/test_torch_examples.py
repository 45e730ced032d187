"""The torch example programs (examples/torch_*.py) against the JAX package on the CPU.

Each program's computation is held against the JAX package on the same
numpy inputs (the JAX examples' own bodies, fed the golden fixtures), each
program's ``main`` runs on the CPU to its own asserts at a small size, and
without ``device="cpu"`` each raises here, where there is no card."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.ops.batch import draw_transforms
from molvoxel_torch.viz import read_dx
from molvoxel_tpu import create_voxelizer as jax_create_voxelizer
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.core.transform import apply_quaternion as jax_apply_quaternion
from molvoxel_tpu.core.transform import do_transform as jax_do_transform
from molvoxel_tpu.data import AtomTypeGetter as JAtomTypeGetter
from molvoxel_tpu.data import BondTypeGetter as JBondTypeGetter
from molvoxel_tpu.data import ComplexPointCloudMaker as JComplexPointCloudMaker
from molvoxel_tpu.data import ComplexWrapper as JComplexWrapper
from molvoxel_tpu.data import SDFBatchFeeder as JSDFBatchFeeder
from molvoxel_tpu.data import SimpleMolecule as JSimpleMolecule
from molvoxel_tpu.data import iter_sdf as jax_iter_sdf
from molvoxel_tpu.ops.batch import voxelize_batch as jax_voxelize_batch
from molvoxel_tpu.ops.voxelize import voxelize as jax_voxelize

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))

import torch_multihost  # noqa: E402
import torch_pose_optimize  # noqa: E402
import torch_screen_library  # noqa: E402
import torch_train_cnn  # noqa: E402
import torch_voxelize_complex  # noqa: E402

GRAD_BAR = 5e-3  # the gate's backward bar (tools/round_gate.py:230)


def _keys(b):
    return jax.random.split(jax.random.PRNGKey(0), b)


# ---------------------------------------------------------------- pose


def test_pose_loss_and_gradient_match_jax():
    """The pose loss at the start pose, and its gradient in (q, t), against
    jax.value_and_grad through the JAX package's voxelize at sigma 1.0, 24^3."""
    coords0 = torch_pose_optimize.ligand_coords()
    q_true, t_true = torch_pose_optimize.hidden_pose(0)
    q0, t0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32), np.zeros(3, np.float32)

    jspec = JSpec(resolution=0.5, dimension=24)
    ones = jnp.ones(coords0.shape[0], jnp.float32)

    def jgrid(coords):
        return jax_voxelize(coords, ones[:, None], ones, spec=jspec, sigma=1.0)

    def jpose(q, t):
        return jax_apply_quaternion(jnp.asarray(coords0), q / jnp.linalg.norm(q)) + t

    target = jgrid(jpose(jnp.asarray(q_true), jnp.asarray(t_true)))
    want, (want_q, want_t) = jax.value_and_grad(
        lambda q, t: jnp.mean((jgrid(jpose(q, t)) - target) ** 2) * 1e4, argnums=(0, 1))(jnp.asarray(q0),
                                                                                           jnp.asarray(t0))

    spec = TSpec(resolution=0.5, dimension=24)
    c0 = torch.as_tensor(coords0)
    t_target = torch_pose_optimize.density(
        torch_pose_optimize.pose_coords(c0, torch.as_tensor(q_true), torch.as_tensor(t_true)), spec)
    q, t = torch.tensor(q0, requires_grad=True), torch.tensor(t0, requires_grad=True)
    loss = torch_pose_optimize.pose_loss(c0, q, t, t_target, spec)
    loss.backward()
    assert float(want) > 1.0  # the start pose is off the target
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for got, ref in ((q.grad.numpy(), np.asarray(want_q)), (t.grad.numpy(), np.asarray(want_t))):
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(got - ref).max()) <= GRAD_BAR * scale, (got, ref)


def test_pose_main_converges_on_cpu():
    r0, r1 = torch_pose_optimize.main(steps=120, dim=24, device="cpu")
    assert r1 < r0 / 10


# ------------------------------------------------------------ train_cnn


def test_train_cnn_batch_and_flax_model_match_jax():
    """The first batch voxelized under explicit transforms against the JAX
    package's voxelize_batch, and the JAX example's flax model, carried
    across by load_flax_params, against the torch model on it."""
    pytest.importorskip("flax")
    pytest.importorskip("optax")
    import train_cnn  # the JAX example

    rng = np.random.default_rng(0)
    coords, weights, mask, labels = torch_train_cnn.make_dataset(np.random.default_rng(0))
    for got, want in zip((coords, weights, mask, labels), train_cnn.make_dataset(np.random.default_rng(0))):
        np.testing.assert_array_equal(got, np.asarray(want))
    idx = rng.choice(coords.shape[0], torch_train_cnn.BATCH, replace=False)
    q = rng.normal(size=(len(idx), 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.uniform(-0.5, 0.5, (len(idx), 3)).astype(np.float32)

    placed = jax.vmap(lambda c, qq, tt: jax_do_transform(c, None, tt, qq))(jnp.asarray(coords[idx]), q, t)
    want = np.asarray(jax_voxelize_batch(placed, jnp.asarray(weights[idx]), jnp.ones((coords.shape[1],)),
                                         jnp.asarray(mask[idx]), None, _keys(len(idx)), 0.0,
                                         spec=JSpec(0.5, 16), density_type="gaussian", sigma=0.5))
    got = torch_train_cnn.voxelize(*(torch.as_tensor(a[idx]) for a in (coords, weights, mask)),
                                   transforms=(torch.as_tensor(q), torch.as_tensor(t)))
    assert got.shape == want.shape == (16, 2, 16, 16, 16) and float(got.sum()) > 0
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5

    flax_model = train_cnn.VoxelCNN()
    params = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 16, 16, 16)))
    want_pred = np.asarray(flax_model.apply(params, jnp.asarray(want)))
    model = torch_train_cnn.load_flax_params(torch_train_cnn.VoxelCNN(), jax.device_get(params))
    with torch.no_grad():
        pred = model(got)
    assert float(np.abs(pred.numpy() - want_pred).max()) <= 1e-5, (pred, want_pred)
    want_mse = float(np.mean((want_pred - labels[idx]) ** 2))
    mse = float(torch.nn.functional.mse_loss(pred, torch.as_tensor(labels[idx])))
    np.testing.assert_allclose(mse, want_mse, rtol=1e-5)


def test_train_cnn_main_reduces_the_loss_on_cpu():
    first, last, step_ms = torch_train_cnn.main(steps=30, device="cpu")
    assert last < 0.8 * first and step_ms > 0


# -------------------------------------------------------- screen_library


@pytest.fixture(scope="module")
def screen_lib(tmp_path_factory):
    path = tmp_path_factory.mktemp("screen") / "library.sdf"
    names = torch_screen_library.make_library(torch_screen_library.query_molecule(), path,
                                              np.random.default_rng(0), n_decoys=6)
    return path, names


def _jax_scores(path, dim, center):
    """The JAX example's score_batch body (examples/screen_library.py),
    with the path given; records centred on their centroids when ``center``."""
    spec = JSpec(resolution=0.5, dimension=dim)

    def grid_of(batch):
        centers = jnp.asarray(batch.centers) if center else None
        return jax_voxelize_batch(jnp.asarray(batch.coords), jnp.asarray(batch.weights),
                                  jnp.ones((batch.coords.shape[1],), jnp.float32), jnp.asarray(batch.mask), centers,
                                  _keys(batch.batch_size), 0.0, spec=spec, density_type="gaussian", sigma=0.5,
                                  random_rotation=False).reshape(batch.batch_size, -1)

    symbols = torch_screen_library.SYMBOLS
    qgrid = grid_of(next(iter(JSDFBatchFeeder(path, symbols, batch_size=1, shards=1))))[0]
    qnorm = jnp.linalg.norm(qgrid)
    scores = []
    for batch in JSDFBatchFeeder(path, symbols, batch_size=8):
        grids = grid_of(batch)
        s = (grids @ qgrid) / (jnp.linalg.norm(grids, axis=1) * qnorm + 1e-8)
        scores.extend(np.asarray(s)[batch.num_atoms > 0].tolist())
    return np.asarray(scores)


def test_screen_library_is_the_jax_examples_library(screen_lib, tmp_path):
    import screen_library  # the JAX example

    path, names = screen_lib
    q = torch_screen_library.query_molecule()
    want = screen_library.make_library(JSimpleMolecule(q.coords, q.symbols, [], "query"), tmp_path / "lib.sdf",
                                       np.random.default_rng(0), n_decoys=6)
    assert names == want
    got, ref = (list(jax_iter_sdf(p)) for p in (path, tmp_path / "lib.sdf"))
    assert [(m.name, m.symbols) for m in got] == [(m.name, m.symbols) for m in ref]
    for m, r in zip(got, ref):
        np.testing.assert_array_equal(m.coords, r.coords)


def test_screen_scores_match_jax(screen_lib):
    path, _ = screen_lib
    scores, records = torch_screen_library.screen(path, TSpec(0.5, 16), device="cpu")
    want = _jax_scores(path, 16, center=False)
    assert scores.shape == want.shape == (11,) and list(records) == list(range(11))
    assert float(np.abs(scores - want).max()) <= 1e-5
    assert list(np.argsort(scores)[::-1]) == list(np.argsort(want)[::-1])


def test_screen_main_ranks_the_query_and_neighbours_first():
    scores, names = torch_screen_library.main(n_decoys=6, dim=16, device="cpu")
    order = np.argsort(scores)[::-1]
    assert names[order[0]] == "query" and sum(names[i].startswith("neighbor") for i in order[:5]) >= 3


def test_screen_given_library_skips_atomless_records_and_matches_jax(tmp_path):
    """A library with an all-hydrogen record (3) and an empty one (11):
    both are left out, the rest centred and scored as the JAX package does."""
    path = chip_smoke.write_library(tmp_path / "lib.sdf", 40, seed=3, all_h_at=3, empty_at=11)
    scores, names = torch_screen_library.main(dim=16, library=path, device="cpu")
    assert len(scores) == 38 and "record-3" not in names and "record-11" not in names
    assert names[int(np.argmax(scores))] == "record-0"
    assert float(np.abs(scores - _jax_scores(path, 16, center=True)).max()) <= 1e-5


# ------------------------------------------------------ voxelize_complex


def test_complex_image_matches_jax_and_writes_the_fallback_session(tmp_path):
    image, aug, result = torch_voxelize_complex.main(out=tmp_path, device="cpu")
    ligand, pocket, center = torch_voxelize_complex.golden_complex()
    atoms = JAtomTypeGetter(torch_voxelize_complex.SYMBOLS)
    maker = JComplexPointCloudMaker(atoms, JBondTypeGetter.default(), atoms, None, channel_type="features")
    wrapper = JComplexWrapper(maker, jax_create_voxelizer(resolution=0.5, dimension=48, density_type="gaussian"))
    want = np.asarray(wrapper.run(*(JSimpleMolecule(m.coords, m.symbols, [], m.name) for m in (ligand, pocket)),
                                  center=center, radii=1.0))
    assert image.shape == want.shape == (12, 48, 48, 48) and float(image.sum()) > 0
    assert float(np.abs(image.numpy() - want).max()) <= 1e-5
    assert float(image[4:8].abs().max()) == 0.0  # the golden carries no bonds
    saved = np.load(tmp_path / "complex.npz")
    np.testing.assert_array_equal(saved["image"], image.numpy())
    assert result.suffix == ".pml" and result.exists()
    dx = sorted(result.parent.glob("*.dx"))  # the empty bond channels write none
    assert len(dx) == 8
    for f in dx:
        group, name = f.stem.split("_", 1)
        channel = torch_voxelize_complex.SYMBOLS.index(name) + (8 if group == "Protein" else 0)
        values, _, _ = read_dx(f)
        assert float(np.abs(values - image[channel].numpy()).max()) <= 1e-5
    assert not torch.equal(aug, image)


# ------------------------------------------------------------- multihost


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_mass(world):
    """The global batch's mass as the JAX package voxelizes it: every rank's
    rows under the transforms the port draws from the example's seed."""
    rows = [torch_multihost.local_rows(r) for r in range(world)]
    coords, weights, mask = (np.concatenate([r[k] for r in rows]) for k in range(3))
    q, t = (x.numpy() for x in draw_transforms(torch.Generator().manual_seed(torch_multihost.SEED), len(coords),
                                               0.5, True))
    placed = jax.vmap(lambda c, qq, tt: jax_do_transform(c, None, tt, qq))(jnp.asarray(coords), q, t)
    grids = jax_voxelize_batch(placed, jnp.asarray(weights), jnp.ones((coords.shape[1],)), jnp.asarray(mask),
                               None, _keys(len(coords)), 0.0, spec=JSpec(0.5, 32), density_type="gaussian")
    return float(np.asarray(grids, np.float64).sum())


def _mass(stdout):
    return [float(m) for m in re.findall(r"global mass = ([0-9.]+)", stdout)]


def test_multihost_single_process():
    out = subprocess.run([sys.executable, str(EXAMPLES / "torch_multihost.py"), "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "streamed 64 molecules in 4 batches" in out.stdout
    assert "streamed 32 local molecules" in out.stdout
    (mass,) = _mass(out.stdout)
    np.testing.assert_allclose(mass, _jax_mass(1), rtol=1e-5)


def test_multihost_two_gloo_ranks():
    """Two fresh interpreters joined over gloo through the environment."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="2")  # two ranks on a shared CPU
    procs = [subprocess.Popen([sys.executable, str(EXAMPLES / "torch_multihost.py"), "--device", "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    streamed = [int(m) for out, _ in outs for m in re.findall(r"streamed (\d+) molecules in", out)]
    assert len(streamed) == 2 and sum(streamed) == 64
    assert all("streamed 32 local molecules" in out for out, _ in outs)
    masses = [m for out, _ in outs for m in _mass(out)]
    assert len(masses) == 2 and masses[0] == masses[1]
    np.testing.assert_allclose(masses[0], _jax_mass(2), rtol=1e-5)


# ---------------------------------------------------------------- device


@pytest.mark.parametrize("module", [torch_pose_optimize, torch_train_cnn, torch_screen_library,
                                    torch_voxelize_complex, torch_multihost], ids=lambda m: m.__name__)
def test_main_runs_on_the_card_by_default_and_raises_without_one(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so main() would run on it")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        module.main()
