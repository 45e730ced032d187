"""molvoxel_torch.parallel's meshes and sharded calls against the JAX package, on the CPU.

Gloo process groups of 2 and 4 ranks (tests/torch_dist_worker.py, fresh
interpreters joined through a file under tmp_path) run voxelize_batch_dp,
voxelize_depth_sharded, voxelize_batch_2d and the mesh stream at 16^3; the
JAX package's functions run in this process on (2, 1), (1, 2) and (2, 2)
meshes of its 8 CPU devices.  Bars: 1e-5 (f32), 2^-7 x max (bf16); a sharded
call with augmentation equals one full call under the same draws, and a
depth slab of a rotated molecule equals the same planes of the full-depth
grid.  One-rank meshes run in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.core.transform import do_random_transform
from molvoxel_torch.ops.batch import voxelize_batch
from molvoxel_torch.ops.voxelize import voxelize
from molvoxel_torch.parallel import (
    DATA_AXIS,
    DEPTH_AXIS,
    data_sharding,
    make_mesh,
    pad_batch_to_mesh,
    replicated_sharding,
    voxelize_batch_2d,
    voxelize_batch_dp,
    voxelize_depth_sharded,
)
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.parallel import make_mesh as jax_make_mesh
from molvoxel_tpu.parallel import pad_batch_to_mesh as jax_pad_batch_to_mesh
from molvoxel_tpu.parallel import voxelize_batch_2d as jax_2d
from molvoxel_tpu.parallel import voxelize_batch_dp as jax_dp
from molvoxel_tpu.parallel import voxelize_depth_sharded as jax_depth

from .torch_dist_worker import run_ranks

SPEC, JSPEC = GridSpec(0.5, 16), JSpec(0.5, 16)


def _inputs(b=4, vp=32, v=25, c=3, seed=20260817):
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    centers = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    return dict(coords=coords, weights=weights, radii=np.ones((vp,), np.float32), mask=mask, centers=centers)


def _jax_args(inp, b):
    return (jnp.asarray(inp["coords"]), jnp.asarray(inp["weights"]), jnp.asarray(inp["radii"]),
            jnp.asarray(inp["mask"]), jnp.asarray(inp["centers"]), jax.random.split(jax.random.PRNGKey(0), b), 0.0)


def _torch_args(inp):
    return tuple(torch.from_numpy(inp[k]) for k in ("coords", "weights", "radii", "mask", "centers"))


def _one_molecule(inp):
    """(coords, weights, radii, mask, center) of the batch's first molecule."""
    return tuple(torch.from_numpy(inp[k] if k == "radii" else inp[k][0])
                 for k in ("coords", "weights", "radii", "mask", "centers"))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("world2")
    lib = chip_smoke.write_library(out / "lib.sdf", 24, seed=6, all_h_at=2, empty_at=9)
    np.savez(out / "inputs.npz", sdf_path=str(lib), **inputs)
    run_ranks("world2", 2, out / "inputs.npz", out)
    return dict(np.load(out / "world2.npz")), [dict(np.load(out / f"world2_local{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    np.savez(out / "inputs.npz", **inputs)
    run_ranks("world4", 4, out / "inputs.npz", out)
    return dict(np.load(out / "world4.npz")), [dict(np.load(out / f"world4_local{r}.npz")) for r in range(4)]


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process (no launcher), taken down after."""
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ meshes


def test_one_rank_mesh_needs_no_launcher(one_rank):
    mesh = one_rank
    assert mesh.mesh_dim_names == (DATA_AXIS, DEPTH_AXIS) == ("data", "depth")
    assert (mesh.size(0), mesh.size(1)) == (1, 1) and mesh.device_type == "cpu"
    assert dist.get_backend() == "gloo"
    assert pad_batch_to_mesh(5, mesh) == 5
    assert [str(p) for p in data_sharding(mesh)] == ["S(0)", "R"]
    assert [str(p) for p in replicated_sharding(mesh)] == ["R", "R"]
    with pytest.raises(ValueError, match="device count 1"):
        make_mesh(depth=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1"):
        make_mesh(2, 1, device="cpu")


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """The default device is the card; with none, no group is started and
    nothing falls back to gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert not dist.is_initialized()


def test_meshes_and_their_errors_over_ranks(world2):
    res, _ = world2
    assert res["raises_mesh_3x1"] and res["raises_depth_3"]
    assert res["raises_odd_batch"] and res["raises_depth_dim"]


def test_pad_batch_to_mesh_matches_jax():
    class Mesh:  # pad_batch_to_mesh reads the data axis size alone
        def size(self, dim):
            return {0: 4, 1: 2}[dim]

    jmesh = jax_make_mesh(4, 2)
    for b in (1, 4, 5, 8, 9):
        assert pad_batch_to_mesh(b, Mesh()) == jax_pad_batch_to_mesh(b, jmesh)


# ------------------------------------------------------- data parallel


def test_dp_equals_jax(world2, inputs):
    res, _ = world2
    want = np.asarray(jax_dp(*_jax_args(inputs, 4), mesh=jax_make_mesh(2, 1, devices=jax.devices()[:2]), spec=JSPEC,
                             impl="dense"))
    np.testing.assert_allclose(res["dp_plain"], want, rtol=0, atol=1e-5)


def test_dp_bf16_equals_jax(world2, inputs):
    res, _ = world2
    want = np.asarray(jax_dp(*_jax_args(inputs, 4), mesh=jax_make_mesh(2, 1, devices=jax.devices()[:2]), spec=JSPEC,
                             impl="dense", out_dtype="bfloat16"), np.float32)
    np.testing.assert_allclose(res["dp_bf16"], want, rtol=0, atol=2**-7 * max(float(np.abs(want).max()), 1.0))


def test_dp_equals_one_call_and_local_rows(world2, inputs):
    """Bit for bit one voxelize_batch call, with and without augmentation,
    on full and on DTensor inputs; each rank holds its two rows."""
    res, local = world2
    args = _torch_args(inputs)
    assert np.array_equal(res["dp_plain"], voxelize_batch(*args, None, 0.0, spec=SPEC).numpy())
    assert np.array_equal(res["dp_dtensor"], res["dp_plain"])
    aug = voxelize_batch(*args, torch.Generator().manual_seed(5), 0.5, spec=SPEC, random_rotation=True).numpy()
    assert np.array_equal(res["dp_aug"], aug) and not np.array_equal(aug, res["dp_plain"])
    for r in range(2):
        assert np.array_equal(local[r]["dp_plain"], res["dp_plain"][2 * r:2 * r + 2])


def test_dp_one_rank(one_rank, inputs):
    args = _torch_args(inputs)
    out = voxelize_batch_dp(*args, torch.Generator().manual_seed(3), 0.5, mesh=one_rank, spec=SPEC,
                            random_rotation=True)
    want = voxelize_batch(*args, torch.Generator().manual_seed(3), 0.5, spec=SPEC, random_rotation=True)
    assert [str(p) for p in out.placements] == ["S(0)", "R"]
    assert torch.equal(out.full_tensor(), want) and torch.equal(out.to_local(), want)


# --------------------------------------------------------- depth sharded


def test_depth_sharded_equals_jax(world2, inputs):
    res, local = world2
    crd, w, r, m, cen = (jnp.asarray(inputs[k][0] if k != "radii" else inputs[k])
                         for k in ("coords", "weights", "radii", "mask", "centers"))
    want = np.asarray(jax_depth(crd, w, r, m, cen, jax.random.PRNGKey(0), 0.0,
                                mesh=jax_make_mesh(1, 2, devices=jax.devices()[:2]), spec=JSPEC, impl="dense"))
    np.testing.assert_allclose(res["depth_plain"], want, rtol=0, atol=1e-5)
    for r in range(2):  # each rank holds its 8 planes
        assert np.array_equal(local[r]["depth_plain"], res["depth_plain"][:, 8 * r:8 * r + 8])


def test_depth_sharded_rotation_is_one_transform(world2, inputs):
    """Depth ranks seeded differently still rotate alike: the assembled
    grid is the full-depth grid under rank 0's draw, not slabs of two
    differently rotated molecules."""
    res, _ = world2
    crd, w, r, m, cen = _one_molecule(inputs)
    placed = do_random_transform(torch.Generator().manual_seed(100), crd - cen, None, 0.5, True)
    want = voxelize(placed, w, r, spec=SPEC, mask=m).numpy()
    other = voxelize(do_random_transform(torch.Generator().manual_seed(101), crd - cen, None, 0.5, True), w, r,
                     spec=SPEC, mask=m).numpy()
    np.testing.assert_allclose(res["depth_rot"], want, rtol=0, atol=1e-5)
    assert np.abs(res["depth_rot"][:, 8:] - other[:, 8:]).max() > 1e-3  # rank 1's own draw is not used


@pytest.mark.parametrize("rotate", [False, True])
def test_depth_sharded_one_rank(one_rank, inputs, rotate):
    crd, w, r, m, cen = _one_molecule(inputs)
    out = voxelize_depth_sharded(crd, w, r, m, cen, torch.Generator().manual_seed(4), 0.5 if rotate else 0.0,
                                 mesh=one_rank, spec=SPEC, random_rotation=rotate)
    placed = do_random_transform(torch.Generator().manual_seed(4), crd - cen, None, 0.5 if rotate else 0.0, rotate)
    assert [str(p) for p in out.placements] == ["R", "S(1)"]
    assert torch.equal(out.full_tensor(), voxelize(placed, w, r, spec=SPEC, mask=m))


# -------------------------------------------------------------------- 2-D


def test_2d_equals_jax(world4, inputs):
    res, local = world4
    grids, mass = jax_2d(*_jax_args(inputs, 4), mesh=jax_make_mesh(2, 2, devices=jax.devices()[:4]), spec=JSPEC,
                         impl="dense")
    np.testing.assert_allclose(res["twod_plain"], np.asarray(grids), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(res["twod_mass"]), float(mass), rtol=1e-5)
    np.testing.assert_allclose(float(res["twod_mass"]), float(res["twod_plain"].sum(dtype=np.float64)), rtol=1e-5)
    for rank in range(4):  # rank = 2 * data + depth: rows 2*data.., planes 8*depth..
        d, z = divmod(rank, 2)
        assert np.array_equal(local[rank]["twod_plain"], res["twod_plain"][2 * d:2 * d + 2, :, 8 * z:8 * z + 8])


def test_2d_rotation_is_one_draw(world4, inputs):
    """The depth ranks were seeded apart: every grid is still one molecule
    under generator 7's draw."""
    res, _ = world4
    want = voxelize_batch(*_torch_args(inputs), torch.Generator().manual_seed(7), 0.5, spec=SPEC,
                          random_rotation=True).numpy()
    np.testing.assert_allclose(res["twod_rot"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(res["twod_rot_mass"]), float(want.sum(dtype=np.float64)), rtol=1e-5)


def test_depth_and_dp_on_2x2_mesh(world4, inputs):
    res, _ = world4
    args = _torch_args(inputs)
    assert np.array_equal(res["dp22"], voxelize_batch(*args, None, 0.0, spec=SPEC).numpy())
    crd, w, r, m, cen = _one_molecule(inputs)
    np.testing.assert_allclose(res["depth22"], voxelize(crd - cen, w, r, spec=SPEC, mask=m).numpy(), rtol=0,
                               atol=1e-5)


def test_2d_one_rank(one_rank, inputs):
    args = _torch_args(inputs)
    grids, mass = voxelize_batch_2d(*args, None, 0.0, mesh=one_rank, spec=SPEC)
    want = voxelize_batch(*args, None, 0.0, spec=SPEC)
    assert [str(p) for p in grids.placements] == ["S(0)", "S(2)"]
    assert torch.equal(grids.full_tensor(), want)
    assert float(mass.full_tensor()) == pytest.approx(float(want.double().sum()), rel=1e-5)


# ------------------------------------------------------------ mesh stream


def test_mesh_stream_equals_meshless_stream(world2):
    """StreamingVoxelizer(mesh=) over two ranks, augmented: the grids of the
    meshless stream under the same seed, bit for bit."""
    res, _ = world2
    assert res["stream_mesh"].shape == (24, 4, 16, 16, 16)
    assert np.array_equal(res["stream_mesh"], res["stream_plain"])


def test_mesh_stream_one_rank_equals_jax(one_rank, tmp_path):
    """No augmentation: the one-rank mesh stream's grids equal the JAX
    package's mesh stream at 1e-5."""
    from molvoxel_torch.data.feed import SDFBatchFeeder
    from molvoxel_torch.parallel import StreamingVoxelizer
    from molvoxel_tpu.data.feed import SDFBatchFeeder as JFeeder
    from molvoxel_tpu.parallel.stream import StreamingVoxelizer as JStreamingVoxelizer

    lib = chip_smoke.write_library(tmp_path / "lib.sdf", 20, seed=8, all_h_at=3, empty_at=12)
    got, want = [], []
    StreamingVoxelizer(SPEC, batch_size=8, device="cpu", mesh=one_rank).run_batches(
        SDFBatchFeeder(lib, ["C", "N", "O", "S"], batch_size=8), lambda im, b: got.append(im.full_tensor()))
    JStreamingVoxelizer(JSPEC, batch_size=8, mesh=jax_make_mesh(2, 1, devices=jax.devices()[:2])).run_batches(
        JFeeder(lib, ["C", "N", "O", "S"], batch_size=8), lambda im, b: want.append(np.asarray(im)))
    np.testing.assert_allclose(torch.cat(got).numpy(), np.concatenate(want), rtol=0, atol=1e-5)
