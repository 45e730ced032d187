"""The launch plans of the kernel route (ops/deposit.py ``LaunchPlan``) and
the transform table ``forward_batch`` stages with its batch
(core/transform.py ``draw_transform_table``), on the CPU.

A plan's launches run against a stand-in library on meta tensors (no card
here): built once a shape and reused, with the arguments the wrappers
pass, the preparation launched through it on both routes and the forward
where no input needs a gradient.
The table holds the draws of ``draw_transforms`` and the matrices of
``quaternion_to_matrix``; ``forward_batch`` with it gives the grids of
``voxelize_batch`` drawing the same transforms itself.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import molvoxel_torch
from molvoxel_torch.core.config import GridSpec
from molvoxel_torch.core.transform import draw_transform_table, quaternion_to_matrix
from molvoxel_torch.data import staging
from molvoxel_torch.ops import autodiff, deposit
from molvoxel_torch.ops import batch as batch_ops
from molvoxel_torch.utils import timing

AUGMENT = [(True, 0.5), (True, 0.0), (False, 0.5), (False, 0.0)]
SEEDS = (0, 7, 2**31 + 4343, 3758096417)


@contextlib.contextmanager
def cpu_profile():
    """A CPU profiler session with a record of its own."""
    with timing.span("molvoxel.untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        yield


def _parent_table(gen, b, translation, rotation):
    q, t = batch_ops.draw_transforms(gen, b, translation, rotation)
    rot = quaternion_to_matrix(q).reshape(b, 9) if q is not None else torch.zeros((b, 9))
    return torch.cat([rot, t if t is not None else torch.zeros((b, 3))], dim=1).numpy()


# --------------------------------------------------------------- the table


@pytest.mark.parametrize("rotation,translation", AUGMENT)
@pytest.mark.parametrize("b", [1, 16, 64])
def test_table_holds_the_parents_draws_and_matrices(b, rotation, translation):
    for seed in SEEDS:
        gen, parent = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        got = draw_transform_table(gen, b, translation, rotation)
        want = _parent_table(parent, b, translation, rotation)
        assert got.dtype == np.float32 and got.shape == (b, 12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # the same uniforms, in the same order: both generators stand at the same place after
        assert torch.equal(gen.get_state(), parent.get_state())
        assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=parent))
        if not rotation:
            assert not got[:, :9].any()
        if translation == 0.0:
            assert not got[:, 9:].any()


def test_table_written_into_a_given_buffer():
    out = np.full((5, 12), np.nan, np.float32)
    got = draw_transform_table(torch.Generator().manual_seed(3), 5, 0.5, True, out=out)
    assert got is out
    np.testing.assert_allclose(out, _parent_table(torch.Generator().manual_seed(3), 5, 0.5, True), atol=1e-6)


@pytest.mark.parametrize("b", [1, 16, 64])
def test_layout_grows_by_the_table_alone(b):
    base = staging.batch_layout(b, 64, 4, (64,), True)
    with_table = staging.batch_layout(b, 64, 4, (64,), True, True)
    assert with_table.payload - base.payload == 48 * b
    assert with_table.sections[:-1] == base.sections
    shape, dtype, torch_dtype, start, end = with_table.sections[-1]
    assert shape == (b, 12) and dtype == np.float32 and torch_dtype == torch.float32 and start % staging.ALIGN == 0
    assert staging.batch_layout(b, 64, 4, (64,), True, False) == base  # no section where nothing is drawn


def _clouds(rng, sizes, c=4):
    return [(rng.normal(scale=2.5, size=(v, 3)).astype(np.float32), rng.integers(0, c, v)) for v in sizes]


@pytest.mark.parametrize("rotation,translation", AUGMENT)
def test_forward_batch_stages_the_table_and_draws_nothing_else(rotation, translation, monkeypatch):
    """The layout ``forward_batch`` stages has the table section exactly
    when it draws, and ``voxelize_batch`` draws nothing itself."""
    layouts = []
    real = staging.unpinned
    monkeypatch.setattr(molvoxel_torch.api.voxelizer, "unpinned",
                        lambda layout: layouts.append(layout) or real(layout))
    monkeypatch.setattr(batch_ops, "draw_transforms", lambda *a: pytest.fail("voxelize_batch drew transforms"))
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=12, device="cpu")
    clouds = _clouds(np.random.default_rng(0), (20, 33))
    vox.forward_batch(clouds, random_rotation=rotation, random_translation=translation, key=5, num_channels=4)
    drawn = rotation or translation > 0.0
    assert layouts[-1] == staging.batch_layout(2, 64, 4, (64,), False, drawn)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotation,translation", AUGMENT)
def test_forward_batch_equals_voxelize_batch_drawing_the_same_transforms(out_dtype, rotation, translation):
    rng = np.random.default_rng(1)
    sizes, c, dim = (17, 40, 61), 4, 16
    clouds = _clouds(rng, sizes, c)
    centers = [crd.mean(0) for crd, _ in clouds]
    vox = molvoxel_torch.create_voxelizer(resolution=0.5, dimension=dim, device="cpu")
    for key in (11, 2**31 + 77):
        got = vox.forward_batch(clouds, centers=centers, random_rotation=rotation, random_translation=translation,
                                key=key, num_channels=c, out_dtype=out_dtype)
        layout = staging.batch_layout(len(sizes), 64, c, (64,), True)
        staged = staging.unpinned(layout)
        staging.stage_batch(staged.arrays, [crd for crd, _ in clouds], [t for _, t in clouds],
                            np.array(sizes), True, 1.0, np.stack(centers).astype(np.float32))
        coords, weights, radii, mask, ctr = layout.tensors(staged.host)
        want = batch_ops.voxelize_batch(coords, weights, radii, mask, ctr, torch.Generator().manual_seed(key),
                                        translation, spec=GridSpec(0.5, dim), random_rotation=rotation,
                                        out_dtype=out_dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-5)


# ----------------------------------------------------- plans, stand-in card


class FakeLib:
    """The three entry points the plans call, recording their arguments."""

    def __init__(self):
        self.calls = []

    def deposit_prep_setup(self):
        return 7

    def deposit_prep(self, *args):
        self.calls.append(("deposit_prep", args))
        return 0

    def deposit_fwd(self, *args):
        self.calls.append(("deposit_fwd", args))
        return 0

    def deposit_fwd_tile(self, *args):
        self.calls.append(("deposit_fwd_tile", args))
        return 0


@pytest.fixture
def card(monkeypatch):
    """Meta tensors stand in for the card's: the stand-in library, no
    device context or stream, an empty plan cache."""
    lib = FakeLib()
    monkeypatch.setattr(deposit, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(deposit, "_WIDE_CLUSTERS", {})
    monkeypatch.setattr(deposit, "_PLANS", {})
    monkeypatch.setattr(deposit, "_check_prep_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return lib


def _meta_batch(b, v, c, requires_grad=False):
    coords = torch.empty((b, v, 3), device="meta", requires_grad=requires_grad)
    weights = torch.empty((b, v, c), device="meta")
    return coords, weights, torch.empty((v,), device="meta"), torch.empty((b, v), dtype=torch.bool, device="meta")


def _table(b):
    return deposit.Transforms(torch.empty((b, 12), device="meta"), True, True)


SPEC = GridSpec(0.5, 48)


def _run(b, v, c, **kw):
    coords, weights, radii, mask = _meta_batch(b, v, c)
    return deposit.voxelize_deposit_batch(coords, weights, radii, spec=SPEC, mask=mask,
                                          centers=torch.empty((b, 3), device="meta"), transforms=_table(b), **kw)


def test_plan_built_once_a_shape_and_reused(card):
    with cpu_profile():
        grids = [_run(16, 3323, 1) for _ in range(3)] + [_run(64, 61, 4, out_dtype="bfloat16")]
        grids.append(_run(16, 3323, 1))
    counters = timing.snapshot()["counters"]
    assert counters["molvoxel.plan_builds"] == 2 and counters["molvoxel.plan_launches"] == 5
    assert len(deposit._PLANS) == 2
    # the complexes (52 chunks) take the tile launch, the ligands (one chunk) the brick
    assert [name for name, _ in card.calls] == ["deposit_prep", "deposit_fwd_tile"] * 3 + \
        ["deposit_prep", "deposit_fwd", "deposit_prep", "deposit_fwd_tile"]
    assert grids[0].shape == (16, 1, 48, 48, 48) and grids[0].dtype == torch.float32
    assert grids[3].shape == (64, 4, 48, 48, 48) and grids[3].dtype == torch.bfloat16
    with cpu_profile():
        _run(16, 3323, 1, out_dtype="float8_e4m3fn")  # a new output dtype is a new plan
        _run(16, 3323, 1, d_offset=8, d_count=16)  # and so is a new slab
    assert timing.snapshot()["counters"]["molvoxel.plan_builds"] == 2 and len(deposit._PLANS) == 4


def test_plans_count_nothing_untraced(card):
    with cpu_profile():
        with timing.span("molvoxel.probe"):
            pass
    _run(4, 100, 1)  # no profiler records
    counters = timing.snapshot()["counters"]
    assert not {"molvoxel.plan_builds", "molvoxel.plan_launches", "molvoxel.grid_bytes"} & set(counters)
    assert len(deposit._PLANS) == 1


@pytest.mark.parametrize("b,v,c,channelwise,density,out_dtype", [
    (16, 3323, 1, False, "gaussian", "float32"),
    (64, 61, 4, False, "gaussian", "bfloat16"),
    (2, 61, 4, True, "binary", "float32"),
    (1, 4096, 1, False, "gaussian_notrunc", "float32"),
])
def test_plan_launches_take_the_wrappers_arguments(card, b, v, c, channelwise, density, out_dtype):
    """Both launches of a plan pass what ``deposit_prep`` (through a plan
    of the preparation alone) and ``deposit_fwd`` (its launch worked out
    a call) pass for the same inputs, each launch counted once."""
    coords, weights, _, mask = _meta_batch(b, v, c)
    radii = torch.empty((c,) if channelwise else (v,), device="meta")
    centers = torch.empty((b, 3), device="meta")
    fn = deposit.voxelize_deposit_batch_channelwise if channelwise else deposit.voxelize_deposit_batch
    before = dict(deposit.launches)
    out = fn(coords, weights, radii, spec=SPEC, density_type=density, mask=mask, centers=centers,
             transforms=_table(b), out_dtype=out_dtype)
    (_, plan_prep), (entry, plan_fwd) = card.calls
    notrunc = density == "gaussian_notrunc"
    prep = deposit.PrepPlan(SPEC, density != "binary", 0.5, notrunc=notrunc, channelwise=channelwise)
    got = deposit.deposit_prep(coords, weights, radii, mask, centers, _table(b), prep)
    name, args = card.calls[-1]  # the same arguments after the ten pointers (the outputs' lie apart here)
    assert name == "deposit_prep" and len(args) == len(plan_prep) == 42 and args[10:] == plan_prep[10:]
    deposit.deposit_fwd(got.rows, got.weights, got.ranges, spec=SPEC, dl=got.dl, gaussian=prep.gaussian,
                        out_dtype=deposit.out_torch_dtype(out_dtype), notrunc=notrunc)
    name, args = card.calls[-1]
    assert name == entry and args[4:] == plan_fwd[4:]
    assert entry == ("deposit_fwd_tile" if deposit.fwd_tiles(got.rows.shape[2]) else "deposit_fwd")
    assert entry == ("deposit_fwd" if (v, channelwise) == (61, False) else "deposit_fwd_tile")
    assert deposit.launches == dict(before, deposit_prep=before["deposit_prep"] + 2, **{entry: before[entry] + 2})
    assert out.shape == (b, c, 48, 48, 48) and out.dtype == deposit.out_torch_dtype(out_dtype)


def test_prepare_batch_cuts_one_allocation_four_ways(card):
    coords, weights, radii, mask = _meta_batch(3, 200, 2)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, weights, radii, spec=SPEC, mask=mask)
    plan = next(iter(deposit._PLANS.values()))
    assert plan.fwd is None  # a preparation alone
    ht = deposit.range_rows(3, 2, 48, 48, 256)
    assert ht == deposit.TILE_RANGE_ROWS and rows.shape == (3, 8, 256) and wt.shape == (3, 2, 256) and ranges.shape == (3, -(-48 // ht), 4, 2)
    assert rows.dtype == wt.dtype == torch.float32 and ranges.dtype == torch.int32 and dl == 48 and gaussian
    assert all(t.is_contiguous() for t in (rows, wt, ranges))
    firsts = [start for _, _, start in plan.parts]
    assert firsts == sorted(firsts) and all(s % deposit._ALIGN_WORDS == 0 for s in firsts)
    for (shape, _, start), nxt in zip(plan.parts, firsts[1:] + [plan.words]):
        assert start + int(np.prod(shape)) <= nxt


def test_a_launch_constant_set_by_a_tool_makes_a_new_plan(card, monkeypatch):
    """A plan keeps the launch it was built with; a tool that sets a
    constant clears the plans, and the next call builds one of the new
    value."""
    for v, constant, entry, density in ((61, "TARGET_BLOCKS", "deposit_fwd", "gaussian"),
                                        (3323, "NOTRUNC_TARGET_BLOCKS", "deposit_fwd_tile", "gaussian_notrunc")):
        deposit._PLANS.clear()
        card.calls.clear()
        _run(16, v, 1, density_type=density)
        monkeypatch.setattr(deposit, constant, getattr(deposit, constant) * 4096)
        _run(16, v, 1, density_type=density)
        assert len(deposit._PLANS) == 1
        deposit._PLANS.clear()
        _run(16, v, 1, density_type=density)
        assert len(deposit._PLANS) == 1
        first, kept, second = (args for name, args in card.calls if name == entry)
        assert kept[4:] == first[4:] and second[4:] != first[4:]  # the blocks follow the constant


def test_inputs_that_need_a_gradient_take_the_autograd_functions(card, monkeypatch):
    """Inputs that need a gradient run both Functions around the shape's
    plan: its preparation launch, and the forward wrapper's launch with the
    plan's arguments.  Without a gradient the same plan launches both,
    with no Function."""
    applied = []
    for fn in (autodiff.PrepareFunction, autodiff.DepositFunction):
        real = fn.apply
        monkeypatch.setattr(fn, "apply", lambda *a, real=real, name=fn.__name__: applied.append(name) or real(*a))
    coords, weights, radii, mask = _meta_batch(2, 61, 4, requires_grad=True)
    with cpu_profile():
        deposit.voxelize_deposit_batch(coords, weights, radii, spec=SPEC, mask=mask, transforms=_table(2))
    assert applied == ["PrepareFunction", "DepositFunction"] and len(deposit._PLANS) == 1
    counters = timing.snapshot()["counters"]
    assert counters["molvoxel.plan_builds"] == 1 and counters["molvoxel.plan_launches"] == 1
    with torch.no_grad():  # nothing can flow back: the plan alone
        deposit.voxelize_deposit_batch(coords, weights, radii, spec=SPEC, mask=mask, transforms=_table(2))
    assert applied == ["PrepareFunction", "DepositFunction"] and len(deposit._PLANS) == 1
    (prep, grad_prep), (entry, grad_fwd), (_, plan_prep), (_, plan_fwd) = card.calls
    assert prep == "deposit_prep" and entry == "deposit_fwd" and len(card.calls) == 4
    assert grad_prep[10:] == plan_prep[10:] and grad_fwd[4:] == plan_fwd[4:]


# ------------------------------------------------- the autograd route (CPU)


def test_cpu_tensors_keep_the_autograd_route_and_build_no_plan(monkeypatch):
    monkeypatch.setattr(deposit, "_PLANS", {})
    rng = np.random.default_rng(2)
    coords = torch.as_tensor(rng.uniform(-3, 3, (2, 40, 3)).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.2, 1.0, (2, 40, 3)).astype(np.float32))
    with cpu_profile():
        out = deposit.voxelize_deposit_batch(coords, weights, torch.ones(40), spec=GridSpec(0.5, 12))
    assert out.shape == (2, 3, 12, 12, 12) and not deposit._PLANS
    assert "molvoxel.plan_builds" not in timing.snapshot()["counters"]


def test_voxelize_batch_gradients_come_from_the_autograd_functions(monkeypatch):
    """``voxelize_batch`` on the kernel route (CPU tensors: the plain
    versions behind the same Functions) with coordinates that need a
    gradient: the Functions run, and the gradients equal those of the two
    Functions composed by hand."""
    monkeypatch.setattr(batch_ops, "resolve_impl", lambda impl, coords: "cuda")
    monkeypatch.setattr(deposit, "_PLANS", {})
    applied = []
    real = autodiff.PrepareFunction.apply
    monkeypatch.setattr(autodiff.PrepareFunction, "apply", lambda *a: applied.append(1) or real(*a))
    rng = np.random.default_rng(3)
    b, v, c, spec = 2, 50, 3, GridSpec(0.5, 16)
    xyz = rng.uniform(-3, 3, (b, v, 3)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (b, v, c)).astype(np.float32)
    mask = torch.ones((b, v), dtype=torch.bool)
    mask[1, 45:] = False
    cot = torch.as_tensor(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))
    grads = []
    for by_hand in (False, True):
        coords = torch.tensor(xyz, requires_grad=True)
        weights = torch.tensor(w, requires_grad=True)
        transforms = batch_ops.draw_transforms(torch.Generator().manual_seed(9), b, 0.5, True)
        if by_hand:
            table = deposit.transform_table(transforms, "cpu")
            plan = deposit.PrepPlan(spec, True, 0.5)
            rows, wt, ranges, dl = autodiff.prepare(coords, weights, torch.ones(v), mask, None, table, plan)
            out = autodiff.deposit(rows, wt, ranges, spec=spec, dl=dl, gaussian=True).reshape(b, c, 16, 16, 16)
        else:
            out = batch_ops.voxelize_batch(coords, weights, torch.ones(v), mask, None, spec=spec,
                                           transforms=transforms)
        (out * cot).sum().backward()
        grads.append((out.detach(), coords.grad, weights.grad))
    assert applied == [1, 1] and not deposit._PLANS
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    assert grads[0][1].abs().sum() > 0
