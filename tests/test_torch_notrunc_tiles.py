"""The tile launches of molvoxel_torch.ops.deposit, and the threshold-row
(gaussian_notrunc) backward.

Molecules of more than one chunk take the tile forward kernel (warp
sub-bricks, ``tile_brick``), at the exact cutoff and on threshold rows;
threshold rows take their own backward (the atom walk in aligned groups of
``BWD_NOTRUNC_GROUP`` columns).  Here, on the CPU: the forward's sub-bricks
cover every voxel once within the kernel's budgets; the backward's groups
hold every voxel inside the threshold; one-chunk launches keep their
earlier arguments; every entry point passes ``notrunc`` to the wrappers;
the plain forward and backward on threshold rows agree with the JAX package
(Pallas in interpret mode), and the plain backward with a brute-force
sum."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.core.config import round_up
from molvoxel_torch.ops import autodiff, deposit
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch, voxelize_pallas_bwd_batch
from molvoxel_tpu.ops.voxelize import voxelize as jax_voxelize

GOLDENS = Path(__file__).parent / "goldens"
SMEM_MAX = 227 * 1024  # dynamic shared memory a block may take on an H100
GRAD_BAR = 5e-3  # the gate's backward bar, times max(1, gradient scale)
DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)

# ---------------------------------------------------------------- the plans

TILE_GRIDS = [(20, None), (20, (3, 11)), (33, None), (33, (5, 27)), (48, None), (64, None), (64, (20, 24)),
              (128, None), (256, None), (256, (128, 64))]
TILE_BATCHES = [(1, 1), (1, 4), (3, 4), (2, 8), (64, 4), (1, 12)]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16", "fp8"])
@pytest.mark.parametrize("dim,slab", TILE_GRIDS, ids=[f"dim{d}-{'slab' if s else 'full'}" for d, s in TILE_GRIDS])
def test_notrunc_tiles_cover_every_voxel_once(dim, slab, out_dtype):
    """The tile launch at both reaches, walked with the kernel's index
    arithmetic (work item -> tile, warp -> sub-brick, lane -> plane, row and
    run of w), writes every (channel, plane, row, column) exactly once,
    within the accumulators and the shared memory the kernel has, and each
    tile reads one plane-range row, which exists."""
    dl = dim if slab is None else slab[1]
    side = deposit.TILE_SIDE
    for (b, c), notrunc in ((bc, nt) for bc in TILE_BATCHES for nt in (True, False)):
        p = deposit.tile_brick(b, c, dl, dim, out_dtype, notrunc)
        lane_w = p.cols // 2
        assert lane_w * p.kct <= deposit.ACC_MAX
        assert (p.bd, p.bh, p.bw) in deposit.NOTRUNC_BLOCK_WARPS if notrunc else {p.bd, p.bh, p.bw} <= {1, 2}
        assert p.threads == 32 * p.bd * p.bh * p.bw <= deposit.BRICK_THREADS
        assert deposit.tile_smem(p) <= SMEM_MAX
        nct = -(-c // p.kct)
        assert sorted(cg * p.kct + k for cg in range(nct) for k in range(p.kct) if cg * p.kct + k < c) == list(range(c))
        ndt, nht, nwt = -(-dl // (side * p.bd)), -(-dim // (side * p.bh)), -(-dim // (p.cols * p.bw))
        hr = deposit.range_rows(b, c, dl, dim, 2 * deposit.CHUNK)  # the plane ranges' rows, which the tiles read
        h_first = np.arange(nht) * side * p.bh
        h_last = np.minimum(h_first + side * p.bh, dim) - 1
        assert (h_last // hr).max() < -(-dim // hr) and (h_first // hr == h_last // hr).all()
        item = np.arange(ndt * nht * nwt)  # one molecule and channel group; the others are disjoint copies
        wi, ti, di = item % nwt, (item // nwt) % nht, item // (nwt * nht)
        warp = np.arange(p.threads // 32)
        wd, wh, ww = warp // (p.bh * p.bw), (warp // p.bw) % p.bh, warp % p.bw
        lane = np.arange(32)
        dd, hh, wg = lane >> 3, (lane >> 1) & 3, lane & 1
        d = ((di * side * p.bd)[:, None] + side * wd[None, :])[:, :, None] + dd[None, None, :]
        h = ((ti * side * p.bh)[:, None] + side * wh[None, :])[:, :, None] + hh[None, None, :]
        wl = ((wi * p.cols * p.bw)[:, None] + p.cols * ww[None, :])[:, :, None] + lane_w * wg[None, None, :]
        w = wl[..., None] + np.arange(lane_w)
        live = ((d < dl) & (h < dim))[..., None] & (w < dim)
        flat = (((d[..., None] * dim) + h[..., None]) * dim + w)[live]
        np.testing.assert_array_equal(np.bincount(flat, minlength=dl * dim * dim), 1)


def test_notrunc_tiles_fill_the_card():
    """Threshold rows take the largest block of their list that still gives
    NOTRUNC_TARGET_BLOCKS blocks (or one warp a block); the exact reach two
    sub-bricks along each axis that holds an even number of them, else one
    (no warp without voxels), the two along w one warp of wide lanes in a
    launch of at least TILE_WIDE_WAVES waves of narrow warps (TILE_SM_WARPS
    on each of the card's SMs) whose channel group fits them; molecules of
    one chunk keep the brick."""
    side = deposit.TILE_SIDE
    for b, c, dim in ((1, 1, 48), (1, 1, 128), (1, 1, 256), (1, 8, 48), (4, 4, 48), (16, 1, 48), (16, 1, 128)):
        for out_dtype in DTYPES:
            p = deposit.tile_brick(b, c, dim, dim, out_dtype, notrunc=True)

            def blocks(bd, bh, bw):
                return b * -(-c // p.kct) * -(-dim // (side * bd)) * -(-dim // (side * bh)) * -(-dim // (p.cols * bw))

            assert blocks(p.bd, p.bh, p.bw) >= deposit.NOTRUNC_TARGET_BLOCKS or p.threads == 32
            larger = deposit.NOTRUNC_BLOCK_WARPS[:deposit.NOTRUNC_BLOCK_WARPS.index((p.bd, p.bh, p.bw))]
            assert all(blocks(*w) < deposit.NOTRUNC_TARGET_BLOCKS for w in larger)
            narrow = 16 if out_dtype.itemsize == 1 else 8
            for dl in (dim, 27, 8):
                e = deposit.tile_brick(b, c, dl, dim, out_dtype)
                even = [-(-n // side_n) % 2 == 0 for n, side_n in ((dl, side), (dim, side), (dim, 2 * narrow))]
                assert (e.bd, e.bh) == tuple(2 if x else 1 for x in even[:2])
                warps = b * -(-c // e.kct) * -(-dl // side) * -(-dim // side) * -(-dim // (2 * narrow))
                wave = deposit.TILE_SM_WARPS * deposit.card_sms()
                wide = even[2] and c * 2 * narrow <= deposit.ACC_MAX and warps >= deposit.TILE_WIDE_WAVES * wave
                assert (e.cols, e.bw) == ((4 * narrow, 1) if wide else (2 * narrow, 2 if even[2] else 1))
    # the protein cell: 8 x 8 x 32 voxels a block, one wide warp along w; the complex cell: 48 columns, 3 sub-bricks
    assert deposit.tile_brick(16, 1, 128, 128)[:5] == (2, 2, 1, 1, 32)
    assert deposit.tile_brick(16, 1, 48, 48)[:5] == (2, 2, 1, 1, 16)
    assert deposit.tile_brick(1, 1, 128, 128)[:5] == (2, 2, 2, 1, 16)  # one protein: too few warps to widen
    assert deposit.fwd_tiles(3264) and deposit.fwd_tiles(128) and not deposit.fwd_tiles(64)


def test_wide_lanes_follow_the_cards_sms(monkeypatch):
    """The wide-lane threshold is counted in waves of the card the plan is
    made for: 128^3 proteins widen from 4 a launch (10.3 waves of an H100's
    132 SMs) and keep narrow lanes at 2 (5.2 waves); on a card of half the
    SMs, 2 proteins are 10.3 waves and widen too."""
    assert deposit.card_sms() == (torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
                                  if torch.cuda.is_available() else deposit.H100_SMS)
    monkeypatch.setattr(deposit, "card_sms", lambda: 132)
    assert [deposit.tile_brick(b, 1, 128, 128).cols for b in (1, 2, 4, 8)] == [16, 16, 32, 32]
    monkeypatch.setattr(deposit, "card_sms", lambda: 66)
    assert [deposit.tile_brick(b, 1, 128, 128).cols for b in (1, 2, 4, 8)] == [16, 32, 32, 32]
    assert deposit.tile_brick(2, 1, 128, 128, notrunc=True).cols == 16  # threshold rows keep narrow lanes


@pytest.mark.parametrize("ct_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_notrunc_launch_per_grid(ct_dtype):
    """Threshold rows take deposit_bwd_notrunc where W is a multiple of
    BWD_NOTRUNC_GROUP (rows of whole groups, aligned vector loads), with
    the atom walk's arguments less ``gaussian`` (the same warps an atom);
    elsewhere (dims 21, 33) they keep the atom walk, which computes the same
    function."""
    kind = 0 if ct_dtype == torch.float32 else 1
    for b, vp, c in ((64, 64, 4), (1, 3264, 1), (1, 512, 8), (2, 128, 12)):
        for dim in (20, 21, 24, 33, 48, 64, 128, 256):
            dl = min(dim, 40)
            spec = TSpec(0.5, dim)
            walk = deposit.bwd_launch(b, vp, c, dl, spec, True, ct_dtype)
            got = deposit.bwd_launch(b, vp, c, dl, spec, True, ct_dtype, notrunc=True)
            assert walk[0] == "deposit_bwd" and walk[1][8] == kind
            if dim % deposit.BWD_NOTRUNC_GROUP == 0:
                assert got == ("deposit_bwd_notrunc", walk[1][:7] + walk[1][8:])
            else:
                assert got == walk


# ------------------------------------------------ the exact-cutoff launches


def _parent_brick_rows(b, c, dl, dim):
    """brick_rows as the exact-cutoff launch had it before threshold rows got
    their own tiles (a frozen copy)."""
    def tile(c_, run):
        cap = min(8, 32 // run)
        return next((k for k in (1, 2, 4, 8) if k >= c_ and k <= cap), cap)

    cap = None
    for run in (4, 8, 16):
        fits = (256 // -(-dim // run)) * (32 // (run * tile(c, run)))
        cap = fits if cap is None else min(cap, fits)
    nct = -(-c // tile(c, 4))
    rows = max(cap, 1)
    while True:
        ht = min(dim, rows)
        dt = min(dl, rows // ht)
        if b * nct * -(-dl // dt) * -(-dim // ht) >= 16 * 132 or (rows // 2) * -(-dim // 4) < 24:
            return dt, ht
        rows //= 2


def _parent_fwd_args(b, vp, c, dl, spec, gaussian, out_dtype):
    """The exact-cutoff forward's launch arguments before this change."""
    dim = spec.dimension
    dt, ht = _parent_brick_rows(b, c, dl, dim)
    run = 16 // out_dtype.itemsize
    cap = min(8, 32 // run)
    kct = next((k for k in (1, 2, 4, 8) if k >= c and k <= cap), cap)
    units = dt * ht * -(-dim // run)
    threads = min(256, round_up(units, 32))
    passes = -(-units // threads)
    kind = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}[out_dtype]
    return ("deposit_fwd", (b, vp, c, dl, dim, float(spec.resolution), float(spec.width / 2.0), int(gaussian), kind,
                            kct, threads, dt, ht, passes))


# (B, C, Dl, dim) of the exact-cutoff launches chip_smoke.py drives: the
# headline and training batches, the proteins, the sliced 256^3 ligand, the
# complexes, the pose ligand, the goldens' grids, the library stream and
# dataset, slabs of the two-rank run; then a sweep of the rest.
MAIN_SHAPES = [(64, 4, 64, 64), (1, 1, 48, 48), (1, 1, 128, 128), (4, 4, 64, 256), (1, 4, 64, 256), (1, 8, 48, 48),
               (8, 8, 48, 48), (1, 1, 32, 32), (64, 16, 64, 64), (1, 4, 256, 256), (1024, 4, 64, 64), (512, 4, 16, 16),
               (1, 4, 8, 64), (2, 4, 12, 24)]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["f32", "bf16", "fp8"])
def test_exact_cutoff_launches_unchanged(out_dtype):
    """Molecules of one chunk keep the forward's brick, its rows (the plane
    ranges'), its entry point and every launch argument; larger ones take
    the tile launch; the backward's launch is what it was: the same
    instantiations on the same arguments."""
    shapes = MAIN_SHAPES + [(b, c, dl, dim) for b in (1, 3, 16, 64) for c in (1, 2, 3, 4, 5, 8, 16)
                            for dim in (12, 16, 20, 24, 32, 33, 48, 64, 96, 128, 256)
                            for dl in sorted({dim, max(1, dim // 4), min(dim, 11)})]
    for b, c, dl, dim in shapes:
        spec = TSpec(0.5, dim)
        assert deposit.brick_rows(b, c, dl, dim) == _parent_brick_rows(b, c, dl, dim)
        assert deposit.range_rows(b, c, dl, dim, 64) == _parent_brick_rows(b, c, dl, dim)[1]
        for gaussian in (True, False):
            assert deposit.fwd_launch(b, 64, c, dl, spec, gaussian, out_dtype) == \
                _parent_fwd_args(b, 64, c, dl, spec, gaussian, out_dtype)
            assert deposit.fwd_launch(b, 128, c, dl, spec, gaussian, out_dtype) == \
                deposit.tile_launch(b, 128, c, dl, spec, gaussian, out_dtype)
        for ct_dtype, kind in ((torch.float32, 0), (torch.bfloat16, 1)):
            wpa = 1
            while wpa < 8 and b * 128 * wpa < 16 * 132:
                wpa *= 2
            assert deposit.bwd_launch(b, 128, c, dl, spec, True, ct_dtype) == \
                ("deposit_bwd", (b, 128, c, dl, dim, 0.5, float(spec.width / 2.0), 1, kind, wpa))


def test_notrunc_launches_use_the_tiles():
    spec = TSpec(0.5, 128)
    name, args = deposit.fwd_launch(1, 3264, 1, 128, spec, True, torch.float32, notrunc=True)
    p = deposit.tile_brick(1, 1, 128, 128, notrunc=True)
    hr = deposit.TILE_RANGE_ROWS  # the tiles read plane ranges at their own rows
    assert name == "deposit_fwd_tile" and args[-8:] == (1, 0, p.kct, 8, p.bd, p.bh, p.bw, hr)
    assert (p.bd, p.bh, p.bw) == deposit.NOTRUNC_BLOCK_WARPS[0]  # the measured threshold-row block
    # a batch of one-chunk molecules keeps the brick launch, threshold rows or not
    assert deposit.fwd_launch(64, 64, 4, 64, TSpec(0.5, 64), True, torch.bfloat16, notrunc=True) == \
        deposit.fwd_launch(64, 64, 4, 64, TSpec(0.5, 64), True, torch.bfloat16)
    name, args = deposit.bwd_launch(1, 3264, 1, 128, spec, True, torch.bfloat16, notrunc=True)
    assert name == "deposit_bwd_notrunc" and args[-2:] == (1, deposit.bwd_warps_per_atom(1, 3264))
    with pytest.raises(ValueError, match="gaussian"):
        deposit.deposit_fwd(torch.zeros(1, 8, 64), torch.zeros(1, 1, 64), torch.zeros(1, 1, 1, 2, dtype=torch.int32),
                            spec=spec, dl=128, gaussian=False, notrunc=True)


# ------------------------------------------------------ the tile route


@pytest.mark.parametrize("density", ["gaussian", "binary", "gaussian_notrunc"])
@pytest.mark.parametrize("vp", [64, 128, 3328, 4096])
def test_forwards_route_on_the_chunk_count(density, vp):
    """``fwd_launch`` sends molecules of more than one chunk to the tile
    entry point, at both reaches and both densities, with ranges at
    ``TILE_RANGE_ROWS``; one chunk keeps the brick's entry point and
    arguments."""
    gaussian, notrunc = density != "binary", density == "gaussian_notrunc"
    for b, c, dim, dl, out_dtype in ((16, 1, 128, 128, torch.float32), (16, 1, 48, 48, torch.float32),
                                     (64, 4, 64, 64, torch.bfloat16), (1, 3, 33, 27, torch.float8_e4m3fn),
                                     (2, 8, 20, 20, torch.float32)):
        spec = TSpec(0.5, dim)
        name, args = deposit.fwd_launch(b, vp, c, dl, spec, gaussian, out_dtype, notrunc)
        assert args[:9] == (b, vp, c, dl, dim, 0.5, float(spec.width / 2.0), int(gaussian),
                            deposit._OUT_KINDS[out_dtype])
        if vp > deposit.CHUNK:
            p = deposit.tile_brick(b, c, dl, dim, out_dtype, notrunc)
            assert name == "deposit_fwd_tile" and args[9:] == (p.kct, p.cols // 2, p.bd, p.bh, p.bw, min(8, dim))
            assert deposit.range_rows(b, c, dl, dim, vp) == deposit.TILE_RANGE_ROWS == 8
        else:
            p = deposit.brick(b, c, dl, dim, out_dtype)
            assert name == "deposit_fwd" and args[9:] == (p.kct, p.threads, p.dt, p.ht, p.passes)
            assert deposit.range_rows(b, c, dl, dim, vp) == p.ht


def test_range_rows_and_the_forwards_shape_check_agree(monkeypatch):
    """The preparation writes its ranges at ``range_rows``, and the forward's
    shape check (on the card) takes exactly that row count: ranges at the
    brick's rows are refused on the tile route."""
    import contextlib

    calls = []
    lib = type("Lib", (), {"deposit_prep_setup": lambda self: 7,
                           "deposit_prep": lambda self, *a: calls.append("deposit_prep") or 0,
                           "deposit_fwd": lambda self, *a: calls.append("deposit_fwd") or 0,
                           "deposit_fwd_tile": lambda self, *a: calls.append("deposit_fwd_tile") or 0})()
    monkeypatch.setattr(deposit, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(deposit, "_WIDE_CLUSTERS", {})
    monkeypatch.setattr(deposit, "_PLANS", {})
    monkeypatch.setattr(deposit, "_check_prep_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    for b, v, c, dim, d_count in ((16, 3323, 1, 48, None), (16, 3262, 1, 128, None), (64, 61, 4, 64, None),
                                  (2, 300, 3, 33, 27), (1, 100, 8, 20, None), (1, 3262, 1, 4, None)):
        spec = TSpec(0.5, dim)
        plan = deposit.PrepPlan(spec, True, 0.5, d_count=d_count)
        got = deposit.deposit_prep(torch.empty((b, v, 3), device="meta"), torch.empty((b, v, c), device="meta"),
                                   torch.empty((v,), device="meta"), None, None, deposit.Transforms(None, False, False),
                                   plan)
        vp = got.rows.shape[2]
        hr = deposit.range_rows(b, c, got.dl, dim, vp)
        assert got.ranges.shape == (b, -(-dim // hr), vp // deposit.CHUNK, 2)
        deposit.deposit_fwd(got.rows, got.weights, got.ranges, spec=spec, dl=got.dl, gaussian=True)
        assert calls[-1] == ("deposit_fwd_tile" if vp > deposit.CHUNK else "deposit_fwd")
        ht = deposit.brick_rows(b, c, got.dl, dim)[1]
        if -(-dim // ht) != -(-dim // hr):
            other = torch.empty((b, -(-dim // ht), vp // deposit.CHUNK, 2), dtype=torch.int32, device="meta")
            with pytest.raises(ValueError, match="ranges must be"):
                deposit.deposit_fwd(got.rows, got.weights, other, spec=spec, dl=got.dl, gaussian=True)


@pytest.mark.parametrize("density", ["gaussian", "binary", "gaussian_notrunc"])
@pytest.mark.parametrize("dim,slab", [(64, None), (33, (5, 27))])
def test_plain_grid_is_the_same_at_the_brick_rows(rng, monkeypatch, density, dim, slab):
    """``deposit_plain`` gives the same grid, bit for bit, from ranges at the
    tile rows as from ranges at 64 rows (the whole grid at dim 33), since
    both stay conservative: the range rows decide which chunks a tile walks,
    never a voxel's sum."""
    b, v, c = 2, 300, 3
    coords = torch.as_tensor(rng.uniform(-dim * 0.2, dim * 0.2, (b, v, 3)).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.2, 1.0, (b, v, c)).astype(np.float32))
    radii = torch.as_tensor(rng.uniform(0.7, 1.6, (b, v)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=(b, v)) >= 0.1)
    kw = dict(spec=TSpec(0.5, dim), density_type=density, mask=mask)
    if slab is not None:
        kw.update(d_offset=slab[0], d_count=slab[1])
    got = deposit.voxelize_deposit_batch(coords, weights, radii, **kw)
    assert deposit.range_rows(b, c, dim, dim, 320) == 8
    monkeypatch.setattr(deposit, "range_rows", lambda b_, c_, dl_, dim_, vp_: min(64, dim_))
    rows, _, ranges, _, _ = deposit.prepare_batch(coords, weights, radii, **kw)
    assert ranges.shape[1] == 1 and rows.shape[2] == 320
    want = deposit.voxelize_deposit_batch(coords, weights, radii, **kw)
    assert float(got.abs().max()) > 0 and torch.equal(got, want)


# ----------------------------------------------------- the call sites


def _spy(monkeypatch):
    """Record the notrunc of every deposit_fwd / deposit_bwd the autograd
    Function calls, and send every entry point down the kernel route (on
    CPU tensors: the plain versions behind the same wrappers)."""
    import importlib

    batch = importlib.import_module("molvoxel_torch.ops.batch")
    voxelize = importlib.import_module("molvoxel_torch.ops.voxelize")
    seen = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = autodiff.deposit_fwd, autodiff.deposit_bwd

    def fwd(*args, **kw):
        seen["fwd"].append(kw.get("notrunc"))
        return real_fwd(*args, **kw)

    def bwd(*args, **kw):
        seen["bwd"].append(kw.get("notrunc"))
        return real_bwd(*args, **kw)

    monkeypatch.setattr(autodiff, "deposit_fwd", fwd)
    monkeypatch.setattr(autodiff, "deposit_bwd", bwd)
    for mod in (batch, voxelize):
        monkeypatch.setattr(mod, "resolve_impl", lambda impl, coords: "cuda")
        monkeypatch.setattr(mod, "notrunc_separable", lambda *a: False)
    return seen


ENTRIES = ["voxelize", "voxelize_batch", "VoxelizeLayer", "sliced", "slab"]


@pytest.mark.parametrize("density", ["gaussian_notrunc", "gaussian"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_notrunc_reaches_the_wrappers_from_every_call_site(rng, monkeypatch, entry, density):
    from molvoxel_torch.nn import VoxelizeLayer
    from molvoxel_torch.ops.batch import voxelize_batch, voxelize_batch_sliced
    from molvoxel_torch.ops.voxelize import voxelize

    seen = _spy(monkeypatch)
    spec = TSpec(0.5, 16)
    b, v, c = 2, 40, 3
    coords = torch.tensor(rng.uniform(-2.5, 2.5, (b, v, 3)).astype(np.float32), requires_grad=True)
    weights = torch.tensor(rng.uniform(0.1, 1.0, (b, v, c)).astype(np.float32), requires_grad=True)
    radii = torch.ones(v)
    mask = torch.ones((b, v), dtype=torch.bool)
    kw = dict(spec=spec, density_type=density)
    if entry == "voxelize":
        out = voxelize(coords[0], weights[0], radii, **kw)
    elif entry == "voxelize_batch":
        out = voxelize_batch(coords, weights, radii, mask, None, **kw)
    elif entry == "VoxelizeLayer":
        out = VoxelizeLayer(spec, density_type=density)(coords, weights, mask)
    elif entry == "slab":
        out = voxelize_batch(coords, weights, radii, mask, None, d_offset=4, d_count=8, **kw)
    else:
        out = voxelize_batch_sliced(coords.detach(), weights.detach(), radii, mask, None, slab_depth=8, **kw)
    assert torch.isfinite(out).all()
    if out.requires_grad:
        out.float().sum().backward()
        assert seen["bwd"] and all(n is (density == "gaussian_notrunc") for n in seen["bwd"])
    assert seen["fwd"] and all(n is (density == "gaussian_notrunc") for n in seen["fwd"])


# ------------------------------------------- plain versions against JAX


def _protein(n):
    g = np.load(GOLDENS / "protein_single_gaussian.npz")
    return (g["coords"] - g["center"]).astype(np.float32)[:n]


def _case(rng, name):
    """(coords (B, Vp, 3), weights (B, Vp, C), mask (B, Vp), dim, slab) of a
    threshold-row case."""
    if name == "protein1024_dim32":
        xyz = _protein(1024)
        return xyz[None], np.ones((1, 1024, 1), np.float32), np.ones((1, 1024), bool), 32, None
    b, v, vp, c = 3, 61, 64, 4
    dim, slab = {"ligands3_dim24_c4": (24, None), "ragged_dim20": (20, None), "slab_dim24": (24, (6, 10))}[name]
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3.5, 3.5, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = (rng.uniform(size=(b, v, c)) < 0.4) * rng.uniform(0.5, 1.0, (b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    return coords, weights.astype(np.float32), mask, dim, slab


JAX_CASES = ["protein1024_dim32", "ligands3_dim24_c4", "ragged_dim20", "slab_dim24"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_threshold_rows_match_jax(rng, name):
    """The plain forward (``deposit_plain`` on threshold rows and the plane
    ranges the kernels read) and backward (``deposit_bwd_plain`` behind the autograd
    Function) of gaussian_notrunc against the JAX package's Pallas kernels
    in interpret mode (its backward takes 128-aligned H*W only: at dims 20
    and 24 the VJP of its dense no-cutoff path): grids at 1e-5, gradients
    of coordinates and weights at 5e-3 x max(1, scale)."""
    coords, weights, mask, dim, slab = _case(rng, name)
    radii = np.ones(coords.shape[1], np.float32)
    kw = {} if slab is None else dict(d_offset=slab[0], d_count=slab[1])
    dl = dim if slab is None else slab[1]
    ct = rng.normal(size=(coords.shape[0], weights.shape[2], dl, dim, dim)).astype(np.float32)
    c_t = torch.tensor(coords, requires_grad=True)
    w_t = torch.tensor(weights, requires_grad=True)
    out = deposit.voxelize_deposit_batch(c_t, w_t, torch.as_tensor(radii), spec=TSpec(0.5, dim),
                                         density_type="gaussian_notrunc", mask=torch.as_tensor(mask), **kw)
    got_c, got_w = torch.autograd.grad(out, (c_t, w_t), grad_outputs=torch.as_tensor(ct))
    jkw = dict(spec=JSpec(0.5, dim), density_type="gaussian_notrunc", sigma=0.5, mask=jnp.asarray(mask), **kw)
    want = np.asarray(voxelize_pallas_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), **jkw))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    if (dim * dim) % 128 == 0:
        dc, dw, _ = voxelize_pallas_bwd_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
                                              jnp.asarray(ct), **jkw)
    else:  # the Pallas backward takes 128-aligned H*W only: the JAX package's dense no-cutoff VJP
        def one(cd, w, m):
            return jax_voxelize(cd, w, jnp.asarray(radii), spec=JSpec(0.5, dim), density_type="gaussian_notrunc",
                                sigma=0.5, mask=m, impl="dense", **kw)

        _, vjp = jax.vjp(jax.vmap(one, in_axes=(0, 0, None)), jnp.asarray(coords), jnp.asarray(weights),
                         jnp.asarray(mask[0]))
        dc, dw, _ = vjp(jnp.asarray(ct))
    scale = max(float(np.abs(np.asarray(dc)).max()), float(np.abs(np.asarray(dw)).max()), 1.0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(dc), rtol=0, atol=GRAD_BAR * scale)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(dw), rtol=0, atol=GRAD_BAR * scale)


# ------------------------------------- the backward's passes, brute force


def _brute_terms(rows, weights, ct, spec, dl):
    """(B, Vp, Dl, H, W, C + 4) float64: for each atom and voxel inside its
    threshold (the exact f32 predicate), its C weight terms and its terms
    of sx, sy, sz, sd, a plain loop over atoms."""
    rows, weights, ct = (np.asarray(t, np.float32) for t in (rows, weights, ct))
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    half = np.float32(spec.width / 2.0)
    pd = np.arange(dl, dtype=np.float32) * np.float32(spec.resolution) - half
    ph = np.arange(dim, dtype=np.float32) * np.float32(spec.resolution) - half
    ct = ct.reshape(b, c, dl, dim, dim)
    out = np.zeros((b, vp, dl, dim, dim, c + 4))
    for bi in range(b):
        for v in range(vp):
            x, y, z, th, coef = rows[bi, :5, v]
            dx = pd - x
            dx2 = dx * dx
            dy, dz = ph - y, ph - z
            dyz2 = (dy * dy)[:, None] + (dz * dz)[None, :]
            inside = dyz2[None] <= (th - dx2)[:, None, None]
            if not inside.any():
                continue
            f = np.where(inside, np.exp(dx2 * coef)[:, None, None] * np.exp((dy * dy) * coef)[None, :, None]
                         * np.exp((dz * dz) * coef)[None, None, :], 0.0).astype(np.float64)
            g = ct[bi].astype(np.float64)
            q = np.tensordot(weights[bi, :, v].astype(np.float64), g, axes=1)  # (Dl, H, W)
            tq = q * f
            out[bi, v, ..., :c] = np.moveaxis(g * f[None], 0, -1)
            out[bi, v, ..., c] = -tq * dx[:, None, None]
            out[bi, v, ..., c + 1] = -tq * dy[None, :, None]
            out[bi, v, ..., c + 2] = -tq * dz[None, None, :]
            out[bi, v, ..., c + 3] = tq * (dx2[:, None, None] + dyz2[None])
    return out


def _spans(rows, spec, dl):
    """(B, Vp, 6) int64 [dlo, dhi, hlo, hhi, wlo, whi]: each atom's box as
    deposit_bwd.cu's ``span`` computes it (its reach with slack, widened by
    a voxel each side, clipped to the grid), in float32 step by step."""
    res = np.float32(spec.resolution)
    inv_res = np.float32(1.0) / res
    hw = np.float32(spec.width / 2.0)
    rows = np.asarray(rows, np.float32)
    reach = np.sqrt(np.maximum(rows[:, 3], 0)) * np.float32(1.0001) + np.float32(1e-4)
    out = []
    for k, n in ((0, dl), (1, spec.dimension), (2, spec.dimension)):
        lo = np.ceil(((rows[:, k] - reach) + hw) * inv_res) - 1
        hi = np.floor(((rows[:, k] + reach) + hw) * inv_res) + 1
        out += [np.clip(lo, 0, n), np.clip(hi, -1, n - 1)]
    return np.stack(out, axis=-1).astype(np.int64)


@pytest.mark.parametrize("dim,slab", [(20, None), (24, (5, 12)), (32, None)])
def test_bwd_groups_cover_every_in_sphere_voxel(rng, dim, slab):
    """The threshold-row backward's enumeration, in numpy: each row's
    w-span (the atom's reach at that row, widened a voxel, clipped to its
    box), cut into aligned groups of BWD_NOTRUNC_GROUP columns, holds every
    voxel of the row inside the threshold (the exact f32 predicate), each
    once, and no column off the grid; the (dz, ez) table from the box's
    aligned start covers every column of the groups within 64 entries."""
    group = deposit.BWD_NOTRUNC_GROUP
    b, v = 2, 90
    spec = TSpec(0.5, dim)
    coords = torch.as_tensor(rng.uniform(-dim * 0.3, dim * 0.3, (b, v, 3)).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.0, 1.0, (b, v, 2)).astype(np.float32))
    radii = torch.as_tensor(rng.uniform(0.7, 1.6, (v,)).astype(np.float32))
    kw = {} if slab is None else dict(d_offset=slab[0], d_count=slab[1])
    rows, _, _, dl, _ = deposit.prepare_batch(coords, weights, radii, spec=spec, density_type="gaussian_notrunc",
                                              **kw)
    rows = rows.numpy()
    spans = _spans(rows, spec, dl)
    half = np.float32(spec.width / 2.0)
    pos = np.arange(max(dl, dim), dtype=np.float32) * np.float32(spec.resolution) - half
    covered = 0
    for bi in range(b):
        for vi in range(rows.shape[2]):
            x, y, z, th = rows[bi, :4, vi]
            dlo, dhi, hlo, hhi, wlo, whi = spans[bi, vi]
            if dhi < dlo or hhi < hlo or whi < wlo:
                continue
            glo = wlo // group * group
            assert (whi | (group - 1)) + 1 - glo <= 64
            for d in range(dlo, dhi + 1):
                t_th = np.float32(th - np.float32((pos[d] - x) * (pos[d] - x)))
                for h in range(hlo, hhi + 1):
                    dy2 = np.float32((pos[h] - y) * (pos[h] - y))
                    dz2 = ((pos[:dim] - z) * (pos[:dim] - z)).astype(np.float32)
                    inside = np.nonzero(np.float32(dy2) + dz2 <= t_th)[0] if dy2 <= t_th else np.zeros(0, int)
                    if dy2 > t_th:
                        continue
                    reach = np.float32(np.sqrt(max(np.float32(t_th - dy2), 0)) * np.float32(1.0001) + 1e-4)
                    lo = max(int(np.clip(np.ceil(((z - reach) + half) / np.float32(spec.resolution)) - 1, 0, dim)), wlo)
                    hi = min(int(np.clip(np.floor(((z + reach) + half) / np.float32(spec.resolution)) + 1, -1,
                                         dim - 1)), whi)
                    cols = np.arange(lo // group * group, (hi // group + 1) * group) if hi >= lo else np.zeros(0, int)
                    assert np.isin(inside, cols).all()
                    if dim % group == 0:
                        assert cols.size == 0 or cols.max() < dim
                    covered += inside.size
    assert covered > 0


def _bwd_brute(rows, weights, ct, spec, dl):
    """(grad_rows (B, 8, Vp), grad_w (B, C, Vp)) float64, a plain loop over
    atoms with the exact f32 predicate."""
    terms = _brute_terms(rows, weights, ct, spec, dl).sum(axis=(2, 3, 4))  # (B, Vp, C + 4)
    c = weights.shape[1]
    coef = np.asarray(rows, np.float64)[:, 4]
    g_rows = np.zeros((rows.shape[0], 8, rows.shape[2]))
    g_rows[:, :3] = 2.0 * coef[:, None] * np.moveaxis(terms[..., c:c + 3], -1, 1)
    g_rows[:, 4] = terms[..., c + 3]
    return g_rows, np.moveaxis(terms[..., :c], -1, 1)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dim,slab", [(20, None), (24, (5, 12)), (16, None)])
def test_bwd_plain_threshold_rows_match_brute_force(rng, c, dim, slab):
    """``deposit_bwd_plain`` on threshold rows, what the threshold-row
    kernel is held against on the card, equals a brute-force sum over every
    voxel inside each atom's threshold: weight sums, 2 coef times the
    coordinate sums, the coef sum; zero-weight atoms still get their weight
    gradient."""
    b, v = 2, 100
    spec = TSpec(0.5, dim)
    coords = torch.as_tensor(rng.uniform(-3.0, 3.0, (b, v, 3)).astype(np.float32))
    weights = torch.as_tensor(rng.uniform(0.0, 1.0, (b, v, c)).astype(np.float32))
    weights[:, ::9] = 0.0
    radii = torch.as_tensor(rng.uniform(0.7, 1.3, (v,)).astype(np.float32))
    kw = {} if slab is None else dict(d_offset=slab[0], d_count=slab[1])
    rows, wt, _, dl, _ = deposit.prepare_batch(coords, weights, radii, spec=spec, density_type="gaussian_notrunc",
                                               **kw)
    ct = torch.as_tensor(rng.normal(size=(b, c, dl, dim * dim)).astype(np.float32))
    want_rows, want_w = _bwd_brute(rows, wt, ct, spec, dl)
    got_rows, got_w = deposit.deposit_bwd_plain(rows, wt, ct, spec=spec, dl=dl, gaussian=True)
    scale = max(np.abs(want_rows).max(), np.abs(want_w).max(), 1.0)
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-5 * scale)
    assert np.abs(want_w[:, :, ::9]).max() > 0  # the zero-weight atoms' weight gradients
