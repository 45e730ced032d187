"""molvoxel_torch.ops.deposit against molvoxel_tpu.ops.pallas_deposit (Pallas in
interpret mode on the CPU): Morton keys, plane ranges, and the plain version
of the CUDA deposit kernel, on the same numpy inputs."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.ops import _build, deposit
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.ops.pallas_deposit import (
    _plane_ranges_closed,
    morton_keys,
    voxelize_pallas_batch,
    voxelize_pallas_batch_channelwise,
)


def _cloud(rng, b=2, v=200, c=3, box=3.5, n_pad=20):
    coords = rng.uniform(-box, box, size=(b, v, 3)).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, size=(b, v, c)).astype(np.float32)
    radii = rng.uniform(0.7, 1.8, size=(b, v)).astype(np.float32)
    mask = np.ones((b, v), bool)
    mask[:, v - n_pad:] = False
    return coords, weights, radii, mask


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("dim", [12, 16, 33])
def test_morton_keys_match(rng, dim):
    coords, _, _, mask = _cloud(rng, v=300, box=dim * 0.3)
    coords[0, :5] = 50.0  # off-grid atoms clip to the edge cell
    got = deposit.morton_keys(torch.as_tensor(coords), TSpec(0.5, dim), torch.as_tensor(mask))
    want = np.asarray(morton_keys(jnp.asarray(coords), JSpec(0.5, dim), jnp.asarray(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _shifted_rows(rng, dim, d_offset, res=0.5):
    coords, _, radii, mask = _cloud(rng, v=256, box=dim * res * 0.45, n_pad=40)
    coords[:, -40:] = deposit.FAR  # padding atoms sit far off, as the wrapper pads them
    r2 = np.where(mask, radii * radii, 1.0).astype(np.float32)
    xs = coords[..., 0] - np.float32(d_offset) * np.float32(res)
    shifted = np.stack([xs, coords[..., 1], coords[..., 2]], axis=-1)
    return shifted, r2


@pytest.mark.parametrize("dim,d_offset,d_count,ht", [(16, 0, None, 8), (32, 0, None, 4), (32, 8, 12, 4),
                                                     (64, 20, 24, 2), (20, 0, None, 3), (20, 3, 11, 1),
                                                     (33, 0, None, 4), (33, 5, 27, 7)])
def test_plane_ranges_equal_closed_form_on_whole_rows(rng, dim, d_offset, d_count, ht):
    # the port's bricks are whole h rows, ragged dims (20, 33) too
    shifted, r2 = _shifted_rows(rng, dim, d_offset)
    dl = dim if d_count is None else d_count
    got = deposit.plane_ranges(torch.as_tensor(shifted), torch.as_tensor(r2), TSpec(0.5, dim), dl, ht)
    nht = -(-dim // ht)
    want = np.asarray(_plane_ranges_closed(jnp.asarray(shifted), jnp.asarray(r2), JSpec(0.5, dim), dl, nht, ht,
                                           deposit.CHUNK))
    assert got.shape == (2, nht, 256 // deposit.CHUNK, 2)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 1, 2), want)


@pytest.mark.parametrize("dim,d_offset,d_count", [(20, 0, None), (33, 5, 27)])
def test_plane_ranges_at_the_wrappers_bricks_equal_closed_form(rng, dim, d_offset, d_count):
    """prepare_batch's ranges are _plane_ranges_closed at the wrapper's own ht."""
    coords, weights, radii, mask = _cloud(rng, v=256, box=dim * 0.5 * 0.45, n_pad=40)
    spec = TSpec(0.5, dim)
    c_t, w_t, r_t, m_t = _t(coords, weights, radii, mask)
    rows, wt, ranges, dl, _ = deposit.prepare_batch(c_t, w_t, r_t, spec=spec, mask=m_t, d_offset=d_offset,
                                                    d_count=d_count, presorted=True)
    ht = deposit.range_rows(2, 3, dl, dim, rows.shape[2])
    shifted = rows[:, :3].transpose(1, 2).numpy()
    want = np.asarray(_plane_ranges_closed(jnp.asarray(shifted), jnp.asarray(rows[:, 3].numpy()), JSpec(0.5, dim),
                                           dl, -(-dim // ht), ht, deposit.CHUNK))
    np.testing.assert_array_equal(ranges.numpy().reshape(-1, 1, 2), want)


@pytest.mark.parametrize("dim,res,d_offset,d_count,ht", [(12, 0.5, 0, None, 5), (20, 0.5, 3, 11, 3),
                                                         (40, 0.375, 0, None, 7), (16, 0.25, 4, 8, 16)])
def test_plane_ranges_never_drop_a_reached_plane(rng, dim, res, d_offset, d_count, ht):
    """Whatever the tiling (ragged tiles too): every (atom, plane, voxel) the
    exact cutoff reaches lies inside its (row tile, chunk) range."""
    spec = TSpec(res, dim)
    shifted, r2 = _shifted_rows(rng, dim, d_offset, res)
    dl = dim if d_count is None else d_count
    ranges = deposit.plane_ranges(torch.as_tensor(shifted), torch.as_tensor(r2), spec, dl, ht)
    half = np.float32(spec.width / 2.0)
    pos = np.arange(dim, dtype=np.float32) * np.float32(res) - half
    pd = np.arange(dl, dtype=np.float32) * np.float32(res) - half
    x, y, z = shifted[..., 0], shifted[..., 1], shifted[..., 2]
    dx = pd[None, None, :] - x[..., None]
    th = r2[..., None] - dx * dx  # (B, V, Dl)
    dy2 = (pos[None, None, :] - y[..., None]) ** 2
    dz2 = (pos[None, None, :] - z[..., None]) ** 2
    dyz2 = (dy2[..., :, None] + dz2[..., None, :]).reshape(2, 256, dim * dim)
    reach = dyz2[:, :, None, :] <= th[..., None]  # (B, V, Dl, HW)
    b_i, v_i, d_i, hw_i = np.nonzero(reach)
    assert b_i.size > 100
    rg = ranges.numpy()[b_i, hw_i // dim // ht, v_i // deposit.CHUNK]
    assert ((rg[:, 0] <= d_i) & (d_i < rg[:, 1])).all()


BRICK_GRIDS = [(12, None), (20, (3, 11)), (33, (5, 27)), (64, None), (64, (20, 24)), (256, (100, 40))]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("dim,slab", BRICK_GRIDS)
def test_bricks_cover_every_voxel_once(dim, slab, out_dtype):
    """The wrapper's launch, walked with the kernel's index arithmetic
    (work item -> brick, thread and pass -> run of w), writes every
    (channel, plane, row, column) of the grid exactly once."""
    for b, c in ((1, 1), (2, 4), (3, 6), (2, 12)):
        dl = dim if slab is None else slab[1]
        p = deposit.brick(b, c, dl, dim, out_dtype)
        assert p.passes * p.run * p.kct <= deposit.ACC_MAX and p.threads <= deposit.BRICK_THREADS
        assert p.threads % 32 == 0 and 1 <= p.dt <= dl and 1 <= p.ht <= dim
        nct, ndt, nht, nrun = -(-c // p.kct), -(-dl // p.dt), -(-dim // p.ht), -(-dim // p.run)
        groups = [cg * p.kct + k for cg in range(nct) for k in range(p.kct) if cg * p.kct + k < c]
        assert sorted(groups) == list(range(c))
        item = np.arange(ndt * nht)  # one molecule and channel group; the others are disjoint copies
        ti, di = item % nht, item // nht
        u = (np.arange(p.threads)[:, None] + np.arange(p.passes)[None, :] * p.threads).reshape(-1)
        u = u[u < p.dt * p.ht * nrun]
        row, run = u // nrun, u % nrun
        d = (di * p.dt)[:, None] + (row // p.ht)[None, :]
        h = (ti * p.ht)[:, None] + (row % p.ht)[None, :]
        w = (run * p.run)[None, :, None] + np.arange(p.run)[None, None, :]
        live = ((d < dl) & (h < dim))[..., None] & (w < dim)
        flat = ((d[..., None] * dim + h[..., None]) * dim + w)[live]
        np.testing.assert_array_equal(np.bincount(flat, minlength=dl * dim * dim), 1)


def test_ranges_must_be_at_the_bricks_rows(rng):
    """deposit_plain takes ranges only at the wrapper's own ht, and a grid
    row wider than the kernel's accumulators is refused when planned."""
    coords, weights, radii, mask = _t(*_cloud(rng))
    spec = TSpec(0.5, 12)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, weights, radii, spec=spec, mask=mask)
    ht = deposit.range_rows(2, 3, dl, 12, rows.shape[2])
    other = deposit.plane_ranges(rows[:, :3].transpose(1, 2), rows[:, 3], spec, dl, 12 if ht < 12 else 5)
    with pytest.raises(ValueError, match="one row per tile"):
        deposit.deposit_plain(rows, wt, other, spec=spec, dl=dl, gaussian=gaussian)
    with pytest.raises(ValueError, match="accumulators"):
        deposit.brick(1, 8, 1, 8192, torch.float32)


CASES = [(dim, dens, var) for dim in (16, 12) for dens in ("gaussian", "binary")
         for var in ("full", "slab", "channelwise", "bf16")]


@pytest.mark.parametrize("dim,density,variant", CASES, ids=[f"dim{d}-{g}-{v}" for d, g, v in CASES])
def test_deposit_plain_matches_pallas(rng, dim, density, variant):
    """B = 2, V = 200 (so the Morton sort runs), C = 3; dim 16 is H*W-aligned
    (_kernel_v5), dim 12 has H*W = 144 (the streamed _kernel_gaussian /
    _kernel_binary)."""
    coords, weights, radii, mask = _cloud(rng)
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    kw = dict(density_type=density, sigma=0.5)
    if variant == "slab":
        kw.update(d_offset=3, d_count=7)
    out_dtype = "bfloat16" if variant == "bf16" else "float32"
    if variant == "channelwise":
        radii_c = np.asarray([0.8, 1.1, 1.6], np.float32)
        want = voxelize_pallas_batch_channelwise(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii_c),
                                                 spec=spec_j, mask=jnp.asarray(mask), **kw)
        c_x, w_x, r_x, m_x = deposit.expand_channelwise(*_t(coords, weights, radii_c, mask))
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(c_x, w_x, r_x, spec=spec_t, mask=m_x, **kw)
    else:
        want = voxelize_pallas_batch(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), spec=spec_j,
                                     mask=jnp.asarray(mask), out_dtype=out_dtype, **kw)
        c_t, w_t, r_t, m_t = _t(coords, weights, radii, mask)
        rows, wt, ranges, dl, gaussian = deposit.prepare_batch(c_t, w_t, r_t, spec=spec_t, mask=m_t, **kw)
    got = deposit.deposit_plain(rows, wt, ranges, spec=spec_t, dl=dl, gaussian=gaussian,
                                out_dtype=getattr(torch, out_dtype))
    got = got.float().numpy().reshape(np.shape(want))
    want = np.asarray(want, np.float32)
    tol = 2**-7 * max(np.abs(want).max(), 1.0) if variant == "bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_batch_wrapper_on_cpu_runs_the_plain_version(rng):
    coords, weights, radii, mask = _t(*_cloud(rng))
    spec = TSpec(0.5, 12)
    before = dict(deposit.launches)
    out = deposit.voxelize_deposit_batch(coords, weights, radii, spec=spec, mask=mask, d_offset=2, d_count=5,
                                         out_dtype="bfloat16")
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, weights, radii, spec=spec, mask=mask,
                                                           d_offset=2, d_count=5)
    plain = deposit.deposit_plain(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 5, 12, 12)
    assert torch.equal(out, plain.reshape(out.shape))
    assert deposit.launches == before  # no kernel launch on CPU tensors


def test_expand_channelwise_layout():
    coords = torch.arange(12, dtype=torch.float32).reshape(1, 4, 3)
    weights = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2) + 1
    c_x, w_x, r_x, m_x = deposit.expand_channelwise(coords, weights, torch.tensor([0.5, 2.0]), None)
    assert c_x.shape == (1, 8, 3) and torch.equal(c_x[0, 4:], coords[0])
    assert torch.equal(r_x, torch.tensor([0.5] * 4 + [2.0] * 4))
    assert torch.equal(w_x[0, :4, 0], weights[0, :, 0]) and torch.equal(w_x[0, 4:, 1], weights[0, :, 1])
    assert float(w_x[0, :4, 1].abs().sum() + w_x[0, 4:, 0].abs().sum()) == 0.0
    assert m_x is None


def test_forward_only_and_unported_density_raise(rng):
    """What these inputs raised before the backward and gaussian_notrunc were
    ported now runs: a gradient flows to every input, notrunc deposits (with
    its threshold row); a bad out_dtype still raises."""
    coords, weights, radii, mask = _t(*_cloud(rng))
    spec = TSpec(0.5, 12)
    out = deposit.voxelize_deposit_batch(coords.requires_grad_(), weights.requires_grad_(), radii.requires_grad_(),
                                         spec=spec, mask=mask)
    out.sum().backward()
    assert all(float(t.grad.abs().max()) > 0 for t in (coords, weights, radii))
    nt = deposit.voxelize_deposit_batch(coords.detach(), weights.detach(), radii.detach(), spec=spec, mask=mask,
                                        density_type="gaussian_notrunc")
    assert nt.shape == out.shape and bool((nt >= out.detach() - 1e-6).all()) and float((nt - out.detach()).max()) > 0
    rows, *_ = deposit.prepare_batch(coords.detach(), weights, radii.detach(), spec=spec, mask=mask,
                                     density_type="gaussian_notrunc", presorted=True)
    r2 = torch.where(mask, radii.detach() ** 2, torch.ones(()))
    assert torch.allclose(rows[:, 3, :200], deposit.notrunc_r2_thresh(r2, 0.5))
    assert torch.allclose(rows[:, 4, :200], -2.0 / r2)  # coef from the true r^2
    with pytest.raises(ValueError, match="out_dtype"):
        deposit.voxelize_deposit_batch(coords.detach(), weights, radii, spec=spec, out_dtype="float16")


def test_kernel_wrapper_rejects_other_devices(rng):
    coords, weights, radii, mask = _t(*_cloud(rng))
    spec = TSpec(0.5, 12)
    rows, wt, ranges, dl, gaussian = deposit.prepare_batch(coords, weights, radii, spec=spec, mask=mask)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        deposit.deposit_fwd(rows.to("meta"), wt.to("meta"), ranges.to("meta"), spec=spec, dl=dl, gaussian=gaussian)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("deposit_fwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("deposit_bwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("deposit_prep")
    assert _build.library_path("deposit_fwd").name.startswith("libdeposit_fwd-")
    assert _build.SOURCES == ("deposit_prep", "deposit_fwd", "deposit_bwd")



# ----------------------------------------------- the backward kernel's walk

F32 = np.float32


def _axis_pos(idx, res, hw):
    return F32(F32(F32(idx) * res) - hw)


def _slack_reach(r2):
    """slack_reach of deposit_bwd.cu, rounded step by step in float32."""
    return F32(F32(np.sqrt(max(F32(r2), F32(0.0))) * F32(1.0001)) + F32(1e-4))


def _span(p, reach, res, hw, n):
    """span of deposit_bwd.cu: the indices in [0, n) within reach of p,
    widened by one voxel each side; empty when hi < lo."""
    inv_res = F32(1.0) / F32(res)
    flo = F32(np.ceil(F32(F32(F32(p - reach) + hw) * inv_res))) - F32(1.0)
    fhi = F32(np.floor(F32(F32(F32(p + reach) + hw) * inv_res))) + F32(1.0)
    return int(min(max(flo, F32(0.0)), F32(n))), int(max(min(fhi, F32(n - 1)), F32(-1.0)))


def _accepted(x, y, z, th, res, hw, dl, dim):
    """(Dl, H, W) bool: the voxels the forward's exact predicate accepts."""
    pd = np.arange(dl, dtype=F32) * F32(res) - F32(hw)
    ph = np.arange(dim, dtype=F32) * F32(res) - F32(hw)
    dx, dy, dz = pd - F32(x), ph - F32(y), ph - F32(z)
    t_th = F32(th) - dx * dx
    dyz2 = (dy * dy)[:, None] + (dz * dz)[None, :]
    return dyz2[None] <= t_th[:, None, None]


def _plane_span(x, y, th, i, res, hw, hlo, hhi, dim):
    """A plane's terms and its h-span in closed form, widened by one voxel
    and clipped to the box; empty where th - dx^2 < 0."""
    dx = F32(_axis_pos(i, res, hw) - x)
    t_th = F32(th - F32(dx * dx))
    if not t_th >= 0:
        return t_th, 0, -1
    lo, hi = _span(y, _slack_reach(t_th), res, hw, dim)
    return t_th, max(lo, hlo), min(hi, hhi)


def _row_span(z, t_th, dy2, res, hw, wlo, whi, dim):
    """A row's w-span, widened by one voxel and clipped to the box; empty
    where dy^2 > th - dx^2."""
    if not dy2 <= t_th:
        return 0, -1
    lo, hi = _span(z, _slack_reach(F32(t_th - dy2)), res, hw, dim)
    return max(lo, wlo), min(hi, whi)


def _owner_rank(counts, base, lane):
    """The kernel's owner_rank: among the lanes with items (counts > 0,
    numbered by prefix sums), the rank of the one holding item base + lane,
    as the count of those whose last item lies below it."""
    ends = [int(e) - 1 for e, n in zip(np.cumsum(counts), counts) if n > 0]
    mask = sum(1 << (e - base) for e in ends if 0 <= e - base < 32)
    return min(sum(e < base for e in ends) + bin(mask & ((1 << lane) - 1)).count("1"), 31)


def _kernel_walk(x, y, z, th, res, hw, dl, dim, wpa):
    """The (i, h, w) pairs the kernel's lanes evaluate, with its own index
    arithmetic: the box; planes 32 at a time, each with its h-span; rows
    numbered by prefix sums, a contiguous share a warp, 32 at a time, each
    finding its plane by owner_rank, each with its w-span; pairs numbered
    the same way, 32 a batch, each finding its row by owner_rank.  Also how
    often a warp had more than 32 rows in a batch of planes."""
    reach = _slack_reach(th)
    dlo, dhi = _span(x, reach, res, hw, dl)
    hlo, hhi = _span(y, reach, res, hw, dim)
    wlo, whi = _span(z, reach, res, hw, dim)
    nd = dhi - dlo + 1 if (dhi >= dlo and hhi >= hlo and whi >= wlo) else 0
    visits, refills = [], 0
    for part in range(wpa):
        for pc in range(0, nd, 32):
            planes = [_plane_span(x, y, th, dlo + pc + lane, res, hw, hlo, hhi, dim) if pc + lane < nd
                      else (F32(0.0), 0, -1) for lane in range(32)]
            hn = [max(hi - lo + 1, 0) for _, lo, hi in planes]
            pincl = np.cumsum(hn)
            with_rows = [(pc + lane, planes[lane][0], planes[lane][1] - int(pincl[lane] - hn[lane]))
                         for lane in range(32) if hn[lane] > 0]
            share = (int(pincl[31]) + wpa - 1) // wpa
            rend = min(int(pincl[31]), (part + 1) * share)
            for q0 in range(part * share, rend, 32):
                rows, lens = [], []
                for lane in range(32):
                    rank = _owner_rank(hn, q0, lane)  # past the last row: a stale entry, unused
                    pl, t_th, hofs = with_rows[rank] if rank < len(with_rows) else (0, F32(-1.0), 0)
                    h = q0 + lane + hofs
                    dy = F32(_axis_pos(h, res, hw) - y)
                    lo, hi = _row_span(z, t_th, F32(dy * dy), res, hw, wlo, whi, dim) if q0 + lane < rend else (0, -1)
                    rows.append((dlo + pl, h, lo))
                    lens.append(max(hi - lo + 1, 0))
                incl = np.cumsum(lens)
                recs = [(*rows[r], int(incl[r] - lens[r])) for r in range(32) if lens[r] > 0]
                for base in range(0, int(incl[31]), 32):  # batches of 32 pairs, lane by lane
                    for lane in range(min(32, int(incl[31]) - base)):
                        i, h, lo, excl = recs[_owner_rank(lens, base, lane)]
                        visits.append((i, h, lo + base + lane - excl))
                refills += q0 > part * share
    return visits, refills


def _adversarial_atoms(res, dim, dl, d_offset):
    """(x', y, z, r2_thresh) rows: centres on voxel centres and half-voxels,
    radii of exactly k voxels, the notrunc threshold row, atoms at and past
    the grid's edges, far-off padding atoms; x' shifted by the slab."""
    hw = F32(res * dim / 2)
    on = [_axis_pos(k, F32(res), hw) for k in (0, 3, dim // 2, dim - 1)]
    half = [F32(p + F32(res / 2)) for p in on]
    edge = [F32(-hw - F32(res)), F32(hw + F32(0.3 * res)), F32(hw - F32(1e-3))]
    r2s = [F32(F32(k * res) ** 2) for k in (1, 2, 3)] + [F32(1.0), F32(2.56)]
    r2s += [F32(deposit.notrunc_r2_thresh(torch.tensor(F32(r2)), 0.5)) for r2 in (1.0, 2.56)]
    atoms = []
    rng = np.random.default_rng(7)
    for r2 in r2s:
        for px in on + half + edge:
            py, pz = rng.choice(on + half + edge, size=2)
            atoms.append((F32(px - F32(F32(d_offset) * F32(res))), F32(py), F32(pz), r2))
    atoms += [(F32(deposit.FAR), F32(deposit.FAR), F32(deposit.FAR), F32(1.0)),
              (F32(-deposit.FAR), F32(0.0), F32(0.0), F32(1.0))]
    return atoms


BWD_GRIDS = [(0.5, 16, 0, None), (0.5, 20, 3, 11), (0.25, 24, 0, None), (0.375, 12, 2, 7)]


@pytest.mark.parametrize("res,dim,d_offset,d_count", BWD_GRIDS)
def test_bwd_row_spans_hold_every_accepted_voxel(res, dim, d_offset, d_count):
    """The kernel's box, h-span and w-span formulas (a float32 copy): on
    adversarial atoms, every voxel the exact predicate accepts lies in the
    box, inside its plane's h-span and its row's w-span; and a w-span is at
    most its row's accepted run plus three voxels."""
    dl = dim if d_count is None else d_count
    hw = F32(res * dim / 2)
    res = F32(res)
    hits = 0
    for x, y, z, th in _adversarial_atoms(res, dim, dl, d_offset):
        acc = _accepted(x, y, z, th, res, hw, dl, dim)
        hits += int(acc.sum())
        reach = _slack_reach(th)
        (dlo, dhi), (hlo, hhi), (wlo, whi) = (_span(p, reach, res, hw, n) for p, n in ((x, dl), (y, dim), (z, dim)))
        for i, h in zip(*np.nonzero(acc.any(axis=2))):
            assert dlo <= i <= dhi and hlo <= h <= hhi
            t_th, hl, hr = _plane_span(x, y, th, i, res, hw, hlo, hhi, dim)
            assert hl <= h <= hr
            dy = F32(_axis_pos(h, res, hw) - y)
            wl, wr = _row_span(z, t_th, F32(dy * dy), res, hw, wlo, whi, dim)
            w = np.nonzero(acc[i, h])[0]
            assert wl <= w.min() and w.max() <= wr
            assert wr - wl + 1 <= w.size + 3
    assert hits > 1000


@pytest.mark.parametrize("wpa", [1, 2, 8])
@pytest.mark.parametrize("res,dim,d_offset,d_count", BWD_GRIDS[:2])
def test_bwd_kernel_walk_visits_each_accepted_voxel_once(res, dim, d_offset, d_count, wpa):
    """The kernel's enumeration, lane by lane: every accepted voxel of an
    atom is a pair of exactly one lane of one of its warps, and no pair
    lies outside the grid or slab."""
    dl = dim if d_count is None else d_count
    hw = F32(res * dim / 2)
    res = F32(res)
    refills = 0
    for x, y, z, th in _adversarial_atoms(res, dim, dl, d_offset):
        visits, n = _kernel_walk(x, y, z, th, res, hw, dl, dim, wpa)
        refills += n
        assert len(visits) == len(set(visits))
        if visits:
            v = np.asarray(visits)
            assert v.min() >= 0 and (v[:, 0] < dl).all() and (v[:, 1:] < dim).all()
        acc = _accepted(x, y, z, th, res, hw, dl, dim)
        want = {tuple(int(k) for k in ijk) for ijk in zip(*np.nonzero(acc))}
        assert want <= set(visits)
    assert refills > 0 or wpa == 8  # with fewer warps an atom, some warp had more than 32 rows of a plane batch


def test_bwd_warps_per_atom_is_what_the_wrapper_passes(rng, monkeypatch):
    """bwd_warps_per_atom: one warp an atom on the training batch (64 x 64
    atoms) and the protein bucket, a whole block for a lone ligand; the
    wrapper hands the kernel that plan and any batch (70,000 molecules: no
    grid-axis cap)."""
    assert deposit.bwd_warps_per_atom(64, 64) == 1
    assert deposit.bwd_warps_per_atom(1, 4096) == 1
    assert deposit.bwd_warps_per_atom(70_000, 64) == 1
    assert deposit.bwd_warps_per_atom(1, 64) == 8
    assert deposit.bwd_warps_per_atom(2, 64) == 8
    assert deposit.bwd_warps_per_atom(9, 128) == 2
    for b, vp in ((1, 64), (9, 128), (64, 64), (70_000, 64)):
        wpa = deposit.bwd_warps_per_atom(b, vp)
        assert wpa in (1, 2, 4, 8) and (b * vp * wpa >= deposit.BWD_TARGET_WARPS or wpa == 8)
        assert wpa == 1 or b * vp * wpa // 2 < deposit.BWD_TARGET_WARPS

    calls = []

    class FakeLib:
        def deposit_bwd(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(deposit, "_kernel_lib", lambda name: FakeLib())
    monkeypatch.setattr(deposit, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)  # meta tensors' device: no context entered
    spec = TSpec(0.5, 8)
    before = deposit.launches["deposit_bwd"]
    for b, vp, c in ((1, 64, 4), (9, 128, 1), (70_000, 64, 1)):
        rows = torch.empty((b, 8, vp), device="meta")
        wt = torch.empty((b, c, vp), device="meta")
        ct = torch.empty((b, c, 8, 64), device="meta")
        grad_rows, grad_w = deposit.deposit_bwd(rows, wt, ct, spec=spec, dl=8, gaussian=True)
        assert grad_rows.shape == (b, 8, vp) and grad_w.shape == (b, c, vp)
        args = calls[-1]
        assert args[5:10] == (b, vp, c, 8, 8) and args[14] == deposit.bwd_warps_per_atom(b, vp)
    assert deposit.launches["deposit_bwd"] == before + 3


@pytest.mark.parametrize("source", ["deposit_fwd.cu", "deposit_bwd.cu", "deposit_prep.cu"])
def test_warp_collectives_are_not_behind_a_branch(source):
    """A __*_sync call that only some lanes of its mask reach hangs the warp
    on the card, and nothing on the CPU runs the kernel.  Every such call in
    the kernels must stand where all lanes reach it: not as the body of a
    one-line `if`, and not as the right operand of && / || or a ?: branch."""
    import re

    from molvoxel_torch.ops._build import CSRC

    call = r"__(shfl\w*|ballot|reduce\w*|any|all|match\w*)_sync\("
    for n, line in enumerate((CSRC / source).read_text().splitlines(), 1):
        code = line.split("//")[0]
        if not re.search(call, code):
            continue
        assert not re.match(r"\s*(if|else)\b", code), f"{source}:{n}: {line.strip()}"
        assert not re.search(r"(&&|\|\||\?)[^;]*" + call, code), f"{source}:{n}: {line.strip()}"
