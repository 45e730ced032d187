"""The deposit's preparation (``ops.deposit.prepare_plain``, the plain version
of ``csrc/deposit_prep.cu``, and ``ops.autodiff.PrepareFunction``) against
molvoxel_tpu on the CPU, on the same numpy inputs: the batch path's order
(center, Morton sort, transform), the permutation, the atom rows, the plane
ranges, the explicit backward against ``jax.vjp`` and against autograd, a
step-by-step model of the kernel's cluster sort against ``torch.argsort``,
and its launch plan (``prep_launch``)."""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molvoxel_torch.core.config import GridSpec as TSpec
from molvoxel_torch.ops import _build, autodiff, deposit
from molvoxel_tpu.core.config import GridSpec as JSpec
from molvoxel_tpu.core.transform import do_transform as jax_do_transform
from molvoxel_tpu.ops import pallas_deposit
from molvoxel_tpu.ops.batch import voxelize_batch as jax_voxelize_batch
from molvoxel_tpu.ops.pallas_deposit import _plane_ranges_closed, _sort_atoms_spatially, voxelize_pallas_batch

GRAD_BAR = 5e-3  # the gate's backward bar (tools/round_gate.py:230)
H100_BLOCK_SMEM = 232_448  # shared memory a block of an H100 can use (227 KB)


def _unit_quaternions(rng, b):
    q = rng.normal(size=(b, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _inputs(rng, b, v, c, box, masked=5):
    coords = rng.uniform(-box, box, size=(b, v, 3)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(b, v, c)).astype(np.float32)
    mask = np.ones((b, v), bool)
    mask[:, :masked] = False
    mask[:, v - masked:] = False
    centers = rng.uniform(-0.5, 0.5, size=(b, 3)).astype(np.float32)
    q = _unit_quaternions(rng, b)
    t = rng.uniform(-0.5, 0.5, size=(b, 3)).astype(np.float32)
    return coords, weights, mask, centers, q, t


def _plan(spec, density="gaussian", **kw):
    return deposit.PrepPlan(spec, density != "binary", 0.5, notrunc=density == "gaussian_notrunc", **kw)


def _table(q, t):
    return deposit.transform_table((None if q is None else torch.as_tensor(q),
                                    None if t is None else torch.as_tensor(t)), "cpu")


@pytest.fixture
def captured_pallas(monkeypatch):
    """pl.pallas_call replaced by a stub that keeps each launch's inputs
    (for _run_v5: ranges, atom rows, weights) and returns zeros; the JAX
    package's wrapper then runs eagerly up to the launch."""
    calls = []

    def fake(kernel, *, out_shape, **kw):
        def run(*args):
            calls.append([np.asarray(a) for a in args])
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return run

    monkeypatch.setattr(pallas_deposit.pl, "pallas_call", fake)
    return calls


@pytest.mark.parametrize("density,dim,slab", [("gaussian", 16, None), ("binary", 16, (3, 9)),
                                              ("gaussian_notrunc", 32, None), ("gaussian", 32, (8, 12))])
def test_prepare_plain_matches_the_jax_batch_path(rng, captured_pallas, density, dim, slab):
    """B = 2, V = 256 atoms (so both packages sort, and neither pads), C = 3,
    per-atom radii, a mask, centers and explicit transforms, in the batch
    path's order (molvoxel_tpu/ops/batch.py:105-119): center, sort by the
    centered coordinates, transform.  The permutation equals the one
    _sort_atoms_spatially applies and the plane ranges equal
    _plane_ranges_closed at the forward's range rows (both exactly); the rows equal
    _run_v5's at rtol 1e-6 (coef is a reciprocal times a scalar here, a
    quotient there), and the coordinate rows, like the placed coordinates
    against do_transform's, within 1e-6 of the grid width (the JAX package
    rotates by a matrix product, the port by sums of products)."""
    b, v, c = 2, 256, 3
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask, centers, q, t = _inputs(rng, b, v, c, spec_t.width / 2)
    radii = rng.uniform(0.7, 1.6, size=(b, v)).astype(np.float32)
    d_offset, d_count = (0, None) if slab is None else slab
    plan = _plan(spec_t, density, d_offset=d_offset, d_count=d_count)
    got = deposit.prepare_plain(*map(torch.as_tensor, (coords, weights, radii, mask, centers)), _table(q, t), plan)
    perm = got.perm.numpy()

    # the JAX batch path, step by step, with the transforms given
    centered = jnp.asarray(coords) - jnp.asarray(centers)[:, None, :]
    index = jnp.broadcast_to(jnp.arange(v, dtype=jnp.float32)[None, :, None], (b, v, 1))
    s_coords, s_w, s_r, s_mask = _sort_atoms_spatially(centered, jnp.concatenate([jnp.asarray(weights), index], -1),
                                                       jnp.asarray(radii), jnp.asarray(mask), spec_j, 0)
    np.testing.assert_array_equal(perm, np.asarray(s_w[..., -1]).astype(np.int32))
    placed = jax.vmap(lambda crd, qq, tt: jax_do_transform(crd, None, tt, qq))(s_coords, jnp.asarray(q), jnp.asarray(t))
    with jax.disable_jit():
        voxelize_pallas_batch(placed, s_w[..., :-1], s_r, spec=spec_j, density_type=density, sigma=0.5, mask=s_mask,
                              d_offset=d_offset, d_count=d_count, presorted=True)
    _, atom_rows, wt = captured_pallas[-1]
    np.testing.assert_allclose(got.rows[:, 3:].numpy(), atom_rows[:, 3:], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.rows[:, :3].numpy(), atom_rows[:, :3], rtol=0, atol=1e-6 * spec_t.width)
    np.testing.assert_array_equal(got.weights.numpy(), wt[:, :c])

    want_xyz = np.stack([np.asarray(jax_do_transform(jnp.asarray(coords[i] - centers[i]), None, jnp.asarray(t[i]),
                                                     jnp.asarray(q[i]))) for i in range(b)])
    xyz = got.rows[:, :3].numpy().transpose(0, 2, 1).copy()
    xyz[..., 0] += np.float32(d_offset) * np.float32(0.5)
    np.testing.assert_allclose(xyz, np.take_along_axis(want_xyz, perm[..., None].astype(np.int64), 1), rtol=0,
                               atol=1e-6 * spec_t.width)

    dl = dim if d_count is None else d_count
    ht = deposit.range_rows(b, c, dl, dim, got.rows.shape[2])
    shifted = got.rows[:, :3].transpose(1, 2).numpy()
    want = np.asarray(_plane_ranges_closed(jnp.asarray(shifted), jnp.asarray(got.rows[:, 3].numpy()), spec_j, dl,
                                           -(-dim // ht), ht, deposit.CHUNK))
    np.testing.assert_array_equal(got.ranges.numpy().reshape(-1, 1, 2), want)


def test_padding_sorts_last_and_one_chunk_keeps_its_order(rng):
    """Padding atoms follow every real one (masked or not) in their input
    order; a molecule of one chunk, or a presorted one, keeps its order."""
    spec = TSpec(0.5, 16)
    coords, weights, mask, *_ = _inputs(rng, 2, 100, 2, 4.0)
    radii = torch.ones(100)
    for m in (torch.as_tensor(mask), None):
        got = deposit.prepare_plain(torch.as_tensor(coords), torch.as_tensor(weights), radii, m, None,
                                    deposit.Transforms(None, False, False), _plan(spec))
        assert got.perm.shape == (2, 128)
        assert (got.perm[:, 100:] == torch.arange(100, 128)).all()
        assert sorted(got.perm[0, :100].tolist()) == list(range(100))
    for v, sort in ((64, True), (100, False)):
        got = deposit.prepare_plain(torch.as_tensor(coords[:, :v]), torch.as_tensor(weights[:, :v]), torch.ones(v),
                                    None, None, deposit.Transforms(None, False, False), _plan(spec, sort=sort))
        assert (got.perm == torch.arange(got.perm.shape[1])).all()


JAX_VJP_CASES = ["shared_radii", "batched_radii", "channelwise"]


@pytest.mark.parametrize("variant", JAX_VJP_CASES)
def test_prepare_backward_matches_jax_vjp_of_the_batch_path(rng, variant):
    """Gradients of coords, weights, radii (shared (V,), per molecule
    (B, V), or per channel) and centers through the preparation's explicit
    backward and the deposit's plain backward, against jax.vjp of the JAX
    batch path (dense impl) on the same inputs: center, transform with
    explicit quaternions and translations, mask; B = 2, V = 130 (sorted,
    three chunks), 16^3.  Bar 5e-3 x max(1, gradient scale)."""
    b, v, c, dim = 2, 130, 3, 16
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask, centers, q, t = _inputs(rng, b, v, c, 3.0)
    channelwise = variant == "channelwise"
    if channelwise:
        radii = np.asarray([0.9, 1.2, 1.5], np.float32)
    else:
        radii = rng.uniform(0.8, 1.6, size=(v,) if variant == "shared_radii" else (b, v)).astype(np.float32)
    ct = rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)

    leaves = [torch.tensor(a, requires_grad=True) for a in (coords, weights, radii, centers)]
    fn = deposit.voxelize_deposit_batch_channelwise if channelwise else deposit.voxelize_deposit_batch
    out = fn(*leaves[:3], spec=spec_t, mask=torch.as_tensor(mask), centers=leaves[3],
             transforms=(torch.as_tensor(q), torch.as_tensor(t)))
    got = torch.autograd.grad(out, leaves, grad_outputs=torch.as_tensor(ct))

    def jfn(crd, w, r, cen):
        placed = jax.vmap(lambda x, qq, tt: jax_do_transform(x, None, tt, qq))(crd - cen[:, None, :], jnp.asarray(q),
                                                                             jnp.asarray(t))
        return jax_voxelize_batch(placed, w, r, jnp.asarray(mask), None, jax.random.split(jax.random.PRNGKey(0), b),
                                  spec=spec_j, impl="dense", channelwise=channelwise,
                                  radii_batched=variant == "batched_radii")

    want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, (coords, weights, radii, centers)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    want = vjp(jnp.asarray(ct))
    scale = max(max(float(np.abs(np.asarray(w)).max()) for w in want), 1.0)
    for g, w, name in zip(got, want, ("dcoords", "dweights", "dradii", "dcenters")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_BAR * scale, err_msg=name)


TRANSFORM_GRAD_CASES = ["deposit_batch", "deposit_batch_channelwise", "voxelize_batch"]


@pytest.mark.parametrize("variant", TRANSFORM_GRAD_CASES)
def test_transform_gradient_matches_jax_vjp(rng, variant):
    """Gradients of the quaternions and translations handed in as
    ``transforms`` (the transform table's gradient, carried on through
    quaternion_to_matrix) against jax.vjp of the JAX batch path (dense
    impl) under do_transform of the same quaternions and translations:
    through the preparation's explicit backward (voxelize_deposit_batch,
    per-atom or channel-wise radii) and through ``voxelize_batch``'s CPU
    route (apply_transforms).  B = 2, V = 130 (three chunks), 16^3, with
    mask and center.  Bar 5e-3 x max(1, gradient scale)."""
    from molvoxel_torch.ops.batch import voxelize_batch

    b, v, c, dim = 2, 130, 3, 16
    spec_t, spec_j = TSpec(0.5, dim), JSpec(0.5, dim)
    coords, weights, mask, centers, q, t = _inputs(rng, b, v, c, 3.0)
    channelwise = variant == "deposit_batch_channelwise"
    radii = (np.asarray([0.9, 1.2, 1.5], np.float32) if channelwise
             else rng.uniform(0.8, 1.6, size=(v,)).astype(np.float32))
    ct = rng.normal(size=(b, c, dim, dim, dim)).astype(np.float32)
    tq, tt = torch.tensor(q, requires_grad=True), torch.tensor(t, requires_grad=True)
    args = [torch.as_tensor(a) for a in (coords, weights, radii)]
    if variant == "voxelize_batch":
        out = voxelize_batch(*args, torch.as_tensor(mask), torch.as_tensor(centers), spec=spec_t, transforms=(tq, tt))
    else:
        fn = deposit.voxelize_deposit_batch_channelwise if channelwise else deposit.voxelize_deposit_batch
        out = fn(*args, spec=spec_t, mask=torch.as_tensor(mask), centers=torch.as_tensor(centers),
                 transforms=(tq, tt))
    got = torch.autograd.grad(out, (tq, tt), grad_outputs=torch.as_tensor(ct))

    def jfn(qq, tr):
        placed = jax.vmap(lambda x, a, bb: jax_do_transform(x, None, bb, a))(
            jnp.asarray(coords - centers[:, None, :]), qq, tr)
        return jax_voxelize_batch(placed, jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(mask), None,
                                  jax.random.split(jax.random.PRNGKey(0), b), spec=spec_j, impl="dense",
                                  channelwise=channelwise)

    want_out, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(t))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    want = vjp(jnp.asarray(ct))
    scale = max(max(float(np.abs(np.asarray(w)).max()) for w in want), 1.0)
    for g, w, name in zip(got, want, ("dq", "dt")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GRAD_BAR * scale, err_msg=name)


AUTOGRAD_CASES = [
    # density, radii kind, mask, placed, slab
    ("gaussian", "shared", True, True, None),
    ("gaussian", "batched", True, False, (3, 7)),
    ("gaussian", "channel", True, True, None),
    ("gaussian", "channel", False, False, None),
    ("binary", "batched", False, True, None),
    ("gaussian_notrunc", "shared", True, True, (2, 9)),
    ("gaussian_notrunc", "batched", False, False, None),
    ("gaussian", "shared", False, True, None),
]


@pytest.mark.parametrize("density,radii_kind,masked,placed,slab", AUTOGRAD_CASES,
                         ids=[f"{d}-{r}-{'mask' if m else 'nomask'}-{'placed' if p else 'raw'}-{'slab' if s else 'full'}"
                              for d, r, m, p, s in AUTOGRAD_CASES])
def test_prepare_backward_matches_autograd_of_prepare_plain(rng, density, radii_kind, masked, placed, slab):
    """PrepareFunction's explicit backward against torch autograd through
    prepare_plain, at random cotangents of the rows and weights: coords,
    weights, radii, centers, and (placed) the quaternions and translations
    through the transform table, within 1e-6 of the gradient scale.  B = 2,
    V = 150 (padded to 192, sorted), C = 3."""
    b, v, c, dim = 2, 150, 3, 12
    spec = TSpec(0.5, dim)
    coords, weights, mask, centers, q, t = _inputs(rng, b, v, c, 3.0)
    if radii_kind == "channel":
        radii = rng.uniform(0.8, 1.6, size=(c,)).astype(np.float32)
    else:
        radii = rng.uniform(0.8, 1.6, size=(v,) if radii_kind == "shared" else (b, v)).astype(np.float32)
    d_offset, d_count = (0, None) if slab is None else slab
    plan = _plan(spec, density, d_offset=d_offset, d_count=d_count, channelwise=radii_kind == "channel")
    m = torch.as_tensor(mask) if masked else None

    def leaves():
        return [torch.tensor(a, requires_grad=True) for a in (coords, weights, radii, centers, q, t)]

    def table(lv):
        return deposit.transform_table((lv[4], lv[5]), "cpu") if placed else deposit.Transforms(None, False, False)

    mine = leaves()
    rows, wt, ranges, dl = autodiff.prepare(mine[0], mine[1], mine[2], m, mine[3] if placed else None, table(mine),
                                            plan)
    ref = leaves()
    want_p = deposit.prepare_plain(ref[0], ref[1], ref[2], m, ref[3] if placed else None, table(ref), plan)
    assert torch.equal(rows, want_p.rows) and torch.equal(wt, want_p.weights) and torch.equal(ranges, want_p.ranges)
    g_rows = torch.as_tensor(rng.normal(size=tuple(rows.shape)).astype(np.float32))
    g_wt = torch.as_tensor(rng.normal(size=tuple(wt.shape)).astype(np.float32))
    n = 6 if placed else 3
    got = torch.autograd.grad((rows, wt), mine[:n], grad_outputs=(g_rows, g_wt))
    want = torch.autograd.grad((want_p.rows, want_p.weights), ref[:n], grad_outputs=(g_rows, g_wt))
    scale = max(max(float(w.abs().max()) for w in want), 1.0)
    for g, w, name in zip(got, want, ("dcoords", "dweights", "dradii", "dcenters", "dq", "dt")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6 * scale, err_msg=name)
    if masked:
        assert not got[1][torch.as_tensor(~mask)].any()  # masked atoms: no weight gradient


def test_transform_table_holds_quaternion_to_matrix_bit_for_bit(rng):
    """The table's rotations are quaternion_to_matrix's bits, in float32
    and float64, and a missing part is zero with its flag off; apply_table
    rotates and translates as rotate and a sum do."""
    from molvoxel_torch.core.transform import quaternion_to_matrix, rotate

    for dtype in (np.float32, np.float64):
        q = torch.as_tensor(_unit_quaternions(rng, 33).astype(dtype))
        t = torch.as_tensor(rng.uniform(-1, 1, size=(33, 3)).astype(dtype))
        tt = deposit.transform_table((q, t), "cpu")
        assert tt.rot and tt.trans and tt.table.dtype == q.dtype
        assert torch.equal(tt.table[:, :9].reshape(33, 3, 3), quaternion_to_matrix(q))
        assert torch.equal(tt.table[:, 9:], t)
        coords = torch.as_tensor(rng.normal(size=(33, 20, 3)).astype(dtype))
        assert torch.equal(deposit.apply_table(coords, tt), rotate(coords, quaternion_to_matrix(q)) + t[:, None, :])
    only_t = deposit.transform_table((None, t), "cpu")
    assert not only_t.rot and only_t.trans and not only_t.table[:, :9].any()
    assert deposit.transform_table((None, None), "cpu") == deposit.Transforms(None, False, False)


# ------------------------------------------------- the kernel's sort, modelled

def _cu_constant(name: str) -> int:
    text = (_build.CSRC / "deposit_prep.cu").read_text()
    return int(eval(re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)))


def _radix_pass(words, shift, split, seg, threads):
    """One digit pass of radix_sort over the cluster: block r holds the
    words [r*seg, (r+1)*seg); warp w takes its words (w * items + k) * 32 +
    lane round by round (k) and ranks each among the earlier lanes of its
    digit in the round (__match_any_sync) plus the warp's running count of
    that digit; each block's prefix of its warps' counts and its 256 counts;
    the cluster's prefix of the counts (the words of lower digits in every
    block, plus those of the same digit in lower blocks); each word to rank
    base + warp prefix + its rank in the warp.  Returns the words in rank
    order."""
    vp = len(words)
    items = -(-seg // threads)
    lanes = np.arange(32)
    counts = np.zeros((split, 256), np.int64)
    placed = []  # per block: (its words, their digits, warp prefix + rank in the warp)
    for r in range(split):
        mine = words[r * seg:min((r + 1) * seg, vp)]
        digit = (mine >> shift) & 0xFF
        hist = np.zeros((threads // 32, 256), np.int64)
        rank = np.zeros(len(mine), np.int64)
        warp_of = np.zeros(len(mine), np.int64)
        for w in range(threads // 32):
            for k in range(items):
                p = (w * items + k) * 32 + lanes
                p = p[p < len(mine)]
                d = digit[p]
                before = ((d[None, :] == d[:, None]) & (p[None, :] < p[:, None])).sum(1)
                rank[p] = hist[w, d] + before
                warp_of[p] = w
                hist[w] += np.bincount(d, minlength=256)
        prefix = np.cumsum(hist, axis=0) - hist  # the warps' exclusive prefix, per digit
        counts[r] = hist.sum(0)
        placed.append((mine, digit, prefix[warp_of, digit] + rank))
    total = counts.sum(0)
    out = np.full(vp, -1, np.int64)
    for r, (mine, digit, local) in enumerate(placed):
        dest = (np.cumsum(total) - total + counts[:r].sum(0))[digit] + local
        assert (out[dest] == -1).all()  # every rank is written once
        out[dest] = mine
    return out


def _kernel_order(keys: np.ndarray, masked: np.ndarray, batch: int = 1, wide: int = 7) -> np.ndarray:
    """The order deposit_prep gives one molecule's (Vp,) keys, as the .cu
    computes it, step by step.  The molecule is one cluster of
    ``prep_launch``'s split blocks; block r sorts the words of input atoms
    [r*seg, (r+1)*seg): key16 << 16 | index, key16 the Morton key or
    kMaskedKey.  Shares of up to PREP_SEARCH_SHARE atoms (search_sort):
    each block ranks its words in its share by counting the words below
    each, stores the share in that order into every block, and a word's
    rank in the molecule is the sum over the shares of the words below it
    (a binary search in each); larger shares (radix_sort): two digit
    passes, the key's low byte and then its high one (``_radix_pass``)."""
    vp = len(keys)
    launch = deposit.prep_launch(batch, vp, vp, 24, True, wide)
    split, seg, threads = launch.split, launch.seg, launch.threads
    assert split * seg >= vp and split * launch.oseg >= vp
    key16 = np.where(masked, _cu_constant("kMaskedKey"), keys).astype(np.int64)
    words = (key16 << 16) | np.arange(vp, dtype=np.int64)
    if seg > deposit.PREP_SEARCH_SHARE:
        for shift in (16, 24):
            words = _radix_pass(words, shift, split, seg, threads)
        return words & 0xFFFF
    shares = []
    for r in range(split):
        mine = words[r * seg:min((r + 1) * seg, vp)]
        in_share = (mine[None, :] < mine[:, None]).sum(1)  # the words below each, in its share
        sorted_share = np.full(len(mine), -1, np.int64)
        sorted_share[in_share] = mine
        assert (sorted_share >= 0).all()  # the words are unique, so the ranks are a permutation
        shares.append((mine, sorted_share))
    out = np.full(vp, -1, np.int64)
    for mine, _ in shares:
        dest = sum(np.searchsorted(other, mine, side="left") for _, other in shares)
        assert (out[dest] == -1).all()  # every rank is written once
        out[dest] = mine
    return out & 0xFFFF


@pytest.mark.parametrize("vp,distinct", [(128, 3), (192, 40), (4096, 7), (4096, 32768), (16384, 50), (16448, 9),
                                         (65536, 300), (4096, 1)])
def test_kernel_sort_model_equals_stable_argsort(rng, vp, distinct):
    """Ties (few distinct keys; one key for every unmasked atom of the
    4,096, so ties run across every block's share), masked atoms, shares
    ranked by search (up to 8,192 atoms in 16 blocks, 4,096 in 8) and by
    digits (above, up to the 65,536-atom cap), clusters of 16 and of the
    portable 8, and a batch's smaller clusters: the kernel's order is
    torch.argsort(stable=True) of the Morton keys, masked atoms last."""
    keys = rng.integers(0, distinct, size=vp).astype(np.int64) * (32768 // distinct)
    masked = rng.uniform(size=vp) < 0.1
    full = np.where(masked, 1 << 30, keys)
    want = torch.argsort(torch.as_tensor(full), stable=True).numpy()
    for batch, wide in ((1, 7), (1, 0), (64, 7)):
        np.testing.assert_array_equal(_kernel_order(keys, masked, batch, wide), want)


def test_kernel_constants_match_the_wrapper():
    assert _cu_constant("kChunk") == deposit.CHUNK
    assert _cu_constant("kMaxThreads") == deposit.PREP_MAX_THREADS
    assert _cu_constant("kItems") == deposit.PREP_ITEMS
    assert _cu_constant("kSearchShare") == deposit.PREP_SEARCH_SHARE
    assert _cu_constant("kSortThreads") == deposit.PREP_SORT_THREADS
    assert _cu_constant("kMaxCluster") == deposit.PREP_MAX_CLUSTER
    assert _cu_constant("kStage") == deposit.PREP_STAGE
    assert _cu_constant("kDigits") == 256  # an 8-bit digit: two passes cover the 16-bit key
    assert _cu_constant("kMaskedKey") == 1 << 15  # above every 15-bit Morton key
    assert "kFar = 1e3f" in (_build.CSRC / "deposit_prep.cu").read_text() and deposit.FAR == 1e3


@pytest.mark.parametrize("v", [61, 65, 468, 3262, 16385, 20000, 65536])
def test_prep_launch_plan_covers_every_chunk_and_rank(v):
    """``prep_launch`` for B in {1, 8, 64, 70000}, one or four channels
    (channel-wise too), with and without a sort, at both cluster caps:
    every output chunk has exactly one block, every sorted rank one owner,
    a cluster holds at most 16 blocks (the cap asked for), each block's
    words fit its threads' registers, and its shared memory fits an H100
    block (227 KB)."""
    vp = -(-v // 64) * 64
    for b in (1, 8, 64, 70_000):
        for c, channelwise, nht in ((1, False, 24), (4, False, 2), (4, True, 64)):
            vo = c * vp if channelwise else vp
            nvc = vo // 64
            for sort in {vp > 64, False}:
                for wide in (0, 7):
                    plan = deposit.prep_launch(b, vp, vo, nht, sort, wide)
                    split, cpb, seg, oseg, threads, smem = plan
                    chunks = np.zeros(nvc, np.int64)
                    for s in range(split):
                        chunks[s * cpb:(s + 1) * cpb] += 1
                    assert (chunks == 1).all(), plan
                    assert smem == deposit.prep_smem(sort, vp, seg, oseg, split, threads, cpb) <= H100_BLOCK_SMEM
                    assert threads % 32 == 0 and threads <= deposit.PREP_MAX_THREADS and b * split < 2**31, plan
                    if not sort:
                        assert seg == oseg == 0 and split <= nvc and threads >= 128, plan
                        continue
                    for share in (seg, oseg):  # the atoms each block sorts, then the ranks each receives
                        ranks = np.zeros(vp, np.int64)
                        for r in range(split):
                            ranks[r * share:(r + 1) * share] += 1
                        assert (ranks == 1).all(), plan
                    assert seg % 32 == 0 and seg <= threads * deposit.PREP_ITEMS, plan
                    assert threads >= deposit.PREP_SORT_THREADS, plan
                    assert split <= (deposit.PREP_MAX_CLUSTER if b <= wide else 8) and split <= 16, plan
    assert deposit.prep_launch(64, 64, 64, 2, False) == (1, 1, 0, 0, 128, 64 * 16)  # the headline: a block each


def test_kernel_sort_model_on_morton_keys_of_a_molecule(rng):
    """On real keys (morton_keys of a cloud: 1,500 atoms in a 10-A box at
    64^3, res 0.5, so about 1-A cells and many ties): the modelled kernel
    order is the order prepare_plain applies."""
    spec = TSpec(0.5, 64)
    coords, weights, mask, *_ = _inputs(rng, 1, 1500, 1, 5.0)
    got = deposit.prepare_plain(torch.as_tensor(coords), torch.as_tensor(weights), torch.ones(1500),
                                torch.as_tensor(mask), None, deposit.Transforms(None, False, False), _plan(spec))
    padded = torch.nn.functional.pad(torch.as_tensor(coords), (0, 0, 0, 36), value=deposit.FAR)
    m = torch.nn.functional.pad(torch.as_tensor(mask), (0, 36), value=False)
    keys = deposit.morton_keys(padded, spec).numpy()[0]
    assert len(np.unique(keys)) < 1000  # ties
    np.testing.assert_array_equal(_kernel_order(keys, ~m.numpy()[0]), got.perm.numpy()[0])


# ------------------------------------------------------- the CUDA wrapper

def test_prep_wrapper_launches_once_below_the_line_and_twice_above(monkeypatch):
    """With a stand-in library: the arguments the wrapper passes through
    the shape's launch plan (shapes, ht, the launch of ``prep_launch`` at
    the card's cluster cap, radii mode, sort) and one launch counted at
    every size, up to the 65,536-atom cap:
    the shared-memory line of 16,384 atoms, and the keys launch and
    torch.argsort above it, are gone."""
    calls = []

    class FakeLib:
        def deposit_prep(self, *args):
            calls.append(("prep", args))
            return 0

        def deposit_prep_setup(self):
            calls.append(("setup", ()))
            return 7

    monkeypatch.setattr(deposit, "_kernel_lib", lambda name: FakeLib())
    monkeypatch.setattr(deposit, "_WIDE_CLUSTERS", {})
    monkeypatch.setattr(deposit, "_PLANS", {})
    monkeypatch.setattr(deposit, "_check_prep_inputs", lambda *a: None)
    monkeypatch.setattr(deposit, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)  # meta tensors' device: no context entered
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    spec = TSpec(0.5, 48)
    for b, v, c, channelwise in ((64, 61, 4, False), (1, 4096, 1, False), (2, 61, 4, True), (1, 20000, 1, False),
                                 (1, 65536, 1, False)):
        calls.clear()
        before = dict(deposit.launches)
        coords = torch.empty((b, v, 3), device="meta")
        radii = torch.empty((c,) if channelwise else (v,), device="meta")
        plan = _plan(spec, channelwise=channelwise)
        out = deposit.deposit_prep(coords, torch.empty((b, v, c), device="meta"), radii, None, None,
                                   deposit.Transforms(None, False, False), plan)
        vp = -(-v // 64) * 64
        vo = c * vp if channelwise else vp
        ht = deposit.range_rows(b, c, 48, 48, vo)
        assert ht == (deposit.TILE_RANGE_ROWS if vo > 64 else deposit.brick_rows(b, c, 48, 48)[1])
        assert out.rows.shape == (b, 8, vo) and out.weights.shape == (b, c, vo) and out.perm.shape == (b, vp)
        assert out.ranges.shape == (b, -(-48 // ht), vo // 64, 2) and out.dl == 48
        assert deposit.launches == dict(before, deposit_prep=before["deposit_prep"] + 1)
        assert [kind for kind, _ in calls] == (["setup", "prep"] if v == 61 and not channelwise else ["prep"])
        args = calls[-1][1]
        assert len(args) == 42
        launch = deposit.prep_launch(b, vp, vo, -(-48 // ht), vp > 64, 7)
        assert args[10:19] == (b, v, vp, c, vo, 48, 48, ht, -(-48 // ht)) and args[23] == (2 if channelwise else 0)
        assert args[19:23] == launch[:4] and args[-3:-1] == launch[4:] and args[26] == int(vp > 64)
        assert launch.split <= 16 and (launch.split == 1 or b * launch.split <= 2 * deposit.PREP_TARGET_BLOCKS)
    assert deposit._WIDE_CLUSTERS == {torch.device("meta"): 7}  # the card's 16-block clusters, asked once
