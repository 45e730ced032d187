"""Deposit on the CUDA kernels ``csrc/deposit_prep.cu``, ``csrc/deposit_fwd.cu`` and ``csrc/deposit_bwd.cu``, and their plain versions.

Counterpart of the forward and backward halves of
``molvoxel_tpu/ops/pallas_deposit.py``.  The O(V) bookkeeping before a
forward launch is one kernel, ``deposit_prep`` (its plain version,
``prepare_plain``, composes the torch functions below):

- pad the atom axis to whole 64-atom chunks with far-off, zero-weight atoms;
- subtract each molecule's center and apply its rigid transform (the
  batch path: ``transform_table`` carries rotations and translations);
- sort atoms along a Morton curve (``morton_keys``), so each chunk is
  spatially compact and its plane ranges are tight;
- build the per-atom rows [x - d_offset*res, y, z, r2_thresh, coef] (B, 8, Vp),
  where r2_thresh is r^2, or for gaussian_notrunc the radius beyond which
  the density is negligible (``notrunc_r2_thresh``), and coef comes from the
  true r^2;
- compute, in closed form, the depth planes [d_lo, d_hi) that each
  (tile of ht rows, atom chunk) pair can reach (``plane_ranges``);
- expand channel-wise radii into virtual atoms (same position, radius r_c,
  weight only in channel c), so they run on the same kernel.

The Python side plans the forward kernel's bricks (``brick``: dt depth
planes x ht whole h rows a block, chosen per grid) and the backward's warps
per atom (``bwd_warps_per_atom``).  Threshold rows (gaussian_notrunc,
``notrunc=True``) take their own launches: the forward's warp
sub-bricks (``notrunc_brick``) for molecules of more than one chunk, and
the backward's atom walk in groups of ``BWD_NOTRUNC_GROUP`` columns.  ``deposit_prep`` (atoms -> rows,
weights, ranges, permutation), ``deposit_fwd`` (rows, weights -> grid) and
``deposit_bwd`` (cotangent grid -> gradients of rows and weights) launch
their kernels on CUDA tensors and run ``prepare_plain`` / ``deposit_plain``
/ ``deposit_bwd_plain`` (the same functions in torch tensor ops) on CPU
tensors.  Nothing on a CUDA tensor falls back to a plain version: a failed
build or launch raises.  The wrappers below go through ``ops.autodiff``
(``prepare`` and ``deposit``), so they are differentiable in coordinates,
weights, radii and centers.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import GridSpec, round_up
from ..core.transform import quaternion_to_matrix, rotate
from ..utils.timing import count, launches, recording, reset_launches, span  # noqa: F401  (reset_launches re-exported)
from . import _build

CHUNK = 64  # atoms per chunk (kChunk in deposit_fwd.cu)
BRICK_THREADS = 256  # threads of the largest forward block (kMaxThreads)
ACC_MAX = 32  # f32 accumulators a forward thread holds (kAccMax)
STORE_BYTES = 16  # bytes of output a forward thread stores at once (kStoreBytes)
TARGET_BLOCKS = 16 * 132  # bricks shrink until a launch has this many blocks: 16 per SM of an H100 SXM
MIN_LANES = 24  # ... or until a smaller brick would leave most of a warp idle (f32 runs)
BWD_THREADS = 256  # threads of a backward block (kThreads in deposit_bwd.cu): 8 warps
BWD_TARGET_WARPS = 16 * 132  # a backward launch spreads atoms over warps until it has this many: 16 per SM
FAR = 1e3  # coordinate of padding atoms: far outside any grid (kFar in deposit_prep.cu)
PREP_MAX_THREADS = 1024  # threads of the largest preparation block (kMaxThreads)
PREP_SEARCH_SHARE = 512  # atoms a block of a sorting cluster ranks by search, at most (kSearchShare)
PREP_ITEMS = 8  # sort words a thread holds in the radix sort of larger shares (kItems): at most 8,192 a block
PREP_SORT_THREADS = 256  # threads of a sorting block, at least (kSortThreads)
PREP_MAX_CLUSTER = 16  # blocks of the largest sorting cluster (kMaxCluster); 8 is portable
PREP_MIN_SHARE = 64  # a sorting molecule splits no further than this many padded atoms a block
PREP_PAIR_THREADS = 16  # threads a block takes for each (row tile, chunk) pair of its plane ranges
PREP_STAGE = 2048  # output atoms a preparation block keeps in shared memory at once (kStage)
PREP_TARGET_BLOCKS = 132  # a small batch splits its molecules' chunks until a launch has this many blocks
NOTRUNC_SIDE = 4  # planes and rows of a threshold-row warp's sub-brick (kNtSide in deposit_fwd.cu)
NOTRUNC_WARP_CAP = 32  # atoms a threshold-row warp deposits per fill of its tables (kNtWarpCap)
NOTRUNC_BLOCK_WARPS = ((2, 2, 1), (1, 1, 2), (1, 1, 1))  # threshold-row blocks (warps along d, h, w), largest first
NOTRUNC_TARGET_BLOCKS = 96  # a threshold-row launch takes the largest block that gives this many blocks
BWD_NOTRUNC_GROUP = 4  # consecutive w a threshold-row backward lane takes (kGroup in deposit_bwd.cu)
_PLAIN_BUDGET = 1 << 26  # elements of deposit_plain's (planes, H*W, chunk) temporary

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_CT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# gaussian_notrunc pruning (a copy of the JAX package's, pallas_deposit.py:65-86):
# density contributions below NOTRUNC_EPS are dropped, which keeps the
# worst-case additive error (V * eps) under 4e-6 for 3.3k-atom proteins.
NOTRUNC_EPS = 1e-9
_F32_ZERO_LOG = 103.972  # -ln(2^-150): exp(-x) rounds to f32 +0.0 for x above this

# Launches of each kernel, counted by its wrapper where it launches
# (``launches`` is the tracer's, utils/timing.py; counted whether or not a
# profiler records).
launches.update(dict.fromkeys(("deposit_prep", "deposit_fwd", "deposit_bwd", "deposit_fwd_notrunc",
                               "deposit_bwd_notrunc"), 0))


# The work each forward and preparation was given, known on the host and
# counted only while a profiler records (untraced: one flag read): the bytes
# of the grids a forward writes, and the padded atom slots a preparation
# Morton-sorts (0 when it does not sort).


def _count_grid(out: torch.Tensor) -> torch.Tensor:
    if recording():
        count("molvoxel.grid_bytes", out.numel() * out.element_size())
    return out


def _count_sort(out: Prepared, plan: PrepPlan) -> Prepared:
    if recording():
        count("molvoxel.sort_slots", out.perm.numel() if plan.sort and out.perm.shape[1] > CHUNK else 0)
    return out


def out_torch_dtype(out_dtype) -> torch.dtype:
    """"float32" / "bfloat16" / "float8_e4m3fn" (or a torch dtype) -> torch dtype."""
    dt = getattr(torch, out_dtype) if isinstance(out_dtype, str) else out_dtype
    if dt not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be float32, bfloat16 or float8_e4m3fn, got {out_dtype!r}")
    return dt


def check_kernel_dtype(on_cuda: bool, dtype: torch.dtype):
    """The CUDA deposit computes in float32: float64 on the card raises
    rather than being cast down.  float64 is the CPU parity lane."""
    if on_cuda and dtype == torch.float64:
        raise ValueError(
            "the CUDA deposit is float32; precision=64 (float64) is the CPU parity lane: "
            "pass device='cpu', or impl='dense' to run the plain float64 path on the card"
        )


def check_density(density_type: str) -> bool:
    """True for gaussian and gaussian_notrunc, False for binary; raises for
    anything else."""
    if density_type not in ("gaussian", "binary", "gaussian_notrunc"):
        raise ValueError(f"unknown density_type {density_type!r}")
    return density_type != "binary"


def notrunc_factor(sigma: float, eps: float = NOTRUNC_EPS) -> float:
    """2 sigma^2 ln(1/eps): ``notrunc_r2_thresh`` is r^2 times this."""
    log_inv = _F32_ZERO_LOG if eps <= 0.0 else min(math.log(1.0 / eps), _F32_ZERO_LOG)
    return 2.0 * sigma * sigma * log_inv


def notrunc_r2_thresh(r2, sigma: float, eps: float = NOTRUNC_EPS):
    """Squared cutoff radius beyond which a no-cutoff gaussian is negligible.

    exp(-0.5 * d2 / (sigma^2 r^2)) <= eps  <=>  d2 >= 2 sigma^2 ln(1/eps) r2.
    eps=0.0 gives the f32 underflow radius (the density rounds to +0.0
    beyond it), i.e. bit-level notrunc."""
    return r2 * notrunc_factor(sigma, eps)


# ------------------------------------------------------------- bookkeeping


def morton_keys(coords: torch.Tensor, spec: GridSpec, mask: torch.Tensor | None = None, bits: int = 5):
    """(B, Vp) int32 Morton (Z-order) cell keys; x bits most significant.
    Masked (padding) atoms key to 2^30, so they sort last."""
    cells = (1 << bits) - 1
    # Python scalars: float32 arithmetic with the scalars rounded to float32,
    # as numpy does (data.feed.morton_presort gives the same keys), and no
    # host-to-device copy
    scale = cells / max(spec.width, 1e-6)
    cell = ((coords.to(torch.float32) - spec.lower_bound) * scale).clamp(0, cells).to(torch.int32)
    key = torch.zeros(coords.shape[:-1], dtype=torch.int32, device=coords.device)
    for i in range(bits):
        key = (
            key
            | (((cell[..., 0] >> i) & 1) << (3 * i + 2))
            | (((cell[..., 1] >> i) & 1) << (3 * i + 1))
            | (((cell[..., 2] >> i) & 1) << (3 * i))
        )
    if mask is not None:
        key = torch.where(mask, key, torch.full((), 1 << 30, dtype=torch.int32, device=key.device))
    return key


def _take_atoms(order, coords, weights, radii, mask):
    """(B, Vp, ...) arrays in ``order`` along the atom axis; radii only when
    per atom (B, Vp), mask only when given."""
    coords = torch.take_along_dim(coords, order[..., None], dim=1)
    weights = torch.take_along_dim(weights, order[..., None], dim=1)
    if radii is not None and radii.ndim == 2:
        radii = torch.take_along_dim(radii, order, dim=1)
    if mask is not None:
        mask = torch.take_along_dim(mask, order, dim=1)
    return coords, weights, radii, mask


def _channel_tile(c: int, run: int) -> int:
    """Channels a forward block computes: the smallest of 1, 2, 4, 8 that
    holds ``c``, at most what the accumulator budget allows at this run."""
    cap = min(8, ACC_MAX // run)
    return next((k for k in (1, 2, 4, 8) if k >= c and k <= cap), cap)


def brick_rows(b: int, c: int, dl: int, dim: int) -> tuple[int, int]:
    """(dt, ht): the depth planes and whole h rows of a forward block.

    The largest brick that one block's threads cover in the passes their
    accumulators allow, for every output dtype, halved until the launch
    has ``TARGET_BLOCKS`` blocks, or until half of it would hold fewer than
    ``MIN_LANES`` runs of f32.  More blocks shorten each block's serial walk
    over its atom chunks (what sets a protein's time); a brick of a few
    runs leaves its warp idle.  Depends on the shapes only, so the plane
    ranges (``plane_ranges`` at ``ht``) are the same whatever the output
    dtype.  The threshold-row kernel reads these ranges too."""
    cap = None
    for run in (STORE_BYTES // 4, STORE_BYTES // 2, STORE_BYTES):
        nrun = -(-dim // run)
        fits = (BRICK_THREADS // nrun) * (ACC_MAX // (run * _channel_tile(c, run)))
        cap = fits if cap is None else min(cap, fits)
    nct = -(-c // _channel_tile(c, STORE_BYTES // 4))
    rows = max(cap, 1)
    while True:
        ht = min(dim, rows)
        dt = min(dl, rows // ht)
        if b * nct * -(-dl // dt) * -(-dim // ht) >= TARGET_BLOCKS or (rows // 2) * -(-dim // 4) < MIN_LANES:
            return dt, ht
        rows //= 2


class Brick(NamedTuple):
    """A forward launch: dt planes x ht rows x all W columns of kct channels
    a block, ``threads`` a block, each thread owning ``passes`` runs of
    ``run`` consecutive w."""

    dt: int
    ht: int
    kct: int
    run: int
    threads: int
    passes: int


def brick(b: int, c: int, dl: int, dim: int, out_dtype=torch.float32) -> Brick:
    """The forward kernel's launch for these shapes (see ``brick_rows``)."""
    dt, ht = brick_rows(b, c, dl, dim)
    run = STORE_BYTES // out_torch_dtype(out_dtype).itemsize
    kct = _channel_tile(c, run)
    units = dt * ht * -(-dim // run)
    threads = min(BRICK_THREADS, round_up(units, 32))
    passes = -(-units // threads)
    if passes * run * kct > ACC_MAX:
        raise ValueError(f"a {dim}-wide grid row exceeds the forward kernel's accumulators")
    return Brick(dt, ht, kct, run, threads, passes)


def notrunc_tiles(vp: int) -> bool:
    """Whether threshold rows of molecules of ``vp`` padded atoms take the
    threshold-row launch: molecules of more than one chunk (proteins,
    complexes).  A single chunk (ligand batches) keeps the brick launch,
    whose slab test already sees only that chunk."""
    return vp > CHUNK


class NotruncBrick(NamedTuple):
    """A threshold-row forward launch: blocks of bd x bh x bw warps, each
    warp a sub-brick of ``NOTRUNC_SIDE`` planes x ``NOTRUNC_SIDE`` rows x
    ``cols`` columns (each lane 4 x 4 x 2 lanes: a row's ``cols`` / 2
    consecutive w), kct channels."""

    bd: int
    bh: int
    bw: int
    kct: int
    cols: int
    threads: int


def notrunc_brick(b: int, c: int, dl: int, dim: int, out_dtype=torch.float32) -> NotruncBrick:
    """The threshold-row forward launch for these shapes: the first block of
    ``NOTRUNC_BLOCK_WARPS`` (4, 2 or 1 warps) that gives the launch
    ``NOTRUNC_TARGET_BLOCKS`` blocks, else the last; channel groups of 1, 2
    or 4 (1 or 2 for fp8), within the accumulators."""
    out_dtype = out_torch_dtype(out_dtype)
    lane_w = 16 if out_dtype.itemsize == 1 else 8
    cols = 2 * lane_w
    cap = ACC_MAX // lane_w
    kct = 1 if c == 1 else 2 if c == 2 or cap == 2 else 4
    groups = b * -(-c // kct)
    for bd, bh, bw in NOTRUNC_BLOCK_WARPS:
        blocks = groups * -(-dl // (NOTRUNC_SIDE * bd)) * -(-dim // (NOTRUNC_SIDE * bh)) * -(-dim // (cols * bw))
        if blocks >= NOTRUNC_TARGET_BLOCKS:
            break
    return NotruncBrick(bd, bh, bw, kct, cols, 32 * bd * bh * bw)


def notrunc_smem(p: NotruncBrick) -> int:
    """Dynamic shared memory of a threshold-row block (deposit_fwd.cu's
    notrunc_smem_bytes): each warp's list of ``NOTRUNC_WARP_CAP`` atoms
    (x, y, z, r2; tables; coef; weights), and the block's kept list of a
    chunk a warp."""
    warps = p.threads // 32
    per = 2 * NOTRUNC_SIDE + p.cols
    return 4 * (warps * NOTRUNC_WARP_CAP * (4 + per + 1 + p.kct) + (5 + p.kct) * warps * CHUNK)


def plane_ranges(coords_shifted: torch.Tensor, r2: torch.Tensor, spec: GridSpec, dl: int, ht: int) -> torch.Tensor:
    """(B, nht, nvc, 2) int32 [d_lo, d_hi) depth planes each (row tile, atom
    chunk) pair can reach, in closed form, at the kernel's bricks.

    Tile ``t`` covers h rows [t*ht, (t+1)*ht) and every column.  An atom's
    minimum squared yz distance to the tile is its distance to that box (a
    lower bound on every voxel's); the planes it reaches solve
    |x - d*res + w/2| <= sqrt(r^2 - min).  A few ulps of slack make the
    interval only ever wider.  ``coords_shifted`` has x pre-shifted by
    d_offset*res; ``r2`` is (B, Vp) with masked atoms at 1.  This is
    _plane_ranges_closed of the JAX package with hrows = ht and a = CHUNK,
    for every dim: the last tile's box runs past the grid as the JAX one
    does, which only widens its ranges.
    """
    b, vp, _ = coords_shifted.shape
    dev = coords_shifted.device
    nht = -(-spec.dimension // ht)
    res = float(spec.resolution)
    lb = float(spec.lower_bound)
    ub = float(spec.upper_bound)
    h_lo = lb + (torch.arange(nht, device=dev) * ht).to(torch.float32) * res
    h_hi = h_lo + float((ht - 1) * res)
    x = coords_shifted[..., 0]
    y = coords_shifted[..., 1]
    z = coords_shifted[..., 2]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dy = torch.maximum(torch.maximum(h_lo[None, :, None] - y[:, None, :], y[:, None, :] - h_hi[None, :, None]), zero)
    dz = torch.maximum(torch.maximum(lb - z, z - ub), zero)
    min_dyz2 = dy * dy + (dz * dz)[:, None, :]
    s2 = r2[:, None, :] - min_dyz2
    s = torch.sqrt(torch.maximum(s2, zero)) * 1.000002 + 1e-6
    lo = torch.ceil((x[:, None, :] - s - lb) / res)
    hi = torch.floor((x[:, None, :] + s - lb) / res) + 1.0
    lo = torch.clamp(lo, 0.0, float(dl))
    hi = torch.clamp(hi, 0.0, float(dl))
    empty = s2 < 0.0
    lo = torch.where(empty, float(dl), lo).to(torch.int32)
    hi = torch.where(empty, 0.0, hi).to(torch.int32)
    nvc = vp // CHUNK
    lo = lo.reshape(b, nht, nvc, CHUNK).amin(dim=3)
    hi = hi.reshape(b, nht, nvc, CHUNK).amax(dim=3)
    hi = torch.maximum(hi, lo)  # all-empty chunks become d_hi == d_lo
    return torch.stack([lo, hi], dim=-1).contiguous()


def prepare_deposit(coords, weights, radii, mask, spec: GridSpec, gaussian: bool, sigma: float,
                    d_offset=0, d_count: int | None = None, notrunc: bool = False):
    """Kernel inputs from padded (B, Vp, 3) / (B, Vp, C) / (B, Vp) arrays with
    Vp a multiple of CHUNK: atom rows (B, 8, Vp), weights (B, C, Vp),
    ranges (B, nht, nvc, 2) at the bricks' ht rows, and the local depth Dl.
    Torch ops only, so autograd carries gradients of the rows and weights
    back to the inputs; masked atoms get zero weight here, hence zero
    gradients."""
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    res = float(spec.resolution)
    wt = weights.to(torch.float32).transpose(1, 2)
    r2 = radii * radii
    if mask is not None:
        wt = torch.where(mask[:, None, :], wt, torch.zeros((), dtype=torch.float32, device=wt.device))
        r2 = torch.where(mask, r2, torch.ones((), dtype=torch.float32, device=r2.device))
    r2_th = notrunc_r2_thresh(r2, sigma) if notrunc else r2
    # the slab's shift as a float32 product, passed as a Python scalar (no
    # host-to-device copy, so no stream sync)
    xs = coords[..., 0] - float(np.float32(d_offset) * np.float32(res))
    zero = torch.zeros_like(r2)
    coef = (-(0.5 / (sigma * sigma))) / r2 if gaussian else zero
    rows = torch.stack([xs, coords[..., 1], coords[..., 2], r2_th, coef, zero, zero, zero], dim=1).contiguous()
    ht = brick_rows(rows.shape[0], wt.shape[1], dl, dim)[1]
    ranges = plane_ranges(rows[:, :3].detach().transpose(1, 2), r2_th.detach(), spec, dl, ht)
    return rows, wt.contiguous(), ranges, dl


class Transforms(NamedTuple):
    """A batch's rigid transforms as one (B, 12) table: each row holds its
    rotation matrix R row-major, then its translation t (a missing part is
    zero and its flag False).  The kernel applies R p + t as ``rotate`` and
    ``apply_transforms`` do."""

    table: torch.Tensor | None
    rot: bool
    trans: bool


def transform_table(transforms, device) -> Transforms:
    """(quaternions (B, 4) or None, translations (B, 3) or None) -> a
    ``Transforms`` on ``device`` (a ``Transforms`` passes through).  R is
    ``quaternion_to_matrix`` on the quaternions' device, so the table is
    differentiable in both.  A table built on the host reaches the card as
    one copy from pinned memory that does not block the host (a pageable
    copy would wait for the work queued before it); one that carries a
    gradient is copied as it is."""
    if isinstance(transforms, Transforms):
        return transforms
    q, t = (None, None) if transforms is None else transforms
    if q is None and t is None:
        return Transforms(None, False, False)
    ref = q if q is not None else t
    b = ref.shape[0]
    rot = quaternion_to_matrix(q).reshape(b, 9) if q is not None else ref.new_zeros((b, 9))
    table = torch.cat([rot, t if t is not None else ref.new_zeros((b, 3))], dim=1)
    device = torch.device(device)
    if table.device != device:
        if device.type == "cuda" and table.device.type == "cpu" and not table.requires_grad:
            table = table.pin_memory().to(device, non_blocking=True)
        else:
            table = table.to(device)
    return Transforms(table, q is not None, t is not None)


def apply_table(coords: torch.Tensor, transforms: Transforms) -> torch.Tensor:
    """Rotate (about the origin) then translate each molecule of (B, V, 3)
    coords by its row of the table."""
    if transforms.rot:
        coords = rotate(coords, transforms.table[:, :9].reshape(-1, 3, 3))
    if transforms.trans:
        coords = coords + transforms.table[:, None, 9:12].to(coords.dtype)
    return coords


class PrepPlan(NamedTuple):
    """What a preparation computes, beside its tensors.

    ``sort``: Morton-sort the atoms (when they fill more than one chunk);
    False for input already in Morton order.  ``channelwise``: radii are
    per channel (C,), each atom becomes C virtual atoms, and the sort keys
    come from the transformed coordinates (that batch path's order); other
    batches sort by the centered ones, before the transform."""

    spec: GridSpec
    gaussian: bool
    sigma: float
    notrunc: bool = False
    d_offset: int = 0
    d_count: int | None = None
    sort: bool = True
    channelwise: bool = False


class Prepared(NamedTuple):
    """A preparation's outputs: atom rows (B, 8, Vo), masked weights (B, C,
    Vo), plane ranges (B, nht, Vo / 64, 2) int32 at the bricks' ht, the
    permutation (B, Vp) int32 (sorted atom i is padded input atom perm[i])
    and the local depth Dl.  Vo is Vp, or C * Vp for channel-wise radii."""

    rows: torch.Tensor
    weights: torch.Tensor
    ranges: torch.Tensor
    perm: torch.Tensor
    dl: int


def prepare_plain(coords, weights, radii, mask, centers, transforms: Transforms, plan: PrepPlan) -> Prepared:
    """The preparation kernel's function in torch tensor ops.

    coords (B, V, 3), weights (B, V, C), radii (V,) or (B, V) per atom or
    (C,) per channel (``plan.channelwise``), mask (B, V) bool or None,
    centers (B, 3) or None.  Center, transform, pad, Morton-sort, expand
    the channel-wise virtual atoms, then ``prepare_deposit``; each step is
    the function the kernel repeats bit for bit.  Differentiable through
    autograd (the sort's order is not)."""
    b, v, _ = coords.shape
    coords = coords.to(torch.float32)
    if centers is not None:
        coords = coords - centers[:, None, :].to(coords.dtype)
    placed = apply_table(coords, transforms)
    keyed = placed if plan.channelwise else coords
    coords = placed
    r_atoms = None if plan.channelwise else radii if radii.ndim == 2 else radii[None].expand(b, -1)
    coords, weights, r_atoms, mask = _pad_atoms(coords, weights.to(torch.float32), r_atoms, mask)
    vp = coords.shape[1]
    if plan.sort and vp > CHUNK:
        keyed = torch.nn.functional.pad(keyed, (0, 0, 0, vp - v), value=FAR)
        order = torch.argsort(morton_keys(keyed, plan.spec, mask), dim=1, stable=True)
        coords, weights, r_atoms, mask = _take_atoms(order, coords, weights, r_atoms, mask)
    else:
        order = torch.arange(vp, device=coords.device).expand(b, vp)
    if plan.channelwise:
        coords, weights, r_atoms, mask = expand_channelwise(coords, weights, radii, mask)
        r_atoms = r_atoms[None].expand(b, -1)
    rows, wt, ranges, dl = prepare_deposit(coords, weights, r_atoms, mask, plan.spec, plan.gaussian, plan.sigma,
                                           plan.d_offset, plan.d_count, notrunc=plan.notrunc)
    return Prepared(rows, wt, ranges, order.to(torch.int32), dl)


# ------------------------------------------------------- kernel and plain


def deposit_plain(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
                  gaussian: bool, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in torch tensor ops -> (B, C, Dl, H*W).

    Same inputs as the kernel; the plane ranges are applied (a voxel of row
    tile t gets chunk vc only on planes [d_lo, d_hi)), so a range that drops
    a reachable plane shows up here too.  Accumulates in f32, casts once."""
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    hw = dim * dim
    dev = rows.device
    nvc = ranges.shape[2]
    chunk = vp // nvc
    ht = brick_rows(b, c, dl, dim)[1]
    if ranges.shape[1] != -(-dim // ht):
        raise ValueError(f"ranges must have one row per tile of {ht} h rows, got {tuple(ranges.shape)}")
    res = torch.tensor(spec.resolution, dtype=torch.float32, device=dev)
    half = torch.tensor(spec.width / 2.0, dtype=torch.float32, device=dev)
    pd = torch.arange(dl, device=dev).to(torch.float32) * res - half
    ph = torch.arange(dim, device=dev).to(torch.float32) * res - half
    tile_of = (torch.arange(hw, device=dev) // dim) // ht
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.zeros((b, c, dl, hw), dtype=torch.float32, device=dev)
    bounds = torch.stack([ranges[..., 0].amin(dim=1), ranges[..., 1].amax(dim=1)], dim=-1).cpu()  # (B, nvc, 2)
    slab = max(1, _PLAIN_BUDGET // (hw * chunk))
    for bi in range(b):
        for vc in range(nvc):
            dlo, dhi = int(bounds[bi, vc, 0]), int(bounds[bi, vc, 1])
            if dhi <= dlo:
                continue
            sl = slice(vc * chunk, (vc + 1) * chunk)
            x, y, z, r2, coef = rows[bi, 0, sl], rows[bi, 1, sl], rows[bi, 2, sl], rows[bi, 3, sl], rows[bi, 4, sl]
            w = weights[bi, :, sl]
            dy = ph[:, None] - y[None, :]
            dz = ph[:, None] - z[None, :]
            dy2, dz2 = dy * dy, dz * dz
            dyz2 = (dy2[:, None, :] + dz2[None, :, :]).reshape(hw, chunk)
            if gaussian:
                eyz = (torch.exp(dy2 * coef)[:, None, :] * torch.exp(dz2 * coef)[None, :, :]).reshape(hw, chunk)
            lo_hw = ranges[bi, :, vc, 0][tile_of]
            hi_hw = ranges[bi, :, vc, 1][tile_of]
            for d0 in range(dlo, dhi, slab):
                d1 = min(d0 + slab, dhi)
                dx = pd[d0:d1, None] - x[None, :]
                dx2 = dx * dx
                th = r2[None, :] - dx2
                planes = torch.arange(d0, d1, device=dev)[:, None]
                active = (planes >= lo_hw[None, :]) & (planes < hi_hw[None, :])  # (S, H*W)
                cut = (dyz2[None] <= th[:, None, :]) & active[:, :, None]  # (S, H*W, A)
                if gaussian:
                    dens = torch.where(cut, eyz[None], zero)
                    m = w[None] * torch.exp(dx2 * coef)[:, None, :]  # (S, C, A)
                else:
                    dens = cut.to(torch.float32)
                    m = w[None].expand(d1 - d0, c, chunk)
                out[bi, :, d0:d1] += torch.bmm(m, dens.transpose(1, 2)).transpose(0, 1)
    return out.to(out_dtype)


def deposit_bwd_plain(rows: torch.Tensor, weights: torch.Tensor, ct: torch.Tensor, *, spec: GridSpec, dl: int,
                      gaussian: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in torch tensor ops: the VJP of
    ``deposit_plain`` at cotangent ``ct`` (B, C, Dl, H*W) of any float dtype
    -> (grad_rows (B, 8, Vp), grad_weights (B, C, Vp)), both f32.

    With f = exp(coef * d^2) inside the cutoff (binary: 1) and
    Q = sum_c ct[c] * w[c] at each voxel:

      grad_weights[c] = sum_vox ct[c] * f
      grad_rows[0:3]  = 2 coef * sum_vox Q f (x - g)     (dL/dx, dL/dy, dL/dz)
      grad_rows[4]    = sum_vox Q f d^2                   (dL/dcoef)

    Rows 3 and 5-7 are zero: the cutoff's boundary term is dropped (the
    almost-everywhere gradient), and binary density has only grad_weights.
    Each atom's difference (x - g) is taken per voxel; no moment sums about
    the grid origin.  Chunked over 64-atom chunks and depth slabs; a chunk
    visits only the planes its atoms' cutoff spheres can reach."""
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    hw = dim * dim
    dev = rows.device
    ct = ct.reshape(b, c, dl, hw).to(torch.float32)
    res = torch.tensor(spec.resolution, dtype=torch.float32, device=dev)
    half = torch.tensor(spec.width / 2.0, dtype=torch.float32, device=dev)
    pd = torch.arange(dl, device=dev).to(torch.float32) * res - half
    ph = torch.arange(dim, device=dev).to(torch.float32) * res - half
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grad_rows = torch.zeros((b, 8, vp), dtype=torch.float32, device=dev)
    grad_w = torch.zeros((b, c, vp), dtype=torch.float32, device=dev)
    # planes each chunk can reach, widened by a plane on each side; the exact
    # cutoff below decides
    nvc = -(-vp // CHUNK)
    reach = torch.sqrt(torch.clamp(rows[:, 3], min=0.0)) * 1.0001 + 1e-4
    lo = torch.floor((rows[:, 0] - reach + half) / res) - 1.0
    hi = torch.floor((rows[:, 0] + reach + half) / res) + 2.0
    pad = nvc * CHUNK - vp
    lo = torch.nn.functional.pad(lo, (0, pad), value=float(dl)).clamp(0, dl).reshape(b, nvc, CHUNK).amin(dim=2)
    hi = torch.nn.functional.pad(hi, (0, pad), value=0.0).clamp(0, dl).reshape(b, nvc, CHUNK).amax(dim=2)
    bounds = torch.stack([lo, hi], dim=-1).to(torch.int64).cpu()
    slab = max(1, _PLAIN_BUDGET // (4 * hw * CHUNK))
    for bi in range(b):
        for vc in range(nvc):
            dlo, dhi = int(bounds[bi, vc, 0]), int(bounds[bi, vc, 1])
            if dhi <= dlo:
                continue
            sl = slice(vc * CHUNK, min((vc + 1) * CHUNK, vp))
            x, y, z, th, coef = (rows[bi, k, sl] for k in range(5))
            a = x.shape[0]
            w = weights[bi, :, sl]
            dy = ph[:, None] - y[None, :]
            dz = ph[:, None] - z[None, :]
            dy2, dz2 = dy * dy, dz * dz
            dyz2 = (dy2[:, None, :] + dz2[None, :, :]).reshape(hw, a)
            if gaussian:
                eyz = (torch.exp(dy2 * coef)[:, None, :] * torch.exp(dz2 * coef)[None, :, :]).reshape(hw, a)
                t_hw = torch.zeros((hw, a), dtype=torch.float32, device=dev)  # sum over planes of Q*f
                sx = torch.zeros((a,), dtype=torch.float32, device=dev)
                sd = torch.zeros((a,), dtype=torch.float32, device=dev)
            gw = torch.zeros((c, a), dtype=torch.float32, device=dev)
            for d0 in range(dlo, dhi, slab):
                d1 = min(d0 + slab, dhi)
                dx = pd[d0:d1, None] - x[None, :]
                dx2 = dx * dx
                cut = dyz2[None] <= (th[None, :] - dx2)[:, None, :]  # (S, H*W, A)
                g = ct[bi, :, d0:d1].reshape(c, -1)  # (C, S*H*W)
                if gaussian:
                    f = torch.where(cut, eyz[None] * torch.exp(dx2 * coef)[:, None, :], zero)
                else:
                    f = cut.to(torch.float32)
                gw += g @ f.reshape(-1, a)
                if gaussian:
                    t = f * (g.t() @ w).reshape(d1 - d0, hw, a)
                    t_plane = t.sum(dim=1)
                    sx -= (t_plane * dx).sum(dim=0)
                    sd += (t_plane * dx2).sum(dim=0)
                    t_hw += t.sum(dim=0)
            grad_w[bi, :, sl] = gw
            if gaussian:
                sy = -(t_hw.reshape(dim, dim, a) * dy[:, None, :]).sum(dim=(0, 1))
                sz = -(t_hw.reshape(dim, dim, a) * dz[None, :, :]).sum(dim=(0, 1))
                sd += (t_hw * dyz2).sum(dim=0)
                grad_rows[bi, 0, sl] = 2.0 * coef * sx
                grad_rows[bi, 1, sl] = 2.0 * coef * sy
                grad_rows[bi, 2, sl] = 2.0 * coef * sz
                grad_rows[bi, 4, sl] = sd
    return grad_rows, grad_w


def _kernel_lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_molvoxel_typed", False):
        if name == "deposit_fwd":
            lib.deposit_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
                [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.deposit_fwd.restype = ctypes.c_int
            lib.deposit_fwd_blocks.argtypes = [ctypes.c_int] * 12 + [ctypes.POINTER(ctypes.c_longlong),
                                                                      ctypes.POINTER(ctypes.c_int)]
            lib.deposit_fwd_blocks.restype = ctypes.c_int
            consts = (lib.deposit_fwd_chunk, lib.deposit_fwd_max_threads, lib.deposit_fwd_acc_max,
                      lib.deposit_fwd_store_bytes)
            for fn in consts:
                fn.argtypes = []
                fn.restype = ctypes.c_int
            lib.deposit_fwd_notrunc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
                [ctypes.c_float] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            lib.deposit_fwd_notrunc.restype = ctypes.c_int
            lib.deposit_fwd_notrunc_blocks.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_longlong),
                                                                              ctypes.POINTER(ctypes.c_int)]
            lib.deposit_fwd_notrunc_blocks.restype = ctypes.c_int
            consts += (lib.deposit_fwd_notrunc_side, lib.deposit_fwd_notrunc_warp_cap)
            for fn in consts:
                fn.argtypes = []
                fn.restype = ctypes.c_int
            if tuple(fn() for fn in consts) != (CHUNK, BRICK_THREADS, ACC_MAX, STORE_BYTES, NOTRUNC_SIDE,
                                                NOTRUNC_WARP_CAP):
                raise RuntimeError("deposit_fwd.cu bricks disagree with molvoxel_torch/ops/deposit.py")
        elif name == "deposit_prep":
            lib.deposit_prep.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 20 + [ctypes.c_float] * 9 + \
                [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.deposit_prep.restype = ctypes.c_int
            consts = (lib.deposit_prep_chunk, lib.deposit_prep_max_threads, lib.deposit_prep_items,
                      lib.deposit_prep_stage, lib.deposit_prep_search_share)
            for fn in consts + (lib.deposit_prep_setup,):
                fn.argtypes = []
                fn.restype = ctypes.c_int
            if tuple(fn() for fn in consts) != (CHUNK, PREP_MAX_THREADS, PREP_ITEMS, PREP_STAGE, PREP_SEARCH_SHARE):
                raise RuntimeError("deposit_prep.cu constants disagree with molvoxel_torch/ops/deposit.py")
        else:
            lib.deposit_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
                [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.deposit_bwd.restype = ctypes.c_int
            lib.deposit_bwd_blocks.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                                                     ctypes.POINTER(ctypes.c_int)]
            lib.deposit_bwd_blocks.restype = ctypes.c_int
            lib.deposit_bwd_notrunc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
                [ctypes.c_int] * 2 + [ctypes.c_void_p]
            lib.deposit_bwd_notrunc.restype = ctypes.c_int
            lib.deposit_bwd_notrunc_blocks.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                                                             ctypes.POINTER(ctypes.c_int)]
            lib.deposit_bwd_notrunc_blocks.restype = ctypes.c_int
            consts = (lib.deposit_bwd_threads, lib.deposit_bwd_notrunc_group)
            for fn in consts:
                fn.argtypes = []
                fn.restype = ctypes.c_int
            if tuple(fn() for fn in consts) != (BWD_THREADS, BWD_NOTRUNC_GROUP):
                raise RuntimeError("deposit_bwd.cu blocks disagree with molvoxel_torch/ops/deposit.py")
        lib._molvoxel_typed = True
    return lib


def _check_kernel_inputs(fn: str, rows, weights):
    """Shape, dtype, device and layout checks shared by both kernel wrappers."""
    if rows.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU tensors, got {rows.device}")
    b, eight, vp = rows.shape
    if eight != 8 or vp % CHUNK:
        raise ValueError(f"atom rows must be (B, 8, Vp) with Vp a multiple of {CHUNK}, got {tuple(rows.shape)}")
    if weights.ndim != 3 or weights.shape[0] != b or weights.shape[2] != vp:
        raise ValueError(f"weights must be (B={b}, C, Vp={vp}), got {tuple(weights.shape)}")
    for name, t in (("rows", rows), ("weights", weights)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"{name} must be a contiguous torch.float32 tensor on {rows.device}")


def deposit_fwd(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
                gaussian: bool, out_dtype=torch.float32, notrunc: bool = False) -> torch.Tensor:
    """Deposit prepared atoms -> (B, C, Dl, H*W) of ``out_dtype``.

    CUDA tensors launch ``csrc/deposit_fwd.cu``: the brick kernel, or with
    ``notrunc`` (threshold rows, gaussian only) and molecules of more than
    one chunk the threshold-row kernel (``notrunc_brick``), which reads the
    same ranges.  CPU tensors run ``deposit_plain`` (the same function).
    Raises on anything the kernel does not take."""
    out_dtype = out_torch_dtype(out_dtype)
    if notrunc and not gaussian:
        raise ValueError("threshold rows (notrunc) are gaussian")
    if rows.device.type == "cpu":
        return _count_grid(deposit_plain(rows, weights, ranges, spec=spec, dl=dl, gaussian=gaussian,
                                         out_dtype=out_dtype))
    _check_kernel_inputs("deposit_fwd", rows, weights)
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    nht = -(-dim // brick_rows(b, c, dl, dim)[1])
    if tuple(ranges.shape) != (b, nht, vp // CHUNK, 2):
        raise ValueError(f"ranges must be {(b, nht, vp // CHUNK, 2)}, got {tuple(ranges.shape)}")
    if ranges.dtype != torch.int32 or not ranges.is_contiguous() or ranges.device != rows.device:
        raise ValueError(f"ranges must be a contiguous torch.int32 tensor on {rows.device}")
    out = torch.empty((b, c, dl, dim * dim), dtype=out_dtype, device=rows.device)
    entry, args = fwd_launch(b, vp, c, dl, spec, gaussian, out_dtype, notrunc)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = getattr(_kernel_lib("deposit_fwd"), entry)(
            rows.data_ptr(), weights.data_ptr(), ranges.data_ptr(), out.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"deposit_fwd kernel launch failed with cudaError {rc}")
    launches[entry] += 1
    return _count_grid(out)


def fwd_launch(b: int, vp: int, c: int, dl: int, spec: GridSpec, gaussian: bool, out_dtype=torch.float32,
               notrunc: bool = False) -> tuple[str, tuple]:
    """The forward wrapper's launch: the C entry point of deposit_fwd.cu
    and its arguments between the four tensors and the stream; the brick
    kernel's (``brick``) or, with ``notrunc`` and more than one chunk, the
    threshold-row kernel's (``notrunc_brick``)."""
    dim = spec.dimension
    kind = _OUT_KINDS[out_torch_dtype(out_dtype)]
    geometry = (b, vp, c, dl, dim, float(spec.resolution), float(spec.width / 2.0))
    if notrunc and notrunc_tiles(vp):
        p = notrunc_brick(b, c, dl, dim, out_dtype)
        hr = brick_rows(b, c, dl, dim)[1]  # the plane ranges' rows
        return "deposit_fwd_notrunc", geometry + (kind, p.kct, p.bd, p.bh, p.bw, hr)
    p = brick(b, c, dl, dim, out_dtype)
    return "deposit_fwd", geometry + (int(gaussian), kind, p.kct, p.threads, p.dt, p.ht, p.passes)


def fwd_launch_info(b: int, c: int, vp: int, dl: int, dim: int, gaussian: bool, out_dtype=torch.float32,
                    notrunc: bool = False) -> dict:
    """The forward launch for these shapes: its plan (``notrunc``: the
    threshold-row launch's where it takes it), its block count and how many
    blocks one SM of the current card holds at once (so blocks / (resident
    per SM x SMs) is the launch's waves).  Needs the card."""
    out_dtype = out_torch_dtype(out_dtype)
    blocks, resident = ctypes.c_longlong(0), ctypes.c_int(0)
    lib = _kernel_lib("deposit_fwd")
    if notrunc and notrunc_tiles(vp):
        plan = notrunc_brick(b, c, dl, dim, out_dtype)
        rc = lib.deposit_fwd_notrunc_blocks(
            b, vp, c, dl, dim, _OUT_KINDS[out_dtype], plan.kct, plan.bd, plan.bh, plan.bw,
            brick_rows(b, c, dl, dim)[1], ctypes.byref(blocks), ctypes.byref(resident))
    else:
        plan = brick(b, c, dl, dim, out_dtype)
        rc = lib.deposit_fwd_blocks(
            b, vp, c, dl, dim, int(gaussian), _OUT_KINDS[out_dtype], plan.kct, plan.threads, plan.dt, plan.ht,
            plan.passes, ctypes.byref(blocks), ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"deposit_fwd occupancy query failed with cudaError {rc}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return dict(plan._asdict(), blocks=blocks.value, resident_per_sm=resident.value,
                waves=blocks.value / max(resident.value * sms, 1))


def bwd_warps_per_atom(b: int, vp: int) -> int:
    """Warps the backward kernel gives each atom: 1, 2, 4 or 8 (a whole
    block), the fewest that give the launch ``BWD_TARGET_WARPS`` warps.  The
    warps of an atom split its rows.  A batch of thousands of atoms (the
    training batch, a protein) gets one warp an atom; a lone ligand, 8.
    Depends on the shapes only: the atoms' reach lives on the card, and
    reading it would stall the launch."""
    wpa = 1
    while wpa < BWD_THREADS // 32 and b * vp * wpa < BWD_TARGET_WARPS:
        wpa *= 2
    return wpa


def bwd_launch_info(b: int, c: int, vp: int, gaussian: bool, ct_dtype=torch.float32, notrunc: bool = False) -> dict:
    """The backward launch for these shapes (``notrunc``: the threshold-row
    kernel's): warps per atom, atoms per block, blocks, how many blocks one
    SM of the current card holds at once, and waves (blocks / (resident per
    SM x SMs)).  Needs the card."""
    wpa = bwd_warps_per_atom(b, vp)
    blocks, resident = ctypes.c_longlong(0), ctypes.c_int(0)
    lib = _kernel_lib("deposit_bwd")
    if notrunc:
        rc = lib.deposit_bwd_notrunc_blocks(b, vp, c, _CT_KINDS[ct_dtype], wpa, ctypes.byref(blocks),
                                            ctypes.byref(resident))
    else:
        rc = lib.deposit_bwd_blocks(b, vp, c, int(gaussian), _CT_KINDS[ct_dtype], wpa, ctypes.byref(blocks),
                                    ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"deposit_bwd occupancy query failed with cudaError {rc}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return dict(warps_per_atom=wpa, atoms_per_block=BWD_THREADS // 32 // wpa, blocks=blocks.value,
                resident_per_sm=resident.value, waves=blocks.value / max(resident.value * sms, 1))


def deposit_bwd(rows: torch.Tensor, weights: torch.Tensor, ct: torch.Tensor, *, spec: GridSpec, dl: int,
                gaussian: bool, notrunc: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of a deposit at cotangent ``ct`` (B, C, Dl, H*W) ->
    (grad_rows (B, 8, Vp), grad_weights (B, C, Vp)), f32; see
    ``deposit_bwd_plain`` for the function.

    CUDA tensors launch ``csrc/deposit_bwd.cu`` with
    ``bwd_warps_per_atom(B, Vp)`` warps an atom; it reads a float32 or a
    bfloat16 cotangent (an fp8 one is widened to bf16 first, exactly).
    With ``notrunc`` (threshold rows, gaussian only) the launch is the
    threshold-row kernel, which takes each row in groups of
    ``BWD_NOTRUNC_GROUP`` columns (``bwd_launch``: when W is a multiple of
    it and the cotangent is aligned for its vector loads).  CPU tensors run
    ``deposit_bwd_plain``.  Raises on anything the kernel does not take."""
    if notrunc and not gaussian:
        raise ValueError("threshold rows (notrunc) are gaussian")
    if rows.device.type == "cpu":
        return deposit_bwd_plain(rows, weights, ct, spec=spec, dl=dl, gaussian=gaussian)
    _check_kernel_inputs("deposit_bwd", rows, weights)
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    if ct.dtype == torch.float8_e4m3fn:
        ct = ct.to(torch.bfloat16)
    if ct.numel() != b * c * dl * dim * dim or ct.shape[:2] != (b, c):
        raise ValueError(f"cotangent must be (B={b}, C={c}, Dl={dl}, {dim}*{dim}), got {tuple(ct.shape)}")
    if ct.dtype not in _CT_KINDS or not ct.is_contiguous() or ct.device != rows.device:
        raise ValueError(f"cotangent must be a contiguous float32 or bfloat16 tensor on {rows.device}")
    grad_rows = torch.empty((b, 8, vp), dtype=torch.float32, device=rows.device)
    grad_w = torch.empty((b, c, vp), dtype=torch.float32, device=rows.device)
    aligned = ct.data_ptr() % (4 * ct.element_size()) == 0  # the threshold-row kernel's vector loads
    entry, args = bwd_launch(b, vp, c, dl, spec, gaussian, ct.dtype, notrunc and aligned)
    with torch.cuda.device(rows.device):
        rc = getattr(_kernel_lib("deposit_bwd"), entry)(
            rows.data_ptr(), weights.data_ptr(), ct.data_ptr(), grad_rows.data_ptr(), grad_w.data_ptr(), *args,
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deposit_bwd kernel launch failed with cudaError {rc}")
    launches[entry] += 1
    return grad_rows, grad_w


def bwd_launch(b: int, vp: int, c: int, dl: int, spec: GridSpec, gaussian: bool, ct_dtype=torch.float32,
               notrunc: bool = False) -> tuple[str, tuple]:
    """The backward wrapper's launch: the C entry point of deposit_bwd.cu
    and its arguments between the tensors and the stream; the atom walk's,
    or with ``notrunc`` and W a multiple of ``BWD_NOTRUNC_GROUP`` the
    threshold-row kernel's (the same arguments, without ``gaussian``).
    Other threshold rows keep the atom walk, which computes the same
    function."""
    geometry = (b, vp, c, dl, spec.dimension, float(spec.resolution), float(spec.width / 2.0))
    kind, wpa = _CT_KINDS[ct_dtype], bwd_warps_per_atom(b, vp)
    if notrunc and spec.dimension % BWD_NOTRUNC_GROUP == 0:
        return "deposit_bwd_notrunc", geometry + (kind, wpa)
    return "deposit_bwd", geometry + (int(gaussian), kind, wpa)


class PrepLaunch(NamedTuple):
    """A preparation launch: ``split`` blocks a molecule (one cluster when
    it sorts), ``cpb`` 64-atom output chunks a block; when sorting, each
    block sorts ``seg`` atoms and receives ``oseg`` sorted ranks (both 0
    without a sort); ``threads`` a block and ``smem`` bytes of dynamic
    shared memory a block."""

    split: int
    cpb: int
    seg: int
    oseg: int
    threads: int
    smem: int


def prep_smem(sort: bool, vp: int, seg: int, oseg: int, split: int, threads: int, cpb: int) -> int:
    """Dynamic shared memory of a preparation block (``smem_bytes`` in
    deposit_prep.cu): x, y, dz^2, r2 of up to ``PREP_STAGE`` output atoms;
    a block of a sorting cluster also its ``oseg``
    sorted words and, reused by the staged atoms, the sort's scratch: for
    shares of up to ``PREP_SEARCH_SHARE`` atoms every share (Vp), its own
    words and their ranks in the share and the molecule; above, its ``seg``
    words, every block's 256 digit counts, 256 offsets and 256 counts a
    warp."""
    chunks = min(cpb, PREP_STAGE // CHUNK)
    stage = chunks * CHUNK * 16
    if not sort:
        return stage
    if seg <= PREP_SEARCH_SHARE:
        return oseg * 4 + max((vp + 3 * seg) * 4, stage)
    return max(seg, oseg) * 4 + max((split + 1 + threads // 32) * 256 * 4, stage)


def prep_launch(b: int, vp: int, vo: int, nht: int, sort: bool, wide: int = 0) -> PrepLaunch:
    """The preparation's launch for B molecules of Vp padded atoms, Vo
    output atoms and ``nht`` row tiles.  A batch of fewer than
    ``PREP_TARGET_BLOCKS`` molecules shares each molecule's output chunks
    over blocks until the launch has at most about that many (one an SM of
    an H100 SXM).  A molecule that sorts is one cluster: at most 16 blocks
    where the card runs ``wide`` clusters of 16 at once and B is no more
    (else 8), and no more than give each ``PREP_MIN_SHARE`` atoms, but
    enough that each sorts at most ``PREP_ITEMS`` atoms a thread of the
    largest block.  Shares of up to ``PREP_SEARCH_SHARE`` atoms are ranked
    by search, larger ones by digits.  Each block receives the ranks of its
    own output atoms (channel-wise, those of its share).  Threads: one an output atom
    of the block, one for ``PREP_ITEMS`` sort words, or
    ``PREP_PAIR_THREADS`` for each (row tile, chunk) pair of its plane
    ranges, whichever is most; 128 (256 when sorting) to 1024."""
    nvc = vo // CHUNK
    want = min(nvc, max(1, PREP_TARGET_BLOCKS // b))
    if sort:
        cap = PREP_MAX_CLUSTER if b <= wide else 8
        split = max(min(want, cap, max(1, vp // PREP_MIN_SHARE)), -(-vp // (PREP_ITEMS * PREP_MAX_THREADS)))
        cpb = -(-nvc // split)
        seg = round_up(-(-vp // split), 32)
        oseg = cpb * CHUNK if vo == vp else seg
    else:
        cpb = -(-nvc // want)
        split, seg, oseg = -(-nvc // cpb), 0, 0
    need = max(cpb * CHUNK, -(-seg // PREP_ITEMS), nht * min(cpb, PREP_STAGE // CHUNK) * PREP_PAIR_THREADS)
    threads = min(PREP_MAX_THREADS, max(PREP_SORT_THREADS if sort else 128, round_up(need, 32)))
    return PrepLaunch(split, cpb, seg, oseg, threads, prep_smem(sort, vp, seg, oseg, split, threads, cpb))


_WIDE_CLUSTERS: dict[torch.device, int] = {}


def _prep_wide_clusters(lib, dev: torch.device) -> int:
    """How many 16-block clusters of the preparation ``dev`` runs at once (0:
    none), asked of the library once a device (``deposit_prep_setup``, which
    also readies the kernel there)."""
    got = _WIDE_CLUSTERS.get(dev)
    if got is None:
        with torch.cuda.device(dev):
            got = lib.deposit_prep_setup()
        if got < 0:
            raise RuntimeError(f"deposit_prep setup failed with cudaError {-got}")
        _WIDE_CLUSTERS[dev] = got
    return got


def _check_prep_inputs(coords, weights, radii, mask, centers, table, plan: PrepPlan):
    """Shape, dtype, device and layout checks of the preparation kernel."""
    dev = coords.device
    if dev.type != "cuda":
        raise ValueError(f"deposit_prep runs on CUDA or CPU tensors, got {dev}")
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coords must be (B, V, 3), got {tuple(coords.shape)}")
    b, v, _ = coords.shape
    if weights.ndim != 3 or tuple(weights.shape[:2]) != (b, v):
        raise ValueError(f"weights must be (B={b}, V={v}, C), got {tuple(weights.shape)}")
    want_r = [(weights.shape[2],)] if plan.channelwise else [(v,), (b, v)]
    if tuple(radii.shape) not in want_r:
        raise ValueError(f"radii must be one of {want_r}, got {tuple(radii.shape)}")
    if v > 65536:
        raise ValueError(f"deposit_prep takes at most 65536 atoms a molecule, got {v}")
    named = [("coords", coords, torch.float32), ("weights", weights, torch.float32), ("radii", radii, torch.float32)]
    if mask is not None:
        if tuple(mask.shape) != (b, v):
            raise ValueError(f"mask must be (B={b}, V={v}), got {tuple(mask.shape)}")
        named.append(("mask", mask, torch.bool))
    if centers is not None:
        if tuple(centers.shape) != (b, 3):
            raise ValueError(f"centers must be (B={b}, 3), got {tuple(centers.shape)}")
        named.append(("centers", centers, torch.float32))
    if table is not None:
        if tuple(table.shape) != (b, 12):
            raise ValueError(f"the transform table must be (B={b}, 12), got {tuple(table.shape)}")
        named.append(("transform table", table, torch.float32))
    for name, t, dtype in named:
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def deposit_prep(coords, weights, radii, mask, centers, transforms: Transforms, plan: PrepPlan) -> Prepared:
    """Prepare a deposit: the arguments and result of ``prepare_plain``.

    CUDA tensors launch ``csrc/deposit_prep.cu``'s preparation kernel once
    (counted as ``deposit_prep``), at every size up to 65,536 atoms a
    molecule: each molecule that sorts is one cluster of blocks
    (``prep_launch``).  CPU tensors run ``prepare_plain``.  Nothing here
    synchronises the host.  Raises on anything the kernel does not take."""
    if coords.device.type == "cpu":
        return _count_sort(prepare_plain(coords, weights, radii, mask, centers, transforms, plan), plan)
    table = None if transforms.table is None else transforms.table.to(torch.float32)
    _check_prep_inputs(coords, weights, radii, mask, centers, table, plan)
    b, v, _ = coords.shape
    c = weights.shape[2]
    spec = plan.spec
    dim = spec.dimension
    dev = coords.device
    vp = round_up(v, CHUNK)
    vo = c * vp if plan.channelwise else vp
    dl = dim if plan.d_count is None else plan.d_count
    ht = brick_rows(b, c, dl, dim)[1]
    nht = -(-dim // ht)
    sort = plan.sort and vp > CHUNK
    radii_mode = 2 if plan.channelwise else 1 if radii.ndim == 2 else 0
    lb, res = float(spec.lower_bound), float(spec.resolution)
    scale = ((1 << 5) - 1) / max(spec.width, 1e-6)  # morton_keys' scale
    lib = _kernel_lib("deposit_prep")
    launch = prep_launch(b, vp, vo, nht, sort, _prep_wide_clusters(lib, dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = torch.empty((b, 8, vo), dtype=torch.float32, device=dev)
    wt = torch.empty((b, c, vo), dtype=torch.float32, device=dev)
    ranges = torch.empty((b, nht, vo // CHUNK, 2), dtype=torch.int32, device=dev)
    perm = torch.empty((b, vp), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.deposit_prep(
            coords.data_ptr(), weights.data_ptr(), radii.data_ptr(), _ptr(mask), _ptr(centers), _ptr(table),
            rows.data_ptr(), wt.data_ptr(), ranges.data_ptr(), perm.data_ptr(),
            b, v, vp, c, vo, dl, dim, ht, nht, launch.split, launch.cpb, launch.seg, launch.oseg, radii_mode,
            int(transforms.rot), int(transforms.trans), int(sort), int(plan.channelwise), int(plan.gaussian),
            int(plan.notrunc), lb, float(spec.upper_bound), scale, res, float(np.float32(1.0) / np.float32(res)),
            float(np.float32(plan.d_offset) * np.float32(res)), float((ht - 1) * res),
            -(0.5 / (plan.sigma * plan.sigma)), notrunc_factor(plan.sigma), launch.threads, launch.smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"deposit_prep kernel launch failed with cudaError {rc}")
    launches["deposit_prep"] += 1
    return _count_sort(Prepared(rows, wt, ranges, perm, dl), plan)


# ------------------------------------------------------------- wrappers


def _pad_atoms(coords, weights, radii, mask):
    """Pad the atom axis to whole chunks with far-off, zero-weight atoms."""
    vp = coords.shape[1]
    vpad = round_up(vp, CHUNK) - vp
    if vpad:
        coords = torch.nn.functional.pad(coords, (0, 0, 0, vpad), value=FAR)
        weights = torch.nn.functional.pad(weights, (0, 0, 0, vpad))
        if radii is not None:
            radii = torch.nn.functional.pad(radii, (0, vpad), value=1.0)
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, vpad), value=False)
    return coords, weights, radii, mask


def prepare_batch(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian", sigma: float = 0.5,
                  mask=None, d_offset=0, d_count: int | None = None, presorted: bool = False, centers=None,
                  transforms=None, channelwise: bool = False):
    """Padded, sorted kernel inputs for a batch: (rows, weights, ranges, Dl,
    gaussian), exactly what voxelize_deposit_batch hands to the kernels,
    from one preparation (``ops.autodiff.prepare``: the kernel on CUDA
    tensors, ``prepare_plain`` on CPU ones).  ``centers`` (B, 3) are
    subtracted and ``transforms`` (``draw_transforms``' pair or a
    ``Transforms``) applied first; the Morton keys come from the centered
    coordinates, or with ``channelwise`` radii (C,) from the transformed
    ones (each caller's order of sort and transform)."""
    from .autodiff import prepare  # autodiff imports this module

    with span("molvoxel.prepare"):
        gaussian = check_density(density_type)
        check_kernel_dtype(coords.is_cuda, coords.dtype)
        dev = coords.device
        radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
        if radii.ndim == 0:
            radii = radii.expand(coords.shape[1])
        plan = PrepPlan(spec, gaussian, sigma, notrunc=density_type == "gaussian_notrunc", d_offset=d_offset,
                        d_count=d_count, sort=not presorted, channelwise=channelwise)
        rows, wt, ranges, dl = prepare(
            coords.to(torch.float32).contiguous(), weights.to(torch.float32).contiguous(), radii.contiguous(),
            None if mask is None else mask.contiguous(),
            None if centers is None else centers.to(device=dev, dtype=torch.float32).contiguous(),
            transform_table(transforms, dev), plan)
        return rows, wt, ranges, dl, gaussian


def voxelize_deposit_batch(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian",
                           sigma: float = 0.5, mask=None, d_offset=0, d_count: int | None = None,
                           out_dtype="float32", presorted: bool = False, centers=None,
                           transforms=None) -> torch.Tensor:
    """Batched deposit -> (B, C, Dl, H, W) with per-atom radii.

    coords (B, V, 3); weights (B, V, C); radii (V,) shared or (B, V); mask
    (B, V) bool or None.  ``centers`` (B, 3) and ``transforms`` place the
    atoms first (center, Morton sort, transform: ops.batch's order, so one
    sort serves every augmented sample).  ``presorted``: atoms already
    arrive in Morton order, so no sort.  Differentiable in coords, weights,
    radii, centers and the transforms' quaternions and translations: the
    preparation and forward kernels run forward, the backward kernel and
    the preparation's explicit VJP backward.
    Counterpart of voxelize_pallas_batch and its custom VJP
    (voxelize_pallas_bwd_batch)."""
    from .autodiff import deposit  # autodiff imports this module

    b, _, c = weights.shape
    rows, wt, ranges, dl, gaussian = prepare_batch(
        coords, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
        d_offset=d_offset, d_count=d_count, presorted=presorted, centers=centers, transforms=transforms,
    )
    out = deposit(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_torch_dtype(out_dtype),
                  notrunc=density_type == "gaussian_notrunc")
    return out.reshape(b, c, dl, spec.dimension, spec.dimension)


def expand_channelwise(coords, weights, radii, mask):
    """Channel-wise radii (C,) -> virtual atoms: atom v in channel c becomes
    atom c*Vp + v at the same position, with radius r_c and weight only in
    channel c.  Returns (coords (B, C*Vp, 3), weights (B, C*Vp, C),
    radii (C*Vp,), mask (B, C*Vp) or None)."""
    b, vp, c = weights.shape
    coords_x = coords.repeat(1, c, 1)
    radii_x = radii.repeat_interleave(vp)
    wx = torch.zeros((b, c * vp, c), dtype=weights.dtype, device=weights.device)
    for ci in range(c):
        wx[:, ci * vp:(ci + 1) * vp, ci] = weights[:, :, ci]
    mask_x = mask.repeat(1, c) if mask is not None else None
    return coords_x, wx, radii_x, mask_x


def voxelize_deposit_batch_channelwise(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian",
                                       sigma: float = 0.5, mask=None, d_offset=0, d_count: int | None = None,
                                       out_dtype="float32", presorted: bool = False, centers=None,
                                       transforms=None) -> torch.Tensor:
    """Batched deposit with channel-wise radii (C,) -> (B, C, Dl, H, W).

    The real atoms are centered, transformed and Morton-sorted (by their
    transformed coordinates) first, then expanded into virtual atoms
    (``expand_channelwise``), so each virtual chunk is single-channel and
    spatially local; one preparation does all of it.  Counterpart of
    voxelize_pallas_batch_channelwise."""
    from .autodiff import deposit  # autodiff imports this module

    b, _, c = weights.shape
    rows, wt, ranges, dl, gaussian = prepare_batch(
        coords, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
        d_offset=d_offset, d_count=d_count, presorted=presorted, centers=centers, transforms=transforms,
        channelwise=True,
    )
    out = deposit(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_torch_dtype(out_dtype),
                  notrunc=density_type == "gaussian_notrunc")
    return out.reshape(b, c, dl, spec.dimension, spec.dimension)


def voxelize_deposit(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian", sigma: float = 0.5,
                     mask=None, d_offset=0, d_count: int | None = None) -> torch.Tensor:
    """Single-molecule deposit -> (C, Dl, H, W); see voxelize_deposit_batch."""
    radii = torch.as_tensor(radii, dtype=torch.float32, device=coords.device)
    out = voxelize_deposit_batch(
        coords[None], weights[None], radii if radii.ndim == 1 else radii[None], spec=spec,
        density_type=density_type, sigma=sigma, mask=None if mask is None else mask[None],
        d_offset=d_offset, d_count=d_count,
    )
    return out[0]


def voxelize_deposit_channelwise(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian",
                                 sigma: float = 0.5, mask=None, d_offset=0, d_count: int | None = None):
    """Single-molecule channel-wise deposit -> (C, Dl, H, W)."""
    out = voxelize_deposit_batch_channelwise(
        coords[None], weights[None], radii, spec=spec, density_type=density_type, sigma=sigma,
        mask=None if mask is None else mask[None], d_offset=d_offset, d_count=d_count,
    )
    return out[0]

