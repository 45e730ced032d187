"""Deposit on the CUDA kernels ``csrc/deposit_fwd.cu`` and ``csrc/deposit_bwd.cu``, and their plain versions.

Counterpart of the forward and backward halves of
``molvoxel_tpu/ops/pallas_deposit.py``.  The torch side does the O(V)
bookkeeping:

- pad the atom axis to whole 64-atom chunks with far-off, zero-weight atoms;
- sort atoms along a Morton curve (``morton_keys``), so each chunk is
  spatially compact and its plane ranges are tight;
- build the per-atom rows [x - d_offset*res, y, z, r2_thresh, coef] (B, 8, Vp),
  where r2_thresh is r^2, or for gaussian_notrunc the radius beyond which
  the density is negligible (``notrunc_r2_thresh``), and coef comes from the
  true r^2;
- plan the kernel's bricks (``brick``): dt depth planes x ht whole h rows
  a block, chosen per grid; and the backward's warps per atom
  (``bwd_warps_per_atom``);
- compute, in closed form, the depth planes [d_lo, d_hi) that each
  (tile of ht rows, atom chunk) pair can reach (``plane_ranges``);
- expand channel-wise radii into virtual atoms (same position, radius r_c,
  weight only in channel c), so they run on the same kernel.

``deposit_fwd`` (rows, weights -> grid) and ``deposit_bwd`` (cotangent grid
-> gradients of rows and weights) launch their kernels on CUDA tensors and
run ``deposit_plain`` / ``deposit_bwd_plain`` (the same functions in torch
tensor ops) on CPU tensors.  Nothing on a CUDA tensor falls back to a plain
version: a failed build or launch raises.  The wrappers below go through
``ops.autodiff.deposit``, so they are differentiable in coordinates,
weights and radii.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import GridSpec, round_up
from . import _build

CHUNK = 64  # atoms per chunk (kChunk in deposit_fwd.cu)
BRICK_THREADS = 256  # threads of the largest forward block (kMaxThreads)
ACC_MAX = 32  # f32 accumulators a forward thread holds (kAccMax)
STORE_BYTES = 16  # bytes of output a forward thread stores at once (kStoreBytes)
TARGET_BLOCKS = 16 * 132  # bricks shrink until a launch has this many blocks: 16 per SM of an H100 SXM
MIN_LANES = 24  # ... or until a smaller brick would leave most of a warp idle (f32 runs)
BWD_THREADS = 256  # threads of a backward block (kThreads in deposit_bwd.cu): 8 warps
BWD_TARGET_WARPS = 16 * 132  # a backward launch spreads atoms over warps until it has this many: 16 per SM
FAR = 1e3  # coordinate of padding atoms: far outside any grid
_PLAIN_BUDGET = 1 << 26  # elements of deposit_plain's (planes, H*W, chunk) temporary

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_CT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# gaussian_notrunc pruning (a copy of the JAX package's, pallas_deposit.py:65-86):
# density contributions below NOTRUNC_EPS are dropped, which keeps the
# worst-case additive error (V * eps) under 4e-6 for 3.3k-atom proteins.
NOTRUNC_EPS = 1e-9
_F32_ZERO_LOG = 103.972  # -ln(2^-150): exp(-x) rounds to f32 +0.0 for x above this

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"deposit_fwd": 0, "deposit_bwd": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


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


def notrunc_r2_thresh(r2, sigma: float, eps: float = NOTRUNC_EPS):
    """Squared cutoff radius beyond which a no-cutoff gaussian is negligible.

    exp(-0.5 * d2 / (sigma^2 r^2)) <= eps  <=>  d2 >= 2 sigma^2 ln(1/eps) r2.
    eps=0.0 gives the f32 underflow radius (the density rounds to +0.0
    beyond it), i.e. bit-level notrunc."""
    log_inv = _F32_ZERO_LOG if eps <= 0.0 else min(math.log(1.0 / eps), _F32_ZERO_LOG)
    return r2 * (2.0 * sigma * sigma * log_inv)


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


def sort_atoms_spatially(coords, weights, radii, mask, spec: GridSpec):
    """Reorder atoms (B, Vp, ...) along a Morton curve (stable).  Deposition
    is permutation-invariant; the order only makes the chunks compact."""
    order = torch.argsort(morton_keys(coords, spec, mask), dim=1, stable=True)
    coords = torch.take_along_dim(coords, order[..., None], dim=1)
    weights = torch.take_along_dim(weights, order[..., None], dim=1)
    if radii.ndim == 2:
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
    dtype."""
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
            if tuple(fn() for fn in consts) != (CHUNK, BRICK_THREADS, ACC_MAX, STORE_BYTES):
                raise RuntimeError("deposit_fwd.cu bricks disagree with molvoxel_torch/ops/deposit.py")
        else:
            lib.deposit_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
                [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.deposit_bwd.restype = ctypes.c_int
            lib.deposit_bwd_blocks.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong),
                                                                     ctypes.POINTER(ctypes.c_int)]
            lib.deposit_bwd_blocks.restype = ctypes.c_int
            lib.deposit_bwd_threads.argtypes = []
            lib.deposit_bwd_threads.restype = ctypes.c_int
            if lib.deposit_bwd_threads() != BWD_THREADS:
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
                gaussian: bool, out_dtype=torch.float32) -> torch.Tensor:
    """Deposit prepared atoms -> (B, C, Dl, H*W) of ``out_dtype``.

    CUDA tensors launch ``csrc/deposit_fwd.cu``; CPU tensors run
    ``deposit_plain``.  Raises on anything the kernel does not take."""
    out_dtype = out_torch_dtype(out_dtype)
    if rows.device.type == "cpu":
        return deposit_plain(rows, weights, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_dtype)
    _check_kernel_inputs("deposit_fwd", rows, weights)
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    plan = brick(b, c, dl, dim, out_dtype)
    nht = -(-dim // plan.ht)
    if tuple(ranges.shape) != (b, nht, vp // CHUNK, 2):
        raise ValueError(f"ranges must be {(b, nht, vp // CHUNK, 2)}, got {tuple(ranges.shape)}")
    if ranges.dtype != torch.int32 or not ranges.is_contiguous() or ranges.device != rows.device:
        raise ValueError(f"ranges must be a contiguous torch.int32 tensor on {rows.device}")
    out = torch.empty((b, c, dl, dim * dim), dtype=out_dtype, device=rows.device)
    lib = _kernel_lib("deposit_fwd")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = lib.deposit_fwd(
            rows.data_ptr(), weights.data_ptr(), ranges.data_ptr(), out.data_ptr(),
            b, vp, c, dl, dim, float(spec.resolution), float(spec.width / 2.0),
            int(gaussian), _OUT_KINDS[out_dtype], plan.kct, plan.threads, plan.dt, plan.ht, plan.passes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"deposit_fwd kernel launch failed with cudaError {rc}")
    launches["deposit_fwd"] += 1
    return out


def fwd_launch_info(b: int, c: int, vp: int, dl: int, dim: int, gaussian: bool, out_dtype=torch.float32) -> dict:
    """The forward launch for these shapes: its brick, its block count and
    how many blocks one SM of the current card holds at once (so blocks /
    (resident per SM x SMs) is the launch's waves).  Needs the card."""
    out_dtype = out_torch_dtype(out_dtype)
    plan = brick(b, c, dl, dim, out_dtype)
    blocks, resident = ctypes.c_longlong(0), ctypes.c_int(0)
    rc = _kernel_lib("deposit_fwd").deposit_fwd_blocks(
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


def bwd_launch_info(b: int, c: int, vp: int, gaussian: bool, ct_dtype=torch.float32) -> dict:
    """The backward launch for these shapes: warps per atom, atoms per
    block, blocks, how many blocks one SM of the current card holds at once,
    and waves (blocks / (resident per SM x SMs)).  Needs the card."""
    wpa = bwd_warps_per_atom(b, vp)
    blocks, resident = ctypes.c_longlong(0), ctypes.c_int(0)
    rc = _kernel_lib("deposit_bwd").deposit_bwd_blocks(b, vp, c, int(gaussian), _CT_KINDS[ct_dtype], wpa,
                                                       ctypes.byref(blocks), ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"deposit_bwd occupancy query failed with cudaError {rc}")
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return dict(warps_per_atom=wpa, atoms_per_block=BWD_THREADS // 32 // wpa, blocks=blocks.value,
                resident_per_sm=resident.value, waves=blocks.value / max(resident.value * sms, 1))


def deposit_bwd(rows: torch.Tensor, weights: torch.Tensor, ct: torch.Tensor, *, spec: GridSpec, dl: int,
                gaussian: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of a deposit at cotangent ``ct`` (B, C, Dl, H*W) ->
    (grad_rows (B, 8, Vp), grad_weights (B, C, Vp)), f32; see
    ``deposit_bwd_plain`` for the function.

    CUDA tensors launch ``csrc/deposit_bwd.cu`` with
    ``bwd_warps_per_atom(B, Vp)`` warps an atom; it reads a float32 or a
    bfloat16 cotangent (an fp8 one is widened to bf16 first, exactly).
    CPU tensors run ``deposit_bwd_plain``.  Raises on anything the kernel
    does not take."""
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
    lib = _kernel_lib("deposit_bwd")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = lib.deposit_bwd(
            rows.data_ptr(), weights.data_ptr(), ct.data_ptr(), grad_rows.data_ptr(), grad_w.data_ptr(),
            b, vp, c, dl, dim, float(spec.resolution), float(spec.width / 2.0),
            int(gaussian), _CT_KINDS[ct.dtype], bwd_warps_per_atom(b, vp), stream,
        )
    if rc != 0:
        raise RuntimeError(f"deposit_bwd kernel launch failed with cudaError {rc}")
    launches["deposit_bwd"] += 1
    return grad_rows, grad_w


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
                  mask=None, d_offset=0, d_count: int | None = None, presorted: bool = False):
    """Padded, sorted kernel inputs for a batch: (rows, weights, ranges, Dl,
    gaussian), exactly what voxelize_deposit_batch hands to the kernels."""
    gaussian = check_density(density_type)
    check_kernel_dtype(coords.is_cuda, coords.dtype)
    b = weights.shape[0]
    radii = torch.as_tensor(radii, dtype=torch.float32, device=coords.device)
    if radii.ndim == 1:
        radii = radii[None, :].expand(b, -1)
    coords, weights, radii, mask = _pad_atoms(coords.to(torch.float32), weights.to(torch.float32), radii, mask)
    if coords.shape[1] > CHUNK and not presorted:
        coords, weights, radii, mask = sort_atoms_spatially(coords, weights, radii, mask, spec)
    rows, wt, ranges, dl = prepare_deposit(coords, weights, radii, mask, spec, gaussian, sigma, d_offset, d_count,
                                           notrunc=density_type == "gaussian_notrunc")
    return rows, wt, ranges, dl, gaussian


def voxelize_deposit_batch(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian",
                           sigma: float = 0.5, mask=None, d_offset=0, d_count: int | None = None,
                           out_dtype="float32", presorted: bool = False) -> torch.Tensor:
    """Batched deposit -> (B, C, Dl, H, W) with per-atom radii.

    coords (B, V, 3); weights (B, V, C); radii (V,) shared or (B, V); mask
    (B, V) bool or None.  ``presorted``: atoms already arrive in Morton
    order (ops.batch sorts before the random transform), so no sort here.
    Differentiable in coords, weights and radii: the forward kernel runs
    forward, the backward kernel backward.  Counterpart of
    voxelize_pallas_batch and its custom VJP (voxelize_pallas_bwd_batch)."""
    from .autodiff import deposit  # autodiff imports this module

    b, _, c = weights.shape
    rows, wt, ranges, dl, gaussian = prepare_batch(
        coords, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
        d_offset=d_offset, d_count=d_count, presorted=presorted,
    )
    out = deposit(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_torch_dtype(out_dtype))
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
                                       out_dtype="float32", presorted: bool = False) -> torch.Tensor:
    """Batched deposit with channel-wise radii (C,) -> (B, C, Dl, H, W).

    The real atoms are Morton-sorted first, then expanded into virtual atoms
    (``expand_channelwise``), so each virtual chunk is single-channel and
    spatially local.  Counterpart of voxelize_pallas_batch_channelwise."""
    check_kernel_dtype(coords.is_cuda, coords.dtype)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=coords.device)
    coords, weights, _, mask = _pad_atoms(coords.to(torch.float32), weights.to(torch.float32), None, mask)
    if coords.shape[1] > CHUNK and not presorted:
        ones = torch.ones(coords.shape[:2], dtype=torch.float32, device=coords.device)
        coords, weights, _, mask = sort_atoms_spatially(coords, weights, ones, mask, spec)
    coords_x, wx, radii_x, mask_x = expand_channelwise(coords, weights, radii, mask)
    return voxelize_deposit_batch(
        coords_x, wx, radii_x, spec=spec, density_type=density_type, sigma=sigma, mask=mask_x,
        d_offset=d_offset, d_count=d_count, out_dtype=out_dtype, presorted=True,
    )


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

