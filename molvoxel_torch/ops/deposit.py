"""Forward deposit on the CUDA kernel ``csrc/deposit_fwd.cu``, and its plain version.

Counterpart of the forward half of ``molvoxel_tpu/ops/pallas_deposit.py``.
The torch side does the O(V) bookkeeping:

- pad the atom axis to whole 64-atom chunks with far-off, zero-weight atoms;
- sort atoms along a Morton curve (``morton_keys``), so each chunk is
  spatially compact and its plane ranges are tight;
- build the per-atom rows [x - d_offset*res, y, z, r^2, coef] (B, 8, Vp);
- compute, in closed form, the depth planes [d_lo, d_hi) that each
  (hw tile, atom chunk) pair can reach (``plane_ranges``);
- expand channel-wise radii into virtual atoms (same position, radius r_c,
  weight only in channel c), so they run on the same kernel.

``deposit_fwd`` launches the kernel on CUDA tensors and runs
``deposit_plain`` (the same function in torch tensor ops, applying the same
ranges) on CPU tensors.  Nothing on a CUDA tensor falls back to the plain
version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import GridSpec, round_up
from . import _build

TILE_HW = 128  # flat h*w voxels per kernel block (kTileHW in deposit_fwd.cu)
CHUNK = 64  # atoms per chunk (kChunk in deposit_fwd.cu)
FAR = 1e3  # coordinate of padding atoms: far outside any grid
_PLAIN_BUDGET = 1 << 26  # elements of deposit_plain's (planes, H*W, chunk) temporary

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"deposit_fwd": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def out_torch_dtype(out_dtype) -> torch.dtype:
    """"float32" / "bfloat16" / "float8_e4m3fn" (or a torch dtype) -> torch dtype."""
    dt = getattr(torch, out_dtype) if isinstance(out_dtype, str) else out_dtype
    if dt not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be float32, bfloat16 or float8_e4m3fn, got {out_dtype!r}")
    return dt


def check_forward_only(*tensors):
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise NotImplementedError(
                "molvoxel_torch is forward-only so far: the backward kernel (the port of "
                "_kernel_v5_bwd) and the autograd.Function are ROADMAP item B.2"
            )


def check_kernel_dtype(on_cuda: bool, dtype: torch.dtype):
    """The CUDA deposit computes in float32: float64 on the card raises
    rather than being cast down.  float64 is the CPU parity lane."""
    if on_cuda and dtype == torch.float64:
        raise ValueError(
            "the CUDA deposit is float32; precision=64 (float64) is the CPU parity lane: "
            "pass device='cpu', or impl='dense' to run the plain float64 path on the card"
        )


def check_density(density_type: str) -> bool:
    """True for gaussian, False for binary; raises for anything else."""
    if density_type == "gaussian_notrunc":
        raise NotImplementedError(
            "density_type='gaussian_notrunc' is not ported yet: it is ROADMAP item A.8 "
            "(the notrunc threshold row plus the separable path)"
        )
    if density_type not in ("gaussian", "binary"):
        raise ValueError(f"unknown density_type {density_type!r}")
    return density_type == "gaussian"


# ------------------------------------------------------------- bookkeeping


def morton_keys(coords: torch.Tensor, spec: GridSpec, mask: torch.Tensor | None = None, bits: int = 5):
    """(B, Vp) int32 Morton (Z-order) cell keys; x bits most significant.
    Masked (padding) atoms key to 2^30, so they sort last."""
    cells = (1 << bits) - 1
    lb = torch.tensor(spec.lower_bound, dtype=torch.float32, device=coords.device)
    scale = torch.tensor(float(cells), dtype=torch.float32) / torch.tensor(max(spec.width, 1e-6), dtype=torch.float32)
    cell = ((coords.to(torch.float32) - lb) * scale.to(coords.device)).clamp(0, cells).to(torch.int32)
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


def plane_ranges(coords_shifted: torch.Tensor, r2: torch.Tensor, spec: GridSpec, dl: int) -> torch.Tensor:
    """(B, nhwt, nvc, 2) int32 [d_lo, d_hi) depth planes each (hw tile, atom
    chunk) pair can reach, in closed form, at the kernel's tiles.

    Tile ``t`` covers flat voxels [t*TILE_HW, min((t+1)*TILE_HW, H*W)), so
    rows h_lo..h_hi and every column.  An atom's minimum squared yz distance
    to the tile is its distance to that box (a lower bound on every voxel's);
    the planes it reaches solve |x - d*res + w/2| <= sqrt(r^2 - min).  A few
    ulps of slack make the interval only ever wider.  ``coords_shifted`` has
    x pre-shifted by d_offset*res; ``r2`` is (B, Vp) with masked atoms at 1.
    Where tiles are whole h rows this is _plane_ranges_closed of the JAX
    package with hrows = TILE_HW // W and a = CHUNK.
    """
    b, vp, _ = coords_shifted.shape
    dev = coords_shifted.device
    dim = spec.dimension
    hw = dim * dim
    nhwt = -(-hw // TILE_HW)
    res = float(spec.resolution)
    lb = float(spec.lower_bound)
    ub = float(spec.upper_bound)
    first = torch.arange(nhwt, device=dev) * TILE_HW
    last = torch.clamp(first + TILE_HW, max=hw) - 1
    row_lo = first // dim
    row_hi = last // dim
    h_lo = lb + row_lo.to(torch.float32) * res
    h_hi = h_lo + ((row_hi - row_lo).to(torch.float64) * res).to(torch.float32)
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
    lo = lo.reshape(b, nhwt, nvc, CHUNK).amin(dim=3)
    hi = hi.reshape(b, nhwt, nvc, CHUNK).amax(dim=3)
    hi = torch.maximum(hi, lo)  # all-empty chunks become d_hi == d_lo
    return torch.stack([lo, hi], dim=-1).contiguous()


def prepare_deposit(coords, weights, radii, mask, spec: GridSpec, gaussian: bool, sigma: float,
                    d_offset=0, d_count: int | None = None):
    """Kernel inputs from padded (B, Vp, 3) / (B, Vp, C) / (B, Vp) arrays with
    Vp a multiple of CHUNK: atom rows (B, 8, Vp), weights (B, C, Vp),
    ranges (B, nhwt, nvc, 2), and the local depth Dl."""
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    res = float(spec.resolution)
    wt = weights.to(torch.float32).transpose(1, 2)
    r2 = radii * radii
    if mask is not None:
        wt = torch.where(mask[:, None, :], wt, torch.zeros((), dtype=torch.float32, device=wt.device))
        r2 = torch.where(mask, r2, torch.ones((), dtype=torch.float32, device=r2.device))
    xs = coords[..., 0] - torch.tensor(float(d_offset), dtype=torch.float32, device=coords.device) * res
    zero = torch.zeros_like(r2)
    coef = (-(0.5 / (sigma * sigma))) / r2 if gaussian else zero
    rows = torch.stack([xs, coords[..., 1], coords[..., 2], r2, coef, zero, zero, zero], dim=1).contiguous()
    coords_shifted = torch.stack([xs, coords[..., 1], coords[..., 2]], dim=-1)
    ranges = plane_ranges(coords_shifted, r2, spec, dl)
    return rows, wt.contiguous(), ranges, dl


# ------------------------------------------------------- kernel and plain


def deposit_plain(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
                  gaussian: bool, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in torch tensor ops -> (B, C, Dl, H*W).

    Same inputs as the kernel; the plane ranges are applied (a voxel of tile
    t gets chunk vc only on planes [d_lo, d_hi)), so a range that drops a
    reachable plane shows up here too.  Accumulates in f32, casts once."""
    b, _, vp = rows.shape
    c = weights.shape[1]
    dim = spec.dimension
    hw = dim * dim
    dev = rows.device
    nvc = ranges.shape[2]
    chunk = vp // nvc
    if ranges.shape[1] != -(-hw // TILE_HW):
        raise ValueError(f"ranges must have one row per {TILE_HW}-voxel hw tile, got {tuple(ranges.shape)}")
    res = torch.tensor(spec.resolution, dtype=torch.float32, device=dev)
    half = torch.tensor(spec.width / 2.0, dtype=torch.float32, device=dev)
    pd = torch.arange(dl, device=dev).to(torch.float32) * res - half
    ph = torch.arange(dim, device=dev).to(torch.float32) * res - half
    tile_of = torch.arange(hw, device=dev) // TILE_HW
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


def _kernel_lib():
    lib = _build.load("deposit_fwd")
    if not getattr(lib, "_molvoxel_typed", False):
        lib.deposit_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.deposit_fwd.restype = ctypes.c_int
        for fn in (lib.deposit_fwd_tile_hw, lib.deposit_fwd_chunk):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.deposit_fwd_tile_hw(), lib.deposit_fwd_chunk()) != (TILE_HW, CHUNK):
            raise RuntimeError("deposit_fwd.cu tiles disagree with molvoxel_torch/ops/deposit.py")
        lib._molvoxel_typed = True
    return lib


def deposit_fwd(rows: torch.Tensor, weights: torch.Tensor, ranges: torch.Tensor, *, spec: GridSpec, dl: int,
                gaussian: bool, out_dtype=torch.float32) -> torch.Tensor:
    """Deposit prepared atoms -> (B, C, Dl, H*W) of ``out_dtype``.

    CUDA tensors launch ``csrc/deposit_fwd.cu``; CPU tensors run
    ``deposit_plain``.  Raises on anything the kernel does not take."""
    out_dtype = out_torch_dtype(out_dtype)
    check_forward_only(rows, weights)
    if rows.device.type == "cpu":
        return deposit_plain(rows, weights, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_dtype)
    if rows.device.type != "cuda":
        raise ValueError(f"deposit_fwd runs on CUDA or CPU tensors, got {rows.device}")
    b, eight, vp = rows.shape
    dim = spec.dimension
    nhwt = -(-dim * dim // TILE_HW)
    if eight != 8 or vp % CHUNK:
        raise ValueError(f"atom rows must be (B, 8, Vp) with Vp a multiple of {CHUNK}, got {tuple(rows.shape)}")
    if weights.ndim != 3 or weights.shape[0] != b or weights.shape[2] != vp:
        raise ValueError(f"weights must be (B={b}, C, Vp={vp}), got {tuple(weights.shape)}")
    if tuple(ranges.shape) != (b, nhwt, vp // CHUNK, 2):
        raise ValueError(f"ranges must be {(b, nhwt, vp // CHUNK, 2)}, got {tuple(ranges.shape)}")
    for name, t, dt in (("rows", rows, torch.float32), ("weights", weights, torch.float32),
                        ("ranges", ranges, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {rows.device}")
    c = weights.shape[1]
    out = torch.empty((b, c, dl, dim * dim), dtype=out_dtype, device=rows.device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        rc = lib.deposit_fwd(
            rows.data_ptr(), weights.data_ptr(), ranges.data_ptr(), out.data_ptr(),
            b, vp, c, dl, dim, float(spec.resolution), float(spec.width / 2.0),
            int(gaussian), _OUT_KINDS[out_dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"deposit_fwd kernel launch failed with cudaError {rc}")
    launches["deposit_fwd"] += 1
    return out


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
    gaussian), exactly what voxelize_deposit_batch hands to deposit_fwd."""
    gaussian = check_density(density_type)
    check_forward_only(coords, weights, radii)
    check_kernel_dtype(coords.is_cuda, coords.dtype)
    b = weights.shape[0]
    radii = torch.as_tensor(radii, dtype=torch.float32, device=coords.device)
    if radii.ndim == 1:
        radii = radii[None, :].expand(b, -1)
    coords, weights, radii, mask = _pad_atoms(coords.to(torch.float32), weights.to(torch.float32), radii, mask)
    if coords.shape[1] > CHUNK and not presorted:
        coords, weights, radii, mask = sort_atoms_spatially(coords, weights, radii, mask, spec)
    rows, wt, ranges, dl = prepare_deposit(coords, weights, radii, mask, spec, gaussian, sigma, d_offset, d_count)
    return rows, wt, ranges, dl, gaussian


def voxelize_deposit_batch(coords, weights, radii, *, spec: GridSpec, density_type: str = "gaussian",
                           sigma: float = 0.5, mask=None, d_offset=0, d_count: int | None = None,
                           out_dtype="float32", presorted: bool = False) -> torch.Tensor:
    """Batched deposit -> (B, C, Dl, H, W) with per-atom radii.

    coords (B, V, 3); weights (B, V, C); radii (V,) shared or (B, V); mask
    (B, V) bool or None.  ``presorted``: atoms already arrive in Morton
    order (ops.batch sorts before the random transform), so no sort here.
    Counterpart of voxelize_pallas_batch."""
    b, _, c = weights.shape
    rows, wt, ranges, dl, gaussian = prepare_batch(
        coords, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
        d_offset=d_offset, d_count=d_count, presorted=presorted,
    )
    out = deposit_fwd(rows, wt, ranges, spec=spec, dl=dl, gaussian=gaussian, out_dtype=out_dtype)
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

