"""Batched voxelization over padded molecule batches.

center shift -> Morton presort -> per-molecule random rigid transform ->
deposit.  On CUDA the batch is the kernels' leading grid axis; on the CPU
the plain dense op runs per molecule; ``gaussian_notrunc`` routes as in
ops/voxelize.py.  Every path is differentiable (the training path).
On the CPU the separable path packs small molecules several to a row
(``_packed_batch``) as the JAX package does; CUDA never packs.  Full
grids too deep for one launch are assembled on the host from depth slabs
(``pick_slab_depth``, ``voxelize_batch_sliced``).  Counterpart of
``molvoxel_tpu/ops/batch.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import GridSpec
from ..core.transform import (  # noqa: F401  (do_random_transform: the JAX package's name here)
    do_random_transform,
    quaternion_to_matrix,
    random_quaternion,
    random_translation_vector,
    rotate,
)
from .deposit import (
    CHUNK,
    check_density,
    out_torch_dtype,
    sort_atoms_spatially,
    voxelize_deposit_batch,
    voxelize_deposit_batch_channelwise,
)
from .dense import voxelize_dense, voxelize_dense_channelwise
from .separable import voxelize_separable_batch, voxelize_separable_batch_channelwise
from .voxelize import default_batch_impl, notrunc_separable, resolve_impl  # noqa: F401  (the JAX package's name)
from .voxelize import needs_grad

# The TPU kernel's output-tile budget, copied from the JAX package
# (_OUT_BUDGET, molvoxel_tpu/ops/pallas_deposit.py:63) with its whole-row
# tile rule (_row_tile, :380) for pick_slab_depth.  They are the TPU's VMEM
# sizes, kept so that both packages cut the same slabs: on an H100 the slab
# size does not matter to the sliced call, whose 4 launches of about 0.09 ms
# stand against 70-100 ms of host copies at 256^3 (PERF.md).
_OUT_BUDGET = 5 * 2**20


def draw_transforms(generator: torch.Generator | None, b: int, random_translation: float,
                    random_rotation: bool) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(quaternions (b, 4) or None, translations (b, 3) or None): the
    draws ``random_transform_batch`` makes for a batch of ``b``, in its
    order, on the generator's device."""
    q = random_quaternion(generator, (b,)) if random_rotation else None
    t = random_translation_vector(generator, random_translation, (b,)) if random_translation > 0.0 else None
    return q, t


def apply_transforms(coords: torch.Tensor, transforms) -> torch.Tensor:
    """Rotate (about the origin) then translate each molecule of (B, V, 3)
    coords by its row of ``transforms`` (``draw_transforms``'s pair)."""
    q, t = transforms
    if q is not None:
        coords = rotate(coords, quaternion_to_matrix(q).to(coords.device))
    if t is not None:
        coords = coords + t.to(device=coords.device, dtype=coords.dtype)[:, None, :]
    return coords


def random_transform_batch(generator: torch.Generator | None, coords: torch.Tensor, random_translation: float,
                           random_rotation: bool) -> torch.Tensor:
    """Apply an independent random rotation (about the origin) and
    translation to every molecule of (B, V, 3) coords."""
    return apply_transforms(coords, draw_transforms(generator, coords.shape[0], random_translation, random_rotation))


def _place(coords, weights, radii, mask, centers, generator, random_translation, *, spec, resolved, separable,
           channelwise, random_rotation, presorted, transforms=None):
    """Center, Morton-sort (kernel path, > CHUNK atoms) and transform a batch:
    the part of ``voxelize_batch`` before the deposit.  Sorting comes BEFORE
    the random transform: rigid transforms preserve locality, so one sort
    serves every augmented sample.  ``transforms`` (drawn beforehand) takes
    the place of the generator's draw.  Returns (coords, weights, radii,
    mask, presorted)."""
    if centers is not None:
        coords = coords - centers[:, None, :].to(coords.dtype)
    if resolved == "cuda" and not separable and not channelwise and coords.shape[1] > CHUNK and not presorted:
        r_atoms = radii if radii.ndim == 2 else torch.as_tensor(radii, dtype=torch.float32).expand(coords.shape[:2])
        coords, weights, radii, mask = sort_atoms_spatially(coords, weights, r_atoms, mask, spec)
        presorted = True
    if transforms is None:
        transforms = draw_transforms(generator, coords.shape[0], float(random_translation), random_rotation)
    return apply_transforms(coords, transforms), weights, radii, mask, presorted


def _deposit(coords, weights, radii, mask, *, spec, density_type, sigma, channelwise, resolved, separable,
             radii_batched, d_offset, d_count, odt, presorted):
    """The deposit half of ``voxelize_batch``, on placed coordinates."""
    if separable:
        kw = dict(spec=spec, sigma=sigma, mask=mask, d_offset=d_offset, d_count=d_count, out_dtype=odt)
        if channelwise:
            return voxelize_separable_batch_channelwise(coords, weights, radii, **kw)
        # packed as the JAX package packs on the CPU; never on CUDA, where the
        # packed product (P x the work over block-diagonal zero weights) ran
        # slower than unpacked at Vp 32 and 64, C 1 and 4 (PERF.md, packing)
        pack = 1 if resolved == "cuda" else _choose_pack_separable(coords.shape[1], weights.shape[2])
        if pack > 1:
            def fn(crd, w, r, mask=None):
                return voxelize_separable_batch(crd, w, r, mask=mask, **kw_nomask(kw))

            return _packed_batch(fn, coords, weights, radii, mask, pack)
        return voxelize_separable_batch(coords, weights, radii, **kw)

    kw = dict(spec=spec, density_type=density_type, sigma=sigma, d_offset=d_offset, d_count=d_count)
    if resolved == "cuda":
        # never packed: on the H100 the kernel ran packed batches (as
        # _choose_pack packs them) 1.7-2.4x slower than unpacked at Vp 32 and
        # 64, C 1 and 4 (PERF.md, packing; chip_smoke.py phase_packing)
        fn = voxelize_deposit_batch_channelwise if channelwise else voxelize_deposit_batch
        return fn(coords, weights, radii, mask=mask, out_dtype=odt, presorted=presorted, **kw)

    fn = voxelize_dense_channelwise if channelwise else voxelize_dense
    outs = [
        fn(coords[i], weights[i], radii[i] if radii_batched else radii, mask=None if mask is None else mask[i], **kw)
        for i in range(coords.shape[0])
    ]
    return torch.stack(outs).to(odt)


def voxelize_batch(
    coords: torch.Tensor,
    weights: torch.Tensor,
    radii: torch.Tensor,
    mask: torch.Tensor | None,
    centers: torch.Tensor | None,
    generator: torch.Generator | None = None,
    random_translation: float = 0.0,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
    radii_batched: bool = False,
    d_offset=0,
    d_count: int | None = None,
    out_dtype="float32",
    presorted: bool = False,
    materialize: bool = False,
    transforms=None,
) -> torch.Tensor:
    """Voxelize a padded batch of point clouds -> (B, C, Dl, H, W) of ``out_dtype``.

    Args:
      coords: (B, V, 3).  weights: (B, V, C).
      radii: (V,)/(C,) shared, or (B, V) when ``radii_batched``.
      mask: (B, V) bool or None.  centers: (B, 3) or None (origin).
      generator: ``torch.Generator`` for the augmentation (drawn on the host).
      random_translation: magnitude; random_rotation: bool.
      d_offset/d_count: optional depth slab.
      out_dtype: "float32", "bfloat16" or "float8_e4m3fn"; accumulation is f32.
      presorted: atoms already arrive in Morton order, so no sort is needed.
      materialize: accepted for the JAX package's signature (there it fences
        XLA's folding of the grid) and ignored: the kernel writes every grid.
      transforms: (quaternions (B, 4) or None, translations (B, 3) or None)
        drawn beforehand (``draw_transforms``), used in place of drawing from
        ``generator`` (the sharded paths draw a whole batch once and hand
        each rank its rows).
    """
    check_density(density_type)
    odt = out_torch_dtype(out_dtype)
    resolved = resolve_impl(impl, coords)
    separable = notrunc_separable(density_type, impl, resolved, coords.shape[1], spec, d_count, channelwise,
                                  channels=weights.shape[2], batch=coords.shape[0], out_dtype=odt,
                                  grad=needs_grad(coords, weights, radii))
    coords, weights, radii, mask, presorted = _place(
        coords, weights, radii, mask, centers, generator, random_translation, spec=spec, resolved=resolved,
        separable=separable, channelwise=channelwise, random_rotation=random_rotation, presorted=presorted,
        transforms=transforms)
    return _deposit(coords, weights, radii, mask, spec=spec, density_type=density_type, sigma=sigma,
                    channelwise=channelwise, resolved=resolved, separable=separable, radii_batched=radii_batched,
                    d_offset=d_offset, d_count=d_count, odt=odt, presorted=presorted)


def _row_tile(hw: int, w: int, target: int = 1024) -> int | None:
    """The TPU kernel's whole-row hw tile (a copy of the JAX package's
    ``_row_tile``): a multiple of both W and 128 that divides hw, at most
    about ``target``, with t // w rows a multiple of 8 or all W rows."""
    if hw % 128 != 0:
        return None
    step = w * 128 // math.gcd(w, 128)
    best = None
    t = step
    while t <= hw:
        rows = t // w
        if hw % t == 0 and (rows % 8 == 0 or rows == w):
            if t <= target or best is None:
                best = t
        t += step
    return best


def pick_slab_depth(spec: GridSpec, num_channels: int = 4) -> int | None:
    """Depth-slab size for grids whose full depth exceeds the kernel budget.

    None = one launch writes the whole depth (every dimension up to 128);
    otherwise the largest 8-multiple divisor of D whose slab tile fits the
    TPU's output budget: 64 at 256^3.  The values are the JAX package's, so
    both packages cut the same slabs (``_OUT_BUDGET``).  Drives the
    full-grid assembly (``voxelize_batch_sliced``, CLI ``--dimension 256``).
    """
    dim = spec.dimension
    hwt = _row_tile(dim * dim, dim)
    if hwt is None or 8 * dim * hwt * 4 <= _OUT_BUDGET:
        return None
    best = None
    for slab in range(8, dim, 8):
        if dim % slab == 0 and 8 * slab * hwt * 4 <= _OUT_BUDGET:
            best = slab
    return best if best is not None else 8


def _host_view(out, odt: torch.dtype) -> torch.Tensor:
    """A CPU tensor sharing ``out``'s memory (a numpy array or memmap, or a
    CPU tensor), viewed as ``odt``.  bfloat16 and float8 grids go into
    numpy arrays of the same item size (int16 / uint8 or raw void)."""
    if isinstance(out, torch.Tensor):
        return out if out.dtype == odt else out.view(odt)
    arr = np.asarray(out) if not isinstance(out, np.ndarray) else out
    size = torch.empty((), dtype=odt).element_size()
    if arr.dtype.itemsize != size:
        raise ValueError(f"out has {arr.dtype} items; {odt} grids need {size}-byte items")
    as_int = {1: np.uint8, 2: np.int16, 4: np.int32}[size]
    t = torch.from_numpy(arr.view(as_int))
    return t.view(odt)


def voxelize_batch_sliced(
    coords,
    weights,
    radii,
    mask,
    centers,
    generator=None,
    random_translation=0.0,
    *,
    spec: GridSpec,
    slab_depth: int,
    out=None,
    **kw,
):
    """Assemble a FULL (B, C, D, H, W) grid from depth slabs, bounded memory.

    The batch is centered, Morton-sorted and transformed ONCE (one draw from
    ``generator``); then each slab of ``slab_depth`` planes is deposited with
    augmentation off, so every slab sees the same rigid transform.  On CUDA
    slab k is copied to the host on a side stream, through a pinned buffer,
    while slab k+1 runs; device memory stays O(B * C * slab * H * W).

    ``out``: a host array to fill (a numpy array or ``np.memmap``, with
    items of the grid dtype's size, or a CPU tensor); None allocates a CPU
    tensor.  Returns ``out``.  ``kw`` are ``voxelize_batch``'s keywords."""
    dim = spec.dimension
    if dim % slab_depth:
        raise ValueError(f"dimension {dim} not divisible by slab_depth {slab_depth}")
    density_type = kw.pop("density_type", "gaussian")
    sigma = kw.pop("sigma", 0.5)
    random_rotation = kw.pop("random_rotation", False)
    channelwise = kw.pop("channelwise", False)
    impl = kw.pop("impl", "auto")
    radii_batched = kw.pop("radii_batched", False)
    odt = out_torch_dtype(kw.pop("out_dtype", "float32"))
    presorted = kw.pop("presorted", False)
    if kw:
        raise TypeError(f"voxelize_batch_sliced got unexpected keywords {sorted(kw)}")
    check_density(density_type)
    b, _, c = weights.shape
    resolved = resolve_impl(impl, coords)
    # routed as one slab would be (notrunc's rule reads the slab depth); no gradient is taken
    separable = notrunc_separable(density_type, impl, resolved, coords.shape[1], spec, slab_depth, channelwise,
                                  channels=c, batch=b, out_dtype=odt)
    coords, weights, radii, mask, presorted = _place(
        coords, weights, radii, mask, centers, generator, random_translation, spec=spec, resolved=resolved,
        separable=separable, channelwise=channelwise, random_rotation=random_rotation, presorted=presorted)
    result = torch.empty((b, c, dim, dim, dim), dtype=odt) if out is None else out
    host = _host_view(result, odt)
    if tuple(host.shape) != (b, c, dim, dim, dim):
        raise ValueError(f"out must be {(b, c, dim, dim, dim)}, got {tuple(host.shape)}")

    def slab(d0):
        return _deposit(coords, weights, radii, mask, spec=spec, density_type=density_type, sigma=sigma,
                        channelwise=channelwise, resolved=resolved, separable=separable,
                        radii_batched=radii_batched, d_offset=d0, d_count=slab_depth, odt=odt, presorted=presorted)

    with torch.no_grad():
        if not coords.is_cuda:
            for d0 in range(0, dim, slab_depth):
                host[:, :, d0:d0 + slab_depth] = slab(d0)
            return result
        main = torch.cuda.current_stream(coords.device)
        side = torch.cuda.Stream(coords.device)
        pinned = [torch.empty((b, c, slab_depth, dim, dim), dtype=odt, pin_memory=True) for _ in range(2)]
        pending = None  # (d0, pinned buffer, event after its copy)
        for k, d0 in enumerate(range(0, dim, slab_depth)):
            cur = slab(d0)
            side.wait_stream(main)
            buf = pinned[k % 2]  # its previous copy (slab k-2) was drained below
            with torch.cuda.stream(side):
                buf.copy_(cur, non_blocking=True)
                cur.record_stream(side)
                copied = torch.cuda.Event()
                copied.record(side)
            if pending is not None:
                pending[2].synchronize()
                host[:, :, pending[0]:pending[0] + slab_depth] = pending[1]
            pending = (d0, buf, copied)
        pending[2].synchronize()
        host[:, :, pending[0]:pending[0] + slab_depth] = pending[1]
    return result


def kw_nomask(kw):
    return {k: v for k, v in kw.items() if k != "mask"}


def _choose_pack(vp: int, c: int) -> int:
    """Molecules packed per launch row for the kernel path (1 = no packing);
    the separable path has its own policy (``_choose_pack_separable``).

    The JAX package's table, kept as it is: on the TPU a V <= 64 molecule
    fills half a 128-lane atom chunk or less and its channels pad to 8
    sublanes, and the smallest pack P with ``P*vp % 128 == 0`` and
    ``P*c % 8 == 0`` fills both; when no P <= 32/c does, lane-filling alone.
    The CUDA kernel has no lanes to fill: packed batches ran slower on the
    H100 at every measured shape, so nothing in the package routes by this
    table (the JAX package's dense path does not pack either); it is kept
    as the JAX package has it, for parity.
    """
    if vp not in (32, 64):
        return 1
    base = 128 // vp
    for p in range(base, 33, base):
        if p * c > 32:
            break
        if (p * c) % 8 == 0:
            return p
    return base if base * c <= 32 else 1


def _choose_pack_separable(vp: int, c: int) -> int:
    """Pack for the separable (no-cutoff) path: lane-filling only, and one
    extra doubling at C = 1 (the JAX package's table, measured on a TPU).
    The CPU path packs by it; the CUDA path does not (``_deposit``)."""
    if vp not in (32, 64):
        return 1
    base = 128 // vp
    p = max(base, 4) if c == 1 else base
    return p if p * c <= 32 else 1


def _packed_batch(fn, coords, weights, radii, mask, pack):
    """Pack ``pack`` small molecules into each launch row.

    P molecules become one row of P*Vp atoms with block-diagonal channel
    weights (each molecule owns a disjoint C-slice of a P*C-channel output);
    the per-molecule grids fall out of a channel reshape.  The same trick as
    the reference's MolSystemPointCloudMaker channel offsets (reference
    molvoxel/etc/rdkit/pointcloud.py:207-312), applied to batching.
    ``fn(coords, weights, radii, mask=...)`` is the unpacked op.
    """
    b, vp, c = weights.shape
    pad_b = (-b) % pack
    if pad_b:
        coords = torch.nn.functional.pad(coords, (0, 0, 0, 0, 0, pad_b))
        weights = torch.nn.functional.pad(weights, (0, 0, 0, 0, 0, pad_b))
        if radii.ndim == 2:
            radii = torch.nn.functional.pad(radii, (0, 0, 0, pad_b), value=1.0)
        mask = torch.nn.functional.pad(mask, (0, 0, 0, pad_b)) if mask is not None else None
    bp = coords.shape[0] // pack

    pc = coords.reshape(bp, pack * vp, 3)
    wg = weights.reshape(bp, pack, vp, c)
    pw = torch.zeros((bp, pack, vp, pack, c), dtype=weights.dtype, device=weights.device)
    for i in range(pack):
        pw[:, i, :, i] = wg[:, i]
    pw = pw.reshape(bp, pack * vp, pack * c)
    pr = radii.reshape(bp, pack * vp) if radii.ndim == 2 else radii.repeat(pack)
    pm = mask.reshape(bp, pack * vp) if mask is not None else None

    out = fn(pc, pw, pr, mask=pm)  # (bp, pack*c, Dl, H, W)
    dl, dim = out.shape[2], out.shape[3]
    return out.reshape(bp * pack, c, dl, dim, dim)[:b]
