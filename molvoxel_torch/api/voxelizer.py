"""Public voxelizer API, with the JAX package's methods, argument orders and defaults.

- ``forward(coords, center, channels, radii, ...)`` dispatches to single /
  types / features on ``channels`` being None / 1-D / 2-D.
- ``forward_types`` renders integer types through one-hot weights.
- ``out_grid`` keeps the in-place contract: the result is copied into a
  given numpy array or tensor and that same object is returned.
- Results are torch tensors on the voxelizer's device.  The device is CUDA
  unless the caller asks for the CPU (``device="cpu"``); with no CUDA device
  a forward raises rather than quietly running on the CPU.
- Randomness: each ``Voxelizer`` owns a ``torch.Generator`` (constructor
  ``seed=``); every forward accepts ``key=`` (a ``torch.Generator`` or an int
  seed) for reproducible augmentation.
- ``precision=64`` computes in float64 on the plain dense path, which is
  the CPU parity lane: the CUDA kernel is float32, so precision=64 on a CUDA
  device raises unless the caller passes ``impl="dense"``.
- Not differentiable, as in the JAX package (whose ``forward_*`` return
  numpy arrays): an input tensor that requires grad raises, naming the
  differentiable entry points (``ops.voxelize.voxelize``,
  ``ops.batch.voxelize_batch``, ``nn.VoxelizeLayer``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.config import DENSITY_TYPE_LIST, RADII_TYPE_LIST, GridSpec, VoxelizerConfig, small_atom_bucket
from ..core.transform import RandomTransform, do_random_transform, draw_transform_table
from ..data.staging import PinnedRing, batch_layout, stage_batch, unpinned
from ..ops.deposit import Transforms, check_kernel_dtype
from ..ops.voxelize import default_impl, voxelize  # noqa: F401  (default_impl: the JAX package's name here)
from ..utils.timing import count, recording, span


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "molvoxel_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


class Voxelizer:
    """Voxelizer on the CUDA deposit kernel (CPU: the plain dense path).
    gaussian_notrunc runs on the CPU as the separable product, and on the
    card on the kernel (its threshold row; ops/voxelize.notrunc_separable)."""

    LIB = "PyTorch"
    RADII_TYPE_LIST = list(RADII_TYPE_LIST)
    DENSITY_TYPE_LIST = list(DENSITY_TYPE_LIST)
    transform_class = RandomTransform

    def __init__(
        self,
        resolution: float = 0.5,
        dimension: int = 64,
        radii_type: str = "scalar",
        density_type: str = "gaussian",
        precision: int = 32,
        blockdim: int | None = None,  # accepted for reference compatibility; tiling is automatic
        device="cuda",
        seed: int | None = None,
        impl: str = "auto",
        **kwargs,
    ):
        self._config = VoxelizerConfig(
            grid=GridSpec(resolution=resolution, dimension=dimension),
            radii_type=radii_type,
            density_type=density_type,
            sigma=kwargs.get("sigma", 0.5),
            precision=precision,
        )
        self._impl = impl
        self._device = torch.device(device)
        self.fp = np.float32 if precision == 32 else np.float64
        self._dtype = torch.float32 if precision == 32 else torch.float64
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self._generator = torch.Generator().manual_seed(int(seed))
        self._ring = None  # forward_batch's pinned staging ring on the card, made at its first call there

    def __getstate__(self):
        return {**self.__dict__, "_ring": None}  # pinned buffers and CUDA events stay in this process

    # ----------------------------------------------------------------- device

    def to(self, device) -> "Voxelizer":
        """Move the voxelizer (its outputs and its compute) to ``device``."""
        self._device = torch.device(device)
        return self

    def cuda(self) -> "Voxelizer":
        return self.to("cuda")

    def cpu(self) -> "Voxelizer":
        return self.to("cpu")

    def _compute_device(self) -> torch.device:
        """The device a forward runs on; raises where this voxelizer's
        precision cannot run there."""
        dev = _resolve_device(self._device)
        if self._impl != "dense":
            check_kernel_dtype(dev.type == "cuda", self._dtype)
        return dev

    @property
    def device(self) -> torch.device:
        return self._device

    # ----------------------------------------------------------------- config

    @property
    def config(self) -> VoxelizerConfig:
        return self._config

    @property
    def spec(self) -> GridSpec:
        return self._config.grid

    @property
    def resolution(self) -> float:
        return self._config.grid.resolution

    @property
    def dimension(self) -> int:
        return self._config.grid.dimension

    @property
    def width(self) -> float:
        return self._config.grid.width

    @property
    def upper_bound(self) -> float:
        return self._config.grid.upper_bound

    @property
    def lower_bound(self) -> float:
        return self._config.grid.lower_bound

    @property
    def spatial_dimension(self) -> tuple[int, int, int]:
        return self._config.grid.spatial_dimension

    def grid_dimension(self, num_channels: int) -> tuple[int, int, int, int]:
        return self._config.grid.grid_dimension(num_channels)

    @property
    def radii_type(self) -> str:
        return self._config.radii_type

    @radii_type.setter
    def radii_type(self, radii_type: str):
        self._config = dataclasses.replace(self._config, radii_type=radii_type)

    @property
    def density_type(self) -> str:
        return self._config.density_type

    @density_type.setter
    def density_type(self, density_type: str):
        self._config = dataclasses.replace(self._config, density_type=density_type)

    @property
    def sigma(self) -> float:
        return self._config.sigma

    @sigma.setter
    def sigma(self, sigma: float):
        self._config = dataclasses.replace(self._config, sigma=float(sigma))

    @property
    def is_radii_type_scalar(self):
        return self._config.is_radii_type_scalar

    @property
    def is_radii_type_channel_wise(self):
        return self._config.is_radii_type_channel_wise

    @property
    def is_radii_type_atom_wise(self):
        return self._config.is_radii_type_atom_wise

    @property
    def is_density_type_gaussian(self):
        return self._config.is_density_type_gaussian

    @property
    def is_density_type_binary(self):
        return self._config.is_density_type_binary

    # ------------------------------------------------------------------ utils

    def get_empty_grid(self, num_channels: int, batch_size: int | None = None, init_zero: bool = False):
        """A (batch_size?, C, D, H, W) tensor on the voxelizer's device."""
        shape = self.grid_dimension(num_channels)
        if batch_size is not None:
            shape = (batch_size,) + shape
        dev = _resolve_device(self._device)
        alloc = torch.zeros if init_zero else torch.empty
        return alloc(shape, dtype=self._dtype, device=dev)

    def asarray(self, array, obj: str) -> torch.Tensor:
        """Coerce to the dtype policy, on the voxelizer's device."""
        if obj in ("coords", "center", "features", "radii"):
            dtype = self._dtype
        elif obj == "types":
            dtype = torch.int64
        else:
            raise ValueError("obj should be ['coords', 'center', 'radii', 'types', 'features']")
        data = array.detach() if isinstance(array, torch.Tensor) else np.asarray(array)
        return torch.as_tensor(data, dtype=dtype, device=_resolve_device(self._device))

    def next_generator(self) -> torch.Generator:
        """A generator seeded from this voxelizer's own generator."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._generator))
        return torch.Generator().manual_seed(seed)

    @staticmethod
    def do_random_transform(coords, center, random_translation, random_rotation, key=None):
        gen = _generator(key) if key is not None else torch.Generator().manual_seed(
            int(np.random.randint(0, 2**31 - 1)))
        coords = torch.as_tensor(coords)
        return do_random_transform(gen, coords, center, random_translation, random_rotation)

    # ---------------------------------------------------------------- forward

    def forward(self, coords, center, channels, radii, random_translation: float = 0.0,
                random_rotation: bool = False, out_grid=None, key=None):
        if channels is None:
            return self.forward_single(coords, center, radii, random_translation, random_rotation, out_grid, key)
        if np.ndim(channels) == 1:
            return self.forward_types(coords, center, channels, radii, random_translation, random_rotation,
                                      out_grid, key)
        return self.forward_features(coords, center, channels, radii, random_translation, random_rotation,
                                     out_grid, key)

    __call__ = forward

    def forward_features(self, coords, center, features, radii, random_translation: float = 0.0,
                         random_rotation: bool = False, out_grid=None, key=None):
        _forward_only(coords, center, features, radii)
        coords = _host(coords, self.fp)
        features = _host(features, self.fp)
        self._check_args_features(coords, features, radii, out_grid)
        v = coords.shape[0]
        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        weights_p = _pad_rows(features, vp)
        channelwise = self.is_radii_type_channel_wise
        if channelwise:
            radii_arr = _host(radii, self.fp)
        elif self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(_host(radii, self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)
        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=channelwise)
        return _finalize(result, out_grid)

    def forward_types(self, coords, center, types, radii, random_translation: float = 0.0,
                      random_rotation: bool = False, out_grid=None, key=None):
        _forward_only(coords, center, types, radii)
        coords = _host(coords, self.fp)
        types = _host(types, None)
        self._check_args_types(coords, types, radii, out_grid)
        v = coords.shape[0]
        # Channel count: explicit out_grid wins; else channel-wise radii define
        # it; else C = max(types) + 1, resolved on the host.
        if out_grid is not None:
            c = int(out_grid.shape[0])
        elif self.is_radii_type_channel_wise:
            c = int(np.shape(radii)[0])
        else:
            c = int(types.max()) + 1 if v > 0 else 1
        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        weights_p = np.zeros((vp, c), dtype=self.fp)
        weights_p[np.arange(v), types.astype(np.int64)] = 1.0
        if self.is_radii_type_channel_wise:
            radii_arr = _pad_vec(_host(radii, self.fp)[types.astype(np.int64)], vp, fill=1.0)
        elif self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(_host(radii, self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)
        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=False)
        return _finalize(result, out_grid)

    def forward_single(self, coords, center, radii, random_translation: float = 0.0,
                       random_rotation: bool = False, out_grid=None, key=None):
        _forward_only(coords, center, radii)
        coords = _host(coords, self.fp)
        self._check_args_single(coords, radii, out_grid)
        v = coords.shape[0]
        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        weights_p = np.zeros((vp, 1), dtype=self.fp)
        weights_p[:v, 0] = 1.0
        if self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(_host(radii, self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)
        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=False)
        return _finalize(result, out_grid)

    # ------------------------------------------------------------------ batch

    def forward_batch(self, clouds, radii=1.0, centers=None, random_translation: float = 0.0,
                      random_rotation: bool = False, key=None, num_channels: int | None = None,
                      out_dtype: str = "float32"):
        """Voxelize many molecules in one kernel launch -> (B, C, D, H, W) tensor.

        ``clouds``: list of (coords (V_i, 3), channels) pairs, where channels
        is a (V_i, C) feature matrix or a (V_i,) int type vector (all items
        must agree).  Ragged sizes are padded into one bucket.
        ``num_channels``: explicit channel count for the types path (else
        ``max(types)+1`` over the batch).  ``out_dtype``: "float32",
        "bfloat16" or "float8_e4m3fn"; accumulation is f32.
        """
        with span("molvoxel.forward_batch"):  # around the whole body, the freeing of its locals included
            return self._forward_batch(clouds, radii, centers, random_translation, random_rotation, key,
                                       num_channels, out_dtype)

    def _forward_batch(self, clouds, radii, centers, random_translation, random_rotation, key, num_channels,
                       out_dtype):
        from ..ops.batch import voxelize_batch

        if len(clouds) == 0:
            raise ValueError("forward_batch needs at least one molecule")
        _forward_only(clouds, radii, centers)
        dev = self._compute_device()
        channelwise = self.is_radii_type_channel_wise
        with span("molvoxel.channels"):
            b = len(clouds)
            typed = np.ndim(clouds[0][1]) == 1  # types -> one-hot
            chan_dtype = np.int64 if typed else np.float32
            coords, channels, counts = [], [], []
            for crd, ch in clouds:
                crd = _host(crd, np.float32)
                coords.append(crd)
                channels.append(_host(ch, chan_dtype))
                counts.append(crd.shape[0])
            counts = np.array(counts, np.int64)
            if not typed:
                num_c = channels[0].shape[1]
            elif num_channels is not None:
                num_c = int(num_channels)
            else:
                num_c = max((int(t.max()) + 1 for t in channels if t.size), default=1)
            if channelwise:
                radii_in = _host(radii, np.float32)
            elif np.isscalar(radii):
                radii_in = float(radii)
            else:
                radii_in = [_host(r, np.float32) for r in radii]
            centers_in = None
            if centers is not None:
                if len(centers) != b:
                    raise ValueError(f"forward_batch has {b} molecules and {len(centers)} centers")
                centers_in = _host(centers, np.float32).reshape(b, 3)
        rot, trans = bool(random_rotation), float(random_translation) > 0.0
        with contextlib.ExitStack() as held:  # the ring's slot, given back behind the kernels that read it
            with span("molvoxel.pad"):  # the one pass that writes the padded batch and its transforms into the slot
                vp = small_atom_bucket(int(counts.max()))
                radii_shape = (tuple(radii_in.shape) if channelwise else (vp,) if isinstance(radii_in, float)
                               else (b, vp))
                layout = batch_layout(b, vp, num_c, radii_shape, centers_in is not None, rot or trans)
                ring = self._staging_ring(dev)
                staged = unpinned(layout) if ring is None else held.enter_context(ring.taken(layout))
                stage_batch(staged.arrays, coords, channels, counts, typed, radii_in, centers_in)
                if rot or trans:  # the table crosses in the slot's one copy
                    gen = _generator(key) if key is not None else self.next_generator()
                    draw_transform_table(gen, b, float(random_translation), rot, out=staged.arrays[-1])

            with span("molvoxel.copy_in"):
                tensors = layout.tensors(staged.host) if ring is None else ring.send(staged)
                if recording():  # counted only while a profiler records: an untraced call pays for no counter
                    count("molvoxel.copy_in_bytes", layout.payload)
            coords_t, weights_t, radii_t, mask_t = tensors[:4]
            centers_t = tensors[4] if centers_in is not None else None
            cfg = self._config
            return voxelize_batch(
                coords_t,
                weights_t,
                radii_t,
                mask_t,
                centers_t,
                spec=cfg.grid,
                density_type=cfg.density_type,
                sigma=cfg.sigma,
                channelwise=channelwise,
                impl=self._impl,
                radii_batched=isinstance(radii_in, list),
                out_dtype=out_dtype,
                transforms=Transforms(tensors[-1] if rot or trans else None, rot, trans),
            )

    def _staging_ring(self, dev: torch.device) -> PinnedRing | None:
        """The pinned ring forward_batch stages through on the card: two
        slots, so a call waits only for the kernels of the call before the
        last.  None on the CPU, where each call writes a fresh buffer that
        its tensors keep."""
        if dev.type != "cuda":
            return None
        if self._ring is None or self._ring.device != dev:
            self._ring = PinnedRing(2, dev)
        return self._ring

    # ----------------------------------------------------------------- engine

    def _run(self, coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation, *,
             channelwise: bool):
        """center shift -> random rigid transform -> deposit."""
        dev = self._compute_device()
        coords = torch.as_tensor(coords_p, device=dev)
        if center is not None:
            coords = coords - torch.as_tensor(_host(center, self.fp).reshape(1, 3), device=dev)
        if random_rotation or (random_translation and random_translation > 0.0):
            gen = _generator(key) if key is not None else self.next_generator()
            coords = do_random_transform(gen, coords, None, float(random_translation), bool(random_rotation))
        cfg = self._config
        return voxelize(
            coords,
            torch.as_tensor(weights_p, device=dev),
            torch.as_tensor(radii_arr, device=dev),
            spec=cfg.grid,
            density_type=cfg.density_type,
            sigma=cfg.sigma,
            mask=torch.as_tensor(mask, device=dev),
            channelwise_radii=channelwise,
            impl=self._impl,
        )

    # ----------------------------------------------------------------- checks
    # Argument contracts: which arguments must be scalar / arrays of what shape.
    # Violations raise ValueError.

    def _check_radii(self, radii, *, num_atoms: int, num_channels: int | None):
        if self.is_radii_type_scalar:
            if not np.isscalar(radii):
                raise ValueError(f"radii_type='scalar' expects a python scalar, got shape {np.shape(radii)}")
            return
        if self.is_radii_type_channel_wise:
            want, kind = num_channels, "channel"
        else:
            want, kind = num_atoms, "atom"
        if np.isscalar(radii):
            raise ValueError(f"radii_type='{self.radii_type}' expects one radius per {kind} ({want},), got a scalar")
        got = tuple(np.shape(radii))
        if self.is_radii_type_channel_wise and num_channels is not None and len(got) == 1:
            if got[0] < want:
                raise ValueError(f"channel-wise radii {got} cover fewer channels than required ({want})")
        elif got != (want,):
            raise ValueError(f"radii shape {got} != one per {kind} ({want},)")

    def _check_out_grid(self, out_grid, num_channels: int | None, exact: bool):
        if out_grid is None:
            return
        d = self.dimension
        got = tuple(out_grid.shape)
        if got[1:] != (d, d, d):
            raise ValueError(f"out_grid spatial shape {got[1:]} != {(d, d, d)}")
        if num_channels is not None:
            if exact and got[0] != num_channels:
                raise ValueError(f"out_grid has {got[0]} channels, expected {num_channels}")
            if not exact and got[0] < num_channels:
                raise ValueError(f"out_grid has {got[0]} channels, needs at least {num_channels}")

    def _check_args_features(self, coords, features, radii, out_grid=None):
        v = coords.shape[0]
        if features.ndim != 2 or features.shape[0] != v:
            raise ValueError(f"features must be (num_atoms={v}, C), got {features.shape}")
        self._check_radii(radii, num_atoms=v, num_channels=features.shape[1])
        self._check_out_grid(out_grid, features.shape[1], exact=True)

    def _check_args_types(self, coords, types, radii, out_grid=None):
        v = coords.shape[0]
        if types.shape != (v,):
            raise ValueError(f"types must be (num_atoms={v},), got {types.shape}")
        c = int(types.max()) + 1 if v > 0 else 1
        self._check_radii(radii, num_atoms=v, num_channels=c)
        self._check_out_grid(out_grid, c, exact=False)

    def _check_args_single(self, coords, radii, out_grid=None):
        if self.is_radii_type_channel_wise:
            raise ValueError("forward_single has no channel axis; channel-wise radii cannot apply")
        self._check_radii(radii, num_atoms=coords.shape[0], num_channels=None)
        self._check_out_grid(out_grid, 1, exact=True)


# ------------------------------------------------------------------- helpers


def _forward_only(*args):
    """Raise for any tensor argument (or tensor in a list or tuple of them)
    that requires grad: a forward would otherwise cut it from the graph."""
    for a in args:
        if type(a) is np.ndarray:  # the common case, before a tensor's slow isinstance
            continue
        if isinstance(a, (list, tuple)):
            _forward_only(*a)
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            raise NotImplementedError(
                "Voxelizer.forward_* is not differentiable (as in the JAX package); for gradients call "
                "molvoxel_torch.ops.voxelize.voxelize, molvoxel_torch.ops.batch.voxelize_batch or "
                "molvoxel_torch.nn.VoxelizeLayer"
            )


def _host(array, dtype) -> np.ndarray:
    """numpy view of an array or tensor (tensors are copied to the host)."""
    if type(array) is not np.ndarray and isinstance(array, torch.Tensor):  # a tensor's isinstance is slow
        array = array.detach().cpu().numpy()
    return np.asarray(array, dtype=dtype)


def _pad_coords(coords: np.ndarray, vp: int, fp) -> tuple[np.ndarray, np.ndarray]:
    v = coords.shape[0]
    out = np.zeros((vp, 3), dtype=fp)
    out[:v] = coords
    mask = np.zeros((vp,), dtype=bool)
    mask[:v] = True
    return out, mask


def _pad_rows(arr: np.ndarray, vp: int) -> np.ndarray:
    out = np.zeros((vp,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _pad_vec(vec: np.ndarray, vp: int, fill: float = 0.0) -> np.ndarray:
    out = np.full((vp,), fill, dtype=vec.dtype)
    out[: vec.shape[0]] = vec
    return out


def _finalize(result: torch.Tensor, out_grid):
    """Honor the in-place out_grid contract (numpy array or tensor)."""
    if out_grid is None:
        return result
    c = result.shape[0]
    if isinstance(out_grid, np.ndarray):
        host = result.cpu().numpy()
        out_grid[:c] = host
        out_grid[c:] = 0.0
        return out_grid
    if isinstance(out_grid, torch.Tensor):
        out_grid[:c].copy_(result)
        out_grid[c:].zero_()
        return out_grid
    raise TypeError(f"out_grid must be a numpy array or a torch tensor, got {type(out_grid).__name__}")


# ----------------------------------------------------------------- factories


def create_voxelizer(
    resolution: float = 0.5,
    dimension: int = 64,
    radii_type: str = "scalar",
    density_type: str = "gaussian",
    library: str = "torch",
    **kwargs,
) -> Voxelizer:
    """Voxelizer factory; ``device`` defaults to "cuda".  ``library`` is
    accepted for source compatibility ("jax", "numpy", "numba", "torch")."""
    if library not in ("jax", "numpy", "numba", "torch"):
        raise ValueError(f"unknown library {library!r}")
    return Voxelizer(resolution, dimension, radii_type, density_type, **kwargs)


def create_random_transform(
    random_translation: float = 0.0,
    random_rotation: bool = False,
    library: str = "torch",
    **kwargs,
) -> RandomTransform:
    """Random transform factory (``library`` as in create_voxelizer)."""
    if library not in ("jax", "numpy", "numba", "torch"):
        raise ValueError(f"unknown library {library!r}")
    return RandomTransform(random_translation, random_rotation)


def default_backend_impl(device="cuda") -> str:
    """The implementation a voxelizer on ``device`` runs: "cuda" (the
    kernels) on the card, the default; "dense" on the CPU.  It reports and
    does not probe: a forward on a CUDA voxelizer with no card raises."""
    return "cuda" if torch.device(device).type == "cuda" else "dense"
