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

import dataclasses

import numpy as np
import torch

from ..core.config import DENSITY_TYPE_LIST, RADII_TYPE_LIST, GridSpec, VoxelizerConfig, small_atom_bucket
from ..core.transform import RandomTransform, do_random_transform
from ..ops.deposit import check_kernel_dtype
from ..ops.voxelize import default_impl, voxelize  # noqa: F401  (default_impl: the JAX package's name here)


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
    card on the kernel (its threshold row) or the separable product, by
    the separable product's FLOPs against thresholds measured on an H100
    (ops/voxelize.notrunc_use_kernel)."""

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
        from ..data.pipeline import pad_point_clouds, types_to_onehot
        from ..ops.batch import voxelize_batch

        if len(clouds) == 0:
            raise ValueError("forward_batch needs at least one molecule")
        _forward_only(clouds, radii, centers)
        dev = self._compute_device()
        if np.ndim(clouds[0][1]) == 1:  # types -> one-hot
            num_c = num_channels if num_channels is not None else max(
                int(_host(ch, None).max()) + 1 for _, ch in clouds
            )
            clouds = [(_host(crd, np.float32), types_to_onehot(_host(ch, None), num_c)) for crd, ch in clouds]
        else:
            clouds = [(_host(crd, np.float32), _host(ch, np.float32)) for crd, ch in clouds]
        batch = pad_point_clouds(clouds, centers=centers)
        b, vp = batch.batch_size, batch.padded_atoms

        channelwise = self.is_radii_type_channel_wise
        radii_batched = False
        if channelwise:
            radii_arr = _host(radii, np.float32)
        elif np.isscalar(radii):
            radii_arr = np.full((vp,), float(radii), np.float32)
        else:
            radii_arr = np.ones((b, vp), np.float32)
            for i, r in enumerate(radii):
                r = _host(r, np.float32)
                radii_arr[i, : r.shape[0]] = r
            radii_batched = True

        if key is not None:
            gen = _generator(key)
        elif random_rotation or random_translation > 0:
            gen = self.next_generator()
        else:
            gen = None
        cfg = self._config
        return voxelize_batch(
            torch.as_tensor(batch.coords, device=dev),
            torch.as_tensor(batch.weights, device=dev),
            torch.as_tensor(radii_arr, device=dev),
            torch.as_tensor(batch.mask, device=dev),
            None if batch.centers is None else torch.as_tensor(batch.centers, device=dev),
            gen,
            float(random_translation),
            spec=cfg.grid,
            density_type=cfg.density_type,
            sigma=cfg.sigma,
            random_rotation=bool(random_rotation),
            channelwise=channelwise,
            impl=self._impl,
            radii_batched=radii_batched,
            out_dtype=out_dtype,
        )

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
    if isinstance(array, torch.Tensor):
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
