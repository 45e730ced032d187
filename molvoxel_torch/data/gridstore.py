"""Sharded on-disk grid store: bounded-memory output for library-scale runs.

The reference has no bulk output path at all (each ``forward`` returns one
array to the caller, reference molvoxel/voxelizer/base/voxelizer.py:101);
holding every batch in host RAM before one ``np.savez_compressed`` takes
about 52 GB for 50k molecules at 64^3 x 4 channels in f32.  This store
streams instead: each flush writes one ``.npy`` shard (plain, mmap-able)
as soon as enough batches have landed, so peak host memory is O(shard), and a
JSON manifest makes the directory self-describing and resumable to read.

Layout::

    store/
      manifest.json     {"num_molecules", "dtype", "grid_shape", "shards":
                         [{"file", "count"}...], "resolution", "dimension",
                         "channels"}
      shard_00000.npy   (n_0, C, D, H, W)
      shard_00001.npy   ...
      num_atoms.npy     (N,) int32 per-record atom counts (alignment record:
                         a 0 marks a record that voxelized to an empty grid)

Readers: ``GridShardReader`` (lazy, mmap per shard) or ``read_grid_shards``
(materialize everything — tests / small stores).  Both give CPU torch
tensors.

The layout and manifest are the JAX package's, byte for byte, so a store
written by either package reads in the other.  bfloat16 and float8_e4m3fn
grids (which numpy has no dtype for) are stored as raw 2- and 1-byte void
(``V2`` / ``V1``) and read back through an int16 / uint8 view and
``torch.Tensor.view``; the manifest's ``dtype`` names the real type.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["GridShardWriter", "GridShardReader", "read_grid_shards"]

_MANIFEST = "manifest.json"
# dtypes numpy lacks: stored as raw void of their size, viewed back through
# an integer of that size
_RAW = {"bfloat16": (torch.bfloat16, np.int16, "V2"), "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, "V1")}


def host_array(images) -> tuple[np.ndarray, str]:
    """(numpy array to save, dtype name for the manifest) of a batch given
    as a torch tensor on any device, or a numpy array."""
    if isinstance(images, torch.Tensor):
        t = images.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _RAW:
            _, int_type, void = _RAW[name]
            return t.view(getattr(torch, np.dtype(int_type).name)).numpy().view(void), name
        return t.numpy(), name
    arr = np.asarray(images)
    return arr, str(arr.dtype)


def _as_tensor(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    """A stored array -> CPU torch tensor of the manifest's ``dtype``."""
    if dtype in _RAW:
        torch_type, int_type, _ = _RAW[dtype]
        return torch.from_numpy(np.array(arr).view(int_type)).view(torch_type)
    return torch.from_numpy(np.array(arr))


class GridShardWriter:
    """Append device batches; flush ``.npy`` shards at ``target_bytes``.

    ``append`` takes the (B, C, D, H, W) batch and its (B,) num_atoms; tail
    padding (virtual molecules appended by the feeder's pad_tail) is cut by
    ``finalize(num_real)`` — callers pass the real record count and the writer
    trims the final shard to it.
    """

    def __init__(
        self,
        root: str | Path,
        channels: list[str],
        *,
        resolution: float,
        dimension: int,
        target_bytes: int = 64 << 20,
        extra_manifest: dict | None = None,
        resume: bool = False,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.channels = list(channels)
        self.resolution = float(resolution)
        self.dimension = int(dimension)
        self.target_bytes = int(target_bytes)
        # e.g. {"process_index": k, "num_processes": n} for per-host shards
        # of a multi-process stream
        self.extra_manifest = dict(extra_manifest or {})
        self._resume = bool(resume)
        self._buf: list[np.ndarray] = []
        self._buf_bytes = 0
        self._atoms: list[np.ndarray] = []
        self._shards: list[dict] = []
        self._rows = 0
        self._dtype: str | None = None
        self._grid_shape: list[int] | None = None
        self._finalized = False
        if resume:
            self._load_existing()

    def _load_existing(self) -> None:
        """Adopt a prior (possibly interrupted) run's flushed shards.

        Every flush writes a provisional manifest (``final: false``), so a
        crashed run leaves a valid prefix on disk; a resumed writer keeps
        those shards and continues appending after them.  Only FLUSHED rows
        survive a crash — rows still buffered in the dead process are gone,
        and the resuming caller must re-feed everything past ``rows``."""
        mp = self.root / _MANIFEST
        if not mp.exists():
            return
        m = json.loads(mp.read_text())
        if m.get("format") != "molvoxel-tpu-gridstore-v1":
            return
        self._shards = [dict(x) for x in m.get("shards", [])]
        self._rows = sum(int(x["count"]) for x in self._shards)
        self._dtype = m.get("dtype")
        self._grid_shape = m.get("grid_shape")
        na = self.root / "num_atoms.npy"
        if na.exists():
            atoms = np.load(na)
            self._atoms = [np.asarray(atoms[: self._rows], np.int32)]

    @property
    def rows(self) -> int:
        """Rows durably flushed to shards (resume skip count)."""
        return self._rows

    # -- context manager: guarantees a valid manifest even without finalize
    def __enter__(self) -> "GridShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and not self._finalized:
            self.finalize(self._rows + sum(a.shape[0] for a in self._buf))

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def append(self, images, num_atoms: np.ndarray | None = None) -> None:
        """Buffer one (B, C, D, H, W) batch: a torch tensor on any device
        (copied to the host here) or a numpy array."""
        images, dtype = host_array(images)
        if self._dtype is None:
            self._dtype = dtype  # np.load sees bf16 / fp8 as raw void
            self._grid_shape = list(images.shape[1:])
        self._buf.append(images)
        self._buf_bytes += images.nbytes
        self._atoms.append(
            np.asarray(num_atoms, np.int32)
            if num_atoms is not None
            else np.full((images.shape[0],), -1, np.int32)
        )
        if self._buf_bytes >= self.target_bytes:
            self._flush()

    def _flush(self, limit: int | None = None) -> None:
        if not self._buf:
            return
        arr = self._buf[0] if len(self._buf) == 1 else np.concatenate(self._buf, axis=0)
        if limit is not None:
            arr = arr[: max(limit - self._rows, 0)]
        self._buf, self._buf_bytes = [], 0
        if arr.shape[0] == 0:
            return
        fname = f"shard_{len(self._shards):05d}.npy"
        np.save(self.root / fname, arr)
        self._shards.append({"file": fname, "count": int(arr.shape[0])})
        self._rows += int(arr.shape[0])
        if limit is None:
            # provisional manifest: a crash after this point can resume from
            # the flushed prefix (the atom counts flush alongside)
            np.save(self.root / "num_atoms.npy", np.concatenate(self._atoms)[: self._rows])
            self._write_manifest(self._rows, final=False)

    def finalize(self, num_molecules: int) -> None:
        """Flush the tail, trim virtual padding, write the manifest."""
        self._flush(limit=num_molecules)
        atoms = (
            np.concatenate(self._atoms)[:num_molecules]
            if self._atoms
            else np.zeros((0,), np.int32)
        )
        np.save(self.root / "num_atoms.npy", atoms)
        self._write_manifest(num_molecules, final=True)
        self._atoms = [atoms]
        self._rows = int(min(num_molecules, self._rows))
        self._finalized = True

    def _write_manifest(self, num_molecules: int, *, final: bool) -> None:
        manifest = {
            "format": "molvoxel-tpu-gridstore-v1",
            "num_molecules": int(min(num_molecules, self._rows)),
            "dtype": self._dtype,
            "grid_shape": self._grid_shape,
            "shards": self._shards,
            "resolution": self.resolution,
            "dimension": self.dimension,
            "channels": self.channels,
            "final": bool(final),
            **self.extra_manifest,
        }
        tmp = self.root / (_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        tmp.replace(self.root / _MANIFEST)


class GridShardReader:
    """Lazy reader over a gridstore directory; shards are mmap'd on demand
    and items come back as CPU torch tensors."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        m = json.loads((self.root / _MANIFEST).read_text())
        if m.get("format") != "molvoxel-tpu-gridstore-v1":
            raise ValueError(f"not a gridstore: {self.root}")
        self.manifest = m
        self.num_molecules = int(m["num_molecules"])
        self.channels = list(m["channels"])
        self._starts = np.cumsum([0] + [s["count"] for s in m["shards"]])
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_molecules

    def _shard(self, si: int) -> np.ndarray:
        """The raw (mmap'd) array of shard ``si``; bf16 / fp8 as void."""
        if si not in self._cache:
            self._cache[si] = np.load(self.root / self.manifest["shards"][si]["file"], mmap_mode="r")
        return self._cache[si]

    def __getitem__(self, i: int) -> torch.Tensor:
        if i < 0:
            i += self.num_molecules
        if not 0 <= i < self.num_molecules:
            raise IndexError(i)
        si = int(np.searchsorted(self._starts, i, side="right") - 1)
        return _as_tensor(self._shard(si)[i - self._starts[si]], self.manifest.get("dtype"))

    def num_atoms(self) -> np.ndarray:
        return np.load(self.root / "num_atoms.npy")


def read_grid_shards(root: str | Path) -> tuple[torch.Tensor, dict]:
    """Materialize a whole gridstore -> ((N, C, D, H, W) CPU tensor, manifest)."""
    r = GridShardReader(root)
    if r.num_molecules == 0:
        return torch.zeros((0,), dtype=torch.float32), r.manifest
    parts = [r._shard(i) for i in range(len(r.manifest["shards"]))]
    return _as_tensor(np.concatenate(parts, axis=0)[: r.num_molecules], r.manifest.get("dtype")), r.manifest
