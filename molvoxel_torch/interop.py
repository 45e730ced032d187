"""PyTorch interoperability: grids into torch training loops.

Counterpart of ``molvoxel_tpu/interop.py``, with its names and arguments.
There the module bridges JAX arrays to torch; here every grid already is a
torch tensor, so:

- ``to_torch(array)`` / ``from_torch(tensor)``: dtype-faithful conversion
  between numpy arrays and torch tensors.  bfloat16 and float8_e4m3fn numpy
  arrays (ml_dtypes items, as the JAX package hands them over) cross
  bit-exact through an int16 / uint8 view, as data/gridstore.py reads its
  raw items; a tensor passes through ``to_torch`` unchanged.
- ``VoxelGridDataset``: a ``torch.utils.data.IterableDataset`` that streams a
  multi-record SDF through the feeder (data.feed.SDFBatchFeeder) and the
  stream's dispatch (parallel.stream.StreamingVoxelizer) on the card,
  yielding ready ``(grids, num_atoms)`` batches: batch k+1 is launched
  before batch k is handed over.
- ``GridStoreDataset``: a map-style dataset over a precomputed grid store.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "to_torch",
    "from_torch",
    "VoxelGridDataset",
    "GridStoreDataset",
]

# numpy dtype names (ml_dtypes) without a numpy counterpart: the torch type
# and the integer type of the same size to view them through
_BIT_VIEWS = {"bfloat16": (torch.bfloat16, np.int16), "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def to_torch(array) -> torch.Tensor:
    """numpy array (or tensor) -> torch.Tensor, preserving dtype and bits.

    A tensor is returned as it is.  A numpy array is shared with the
    tensor when it is contiguous and writable, else copied once (torch has
    no read-only tensors).  bfloat16 and float8_e4m3fn arrays are viewed as
    int16 / uint8 and reinterpreted on the torch side, with no rounding."""
    if isinstance(array, torch.Tensor):
        return array
    arr = np.asarray(array)
    if not arr.flags.writeable:
        arr = np.array(arr)
    arr = np.ascontiguousarray(arr)
    view = _BIT_VIEWS.get(arr.dtype.name)
    if view is not None:
        return torch.from_numpy(arr.view(view[1])).view(view[0])
    return torch.from_numpy(arr)


def from_torch(tensor) -> np.ndarray:
    """torch.Tensor -> numpy array on the host, detached.

    bfloat16 and float8 tensors are upcast to float32 (numpy has no such
    types); every other dtype converts as it is."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16 or str(t.dtype).startswith("torch.float8"):
        t = t.float()
    return t.numpy()


class VoxelGridDataset(torch.utils.data.IterableDataset):
    """Stream an SDF as voxelized torch batches.

    Each iteration yields ``(grids, num_atoms)``:

    - ``grids``: (B, C, D, H, W) in ``out_dtype`` on ``device``: one channel
      per symbol, and a catch-all with ``unknown``;
    - ``num_atoms``: int64 (B,) on the CPU, the true atom counts (0 marks a
      record without heavy atoms or a padded tail slot; both grids are zero).

    Use with ``torch.utils.data.DataLoader(ds, batch_size=None)``: batching
    happens here (fixed shapes), the DataLoader just iterates.  Each batch
    is staged onto the card through the stream's pinned buffers and
    launched before the previous batch is yielded.

    ``augment=True`` applies a fresh random rotation (and
    ``random_translation`` A jitter) per molecule per pass.

    ``DataLoader(ds, batch_size=None, num_workers=N)``: each worker reads a
    disjoint stripe of the file's record shards, with its own generator
    (seed ``seed + 1000003 * worker_id + epoch``).  Pass
    ``multiprocessing_context="spawn"`` with ``num_workers > 0``.  CUDA
    tensors should not cross worker processes: give workers
    ``device="cpu"``, or keep ``num_workers=0`` so the card's work stays in
    the main process.  ``shuffle=True`` reshuffles the shard order every
    epoch (from ``seed`` + epoch; records within a shard, about 8 MB, keep
    file order; ``feeder_kwargs={"target_shard_bytes": ...}`` mixes finer).
    """

    def __init__(
        self,
        path: str | Path,
        symbols: Sequence[str],
        spec=None,
        *,
        batch_size: int = 64,
        unknown: bool = False,
        density_type: str = "gaussian",
        sigma: float = 0.5,
        radii: float = 1.0,
        out_dtype: str = "float32",
        augment: bool = False,
        random_translation: float = 0.0,
        seed: int = 0,
        workers: int = 2,
        shuffle: bool = False,
        feeder_kwargs: dict | None = None,
        device="cuda",
    ):
        from .core.config import GridSpec
        from .parallel.stream import _device

        super().__init__()
        self.path = str(path)
        self.symbols = list(symbols)
        self.spec = spec if spec is not None else GridSpec(0.5, 64)
        self.batch_size = batch_size
        self.unknown = unknown
        self.density_type = density_type
        self.sigma = sigma
        self.radii = radii
        self.out_dtype = out_dtype
        self.augment = augment
        self.random_translation = random_translation
        self.seed = seed
        self.workers = workers
        self.shuffle = shuffle
        self.feeder_kwargs = dict(feeder_kwargs or {})
        self.device = _device(device)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch for shuffle order and augmentation.

        Required with ``DataLoader(num_workers>0)`` (call before each epoch,
        like ``DistributedSampler.set_epoch``); single-process iteration
        advances the epoch automatically."""
        self._epoch = int(epoch)

    def _feeder(self, worker_id: int = 0, num_workers: int = 1, epoch: int = 0):
        from .data.feed import SDFBatchFeeder

        return SDFBatchFeeder(
            self.path,
            self.symbols,
            batch_size=self.batch_size,
            unknown=self.unknown,
            workers=self.workers,
            shuffle_seed=self.seed + epoch if self.shuffle else None,
            span_offset=worker_id,
            span_stride=num_workers,
            **self.feeder_kwargs,
        )

    def __iter__(self) -> Iterator[tuple]:
        from .data.feed import prefetch_iter
        from .parallel.stream import StreamingVoxelizer

        info = torch.utils.data.get_worker_info()
        worker_id = info.id if info is not None else 0
        num_workers = info.num_workers if info is not None else 1
        epoch = self._epoch
        if info is None:
            # single-process: each pass is a new epoch.  With num_workers>0
            # the parent never runs __iter__, so worker copies would restart
            # at the pickled epoch every time: call ``ds.set_epoch(e)``
            self._epoch += 1

        sv = StreamingVoxelizer(
            self.spec,
            batch_size=self.batch_size,
            density_type=self.density_type,
            sigma=self.sigma,
            radii=self.radii,
            random_rotation=self.augment,
            random_translation=self.random_translation if self.augment else 0.0,
            out_dtype=self.out_dtype,
            seed=self.seed + 1000003 * worker_id + epoch,
            device=self.device,
        )
        ring = sv._staging_ring()
        radii_dev = None
        pending = None
        # parse and assembly run one batch ahead on a worker thread
        for batch in prefetch_iter(iter(self._feeder(worker_id, num_workers, epoch))):
            if radii_dev is None or radii_dev.shape[0] != batch.padded_atoms:
                radii_dev = torch.full((batch.padded_atoms,), float(self.radii), dtype=torch.float32,
                                       device=self.device)
            images = sv._dispatch(batch, radii_dev, ring)  # launched, not waited for
            if pending is not None:
                yield self._emit(*pending)
            pending = (images, batch)
        if pending is not None:
            yield self._emit(*pending)

    @staticmethod
    def _emit(images, batch):
        return images, torch.from_numpy(batch.num_atoms.astype(np.int64))


class GridStoreDataset(torch.utils.data.Dataset):
    """Map-style torch Dataset over a precomputed grid store.

    The precompute-then-train workflow (``voxelize -o store/`` as the
    precompute step): random access into mmap'd shards, so a shuffling
    DataLoader works out of the box and only the touched grids page in.
    Each item is ``(grid, num_atoms)``, the grid a CPU tensor of the store's
    dtype.  DataLoader workers reopen the store (the mmaps are not pickled).
    """

    def __init__(self, root):
        from .data.gridstore import GridShardReader

        self.root = Path(root)
        self.reader = GridShardReader(self.root)
        self._num_atoms = self.reader.num_atoms()

    def __getstate__(self):
        return {"root": self.root}

    def __setstate__(self, state):
        self.__init__(state["root"])

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int):
        return self.reader[i], int(self._num_atoms[i])

    @property
    def channels(self):
        return self.reader.channels
