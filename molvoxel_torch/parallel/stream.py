"""Streaming library voxelization.

The reference processes molecules one Python call at a time with no batching,
metrics or resumability.  This module turns a molecule stream into padded
batches (data/pipeline.py, data/feed.py), voxelizes them on the card, and adds
the operational layer a production run needs:

- overlap: each batch's arrays are staged onto the card through pinned
  host buffers on a side CUDA stream, so the copy runs beside the previous
  batch's kernels, and the batch is launched before the previous result is
  handed to the consumer (CUDA launches are asynchronous);
- observability: molecules/s counters (``StreamStats``);
- checkpoint/resume: an optional JSON manifest ``{"molecules_done", "ts"}``
  records the molecules completed; a restarted run skips them.

``stream_checksum`` is the throughput-shaped loop: compact superbatches
(int8 types, or one int16 wire array) are staged onto the card through a ring
of pinned host buffers on a side CUDA stream from a prefetch thread, and each
chunk rebuilds its one-hot weights, mask and per-type radii on the card,
transforms, deposits through the kernel and adds its sum to a device
accumulator.  The loop makes no host sync; the checksum is read once, at the
end.  Counterpart of ``molvoxel_tpu/parallel/stream.py``; given a mesh
(parallel/mesh.py), ``StreamingVoxelizer`` routes batches through the
data-parallel ``voxelize_batch_dp`` as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections.abc import Callable, Iterable
from pathlib import Path

import numpy as np
import torch

from ..core.config import GridSpec
from ..data.pipeline import PaddedBatch, iter_batches
from ..ops.batch import voxelize_batch, voxelize_batch_sliced
from .sharded import voxelize_batch_dp


@dataclasses.dataclass
class StreamStats:
    molecules: int = 0
    batches: int = 0
    skipped: int = 0
    wall_seconds: float = 0.0

    @property
    def mols_per_second(self) -> float:
        return self.molecules / self.wall_seconds if self.wall_seconds > 0 else 0.0


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the stream runs on CUDA by default and no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StreamingVoxelizer:
    """Voxelize a molecule stream in fixed-shape batches with metrics/resume.

    ``device``: "cuda" (default) or "cpu".  ``mesh`` (``make_mesh``): a
    batch with shared radii whose size divides by the mesh's data axis goes
    through ``voxelize_batch_dp`` (every rank streams the same batches and
    voxelizes its rows; the consumer gets the DTensor), the rest as without
    one; the transforms are drawn as without a mesh, so the grids are the
    same.  ``materialize`` exists only for the JAX package's signature
    (there it fences XLA's folding of the grid) and is ignored: the kernel
    always writes every grid."""

    def __init__(
        self,
        spec: GridSpec,
        *,
        batch_size: int = 64,
        density_type: str = "gaussian",
        sigma: float = 0.5,
        radii: float = 1.0,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        bucket: int | None = None,
        mesh=None,
        seed: int = 0,
        checkpoint_path: str | Path | None = None,
        checkpoint_every: int = 10,
        out_dtype: str = "float32",
        presorted: bool = False,
        materialize: bool = False,
        slab_depth: int | None = None,
        device="cuda",
    ):
        self.spec = spec
        self.batch_size = batch_size
        self.density_type = density_type
        self.sigma = sigma
        self.radii = radii
        self.random_translation = random_translation
        self.random_rotation = random_rotation
        self.bucket = bucket
        self.mesh = mesh
        self.checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        self.checkpoint_every = checkpoint_every
        self.out_dtype = out_dtype
        self.presorted = presorted
        self.materialize = materialize
        # full-grid assembly for depths beyond one launch (256^3+): depth
        # slabs assembled on the host (ops/batch.py voxelize_batch_sliced).
        # None = single-launch full depth.
        self.slab_depth = slab_depth
        self.device = _device(device)
        self._generator = torch.Generator().manual_seed(int(seed))

    # ------------------------------------------------------------- checkpoint

    def _load_checkpoint(self) -> int:
        if self.checkpoint_path and self.checkpoint_path.exists():
            return int(json.loads(self.checkpoint_path.read_text()).get("molecules_done", 0))
        return 0

    def _save_checkpoint(self, molecules_done: int) -> None:
        if self.checkpoint_path:
            tmp = self.checkpoint_path.with_suffix(".tmp")
            tmp.write_text(json.dumps({"molecules_done": molecules_done, "ts": time.time()}))
            tmp.replace(self.checkpoint_path)

    # ------------------------------------------------------------------ drive

    def _dispatch(self, batch: PaddedBatch, radii_dev, ring):
        per_atom = batch.radii is not None
        weights = batch.weights
        if weights is None:  # compact batch: expand the one-hot on the host
            t = batch.types
            eye = np.eye(batch.num_channels, dtype=np.float32)
            weights = np.where((t >= 0)[..., None], eye[np.maximum(t, 0)], 0.0).astype(np.float32)
        arrays = [batch.coords, weights, batch.mask]
        arrays += [batch.radii] if per_atom else []
        arrays += [] if batch.centers is None else [batch.centers]
        if ring is None:
            views = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        else:  # a copy from pageable memory would wait for the previous batch's kernels
            views, event = ring.stage(arrays)
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            for v in views:
                v.record_stream(main)
        coords, weights, mask = views[:3]
        radii = views[3] if per_atom else radii_dev
        centers = None if batch.centers is None else views[-1]
        args = (coords, weights, radii, mask, centers, self._generator, self.random_translation)
        kw = dict(
            spec=self.spec,
            density_type=self.density_type,
            sigma=self.sigma,
            random_rotation=self.random_rotation,
            out_dtype=self.out_dtype,
            presorted=self.presorted,
            radii_batched=per_atom,
        )
        with torch.no_grad():
            if self.slab_depth is not None:
                return voxelize_batch_sliced(*args, slab_depth=self.slab_depth, **kw)
            if self.mesh is not None and not per_atom and batch.batch_size % self.mesh.size(0) == 0:
                kw.pop("radii_batched")
                return voxelize_batch_dp(*args, mesh=self.mesh, **kw)
            return voxelize_batch(*args, **kw)

    def _staging_ring(self):
        """The pinned ring ``_dispatch`` stages batches through (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return _PinnedRing(2, self.device, torch.cuda.Stream(self.device))

    def run(
        self,
        clouds: Iterable[tuple[np.ndarray, np.ndarray]],
        consumer: Callable[[torch.Tensor, PaddedBatch], None] | None = None,
        log_every: int = 0,
    ) -> StreamStats:
        """Drive the stream; ``consumer(images, batch)`` receives each result.

        images is the (B, C, D, H, W) tensor on the device (on the host when
        ``slab_depth`` assembles full grids); padded tail molecules (mask
        all-False) produce all-zero grids.
        """
        source = iter(clouds)
        skip = self._load_checkpoint()
        for _ in range(skip):
            next(source, None)
        return self.run_batches(
            iter_batches(source, self.batch_size, bucket=self.bucket),
            consumer,
            log_every=log_every,
            skipped=skip,
        )

    def run_batches(
        self,
        batches: Iterable[PaddedBatch],
        consumer: Callable[[torch.Tensor, PaddedBatch], None] | None = None,
        log_every: int = 0,
        skipped: int = 0,
    ) -> StreamStats:
        """Drive a pre-built PaddedBatch stream (e.g. data.feed.SDFBatchFeeder).

        Callers that batch upstream (the vectorized feeder) enter here
        directly.  Resume semantics: ``skipped`` molecules were already done;
        checkpoints record ``skipped + molecules``.
        """
        stats = StreamStats()
        stats.skipped = skipped
        t0 = time.time()
        radii_dev = None
        ring = self._staging_ring()
        pending: tuple[torch.Tensor, PaddedBatch] | None = None

        def flush(p):
            if p is not None and consumer is not None:
                consumer(p[0], p[1])

        for batch in batches:
            if batch.radii is None and (radii_dev is None or radii_dev.shape[0] != batch.padded_atoms):
                radii_dev = torch.full((batch.padded_atoms,), float(self.radii), dtype=torch.float32,
                                       device=self.device)
            images = self._dispatch(batch, radii_dev, ring)  # launched, not waited for
            flush(pending)  # consume the previous batch while this one runs
            pending = (images, batch)
            stats.batches += 1
            stats.molecules += int((batch.num_atoms > 0).sum())
            if self.checkpoint_path and stats.batches % self.checkpoint_every == 0:
                _synchronize(self.device)
                self._save_checkpoint(skipped + stats.molecules)
            if log_every and stats.batches % log_every == 0:
                dt = time.time() - t0
                print(f"[stream] {stats.molecules} mols, {stats.batches} batches, {stats.molecules / dt:.0f} mols/s")
        flush(pending)
        _synchronize(self.device)
        stats.wall_seconds = time.time() - t0
        self._save_checkpoint(skipped + stats.molecules)
        return stats


# ------------------------------------------------------- superbatch stream


class _PinnedRing:
    """``depth`` pinned host buffers, each reused only after the event
    recorded behind its last host-to-device copy has completed.  ``stage``
    packs a superbatch's arrays into the next buffer and copies it to the
    card in ONE transfer on ``stream``; it returns device views of the
    arrays and the event the consumer must wait for."""

    def __init__(self, depth: int, device: torch.device, stream):
        self.device, self.stream = device, stream
        self.slots: list[list] = [[None, None] for _ in range(depth)]  # [pinned uint8, event]
        self.next = 0

    def stage(self, arrays: list[np.ndarray]):
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // 16) * 16
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot[1] is not None:
            slot[1].synchronize()  # its previous copy has left the buffer
        if slot[0] is None or slot[0].numel() < total:
            slot[0] = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        host = slot[0].numpy()
        for a, off in zip(arrays, offsets):
            host[off:off + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = slot[0][:total].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot[1] = event
        views = [dev[off:off + a.nbytes].view(getattr(torch, a.dtype.name)).reshape(a.shape)
                 for a, off in zip(arrays, offsets)]
        return views, event


def _scan_chunks(coords, types, centers, generator, acc, *, chunk, num_channels, radii, rtab, random_translation,
                 spec, density_type, sigma, random_rotation, out_dtype, impl, presorted, witness):
    """One superbatch, chunk by chunk, into the device accumulator ``acc``.

    Each chunk rebuilds its one-hot weights and mask from the int types
    (-1 = padding) and, with ``rtab``, its per-type radii, on the device;
    draws its transforms from ``generator`` (on the device when the data
    is); deposits; and adds the sum of its grids (``witness``: of its first
    molecule's grid only) to ``acc``.  Nothing here waits for the device."""
    b = types.shape[0]
    chan = torch.arange(num_channels, device=types.device)
    for c0 in range(0, b, chunk):
        t = types[c0:c0 + chunk].to(torch.int64)
        mask = t >= 0
        w = (t[..., None] == chan).to(torch.float32)
        r, batched = radii, False
        if rtab is not None:
            r = torch.where(mask, rtab[t.clamp(min=0)], 1.0)
            batched = True
        out = voxelize_batch(
            coords[c0:c0 + chunk], w, r, mask, None if centers is None else centers[c0:c0 + chunk], generator,
            random_translation, spec=spec, density_type=density_type, sigma=sigma, random_rotation=random_rotation,
            impl=impl, radii_batched=batched, out_dtype=out_dtype, presorted=presorted,
        )
        consumed = out[:1] if witness else out
        if consumed.dtype == torch.float8_e4m3fn:  # widened exactly; sum has no float8 kernel
            consumed = consumed.to(torch.bfloat16)
        acc += consumed.sum(dtype=torch.float32)  # cast inside the reduction: no f32 copy of the grids


def stream_checksum(
    batches: Iterable,
    spec: GridSpec,
    *,
    chunk: int = 256,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    radii: float = 1.0,
    radii_by_type=None,
    random_translation: float = 0.0,
    random_rotation: bool = False,
    out_dtype: str = "float32",
    impl: str = "auto",
    seed: int = 0,
    presorted: bool = False,
    wire: bool = False,
    witness: bool = False,
    prefetch_depth: int = 2,
    device="cuda",
) -> tuple[StreamStats, float]:
    """Drive compact superbatches through the card; return a checksum.

    The throughput-measurement / training-shaped loop.  ``batches`` are
    compact PaddedBatches (types present, SDFBatchFeeder(compact=True)) with
    batch_size a multiple of ``chunk``, or, with ``wire``, pre-packed
    ``(wire, num_atoms, num_channels)`` tuples from
    ``SDFBatchFeeder.iter_wire`` (compact batches are packed here with
    ``pack_wire``).  A prefetch thread stages each superbatch through a ring
    of ``prefetch_depth + 1`` pinned buffers onto the card on a side stream
    (one transfer: coords, types and centers, or the one int16 wire array,
    which the card dequantizes with one power-of-two multiply); the main
    thread waits for the copy on the device, not the host, and launches the
    chunks.  The checksum is fetched once, at the end: the only host sync.

    ``presorted``: the batches arrived Morton-sorted on the host
    (SDFBatchFeeder(presort=True)).  ``witness``: each chunk adds the sum of
    one molecule's grid instead of every grid (grids are still all written).
    ``radii_by_type``: per-channel radii, gathered on the card by type.
    Randomness: a ``torch.Generator`` on the device seeded with ``seed``.
    """
    from ..data.feed import pack_wire, prefetch_iter, wire_scale

    dev = _device(device)
    cuda = dev.type == "cuda"
    generator = torch.Generator(device=dev).manual_seed(int(seed))
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    rtab = None if radii_by_type is None else torch.as_tensor(
        np.asarray(radii_by_type, np.float32)).to(dev, non_blocking=True)
    radii_vec: dict[int, torch.Tensor] = {}
    scale = wire_scale(spec)
    side = torch.cuda.Stream(dev) if cuda else None
    ring = _PinnedRing(prefetch_depth + 1, dev, side) if cuda else None

    def host_arrays(batch):
        """(arrays to stage, molecules, channels) of one superbatch."""
        if isinstance(batch, tuple):  # pre-packed wire (SDFBatchFeeder.iter_wire)
            if not wire:
                raise ValueError("wire tuples need stream_checksum(wire=True)")
            wire_arr, num_atoms, nc = batch
            return [wire_arr], int((num_atoms > 0).sum()), nc
        if batch.types is None:
            raise ValueError("stream_checksum needs compact batches (SDFBatchFeeder(compact=True))")
        nmol = int((batch.num_atoms > 0).sum())
        if wire:
            return [pack_wire(batch, scale)], nmol, batch.num_channels
        centers = batch.centers if batch.centers is not None else np.zeros((batch.batch_size, 3), np.float32)
        return [batch.coords, batch.types, centers], nmol, batch.num_channels

    def staged():
        for batch in batches:
            arrays, nmol, nc = host_arrays(batch)
            if arrays[0].shape[0] % chunk:
                raise ValueError(f"batch_size {arrays[0].shape[0]} not a multiple of chunk {chunk}")
            if cuda:
                views, event = ring.stage(arrays)
            else:
                views, event = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], None
            yield views, event, nmol, nc

    stats = StreamStats()
    t0 = time.time()
    kw = dict(chunk=chunk, rtab=rtab, random_translation=float(random_translation), spec=spec,
              density_type=density_type, sigma=sigma, random_rotation=random_rotation, out_dtype=out_dtype,
              impl=impl, presorted=presorted, witness=witness)
    with torch.no_grad():
        for views, event, nmol, nc in prefetch_iter(staged(), depth=prefetch_depth):
            if event is not None:
                main = torch.cuda.current_stream(dev)
                main.wait_event(event)
                for v in views:
                    v.record_stream(main)
            if wire:
                coords = views[0][..., :3].to(torch.float32) * (1.0 / scale)  # exact: a power of two
                types, centers = views[0][..., 3], None
            else:
                coords, types, centers = views
            vp = types.shape[1]
            if vp not in radii_vec:
                radii_vec[vp] = torch.full((vp,), float(radii), dtype=torch.float32, device=dev)
            _scan_chunks(coords, types, centers, generator, acc, num_channels=nc, radii=radii_vec[vp], **kw)
            stats.batches += 1
            stats.molecules += nmol
        checksum = float(acc)
    stats.wall_seconds = time.time() - t0
    return stats, checksum
