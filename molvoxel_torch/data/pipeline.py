"""Host-side batching: ragged molecules -> padded fixed-shape batches.

The JAX package's pipeline in numpy: variable-size point clouds are padded
into bucketed (B, Vp, ...) arrays plus validity masks that feed
``ops.batch.voxelize_batch`` and the stream (``parallel/stream.py``), by the
one writer of that layout ``forward_batch`` uses (``data/staging.py``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator, Sequence

import numpy as np

from ..core.config import small_atom_bucket
from .staging import batch_layout, stage_batch, unpinned


@dataclasses.dataclass
class PaddedBatch:
    """A fixed-shape molecule batch ready for device transfer.

    Two channel encodings:
    - dense: ``weights`` (B, Vp, C) one-hot / feature rows, ``types`` None.
    - compact: ``types`` (B, Vp) int8 channel indices (-1 = padding) and
      ``weights`` None: 1/(4C) the transfer bytes; the one-hot expansion and
      the validity mask (``types >= 0``) are rebuilt on the device
      (``parallel.stream.stream_checksum``).  ``num_channels`` records C.
    """

    coords: np.ndarray  # (B, Vp, 3) f32
    weights: np.ndarray | None  # (B, Vp, C) f32, or None when compact
    mask: np.ndarray  # (B, Vp) bool
    radii: np.ndarray | None  # (B, Vp) f32 when per-atom, else None
    centers: np.ndarray | None  # (B, 3) f32
    num_atoms: np.ndarray  # (B,) int32 true sizes
    types: np.ndarray | None = None  # (B, Vp) int8, -1 padding (compact form)
    num_channels: int | None = None  # C for the compact form

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def padded_atoms(self) -> int:
        return self.coords.shape[1]


def pad_point_clouds(
    clouds: Sequence[tuple[np.ndarray, np.ndarray]],
    *,
    radii: Sequence[np.ndarray] | None = None,
    centers: Sequence[np.ndarray] | None = None,
    bucket: int | None = None,
) -> PaddedBatch:
    """Pad a list of (coords (V_i, 3), weights (V_i, C)) to one batch.

    Vp is ``small_atom_bucket(max V_i)`` unless ``bucket`` is given.  Padded
    atoms get zero weights, radius 1 and mask False: they deposit nothing.
    The batch is ``data.staging.stage_batch``'s (``forward_batch``'s)
    layout, written by it into one fresh buffer; its arrays are views of
    the buffer's sections.
    """
    if len(clouds) == 0:
        raise ValueError("pad_point_clouds needs at least one cloud")
    c = clouds[0][1].shape[1]
    counts = np.array([crd.shape[0] for crd, _ in clouds], np.int32)
    vmax = int(counts.max())
    vp = bucket if bucket is not None else small_atom_bucket(vmax)
    if vp < vmax:
        raise ValueError(f"bucket {vp} smaller than max atom count {vmax}")
    b = len(clouds)
    if radii is not None:  # per molecule, as (V_i,) float32
        radii = [np.broadcast_to(np.asarray(radii[i], np.float32), (v,)) for i, v in enumerate(counts)]
    if centers is not None:
        centers = np.stack([np.asarray(ce, np.float32).reshape(3) for ce in centers])
    layout = batch_layout(b, vp, c, (0,) if radii is None else (b, vp), centers is not None)  # (0,): no radii
    arrays = unpinned(layout).arrays
    stage_batch(arrays, [np.asarray(crd, np.float32) for crd, _ in clouds],
                [np.asarray(w, np.float32) for _, w in clouds], counts, False, 1.0 if radii is None else radii,
                centers)
    coords, weights, radii_arr, mask = arrays[:4]
    return PaddedBatch(coords, weights, mask, None if radii is None else radii_arr,
                       None if centers is None else arrays[4], counts)


def types_to_onehot(types: np.ndarray, num_channels: int) -> np.ndarray:
    """(V,) int types -> (V, C) one-hot float32 weights."""
    out = np.zeros((types.shape[0], num_channels), np.float32)
    out[np.arange(types.shape[0]), np.asarray(types, np.int64)] = 1.0
    return out


def iter_batches(
    clouds: Iterable[tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    *,
    bucket: int | None = None,
    drop_remainder: bool = False,
) -> Iterator[PaddedBatch]:
    """Group a molecule stream into fixed-size padded batches.

    The final short batch is padded to ``batch_size`` with empty entries
    (mask all-False) unless ``drop_remainder``.
    """
    buf: list[tuple[np.ndarray, np.ndarray]] = []
    c = None
    for cloud in clouds:
        buf.append(cloud)
        c = cloud[1].shape[1]
        if len(buf) == batch_size:
            yield pad_point_clouds(buf, bucket=bucket)
            buf = []
    if buf and not drop_remainder:
        empty = (np.zeros((0, 3), np.float32), np.zeros((0, c), np.float32))
        while len(buf) < batch_size:
            buf.append(empty)
        yield pad_point_clouds(buf, bucket=bucket)
