"""Host-side batching: ragged molecules -> padded fixed-shape batches.

A numpy copy of the JAX package's pipeline: variable-size point clouds are
padded into bucketed (B, Vp, ...) arrays plus validity masks that feed
``ops.batch.voxelize_batch`` and the stream (``parallel/stream.py``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator, Sequence

import numpy as np

from ..core.config import small_atom_bucket


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
    """
    if len(clouds) == 0:
        raise ValueError("pad_point_clouds needs at least one cloud")
    c = clouds[0][1].shape[1]
    vmax = max(crd.shape[0] for crd, _ in clouds)
    vp = bucket if bucket is not None else small_atom_bucket(vmax)
    if vp < vmax:
        raise ValueError(f"bucket {vp} smaller than max atom count {vmax}")
    b = len(clouds)

    coords = np.zeros((b, vp, 3), np.float32)
    weights = np.zeros((b, vp, c), np.float32)
    mask = np.zeros((b, vp), bool)
    num_atoms = np.zeros((b,), np.int32)
    radii_arr = None
    if radii is not None:
        radii_arr = np.ones((b, vp), np.float32)

    for i, (crd, w) in enumerate(clouds):
        v = crd.shape[0]
        coords[i, :v] = crd
        weights[i, :v] = w
        mask[i, :v] = True
        num_atoms[i] = v
        if radii is not None:
            radii_arr[i, :v] = np.broadcast_to(np.asarray(radii[i], np.float32), (v,))

    centers_arr = None
    if centers is not None:
        centers_arr = np.stack([np.asarray(ce, np.float32).reshape(3) for ce in centers])

    return PaddedBatch(coords, weights, mask, radii_arr, centers_arr, num_atoms)


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
