"""Staging host arrays for the card: one buffer, one copy.

``PinnedRing`` is a ring of pinned host buffers ("slots"), each written
again only after the event recorded behind its last use has completed, so
callers that never synchronise stay correct.  A caller takes the next slot
as typed numpy views of its sections, writes them, and sends the slot's
used bytes to the card in ONE non-blocking transfer, which returns device
views of the same sections (``taken``: ``Voxelizer.forward_batch``);
``stage`` packs ready arrays that way (the stream's superbatches,
parallel/stream.py).

``stage_batch`` writes ``Voxelizer.forward_batch``'s padded batch (coords,
one-hot or feature weights, radii, mask, centers: what ``pad_point_clouds``
and ``types_to_onehot`` make, bit for bit) into the sections in one pass.
Where molecules are large each is written by slices; where they are many and
small, one concatenate and one gather write them all (``GATHER_MAX_ATOMS``).
The batch's transform table, where it draws one, is a last section of the
same slot (``batch_layout``), so it crosses in the same copy.

With no profiler recording nothing here counts; while one records,
``molvoxel.staging_allocs`` counts slot allocations and growths and
``molvoxel.staging_waits`` slots taken whose event had not completed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ..utils.timing import count

ALIGN = 16  # bytes: each section starts at a multiple

# Mean atoms a molecule at or below which one concatenate and one gather
# place a batch; above it, per-molecule slices do.  On an H100 machine's host
# (tools/torch_staging_sweep.py into pinned memory, PERF.md) the gather won
# at every mean up to 192 atoms in batches of 16 and of 64 (64 molecules of
# 24-32 atoms: 0.12-0.14 ms against 0.31), and the slices from 256 and 320
# atoms on (16 of 3,323: 0.39 ms against 0.89).
GATHER_MAX_ATOMS = 192


@dataclasses.dataclass(frozen=True)
class Layout:
    """Sections of one buffer: ``sections`` holds each one's (shape, numpy
    dtype, torch dtype, first byte, end byte), the first byte a multiple of
    ``ALIGN``; ``total``, the bytes a copy sends, is the last section's end
    rounded up to one; ``payload`` counts the sections' bytes alone."""

    sections: tuple
    total: int
    payload: int

    @classmethod
    def of(cls, specs) -> "Layout":
        sections, end, payload = [], 0, 0
        for shape, dtype in specs:
            shape, dtype = tuple(int(n) for n in shape), np.dtype(dtype)
            start = -(-end // ALIGN) * ALIGN
            nbytes = math.prod(shape) * dtype.itemsize
            end, payload = start + nbytes, payload + nbytes
            sections.append((shape, dtype, getattr(torch, dtype.name), start, end))
        return cls(tuple(sections), -(-end // ALIGN) * ALIGN, payload)

    def host(self, buf: np.ndarray) -> list[np.ndarray]:
        """numpy views of the sections in a uint8 buffer."""
        return [buf[start:end].view(dt).reshape(shape) for shape, dt, _, start, end in self.sections]

    def tensors(self, buf: torch.Tensor) -> list[torch.Tensor]:
        """torch views of the sections in a uint8 tensor (on any device)."""
        return [buf[start:end].view(dt).view(shape) for shape, _, dt, start, end in self.sections]


class _Slot:
    __slots__ = ("host", "dev", "event", "busy", "layout", "arrays", "sent")

    def __init__(self):
        self.host = self.dev = self.event = self.layout = self.arrays = self.sent = None
        self.busy = False


@dataclasses.dataclass
class Staged:
    """A buffer taken for writing: ``arrays`` are numpy views of its
    sections, ``host`` the whole uint8 tensor, ``slot`` the ring's slot
    (None for an unpinned buffer of its own)."""

    layout: Layout
    host: torch.Tensor
    arrays: list
    slot: _Slot | None = None


def unpinned(layout: Layout) -> Staged:
    """A fresh pageable buffer of ``layout``: the CPU path, where the
    tensors are the buffer itself and nothing may be reused."""
    host = torch.empty(max(layout.total, 1), dtype=torch.uint8)
    return Staged(layout, host, layout.host(host.numpy()))


class PinnedRing:
    """``depth`` slots, each a pinned host buffer on the host of ``device``
    (pageable on a CPU ``device``: the CPU tests give a stand-in ``event``,
    else ``torch.cuda.Event``), taken in turn under a lock.  A slot still
    being written by another thread is passed over, and the ring grows by
    one where every slot is.  Two uses:

    - ``taken`` and ``send``: the caller writes the slot's sections in
      place, ``send`` copies the used bytes into the slot's own device
      buffer in one non-blocking transfer on the current stream and returns
      device views of the sections, the caller launches its work on them,
      and the block's end records the slot's event on the current stream
      behind that work.  The slot is taken again only after that event has
      completed, so its host buffer has been copied and its device buffer
      read.  Its views are made once a layout, as normal tensors, so that
      calls under ``torch.inference_mode()`` and outside it share a slot.
    - ``stage``: ready arrays are packed into the next slot and copied to a
      new device buffer on ``stream``; the slot is taken again only after
      that copy, and the consumer waits for the event returned (the
      stream's superbatches).
    """

    def __init__(self, depth: int, device, stream=None, event=None):
        self.device, self.stream = torch.device(device), stream
        self.event = torch.cuda.Event if event is None else event
        self.slots = [_Slot() for _ in range(depth)]
        self.next = 0
        self._lock = threading.Lock()

    def _claim(self) -> _Slot:
        with self._lock:
            n = len(self.slots)
            for k in range(n):
                i = (self.next + k) % n
                if not self.slots[i].busy:
                    break
            else:
                self.slots.append(_Slot())
                i = n
            self.next = (i + 1) % len(self.slots)
            slot = self.slots[i]
            slot.busy = True
            return slot

    def take(self, layout: Layout) -> Staged:
        """The next slot, its event completed and its buffer at least
        ``layout.total`` bytes, as numpy views of ``layout``'s sections."""
        slot = self._claim()
        try:
            if slot.event is not None and not slot.event.query():
                count("molvoxel.staging_waits")
                slot.event.synchronize()
            if slot.host is None or slot.host.numel() < layout.total:
                count("molvoxel.staging_allocs")
                with torch.inference_mode(False):  # a normal tensor, for calls in either mode
                    slot.host = torch.empty(max(layout.total, 1), dtype=torch.uint8,
                                            pin_memory=self.device.type == "cuda")
                slot.dev = slot.layout = slot.sent = None
        except BaseException:
            slot.busy = False
            raise
        if slot.layout is not layout:  # the views of the slot's last layout serve again
            slot.layout, slot.arrays = layout, layout.host(slot.host.numpy())
        return Staged(layout, slot.host, slot.arrays, slot)

    def send(self, staged: Staged) -> list[torch.Tensor]:
        """Copy the slot's used bytes into its device buffer in one
        non-blocking transfer on the current stream; device views of the
        sections."""
        slot, layout = staged.slot, staged.layout
        if slot.sent is None or slot.sent[0] is not layout:
            # Normal tensors, whichever mode this call runs in: an inference
            # tensor made here would refuse the copy of a later normal call.
            with torch.inference_mode(False):
                if slot.dev is None:
                    slot.dev = torch.empty(slot.host.numel(), dtype=torch.uint8, device=self.device)
                total = layout.total
                slot.sent = (layout, slot.host[:total], slot.dev[:total], layout.tensors(slot.dev))
        _, host, dev, views = slot.sent
        dev.copy_(host, non_blocking=True)
        return views

    @contextlib.contextmanager
    def taken(self, layout: Layout):
        """``take`` for the block; when it ends, however it ends, the slot
        goes back with its event recorded on the current stream behind the
        work the block launched on its views."""
        staged = self.take(layout)
        try:
            yield staged
        finally:
            slot = staged.slot
            if slot.event is None:
                slot.event = self.event()
            slot.event.record(torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None)
            slot.busy = False

    def stage(self, arrays: list[np.ndarray]):
        """Pack ``arrays`` into the next slot and copy it to the card in ONE
        transfer on ``stream``; the arrays' device views and the event the
        consumer must wait for."""
        staged = self.take(Layout.of((a.shape, a.dtype) for a in arrays))
        slot, total = staged.slot, staged.layout.total
        for dst, a in zip(staged.arrays, arrays):
            dst[...] = a
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = slot.host[:total].to(self.device, non_blocking=True)
            event = self.event()
            event.record(self.stream)
        slot.event = event
        slot.busy = False
        return staged.layout.tensors(dev), event


# ------------------------------------------------------ forward_batch's batch


@functools.lru_cache(maxsize=64)
def batch_layout(b: int, vp: int, c: int, radii_shape: tuple, centers: bool, table: bool = False) -> Layout:
    """coords (B, Vp, 3) f32, weights (B, Vp, C) f32, radii (``radii_shape``)
    f32, mask (B, Vp) bool, centers (B, 3) f32 when given, and the transform
    table (B, 12) f32 (``core.transform.draw_transform_table``) last when
    one is drawn."""
    specs = [((b, vp, 3), np.float32), ((b, vp, c), np.float32), (radii_shape, np.float32), ((b, vp), np.bool_)]
    return Layout.of(specs + ([((b, 3), np.float32)] if centers else []) + ([((b, 12), np.float32)] if table else []))


def stage_batch(arrays: list[np.ndarray], coords: list[np.ndarray], channels: list[np.ndarray],
                counts: np.ndarray, typed: bool, radii, centers) -> None:
    """Write a padded batch into ``batch_layout``'s sections ``arrays`` in
    one pass.

    ``coords``: (V_i, 3) float32 arrays; ``channels``: (V_i,) int64 types
    (one-hot over the weights' C channels, as ``types_to_onehot`` indexes:
    a negative type counts from the end, one of C or more raises
    IndexError) or (V_i, C) float32 features; ``counts``: the V_i.
    ``radii``: a float (every radius), a list of per-molecule (V_i,) float32
    arrays (padding 1.0), or a float32 array copied whole (channel-wise).
    ``centers``: a (B, 3) float32 array, or None.  Padded atoms get zero
    coords and weights and mask False; every byte of every section is
    written once."""
    out_coords, out_w, out_r, out_mask = arrays[:4]
    b, vp, c = out_w.shape
    np.less(np.arange(vp), counts[:, None], out=out_mask)
    n = int(counts.sum())
    if n <= GATHER_MAX_ATOMS * b:
        _gather(out_coords, out_w, out_mask, coords, channels, n, typed)
    else:
        _slices(out_coords, out_w, coords, channels, counts, typed)
    if isinstance(radii, float):
        out_r.fill(radii)
    elif isinstance(radii, list):
        for i, r in enumerate(radii):
            out_r[i, :r.shape[0]] = r
            out_r[i, r.shape[0]:] = 1.0
        out_r[len(radii):] = 1.0
    else:
        out_r[...] = radii
    if centers is not None:
        arrays[4][...] = centers


def _slices(out_coords, out_w, coords, channels, counts, typed):
    """Each molecule by slices of its rows, and its padding zeroed."""
    c = out_w.shape[2]
    eye = np.eye(c, dtype=np.float32) if typed else None
    for i, (crd, ch) in enumerate(zip(coords, channels)):
        v = int(counts[i])
        out_coords[i, :v] = crd
        out_coords[i, v:] = 0.0
        if typed:
            eye.take(ch, axis=0, out=out_w[i, :v])  # IndexError for a type past C, as types_to_onehot
        else:
            out_w[i, :v] = ch
        out_w[i, v:] = 0.0


def _gather(out_coords, out_w, mask, coords, channels, n, typed):
    """The molecules concatenated once, with a zero row after them, and
    every padded row gathered from them: the padding from the zero row."""
    c = out_w.shape[2]
    src = np.full(mask.shape, n)  # each padded row's row of the concatenation; the padding's, the zero row
    src[mask] = np.arange(n)
    np.concatenate(coords + [np.zeros((1, 3), np.float32)]).take(src, axis=0, out=out_coords, mode="clip")
    if not typed:
        np.concatenate(channels + [np.zeros((1, c), np.float32)]).take(src, axis=0, out=out_w, mode="clip")
        return
    flat = np.concatenate(channels + [np.array([c])])
    if n and not (0 <= flat[:n].min() and flat[:n].max() < c):
        flat[:n] = np.arange(c)[flat[:n]]  # index as types_to_onehot does: wrap a negative type, raise past C
    one_hot = np.eye(c + 1, c, dtype=np.float32)  # row C, all zero, for the padding
    one_hot.take(flat.take(src, mode="clip"), axis=0, out=out_w, mode="clip")
