"""The least time the card could take for a cell's voxelization work, counted from its inputs.

The count is the work the inputs need, whatever implements it, so that a
later fusion, split or rename of a kernel leaves it alone:

- bytes: each input byte read once and each output byte written once.  A
  forward call reads 12 bytes of coordinates per atom, 4 bytes per nonzero
  channel weight (one per atom for atom types) and 40 bytes per molecule
  (its center and its rotation and translation), and writes its grids;
- operations: every (atom, voxel) pair inside the cutoff.  A forward pair
  costs 13 float32 operations (the squared distance 8, the cutoff 1, the
  gaussian 4) and 2 per nonzero channel weight (a multiply-add).  The pairs
  a call needs are its atoms times the pairs per atom that the reference
  counted on the run's checked calls.

The least time is the larger of bytes over the card's memory bandwidth and
operations over its float32 rate (NVIDIA's H100 SXM data sheet, at its full
power limit of 700 W).
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FWD_PAIR_OPS, FWD_WEIGHT_OPS = 13, 2
COORD_BYTES, WEIGHT_BYTES, MOLECULE_BYTES = 12, 4, 40


@dataclasses.dataclass
class Work:
    """Work summed over calls: bytes moved, and operations per pair per atom
    (operations = ``pair_ops`` times the pairs per atom)."""

    bytes: float = 0.0
    pair_ops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.pair_ops + other.pair_ops)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.pair_ops * n)


def forward(atoms: int, weights: int, molecules: int, out_elements: int, out_itemsize: int) -> Work:
    """One forward call: ``atoms`` live atoms with ``weights`` nonzero channel
    weights in ``molecules`` molecules, writing ``out_elements`` voxels."""
    return Work(atoms * COORD_BYTES + weights * WEIGHT_BYTES + molecules * MOLECULE_BYTES
                + out_elements * out_itemsize,
                atoms * FWD_PAIR_OPS + weights * FWD_WEIGHT_OPS)


def least_seconds(work: Work, pairs_per_atom: float) -> tuple[float, str]:
    """(least seconds, which bound sets them: "bytes" or "operations")."""
    t_bytes = work.bytes / HBM_BYTES_PER_S
    t_ops = work.pair_ops * pairs_per_atom / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share_pct(run) -> float | None:
    """The window's least time over the device time of every kernel launched
    inside the port's entry spans, in percent; None without a trace."""
    if run.timeline is None or run.pairs_per_atom is None:
        return None
    kernel_s = run.timeline.kernel_seconds_in(run.entry_spans)
    if kernel_s <= 0:
        return None
    least, _ = least_seconds(run.window.work, run.pairs_per_atom)
    return 100.0 * least / kernel_s
