"""A seeded library of drug-like ligands, in memory.

Each record is the template ligand (``molecules.template``: ``coords`` and
``channels`` 0-3 for the configuration's four symbols) rotated by a random
quaternion about its centroid, each coordinate jittered by U(-jitter,
jitter) A, and cut to a random subset of ``min_atoms`` up to all of its
atoms; all drawn from the seed.  Record ``all_h_record`` holds five
hydrogens and record ``empty_record`` no atom: both have no heavy atom and
keep their slots.  Coordinates are rounded to four decimals, as an SDF
V2000 file holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Library:
    counts: np.ndarray  # (n,) atoms per record
    xyz: np.ndarray  # (total, 3) float64, rounded to four decimals
    sym: np.ndarray  # (total,) index into symbols + ["H"]
    symbols: list

    @property
    def heavy_counts(self) -> np.ndarray:
        rec = np.repeat(np.arange(len(self.counts)), self.counts)
        return np.bincount(rec[self.sym < len(self.symbols)], minlength=len(self.counts))


def generate(root, cfg, seed: int) -> Library:
    m = cfg["molecules"]
    g = np.load(root / m["template"])
    base = g["coords"].astype(np.float64)
    centroid = base.mean(0)
    base = base - centroid
    types = g["channels"].astype(np.int64)
    rng = np.random.default_rng(seed)
    n = int(m["records"])
    all_h, empty = int(m["all_h_record"]), int(m["empty_record"])
    counts = rng.integers(int(m["min_atoms"]), base.shape[0] + 1, n)
    counts[[i for i in (all_h, empty) if i < n]] = 0
    if all_h < n:
        counts[all_h] = 5
    u = rng.uniform(size=(n, 3))
    a, b = np.sqrt(1 - u[:, 0]), np.sqrt(u[:, 0])
    q = np.stack([a * np.sin(2 * np.pi * u[:, 1]), a * np.cos(2 * np.pi * u[:, 1]),
                  b * np.sin(2 * np.pi * u[:, 2]), b * np.cos(2 * np.pi * u[:, 2])], -1)
    w, x, y, z = q.T
    rot = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                    np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                    np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)
    pick = np.argsort(rng.uniform(size=(n, base.shape[0])), axis=1)  # a random atom order per record
    rec = np.repeat(np.arange(n), counts)
    slot = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    atom = pick[rec, slot]
    xyz = np.einsum("nij,nj->ni", rot[rec], base[atom]) + centroid
    xyz += rng.uniform(-float(m["jitter"]), float(m["jitter"]), size=xyz.shape)
    sym = types[atom]
    symbols = list(m["symbols"])
    if all_h < n:
        sym[rec == all_h] = len(symbols)
    return Library(counts, np.rint(xyz * 1e4) / 1e4, sym, symbols)


def molecules(root, cfg, seed: int) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each record's heavy atoms: (coords (n, 3) float32, types (n,) int64,
    center (3,) float32, the mean of the coordinates; zeros when empty)."""
    lib = generate(root, cfg, seed)
    heavy = lib.sym < len(lib.symbols)
    xyz = lib.xyz.astype(np.float32)
    off = np.concatenate([[0], np.cumsum(lib.counts)])
    out = []
    for i in range(len(lib.counts)):
        keep = heavy[off[i]:off[i + 1]]
        crd = np.ascontiguousarray(xyz[off[i]:off[i + 1]][keep])
        center = crd.astype(np.float64).mean(0).astype(np.float32) if len(crd) else np.zeros(3, np.float32)
        out.append((crd, lib.sym[off[i]:off[i + 1]][keep].astype(np.int64), center))
    return out
