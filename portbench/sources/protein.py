"""A whole protein from a frozen ``.npz`` file, one channel, the box centered on its own mean.

``molecules.protein`` names the file, relative to the checkout; it holds
``coords`` (n, 3).  Every atom weighs 1 in the one channel (the upstream
``single`` path).
"""

from __future__ import annotations

import numpy as np


def molecules(root, cfg, seed: int) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The one molecule of this source (the seed draws nothing here):
    (coords (n, 3) float32, types (n,) int64, all 0, center (3,) float32,
    the mean of the coordinates)."""
    coords = np.ascontiguousarray(np.load(root / cfg["molecules"]["protein"])["coords"], np.float32)
    center = coords.astype(np.float64).mean(0).astype(np.float32)
    return [(coords, np.zeros(len(coords), np.int64), center)]
