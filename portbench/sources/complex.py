"""A protein-ligand complex from frozen ``.npz`` files: the ligand and the whole protein, one channel.

``molecules.ligand`` and ``molecules.protein`` name the files, relative to
the checkout; each holds ``coords`` (n, 3) in the complex's frame, and the
ligand's file its ``center`` (3,), the ligand's mean, on which the box is
centered.  Every atom weighs 1 in the one channel (the upstream ``single``
path); the ligand's atoms come first.
"""

from __future__ import annotations

import numpy as np


def split(root, cfg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ligand coords (n_l, 3), protein coords (n_p, 3), center (3,)), float32."""
    m = cfg["molecules"]
    lig, prot = np.load(root / m["ligand"]), np.load(root / m["protein"])
    return (np.ascontiguousarray(lig["coords"], np.float32), np.ascontiguousarray(prot["coords"], np.float32),
            np.asarray(lig["center"], np.float32))


def molecules(root, cfg, seed: int) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The one molecule of this source (the seed draws nothing here):
    (coords (n, 3) float32, types (n,) int64, all 0, center (3,) float32)."""
    lig, prot, center = split(root, cfg)
    coords = np.concatenate([lig, prot])
    return [(coords, np.zeros(len(coords), np.int64), center)]
