"""A plain reader of a grid store, written from its documented layout.

    store/
      manifest.json     {"format": "molvoxel-tpu-gridstore-v1", "num_molecules", "dtype",
                         "grid_shape", "shards": [{"file", "count"}, ...], "final", ...}
      shard_00000.npy   (count, C, D, H, W); bfloat16 / float8_e4m3fn as raw 2- / 1-byte void
      num_atoms.npy     (num_molecules,) int32 atoms a record, 0 for a record with none

``problems`` lists every way a store breaks the guarantees of its
configuration; ``Store.grid`` reads one record back as a CPU tensor.
NumPy, JSON and torch's dtypes only: nothing of the port.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

FORMAT = "molvoxel-tpu-gridstore-v1"
# the stored items of a dtype numpy lacks: (the integer of its size, the torch dtype)
RAW = {"bfloat16": (np.int16, torch.bfloat16), "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float8_e4m3fn": 1}


class Store:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "manifest.json").read_text())
        counts = [int(s["count"]) for s in self.manifest["shards"]]
        self.starts = np.cumsum([0] + counts)

    def shard(self, si: int) -> np.ndarray:
        return np.load(self.root / self.manifest["shards"][si]["file"], mmap_mode="r")

    def grid(self, i: int) -> torch.Tensor:
        """Record ``i``'s grid (C, D, H, W), a CPU tensor of the manifest's dtype."""
        si = int(np.searchsorted(self.starts, i, side="right") - 1)
        raw = np.array(self.shard(si)[i - self.starts[si]])
        dtype = self.manifest["dtype"]
        if dtype in RAW:
            as_int, as_torch = RAW[dtype]
            return torch.from_numpy(raw.view(as_int)).view(as_torch)
        return torch.from_numpy(raw)

    def num_atoms(self) -> np.ndarray:
        return np.load(self.root / "num_atoms.npy")


def problems(root: Path, *, records: int, dtype: str, grid_shape: list, heavy_counts: np.ndarray) -> list[str]:
    """Every breach of the store's guarantees: a final manifest of the format,
    every record in its slot (shard counts summing to ``records``, each
    shard of the asked dtype and shape), ``num_atoms`` equal to
    ``heavy_counts``, and each record without a heavy atom a zero grid."""
    try:
        store = Store(root)
    except (OSError, ValueError, KeyError) as exc:
        return [f"unreadable manifest: {exc!r}"]
    m, out = store.manifest, []
    if m.get("format") != FORMAT:
        out.append(f"format {m.get('format')!r}")
    if m.get("final") is not True:
        out.append(f"final {m.get('final')!r}")
    if m.get("num_molecules") != records:
        out.append(f"num_molecules {m.get('num_molecules')!r} of {records}")
    if int(store.starts[-1]) != records:
        out.append(f"shard counts sum to {int(store.starts[-1])} of {records}")
    if m.get("dtype") != dtype or list(m.get("grid_shape") or []) != list(grid_shape):
        out.append(f"dtype {m.get('dtype')!r}, grid_shape {m.get('grid_shape')!r}")
    for si, entry in enumerate(m["shards"]):
        try:
            arr = store.shard(si)
        except (OSError, ValueError) as exc:
            out.append(f"{entry['file']}: {exc!r}")
            continue
        if list(arr.shape) != [int(entry["count"])] + list(grid_shape) or arr.dtype.itemsize != ITEMSIZE.get(dtype):
            out.append(f"{entry['file']}: shape {arr.shape}, itemsize {arr.dtype.itemsize}")
    try:
        atoms = store.num_atoms()
    except (OSError, ValueError) as exc:
        return out + [f"num_atoms.npy: {exc!r}"]
    if atoms.shape != heavy_counts.shape or not np.array_equal(atoms, heavy_counts):
        out.append(f"num_atoms differs from the heavy-atom counts ({atoms.shape} against {heavy_counts.shape})")
    if out:
        return out
    for i in np.flatnonzero(heavy_counts == 0).tolist():
        if bool(store.grid(i).to(torch.float32).ne(0).any()):
            out.append(f"record {i} has no heavy atom and a nonzero grid")
    return out
