"""OpenDX volume I/O.

Writes per-channel voxel grids as OpenDX ASCII volumes, the format PyMOL
loads as isosurface-capable maps.  Layout follows the reference writer
(reference molvoxel/etc/pymol/dx.py:2-39, itself adapted from LiGAN):
origin = center - resolution * (size - 1) / 2, three values per data line.
A reader is included for round-tripping and testing (the reference has none).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_dx(dx_path: str | Path, values: np.ndarray, center, resolution: float) -> None:
    """Write one (D, H, W) grid to an OpenDX file."""
    values = np.asarray(values)
    assert values.ndim == 3, f"expected a 3-D grid, got shape {values.shape}"
    center = np.asarray(center, dtype=float).reshape(3)
    sx, sy, sz = values.shape
    origin = center - resolution * (np.asarray(values.shape) - 1) / 2.0

    header = (
        f"object 1 class gridpositions counts {sx:d} {sy:d} {sz:d}\n"
        f"origin {origin[0]:.5f} {origin[1]:.5f} {origin[2]:.5f}\n"
        f"delta {resolution:.5f} 0 0\n"
        f"delta 0 {resolution:.5f} 0\n"
        f"delta 0 0 {resolution:.5f}\n"
        f"object 2 class gridconnections counts {sx:d} {sy:d} {sz:d}\n"
        f"object 3 class array type double rank 0 items [ {sx * sy * sz:d} ] data follows\n"
    )

    flat = values.reshape(-1)
    n_full, rem = divmod(flat.shape[0], 3)
    lines = []
    triples = flat[: n_full * 3].reshape(-1, 3)
    for a, b, c in triples:
        lines.append(f"{a:.5f} {b:.5f} {c:.5f}")
    if rem:
        lines.append(" ".join(f"{x:.5f}" for x in flat[n_full * 3 :]))
    body = "\n".join(lines)

    with open(dx_path, "w") as fh:
        fh.write(header + body + "\n")


# reference-compatible alias (dx.py:2)
write_grid_to_dx_file = write_dx


def read_dx(dx_path: str | Path) -> tuple[np.ndarray, np.ndarray, float]:
    """Read an OpenDX file -> (values (D, H, W), origin (3,), resolution)."""
    with open(dx_path) as fh:
        lines = fh.read().split("\n")
    shape = None
    origin = None
    deltas = []
    data_start = None
    for i, line in enumerate(lines):
        parts = line.split()
        if line.startswith("object 1 class gridpositions"):
            shape = tuple(int(x) for x in parts[-3:])
        elif line.startswith("origin"):
            origin = np.asarray([float(x) for x in parts[1:4]])
        elif line.startswith("delta"):
            deltas.append([float(x) for x in parts[1:4]])
        elif "data follows" in line:
            data_start = i + 1
            break
    assert shape is not None and origin is not None and data_start is not None
    resolution = float(deltas[0][0])
    n = int(np.prod(shape))
    values = np.asarray(
        [float(tok) for line in lines[data_start:] for tok in line.split()][:n], dtype=np.float64
    )
    return values.reshape(shape), origin, resolution


def write_channels_dx(
    out_dir: str | Path, channel_dict: dict[str, np.ndarray], center, resolution: float, prefix: str = ""
) -> dict[str, Path]:
    """Write every channel of a {name: (D,H,W)} dict; returns name -> path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, grid in channel_dict.items():
        safe = "".join(ch if (ch.isalnum() or ch in "-_") else "_" for ch in name)
        path = out_dir / f"{prefix}{safe}.dx"
        write_dx(path, np.asarray(grid), center, resolution)
        paths[name] = path
    return paths
