"""A frozen copy of the augmentation recipe the port draws a batch's transforms by.

For a batch of ``b`` molecules and a ``torch.Generator`` on the host, the
port draws ``b x 3`` float32 uniforms for the rotations first (when it
rotates) and ``b x 3`` for the translations next (when it translates).  A
rotation is Shoemake's uniform unit quaternion of its three uniforms; a
translation is ``(2 u - 1) * magnitude`` per axis.  Each molecule is then
placed as ``R (x - center) + t``.  The draws are made here again, from the
same key, with torch's generator; everything after the uniforms is computed
in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(key: int) -> torch.Generator:
    """The host generator a call keyed ``key`` draws from."""
    return torch.Generator().manual_seed(int(key))


def quaternions(u: np.ndarray) -> np.ndarray:
    """(b, 3) uniforms -> (b, 4) unit quaternions (w, x, y, z), float64."""
    u = np.asarray(u, np.float64)
    a, b = np.sqrt(1.0 - u[:, 0]), np.sqrt(u[:, 0])
    return np.stack([a * np.sin(2 * math.pi * u[:, 1]), a * np.cos(2 * math.pi * u[:, 1]),
                     b * np.sin(2 * math.pi * u[:, 2]), b * np.cos(2 * math.pi * u[:, 2])], -1)


def rotation_matrices(q: np.ndarray) -> np.ndarray:
    """(b, 4) quaternions (w, x, y, z) -> (b, 3, 3) rotation matrices, float64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def draw(gen: torch.Generator, b: int, translation: float, rotation: bool) -> tuple[np.ndarray, np.ndarray]:
    """(rotations (b, 3, 3), translations (b, 3)) of one batch, in the port's order of draws."""
    rot = np.broadcast_to(np.eye(3), (b, 3, 3)).copy()
    shift = np.zeros((b, 3))
    if rotation:
        rot = rotation_matrices(quaternions(torch.rand((b, 3), generator=gen, dtype=torch.float32).numpy()))
    if translation > 0.0:
        u = torch.rand((b, 3), generator=gen, dtype=torch.float32).numpy().astype(np.float64)
        shift = (u * 2.0 - 1.0) * float(translation)
    return rot, shift


def place(coords: np.ndarray, center: np.ndarray, rot: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """``R (x - center) + t`` of one molecule's (n, 3) coordinates, float64."""
    return (np.asarray(coords, np.float64) - np.asarray(center, np.float64)) @ rot.T + shift
