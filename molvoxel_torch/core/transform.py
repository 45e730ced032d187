"""Geometric transforms: quaternion rotations and random rigid transforms.

Randomness comes from an explicit ``torch.Generator``, and the uniforms are
drawn on the generator's device.  A CPU generator (the API's) draws on the
host and moves the few uniforms to the coordinates' device, so a seed gives
the same transform on every device; a generator on the card (the stream's,
``parallel/stream.py``) draws there, with no copy from the host.
The sampling formula is Marsaglia/Shoemake's uniform unit quaternion:
q = (sqrt(1-u1) sin(2pi u2), sqrt(1-u1) cos(2pi u2), sqrt(u1) sin(2pi u3),
sqrt(u1) cos(2pi u3)).  Torch and ``jax.random`` give different uniforms
from one seed; to reproduce a JAX transform, pass its quaternion and
translation (core/state.py).

The rotation is applied as explicit sums of products rather than a matrix
product, so no TF32 setting can change it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_PI2 = 2.0 * math.pi


def _draw_device(generator: torch.Generator | None):
    return None if generator is None else generator.device


def random_quaternion(generator: torch.Generator | None = None, batch: tuple[int, ...] = (),
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform random unit quaternion(s) (w, x, y, z), shape batch + (4,)."""
    u = torch.rand(tuple(batch) + (3,), generator=generator, dtype=dtype, device=_draw_device(generator))
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    sq1 = torch.sqrt(1.0 - u1)
    sqr = torch.sqrt(u1)
    q = torch.stack(
        [sq1 * torch.sin(_PI2 * u2), sq1 * torch.cos(_PI2 * u2), sqr * torch.sin(_PI2 * u3), sqr * torch.cos(_PI2 * u3)],
        dim=-1,
    )
    return q.to(device) if device is not None else q


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from unit quaternion(s) (..., 4) as (w, x, y, z).

    ``coords @ R.T`` rotates coords by q (q * p * q^-1)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1),
        torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], dim=-1),
        torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotate(coords: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """coords (..., V, 3) @ rot(..., 3, 3).T, as sums of products."""
    rot = rot.to(coords.dtype)
    cols = [
        coords[..., 0] * rot[..., i, 0, None] + coords[..., 1] * rot[..., i, 1, None]
        + coords[..., 2] * rot[..., i, 2, None]
        for i in range(3)
    ]
    return torch.stack(cols, dim=-1)


def apply_quaternion(coords: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate coords (..., 3) by unit quaternion q (4,)."""
    return rotate(coords, quaternion_to_matrix(q.to(coords.device)))


def random_translation_vector(generator: torch.Generator | None, magnitude: float, batch: tuple[int, ...] = (),
                              dtype=torch.float32, device=None) -> torch.Tensor:
    """Translation ~ U(-magnitude, magnitude)^3, shape batch + (3,)."""
    u = torch.rand(tuple(batch) + (3,), generator=generator, dtype=dtype, device=_draw_device(generator))
    t = (u * 2.0 - 1.0) * float(magnitude)
    return t.to(device) if device is not None else t


@dataclasses.dataclass(frozen=True)
class Transform:
    """A concrete rigid transform: optional rotation then optional translation."""

    translation: torch.Tensor | None = None
    quaternion: torch.Tensor | None = None

    def __call__(self, coords: torch.Tensor, center: torch.Tensor | None = None) -> torch.Tensor:
        return do_transform(coords, center, self.translation, self.quaternion)

    @classmethod
    def create(cls, generator: torch.Generator | None = None, random_translation: float = 0.0,
               random_rotation: bool = False) -> "Transform":
        translation = random_translation_vector(generator, random_translation) if random_translation > 0.0 else None
        quaternion = random_quaternion(generator) if random_rotation else None
        return cls(translation, quaternion)


def do_transform(
    coords: torch.Tensor,
    center: torch.Tensor | None = None,
    translation: torch.Tensor | None = None,
    quaternion: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate about ``center`` (origin if None), then translate."""
    if quaternion is not None:
        if center is not None:
            center = torch.as_tensor(center, dtype=coords.dtype, device=coords.device).reshape(1, 3)
            coords = apply_quaternion(coords - center, quaternion) + center
        else:
            coords = apply_quaternion(coords, quaternion)
    if translation is not None:
        coords = coords + torch.as_tensor(translation, dtype=coords.dtype, device=coords.device).reshape(1, 3)
    return coords


def do_random_transform(
    generator: torch.Generator | None,
    coords: torch.Tensor,
    center: torch.Tensor | None = None,
    random_translation: float = 0.0,
    random_rotation: bool = False,
) -> torch.Tensor:
    """Sample and apply a random rigid transform drawn from ``generator``."""
    quaternion = random_quaternion(generator) if random_rotation else None
    translation = random_translation_vector(generator, random_translation) if random_translation > 0.0 else None
    return do_transform(coords, center, translation, quaternion)


@dataclasses.dataclass(frozen=True)
class RandomTransform:
    """Factory for random transforms with an explicit generator argument."""

    random_translation: float = 0.0
    random_rotation: bool = False

    def forward(self, generator: torch.Generator | None, coords: torch.Tensor,
                center: torch.Tensor | None = None) -> torch.Tensor:
        return do_random_transform(generator, coords, center, self.random_translation, self.random_rotation)

    __call__ = forward

    def get_transform(self, generator: torch.Generator | None = None) -> Transform:
        return Transform.create(generator, self.random_translation, self.random_rotation)
