"""SoA 3-vectors over torch tensors.

Port of ``raytpu/core/vec3.py``: a batch of N vectors is three separate
(N,) component tensors, so every operation is elementwise over N and the
layout matches the JAX package's public functions. Only the operations the
forward sphere render uses are here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
from torch import Tensor

Scalar = Union[float, Tensor]


@dataclass(frozen=True)
class Vec3:
    """A batch of 3-vectors stored as separate x/y/z component tensors."""

    x: Tensor
    y: Tensor
    z: Tensor

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    @staticmethod
    def create(x: Scalar, y: Scalar, z: Scalar, device=None) -> "Vec3":
        f = lambda c: torch.as_tensor(c, dtype=torch.float32, device=device)
        return Vec3(f(x), f(y), f(z))

    @staticmethod
    def from_array(a: Tensor) -> "Vec3":
        """Build from an (..., 3) tensor."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def zeros(shape, device=None) -> "Vec3":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    def to_array(self) -> Tensor:
        """(..., 3) tensor."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        return Vec3(self.x * o, self.y * o, self.z * o)

    def dot(self, o: "Vec3") -> Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def normalize(self) -> "Vec3":
        """Unit vector; zero-length inputs map to zero (vec3.normalize)."""
        n2 = self.dot(self)
        inv_len = torch.where(
            n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0
        )
        return Vec3(self.x * inv_len, self.y * inv_len, self.z * inv_len)

    def clamp(self, lo: float, hi: float) -> "Vec3":
        return Vec3(
            self.x.clamp(lo, hi), self.y.clamp(lo, hi), self.z.clamp(lo, hi)
        )
