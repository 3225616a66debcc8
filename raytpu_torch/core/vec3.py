"""SoA 3-vectors over torch tensors.

Port of ``raytpu/core/vec3.py``: a batch of N vectors is three separate
(N,) component tensors, so every operation is elementwise over N and the
layout matches the JAX package's public functions, with the reference's
``reflect``, ``refract`` (its squared-index quirk included) and
``random_unit_vector`` beside the class.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import math

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

    @staticmethod
    def full(shape, x: float, y: float, z: float, device=None) -> "Vec3":
        f = lambda c: torch.full(shape, c, dtype=torch.float32, device=device)
        return Vec3(f(x), f(y), f(z))

    @staticmethod
    def where(mask: Tensor, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))

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
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

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

    def lerp(self, o: "Vec3", t: Scalar) -> "Vec3":
        """x + (y - x) * t (rtutility.h:32-34)."""
        return self + (o - self) * t

    def clamp(self, lo: float, hi: float) -> "Vec3":
        return Vec3(
            self.x.clamp(lo, hi), self.y.clamp(lo, hi), self.z.clamp(lo, hi)
        )


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """v - 2 (v.n) n (rtutility.h:205-208)."""
    return v - n * (2.0 * v.dot(n))


def refract(v: Vec3, normal: Vec3, n1: Scalar, n2: Scalar) -> Vec3:
    """Snell refraction with the reference's quirk of squaring both indices
    (rtutility.h:210-227); total internal reflection gives the mirror
    direction. The clamps only keep gradients finite (a miss carries
    ior = 0), as in ``raytpu``."""
    n1s = n1 * n1
    n2s = n2 * n2
    ratio = torch.clamp(n1s / torch.clamp(n2s, min=1e-20), 0.0, 1e6)
    ndotv = normal.dot(v)
    radical = 1.0 - (ratio * ratio) * (1.0 - ndotv * ndotv)
    comp_tan = (v - normal * v.dot(normal)) * ratio
    comp_norm = (-normal) * torch.sqrt(torch.clamp(radical, min=1e-20))
    return Vec3.where(radical > 0, comp_tan + comp_norm, reflect(v, normal))


def random_unit_vector(u: Tensor, v: Tensor) -> Vec3:
    """Uniform direction from two U(0,1) draws (rtutility.h:189-203):
    theta = 2 pi u, cos(phi) = 2v - 1, sin(phi) = sqrt(1 - cos^2)."""
    theta = (2.0 * math.pi) * u
    cos_phi = torch.clamp(2.0 * v - 1.0, -1.0, 1.0)
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return Vec3(torch.cos(theta) * sin_phi, torch.sin(theta) * sin_phi, cos_phi)
