"""Ray-sphere distances for the scan path.

Port of ``raytpu/geometry/sphere.py``: the reference's quadratic solve
(sphere.h:13-47) as a (B rays x S spheres) distance matrix with +inf for
misses, its per-ray twin for one gathered sphere, and the outward normal.
The near root is taken when t1 >= eps, else the far one when t2 >= eps,
only where disc > 0. The floors sqrt(max(disc, 1e-30)) and
0.5 / max(a, 1e-20) only keep gradients finite: misses are masked.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from raytpu_torch.core.vec3 import Vec3


def _roots(a, b, c, eps: float) -> Tensor:
    disc = b * b - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=1e-30))
    inv_2a = 0.5 / torch.clamp(a, min=1e-20)
    t1 = (-b - sqrt_disc) * inv_2a
    t2 = (-b + sqrt_disc) * inv_2a
    hit = disc > 0.0
    return torch.where(hit & (t1 >= eps), t1,
                       torch.where(hit & (t2 >= eps), t2, math.inf))


def sphere_distances(origin: Vec3, direction: Vec3, center: Vec3,
                     radius: Tensor, eps: float = 1e-4) -> Tensor:
    """Distances (B, S); +inf where there is no acceptable root."""
    ox, oy, oz = (c[:, None] for c in origin)
    dx, dy, dz = (c[:, None] for c in direction)
    cx, cy, cz = (c[None, :] for c in center)
    r = radius[None, :]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    return _roots(a, b, c, eps)


def sphere_normal(hit_point: Vec3, center: Vec3) -> Vec3:
    """Outward normal normalize(p - c) (sphere.h:33, 42)."""
    return (hit_point - center).normalize()


def sphere_distance_one(origin: Vec3, direction: Vec3, center: Vec3,
                        radius: Tensor, eps: float = 1e-4) -> Tensor:
    """Per-ray distance to one gathered sphere (all (B,)): the winner's
    distance recomputed differentiably after the selection."""
    oc = origin - center
    a = direction.dot(direction)
    b = 2.0 * oc.dot(direction)
    c = oc.dot(oc) - radius * radius
    return _roots(a, b, c, eps)
