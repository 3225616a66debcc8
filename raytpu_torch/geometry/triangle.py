"""Per-triangle precomputation and barycentric coordinates.

Port of ``raytpu/geometry/triangle.py`` (``precompute``, ``barycentric``):
the Moller-Trumbore edges and raw normal hoisted out of the per-ray loop,
and the area-ratio barycentrics of the reference's texture lookup
(texture.h:16-27), op for op in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from raytpu_torch.core.types import Triangles
from raytpu_torch.core.vec3 import Vec3


class TriangleGeom(NamedTuple):
    edge_ab: Vec3      # B - A (T,)
    edge_ac: Vec3      # C - A
    normal_raw: Vec3   # cross(AB, AC), unnormalized
    normal: Vec3       # normalized plane normal
    a: Vec3


def precompute(tris: Triangles) -> TriangleGeom:
    edge_ab = tris.b - tris.a
    edge_ac = tris.c - tris.a
    n_raw = edge_ab.cross(edge_ac)
    return TriangleGeom(edge_ab, edge_ac, n_raw, n_raw.normalize(), tris.a)


def barycentric(a: Vec3, b: Vec3, c: Vec3, normal: Vec3,
                p: Vec3) -> tuple[Tensor, Tensor, Tensor]:
    """Signed areas projected on the hit normal, per ray (all (B,))."""
    area_abc = normal.dot((b - a).cross(c - a))
    area_pbc = normal.dot((b - p).cross(c - p))
    area_pca = normal.dot((c - p).cross(a - p))
    # degenerate-triangle guard (valid hits have area > 0)
    inv = 1.0 / torch.where(area_abc.abs() > 1e-20, area_abc, 1.0)
    w_a = area_pbc * inv
    w_b = area_pca * inv
    return w_a, w_b, 1.0 - w_a - w_b
