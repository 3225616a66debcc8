"""Per-triangle precomputation, ray-triangle distances and barycentrics.

Port of ``raytpu/geometry/triangle.py`` (``precompute``,
``triangle_distances``, ``triangle_distance_one``, ``barycentric``): the
Moller-Trumbore edges and raw normal hoisted out of the per-ray loop, the
(B rays x T triangles) distance matrix of the scan path and its per-ray
twin for one gathered triangle (mesh.h:70-94), the area-ratio
barycentrics of the reference's texture lookup (texture.h:16-27), and
``raytpu``'s one bounding box over a mesh with its slab test (``AABB``,
``build_aabb``, ``hit_aabb``; triangle.hu:42-59, 143-160), op for op in
f32.
"""

from __future__ import annotations

import math
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


def _distance(ao: Vec3, d: Vec3, edge_ab: Vec3, edge_ac: Vec3,
              normal_raw: Vec3, det_eps: float, eps: float) -> Tensor:
    dao = ao.cross(d)
    det = -d.dot(normal_raw)
    # the guard keeps gradients finite; invalid dets are masked below
    inv_det = 1.0 / torch.where(det >= det_eps, det, 1.0)
    dst = ao.dot(normal_raw) * inv_det
    u = edge_ac.dot(dao) * inv_det
    v = -edge_ab.dot(dao) * inv_det
    w = 1.0 - u - v
    valid = ((det >= det_eps) & (dst >= eps) & (u >= eps) & (v >= eps)
             & (w >= eps))
    return torch.where(valid, dst, math.inf)


def triangle_distances(origin: Vec3, direction: Vec3, geom: TriangleGeom,
                       det_eps: float = 1e-6, eps: float = 1e-7) -> Tensor:
    """Distances (B, T); +inf where there is no hit."""
    col = lambda v: Vec3(*(c[:, None] for c in v))
    row = lambda v: Vec3(*(c[None, :] for c in v))
    return _distance(col(origin) - row(geom.a), col(direction),
                     row(geom.edge_ab), row(geom.edge_ac),
                     row(geom.normal_raw), det_eps, eps)


def triangle_distance_one(origin: Vec3, direction: Vec3, a: Vec3,
                          edge_ab: Vec3, edge_ac: Vec3, normal_raw: Vec3,
                          det_eps: float = 1e-6, eps: float = 1e-7) -> Tensor:
    """Per-ray distance to one gathered triangle (all (B,)): the winner's
    distance recomputed differentiably after the selection."""
    return _distance(origin - a, direction, edge_ab, edge_ac, normal_raw,
                     det_eps, eps)


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


class AABB(NamedTuple):
    """Axis-aligned box (BBox, triangle.hu:8-11): 0-dim corners."""

    mn: Vec3
    mx: Vec3


def build_aabb(tris: Triangles) -> AABB:
    """One box over every vertex of ``tris``."""
    lo = Vec3(*(torch.stack([a, b, c]).min()
                for a, b, c in zip(tris.a, tris.b, tris.c)))
    hi = Vec3(*(torch.stack([a, b, c]).max()
                for a, b, c in zip(tris.a, tris.b, tris.c)))
    return AABB(lo, hi)


def hit_aabb(origin: Vec3, direction: Vec3, box: AABB) -> Tensor:
    """Slab test with 1/d (hit_BBox, triangle.hu:42-59): (B,) bool, true
    where the ray's line meets the box at t >= 0."""
    t0, t1 = [], []
    for o, d, lo, hi in zip(origin, direction, box.mn, box.mx):
        inv = 1.0 / d
        t0.append((lo - o) * inv)
        t1.append((hi - o) * inv)
    near = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    far = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    tmin = torch.maximum(near[0], torch.maximum(near[1], near[2]))
    tmax = torch.minimum(far[0], torch.minimum(far[1], far[2]))
    return (tmax >= tmin) & (tmax >= 0.0)
