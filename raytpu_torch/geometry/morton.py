"""Morton (Z-order) triangle reordering for cull locality.

Port of ``raytpu/geometry/morton.py``: a stable sort of the triangles by
the 30-bit Morton code of their centroid (host-side numpy, once at scene
load), so that the 32 consecutive triangles of a cull chunk are spatial
neighbours and their box is small. The order is ``raytpu``'s exactly:
winner indices recorded by the kernels index this order.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.core.types import Triangles
from raytpu_torch.core.vec3 import Vec3


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v with two zero bits between each."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def morton_codes(cx: np.ndarray, cy: np.ndarray, cz: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points normalized to their bounding box."""
    codes = np.zeros(cx.shape, np.uint64)
    for i, c in enumerate((cx, cy, cz)):
        lo, hi = float(c.min()), float(c.max())
        span = hi - lo
        q = (np.zeros_like(c) if span <= 0
             else np.clip((c - lo) / span * 1023.0, 0, 1023))
        codes |= _spread_bits(q.astype(np.uint32)) << np.uint64(i)
    return codes


def morton_order(tris: Triangles) -> Triangles:
    """Stable-sort the triangle SoA by centroid Morton code."""
    if tris.count <= 1:
        return tris
    np_ = lambda t: t.detach().cpu().numpy()
    (ax, ay, az), (bx, by, bz), (cx, cy, cz) = (
        map(np_, v) for v in (tris.a, tris.b, tris.c))
    codes = morton_codes((ax + bx + cx) / 3.0, (ay + by + cy) / 3.0,
                         (az + bz + cz) / 3.0)
    perm = np.argsort(codes, kind="stable")
    if (perm == np.arange(perm.size)).all():
        return tris
    idx = torch.as_tensor(perm, device=tris.mat_id.device)
    take = lambda t: t[idx]
    takev = lambda v: Vec3(take(v.x), take(v.y), take(v.z))
    return Triangles(
        a=takev(tris.a), b=takev(tris.b), c=takev(tris.c),
        ua=take(tris.ua), va=take(tris.va), ub=take(tris.ub),
        vb=take(tris.vb), uc=take(tris.uc), vc=take(tris.vc),
        mat_id=take(tris.mat_id),
    )
