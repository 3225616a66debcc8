"""The fused closest-hit selection (K4) of the scan path.

Port of ``raytpu/kernels/intersect.py`` (``_intersect_kernel``, launched by
``_intersect_call``, entry point ``pallas_select``): per ray the winner
``(best_t, best_idx)`` over spheres then triangles, with no shading, so
the scan path (``integrator/hit``) never builds its (rays x primitives)
distance matrices. Spheres are scanned before triangles and a later
primitive wins only on a strictly smaller t; a triangle t is reported as
``n_spheres + t``, a miss as ``(BIG, -1)``. The arithmetic is K4's own,
which differs from ``geometry.sphere.sphere_distances`` in its sqrt floor
(``sqrt(max(disc, 0))``) and computes |d|^2 once per ray.

``pallas_select`` is the entry point. On CUDA tensors it launches the
hand-written kernel in ``csrc/intersect.cu``; on CPU tensors it runs
``intersect_reference``, the plain PyTorch version, which scans every
primitive with no cull (the kernel culls KERNEL_CHUNK-triangle chunks by
box against each ray's running best, and equals this version bit for bit
on the card, which is what shows the cull exact). Selection only: the
result carries no gradient, and the scan path recomputes the winner's
distance differentiably. The tables (``pack_tables``) are ``raytpu``'s
without its 128-lane padding: spheres (4, S), triangles (12, T) and one
box per chunk of triangles (6, C), 128 a chunk as in ``raytpu`` unless
asked otherwise (``kernel_tables``: the kernel's chunk).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from raytpu_torch.core.types import Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.geometry.triangle import TriangleGeom, triangle_distances
from raytpu_torch.kernels.trace_scene import chunk_boxes, entered_boxes

BIG = 3.0e38
MAX_PRIMS = 4096    # raytpu's MAX_SMEM_PRIMS, kept so both route the same scenes
CHUNK = 128         # triangles per box in raytpu's tables
KERNEL_CHUNK = 32   # triangles per cull box of the kernel (csrc/intersect.cu:
                    # kChunk; PERF.md: 32 beat 16, 64 and 128 on the card)
BLOCK_ELEMS = 1 << 24   # (rays x primitives) entries per block of rays

launches = 0   # kernel launches by pallas_select (CPU calls do not count)


def pallas_supported(scene: Scene) -> bool:
    """At most MAX_PRIMS spheres and MAX_PRIMS triangles (``raytpu``'s
    SMEM bound); the scan path uses its distance matrices otherwise."""
    return (scene.spheres.count <= MAX_PRIMS
            and scene.triangles.count <= MAX_PRIMS)


def ray_blocks(n_rays: int, n_prims: int):
    """Slices over blocks of rays whose (rays x primitives) intermediates
    hold at most BLOCK_ELEMS entries: the plain version's and the scan
    path's distance matrices. Blocking changes no value."""
    step = max(1, BLOCK_ELEMS // max(n_prims, 1))
    for lo in range(0, n_rays, step):
        yield slice(lo, lo + step)


def pack_tables(scene: Scene, geom: Optional[TriangleGeom],
                chunk: int = CHUNK) -> tuple[Tensor, Tensor, Tensor]:
    """(sph (4, S): cx cy cz r; tri (12, T): a, b - a, c - a, raw normal;
    boxes (6, ceil(T / chunk)): lo3 hi3 over each chunk's corners a, a + ab
    and a + ac, inflated by 1e-5 (|x| + 1)), contiguous f32, detached."""
    s = scene.spheres
    sph = torch.stack([*s.center, s.radius])
    if scene.triangles.count:
        tri = torch.stack([*geom.a, *geom.edge_ab, *geom.edge_ac,
                           *geom.normal_raw])
        corners = [(tri[r], tri[r] + tri[r + 3], tri[r] + tri[r + 6])
                   for r in range(3)]
        boxes = chunk_boxes(*map(list, corners), tri.shape[1], chunk)
    else:
        tri = sph.new_zeros((12, 0))
        boxes = sph.new_zeros((6, 0))
    f = lambda t: t.detach().to(torch.float32).contiguous()
    return f(sph), f(tri), f(boxes)


def kernel_tables(scene: Scene, geom: Optional[TriangleGeom]
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """``pack_tables`` with the kernel's chunk boxes."""
    return pack_tables(scene, geom, KERNEL_CHUNK)


def _sphere_hits(sph: Tensor, o, d, a_quad, inv_2a, eps: float) -> Tensor:
    """(B, S) distances with K4's arithmetic, BIG where there is no root."""
    ocx, ocy, ocz = (oc[:, None] - sph[r][None, :]
                     for r, oc in enumerate(o))
    dx, dy, dz = (c[:, None] for c in d)
    r = sph[3][None, :]
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * a_quad[:, None] * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) * inv_2a[:, None]
    t2 = (-b + sq) * inv_2a[:, None]
    hit = disc > 0.0
    return torch.where(hit & (t1 >= eps), t1,
                       torch.where(hit & (t2 >= eps), t2, BIG))


def _entered_chunks(boxes: Tensor, o, d) -> Tensor:
    """(B, C) whether each ray's line enters each chunk box ahead of its
    origin, an axis with a NaN product unconstrained (the kernel's test)."""
    return entered_boxes(boxes, o, d)[0]


def _culled_tests(boxes: Tensor, o, d, best: Tensor, tt: Tensor,
                  chunk: int) -> int:
    """Triangle tests of the kernel's cull at ray granularity: the chunks
    each ray enters before its running best (the spheres' winner ``best``,
    then each entered chunk's least distance of ``tt``, (B, T)), in index
    order."""
    enter, tmin = entered_boxes(boxes, o, d)
    n_c = boxes.shape[1]
    pad = n_c * chunk - tt.shape[1]
    mins = torch.nn.functional.pad(tt, (0, pad), value=BIG).view(
        -1, n_c, chunk).amin(dim=2)
    sizes = torch.clamp(tt.shape[1] - chunk * torch.arange(
        n_c, device=tt.device), max=chunk)
    tests = torch.zeros_like(best, dtype=torch.int64)
    for c in range(n_c):
        e = enter[:, c] & (tmin[:, c] < best)
        tests += e.long() * sizes[c]
        best = torch.where(e, torch.minimum(best, mins[:, c]), best)
    return int(tests.sum())


@torch.no_grad()
def intersect_reference(sph: Tensor, tri: Tensor, boxes: Tensor, ox: Tensor,
                        oy: Tensor, oz: Tensor, dx: Tensor, dy: Tensor,
                        dz: Tensor, sphere_eps: float, det_eps: float,
                        tri_eps: float, counts: Optional[dict] = None,
                        chunk: int = CHUNK) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: every primitive of every ray,
    no cull, over ``ray_blocks``. Ties go to the
    first primitive, as the kernel's strict t < best. ``counts``, a dict,
    receives the work this input needs at ray granularity: ``sphere``
    tests, ``slab`` tests (one a box of ``chunk`` triangles) and ``tri``
    tests of the chunks each ray enters before its running best, in index
    order (the kernel's cull)."""
    n_s, n_t = sph.shape[1], tri.shape[1]
    b = ox.shape[0]
    best_t = torch.full((b,), BIG, dtype=torch.float32, device=ox.device)
    best_i = torch.full((b,), -1, dtype=torch.int32, device=ox.device)
    geom = TriangleGeom(Vec3(*tri[3:6]), Vec3(*tri[6:9]), Vec3(*tri[9:12]),
                        None, Vec3(*tri[0:3]))
    for sl in ray_blocks(b, max(n_s, n_t)):
        o = tuple(c[sl] for c in (ox, oy, oz))
        d = tuple(c[sl] for c in (dx, dy, dz))
        a_quad = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inv_2a = 0.5 / torch.clamp(a_quad, min=1e-20)
        t = torch.full_like(o[0], BIG)
        idx = torch.full_like(o[0], -1, dtype=torch.int32)
        if n_s:
            ts = _sphere_hits(sph, o, d, a_quad, inv_2a, sphere_eps)
            t_s, j = torch.min(ts, dim=1)
            better = t_s < t
            t = torch.where(better, t_s, t)
            idx = torch.where(better, j.to(torch.int32), idx)
        if counts is not None:
            n = o[0].shape[0]
            counts["sphere"] += n * n_s
            counts["slab"] += n * boxes.shape[1]
        if n_t:
            tt = triangle_distances(Vec3(*o), Vec3(*d), geom, det_eps, tri_eps)
            if counts is not None:
                counts["tri"] += _culled_tests(boxes, o, d, t, tt, chunk)
            t_t, j = torch.min(tt, dim=1)
            better = t_t < t
            t = torch.where(better, t_t, t)
            idx = torch.where(better, (n_s + j).to(torch.int32), idx)
        best_t[sl] = t
        best_i[sl] = idx
    return best_t, best_i


_ARGTYPES = ([ctypes.c_void_p] * 11          # 3 tables, 6 rays, t_out, idx_out
             + [ctypes.c_int] * 3            # n_rays n_spheres n_tris
             + [ctypes.c_float] * 3          # sphere/det/tri eps
             + [ctypes.c_void_p])            # stream


def _library():
    from raytpu_torch.kernels import _build

    fn = _build.load("intersect").raytpu_intersect
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(sph: Tensor, tri: Tensor, boxes: Tensor, rays: tuple,
            sphere_eps: float, det_eps: float, tri_eps: float
            ) -> tuple[Tensor, Tensor]:
    """Launch ``csrc/intersect.cu`` on the current stream; ``boxes`` are
    those of KERNEL_CHUNK triangles (``kernel_tables``)."""
    global launches
    dev = rays[0].device
    b = rays[0].shape[0]
    for t in (sph, tri, boxes, *rays):
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"intersect kernel: want contiguous f32 on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if any(r.shape != (b,) for r in rays):
        raise ValueError("intersect kernel: the six ray planes must be (B,)")
    if boxes.shape != (6, -(-tri.shape[1] // KERNEL_CHUNK)):
        raise ValueError(f"intersect kernel: boxes {tuple(boxes.shape)} are "
                         f"not those of {KERNEL_CHUNK}-triangle chunks")
    best_t = torch.empty((b,), dtype=torch.float32, device=dev)
    best_i = torch.empty((b,), dtype=torch.int32, device=dev)
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(sph.data_ptr(), tri.data_ptr(), boxes.data_ptr(),
                 *(r.data_ptr() for r in rays), best_t.data_ptr(),
                 best_i.data_ptr(), b, sph.shape[1], tri.shape[1],
                 sphere_eps, det_eps, tri_eps, stream)
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: cudaError {err}")
    launches += 1
    return best_t, best_i


def func_attrs() -> dict:
    """The kernel's attributes as the driver of the current card holds
    them (``cudaFuncGetAttributes``): registers and local bytes a thread,
    static shared bytes, and the dynamic shared bytes of the last launch."""
    from raytpu_torch.kernels import _build

    fn = _build.load("intersect").raytpu_intersect_attrs
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return _build.func_attrs(fn)


@torch.no_grad()
def pallas_select(scene: Scene, geom: Optional[TriangleGeom], origin: Vec3,
                  direction: Vec3, sphere_eps: float, det_eps: float,
                  tri_eps: float) -> tuple[Tensor, Tensor]:
    """Winner selection for a ray batch: (best_t (B,) f32, best_idx (B,)
    int32). ``best_idx`` < n_spheres is a sphere, otherwise triangle
    ``best_idx - n_spheres``; -1 is a miss (best_t == BIG). ``geom`` is
    ``precompute(scene.triangles)`` (None without triangles). Runs on the
    device of the rays: the kernel for CUDA tensors, the plain version for
    CPU tensors. Not differentiable."""
    if not pallas_supported(scene):
        raise ValueError(f"intersect: {scene.spheres.count} spheres and "
                         f"{scene.triangles.count} triangles; at most "
                         f"{MAX_PRIMS} of each")
    tables = kernel_tables(scene, geom)
    rays = tuple(c.detach().to(torch.float32).contiguous()
                 for c in (*origin, *direction))
    dev = rays[0].device
    if dev.type == "cuda":
        return _launch(*tables, rays, sphere_eps, det_eps, tri_eps)
    if dev.type == "cpu":
        return intersect_reference(*tables, *rays, sphere_eps, det_eps, tri_eps)
    raise NotImplementedError(f"intersect: no kernel for {dev}")
