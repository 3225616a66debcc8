"""Closest-hit and any-hit queries of the scan path over spheres + triangles.

Port of ``raytpu/integrator/hit.py``. The reference's linear scan
(main.c:52-92: spheres, then triangles, a later primitive winning only on
a strictly smaller distance) is a selection followed by a differentiable
recompute:

* Selection runs without gradient on detached rays: the fused selection
  kernel K4 (``kernels/intersect.pallas_select``) where
  ``_resolve_use_pallas`` turns it on and the scene fits it, else the
  (rays x primitives) distance matrices of ``geometry/sphere`` and
  ``geometry/triangle`` and a first-index argmin per class. The matrices
  are built a block of rays at a time (``intersect.ray_blocks``), which
  changes no value.
* The winner's distance is then recomputed from the gathered primitive
  (``sphere_distance_one``, ``triangle_distance_one``), the same f32 value,
  differentiable in the ray and the primitive; its normal, material and
  texel follow by ``kernels.gather.gather`` (``raytpu``'s
  ``gather_channels`` is a TPU layout trick): all the sphere channels at
  the sphere index in one call, all the triangle channels at the
  triangle index in another, so each index is sorted once for the
  backward, which sums each row's cotangents in a fixed order without
  float atomics (``csrc/segment_sum.cu``).

The equirect sky (``Scene.sky_index``): where the sky sphere wins, its
emission is the sky texel at the hit (``materials.texture.sky_emission``),
detached unless ``cfg.sky_texture_grads``, as ``raytpu``'s
stop_gradient. ``raytpu``'s ``best_idx`` injection (the megakernel
backward's replay) is not needed: K2 replays instead.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from raytpu_torch.core.types import Materials, RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.geometry.sphere import (sphere_distance_one,
                                          sphere_distances, sphere_normal)
from raytpu_torch.geometry.triangle import (TriangleGeom, precompute,
                                            triangle_distance_one,
                                            triangle_distances)
from raytpu_torch.kernels import intersect
from raytpu_torch.kernels.gather import GatherIndex, gather
from raytpu_torch.materials.texture import sky_emission, triangle_material

_logged: set = set()


def log_once(msg: str) -> None:
    """One stderr line per message and process: why a render did not get
    the kernel it asked for."""
    if msg not in _logged:
        _logged.add(msg)
        print(f"raytpu_torch: {msg}", file=sys.stderr)


def _resolve_use_pallas(scene: Scene, cfg: RenderConfig) -> bool:
    """``cfg.use_pallas``, or when it is None: 128 or more triangles on a
    CUDA device (``raytpu``: on a non-CPU backend)."""
    if cfg.use_pallas is not None:
        return cfg.use_pallas
    return scene.triangles.count >= 128 and scene.device.type == "cuda"


def _use_kernel(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether the selection runs K4: resolved on and within its bounds.
    A scene past them takes the matrices, said once on stderr when
    ``use_pallas`` asked for the kernel."""
    if not _resolve_use_pallas(scene, cfg):
        return False
    if intersect.pallas_supported(scene):
        return True
    if cfg.use_pallas:
        log_once(f"closest-hit kernel unavailable ({scene.spheres.count} "
                  f"spheres, {scene.triangles.count} triangles; at most "
                  f"{intersect.MAX_PRIMS} of each); distance matrices "
                  "serve this render")
    return False


def _ray_blocks(scene: Scene, o: Vec3, d: Vec3):
    """(slice, origin, direction) over ``intersect.ray_blocks``."""
    n = max(scene.spheres.count, scene.triangles.count)
    for sl in intersect.ray_blocks(o.x.shape[0], n):
        yield sl, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d))


def _matrix_argmin(scene: Scene, geom, o: Vec3, d: Vec3, cfg: RenderConfig
                   ) -> tuple[Tensor, Tensor]:
    """First-index argmin per ray over the sphere and the triangle
    distance matrices (zeros for an empty class)."""
    s_idx = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    t_idx = torch.zeros_like(s_idx)
    sph = scene.spheres
    for sl, ob, db in _ray_blocks(scene, o, d):
        if sph.count:
            s_idx[sl] = torch.argmin(sphere_distances(
                ob, db, sph.center, sph.radius, eps=cfg.sphere_eps), dim=1)
        if scene.triangles.count:
            t_idx[sl] = torch.argmin(triangle_distances(
                ob, db, geom, det_eps=cfg.tri_det_eps, eps=cfg.tri_eps), dim=1)
    return s_idx, t_idx


def _matrix_any(scene: Scene, geom, o: Vec3, d: Vec3, cfg: RenderConfig
                ) -> Tensor:
    """Whether any primitive's distance is finite, per ray."""
    found = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    sph = scene.spheres
    for sl, ob, db in _ray_blocks(scene, o, d):
        if sph.count:
            found[sl] |= sphere_distances(
                ob, db, sph.center, sph.radius,
                eps=cfg.sphere_eps).isfinite().any(dim=1)
        if scene.triangles.count:
            found[sl] |= triangle_distances(
                ob, db, geom, det_eps=cfg.tri_det_eps,
                eps=cfg.tri_eps).isfinite().any(dim=1)
    return found


class Hit(NamedTuple):
    did_hit: Tensor   # (B,) bool
    dst: Tensor       # (B,) distance (inf on a miss)
    point: Vec3       # (B,)
    normal: Vec3      # (B,) geometric normal, not flipped (as the reference)
    mat: Materials    # (B,)


def _detached(v: Vec3) -> Vec3:
    return Vec3(*(c.detach() for c in v))


def closest_hit(scene: Scene, geom: Optional[TriangleGeom], origin: Vec3,
                direction: Vec3, cfg: RenderConfig) -> Hit:
    """closest_hit (main.c:52-92) for a batch of rays. ``geom`` is
    ``precompute(scene.triangles)`` (None computes it here)."""
    b = origin.x.shape[0]
    dev = origin.x.device
    n_spheres, n_tris = scene.spheres.count, scene.triangles.count
    inf = torch.full((b,), torch.inf, device=dev)
    if n_tris > 0 and geom is None:
        geom = precompute(scene.triangles)

    # selection: no gradient, detached rays and scene
    with torch.no_grad():
        o_sg, d_sg = _detached(origin), _detached(direction)
        if _use_kernel(scene, cfg):
            _, best_idx = intersect.pallas_select(
                scene, geom, o_sg, d_sg, cfg.sphere_eps, cfg.tri_det_eps,
                cfg.tri_eps)
            best_idx = best_idx.long()
            found = best_idx >= 0
            tri_wins = best_idx >= n_spheres
            s_idx = torch.where(tri_wins | ~found, 0, best_idx)
            t_idx = torch.where(tri_wins, best_idx - n_spheres, 0)
        else:
            s_idx, t_idx = _matrix_argmin(scene, geom, o_sg, d_sg, cfg)
            found = tri_wins = None   # decided on the recomputed distances

    # the winners' rows: every sphere channel (centre, radius, material)
    # in one gather, every triangle channel in another
    if n_spheres > 0:
        sph = scene.spheres
        sm = sph.mat
        w = gather(GatherIndex(s_idx, n_spheres), (
            *sph.center, sph.radius, *sm.diffuse, *sm.emission,
            sm.emission_strength, sm.reflection, sm.alpha, sm.ior))
        centers, radii = Vec3(*w[0:3]), w[3]
        m_s = Materials(Vec3(*w[4:7]), Vec3(*w[7:10]), *w[10:14])
        # the winner's distance, recomputed differentiably
        s_t = sphere_distance_one(origin, direction, centers, radii,
                                  eps=cfg.sphere_eps)
    else:
        s_t = inf
    if n_tris > 0:
        tris = scene.triangles
        w = gather(GatherIndex(t_idx, n_tris), (
            *geom.a, *geom.edge_ab, *geom.edge_ac, *geom.normal_raw,
            *tris.b, *tris.c, tris.ua, tris.va, tris.ub, tris.vb, tris.uc,
            tris.vc, tris.mat_id))
        win_a, win_ab, win_ac, win_nraw, win_b, win_c = (
            Vec3(*w[j:j + 3]) for j in range(0, 18, 3))
        t_t = triangle_distance_one(origin, direction, win_a, win_ab, win_ac,
                                    win_nraw, det_eps=cfg.tri_det_eps,
                                    eps=cfg.tri_eps)
    else:
        t_t = inf

    if tri_wins is None:
        # spheres first; a triangle wins only on a strictly smaller distance
        tri_wins = t_t < s_t
        found = torch.where(tri_wins, t_t, s_t).isfinite()

    dst = torch.where(found, torch.where(tri_wins, t_t, s_t), torch.inf)
    did_hit = dst.isfinite()
    safe_dst = torch.where(did_hit, dst, 0.0)
    point = origin + direction * safe_dst

    normal = Vec3.zeros((b,), dev)
    mat = Materials.zeros((b,), dev)
    if n_spheres > 0:
        if scene.sky_index >= 0:
            # the sky sphere's emission is the texel it shows at the hit
            sky_rgb = sky_emission(scene.sky, point, centers, radii)
            if not cfg.sky_texture_grads:
                sky_rgb = Vec3(*(c.detach() for c in sky_rgb))
            is_sky = s_idx == scene.sky_index
            m_s = Materials(m_s.diffuse,
                            Vec3.where(is_sky, sky_rgb, m_s.emission),
                            m_s.emission_strength, m_s.reflection, m_s.alpha,
                            m_s.ior)
        sphere_sel = did_hit & ~tri_wins
        normal = Vec3.where(sphere_sel, sphere_normal(point, centers), normal)
        mat = Materials.where(sphere_sel, m_s, mat)
    if n_tris > 0:
        n_t = win_nraw.normalize()
        m_t = triangle_material(
            win_a, win_b, win_c, (w[18], w[19]), (w[20], w[21]),
            (w[22], w[23]), n_t, point, w[24], scene.atlas, scene.mat_table,
            bilinear=cfg.bilinear_textures)
        tri_sel = did_hit & tri_wins
        normal = Vec3.where(tri_sel, n_t, normal)
        mat = Materials.where(tri_sel, m_t, mat)
    return Hit(did_hit, dst, point, normal, mat)


def any_hit(scene: Scene, geom: Optional[TriangleGeom], origin: Vec3,
            direction: Vec3, cfg: RenderConfig) -> Tensor:
    """Occlusion query of the AO probes (main.c:94-116): did the ray hit
    anything? A boolean with no gradient: K4's winner >= 0, or any finite
    entry of the distance matrices."""
    if scene.triangles.count > 0 and geom is None:
        geom = precompute(scene.triangles)
    with torch.no_grad():
        o_sg, d_sg = _detached(origin), _detached(direction)
        if _use_kernel(scene, cfg):
            _, best_idx = intersect.pallas_select(
                scene, geom, o_sg, d_sg, cfg.sphere_eps, cfg.tri_det_eps,
                cfg.tri_eps)
            return best_idx >= 0
        return _matrix_any(scene, geom, o_sg, d_sg, cfg)
