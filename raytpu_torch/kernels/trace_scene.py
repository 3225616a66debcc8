"""The mesh megakernel (K3) and the bounce shading its kernels share.

Port of ``raytpu/kernels/trace_scene.py``: the whole forward bounce loop
over spheres plus up to 2048 textured triangles in one launch (``_kernel``
-> ``bounce_body``, launched by ``_trace_call``), with its recording mode
for the backward, its equirect-sky slot and its merged-quad search.
Per ray and bounce: the closest sphere (scanned first, strict t < best),
then the triangles, the winner's barycentric UVs, nearest texel and
material-table row, the AO probes, and ``shade_bounce``.

The triangle search has two modes, as in ``raytpu``. Triangle by
triangle (``merge_quads=False``, or no quad pairs: ``quad_plan`` is None
for any mesh without coplanar parallelogram pairs and any scene built in
code without them): the triangles of every 32-triangle chunk whose box
the ray enters before its current best (Moller-Trumbore); the kernel
searches a warp's 32 rays together, and ``_closest_triangle`` counts the
work of its warps (``tests/test_torch_k3_warp.py`` emulates their
schedule). Merged (``merge_quads`` with the pairs ``config``
detected, ``geometry/quads``; ``MeshKnobs.plan``): candidates rank as
fractions t = num / den, with one division per ray and bounce at the end.
The six (normal axis, sign) groups of axis-aligned rectangles and unpaired
triangles run first, in ``aa_layout`` order (rects with e1 on the lower
in-plane axis, then the higher, then the triangles; the candidates of a
group share the denominator -s d_k, so they rank by numerator, and the
group's winner joins the running one by a fraction compare gated on a
hit; the kernel walks each group's sub-lists in plane order over
``walk_tables``, which ``_aa_walk`` emulates for the tests and the
counts), then the general parallelograms and the general leftover
triangles, each behind a fraction-ranked chunk cull once there are more
than 2 * CULL_CHUNK of them. A parallelogram's winner is the half on its
side of the diagonal, so the recorded winner stays an original triangle
index and K2's mesh mode replays it unchanged; AO probes stay per
triangle. The merged search accepts the ~tri_eps crack the per-triangle
test leaves along a pair's diagonal and rounds differently, so the two
modes agree by winners and outliers (``tests/test_quad_merge.py``'s
bars), not bit for bit.

The equirect sky (``Scene.sky_index``): the 4096x2048 sky textures are
not read in the kernel. Each ray keeps one sky slot (``take_sky_slot``):
the throughput scale of its first sky event, the unit hit direction on
the sky sphere and whether that event was an emissive early return; the
sky sphere's own emission is zeroed in the loop, and
``trace_spheres.compose_sky`` adds the texel outside. One slot is exact
because the sky sphere has black diffuse (``config`` enforces it): the
first sky event ends the ray's sky contribution. With the sky on, the
kernel returns 16 planes instead of 9.

``trace_mesh_megakernel`` is the entry point. On CUDA tensors it launches
the hand-written kernel in ``csrc/trace_scene.cu``, which takes the rays'
threefry keys ((2, B) int32, ``render.sample_start``) and hashes each
bounce's draws where it reads them, at K1's counters; on CPU tensors it
runs ``trace_scene_reference``, the plain PyTorch version of the same
loop, on the keys' draws (``rng.bounce_draws``) or on a draw buffer,
which the tests hold against ``raytpu`` and the chip check holds the
kernel against. The packers (``pack_tri``, ``chunk_boxes``, ``pack_mats``,
``pack_atlas``, and for the merged search ``pack_aa``, ``pack_quads`` and
``walk_tables``) fix the tables both read (``render`` builds the ones
derived from ``tri`` once a call: ``frame_selection``); ``raytpu``'s bf16 limbs, one-hot layouts and
SMEM padding are TPU tricks and become plain indexed loads.

Gradients: ``TraceMesh`` joins K3 in recording mode (each bounce's winner
index and AO factor) to K2's mesh mode (``trace_scene_bwd.mesh_backward``);
autograd pulls the table cotangents back through the packers onto the
scene leaves.

``shade_bounce`` (``raytpu``'s, op for op) is everything after the winner's
(point, normal, material) is known. Three plain versions run it: K3's and
K1's (``trace_spheres_reference``) after their searches, and K2's
(``trace_scene_bwd.replay_bounce``) after it rebuilds the recorded winner;
sharing it keeps them in step, which the gradient tests rely on. Its
carry is the 22-plane tuple of ``raytpu``'s replay: ``(ro xyz, rd xyz,
throughput xyz, radiance xyz, albedo AOV xyz, normal AOV xyz, active,
is_alpha, alpha_depth, medium_n2)``, with the two masks as f32 0/1 planes
and ``alpha_depth`` as int32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from raytpu_torch import observe
from raytpu_torch.core import rng
from raytpu_torch.core.color import hsl_boost
from raytpu_torch.core.types import (MatTable, RenderConfig, Scene, TextureAtlas,
                                     requires_grad)
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.geometry.triangle import precompute
from raytpu_torch.materials.texture import triangle_material

TWO_PI = 2.0 * float(np.float32(math.pi))  # 2 * f32(pi), exact in f32
BIG = 3.0e38
MAX_SPHERES = 64
MAX_TRIS = 2048     # raytpu's SMEM budget; kept so both take the same scenes
MAX_MATS = 64
MAX_TEX_W4 = 256    # raytpu's texture-row fetch bounds (4 * atlas width,
MAX_TEX_ROWS = 512  # texture rows), kept for the same reason
CULL_CHUNK = 32     # triangles per cull box
WARP = 32           # rays a warp of the per-triangle kernel searches together
COOP_MIN = 16       # lanes entering a chunk from which each scans it alone
                    # (the kernel's Knobs::coop_min, passed at each launch)
WALK_CHUNK = 8      # columns per chunk box of the merged search's walk
                    # (csrc/trace_scene.cu: kWalkChunk)

launches = 0   # kernel launches by trace_mesh_megakernel (CPU calls do not count)


@dataclass(frozen=True)
class Knobs:
    """The loop's static parameters (``_statics``), with the two
    products ``raytpu`` forms in double precision before rounding to f32."""

    n_spheres: int
    bounces: int
    n_draws: int
    sphere_eps: float
    alpha_lo: float
    alpha_hi: float
    bright_boost: float
    bright_threshold: float
    use_ao: bool
    ao_samples: int
    ao_e_scale: float   # ao_emission_factor * ao_intensity
    ao_inv: float       # 1 / (ao_samples * ao_intensity)
    hsl_l: float
    hsl_s: float
    sky_idx: int        # the sky sphere with the sky slot on, else -1

    @staticmethod
    def create(cfg: RenderConfig, n_spheres: int, n_draws: int,
               sky_idx: int = -1) -> "Knobs":
        return Knobs(
            n_spheres=n_spheres, bounces=cfg.max_bounces, n_draws=n_draws,
            sphere_eps=cfg.sphere_eps, alpha_lo=cfg.refr_alpha_lo,
            alpha_hi=cfg.refr_alpha_hi, bright_boost=cfg.bright_boost,
            bright_threshold=cfg.bright_threshold, use_ao=cfg.use_ao,
            ao_samples=cfg.ao_samples,
            ao_e_scale=cfg.ao_emission_factor * cfg.ao_intensity,
            ao_inv=1.0 / (cfg.ao_samples * cfg.ao_intensity),
            hsl_l=cfg.hsl_l_factor, hsl_s=cfg.hsl_s_factor, sky_idx=sky_idx,
        )

    @property
    def hsl_on(self) -> bool:
        return not (self.hsl_l == 1.0 and self.hsl_s == 1.0)

    @property
    def e_scale_mult(self) -> float:
        return self.ao_e_scale if self.use_ao else 1.0

    @property
    def shade_kw(self) -> dict:
        """The static knobs ``trace_scene.shade_bounce`` takes."""
        return dict(alpha_lo=self.alpha_lo, alpha_hi=self.alpha_hi,
                    bright_boost=self.bright_boost,
                    bright_threshold=self.bright_threshold,
                    hsl_l=self.hsl_l, hsl_s=self.hsl_s)

    @property
    def draws_needed(self) -> int:
        return 3 + 2 * (self.ao_samples if self.use_ao else 0)


class QuadPlan(NamedTuple):
    """The merged search's static selection (``raytpu``'s
    ``_aa_partition`` and the arguments of its ``pack_aa`` /
    ``pack_quads``), from the config's quad fields."""

    aa_layout: tuple   # 6 x (k, s, rects m=0, rects m=1, triangles), in
                       # the group order (0,+1) (0,-1) (1,+1) ... (2,-1)
    rects: tuple       # (i, j, oi, k, s, m) per axis-aligned rect, in table order
    aa_tris: tuple     # (t, k, s) per axis-aligned unpaired triangle
    quads: tuple       # (i, j, oi) per general parallelogram
    leftovers: tuple   # the general unpaired triangles


def aa_partition(rect_classes, tri_classes):
    """``raytpu``'s ``_aa_partition``: ``(layout, rect_sel, tri_sel)``, the
    six (k, s, n_rect_m0, n_rect_m1, n_tri) groups in fixed order and the
    (pair index, k, s, m) / (tri, k, s) columns in group-major order."""
    layout, rect_sel, tri_sel = [], [], []
    for k in range(3):
        for s in (1, -1):
            ra = [p for p, c in enumerate(rect_classes) if c == (k, s, 0)]
            rb = [p for p, c in enumerate(rect_classes) if c == (k, s, 1)]
            tt = [t for (t, kk, ss) in tri_classes if (kk, ss) == (k, s)]
            layout.append((k, s, len(ra), len(rb), len(tt)))
            rect_sel += [(p, k, s, 0) for p in ra] + [(p, k, s, 1) for p in rb]
            tri_sel += [(t, k, s) for t in tt]
    return tuple(layout), rect_sel, tri_sel


def quad_plan(cfg: RenderConfig, n_tris: int) -> Optional[QuadPlan]:
    """The merged search's plan, or None for the per-triangle search (no
    pairs, or ``merge_quads`` off), as ``raytpu``'s ``_mkm_forward``
    decides. Rect classes that do not match the pairs in number count
    as general, as there."""
    from raytpu_torch.geometry.quads import leftover_indices

    pairs = cfg.quad_pairs if cfg.merge_quads else ()
    if not pairs:
        return None
    rect_classes = (cfg.quad_aa_rects if len(cfg.quad_aa_rects) == len(pairs)
                    else ((),) * len(pairs))
    layout, rect_sel, tri_sel = aa_partition(rect_classes, cfg.quad_aa_tris)
    aa_set = {t for t, _, _ in cfg.quad_aa_tris}
    return QuadPlan(
        aa_layout=layout,
        rects=tuple((*pairs[p], k, s, m) for p, k, s, m in rect_sel),
        aa_tris=tuple(tri_sel),
        quads=tuple(p for p, c in zip(pairs, rect_classes) if c == ()),
        leftovers=tuple(t for t in leftover_indices(n_tris, pairs)
                        if t not in aa_set),
    )


@dataclass(frozen=True)
class MeshKnobs(Knobs):
    """K3's static parameters: K1's plus the triangle epsilons, the table
    sizes and, for the merged search, its plan (``aa_layout``,
    ``n_quads``, ``n_leftover``)."""

    n_tris: int
    n_mats: int
    n_tex: int          # atlas texels (0: untextured)
    atlas_w: int
    atlas_h: int
    det_eps: float
    tri_eps: float
    plan: Optional[QuadPlan] = None   # None: the per-triangle search

    @staticmethod
    def for_scene(cfg: RenderConfig, scene: Scene, n_draws: int) -> "MeshKnobs":
        base = Knobs.create(cfg, scene.spheres.count, n_draws, scene.sky_index)
        return MeshKnobs(
            **base.__dict__, n_tris=scene.triangles.count,
            n_mats=scene.mat_table.count, n_tex=scene.atlas.alpha.shape[0],
            atlas_w=scene.atlas.width, atlas_h=scene.atlas.height,
            det_eps=cfg.tri_det_eps, tri_eps=cfg.tri_eps,
            plan=quad_plan(cfg, scene.triangles.count),
        )

    @property
    def aa_layout(self) -> Optional[tuple]:
        return None if self.plan is None else self.plan.aa_layout

    @property
    def n_quads(self) -> int:
        return 0 if self.plan is None else len(self.plan.quads)

    @property
    def n_leftover(self) -> int:
        return 0 if self.plan is None else len(self.plan.leftovers)

    @staticmethod
    def of_spheres(k: Knobs) -> "MeshKnobs":
        """K1's knobs ``k`` with no triangles, materials or texels."""
        return MeshKnobs(**k.__dict__, n_tris=0, n_mats=0, n_tex=0,
                         atlas_w=1, atlas_h=1, det_eps=0.0, tri_eps=0.0)

    @property
    def n_chunks(self) -> int:
        return -(-self.n_tris // CULL_CHUNK)


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """K3's gates: ``raytpu``'s (1 to 2048 triangles, at most 64 spheres
    and 64 materials, nearest textures within the texture-row bounds, a
    sky sphere index in range)."""
    return not unsupported_reasons(scene, cfg)


def unsupported_reasons(scene: Scene, cfg: RenderConfig) -> list[str]:
    """Human-readable failed gates of ``supported``."""
    n_tex = scene.atlas.alpha.shape[0]
    w = max(scene.atlas.width, 1)
    n_t, n_s, n_m = scene.triangles.count, scene.spheres.count, scene.mat_table.count
    r = []
    if n_t == 0:
        r.append("no triangles (sphere kernel territory)")
    if n_t > MAX_TRIS:
        r.append(f"{n_t} triangles > {MAX_TRIS}")
    if n_s > MAX_SPHERES:
        r.append(f"{n_s} spheres > {MAX_SPHERES}")
    if scene.sky_sphere_index >= n_s:
        r.append("sky_sphere_index out of range")
    if n_tex > 0 and cfg.bilinear_textures:
        r.append("bilinear texture filtering")
    if n_m > MAX_MATS:
        r.append(f"{n_m} materials > {MAX_MATS}")
    if 4 * w > MAX_TEX_W4:
        r.append(f"atlas width {w} > {MAX_TEX_W4 // 4} (texture-row fetch bound)")
    if -(-n_tex // w) > MAX_TEX_ROWS:
        r.append(f"{-(-n_tex // w)} texture rows > {MAX_TEX_ROWS}")
    return r


def initial_carry(rox, roy, roz, rdx, rdy, rdz) -> tuple:
    """Carry at bounce 0: unit throughput, zero sums, every ray active."""
    f0 = torch.zeros_like(rox)
    f1 = torch.ones_like(rox)
    i0 = torch.zeros_like(rox, dtype=torch.int32)
    return (rox, roy, roz, rdx, rdy, rdz, f1, f1, f1,
            f0, f0, f0, f0, f0, f0, f0, f0, f0,
            f1, f0, i0, f1)


def shade_bounce(i: int, carry, did_hit, px, py, pz, nX, nY, nZ,
                 dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha, ior,
                 u_d, v_d, roulette, *, alpha_lo, alpha_hi, bright_boost,
                 bright_threshold, hsl_l, hsl_s, e_scale_mult=1.0,
                 ao_factor=None, with_masks=False):
    """Everything after the winner's (point, normal, material) is known:
    AOV base cases, emissive early return with the HSL boost, scatter,
    refraction, cutout and accumulation. ``i`` is the static bounce index.
    ``with_masks`` also returns the (emissive_ret, accum) masks the sky
    slot reads (``take_sky_slot``).

    ``e_scale_mult`` is the AO mode's emission compensation
    (ao_emission_factor * ao_intensity) and ``ao_factor`` the occlusion
    plane that scales the throughput update after the x1.3 bright quirk;
    the backward replay passes the factor the forward recorded, as a
    constant (it is piecewise constant in every parameter).
    """
    (rox, roy, roz, rdx, rdy, rdz,
     rcx, rcy, rcz, ix, iy, iz,
     ax_, ay_, az_, nx_, ny_, nz_,
     active_f, is_alpha_f, alpha_depth, medium_n2) = carry
    f0 = torch.zeros_like(rox)
    f1 = torch.ones_like(rox)
    active = active_f > 0.0
    is_alpha = is_alpha_f > 0.0

    if i == 0:
        ax_, ay_, az_ = dfx, dfy, dfz
        nx_, ny_, nz_ = nX, nY, nZ
    else:
        aov_alpha = active & (alpha_depth == i) & is_alpha
        em = estr > 0.0
        ax_ = torch.where(aov_alpha, torch.where(em, emx, dfx), ax_)
        ay_ = torch.where(aov_alpha, torch.where(em, emy, dfy), ay_)
        az_ = torch.where(aov_alpha, torch.where(em, emz, dfz), az_)
        nx_ = torch.where(aov_alpha, nX, nx_)
        ny_ = torch.where(aov_alpha, nY, ny_)
        nz_ = torch.where(aov_alpha, nZ, nz_)
        is_alpha = is_alpha & ~aov_alpha
        is_alpha_f = torch.where(is_alpha, f1, f0)

    emissive_ret = active & did_hit & (alpha_depth == i) & (estr > 0.0)
    bx, by, bz = hsl_boost(Vec3(emx, emy, emz), hsl_l, hsl_s)
    ix = torch.where(emissive_ret, bx, ix)
    iy = torch.where(emissive_ret, by, iy)
    iz = torch.where(emissive_ret, bz, iz)
    ax_ = torch.where(emissive_ret, bx, ax_)
    ay_ = torch.where(emissive_ret, by, ay_)
    az_ = torch.where(emissive_ret, bz, az_)
    nx_ = torch.where(emissive_ret, nX, nx_)
    ny_ = torch.where(emissive_ret, nY, ny_)
    nz_ = torch.where(emissive_ret, nZ, nz_)
    active = active & ~emissive_ret
    live = active & did_hit

    # ---- scatter: diffuse/specular lerp ----------------------------------
    theta = TWO_PI * u_d
    cph = torch.clamp(2.0 * v_d - 1.0, -1.0, 1.0)
    sph_ = torch.sqrt(torch.clamp(1.0 - cph * cph, min=0.0))
    ddx, ddy, ddz = Vec3(
        nX + torch.cos(theta) * sph_, nY + torch.sin(theta) * sph_, nZ + cph
    ).normalize()
    vdn = rdx * nX + rdy * nY + rdz * nZ
    rfx = rdx - 2.0 * vdn * nX
    rfy = rdy - 2.0 * vdn * nY
    rfz = rdz - 2.0 * vdn * nZ
    drx = ddx + (rfx - ddx) * refl
    dry = ddy + (rfy - ddy) * refl
    drz = ddz + (rfz - ddz) * refl

    # ---- refraction (reduced pile.h medium stack) ------------------------
    refr_case = live & (alpha <= alpha_hi) & (alpha >= alpha_lo)
    exiting = vdn > 0.0
    nex = torch.where(exiting, -nX, nX)
    ney = torch.where(exiting, -nY, nY)
    nez = torch.where(exiting, -nZ, nZ)
    n1_ = torch.where(exiting, ior, medium_n2)
    n2_ = torch.where(exiting, medium_n2, ior)
    medium_n2 = torch.where(refr_case & ~exiting, ior, medium_n2)
    n1s = n1_ * n1_
    n2s = n2_ * n2_
    # select-based floor: non-refractive materials may carry ior == 0, and
    # a max() floor's backward would meet 0 * inf on their lanes
    n2s_safe = torch.where(n2s > 1e-20, n2s, 1.0)
    ratio = torch.clamp(n1s / n2s_safe, 0.0, 1e6)
    ndotv = nex * rdx + ney * rdy + nez * rdz
    radical = 1.0 - (ratio * ratio) * (1.0 - ndotv * ndotv)
    ct_scale = rdx * nex + rdy * ney + rdz * nez
    sqr = torch.sqrt(torch.clamp(radical, min=1e-20))
    refx = (rdx - nex * ct_scale) * ratio - nex * sqr
    refy = (rdy - ney * ct_scale) * ratio - ney * sqr
    refz = (rdz - nez * ct_scale) * ratio - nez * sqr
    # total internal reflection: mirror about the effective normal
    vdne = rdx * nex + rdy * ney + rdz * nez
    tir = radical <= 0.0
    refx = torch.where(tir, rdx - 2.0 * vdne * nex, refx)
    refy = torch.where(tir, rdy - 2.0 * vdne * ney, refy)
    refz = torch.where(tir, rdz - 2.0 * vdne * nez, refz)
    do_refract = refr_case & (roulette > alpha)

    # ---- opaque / cutout -------------------------------------------------
    cutout = live & (alpha < alpha_lo)
    opaque = live & (alpha > alpha_hi)
    is_alpha_f = torch.where(opaque, f0, is_alpha_f)
    is_alpha_f = torch.where(cutout, f1, is_alpha_f)
    alpha_depth = torch.where(cutout, alpha_depth + 1, alpha_depth)

    accum = live & ~do_refract & ~cutout
    rox = torch.where(live, px, rox)
    roy = torch.where(live, py, roy)
    roz = torch.where(live, pz, roz)
    rdx = torch.where(do_refract, refx, torch.where(accum, drx, rdx))
    rdy = torch.where(do_refract, refy, torch.where(accum, dry, rdy))
    rdz = torch.where(do_refract, refz, torch.where(accum, drz, rdz))

    # ---- accumulate (the bright test reads the throughput before update) -
    e_scale = estr if e_scale_mult == 1.0 else estr * e_scale_mult
    ix = torch.where(accum, ix + emx * e_scale * rcx, ix)
    iy = torch.where(accum, iy + emy * e_scale * rcy, iy)
    iz = torch.where(accum, iz + emz * e_scale * rcz, iz)
    th, bb = bright_threshold, bright_boost
    bright = (rcx > th) | (rcy > th) | (rcz > th)
    nbx = torch.where(bright, dfx * (dfx * (rcx * bb)), dfx * rcx)
    nby = torch.where(bright, dfy * (dfy * (rcy * bb)), dfy * rcy)
    nbz = torch.where(bright, dfz * (dfz * (rcz * bb)), dfz * rcz)
    if ao_factor is not None:
        nbx, nby, nbz = nbx * ao_factor, nby * ao_factor, nbz * ao_factor
    rcx = torch.where(accum, nbx, rcx)
    rcy = torch.where(accum, nby, rcy)
    rcz = torch.where(accum, nbz, rcz)

    active_f = torch.where(active & did_hit, f1, f0)
    out = (rox, roy, roz, rdx, rdy, rdz, rcx, rcy, rcz, ix, iy, iz,
           ax_, ay_, az_, nx_, ny_, nz_,
           active_f, is_alpha_f, alpha_depth, medium_n2)
    return (out, emissive_ret, accum) if with_masks else out


def initial_sky(rox, planes: int = 8) -> tuple:
    """The sky slot at bounce 0, all zero: the forward's 8 planes (scale
    xyz, unit direction xyz, early flag, taken flag) or the replay's 4
    (scale xyz, taken flag)."""
    return (torch.zeros_like(rox),) * planes


def sky_direction(px, py, pz, cx, cy, cz, r) -> tuple:
    """Unit hit direction (p - c) / r on the sky sphere; a zero radius
    (a miss's all-zero winner) divides by 1, and is never taken."""
    r_safe = torch.where(r > 0.0, r, 1.0)
    return (px - cx) / r_safe, (py - cy) / r_safe, (pz - cz) / r_safe


def take_sky_slot(sky: tuple, sky_win, emissive_ret, accum, estr, rc,
                  e_scale_mult=1.0, sdir=None) -> tuple:
    """The slot after one bounce (``raytpu``'s take_e / take_a): a ray's
    first sky event is an emissive early return (scale 1, the HSL boost
    applied outside) or an accumulation (scale e_scale times the
    throughput before the bounce, ``rc``, what the zeroed emission would
    have been multiplied by). Later sky events add nothing under the
    black-diffuse sky. ``sky`` holds 8 planes with the direction ``sdir``
    (the forward), 4 without (the replay, whose direction and flag are
    constants: they reach the output only through floor() and compares).
    """
    free = sky_win & (sky[-1] == 0.0)
    take_e = emissive_ret & free
    take_a = accum & free
    take = take_e | take_a
    f1 = torch.ones_like(sky[-1])
    e_scale = estr if e_scale_mult == 1.0 else estr * e_scale_mult
    skl = tuple(torch.where(take_e, f1, torch.where(take_a, e_scale * c, s))
                for s, c in zip(sky[0:3], rc))
    slot = torch.where(take, f1, sky[-1])
    if sdir is None:
        return (*skl, slot)
    return (*skl, *(torch.where(take, d, s) for d, s in zip(sdir, sky[3:6])),
            torch.where(take_e, f1, sky[6]), slot)


class MeshTables(NamedTuple):
    """The tables K3 and its plain version read (``pack_scene``); the last
    ten only for the merged search (``pack_aa``, ``pack_quads``,
    ``walk_tables``: the kernel reads the walk tables and their chunk
    boxes in place of aa and aa3)."""

    sph: Tensor     # (14, S): cx cy cz r | diffuse3 emission3 estr refl alpha ior
    tri: Tensor     # (25, T): a3 ab3 ac3 n3 b3 c3 ua va ub vb uc vc mat
    search: Tensor  # (T, 12): rows 0-11 of tri per triangle (the kernel's
                    # shared-memory layout)
    boxes: Tensor   # (6, ceil(T / 32)): per-chunk box lo3 hi3
    mats: Tensor    # (9, M): emission3 estr refl ior alpha_c use_c eft
    atlas: Tensor   # (4, n_tex): r g b alpha texel planes
    aa: Optional[Tensor] = None     # (8, N) axis-aligned rects
    aa3: Optional[Tensor] = None    # (9, L3) axis-aligned unpaired triangles
    quad: Optional[Tensor] = None   # (14, Q) general parallelograms
    qbox: Optional[Tensor] = None   # (6, ceil(Q / 32)) their chunk boxes
    left: Optional[Tensor] = None   # (13, L) general leftover triangles
    lbox: Optional[Tensor] = None   # (6, ceil(L / 32)) their chunk boxes
    aa_walk: Optional[Tensor] = None    # (9, N) aa's columns in walk order,
                                        # row 8 the original column
    aa3_walk: Optional[Tensor] = None   # (10, L3) aa3's likewise, row 9
    aa_box: Optional[Tensor] = None     # (6, chunks) the walk's chunk boxes
    aa3_box: Optional[Tensor] = None    # (6, chunks) likewise

    def nbytes(self) -> int:
        """Bytes of every table present."""
        return sum(4 * t.numel() for t in self if t is not None)


def pack_tri(scene: Scene) -> Tensor:
    """(25, T) f32 triangle table (``raytpu``'s ``pack_tri25`` without the
    padding): the search channels a, b - a, c - a and the raw normal, then
    the raw b and c that the barycentrics read, the UVs and the material
    id."""
    t = scene.triangles
    g = precompute(t)
    return torch.stack([
        *g.a, *g.edge_ab, *g.edge_ac, *g.normal_raw, *t.b, *t.c,
        t.ua, t.va, t.ub, t.vb, t.uc, t.vc, t.mat_id.to(torch.float32),
    ]).to(torch.float32).contiguous()


def chunk_boxes(xs, ys, zs, n: int, chunk: int = CULL_CHUNK) -> Tensor:
    """(6, ceil(n / chunk)) boxes lo3 hi3 over each run of ``chunk``
    primitives. ``xs``/``ys``/``zs`` list each corner's (n,) coordinate.
    Every box grows by 1e-5 (|x| + 1) per side, which keeps the cull
    conservative for the f32-recomputed corners."""
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    lo, hi = [], []
    for parts in (xs, ys, zs):
        stack = torch.stack(parts)                      # (corners, n)
        chunks = lambda v: torch.nn.functional.pad(stack, (0, pad), value=v) \
            .reshape(len(parts), n_chunks, chunk)
        lo.append(chunks(math.inf).amin(dim=(0, 2)))
        hi.append(chunks(-math.inf).amax(dim=(0, 2)))
    boxes = torch.stack(lo + hi)
    eps = 1e-5 * (boxes.abs() + 1.0)
    return (boxes + torch.cat([-eps[:3], eps[3:]])).contiguous()


def entered_boxes(boxes: Tensor, o, d) -> tuple[Tensor, Tensor]:
    """(B, C) whether each ray's line meets each box (lo3 hi3 rows) ahead
    of its origin, and its entry t. An axis whose slab product is NaN
    (the origin on a box plane and the direction's component zero) is
    unconstrained: the line lies in that slab. The conservative test of
    the culls that must skip no valid hit (K4's and the merged walk's)."""
    t_near, t_far = [], []
    for r, (oc, dc) in enumerate(zip(o, d)):
        inv = (1.0 / dc)[:, None]
        t0 = (boxes[r][None, :] - oc[:, None]) * inv
        t1 = (boxes[r + 3][None, :] - oc[:, None]) * inv
        nan = t0.isnan() | t1.isnan()
        t_near.append(torch.where(nan, -torch.inf, torch.minimum(t0, t1)))
        t_far.append(torch.where(nan, torch.inf, torch.maximum(t0, t1)))
    tmin = torch.maximum(torch.maximum(t_near[0], t_near[1]), t_near[2])
    tmax = torch.minimum(torch.minimum(t_far[0], t_far[1]), t_far[2])
    return (tmax >= tmin) & (tmax >= 0.0), tmin


def pack_mats(scene: Scene) -> Tensor:
    """(9, M) f32 material table: emission3 estr refl ior alpha_c
    use_alpha_const emission_from_texture."""
    m = scene.mat_table
    return torch.stack([
        *m.emission, m.emission_strength, m.reflection, m.ior, m.alpha_const,
        m.use_alpha_const.to(torch.float32),
        m.emission_from_texture.to(torch.float32),
    ]).to(torch.float32).contiguous()


def pack_atlas(scene: Scene) -> Tensor:
    """(4, n_tex) f32 atlas: r g b alpha texel planes."""
    a = scene.atlas
    return torch.stack([*a.rgb, a.alpha]).to(torch.float32).contiguous()


# rows of pack_tri's table that hold vertex a, the raw b and the raw c
VERTEX_ROWS = (0, 12, 15)


@functools.lru_cache(maxsize=64)
def _plan_index(plan: QuadPlan, device: str) -> dict:
    """The index tensors the merged packers gather with, on ``device``
    (made once per plan and device: a copy to the card per call would
    wait for it)."""
    v = lambda *rows: torch.tensor(np.asarray(rows, np.int64).reshape(
        len(rows), -1), device=device)
    out = {}
    if plan.rects:
        i, j, oi, k, s, m = (np.asarray(c) for c in zip(*plan.rects))
        i1 = np.where(k == 0, 1, 0)
        i2 = np.where(k == 2, 1, 2)
        m_ax, o_ax = np.where(m == 0, i1, i2), np.where(m == 0, i2, i1)
        base = np.asarray(VERTEX_ROWS)
        a_row, s1_row, s2_row = base[oi], base[(oi + 1) % 3], base[(oi + 2) % 3]
        out["rect"] = v(a_row + k, a_row + m_ax, a_row + o_ax, s1_row + m_ax,
                        s2_row + o_ax, i, j)
        out["rect_s"] = torch.tensor(s.astype(np.float32), device=device)
    if plan.aa_tris:
        t, k, s = (np.asarray(c) for c in zip(*plan.aa_tris))
        i1 = np.where(k == 0, 1, 0)
        i2 = np.where(k == 2, 1, 2)
        out["aa3"] = v(k, i1, i2, t)
        out["aa3_s"] = torch.tensor(s.astype(np.float32), device=device)
    if plan.quads:
        i, j, oi = (np.asarray(c) for c in zip(*plan.quads))
        base = np.asarray(VERTEX_ROWS)
        out["quad"] = v(base[oi], base[(oi + 1) % 3], base[(oi + 2) % 3], i, j)
    if plan.leftovers:
        out["left"] = v(plan.leftovers)
    # the walk's sub-lists: each aa column's (group, m) and each aa3
    # column's group, in table order
    for key, sizes in _sub_list_sizes(plan).items():
        out[f"{key}_sub"] = torch.tensor(
            np.repeat(np.arange(len(sizes)), sizes), device=device)
    return out


def _sub_list_sizes(plan: QuadPlan) -> dict:
    """The walk's sub-list lengths in table order: aa's (rects with m = 0,
    m = 1 of each group), aa3's (each group's triangles)."""
    return {"aa": [c for g in plan.aa_layout for c in g[2:4]],
            "aa3": [g[4] for g in plan.aa_layout]}


@functools.lru_cache(maxsize=64)
def _walk_pad(sizes: tuple, chunk: int, device: str) -> Tensor:
    """Each sub-list's runs of ``chunk`` columns as a (chunks, chunk)
    column index, -1 past the sub-list's end."""
    pad, lo = [np.zeros(0, np.int64)], 0
    for n in sizes:
        cols = np.full(-(-n // chunk) * chunk, -1)
        cols[:n] = np.arange(lo, lo + n)
        pad.append(cols)
        lo += n
    return torch.tensor(np.concatenate(pad).reshape(-1, chunk), device=device)


def pack_aa(tri: Tensor, plan: QuadPlan, det_eps: float
            ) -> tuple[Tensor, Tensor]:
    """The axis-aligned loops' tables (``raytpu``'s ``pack_aa``, its values
    without the padding), normalised by the normal's length u = |n_k| so
    that a ray's group scalar detg = -s d_k is each candidate's
    denominator:

      aa  (8, N)  per rect: s a_k | det_eps / u | a_m | 1 / e1_m | a_o
                  | 1 / e2_o | i | j   (m: e1's in-plane axis, o: e2's)
      aa3 (9, L3) per unpaired triangle: s a_k | det_eps / |D| | a_i1
                  | a_i2 | ac_i2 / D | -ac_i1 / D | -ab_i2 / D | ab_i1 / D
                  | t   (D: the in-plane 2x2 determinant)

    from ``pack_tri``'s table: a rect's corner and edges from its raw
    vertices, a triangle's from a, b - a and c - a."""
    ix = _plan_index(plan, str(tri.device))
    aa = tri.new_zeros((8, 0))
    if plan.rects:
        r = ix["rect"]
        a_k, a_m, a_o = (tri[r[q], r[5]] for q in range(3))
        e1m = tri[r[3], r[5]] - a_m
        e2o = tri[r[4], r[5]] - a_o
        u = torch.abs(e1m * e2o)
        aa = torch.stack([ix["rect_s"] * a_k, torch.full_like(u, det_eps) / u,
                          a_m, 1.0 / e1m, a_o, 1.0 / e2o,
                          r[5].to(torch.float32), r[6].to(torch.float32)])
    aa3 = tri.new_zeros((9, 0))
    if plan.aa_tris:
        k, i1, i2, t = ix["aa3"]
        a = lambda base, axis: tri[base + axis, t]
        ab1, ab2, ac1, ac2 = a(3, i1), a(3, i2), a(6, i1), a(6, i2)
        D = ab1 * ac2 - ab2 * ac1
        aa3 = torch.stack([
            ix["aa3_s"] * a(0, k), torch.full_like(D, det_eps) / torch.abs(D),
            a(0, i1), a(0, i2), ac2 / D, -ac1 / D, -ab2 / D, ab1 / D,
            t.to(torch.float32)])
    return aa.contiguous(), aa3.contiguous()


def walk_tables(tri: Tensor, aa: Tensor, aa3: Tensor, plan: QuadPlan,
                chunk: int = WALK_CHUNK
                ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The kernel's walk order of ``pack_aa``'s tables, and its chunk
    boxes: (aa_walk (9, N), aa3_walk (10, L3), aa_box, aa3_box).

    Each sub-list of a group (rects with m = 0, rects with m = 1,
    triangles) is sorted by its plane offset s a_k (row 0) descending,
    stably, so along it a ray's numerator s o_k - s a_k rises, and within
    a plane the columns keep their order (the load's Morton order, so a
    chunk of them is compact); one more row holds each column's original
    column, the tie-break of the kernel's strict t < best. The boxes (6,
    chunks): lo3 hi3 of each sub-list's runs of ``chunk`` columns, over
    their triangles' corners a, a + ab and a + ac from ``pack_tri``'s
    table (a rect's two triangles), inflated by 1e-5 (|x| + 1) as
    ``chunk_boxes``: a chunk whose box a ray's line does not meet ahead
    of its origin holds no valid candidate for it."""
    ix = _plan_index(plan, str(aa.device))

    def walk(tab, sub):
        by_offset = torch.sort(tab[0], descending=True, stable=True).indices
        perm = by_offset[torch.sort(sub[by_offset], stable=True).indices]
        return torch.cat([tab[:, perm], perm.to(tab.dtype)[None]]).contiguous()

    def boxes(walked, rows, pad):
        t = walked[list(rows)].long()                           # (R, n)
        a = tri[0:3][:, t]
        pts = torch.cat([a, a + tri[3:6][:, t], a + tri[6:9][:, t]], dim=1)
        g = pts[:, :, pad.clamp(min=0)]               # (3, 3R, chunks, chunk)
        used = pad >= 0
        box = torch.cat([torch.where(used, g, math.inf).amin(dim=(1, 3)),
                         torch.where(used, g, -math.inf).amax(dim=(1, 3))])
        eps = 1e-5 * (box.abs() + 1.0)
        return (box + torch.cat([-eps[:3], eps[3:]])).contiguous()

    pad = {key: _walk_pad(tuple(n), chunk, str(aa.device))
           for key, n in _sub_list_sizes(plan).items()}
    aa_w, aa3_w = walk(aa, ix["aa_sub"]), walk(aa3, ix["aa3_sub"])
    return (aa_w, aa3_w, boxes(aa_w, (6, 7), pad["aa"]),
            boxes(aa3_w, (8,), pad["aa3"]))


def pack_quads(tri: Tensor, plan: QuadPlan
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The general loops' tables (``raytpu``'s ``pack_quads``, its values
    without the padding):

      quad (14, Q)  a3 e1_3 e2_3 n3 i j: the corner is triangle i's vertex
                    opposite the shared edge, e1 / e2 the diagonal's ends
                    minus it (cyclic order, so n = cross(e1, e2) is
                    triangle i's raw normal and the back-face cull matches)
      qbox (6, ceil(Q / 32)) chunk boxes over the four corners
      left (13, L)  a3 ab3 ac3 n3 t per general unpaired triangle
      lbox (6, ceil(L / 32)) chunk boxes over a, a + ab, a + ac"""
    ix = _plan_index(plan, str(tri.device))
    quad, qbox = tri.new_zeros((14, 0)), tri.new_zeros((6, 0))
    if plan.quads:
        ar, s1r, s2r, i, j = ix["quad"]
        axes = []
        for ax in range(3):
            a_, s1, s2 = tri[ar + ax, i], tri[s1r + ax, i], tri[s2r + ax, i]
            axes.append((a_, s1 - a_, s2 - a_, s1 + s2 - a_, s1, s2))
        ((ax_, e1x, e2x, d4x, s1x, s2x), (ay_, e1y, e2y, d4y, s1y, s2y),
         (az_, e1z, e2z, d4z, s1z, s2z)) = axes
        quad = torch.stack([
            ax_, ay_, az_, e1x, e1y, e1z, e2x, e2y, e2z,
            e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
            e1x * e2y - e1y * e2x, i.to(torch.float32), j.to(torch.float32)])
        qbox = chunk_boxes([ax_, s1x, s2x, d4x], [ay_, s1y, s2y, d4y],
                           [az_, s1z, s2z, d4z], len(plan.quads))
    left, lbox = tri.new_zeros((13, 0)), tri.new_zeros((6, 0))
    if plan.leftovers:
        t = ix["left"][0]
        g = tri[:12, t]
        left = torch.cat([g, t.to(torch.float32)[None]])
        lbox = chunk_boxes(*([g[r], g[r] + g[r + 3], g[r] + g[r + 6]]
                             for r in range(3)), len(plan.leftovers))
    return quad.contiguous(), qbox, left.contiguous(), lbox


def selection_tables(tri: Tensor, k: Optional["MeshKnobs"] = None) -> dict:
    """The tables K3 selects with, all derived from ``tri``: the search
    channels and the cull boxes (over the recomputed corners a, a + ab and
    a + ac, as ``raytpu``'s ``pack_scene``) and, with a merged plan on
    ``k``, the merged search's tables and its walk's. They carry no
    gradient (the winners are indices), so ``render`` builds them once
    for all the samples of a call (``frame_selection``)."""
    corners = [(tri[r], tri[r] + tri[r + 3], tri[r] + tri[r + 6])
               for r in range(3)]
    sel = dict(search=tri[:12].T.contiguous(),
               boxes=chunk_boxes(*map(list, corners), tri.shape[1]))
    if k is not None and k.plan is not None:
        aa = pack_aa(tri, k.plan, k.det_eps)
        sel.update(zip(("aa", "aa3", "quad", "qbox", "left", "lbox",
                        "aa_walk", "aa3_walk", "aa_box", "aa3_box"),
                       (*aa, *pack_quads(tri, k.plan),
                        *walk_tables(tri, *aa, k.plan))))
    return sel


def mesh_tables(sph: Tensor, tri: Tensor, mats: Tensor, atlas: Tensor,
                k: Optional["MeshKnobs"] = None,
                selection: Optional[dict] = None) -> MeshTables:
    """K3's tables from the four packed ones and ``selection_tables`` of
    ``tri`` (built here unless given)."""
    if selection is None:
        selection = selection_tables(tri, k)
    return MeshTables(sph=sph, tri=tri, mats=mats, atlas=atlas, **selection)


def pack_scene(scene: Scene, k: Optional["MeshKnobs"] = None) -> MeshTables:
    """K3's tables for ``scene``, with the merged search's when ``k``
    carries a plan."""
    from raytpu_torch.kernels.trace_spheres import pack_spheres

    return mesh_tables(pack_spheres(scene), pack_tri(scene), pack_mats(scene),
                       pack_atlas(scene), k)


def _closest_sphere(geo, n_s, rox, roy, roz, rdx, rdy, rdz, eps):
    """(best t, winner index or -1) over the spheres: strict t < best.
    ``raytpu``'s K3 takes sqrt(max(disc, 0)) where its K1 clamps at 1e-30,
    so this is not ``trace_spheres._closest_sphere``."""
    a_quad = rdx * rdx + rdy * rdy + rdz * rdz
    inv_2a = 0.5 / torch.clamp(a_quad, min=1e-20)
    best = torch.full_like(rox, BIG)
    bidx = torch.full_like(rox, -1, dtype=torch.int32)
    for s in range(n_s):
        cx, cy, cz, r = geo[0][s], geo[1][s], geo[2][s], geo[3][s]
        ocx, ocy, ocz = rox - cx, roy - cy, roz - cz
        b_ = 2.0 * (ocx * rdx + ocy * rdy + ocz * rdz)
        c_ = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_ * b_ - 4.0 * a_quad * c_
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = (-b_ - sq) * inv_2a
        t2 = (-b_ + sq) * inv_2a
        hit = disc > 0.0
        t = torch.where(hit & (t1 >= eps), t1,
                        torch.where(hit & (t2 >= eps), t2, BIG))
        better = t < best
        best = torch.where(better, t, best)
        bidx = torch.where(better, s, bidx)
    return best, bidx


def _slab(boxes: Tensor, c: int, ox, oy, oz, inv_x, inv_y, inv_z):
    """(the ray's line meets box c ahead of the origin, entry t)."""
    t0x, t1x = (boxes[0, c] - ox) * inv_x, (boxes[3, c] - ox) * inv_x
    t0y, t1y = (boxes[1, c] - oy) * inv_y, (boxes[4, c] - oy) * inv_y
    t0z, t1z = (boxes[2, c] - oz) * inv_z, (boxes[5, c] - oz) * inv_z
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    return (tmax >= tmin) & (tmax >= 0.0), tmin


def _triangle_hits(tri: Tensor, lo: int, hi: int, o, d, k: MeshKnobs):
    """Moller-Trumbore of every ray against triangles lo..hi-1: (B, L)
    distances (BIG where there is no valid hit) and validity."""
    (ax, ay, az, abx, aby, abz, acx, acy, acz, nx, ny, nz) = (
        tri[r, lo:hi][None, :] for r in range(12))
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in (*o, *d))
    aox, aoy, aoz = ox - ax, oy - ay, oz - az
    daox = aoy * dz - aoz * dy
    daoy = aoz * dx - aox * dz
    daoz = aox * dy - aoy * dx
    det = -(dx * nx + dy * ny + dz * nz)
    inv_det = 1.0 / torch.where(det >= k.det_eps, det, 1.0)
    dst = (aox * nx + aoy * ny + aoz * nz) * inv_det
    u = (acx * daox + acy * daoy + acz * daoz) * inv_det
    v = -(abx * daox + aby * daoy + abz * daoz) * inv_det
    w = 1.0 - u - v
    valid = ((det >= k.det_eps) & (dst >= k.tri_eps) & (u >= k.tri_eps)
             & (v >= k.tri_eps) & (w >= k.tri_eps))
    return torch.where(valid, dst, BIG), valid


def _chunks(k: MeshKnobs):
    for c in range(k.n_chunks):
        yield c, c * CULL_CHUNK, min(k.n_tris, (c + 1) * CULL_CHUNK)


def warp_entries(enter: Tensor) -> Tensor:
    """(W,) how many of each warp's 32 consecutive rays (the last warp
    padded) ``enter`` holds: the ballot the kernel's warp takes."""
    pad = -enter.shape[0] % WARP
    return torch.nn.functional.pad(enter, (0, pad)).reshape(-1, WARP).sum(1)


def _closest_triangle(tb: MeshTables, k: MeshKnobs, o, d, active, best,
                      bidx, counts):
    """Continue the search over the triangle chunks that a live ray's
    line enters before its current best (the kernel's per-ray cull, so
    a skipped chunk never holds the winner); winners are n_spheres + t.

    ``counts`` (a dict) gets ``tri``, the triangle tests the rays need,
    and for the kernel's warps of 32 consecutive rays, in lane slots (a
    warp's test of one triangle is 32 slots, its idle lanes' included):
    ``tri_issued``, those of a warp that scans the union of its lanes'
    chunks (the per-thread cull of the kernel before its warp search);
    ``tri_loop``, those of the chunks that COOP_MIN or more of a warp's
    lanes enter, which the kernel's lanes scan each on its own; ``coop``,
    the (ray, chunk) entries of the others, each a warp-wide test of the
    chunk's triangles and a (t, index) argmin."""
    inv = [1.0 / c for c in d]
    for c, lo, hi in _chunks(k):
        hit_box, tmin = _slab(tb.boxes, c, *o, *inv)
        enter = hit_box & active & (tmin < best)
        if counts is not None:
            counts["tri"] += int(enter.sum()) * (hi - lo)
            pc = warp_entries(enter)
            many = pc >= COOP_MIN
            slots = WARP * (hi - lo)
            for key, v in (("tri_issued", int((pc > 0).sum()) * slots),
                           ("tri_loop", int(many.sum()) * slots),
                           ("coop", int(pc[~many].sum()))):
                counts[key] = counts.get(key, 0) + v
        if not bool(enter.any()):
            continue
        t, _ = _triangle_hits(tb.tri, lo, hi, o, d, k)
        t_c, j = torch.min(t, dim=1)        # the first of equal minima
        better = enter & (t_c < best)
        best = torch.where(better, t_c, best)
        bidx = torch.where(better, (k.n_spheres + lo + j).to(torch.int32), bidx)
    return best, bidx


def _aa_group_min(tb: MeshTables, r0: int, nr: int, t0: int, nt: int):
    """The least det_eps / u of a group's candidates: a ray whose group
    scalar detg is below it (or NaN) has no valid candidate there, which
    lets the kernel skip the group exactly."""
    du = torch.cat([tb.aa[1, r0:r0 + nr], tb.aa3[1, t0:t0 + nt]])
    return du.min()


def _groups(plan: QuadPlan):
    """(kx, sign, rects m = 0, rects m = 1, triangles, first rect column,
    first triangle column) of each non-empty axis-aligned group."""
    r_off = t_off = 0
    for kx, sgn, ca, cb, ct in plan.aa_layout:
        if ca + cb + ct:
            yield kx, sgn, ca, cb, ct, r_off, t_off
        r_off, t_off = r_off + ca + cb, t_off + ct


def _group_rays(k: MeshKnobs, o, d, kx: int, sgn: int) -> dict:
    """A group's per-ray scalars, each (B, 1): the shared denominator
    detg = -s d_k, the numerator's s o_k, tri_eps and 1 - tri_eps times
    detg, the in-plane origin times detg and the in-plane direction."""
    i1, i2 = [a for a in range(3) if a != kx]
    detg = -d[kx] if sgn > 0 else d[kx]
    col = lambda t: t[:, None]
    return dict(dg=col(detg), so=col(o[kx] if sgn > 0 else -o[kx]),
                epsd=col(k.tri_eps * detg), hid=col((1.0 - k.tri_eps) * detg),
                X1=col(o[i1] * detg), X2=col(o[i2] * detg), d1=col(d[i1]),
                d2=col(d[i2]))


def _rect_test(g: dict, m: int):
    """Validity and winning triangle of rays (rows) against aa rect
    columns A whose numerators are numr: alpha * detg and beta * detg
    from the corner and the edges' reciprocals (e1 on axis i1 for m = 0,
    on i2 for m = 1)."""
    Xm, dm, Xo, do_ = ((g["X1"], g["d1"], g["X2"], g["d2"]) if m == 0 else
                       (g["X2"], g["d2"], g["X1"], g["d1"]))

    def test(A, numr):
        dg, epsd, hid = g["dg"], g["epsd"], g["hid"]
        pug = (Xm - A[2] * dg + numr * dm) * A[3]
        pvg = (Xo - A[4] * dg + numr * do_) * A[5]
        valid = ((dg >= A[1]) & (numr >= epsd) & (pug >= epsd)
                 & (pvg >= epsd) & (pug <= hid) & (pvg <= hid))
        return valid, torch.where(pug + pvg <= dg, A[6], A[7]).to(torch.int32)
    return test


def _tri_test(g: dict):
    """``_rect_test`` for aa3's unpaired triangles."""
    def test(A, numr):
        dg, epsd = g["dg"], g["epsd"]
        P1 = g["X1"] - A[2] * dg + numr * g["d1"]
        P2 = g["X2"] - A[3] * dg + numr * g["d2"]
        ug = P1 * A[4] + P2 * A[5]
        vg = P1 * A[6] + P2 * A[7]
        valid = ((dg >= A[1]) & (numr >= epsd) & (ug >= epsd)
                 & (vg >= epsd) & (ug + vg <= g["hid"]))
        return valid, A[8].to(torch.int32).expand_as(numr)
    return test


def _fold_group(best, bden, bidx, bg, gi, detg, ns):
    """Join a group's winner (numerator bg over detg) to the running
    fraction best / bden; the bg < BIG gate keeps a group's miss out of
    the compare: with deng > 1 (|d_k| > 1) BIG * bden < best * deng would
    otherwise fabricate a hit."""
    deng = torch.where(detg > 0.0, detg, 1.0)
    better = (bg < BIG) & (bg * bden < best * deng)
    return (torch.where(better, bg, best), torch.where(better, deng, bden),
            torch.where(better, ns + gi, bidx))


def _aa_groups(tb: MeshTables, k: MeshKnobs, o, d, best, bidx):
    """The axis-aligned groups after the spheres: (best, bden, bidx). In a
    group the candidates share the denominator, so a chunk's first least
    numerator is the sequential fold's winner."""
    bden = torch.ones_like(best)
    for kx, sgn, ca, cb, ct, r0, t0 in _groups(k.plan):
        g = _group_rays(k, o, d, kx, sgn)
        bg = torch.full_like(best, BIG)
        gi = torch.full_like(bidx, -1)
        for tab, lo, hi, test in ((tb.aa, r0, r0 + ca, _rect_test(g, 0)),
                                  (tb.aa, r0 + ca, r0 + ca + cb,
                                   _rect_test(g, 1)),
                                  (tb.aa3, t0, t0 + ct, _tri_test(g))):
            for c0 in range(lo, hi, CULL_CHUNK):
                A = tab[:, c0:min(hi, c0 + CULL_CHUNK)]
                numr = g["so"] - A[0]
                valid, win = test(A, numr)
                m, j = torch.min(torch.where(valid, numr, BIG), dim=1)
                better = m < bg          # the first of equal minima
                bg = torch.where(better, m, bg)
                gi = torch.where(better, win.gather(1, j[:, None])[:, 0], gi)
        best, bden, bidx = _fold_group(best, bden, bidx, bg, gi, g["dg"][:, 0],
                                       k.n_spheres)
    return best, bden, bidx


WALK_BLOCK = 1 << 22   # (rays x columns) entries of the walk emulation at once


def _walk(A: Tensor, g: dict, test, enter: Tensor, chunk: int, bar: Tensor,
          bden: Tensor, bg: Tensor, gi: Tensor):
    """The kernel's walk of one sub-list, for every ray: A, the sub-list's
    columns in walk order (last row the original column), has numerators
    numr = s o_k - s a_k that rise along it; ``enter`` (B, chunks) says
    which of its ``chunk``-column chunk boxes each ray's line meets. The
    sub-list's winner is its least valid numerator, ties to the least
    original column, over the chunks the ray needs: those not past its
    end (a chunk whose first numerator is past the winner's so far, or
    not below bg, the earlier sub-lists' winner, or failing the gate
    numr * bden < bar = best * deng, ends the walk), whose last numerator
    reaches epsd and whose box the line meets. It joins bg on a strictly
    smaller numerator. Returns (bg, gi, columns tested, chunk boxes
    tested, chunks visited) per ray."""
    n = A.shape[1]
    numr = g["so"] - A[0]
    valid, win = test(A, numr)
    epsd = g["epsd"][:, 0]
    sbg = torch.full_like(bg, BIG)
    spos = torch.full_like(bg, math.inf)
    sgi = torch.full_like(gi, -1)
    done = torch.zeros_like(gi, dtype=torch.bool)
    tests = torch.zeros_like(gi, dtype=torch.int64)
    slabs = torch.zeros_like(tests)
    visits = torch.zeros_like(tests)
    for ch, cs in enumerate(range(0, n, chunk)):
        ce = min(n, cs + chunk)
        head = numr[:, cs]
        visits += ~done
        done = (done | ((sgi >= 0) & (head > sbg))
                | ~((head < bg) & (head * bden < bar)))
        live = ~done & (numr[:, ce - 1] >= epsd)
        need = live & enter[:, ch]
        slabs += live
        tests += need * (ce - cs)
        for c in range(cs, ce):
            nc, oc = numr[:, c], A[-1, c]
            better = need & valid[:, c] & ((nc < sbg) | ((nc == sbg)
                                                         & (oc < spos)))
            sbg = torch.where(better, nc, sbg)
            spos = torch.where(better, oc, spos)
            sgi = torch.where(better, win[:, c], sgi)
    take = (sgi >= 0) & (sbg < bg)
    return (torch.where(take, sbg, bg), torch.where(take, sgi, gi), tests,
            slabs, visits)


def _aa_walk(tb: MeshTables, k: MeshKnobs, o, d, active, best, bidx,
             cand: dict, chunk: int = WALK_CHUNK):
    """The kernel's axis-aligned search, emulated: ``_aa_groups``'s result
    (best, bden, bidx) by the walk over ``walk_tables``' sub-lists and
    their ``chunk``-column boxes (exact: equal to ``_aa_groups``'s bits)
    and, into ``cand``, the walk's work on the active rays whose group is
    not skipped: ``aa_rect`` / ``aa_tri`` columns tested, ``aa_head``
    chunks visited and ``aa_slab`` chunk boxes tested."""
    bden = torch.ones_like(best)
    box_off = {"aa": 0, "aa3": 0}
    for kx, sgn, ca, cb, ct, r0, t0 in _groups(k.plan):
        g = _group_rays(k, o, d, kx, sgn)
        detg = g["dg"][:, 0]
        walked = active & (detg >= _aa_group_min(tb, r0, ca + cb, t0, ct))
        bar = best * torch.where(detg > 0.0, detg, 1.0)
        bg = torch.full_like(best, BIG)
        gi = torch.full_like(bidx, -1)
        for key, lo, hi, m in (("aa", r0, r0 + ca, 0),
                               ("aa", r0 + ca, r0 + ca + cb, 1),
                               ("aa3", t0, t0 + ct, None)):
            n_box = -(-(hi - lo) // chunk)
            tab, boxes = ((tb.aa_walk, tb.aa_box) if key == "aa" else
                          (tb.aa3_walk, tb.aa3_box))
            boxes = boxes[:, box_off[key]:box_off[key] + n_box]
            box_off[key] += n_box
            if hi == lo:
                continue
            step = max(1, WALK_BLOCK // (hi - lo))
            parts = []
            for r in range(0, best.shape[0], step):
                sl = slice(r, r + step)
                gs = {n: v[sl] for n, v in g.items()}
                test = _tri_test(gs) if m is None else _rect_test(gs, m)
                enter = entered_boxes(boxes, [c[sl] for c in o],
                                      [c[sl] for c in d])[0]
                parts.append(_walk(tab[:, lo:hi], gs, test, enter, chunk,
                                   bar[sl], bden[sl], bg[sl], gi[sl]))
            bg, gi, tests, slabs, visits = (torch.cat(p) for p in zip(*parts))
            cand["aa_rect" if m is not None else "aa_tri"] += int(
                tests[walked].sum())
            cand["aa_slab"] += int(slabs[walked].sum())
            cand["aa_head"] += int(visits[walked].sum())
        best, bden, bidx = _fold_group(best, bden, bidx, bg, gi, detg,
                                       k.n_spheres)
    return best, bden, bidx


def _closest_merged(tb: MeshTables, k: MeshKnobs, o, d, active, best, bidx,
                    counts):
    """The merged search after the spheres (``raytpu``'s ``use_merged``
    branch of ``bounce_body``): the running winner as the fraction
    best / bden (bden is 1 after the spheres, so their strict t < best is
    the fraction compare with denominator 1), the axis-aligned groups
    (``_aa_groups``), the
    general parallelograms and leftovers, then the one division.

    The general loops compare fractions, whose rounding is not
    transitive, so they fold one candidate at a time, as the kernel does.
    ``counts`` receives the kernel's work: ``aa_rect`` / ``aa_tri`` /
    ``aa_head`` / ``aa_slab`` of its walk (``_aa_walk``), ``quad`` /
    ``left`` tests and the ``slab`` tests of the culled general loops."""
    ns = k.n_spheres
    cand = {"aa_rect": 0, "aa_tri": 0, "aa_head": 0, "aa_slab": 0,
            "quad": 0, "left": 0, "slab": 0}
    if counts is not None:
        _aa_walk(tb, k, o, d, active, best, bidx, cand)
    best, bden, bidx = _aa_groups(tb, k, o, d, best, bidx)

    oc, dc = [c[:, None] for c in o], [c[:, None] for c in d]

    def quad_body(lo, hi):
        q = tb.quad[:, lo:hi]
        det, num, pu, pv = _frac_terms(q, oc, dc, q[6:9], q[3:6])
        lo_, hi_ = k.tri_eps * det, (1.0 - k.tri_eps) * det
        valid = ((det >= k.det_eps) & (num >= lo_) & (pu >= lo_)
                 & (pv >= lo_) & (pu <= hi_) & (pv <= hi_))
        win = torch.where(pu + pv <= det, q[12], q[13]).to(torch.int32)
        return valid, num, det, win

    def left_body(lo, hi):
        q = tb.left[:, lo:hi]
        det, num, pu, pv = _frac_terms(q, oc, dc, q[6:9], q[3:6])
        lo_ = k.tri_eps * det
        valid = ((det >= k.det_eps) & (num >= lo_) & (pu >= lo_)
                 & (pv >= lo_) & (pu + pv <= (1.0 - k.tri_eps) * det))
        return valid, num, det, q[12].to(torch.int32).expand_as(num)

    inv = [1.0 / c for c in d]
    for n, boxes, body, key in ((k.n_quads, tb.qbox, quad_body, "quad"),
                                (k.n_leftover, tb.lbox, left_body, "left")):
        culled = n > 2 * CULL_CHUNK
        for c, lo in enumerate(range(0, n, CULL_CHUNK)):
            hi = min(n, lo + CULL_CHUNK)
            enter = active
            if culled:
                hit_box, tmin = _slab(boxes, c, *o, *inv)
                enter = hit_box & active & (tmin * bden < best)
            if counts is not None:
                cand["slab"] += int(active.sum()) if culled else 0
                cand[key] += int(enter.sum()) * (hi - lo)
            if culled and not bool(enter.any()):
                continue
            valid, num, det, win = body(lo, hi)
            num_c = torch.where(valid, num, BIG)
            den_c = torch.where(valid, det, 1.0)
            for j in range(hi - lo):
                better = enter & (num_c[:, j] * bden < best * den_c[:, j])
                best = torch.where(better, num_c[:, j], best)
                bden = torch.where(better, den_c[:, j], bden)
                bidx = torch.where(better, ns + win[:, j], bidx)
    if counts is not None:
        for key, v in cand.items():
            counts[key] = counts.get(key, 0) + v
    # the deferred division: one per ray and bounce; a miss keeps BIG / 1
    return best / bden, bidx


def _frac_terms(q: Tensor, o, d, e_u, e_v):
    """(det, t * det, u * det, v * det) of every ray (rows) against the
    parallelograms or triangles of ``q`` (columns; rows 0-2 the corner
    a, 9-11 the raw normal): u pairs with ``e_u`` (a parallelogram's e2,
    a triangle's c - a) and v with ``e_v`` (e1, b - a), as in
    Moller-Trumbore without the division."""
    aox, aoy, aoz = o[0] - q[0], o[1] - q[1], o[2] - q[2]
    dx, dy, dz = d
    daox = aoy * dz - aoz * dy
    daoy = aoz * dx - aox * dz
    daoz = aox * dy - aoy * dx
    det = -(dx * q[9] + dy * q[10] + dz * q[11])
    num = aox * q[9] + aoy * q[10] + aoz * q[11]
    pu = e_u[0] * daox + e_u[1] * daoy + e_u[2] * daoz
    pv = -(e_v[0] * daox + e_v[1] * daoy + e_v[2] * daoz)
    return det, num, pu, pv


def _ao_factor(tb: MeshTables, geo, k: MeshKnobs, p: Vec3, n: Vec3, active,
               draws: Tensor, row0: int) -> Tensor:
    """Hemisphere probes from the hit point: any sphere hit at t >= eps
    (either root), then any valid triangle of the chunks the probe enters;
    occluded probes / (ao_samples * ao_intensity)."""
    occ = torch.zeros_like(p.x)
    for s_i in range(k.ao_samples):
        ath = TWO_PI * draws[row0 + 3 + 2 * s_i]
        acp = torch.clamp(2.0 * draws[row0 + 4 + 2 * s_i] - 1.0, -1.0, 1.0)
        asp = torch.sqrt(torch.clamp(1.0 - acp * acp, min=0.0))
        ao = Vec3(n.x + torch.cos(ath) * asp, n.y + torch.sin(ath) * asp,
                  n.z + acp).normalize()
        aq = ao.dot(ao)
        ai2a = 0.5 / torch.clamp(aq, min=1e-20)
        hit = torch.zeros_like(active)
        for s in range(k.n_spheres):
            ocx, ocy, ocz = p.x - geo[0][s], p.y - geo[1][s], p.z - geo[2][s]
            b2 = 2.0 * (ocx * ao.x + ocy * ao.y + ocz * ao.z)
            c2 = ocx * ocx + ocy * ocy + ocz * ocz - geo[3][s] * geo[3][s]
            d2 = b2 * b2 - 4.0 * aq * c2
            sq2 = torch.sqrt(torch.clamp(d2, min=0.0))
            tt1, tt2 = (-b2 - sq2) * ai2a, (-b2 + sq2) * ai2a
            hit = hit | ((d2 > 0.0) & ((tt1 >= k.sphere_eps)
                                       | (tt2 >= k.sphere_eps)))
        inv = [1.0 / c for c in ao]
        for c, lo, hi in _chunks(k):
            enter = _slab(tb.boxes, c, *p, *inv)[0] & active & ~hit
            if bool(enter.any()):
                valid = _triangle_hits(tb.tri, lo, hi, p, ao, k)[1]
                hit = hit | (enter & valid.any(dim=1))
        occ = occ + torch.where(hit, 1.0, 0.0)
    return occ * k.ao_inv


def trace_scene_reference(tb: MeshTables, ox: Tensor, oy: Tensor, oz: Tensor,
                          dx: Tensor, dy: Tensor, dz: Tensor, draws: Tensor,
                          k: MeshKnobs, counts: Optional[dict] = None,
                          record: bool = False):
    """Plain PyTorch version of the kernel (``raytpu``'s ``bounce_body``),
    triangles (or merged candidates, with ``k.plan``; ``tb`` then carries
    the merged tables) a chunk of 32 at a time so memory stays
    O(rays x chunk).

    rays (B,) each; draws (bounces * n_draws, B). Returns (9, B):
    radiance xyz, albedo xyz, normal xyz; with the sky slot on
    (``k.sky_idx >= 0``) (16, B): those, then the slot's scale xyz, unit
    direction xyz and early flag. ``counts``, a dict, receives the search
    work this input needs: ``live`` (ray, bounce) entries, ``sphere`` and
    ``slab`` tests, and ``tri`` tests of entered chunks (with the kernel's
    warps' issue, ``_closest_triangle``), or in the merged
    search (``k.plan``) the ``aa_rect``, ``aa_tri``, ``quad`` and ``left``
    tests of ``_closest_merged`` (AO probes not counted); and the draws the
    kernel hashes: ``draws``, the scatter's two where a bounce scatters and
    the roulette where the material can refract, ``probe_draws``, the AO
    probes' two a probe where they run (a bounce that accumulates, or with
    ``record`` every live entry).

    With ``record`` returns ``(out, idx, aof)`` as ``raytpu``'s
    ``with_indices``: the per-bounce winner (bounces, B) int32, a triangle
    t as ``n_spheres + t``, -1 where the ray missed or its loop is over;
    with ``use_ao`` the per-bounce AO factor (bounces, B) f32, computed on
    every lane as ``raytpu`` does (else None). A bounce after every ray
    has finished records -1 and 0 (``skip_body``).
    """
    if k.plan is not None and tb.aa is None:
        raise ValueError("the merged search needs the tables of "
                         "pack_scene(scene, k) / mesh_tables(..., k)")
    n_s = k.n_spheres
    sky_on = k.sky_idx >= 0
    carry = initial_carry(ox, oy, oz, dx, dy, dz)
    sky = initial_sky(ox) if sky_on else ()
    idx_rec, aof_rec = [], []
    # sphere winner table with a zero column n_s for triangle winners and misses
    stab = torch.cat([tb.sph[:, :n_s], tb.sph.new_zeros((14, 1))], dim=1)
    geo = [[stab[r, s] for s in range(n_s)] for r in range(4)]
    atlas = TextureAtlas(Vec3(*tb.atlas[:3]), tb.atlas[3], k.atlas_w, k.atlas_h)
    table = MatTable(Vec3(*tb.mats[:3]), tb.mats[3], tb.mats[4], tb.mats[5],
                     tb.mats[6], tb.mats[7] > 0.0, tb.mats[8] > 0.0)
    for i in range(k.bounces):
        o, d = carry[0:3], carry[3:6]
        active = carry[18] > 0.0
        if not bool(active.any()):
            # skip_body: a finished ray's carry is left as it is
            idx_rec.append(torch.full_like(ox, -1, dtype=torch.int32))
            aof_rec.append(torch.zeros_like(ox))
            continue
        if counts is not None:
            live = int(active.sum())
            counts["live"] += live
            counts["sphere"] += live * n_s
            if k.plan is None:
                counts["slab"] += live * k.n_chunks
        best, bidx = _closest_sphere(geo, n_s, *o, *d, k.sphere_eps)
        if k.plan is None:
            best, bidx = _closest_triangle(tb, k, o, d, active, best, bidx,
                                           counts)
        else:
            best, bidx = _closest_merged(tb, k, o, d, active, best, bidx,
                                         counts)
        idx_rec.append(torch.where(active, bidx, -1))
        did_hit = bidx >= 0
        tri_wins = bidx >= n_s
        safe_t = torch.where(did_hit, best, 0.0)
        p = Vec3(*(oc + dc * safe_t for oc, dc in zip(o, d)))

        sph_wins = did_hit & ~tri_wins
        (scx, scy, scz, sr, sdfx, sdfy, sdfz, semx, semy, semz, sestr, srefl,
         salpha, sior) = stab[:, torch.where(sph_wins, bidx, n_s).long()].unbind(0)
        svx, svy, svz = p.x - scx, p.y - scy, p.z - scz
        n2s = svx * svx + svy * svy + svz * svz
        s_inv = torch.where((n2s > 0) & sph_wins,
                            1.0 / torch.sqrt(torch.clamp(n2s, min=1e-38)), 0.0)

        w = tb.tri[:, torch.where(tri_wins, bidx - n_s, 0).long()]   # (25, B)
        tn = Vec3(w[9], w[10], w[11]).normalize()
        m = triangle_material(Vec3(w[0], w[1], w[2]), Vec3(w[12], w[13], w[14]),
                              Vec3(w[15], w[16], w[17]), (w[18], w[19]),
                              (w[20], w[21]), (w[22], w[23]), tn, p, w[24],
                              atlas, table)
        sel = lambda t, s: torch.where(tri_wins, t, s)
        nrm = Vec3(sel(tn.x, svx * s_inv), sel(tn.y, svy * s_inv),
                   sel(tn.z, svz * s_inv))
        row0 = k.n_draws * i
        aof = (_ao_factor(tb, geo, k, p, nrm, active, draws, row0)
               if k.use_ao else None)
        aof_rec.append(aof)
        em = (sel(m.emission.x, semx), sel(m.emission.y, semy),
              sel(m.emission.z, semz))
        estr = sel(m.emission_strength, sestr)
        if sky_on:
            # the sky sphere's emission is the texel, added outside
            sky_win = did_hit & (bidx == k.sky_idx)
            em = tuple(torch.where(sky_win, 0.0, e) for e in em)
            sdir = sky_direction(*p, scx, scy, scz, sr)
        rc = carry[6:9]
        alpha = sel(m.alpha, salpha)
        carry, e_ret, acc = shade_bounce(
            i, carry, did_hit, *p, *nrm,
            sel(m.diffuse.x, sdfx), sel(m.diffuse.y, sdfy),
            sel(m.diffuse.z, sdfz), *em, estr, sel(m.reflection, srefl),
            alpha, sel(m.ior, sior),
            draws[row0], draws[row0 + 1], draws[row0 + 2],
            e_scale_mult=k.e_scale_mult, ao_factor=aof, with_masks=True,
            **k.shade_kw,
        )
        if counts is not None:
            live = active & did_hit & ~e_ret
            refr = live & (alpha <= k.alpha_hi) & (alpha >= k.alpha_lo)
            probed = int((active if record else acc).sum()) if k.use_ao else 0
            counts["draws"] = (counts.get("draws", 0) + 2 * int(acc.sum())
                               + int(refr.sum()))
            counts["probe_draws"] = (counts.get("probe_draws", 0)
                                     + 2 * k.ao_samples * probed)
        if sky_on:
            sky = take_sky_slot(sky, sky_win, e_ret, acc, estr, rc,
                                k.e_scale_mult, sdir)
    out = torch.stack(carry[9:18] + sky[:7])
    if not record:
        return out
    return (out, torch.stack(idx_rec),
            torch.stack(aof_rec) if k.use_ao else None)


_ARGTYPES = (
    [ctypes.c_void_p] * 16                 # 6 tables, 6 rays, keys, out,
                                           # idx_out, aof_out
    + [ctypes.c_int] * 9                   # n_rays n_spheres n_tris n_mats n_tex
                                           # atlas_w atlas_h bounces n_draws
    + [ctypes.c_float] * 7                 # sphere/det/tri eps, alpha lo/hi,
                                           # bright boost/threshold
    + [ctypes.c_int] * 2                   # use_ao, ao_samples
    + [ctypes.c_float] * 2                 # ao_e_scale, ao_inv
    + [ctypes.c_int] + [ctypes.c_float] * 2  # hsl_on, hsl_l, hsl_s
    + [ctypes.c_int] * 2                   # sky_idx, coop_min
    + [ctypes.c_void_p] * 8                # merged: aa aa3 (walk order) quad
                                           # qbox left lbox aa_box aa3_box
    + [ctypes.c_int] * 4                   # n_aa n_aa3 n_quad n_left
    + [ctypes.c_void_p]                    # layout (host int[18]) or null
    + [ctypes.c_float]                     # hi_eps = 1 - tri_eps
    + [ctypes.c_void_p]                    # stream
)


def out_planes(k: Knobs) -> int:
    """Planes K1 and K3 return: 9, or 16 with the sky slot."""
    return 16 if k.sky_idx >= 0 else 9


def _library():
    from raytpu_torch.kernels import _build

    fn = _build.load("trace_scene").raytpu_trace_scene
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(tb: MeshTables, rays: tuple, keys: Tensor, k: MeshKnobs,
            record: bool = False):
    """Launch ``csrc/trace_scene.cu`` on the current stream with the ray
    keys (2, B) int32. Returns what ``trace_scene_reference`` returns for
    the same ``record`` and the keys' draws (``rng.bounce_draws``); a
    merged plan's walk boxes are those of WALK_CHUNK columns."""
    global launches
    b = rays[0].shape[0]
    dev = rays[0].device
    rng.check_keys(keys, b, dev, "trace_scene")
    tensors = (tb.sph, tb.search, tb.tri, tb.boxes, tb.mats, tb.atlas, *rays)
    if not all(t.is_contiguous() and t.dtype == torch.float32 for t in tensors):
        raise ValueError("trace_scene kernel needs contiguous f32 inputs")
    if not keys.is_contiguous():
        raise ValueError("trace_scene kernel needs contiguous ray keys")
    out = torch.empty((out_planes(k), b), dtype=torch.float32, device=dev)
    idx = aof = None
    if record:
        idx = torch.empty((k.bounces, b), dtype=torch.int32, device=dev)
        if k.use_ao:
            aof = torch.empty((k.bounces, b), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    merged = (None,) * 8
    layout = None
    if k.plan is not None:
        merged = (tb.aa_walk, tb.aa3_walk, tb.quad, tb.qbox, tb.left, tb.lbox,
                  tb.aa_box, tb.aa3_box)
        if not all(t is not None and t.is_contiguous() and t.device == dev
                   and t.dtype == torch.float32 for t in merged):
            raise ValueError("merged K3 needs the tables of walk_tables and "
                             "pack_quads (mesh_tables with the knobs)")
        n_box = [sum(-(-n // WALK_CHUNK) for n in sizes)
                 for sizes in _sub_list_sizes(k.plan).values()]
        if [tb.aa_box.shape[1], tb.aa3_box.shape[1]] != n_box:
            raise ValueError(f"merged K3: walk boxes are not those of "
                             f"{WALK_CHUNK}-column chunks")
        layout = (ctypes.c_int * 18)(*(c for g in k.aa_layout for c in g[2:]))
        merged = tuple(t.data_ptr() if t.numel() else None for t in merged)
    n_aa, n_aa3 = (0, 0) if k.plan is None else (tb.aa.shape[1], tb.aa3.shape[1])
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in tensors), keys.data_ptr(), out.data_ptr(),
            ptr(idx),
            ptr(aof), b, k.n_spheres, k.n_tris, k.n_mats, k.n_tex,
            k.atlas_w, k.atlas_h, k.bounces, k.n_draws,
            k.sphere_eps, k.det_eps, k.tri_eps, k.alpha_lo, k.alpha_hi,
            k.bright_boost, k.bright_threshold,
            int(k.use_ao), k.ao_samples, k.ao_e_scale, k.ao_inv,
            int(k.hsl_on), k.hsl_l, k.hsl_s, k.sky_idx, COOP_MIN, *merged,
            n_aa, n_aa3,
            k.n_quads, k.n_leftover, layout, 1.0 - k.tri_eps, stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_scene kernel launch failed: cudaError {err}")
    launches += 1
    return (out, idx, aof) if record else out


def func_attrs(record: bool, sky: bool, merged: bool = True) -> dict:
    """An instantiation's attributes as the CUDA runtime reports them for
    the current card (``cudaFuncGetAttributes``): registers and local bytes a
    thread, static shared bytes, and the dynamic shared bytes of its last
    launch."""
    from raytpu_torch.kernels import _build

    fn = _build.load("trace_scene").raytpu_trace_scene_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.func_attrs(fn, int(merged), int(record), int(sky))


def _forward(tb: MeshTables, rays, src: Tensor, k: MeshKnobs,
             record: bool = False):
    """K3 on the device of the tables: the kernel for CUDA tensors (``src``
    the ray keys), the plain version for CPU tensors (``src`` the keys or
    a draw buffer)."""
    dev = tb.sph.device
    if dev.type == "cuda":
        return _launch(tb, rays, src, k, record)
    if dev.type == "cpu":
        return trace_scene_reference(
            tb, *rays, rng.plain_draws(src, k.n_draws, k.bounces), k,
            record=record)
    raise NotImplementedError(f"trace_scene: no kernel for {dev}")


class TraceMesh(torch.autograd.Function):
    """K3 in recording mode, then K2's mesh mode.

    Counterpart of ``raytpu``'s ``_mkm_vjp`` / ``_mkm_fwd`` / ``_mkm_bwd``:
    the forward records each bounce's winner index (and AO factor), the
    backward replays the bounces from them without a search
    (``trace_scene_bwd.mesh_backward``). Inputs: the packed tables sph
    (14, S), tri (25, T), mats (9, M) and atlas (4, n_tex), the six ray
    planes, the draw source (the (2, B) int32 ray keys, whose draws K3 and
    K2 hash, 8 B a ray; on CPU tensors also a (bounces * n_draws, B) draw
    buffer) and the knobs; output (9, B),
    or (16, B) with the sky slot, whose direction and early-flag planes
    get no cotangent (they reach the image only through floor() and
    compares), so K2 takes the first 12 planes' cotangent.
    The search channels, cull boxes and merged tables are derived from
    ``tri`` inside: they are selection and carry no cotangent, and the
    merged search's winners are original triangle indices, which K2
    replays as the per-triangle search's. The table cotangents go
    back through the packers by autograd, as ``raytpu``'s ``jax.vjp`` of
    ``_pack_diff``; the draws get none (zero by construction).
    """

    @staticmethod
    def forward(ctx, sph, tri, mats, atlas, ox, oy, oz, dx, dy, dz, src,
                k: MeshKnobs, selection: Optional[dict] = None):
        from raytpu_torch.kernels.trace_scene_bwd import check_depth

        check_depth(k.bounces)
        rays = (ox, oy, oz, dx, dy, dz)
        out, idx, aof = _forward(mesh_tables(sph, tri, mats, atlas, k,
                                             selection), rays,
                                 src, k, record=True)
        ctx.k = k
        ctx.save_for_backward(sph, tri, mats, atlas, *rays, src, idx, aof)
        return out

    @staticmethod
    def backward(ctx, g):
        from raytpu_torch.kernels.trace_scene_bwd import (Tables, g_planes,
                                                          mesh_backward)

        sph, tri, mats, atlas, *rays, src, idx, aof = ctx.saved_tensors
        *d_tabs, d_rays = mesh_backward(Tables(sph, tri, mats, atlas), rays,
                                        src, idx, aof,
                                        g[:g_planes(ctx.k)].contiguous(), ctx.k)
        return (*d_tabs, *d_rays, None, None, None)


def frame_selection(scene: Scene, cfg: RenderConfig) -> dict:
    """``selection_tables`` of ``scene`` under ``cfg``'s plan, detached:
    what every sample of a render call shares. Counts (``observe.count``)
    the scene's triangles, ``trace_scene.triangles``, and the candidates
    its search tests, ``trace_scene.candidates``: the merged plan's rects,
    unpaired axis-aligned triangles, general parallelograms and leftover
    triangles, else every triangle."""
    k = MeshKnobs.for_scene(cfg, scene, 0)
    p = k.plan
    observe.count("trace_scene.triangles", k.n_tris)
    observe.count("trace_scene.candidates", k.n_tris if p is None else
                  len(p.rects) + len(p.aa_tris) + len(p.quads)
                  + len(p.leftovers))
    with torch.no_grad():
        return selection_tables(pack_tri(scene), k)


def trace_mesh_megakernel(scene: Scene, cfg: RenderConfig, origin: Vec3,
                          direction: Vec3, src: Tensor,
                          selection: Optional[dict] = None
                          ) -> tuple[Vec3, Vec3, Vec3]:
    """(radiance, albedo AOV, normal AOV) for a batch of rays through a
    mesh scene.

    src: the rays' threefry keys, (2, B) int32 (``render.sample_start``),
    whose draws K3 hashes (n_bounce_draws(cfg) a bounce, after the 4
    camera draws); on CPU tensors also a (max_bounces, n_bounce_draws(cfg),
    B) U(0,1) draw buffer. Runs on the device of the scene: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. When a
    table leaf or a ray requires grad it runs ``TraceMesh`` (K3 recording,
    then K2's mesh mode in the backward). A sky scene's slot planes are
    composed with the sky texels by ``trace_spheres.compose_sky``. Raises
    ``NotImplementedError`` for scenes the kernel does not cover
    (``unsupported_reasons``). ``selection``: ``frame_selection`` of the
    same scene and config, or None to build it here. Span
    (``observe.span``) ``trace_scene.tables``, once a call: the packers
    and, not differentiated, ``mesh_tables``.
    """
    from raytpu_torch.integrator.path import n_bounce_draws
    from raytpu_torch.kernels.trace_spheres import compose_sky, pack_spheres

    reasons = unsupported_reasons(scene, cfg)
    if reasons:
        raise NotImplementedError("trace_scene: " + "; ".join(reasons))
    rays = (*origin, *direction)
    dev = scene.device
    b = src.shape[-1]
    if rng.is_keys(src):
        nd = n_bounce_draws(cfg)
        if src.shape != (2, b) or src.device != dev:
            raise ValueError(f"trace_scene: ray keys {tuple(src.shape)} on "
                             f"{src.device}: need (2, B) on {dev}")
    else:
        if dev.type != "cpu":
            raise ValueError(
                "trace_scene: the kernel hashes its draws; pass the ray "
                "keys of render.sample_start, not a draw buffer")
        bn, nd = src.shape[:2] if src.dim() == 3 else (-1, -1)
        if bn != cfg.max_bounces or nd < n_bounce_draws(cfg):
            raise ValueError(
                f"bounce_draws {tuple(src.shape)}: need "
                f"({cfg.max_bounces}, >={n_bounce_draws(cfg)}, B)")
        src = src.reshape(bn * nd, b).contiguous()
    k = MeshKnobs.for_scene(cfg, scene, nd)
    for t in rays:
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 1
                or t.shape[0] != b):
            raise ValueError(
                f"trace_scene: rays must be f32 (B,) with B={b} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    rays = tuple(t.contiguous() for t in rays)
    with observe.span("trace_scene.tables"):
        tabs = (pack_spheres(scene), pack_tri(scene), pack_mats(scene),
                pack_atlas(scene))
        grad = torch.is_grad_enabled() and requires_grad(*tabs, *rays)
        tables = None if grad else mesh_tables(*tabs, k, selection)
    if grad:
        out = TraceMesh.apply(*tabs, *rays, src, k, selection)
    else:
        out = _forward(tables, rays, src, k)
    if k.sky_idx >= 0:
        return compose_sky(scene, cfg, out)
    return Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9])
