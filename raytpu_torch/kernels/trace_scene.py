"""One bounce's shading, shared by the sphere forward and the backward replay.

Port of ``raytpu/kernels/trace_scene.py:shade_bounce`` op for op. The mesh
forward megakernel (K3) that ``raytpu`` keeps in the same module is not
ported yet; this module holds only the shading both plain versions run:
``trace_spheres_reference`` (K1's plain version) after its closest-hit
search, and ``trace_scene_bwd.replay_bounce`` (K2's plain version) after
it rebuilds the recorded winner. Sharing it keeps the two in step, which
the gradient tests rely on.

The carry is the 22-plane tuple of ``raytpu``'s replay:
``(ro xyz, rd xyz, throughput xyz, radiance xyz, albedo AOV xyz,
normal AOV xyz, active, is_alpha, alpha_depth, medium_n2)``, with the two
masks as f32 0/1 planes and ``alpha_depth`` as int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytpu_torch.core.color import hsl_boost
from raytpu_torch.core.vec3 import Vec3

TWO_PI = 2.0 * float(np.float32(math.pi))  # 2 * f32(pi), exact in f32


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
                 ao_factor=None):
    """Everything after the winner's (point, normal, material) is known:
    AOV base cases, emissive early return with the HSL boost, scatter,
    refraction, cutout and accumulation. ``i`` is the static bounce index.

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
    return (rox, roy, roz, rdx, rdy, rdz, rcx, rcy, rcz, ix, iy, iz,
            ax_, ay_, az_, nx_, ny_, nz_,
            active_f, is_alpha_f, alpha_depth, medium_n2)
