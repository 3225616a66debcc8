"""The sphere megakernel (K1): the whole forward bounce loop in one launch.

Port of ``raytpu/kernels/trace_spheres.py`` (``_kernel`` ->
``_forward_body``, the Pallas kernel ``_trace_call`` launches) for the
forward render without sky slot or index recording. Per ray and bounce:
closest sphere hit, AOV base cases, emissive early return with the HSL
boost, diffuse/specular lerp, probabilistic refraction with the reduced
``pile.h`` medium scalar, alpha cutout, the x1.3 bright quirk and the AO
probes, with all state carried between bounces.

``trace_megakernel`` is the entry point. On CUDA tensors it launches the
hand-written kernel in ``csrc/trace_spheres.cu``; on CPU tensors it runs
``trace_spheres_reference``, the plain PyTorch version of the same loop,
which the tests hold against ``raytpu`` and the chip check holds the
kernel against. Random draws are made outside the kernel from the
threefry stream (``core.rng.ray_uniforms``), as in ``raytpu``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from raytpu_torch.core.color import hsl_boost
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3

MAX_SPHERES = 64
BIG = 3.0e38
TWO_PI = 2.0 * float(np.float32(math.pi))  # 2 * f32(pi), exact in f32

launches = 0   # kernel launches by trace_megakernel (CPU calls do not count)


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """The port's K1 covers sphere scenes of 1 to 64 spheres without an
    equirect sky (the sky slot is not ported yet)."""
    return not unsupported_reasons(scene, cfg)


def unsupported_reasons(scene: Scene, cfg: RenderConfig) -> list[str]:
    """Human-readable failed gates of ``supported``."""
    r = []
    n = scene.spheres.count
    if scene.n_triangles != 0:
        r.append("scene has triangles (mesh kernel not ported)")
    if n == 0:
        r.append("no spheres")
    if n > MAX_SPHERES:
        r.append(f"{n} spheres > {MAX_SPHERES}")
    if scene.sky_sphere_index >= 0:
        r.append("equirect sky (sky slot not ported)")
    return r


def pack_spheres(scene: Scene) -> Tensor:
    """(14, S) f32 sphere table, rows cx cy cz r | diffuse3 emission3
    e_strength reflection alpha ior (``_pack_inputs``' layout, without
    the TPU's 128-lane padding)."""
    s = scene.spheres
    m = s.mat
    return torch.stack([
        s.center.x, s.center.y, s.center.z, s.radius,
        m.diffuse.x, m.diffuse.y, m.diffuse.z,
        m.emission.x, m.emission.y, m.emission.z,
        m.emission_strength, m.reflection, m.alpha, m.ior,
    ]).to(torch.float32).contiguous()


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

    @staticmethod
    def create(cfg: RenderConfig, n_spheres: int, n_draws: int) -> "Knobs":
        return Knobs(
            n_spheres=n_spheres, bounces=cfg.max_bounces, n_draws=n_draws,
            sphere_eps=cfg.sphere_eps, alpha_lo=cfg.refr_alpha_lo,
            alpha_hi=cfg.refr_alpha_hi, bright_boost=cfg.bright_boost,
            bright_threshold=cfg.bright_threshold, use_ao=cfg.use_ao,
            ao_samples=cfg.ao_samples,
            ao_e_scale=cfg.ao_emission_factor * cfg.ao_intensity,
            ao_inv=1.0 / (cfg.ao_samples * cfg.ao_intensity),
            hsl_l=cfg.hsl_l_factor, hsl_s=cfg.hsl_s_factor,
        )

    @property
    def hsl_on(self) -> bool:
        return not (self.hsl_l == 1.0 and self.hsl_s == 1.0)

    @property
    def draws_needed(self) -> int:
        return 3 + 2 * (self.ao_samples if self.use_ao else 0)


def trace_spheres_reference(sph: Tensor, ox: Tensor, oy: Tensor, oz: Tensor,
                            dx: Tensor, dy: Tensor, dz: Tensor,
                            draws: Tensor, k: Knobs) -> Tensor:
    """Plain PyTorch version of the kernel (``_forward_body`` with
    ``sky_idx=-1, record=False``), op for op in ``raytpu``'s forms.

    sph (14, S); rays (B,) each; draws (bounces * n_draws, B).
    Returns (9, B): radiance xyz, albedo xyz, normal xyz.
    """
    n_s = k.n_spheres
    rox, roy, roz, rdx, rdy, rdz = ox, oy, oz, dx, dy, dz
    f0 = torch.zeros_like(rox)
    f1 = torch.ones_like(rox)
    rcx = rcy = rcz = f1                               # throughput
    ix = iy = iz = f0                                  # incoming radiance
    ax_ = ay_ = az_ = f0                               # albedo AOV
    nx_ = ny_ = nz_ = f0                               # normal AOV
    active = torch.ones_like(rox, dtype=torch.bool)
    is_alpha = torch.zeros_like(active)
    alpha_depth = torch.zeros_like(rox, dtype=torch.int32)
    medium_n2 = f1
    # winner table with a zero column for misses (the miss winner is all 0)
    tab = torch.cat([sph[:, :n_s], torch.zeros_like(sph[:, :1])], dim=1)
    geo = [[sph[r, s] for s in range(n_s)] for r in range(4)]

    for i in range(k.bounces):
        # ---- closest sphere: strict t < best in sphere order ----------
        a_quad = rdx * rdx + rdy * rdy + rdz * rdz
        inv_2a = 0.5 / torch.clamp(a_quad, min=1e-20)
        best = torch.full_like(rox, BIG)
        bidx = torch.full_like(alpha_depth, -1)
        for s in range(n_s):
            cx, cy, cz, r = geo[0][s], geo[1][s], geo[2][s], geo[3][s]
            ocx, ocy, ocz = rox - cx, roy - cy, roz - cz
            b_ = 2.0 * (ocx * rdx + ocy * rdy + ocz * rdz)
            c_ = ocx * ocx + ocy * ocy + ocz * ocz - r * r
            disc = b_ * b_ - 4.0 * a_quad * c_
            sq = torch.sqrt(torch.clamp(disc, min=1e-30))
            t1 = (-b_ - sq) * inv_2a
            t2 = (-b_ + sq) * inv_2a
            hit_s = disc > 0.0
            t = torch.where(
                hit_s & (t1 >= k.sphere_eps), t1,
                torch.where(hit_s & (t2 >= k.sphere_eps), t2, BIG),
            )
            better = t < best
            best = torch.where(better, t, best)
            bidx = torch.where(better, s, bidx)

        did_hit = bidx >= 0
        safe_t = torch.where(did_hit, best, 0.0)
        px = rox + rdx * safe_t
        py = roy + rdy * safe_t
        pz = roz + rdz * safe_t
        (cx, cy, cz, r, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
         ior) = tab[:, torch.where(did_hit, bidx, n_s).long()].unbind(0)

        # outward normal; zero on a miss
        nvx, nvy, nvz = px - cx, py - cy, pz - cz
        n2 = nvx * nvx + nvy * nvy + nvz * nvz
        inv_len = torch.where(
            n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0
        )
        inv_len = torch.where(did_hit, inv_len, 0.0)
        nX, nY, nZ = nvx * inv_len, nvy * inv_len, nvz * inv_len

        # ---- AOV base cases ------------------------------------------
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

        # ---- emissive early return + HSL boost -----------------------
        emissive_ret = active & did_hit & (alpha_depth == i) & (estr > 0.0)
        bx, by, bz = hsl_boost(Vec3(emx, emy, emz), k.hsl_l, k.hsl_s)
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

        # ---- scatter: diffuse/specular lerp --------------------------
        u_d = draws[k.n_draws * i + 0]
        v_d = draws[k.n_draws * i + 1]
        roulette = draws[k.n_draws * i + 2]
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

        # ---- refraction (reduced pile.h medium stack) ----------------
        refr_case = live & (alpha <= k.alpha_hi) & (alpha >= k.alpha_lo)
        exiting = vdn > 0.0
        nex = torch.where(exiting, -nX, nX)
        ney = torch.where(exiting, -nY, nY)
        nez = torch.where(exiting, -nZ, nZ)
        n1_ = torch.where(exiting, ior, medium_n2)
        n2_ = torch.where(exiting, medium_n2, ior)
        medium_n2 = torch.where(refr_case & ~exiting, ior, medium_n2)
        n1s = n1_ * n1_
        n2s = n2_ * n2_
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

        # ---- opaque / cutout -----------------------------------------
        cutout = live & (alpha < k.alpha_lo)
        opaque = live & (alpha > k.alpha_hi)
        is_alpha = (is_alpha & ~opaque) | cutout
        alpha_depth = torch.where(cutout, alpha_depth + 1, alpha_depth)

        accum = live & ~do_refract & ~cutout
        rox = torch.where(live, px, rox)
        roy = torch.where(live, py, roy)
        roz = torch.where(live, pz, roz)
        rdx = torch.where(do_refract, refx, torch.where(accum, drx, rdx))
        rdy = torch.where(do_refract, refy, torch.where(accum, dry, rdy))
        rdz = torch.where(do_refract, refz, torch.where(accum, drz, rdz))

        # ---- accumulate ----------------------------------------------
        e_scale = estr * k.ao_e_scale if k.use_ao else estr
        ix = torch.where(accum, ix + emx * e_scale * rcx, ix)
        iy = torch.where(accum, iy + emy * e_scale * rcy, iy)
        iz = torch.where(accum, iz + emz * e_scale * rcz, iz)
        # the bright test reads the throughput before this bounce's update
        th = k.bright_threshold
        bright = (rcx > th) | (rcy > th) | (rcz > th)
        bb = k.bright_boost
        nbx = torch.where(bright, dfx * (dfx * (rcx * bb)), dfx * rcx)
        nby = torch.where(bright, dfy * (dfy * (rcy * bb)), dfy * rcy)
        nbz = torch.where(bright, dfz * (dfz * (rcz * bb)), dfz * rcz)
        if k.use_ao:
            # hemisphere probes from the hit point: any hit at t >= eps
            occ = f0
            for s_i in range(k.ao_samples):
                au = draws[k.n_draws * i + 3 + 2 * s_i]
                av = draws[k.n_draws * i + 4 + 2 * s_i]
                ath = TWO_PI * au
                acp = torch.clamp(2.0 * av - 1.0, -1.0, 1.0)
                asp = torch.sqrt(torch.clamp(1.0 - acp * acp, min=0.0))
                aox, aoy, aoz = Vec3(
                    nX + torch.cos(ath) * asp, nY + torch.sin(ath) * asp,
                    nZ + acp,
                ).normalize()
                aq = aox * aox + aoy * aoy + aoz * aoz
                ai2a = 0.5 / torch.clamp(aq, min=1e-20)
                occ_hit = torch.zeros_like(active)
                for s2 in range(n_s):
                    scx, scy, scz, sr = (geo[0][s2], geo[1][s2], geo[2][s2],
                                         geo[3][s2])
                    ocx2, ocy2, ocz2 = px - scx, py - scy, pz - scz
                    b2 = 2.0 * (ocx2 * aox + ocy2 * aoy + ocz2 * aoz)
                    c2 = ocx2 * ocx2 + ocy2 * ocy2 + ocz2 * ocz2 - sr * sr
                    d2 = b2 * b2 - 4.0 * aq * c2
                    sq2 = torch.sqrt(torch.clamp(d2, min=1e-30))
                    tt1 = (-b2 - sq2) * ai2a
                    tt2 = (-b2 + sq2) * ai2a
                    occ_hit = occ_hit | (
                        (d2 > 0.0)
                        & ((tt1 >= k.sphere_eps) | (tt2 >= k.sphere_eps))
                    )
                occ = occ + torch.where(occ_hit, 1.0, 0.0)
            factor = occ * k.ao_inv
            nbx, nby, nbz = nbx * factor, nby * factor, nbz * factor
        rcx = torch.where(accum, nbx, rcx)
        rcy = torch.where(accum, nby, rcy)
        rcz = torch.where(accum, nbz, rcz)

        active = active & did_hit

    return torch.stack([ix, iy, iz, ax_, ay_, az_, nx_, ny_, nz_])


_ARGTYPES = (
    [ctypes.c_void_p] * 9                  # sph, ox oy oz dx dy dz, draws, out
    + [ctypes.c_int] * 4                   # n_rays, n_spheres, bounces, n_draws
    + [ctypes.c_float] * 5                 # eps, alpha lo/hi, bright boost/threshold
    + [ctypes.c_int] * 2                   # use_ao, ao_samples
    + [ctypes.c_float] * 2                 # ao_e_scale, ao_inv
    + [ctypes.c_int] + [ctypes.c_float] * 2  # hsl_on, hsl_l, hsl_s
    + [ctypes.c_void_p]                    # stream
)


def _library():
    from raytpu_torch.kernels import _build

    lib = _build.load("trace_spheres")
    fn = lib.raytpu_trace_spheres
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(sph: Tensor, rays: tuple, draws: Tensor, k: Knobs) -> Tensor:
    """Launch ``csrc/trace_spheres.cu`` on the current stream."""
    global launches
    tensors = (sph, *rays, draws)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("trace_spheres kernel needs contiguous inputs")
    b = rays[0].shape[0]
    out = torch.empty((9, b), dtype=torch.float32, device=sph.device)
    fn = _library()
    stream = torch.cuda.current_stream(sph.device).cuda_stream
    with torch.cuda.device(sph.device):
        err = fn(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            b, k.n_spheres, k.bounces, k.n_draws,
            k.sphere_eps, k.alpha_lo, k.alpha_hi,
            k.bright_boost, k.bright_threshold,
            int(k.use_ao), k.ao_samples, k.ao_e_scale, k.ao_inv,
            int(k.hsl_on), k.hsl_l, k.hsl_s, stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_spheres kernel launch failed: cudaError {err}")
    launches += 1
    return out


def trace_megakernel(scene: Scene, cfg: RenderConfig, origin: Vec3,
                     direction: Vec3, bounce_draws: Tensor
                     ) -> tuple[Vec3, Vec3, Vec3]:
    """(radiance, albedo AOV, normal AOV) for a batch of rays.

    bounce_draws: (max_bounces, n_bounce_draws(cfg), B) U(0,1) draws.
    Runs on the device of the scene: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Raises ``NotImplementedError`` for
    scenes the kernel does not cover and for inputs that require grad
    (the backward kernel is not ported).
    """
    reasons = unsupported_reasons(scene, cfg)
    if reasons:
        raise NotImplementedError("trace_spheres: " + "; ".join(reasons))
    sph = pack_spheres(scene)
    rays = (*origin, *direction)
    if sph.requires_grad or bounce_draws.requires_grad or any(
        t.requires_grad for t in rays
    ):
        raise NotImplementedError(
            "trace_spheres: gradients need the backward kernel, not ported"
        )
    bn, nd, b = bounce_draws.shape
    k = Knobs.create(cfg, scene.spheres.count, nd)
    if bn != cfg.max_bounces or nd < k.draws_needed:
        raise ValueError(
            f"bounce_draws {tuple(bounce_draws.shape)}: need "
            f"({cfg.max_bounces}, >={k.draws_needed}, B)"
        )
    dev = sph.device
    for t in (*rays, bounce_draws):
        if (t.device != dev or t.dtype != torch.float32
                or t.shape[-1] != b or (t is not bounce_draws and t.dim() != 1)):
            raise ValueError(
                f"trace_spheres: rays and draws must be f32 with B={b} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    draws = bounce_draws.reshape(bn * nd, b)
    if dev.type == "cuda":
        out = _launch(sph, rays, draws, k)
    elif dev.type == "cpu":
        out = trace_spheres_reference(sph, *rays, draws, k)
    else:
        raise NotImplementedError(f"trace_spheres: no kernel for {dev}")
    return Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9])
