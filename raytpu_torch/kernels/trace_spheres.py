"""The sphere megakernel (K1): the whole forward bounce loop in one launch.

Port of ``raytpu/kernels/trace_spheres.py`` (``_kernel`` ->
``_forward_body``, the Pallas kernel ``_trace_call`` launches) with its
recording mode for the backward and its equirect-sky slot. Per ray and
bounce:
closest sphere hit, AOV base cases, emissive early return with the HSL
boost, diffuse/specular lerp, probabilistic refraction with the reduced
``pile.h`` medium scalar, alpha cutout, the x1.3 bright quirk and the AO
probes, with all state carried between bounces.

``trace_megakernel`` is the entry point. On CUDA tensors it launches the
hand-written kernel in ``csrc/trace_spheres.cu``; on CPU tensors it runs
``trace_spheres_reference``, the plain PyTorch version of the same loop,
which the tests hold against ``raytpu`` and the chip check holds the
kernel against. The kernel takes each ray's threefry key (the (2, B) int32
words of ``core.rng.sample_stream``) and hashes the bounce draws itself,
draw j of bounce b at counter ``4 + b * n_draws + j`` with ``n_draws =
integrator.path.n_bounce_draws(cfg)``; the plain version reads the same
draws from the eager stream (``core.rng.bounce_draws``), or a draw buffer
where a caller passes one (CPU tensors only), so its results are
``raytpu``'s, which draws them with ``jax.random`` outside its kernel.

Gradients: ``TraceSpheres`` joins K1 in recording mode to the
index-replay backward K2 (``kernels/trace_scene_bwd``), or, with
``RAYTPU_SPH_BWD=ad`` (read when the backward runs, as ``raytpu``'s
``_mk_bwd`` reads it), to K5: ``spheres_ad``, the AD of the forward, which
runs the sphere search and the AO probes again instead of reading the
recorded winners (the CUDA kernel in ``csrc/trace_spheres_bwd.cu``; its
plain version ``ad_reference`` is ``torch.autograd.grad`` through
``trace_spheres_reference``, the counterpart of ``jax.vjp`` of
``_forward_body``).

The equirect sky (``Scene.sky_index``): the kernel keeps one sky slot a
ray (``trace_scene.take_sky_slot``) and returns 16 planes; ``compose_sky``
maps the slot's direction to its texel and adds it outside the kernel, as
``raytpu`` does outside ``pallas_call``, for K1 and K3 alike.
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch import Tensor

from raytpu_torch.core import rng
from raytpu_torch.core.color import hsl_boost
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.kernels.trace_scene import (TWO_PI, Knobs, initial_carry,
                                             initial_sky, out_planes,
                                             shade_bounce, sky_direction,
                                             take_sky_slot)
from raytpu_torch.kernels.trace_scene_bwd import (check_depth, g_planes,
                                                  sphere_backward)
from raytpu_torch.materials.texture import sky_texel_index

MAX_SPHERES = 64
BIG = 3.0e38

launches = 0      # K1 launches by trace_megakernel (CPU calls do not count)
ad_launches = 0   # K5 launches by spheres_ad (CPU calls do not count)


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """The port's K1 covers sphere scenes of 1 to 64 spheres, with or
    without an equirect sky whose sphere index is in range."""
    return not unsupported_reasons(scene, cfg)


def unsupported_reasons(scene: Scene, cfg: RenderConfig) -> list[str]:
    """Human-readable failed gates of ``supported``."""
    r = []
    n = scene.spheres.count
    if scene.n_triangles != 0:
        r.append("scene has triangles (the mesh kernel, "
                 "kernels/trace_scene, traces them)")
    if n == 0:
        r.append("no spheres")
    if n > MAX_SPHERES:
        r.append(f"{n} spheres > {MAX_SPHERES}")
    if scene.sky_sphere_index >= n:
        r.append("sky_sphere_index out of range")
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


def _closest_sphere(geo, n_s, rox, roy, roz, rdx, rdy, rdz, eps):
    """(best t, winner index or -1): strict t < best in sphere order."""
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
        sq = torch.sqrt(torch.clamp(disc, min=1e-30))
        t1 = (-b_ - sq) * inv_2a
        t2 = (-b_ + sq) * inv_2a
        hit_s = disc > 0.0
        t = torch.where(
            hit_s & (t1 >= eps), t1,
            torch.where(hit_s & (t2 >= eps), t2, BIG),
        )
        better = t < best
        best = torch.where(better, t, best)
        bidx = torch.where(better, s, bidx)
    return best, bidx


def _ao_factor(geo, n_s, px, py, pz, nX, nY, nZ, draws, row0, k: Knobs):
    """Hemisphere probes from the hit point (any hit at t >= eps):
    occluded probes / (ao_samples * ao_intensity)."""
    occ = torch.zeros_like(px)
    for s_i in range(k.ao_samples):
        ath = TWO_PI * draws[row0 + 3 + 2 * s_i]
        acp = torch.clamp(2.0 * draws[row0 + 4 + 2 * s_i] - 1.0, -1.0, 1.0)
        asp = torch.sqrt(torch.clamp(1.0 - acp * acp, min=0.0))
        aox, aoy, aoz = Vec3(
            nX + torch.cos(ath) * asp, nY + torch.sin(ath) * asp, nZ + acp,
        ).normalize()
        aq = aox * aox + aoy * aoy + aoz * aoz
        ai2a = 0.5 / torch.clamp(aq, min=1e-20)
        occ_hit = torch.zeros_like(px, dtype=torch.bool)
        for s2 in range(n_s):
            scx, scy, scz, sr = geo[0][s2], geo[1][s2], geo[2][s2], geo[3][s2]
            ocx, ocy, ocz = px - scx, py - scy, pz - scz
            b2 = 2.0 * (ocx * aox + ocy * aoy + ocz * aoz)
            c2 = ocx * ocx + ocy * ocy + ocz * ocz - sr * sr
            d2 = b2 * b2 - 4.0 * aq * c2
            sq2 = torch.sqrt(torch.clamp(d2, min=1e-30))
            tt1 = (-b2 - sq2) * ai2a
            tt2 = (-b2 + sq2) * ai2a
            occ_hit = occ_hit | (
                (d2 > 0.0) & ((tt1 >= k.sphere_eps) | (tt2 >= k.sphere_eps))
            )
        occ = occ + torch.where(occ_hit, 1.0, 0.0)
    return occ * k.ao_inv


def trace_spheres_reference(sph: Tensor, ox: Tensor, oy: Tensor, oz: Tensor,
                            dx: Tensor, dy: Tensor, dz: Tensor,
                            draws: Tensor, k: Knobs, record: bool = False,
                            counts: dict | None = None):
    """Plain PyTorch version of the kernel (``_forward_body``), op for op
    in ``raytpu``'s forms: the closest-hit search, the winner's point and
    normal, the AO probes, then ``trace_scene.shade_bounce``, and with
    ``k.sky_idx >= 0`` the sky slot (``trace_scene.take_sky_slot``).

    sph (14, S); rays (B,) each; draws (bounces * n_draws, B).
    Returns (9, B): radiance xyz, albedo xyz, normal xyz; with the sky
    slot (16, B): those, then the slot's scale xyz, unit direction xyz
    and early flag. With ``record``
    returns ``(out, idx, aof)``: the per-bounce winner index (bounces, B)
    int32, -1 where the ray missed or its bounce loop is over, and with
    ``use_ao`` the per-bounce AO factor (bounces, B) f32 (else None).

    ``counts``, a dict, receives the work the keyed kernels do on these
    rays: "live", the (ray, bounce) entries in the loop that hit; "draws",
    the scatter and roulette draws they hash (two for a bounce that
    scatters, one where the material can refract); "probe_draws", the AO
    probes' (two a probe of a bounce that accumulates, or of every
    (ray, bounce) when recording with AO).
    """
    n_s = k.n_spheres
    sky_on = k.sky_idx >= 0
    carry = initial_carry(ox, oy, oz, dx, dy, dz)
    sky = initial_sky(ox) if sky_on else ()
    # winner table with a zero column for misses (the miss winner is all 0)
    tab = torch.cat([sph[:, :n_s], torch.zeros_like(sph[:, :1])], dim=1)
    geo = [[sph[r, s] for s in range(n_s)] for r in range(4)]
    idx_rec, aof_rec = [], []

    for i in range(k.bounces):
        rox, roy, roz, rdx, rdy, rdz = carry[:6]
        best, bidx = _closest_sphere(geo, n_s, rox, roy, roz, rdx, rdy, rdz,
                                     k.sphere_eps)
        did_hit = bidx >= 0
        if record:   # carry[18]: the ray is still in its bounce loop
            idx_rec.append(torch.where(carry[18] > 0.0, bidx, -1))
        safe_t = torch.where(did_hit, best, 0.0)
        px = rox + rdx * safe_t
        py = roy + rdy * safe_t
        pz = roz + rdz * safe_t
        (cx, cy, cz, r, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
         ior) = tab[:, torch.where(did_hit, bidx, n_s).long()].unbind(0)
        if sky_on:
            # the sky sphere's emission is the texel, added outside
            sky_win = did_hit & (bidx == k.sky_idx)
            emx, emy, emz = (torch.where(sky_win, 0.0, e)
                             for e in (emx, emy, emz))
            sdir = sky_direction(px, py, pz, cx, cy, cz, r)

        # outward normal; zero on a miss
        nvx, nvy, nvz = px - cx, py - cy, pz - cz
        n2 = nvx * nvx + nvy * nvy + nvz * nvz
        inv_len = torch.where(
            n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0
        )
        inv_len = torch.where(did_hit, inv_len, 0.0)
        nX, nY, nZ = nvx * inv_len, nvy * inv_len, nvz * inv_len

        row0 = k.n_draws * i
        aof = None
        if k.use_ao:
            aof = _ao_factor(geo, n_s, px, py, pz, nX, nY, nZ, draws, row0, k)
            if record:
                aof_rec.append(aof)
        rc, was_active = carry[6:9], carry[18] > 0.0
        carry, e_ret, acc = shade_bounce(
            i, carry, did_hit, px, py, pz, nX, nY, nZ,
            dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha, ior,
            draws[row0], draws[row0 + 1], draws[row0 + 2],
            e_scale_mult=k.e_scale_mult, ao_factor=aof, with_masks=True,
            **k.shade_kw,
        )
        if counts is not None:
            _count_work(counts, k, record, was_active & did_hit, e_ret, acc,
                        alpha)
        if sky_on:
            sky = take_sky_slot(sky, sky_win, e_ret, acc, estr, rc,
                                k.e_scale_mult, sdir)

    out = torch.stack(carry[9:18] + sky[:7])
    if not record:
        return out
    return (out, torch.stack(idx_rec),
            torch.stack(aof_rec) if k.use_ao else None)


def _count_work(counts, k: Knobs, record, hit, e_ret, acc, alpha):
    """Adds one bounce's live entries and hashed draws to ``counts``
    (``trace_spheres_reference``)."""
    live = hit & ~e_ret
    refr = live & (alpha <= k.alpha_hi) & (alpha >= k.alpha_lo)
    probed = (acc.numel() if record else int(acc.sum())) if k.use_ao else 0
    for name, n in (("live", int(hit.sum())),
                    ("draws", 2 * int(acc.sum()) + int(refr.sum())),
                    ("probe_draws", 2 * k.ao_samples * probed)):
        counts[name] = counts.get(name, 0) + n


_ARGTYPES = (
    [ctypes.c_void_p] * 11                 # sph, ox..dz, keys, out, idx, aof
    + [ctypes.c_int] * 4                   # n_rays, n_spheres, bounces, n_draws
    + [ctypes.c_float] * 5                 # eps, alpha lo/hi, bright boost/threshold
    + [ctypes.c_int] * 2                   # use_ao, ao_samples
    + [ctypes.c_float] * 2                 # ao_e_scale, ao_inv
    + [ctypes.c_int] + [ctypes.c_float] * 2  # hsl_on, hsl_l, hsl_s
    + [ctypes.c_int]                       # sky_idx
    + [ctypes.c_void_p]                    # stream
)


def _library():
    from raytpu_torch.kernels import _build

    lib = _build.load("trace_spheres")
    fn = lib.raytpu_trace_spheres
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(sph: Tensor, rays: tuple, keys: Tensor, k: Knobs,
            record: bool = False):
    """Launch ``csrc/trace_spheres.cu`` on the current stream with the ray
    keys (2, B) int32. Returns what ``trace_spheres_reference`` returns for
    the same ``record`` and the keys' draws (``rng.bounce_draws``)."""
    global launches
    b = rays[0].shape[0]
    dev = sph.device
    _check_keys(keys, b, dev, "trace_spheres")
    tensors = (sph, *rays, keys)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("trace_spheres kernel needs contiguous inputs")
    out = torch.empty((out_planes(k), b), dtype=torch.float32, device=dev)
    idx = aof = None
    if record:
        idx = torch.empty((k.bounces, b), dtype=torch.int32, device=dev)
        if k.use_ao:
            aof = torch.empty((k.bounces, b), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in tensors), out.data_ptr(), ptr(idx),
            ptr(aof), b, k.n_spheres, k.bounces, k.n_draws,
            k.sphere_eps, k.alpha_lo, k.alpha_hi,
            k.bright_boost, k.bright_threshold,
            int(k.use_ao), k.ao_samples, k.ao_e_scale, k.ao_inv,
            int(k.hsl_on), k.hsl_l, k.hsl_s, k.sky_idx, stream,
        )
    if err != 0:
        raise RuntimeError(f"trace_spheres kernel launch failed: cudaError {err}")
    launches += 1
    return (out, idx, aof) if record else out


def _check_keys(keys: Tensor, b: int, dev, what: str) -> None:
    """Raise unless ``keys`` are (2, b) int32 ray keys on ``dev``: the
    kernels hash their draws and take no draw buffer."""
    if (keys.dtype != torch.int32 or tuple(keys.shape) != (2, b)
            or keys.device != dev):
        raise ValueError(
            f"{what} kernel: want the (2, {b}) int32 ray keys of "
            f"rng.sample_stream on {dev} (it hashes its draws), got "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}")


def _forward(sph, rays, src, k: Knobs, record: bool = False):
    """K1 on the device of ``sph``: the kernel for CUDA tensors (``src``
    the ray keys), the plain version for CPU tensors (``src`` the keys or
    a draw buffer)."""
    dev = sph.device
    if dev.type == "cuda":
        return _launch(sph, rays, src, k, record)
    if dev.type == "cpu":
        return trace_spheres_reference(
            sph, *rays, rng.plain_draws(src, k.n_draws, k.bounces), k, record)
    raise NotImplementedError(f"trace_spheres: no kernel for {dev}")


def ad_reference(sph: Tensor, rays, draws: Tensor, g: Tensor, k: Knobs):
    """Plain version of K5: ``torch.autograd.grad`` through
    ``trace_spheres_reference`` on the sphere table and the six ray planes
    (``raytpu``'s ``jax.vjp`` of ``_forward_body``). g (9, B) is the
    cotangent of the radiance, albedo and normal planes, (12, B) with the
    sky slot's scale. Returns (d_sph (14, S), six ray cotangents (B,));
    the draws get none (each use ends in a selection or a comparison)."""
    check_depth(k.bounces)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (sph, *rays)]
        out = trace_spheres_reference(leaves[0], *leaves[1:], draws.detach(), k)
        grads = torch.autograd.grad(out[:g.shape[0]], leaves, g,
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if d is None else d
             for t, d in zip(leaves, grads)]
    return grads[0], tuple(grads[1:])


_AD_ARGTYPES = (
    [ctypes.c_void_p] * 11                 # sph, ox..dz, keys, g, d_rays, partial
    + [ctypes.c_int] * 4                   # n_rays, n_spheres, bounces, n_draws
    + [ctypes.c_float] * 5                 # eps, alpha lo/hi, bright boost/threshold
    + [ctypes.c_int] * 2                   # use_ao, ao_samples
    + [ctypes.c_float] * 2                 # e_scale_mult, ao_inv
    + [ctypes.c_int] + [ctypes.c_float] * 2  # hsl_on, hsl_l, hsl_s
    + [ctypes.c_int]                       # sky_idx
    + [ctypes.c_void_p] * 2                # d_sph, stream
)


def _launch_ad(sph: Tensor, rays, keys: Tensor, g: Tensor, k: Knobs):
    """Launch ``csrc/trace_spheres_bwd.cu`` (the search-and-reverse sweep,
    then the fixed-order sum over blocks of d_sph) on the current stream
    with the ray keys (2, B) int32: what ``ad_reference`` returns for the
    keys' draws."""
    from raytpu_torch.kernels import _build

    global ad_launches
    dev = sph.device
    b = rays[0].shape[0]
    _check_keys(keys, b, dev, "trace_spheres_bwd")
    for t, shape in ((sph, (14, k.n_spheres)), *((r, (b,)) for r in rays),
                     (g, (g_planes(k), b))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"trace_spheres_bwd kernel: want contiguous f32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load("trace_spheres_bwd")
    fn, n_blocks = lib.raytpu_spheres_ad, lib.raytpu_spheres_ad_blocks
    fn.argtypes, fn.restype = _AD_ARGTYPES, ctypes.c_int
    n_blocks.argtypes, n_blocks.restype = [ctypes.c_int] * 2, ctypes.c_int
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    d_rays, d_sph = empty(6, b), empty(14, k.n_spheres)
    partial = empty(max(n_blocks(b, k.n_spheres), 1), 14 * k.n_spheres)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            sph.data_ptr(), *(t.data_ptr() for t in rays), keys.data_ptr(),
            g.data_ptr(), d_rays.data_ptr(), partial.data_ptr(), b,
            k.n_spheres, k.bounces, k.n_draws, k.sphere_eps, k.alpha_lo,
            k.alpha_hi, k.bright_boost, k.bright_threshold, int(k.use_ao),
            k.ao_samples, k.e_scale_mult, k.ao_inv, int(k.hsl_on), k.hsl_l,
            k.hsl_s, k.sky_idx, d_sph.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"trace_spheres_bwd kernel launch failed: cudaError {err}")
    ad_launches += 1
    return d_sph, tuple(d_rays.unbind(0))


def spheres_ad(sph: Tensor, rays, src: Tensor, g: Tensor, k: Knobs):
    """K5: (d_sph (14, S), six ray cotangents) for the output cotangent g
    (9, B), (12, B) with the sky slot's scale, without recorded winners.
    The kernel for CUDA tensors (``src`` the ray keys), the plain version
    for CPU tensors (the keys or a draw buffer); gradients to 48 bounces,
    ``NotImplementedError`` past that (F4)."""
    check_depth(k.bounces)
    dev = sph.device
    if dev.type == "cuda":
        return _launch_ad(sph, rays, src, g, k)
    if dev.type == "cpu":
        return ad_reference(sph, rays,
                            rng.plain_draws(src, k.n_draws, k.bounces), g, k)
    raise NotImplementedError(f"trace_spheres_bwd: no kernel for {dev}")


def sphere_bwd_mode() -> str:
    """``RAYTPU_SPH_BWD``: "replay" (the default, K2) or "ad" (K5)."""
    mode = os.environ.get("RAYTPU_SPH_BWD", "replay")
    if mode not in ("replay", "ad"):
        raise ValueError(f"RAYTPU_SPH_BWD={mode!r}: want 'replay' or 'ad'")
    return mode


class TraceSpheres(torch.autograd.Function):
    """K1 in recording mode, then the index-replay backward K2 (or, with
    ``RAYTPU_SPH_BWD=ad``, K5).

    Counterpart of ``raytpu``'s ``_mk_vjp`` / ``_mk_fwd`` / ``_mk_bwd``:
    the forward records each bounce's winner index (and AO factor), the
    backward replays the bounces from those indices without a search
    (``trace_scene_bwd.sphere_backward``). Inputs: the (14, S) table of
    ``pack_spheres``, the six ray planes, the draw source (the (2, B) int32
    ray keys, whose draws K1 and K2 hash, 8 B a ray; on CPU tensors also a
    (bounces * n_draws, B) draw buffer) and the knobs; output (9, B), or
    (16, B) with the sky slot, of which K2 takes the first 12 planes'
    cotangent (the direction and the early flag reach the image only
    through floor() and compares). The draws get no cotangent (it is zero
    by construction, ``trace_scene_bwd``).
    """

    @staticmethod
    def forward(ctx, sph, ox, oy, oz, dx, dy, dz, src, k: Knobs):
        check_depth(k.bounces)
        rays = (ox, oy, oz, dx, dy, dz)
        out, idx, aof = _forward(sph, rays, src, k, record=True)
        ctx.k = k
        ctx.save_for_backward(sph, *rays, src, idx, aof)
        return out

    @staticmethod
    def backward(ctx, g):
        sph, ox, oy, oz, dx, dy, dz, src, idx, aof = ctx.saved_tensors
        rays, g = (ox, oy, oz, dx, dy, dz), g[:g_planes(ctx.k)].contiguous()
        if sphere_bwd_mode() == "ad":
            d_sph, d_rays = spheres_ad(sph, rays, src, g, ctx.k)
        else:
            d_sph, d_rays = sphere_backward(sph, rays, src, idx, aof, g,
                                            ctx.k)
        return (d_sph, *d_rays, None, None)


def compose_sky(scene: Scene, cfg: RenderConfig, out: Tensor
                ) -> tuple[Vec3, Vec3, Vec3]:
    """(radiance, albedo AOV, normal AOV) from K1's or K3's 16 planes
    (``raytpu``'s ``compose_sky``): the slot's direction to its texel
    (``materials.texture.sky_texel_index``, the scan path's chain), an
    ``index_select`` of the sky table (detached unless
    ``cfg.sky_texture_grads``), then radiance + texel * scale, or the
    HSL-boosted texel as radiance and albedo where the slot is an
    emissive early return. A ray with no sky event has scale 0 and no
    early flag: its texel (of direction 0) is read and adds 0."""
    sky = scene.sky
    idx = sky_texel_index(Vec3(*out[12:15]), sky.width, sky.height)
    table = sky.rgb if cfg.sky_texture_grads else Vec3(*(c.detach()
                                                         for c in sky.rgb))
    texel = Vec3(*(c.index_select(0, idx) for c in table))
    early = out[15] > 0.0
    boosted = hsl_boost(texel, cfg.hsl_l_factor, cfg.hsl_s_factor)
    inc = Vec3.where(early, boosted, Vec3(*out[0:3]) + texel * Vec3(*out[9:12]))
    alb = Vec3.where(early, boosted, Vec3(*out[3:6]))
    return inc, alb, Vec3(*out[6:9])


def trace_megakernel(scene: Scene, cfg: RenderConfig, origin: Vec3,
                     direction: Vec3, src: Tensor
                     ) -> tuple[Vec3, Vec3, Vec3]:
    """(radiance, albedo AOV, normal AOV) for a batch of rays.

    src: the rays' threefry keys, (2, B) int32 (``rng.sample_stream``),
    whose draws K1 hashes (n_bounce_draws(cfg) a bounce, after the 4
    camera draws); on CPU tensors also a (max_bounces, n_bounce_draws(cfg),
    B) U(0,1) draw buffer. Runs on the device of the scene: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. When the
    sphere table or a ray requires grad, it runs ``TraceSpheres`` (K1
    recording, then K2 in the backward). A sky scene's slot planes go
    through ``compose_sky``. Raises ``NotImplementedError`` for scenes the
    kernel does not cover.
    """
    reasons = unsupported_reasons(scene, cfg)
    if reasons:
        raise NotImplementedError("trace_spheres: " + "; ".join(reasons))
    sph = pack_spheres(scene)
    rays = (*origin, *direction)
    dev = sph.device
    b = src.shape[-1]
    if rng.is_keys(src):
        nd, draws = n_bounce_draws(cfg), src
        if src.shape != (2, b) or src.device != dev:
            raise ValueError(f"trace_spheres: ray keys {tuple(src.shape)} on "
                             f"{src.device}: need (2, B) on {dev}")
    else:
        if dev.type != "cpu":
            raise ValueError(
                "trace_spheres: the kernel hashes its draws; pass the ray "
                "keys of rng.sample_stream, not a draw buffer")
        bn, nd = src.shape[:2] if src.dim() == 3 else (-1, -1)
        if bn != cfg.max_bounces or nd < n_bounce_draws(cfg):
            raise ValueError(
                f"bounce_draws {tuple(src.shape)}: need "
                f"({cfg.max_bounces}, >={n_bounce_draws(cfg)}, B)"
            )
        draws = src.reshape(bn * nd, b)
    k = Knobs.create(cfg, scene.spheres.count, nd, scene.sky_index)
    for t in rays:
        if (t.device != dev or t.dtype != torch.float32 or t.dim() != 1
                or t.shape[0] != b):
            raise ValueError(
                f"trace_spheres: rays and draws must be f32 with B={b} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if torch.is_grad_enabled() and (
        sph.requires_grad or any(t.requires_grad for t in rays)
    ):
        out = TraceSpheres.apply(sph, *rays, draws, k)
    else:
        out = _forward(sph, rays, draws, k)
    if k.sky_idx >= 0:
        return compose_sky(scene, cfg, out)
    return Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9])
