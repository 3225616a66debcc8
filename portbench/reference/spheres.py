"""Plain reference of a sphere scene: camera, sample start, bounce loop.

Written from the configuration file alone (``scene.spheres``,
``camera``, ``render``), in the forms of the program's plain versions:
the look-at camera, ``sample_rays`` on draws 0-3 of each ray's key, and
the sphere bounce loop (closest sphere with the strict ``t < best`` in
sphere order, the winner's point and outward normal, the emissive early
return, the diffuse/specular lerp, the reduced refraction stack, alpha
cutout, accumulation with the x1.3 bright quirk). Each operation is
written as the program writes it (``0.5 / x`` is a reciprocal and a
multiply in PyTorch, a division by a 0-dim tensor is a division), so on
one device the two agree to the bit where the kernels compute the same
operations.

Covered: sphere scenes without AO, sky texture or HSL boost, which is
what the configurations that use this module state; ``build`` refuses
the rest. The albedo and normal AOVs are not traced: the image is the
radiance.

``dtype`` runs the whole trace in another precision (the control of the
check runs it in bfloat16); sums over samples stay in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from portbench.reference import rng, train, work

TWO_PI = 2.0 * float(np.float32(math.pi))
BIG = 3.0e38
# the table's rows, in the order of the leaves the trainer steps
LEAVES = tuple("spheres." + k for k in (
    "center.x", "center.y", "center.z", "radius",
    "mat.diffuse.x", "mat.diffuse.y", "mat.diffuse.z",
    "mat.emission.x", "mat.emission.y", "mat.emission.z",
    "mat.emission_strength", "mat.reflection", "mat.alpha", "mat.ior"))
N_CAMERA_DRAWS = 4
N_BOUNCE_DRAWS = 3   # diffuse u, diffuse v, roulette


@dataclass(frozen=True)
class Settings:
    width: int
    height: int
    bounces: int
    focus_distance: float
    aperture_x: float
    aperture_y: float
    sphere_eps: float
    alpha_lo: float
    alpha_hi: float
    bright_boost: float
    bright_threshold: float


def table(rows, device=None) -> Tensor:
    """The (14, S) f32 table of the config's sphere rows (center, radius,
    diffuse, emission, emission strength, reflection, alpha, ior)."""
    flat = [[*r[0], r[1], *r[2], *r[3], r[4], r[5], r[6], r[7]]
            for r in rows]
    return torch.tensor(np.array(flat, np.float32).T.copy(), device=device)


def build(config: dict, device=None) -> tuple[Tensor, Tensor, Settings]:
    """(sphere table (14, S), packed camera (12,), settings) of a
    configuration file's dict, on ``device``."""
    rc = config["render"]
    if (rc.get("use_ao") or rc.get("hsl_l_factor", 1.0) != 1.0
            or rc.get("hsl_s_factor", 1.0) != 1.0
            or config["scene"].get("sky_sphere_index", -1) >= 0):
        raise NotImplementedError("reference spheres: AO, HSL boost and the "
                                  "sky texture are not covered")
    c = config["camera"]
    s = Settings(
        width=rc["width"], height=rc["height"], bounces=rc["max_bounces"],
        focus_distance=rc["focus_distance"], aperture_x=rc["aperture_x"],
        aperture_y=rc["aperture_y"], sphere_eps=rc["sphere_eps"],
        alpha_lo=rc["refr_alpha_lo"], alpha_hi=rc["refr_alpha_hi"],
        bright_boost=rc["bright_boost"],
        bright_threshold=rc["bright_threshold"])
    cam = camera(c["origin"], c["target"], c["up"], c["vfov_deg"],
                 c["aspect_ratio"], device)
    return table(config["scene"]["spheres"], device), cam, s


# ---- 3-vectors as tuples of tensors --------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a):
    n2 = _dot(a, a)
    inv_len = torch.where(n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)),
                          0.0)
    return a[0] * inv_len, a[1] * inv_len, a[2] * inv_len


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def camera(origin, target, up, vfov_deg, aspect_ratio, device=None) -> Tensor:
    """The look-at camera in f32: (12,) origin, horizontal, vertical,
    lower-left corner; a viewport of height 2 tan(vfov / 2)."""
    vec = lambda c: tuple(torch.as_tensor(x, dtype=torch.float32,
                                          device=device) for x in c)
    o, t, u_ = vec(origin), vec(target), vec(up)
    theta = torch.tensor(vfov_deg, dtype=torch.float32, device=device) * (
        math.pi / 180.0)
    vh = 2.0 * torch.tan(theta / 2.0)
    vw = aspect_ratio * vh
    w = _normalize(tuple(a - b for a, b in zip(o, t)))
    u = _normalize(_cross(u_, w))
    v = _cross(w, u)
    hor = tuple(c * vw for c in u)
    ver = tuple(c * vh for c in v)
    ll = tuple(oc - (hc * 0.5 + (vc * 0.5 + wc))
               for oc, hc, vc, wc in zip(o, hor, ver, w))
    return torch.stack([*o, *hor, *ver, *ll]).to(torch.float32)


def camera_rays(cam: Tensor, s: Settings, pixel_ids: Tensor, d: Tensor):
    """Each pixel's camera ray from its draws 0-3 (4, B): pixel (i, j) with
    j counted from the bottom row, u = (i + U - .5) / (W - 1), v likewise,
    the aperture jitter (U - .5) * aperture on world x and y."""
    full = lambda x: torch.full((), x, dtype=d.dtype, device=d.device)
    i = (pixel_ids % s.width).to(d.dtype)
    j = torch.div(pixel_ids, s.width, rounding_mode="floor").to(d.dtype)
    u = (i + (d[0] - 0.5)) / full(s.width - 1)
    v = (j + (d[1] - 0.5)) / full(s.height - 1)
    dx = (d[2] - 0.5) * s.aperture_x
    dy = (d[3] - 0.5) * s.aperture_y
    c = cam.to(d.dtype)
    o, h, vv, ll = (c[k:k + 3] for k in range(0, 12, 3))
    direction = tuple(ll[a] + (h[a] * u + (vv[a] * v - o[a]))
                      for a in range(3))
    dest = tuple(o[a] + direction[a] * s.focus_distance for a in range(3))
    new_o = (o[0] + dx, o[1] + dy, o[2] + torch.zeros_like(dx))
    return new_o, _normalize(tuple(a - b for a, b in zip(dest, new_o)))


def _closest(geo, n_s, o, d, eps):
    """(best t, winner or -1): strict t < best in sphere order."""
    rdx, rdy, rdz = d
    a_quad = rdx * rdx + rdy * rdy + rdz * rdz
    inv_2a = 0.5 / torch.clamp(a_quad, min=1e-20)
    best = torch.full_like(rdx, BIG)
    bidx = torch.full_like(rdx, -1, dtype=torch.int32)
    for k in range(n_s):
        cx, cy, cz, r = geo[0][k], geo[1][k], geo[2][k], geo[3][k]
        ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
        b_ = 2.0 * (ocx * rdx + ocy * rdy + ocz * rdz)
        c_ = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_ * b_ - 4.0 * a_quad * c_
        sq = torch.sqrt(torch.clamp(disc, min=1e-30))
        t1 = (-b_ - sq) * inv_2a
        t2 = (-b_ + sq) * inv_2a
        hit = disc > 0.0
        t = torch.where(hit & (t1 >= eps), t1,
                        torch.where(hit & (t2 >= eps), t2, BIG))
        better = t < best
        best = torch.where(better, t, best)
        bidx = torch.where(better, k, bidx)
    return best, bidx


def trace(sph: Tensor, o, d, draws: Tensor, s: Settings,
          counts: dict | None = None) -> Tensor:
    """The bounce loop: (3, B) radiance of rays o, d (tuples of (B,)),
    with draw j of bounce b in row 3b + j of ``draws``. ``counts``
    receives the work: "live", the (ray, bounce) pairs still in the loop
    that hit; "draws", the scatter and roulette draws those bounces use
    (two a bounce that scatters, one more where the material can
    refract)."""
    n_s = sph.shape[1]
    rox, roy, roz = o
    rdx, rdy, rdz = d
    f0, f1 = torch.zeros_like(rox), torch.ones_like(rox)
    rcx = rcy = rcz = f1
    ix = iy = iz = f0
    active_f, medium_n2 = f1, f1
    alpha_depth = torch.zeros_like(rox, dtype=torch.int32)
    tab = torch.cat([sph, torch.zeros_like(sph[:, :1])], dim=1)
    geo = [[sph[r, k] for k in range(n_s)] for r in range(4)]
    for i in range(s.bounces):
        best, bidx = _closest(geo, n_s, (rox, roy, roz), (rdx, rdy, rdz),
                              s.sphere_eps)
        did_hit = bidx >= 0
        safe_t = torch.where(did_hit, best, 0.0)
        px = rox + rdx * safe_t
        py = roy + rdy * safe_t
        pz = roz + rdz * safe_t
        (cx, cy, cz, r, dfx, dfy, dfz, emx, emy, emz, estr, refl, alpha,
         ior) = tab[:, torch.where(did_hit, bidx, n_s).long()].unbind(0)
        nvx, nvy, nvz = px - cx, py - cy, pz - cz
        n2 = nvx * nvx + nvy * nvy + nvz * nvz
        inv_len = torch.where(
            n2 > 0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-38)), 0.0)
        inv_len = torch.where(did_hit, inv_len, 0.0)
        nX, nY, nZ = nvx * inv_len, nvy * inv_len, nvz * inv_len
        u_d, v_d, roulette = draws[3 * i], draws[3 * i + 1], draws[3 * i + 2]

        active = active_f > 0.0
        was_live = active & did_hit
        emissive_ret = active & did_hit & (alpha_depth == i) & (estr > 0.0)
        ix = torch.where(emissive_ret, emx, ix)
        iy = torch.where(emissive_ret, emy, iy)
        iz = torch.where(emissive_ret, emz, iz)
        active = active & ~emissive_ret
        live = active & did_hit

        # scatter: diffuse/specular lerp
        theta = TWO_PI * u_d
        cph = torch.clamp(2.0 * v_d - 1.0, -1.0, 1.0)
        sph_ = torch.sqrt(torch.clamp(1.0 - cph * cph, min=0.0))
        ddx, ddy, ddz = _normalize((nX + torch.cos(theta) * sph_,
                                    nY + torch.sin(theta) * sph_, nZ + cph))
        vdn = rdx * nX + rdy * nY + rdz * nZ
        rfx = rdx - 2.0 * vdn * nX
        rfy = rdy - 2.0 * vdn * nY
        rfz = rdz - 2.0 * vdn * nZ
        drx = ddx + (rfx - ddx) * refl
        dry = ddy + (rfy - ddy) * refl
        drz = ddz + (rfz - ddz) * refl

        # refraction through the reduced medium stack
        refr_case = live & (alpha <= s.alpha_hi) & (alpha >= s.alpha_lo)
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
        vdne = rdx * nex + rdy * ney + rdz * nez
        tir = radical <= 0.0
        refx = torch.where(tir, rdx - 2.0 * vdne * nex, refx)
        refy = torch.where(tir, rdy - 2.0 * vdne * ney, refy)
        refz = torch.where(tir, rdz - 2.0 * vdne * nez, refz)
        do_refract = refr_case & (roulette > alpha)

        # opaque / cutout
        cutout = live & (alpha < s.alpha_lo)
        alpha_depth = torch.where(cutout, alpha_depth + 1, alpha_depth)

        accum = live & ~do_refract & ~cutout
        rox = torch.where(live, px, rox)
        roy = torch.where(live, py, roy)
        roz = torch.where(live, pz, roz)
        rdx = torch.where(do_refract, refx, torch.where(accum, drx, rdx))
        rdy = torch.where(do_refract, refy, torch.where(accum, dry, rdy))
        rdz = torch.where(do_refract, refz, torch.where(accum, drz, rdz))

        # accumulate; the bright test reads the throughput before the update
        ix = torch.where(accum, ix + emx * estr * rcx, ix)
        iy = torch.where(accum, iy + emy * estr * rcy, iy)
        iz = torch.where(accum, iz + emz * estr * rcz, iz)
        th, bb = s.bright_threshold, s.bright_boost
        bright = (rcx > th) | (rcy > th) | (rcz > th)
        nbx = torch.where(bright, dfx * (dfx * (rcx * bb)), dfx * rcx)
        nby = torch.where(bright, dfy * (dfy * (rcy * bb)), dfy * rcy)
        nbz = torch.where(bright, dfz * (dfz * (rcz * bb)), dfz * rcz)
        rcx = torch.where(accum, nbx, rcx)
        rcy = torch.where(accum, nby, rcy)
        rcz = torch.where(accum, nbz, rcz)
        active_f = torch.where(active & did_hit, f1, f0)
        if counts is not None:
            refr = live & (alpha <= s.alpha_hi) & (alpha >= s.alpha_lo)
            for name, n in (("live", int(was_live.sum())),
                            ("draws", 2 * int(accum.sum())
                             + int(refr.sum()))):
                counts[name] = counts.get(name, 0) + n
    return torch.stack([ix, iy, iz])


def trace_rays(sph: Tensor, cam: Tensor, s: Settings, k: Tensor,
               pixel_ids: Tensor, sample_ids, dtype=torch.float32,
               counts: dict | None = None) -> Tensor:
    """(3, B) radiance of the rays (pixel_ids[i], sample_ids[i]) under the
    frame key ``k``: their keys, camera rays and bounce loop, computed in
    ``dtype``."""
    keys = rng.ray_keys(k, pixel_ids, sample_ids)
    d = rng.draws(keys, range(N_CAMERA_DRAWS + s.bounces * N_BOUNCE_DRAWS))
    d = d.to(dtype)
    o, direction = camera_rays(cam, s, pixel_ids, d[:N_CAMERA_DRAWS])
    return trace(sph.to(dtype), o, direction, d[N_CAMERA_DRAWS:], s, counts)


def render_pixels(sph: Tensor, cam: Tensor, s: Settings, k: Tensor,
                  pixel_ids: Tensor, spp: int, dtype=torch.float32,
                  max_rays: int = 1 << 20,
                  counts: dict | None = None) -> Tensor:
    """(3, P) f32 radiance sums of ``spp`` samples of the pixels
    ``pixel_ids``, added in sample order from zero as the program adds
    them. Samples are traced together, at most ``max_rays`` rays a call."""
    p = pixel_ids.shape[0]
    acc = torch.zeros((3, p), dtype=torch.float32, device=pixel_ids.device)
    step = max(1, max_rays // p)
    for s0 in range(0, spp, step):
        n = min(spp, s0 + step) - s0
        sids = torch.arange(s0, s0 + n, device=pixel_ids.device
                            ).repeat_interleave(p)
        rad = trace_rays(sph, cam, s, k, pixel_ids.repeat(n), sids, dtype,
                         counts).float().view(3, n, p)
        for t in range(n):
            acc = acc + rad[:, t]
    return acc


def train_steps(config: dict, device, keys, spp: int, target: Tensor,
                lr: float, block: int, dtype=torch.float32,
                counts: dict | None = None):
    """Adam steps of the reference from the configuration's table, one a
    key of ``keys``, traced in ``dtype``: (each step's loss, the first
    gradient by leaf, each leaf's change over the steps)."""
    sph, cam, s = build(config, device)
    losses, g1, change = train.steps(
        lambda p, k, ids, sids, c: trace_rays(p, cam, s, k, ids, sids, dtype,
                                              c),
        sph, keys, spp, target, lr, block, counts)
    by_leaf = lambda t: {k: t[i].cpu() for i, k in enumerate(LEAVES)}
    return losses, by_leaf(g1), by_leaf(change)


def layer_work(config: dict, rays: float, counts: dict, counted_rays: float,
               train: bool = False) -> dict:
    """The least work of each layer of a frame or step of ``rays`` rays of
    the configuration's scene, from ``counts`` taken over ``counted_rays``
    rays of the same traffic (``trace``'s live pairs and draws, scaled):
    the sample start, the forward bounce loop (recording each winner when
    ``train``), the per-sample sums, and in training the backward."""
    n_spheres = len(config["scene"]["spheres"])
    bounces = config["render"]["max_bounces"]
    scale = rays / counted_rays
    live, draws = counts["live"] * scale, counts["draws"] * scale
    w = {"sample_start": work.sample_start(rays),
         "bounce_loop": work.sphere_bounce_loop(rays, live, draws, n_spheres,
                                                bounces, record=train),
         "sums": work.sums(rays)}
    if train:
        w["backward"] = work.sphere_backward(rays, live, draws, n_spheres,
                                             bounces)
    return w
