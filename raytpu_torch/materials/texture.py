"""Texture lookup and material resolution for triangle hits, and the
equirect sky.

Port of ``raytpu/materials/texture.py`` (``wrap_uv``, the nearest
``atlas_fetch``, ``atlas_fetch_bilinear`` and ``triangle_material``,
tri_uvmapping in texture.h:44-89; ``sky_texel_index`` and
``sky_emission``, sphere_uvmapping in texture.h:92-112; the procedural
``checker_value``, texture.h:8-14): barycentric UVs
with the fmod wrap, the nearest texel of the flat atlas (index y*W + x +
W*H*mat_id) or the bilinear blend of four, and the per-material-id table.
An index outside the atlas or the table reads zeros, as ``raytpu``'s mesh
kernel (K3) does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from raytpu_torch.core.types import Materials, MatTable, SkyTexture, TextureAtlas
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.geometry.triangle import barycentric
from raytpu_torch.kernels.gather import GatherIndex, gather

UNTEXTURED_RGB = (0.784, 0.965, 1.0)   # mesh.h:207's default material
PI32 = float(np.float32(math.pi))   # jnp.pi as it meets an f32 array
TWO_PI32 = 2.0 * PI32               # f32(2 pi), exactly twice f32(pi)


def wrap_uv(u: Tensor) -> Tensor:
    """fmod wrap to [0, 1) with the negative correction (texture.h:53-60)."""
    u = torch.fmod(u, 1.0)
    return torch.where(u < 0.0, u + 1.0, u)


def _take(planes, idx: Tensor) -> list[Tensor]:
    """plane[idx] for each of ``planes`` (all of one length), and zero
    (False for a bool plane) where idx is outside them: one
    ``kernels.gather.gather`` at one index, whose backward sorts the index
    once and sums each row's cotangents in a fixed order."""
    planes = list(planes)
    n = planes[0].shape[0]
    ok = (idx >= 0) & (idx < n)
    got = gather(GatherIndex(torch.where(ok, idx, 0), n), planes)
    return [torch.where(ok, g, False if g.dtype == torch.bool else 0.0)
            for g in got]


def atlas_fetch(atlas: TextureAtlas, mat_id: Tensor, u: Tensor,
                v: Tensor) -> tuple[Vec3, Tensor]:
    """Nearest texel (texture.h:61-69): (rgb, alpha) per ray. x and y are
    clamped for u or v that round to 1.0."""
    w, h = atlas.width, atlas.height
    x = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    idx = (y * w + x) + (h * w) * mat_id.to(torch.int64)
    r, g, b, alpha = _take((*atlas.rgb, atlas.alpha), idx)
    return Vec3(r, g, b), alpha


def atlas_fetch_bilinear(atlas: TextureAtlas, mat_id: Tensor, u: Tensor,
                         v: Tensor) -> tuple[Vec3, Tensor]:
    """Bilinear colour with wrap addressing; alpha stays nearest (an
    interpolated alpha at a cutout edge would fall into the refraction
    window). Not a reference behaviour: the differentiable mode
    (``cfg.bilinear_textures``), in which colour is continuous in the UVs
    and so the hit point, which gives vertex and camera gradients."""
    w, h = atlas.width, atlas.height
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    base = (h * w) * mat_id.to(torch.int64)
    c00, c10, c01, c11 = (
        Vec3(*_take(atlas.rgb, base + yi * w + xi))
        for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)))
    rgb = (c00 * ((1 - tx) * (1 - ty)) + c10 * (tx * (1 - ty))
           + c01 * ((1 - tx) * ty) + c11 * (tx * ty))
    return rgb, atlas_fetch(atlas, mat_id, u, v)[1]


def triangle_material(tri_a: Vec3, tri_b: Vec3, tri_c: Vec3,
                      uv_a: tuple, uv_b: tuple, uv_c: tuple, normal: Vec3,
                      hit_point: Vec3, mat_id: Tensor, atlas: TextureAtlas,
                      table: MatTable, bilinear: bool = False) -> Materials:
    """tri_uvmapping for per-ray winning triangles (all (B,)); ``bilinear``
    selects ``atlas_fetch_bilinear``."""
    w_a, w_b, w_c = barycentric(tri_a, tri_b, tri_c, normal, hit_point)
    u = wrap_uv(w_a * uv_a[0] + w_b * uv_b[0] + w_c * uv_c[0])
    v = wrap_uv(w_a * uv_a[1] + w_b * uv_b[1] + w_c * uv_c[1])
    if atlas.count > 0:
        fetch = atlas_fetch_bilinear if bilinear else atlas_fetch
        rgb, tex_alpha = fetch(atlas, mat_id, u, v)
    else:
        full = lambda c: torch.full_like(u, c)
        rgb, tex_alpha = Vec3(*map(full, UNTEXTURED_RGB)), full(1.0)
    (*em, eft, use_const, estr, refl, alpha_c, ior) = _take(
        (*table.emission, table.emission_from_texture, table.use_alpha_const,
         table.emission_strength, table.reflection, table.alpha_const,
         table.ior), mat_id.to(torch.int64))
    return Materials(
        diffuse=rgb,
        emission=Vec3(*(torch.where(eft, e * t, e) for e, t in zip(em, rgb))),
        emission_strength=estr,
        reflection=refl,
        alpha=torch.where(use_const, alpha_c, tex_alpha),
        ior=ior,
    )


def checker_value(c1: Vec3, c2: Vec3, scale, p: Vec3) -> Vec3:
    """Procedural checker: ``c1`` where the parity of floor(p / scale)
    summed over x, y and z is even, else ``c2``. Unused by the shipped
    scenes. ``scale`` divides as a 0-dim tensor on p's device (a Python
    number would be a reciprocal multiply on the card)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=p.x.device)
    x, y, z = (torch.floor(c / s).to(torch.int32) for c in p)
    return Vec3.where((x + y + z) % 2 == 0, c1, c2)


def sky_texel_index(d: Vec3, w: int, h: int) -> Tensor:
    """Equirect direction -> flat texel index (sphere_uvmapping,
    texture.h:92-112): theta = acos(-d.y), phi = atan2(-d.z, d.x) + pi,
    u = phi / 2pi, v = theta / pi, nearest texel, int64.

    The port's one copy of the UV chain: the scan path (``sky_emission``)
    and both megakernels' composition outside the kernel
    (``trace_spheres.compose_sky``) call it, so their texel indices agree
    bit for bit on one device. ``raytpu``'s op order in f32: the
    negations (a -0.0 from ``-d.z`` sends atan2 to -pi and the texel to
    column 0, a +0.0 to +pi and column w - 1), the clip, ``+ pi``, the two
    divisions, floor, clip.

    The divisors are 0-dim tensors on the direction's device, not Python
    floats: ATen's CUDA division by a CPU scalar multiplies by its
    reciprocal, which can floor to a neighbouring texel, while a tensor
    divisor gives the correctly rounded quotient on the card as on the
    CPU. ``torch.full`` fills them on the device: a ``torch.tensor`` of a
    Python float would be a host-to-device copy, which waits for the
    card."""
    full = lambda c: torch.full((), c, dtype=torch.float32, device=d.x.device)
    theta = torch.acos(torch.clamp(-d.y, -1.0, 1.0))
    phi = torch.atan2(-d.z, d.x) + PI32
    u = phi / full(TWO_PI32)
    v = theta / full(PI32)
    x = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return y * w + x


def sky_emission(sky: SkyTexture, hit_point: Vec3, center: Vec3,
                 radius: Tensor) -> Vec3:
    """The sky texel seen at a hit on the sky sphere: d = (p - c) / r,
    ``sky_texel_index``, then one ``kernels.gather.gather`` of the three
    channels."""
    d = Vec3(*((p - c) / radius for p, c in zip(hit_point, center)))
    idx = sky_texel_index(d, sky.width, sky.height)
    return Vec3(*gather(GatherIndex(idx, sky.rgb.x.shape[0]), sky.rgb))
