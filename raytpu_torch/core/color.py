"""Color utilities: HSL boost, gamma tone map, quantization.

Port of ``raytpu/core/color.py`` with the same branchless forms, so the
emissive HSL boost, the sqrt tone map and the truncating quantizer give
the JAX package's values.
"""

from __future__ import annotations

import torch
from torch import Tensor

from raytpu_torch.core.vec3 import Vec3


def _safe(x: Tensor, eps: float = 1e-30) -> Tensor:
    return torch.where(torch.abs(x) > eps, x, eps)


def rgb_to_hsl(rgb: Vec3) -> Vec3:
    """Vectorized rgb_to_hsl; ties pick r, then g, then b. Returns (h, s, l)."""
    r, g, b = rgb.x, rgb.y, rgb.z
    cmax = torch.maximum(r, torch.maximum(g, b))
    cmin = torch.minimum(r, torch.minimum(g, b))
    l = (cmax + cmin) * 0.5
    d = cmax - cmin
    gray = cmax == cmin
    denom_lo = cmax + cmin
    denom_hi = 2.0 - cmax - cmin
    s = torch.where(
        gray, 0.0,
        torch.where(l < 0.5, d / _safe(denom_lo), d / _safe(denom_hi)),
    )
    d_safe = _safe(d)
    h_r = (g - b) / d_safe + torch.where(g < b, 6.0, 0.0)
    h_g = (b - r) / d_safe + 2.0
    h_b = (r - g) / d_safe + 4.0
    h = torch.where(cmax == r, h_r, torch.where(cmax == g, h_g, h_b))
    h = torch.where(gray, 0.0, h / 6.0)
    return Vec3(h, s, l)


def _hue_to_rgb(t1: Tensor, t2: Tensor, hue: Tensor) -> Tensor:
    hue = torch.where(hue < 0.0, hue + 1.0, hue)
    hue = torch.where(hue > 1.0, hue - 1.0, hue)
    r1 = t1 + (t2 - t1) * 6.0 * hue
    r3 = t1 + (t2 - t1) * ((2.0 / 3.0) - hue) * 6.0
    return torch.where(
        6.0 * hue < 1.0, r1,
        torch.where(2.0 * hue < 1.0, t2, torch.where(3.0 * hue < 2.0, r3, t1)),
    )


def hsl_to_rgb(hsl: Vec3) -> Vec3:
    h, s, l = hsl.x, hsl.y, hsl.z
    t2 = torch.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    t1 = 2.0 * l - t2
    r = _hue_to_rgb(t1, t2, h + 1.0 / 3.0)
    g = _hue_to_rgb(t1, t2, h)
    b = _hue_to_rgb(t1, t2, h - 1.0 / 3.0)
    gray = s == 0.0
    return Vec3(
        torch.where(gray, l, r), torch.where(gray, l, g), torch.where(gray, l, b)
    )


def hsl_boost(rgb: Vec3, l_factor: float = 1.0, s_factor: float = 1.0) -> Vec3:
    """Emissive boost through HSL space. With both factors at 1.0 the
    round trip (the identity up to f32 rounding) is skipped, as in
    ``raytpu``."""
    if l_factor == 1.0 and s_factor == 1.0:
        return rgb
    hsl = rgb_to_hsl(rgb)
    return hsl_to_rgb(Vec3(hsl.x, hsl.y * s_factor, hsl.z * l_factor))


def tonemap(mean_radiance: Vec3) -> Vec3:
    """sqrt gamma, then clamp to [0, 0.999], on the mean radiance."""
    g = Vec3(*(torch.sqrt(torch.clamp(c, min=0.0)) for c in mean_radiance))
    return g.clamp(0.0, 0.999)


def quantize(toned: Vec3) -> Vec3:
    """[0, 1) -> {0..255} as floats, truncating like ``(int)(256 * c)``."""
    return Vec3(*(torch.floor(256.0 * c) for c in toned))
