"""Joint-bilateral denoiser guided by the albedo and normal AOVs.

Port of ``raytpu/denoise/bilateral.py``. For every pixel p the filtered
color is a normalised weighted sum over a (2r+1)^2 window:

    w(p, q) = exp(-|q-p|^2         / 2 sigma_s^2)   spatial
            * exp(-|alb_q-alb_p|^2 / 2 sigma_a^2)   albedo edge-stop
            * exp(-|n_q-n_p|^2     / 2 sigma_n^2)   normal edge-stop
            * exp(-|c_q-c_p|^2     / 2 sigma_c^2)   range (color) term

with the four terms summed in one exponent. The window is a Python loop
over shifted images (``torch.roll``, which shifts as ``jnp.roll`` does,
with the texels that wrap around masked to weight 0, ``taps``), taps in
``raytpu``'s dy, dx order. Plain PyTorch, differentiable by autograd in the images and
the sigmas: ``raytpu``'s filter is ``jnp`` with no Pallas kernel, so there
is no kernel to port. On a CUDA device it is ~25 eager kernels a tap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import Tensor

from raytpu_torch.core.device import resolve_device


@dataclass(frozen=True)
class DenoiseParams:
    """The four sigmas as 0-dim f32 tensors (they may require grad) and
    the window's static radius."""

    sigma_spatial: Tensor
    sigma_albedo: Tensor
    sigma_normal: Tensor
    sigma_color: Tensor
    radius: int = 3

    @staticmethod
    def default(sigma_spatial: float = 2.0, sigma_albedo: float = 0.2,
                sigma_normal: float = 0.3, sigma_color: float = 0.6,
                radius: int = 3, device=None) -> "DenoiseParams":
        """``raytpu``'s defaults; ``device=None`` is the CUDA card."""
        dev = resolve_device(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        return DenoiseParams(f(sigma_spatial), f(sigma_albedo),
                             f(sigma_normal), f(sigma_color), radius)


def taps(img: Tensor, radius: int):
    """The (2r+1)^2 window's taps in ``raytpu``'s order: (dy, dx, valid)
    with ``valid`` the (H, W, 1) mask of ``img``'s dtype that is 0 where
    ``torch.roll(img, (dy, dx), (0, 1))`` wrapped a texel around. The row
    and column tests are made once a call and a tap's mask is their
    product."""
    h, w = img.shape[:2]
    rows = torch.arange(h, device=img.device)[:, None, None]
    cols = torch.arange(w, device=img.device)[None, :, None]
    span = range(-radius, radius + 1)
    col_ok = [((cols - dx >= 0) & (cols - dx < w)).to(img.dtype)
              for dx in span]
    for dy in span:
        row_ok = ((rows - dy >= 0) & (rows - dy < h)).to(img.dtype)
        for dx, ok in zip(span, col_ok):
            yield dy, dx, row_ok * ok


def denoise(color: Tensor, albedo: Tensor, normal: Tensor,
            params: Optional[DenoiseParams] = None) -> Tensor:
    """Filters an (H, W, 3) linear-float color image with its (H, W, 3)
    AOVs, on their device. ``params=None`` takes ``DenoiseParams.default``."""
    p = params if params is not None else DenoiseParams.default(
        device=color.device)
    r = p.radius
    half = torch.full((), 0.5, dtype=color.dtype, device=color.device)
    # an IEEE division, as jnp's 0.5 / x (a Python-number numerator would
    # be a reciprocal, then a multiply)
    inv2 = lambda s: half / torch.clamp(s * s, min=1e-12)
    ks, ka, kn, kc = (inv2(p.sigma_spatial), inv2(p.sigma_albedo),
                      inv2(p.sigma_normal), inv2(p.sigma_color))

    num = torch.zeros_like(color)
    den = torch.zeros(color.shape[:2] + (1,), dtype=color.dtype,
                      device=color.device)
    for dy, dx, valid in taps(color, r):
        c_q = torch.roll(color, (dy, dx), (0, 1))
        a_q = torch.roll(albedo, (dy, dx), (0, 1))
        n_q = torch.roll(normal, (dy, dx), (0, 1))
        d_a = ((a_q - albedo) ** 2).sum(-1, keepdim=True)
        d_n = ((n_q - normal) ** 2).sum(-1, keepdim=True)
        d_c = ((c_q - color) ** 2).sum(-1, keepdim=True)
        d_s = float(dy * dy + dx * dx)
        w = valid * torch.exp(-(d_s * ks + d_a * ka + d_n * kn + d_c * kc))
        num = num + w * c_q
        den = den + w
    # den >= 1 (the centre tap has weight 1); guarded all the same
    return num / torch.clamp(den, min=1e-8)
