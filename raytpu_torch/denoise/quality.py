"""Denoiser quality: PSNR and SSIM against a high-spp target.

Port of ``raytpu/denoise/quality.py``. Render a (low-spp, high-spp) pair
of one frame, score each denoiser's output against the high-spp image.
Both scores are taken after the sqrt tone map, so they weigh errors the
way the written file shows them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from raytpu_torch.core.device import resolve_device


def tonemapped(img: Tensor) -> Tensor:
    """sqrt gamma, clipped to [0, 1]."""
    return torch.sqrt(torch.clamp(img, 0.0, 1.0))


def psnr(img: Tensor, target: Tensor, tonemap: bool = True) -> float:
    """Peak signal-to-noise ratio in dB over the [0, 1] tone-mapped range."""
    a, b = (tonemapped(img), tonemapped(target)) if tonemap else (img, target)
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))


def _gauss_kernel(radius: int = 5, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k2 = np.outer(k, k)
    return (k2 / k2.sum()).astype(np.float32)


def _filter2(img: Tensor, kernel: np.ndarray) -> Tensor:
    """Depthwise 2-D convolution of an (H, W, C) image, zero padding to
    the same size (the kernel is square and odd). It sums in float64 and
    rounds each output once to the image's dtype: ``raytpu``'s f32 XLA
    convolution lands closer to that than an f32 ``conv2d`` does (which
    on the card would also round its inputs to TF32)."""
    c = img.shape[-1]
    k = torch.from_numpy(kernel).to(img.device, torch.float64)
    out = F.conv2d(img.permute(2, 0, 1)[None].double(),
                   k[None, None].expand(c, 1, *k.shape),
                   padding=kernel.shape[0] // 2, groups=c)
    return out[0].permute(1, 2, 0).to(img.dtype)


def ssim(img: Tensor, target: Tensor, tonemap: bool = True) -> float:
    """Mean SSIM (Wang et al. 2004) with the 11x11 Gaussian window
    (sigma 1.5) on the tone-mapped images, averaged over channels."""
    a = tonemapped(img) if tonemap else img
    b = tonemapped(target) if tonemap else target
    k = _gauss_kernel(5, 1.5)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    var_a = _filter2(a * a, k) - mu_a ** 2
    var_b = _filter2(b * b, k) - mu_b ** 2
    cov = _filter2(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))


def render_pair(scene, cam, cfg, key, spp_lo: int, spp_hi: int):
    """(low-spp, high-spp) ``RenderOutput`` of one frame through
    ``render_image``; the target's samples include the low render's."""
    from raytpu_torch.integrator.render import render_image

    lo = render_image(scene, cam, cfg.replace(spp=spp_lo), key)
    hi = render_image(scene, cam, cfg.replace(spp=spp_hi), key)
    return lo, hi


def score_denoisers(lo, hi, denoisers: dict, device=None) -> dict:
    """{name: {"psnr", "ssim"}} of each ``fn(color, albedo, normal)`` on
    the render pair's images, moved to ``device`` (None: the CUDA card),
    with the identity as ``"noisy"``."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    target, color = t(hi.image), t(lo.image)
    out = {"noisy": {"psnr": psnr(color, target),
                     "ssim": ssim(color, target)}}
    with torch.no_grad():
        for name, fn in denoisers.items():
            img = fn(color, t(lo.albedo), t(lo.normal))
            out[name] = {"psnr": psnr(img, target), "ssim": ssim(img, target)}
    return out
