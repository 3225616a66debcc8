"""Differentiable denoising of rendered images.

Port of ``raytpu/denoise``: the joint-bilateral filter over the color,
albedo and normal AOVs (``bilateral``), the kernel-predicting CNN with
``raytpu``'s trained weights (``learned.denoise_learned``) and the PSNR /
SSIM scores against a high-spp target (``quality``). Each works on
(H, W, 3) linear-float tensors on their own device and is differentiable
by autograd.
"""

from raytpu_torch.denoise.bilateral import DenoiseParams, denoise

__all__ = ["DenoiseParams", "denoise"]
