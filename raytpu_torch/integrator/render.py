"""Render orchestration: ray generation, sample accumulation, tiling.

Port of ``raytpu/integrator/render.py``. For each sample index the
per-(pixel, sample) threefry keys give the camera jitter and every
bounce's draws (``rng.sample_stream``: one RNG kernel launch a sample on
the card, the eager stream on the CPU), the camera makes one ray per
pixel, and the bounce loop traces them. K1 takes the keys and hashes its
bounce draws itself, so the stream makes only the 4 camera rows for it;
K3 and the scan path read every row. Which loop follows ``raytpu.render``: with
``cfg.use_megakernel`` the sphere megakernel (K1) where
``trace_spheres.supported`` holds, else the mesh megakernel (K3) where
``trace_scene.supported`` holds; otherwise, and always without
``use_megakernel``, the scan path (``integrator/path.trace``, whose
closest-hit selection is K4 where ``integrator/hit`` turns it on). A
render that asked for a megakernel and is served by the scan path says
why once on stderr. Sums accumulate in f32 in sample order, as
``raytpu``'s scan does. Pixel coordinates follow the reference: u = (i +
U - .5)/(W-1), v = (j + U - .5)/(H-1) with j counted from the bottom row,
and the aperture jitter is (U - .5) * aperture.

The render runs on the device of the scene's tensors. It is
differentiable in every scene and camera leaf that requires grad: K1 or
K3 then record winner indices and the backward runs K2; the scan path is
differentiated by autograd. Each sample runs under ``checkpoint``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from raytpu_torch.camera import Camera, get_rays
from raytpu_torch.core import rng
from raytpu_torch.core.color import quantize, tonemap
from raytpu_torch.core.types import RenderConfig, Scene, requires_grad
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.hit import log_once
from raytpu_torch.integrator.path import n_bounce_draws, trace
from raytpu_torch.kernels import trace_scene, trace_spheres


class RenderSums(NamedTuple):
    """Per-pixel sample sums (not means) and the sample count."""

    radiance: Vec3
    albedo: Vec3
    normal: Vec3
    samples: int


def sample_rays(cam: Camera, cfg: RenderConfig, pixel_ids: Tensor,
                draws: Tensor) -> tuple[Vec3, Vec3]:
    """One camera ray per pixel id for one sample index.
    draws: (4, B) U(0,1) camera draws, rows 0-3 of a ray key's draws
    (``rng.sample_stream``, ``rng.ray_uniforms``)."""
    i = (pixel_ids % cfg.width).to(torch.float32)
    j = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(torch.float32)
    u = (i + (draws[0] - 0.5)) / (cfg.width - 1)
    v = (j + (draws[1] - 0.5)) / (cfg.height - 1)
    dx = (draws[2] - 0.5) * cfg.aperture_x
    dy = (draws[3] - 0.5) * cfg.aperture_y
    return get_rays(cam, u, v, cfg.focus_distance, dx, dy)


def trace_fn(scene: Scene, cfg: RenderConfig):
    """The bounce loop ``render`` runs for this scene and config:
    ``trace_spheres.trace_megakernel``, ``trace_scene.trace_mesh_megakernel``
    or ``path.trace`` (see the module docstring)."""
    if cfg.use_megakernel:
        if trace_spheres.supported(scene, cfg):
            return trace_spheres.trace_megakernel
        if trace_scene.supported(scene, cfg):
            return trace_scene.trace_mesh_megakernel
        mod = trace_scene if scene.n_triangles else trace_spheres
        log_once(f"megakernel unavailable ("
                 f"{', '.join(mod.unsupported_reasons(scene, cfg))}); scan "
                 "path serves this render")
    return trace


def render(scene: Scene, cam: Camera, cfg: RenderConfig, pixel_ids,
           key: Tensor, sample_offset: int = 0,
           n_samples: Optional[int] = None,
           init: Optional[RenderSums] = None) -> RenderSums:
    """Accumulate ``n_samples`` samples (sample indices ``sample_offset``
    ... ``sample_offset + n - 1``) for a batch of pixel ids.

    ``pixel_ids`` and ``key`` (a ``rng.prng_key``) are placed on the
    scene's device. Per sample one ``rng.sample_stream`` call, then one
    bounce loop (``trace_fn``): a K1 or K3 call, or the scan path with one
    closest-hit selection per bounce (and one per AO probe). When a scene
    or camera leaf requires grad, the backward recomputes each sample once
    (the checkpoint): the stream again, and a megakernel then adds a
    recording call and a K2 call per sample, the scan path its selections
    again.
    """
    dev = scene.device
    n = cfg.spp if n_samples is None else n_samples
    pixel_ids = torch.as_tensor(pixel_ids, device=dev).to(torch.int64)
    key = key.to(device=dev, dtype=torch.int64).contiguous()
    b = pixel_ids.shape[0]
    if init is None:
        zeros = Vec3.zeros((b,), device=dev)
        init = RenderSums(zeros, zeros, zeros, 0)
    rad, alb, nrm, count = init
    bounce_loop = trace_fn(scene, cfg)
    # K1 hashes its bounce draws from the ray keys; the others read them
    keyed = bounce_loop is trace_spheres.trace_megakernel
    n_draws = n_bounce_draws(cfg)
    n_rows = 4 if keyed else 4 + cfg.max_bounces * n_draws

    def one_sample(s):
        ray_keys, draws = rng.sample_stream(key, pixel_ids, s, n_rows)
        origin, direction = sample_rays(cam, cfg, pixel_ids, draws[:4])
        src = ray_keys if keyed else draws[4:].view(cfg.max_bounces,
                                                    n_draws, b)
        r, a, nm = bounce_loop(scene, cfg, origin, direction, src)
        return (*r, *a, *nm)

    # Differentiated, each sample runs under checkpoint (raytpu's
    # jax.checkpoint of mk_direct or scan_sample): its residuals (keys or
    # draws, rays, recorded indices or the scan's intermediates) are
    # dropped after the forward and rebuilt from the base key in the
    # backward, so memory holds one sample's worth, not spp's.
    differentiate = torch.is_grad_enabled() and requires_grad(scene, cam)
    for s in range(sample_offset, sample_offset + n):
        if differentiate:
            # the draws hang off the keys, not torch's generator: no RNG
            # state to stash for the recompute
            out = checkpoint(one_sample, s, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = one_sample(s)
        rad = rad + Vec3(*out[0:3])
        alb = alb + Vec3(*out[3:6])
        nrm = nrm + Vec3(*out[6:9])
        count += 1
    return RenderSums(rad, alb, nrm, count)


def blocked_pixel_order(cfg: RenderConfig, block_w: int = 128,
                        block_h: int = 64) -> np.ndarray:
    """Pixel ids in screen-block-major order (128x64 blocks, row-major
    inside each block). Keys hang off the pixel id, so the order does not
    change any pixel's value."""
    w, h = cfg.width, cfg.height
    ids = np.arange(w * h, dtype=np.int32).reshape(h, w)
    return np.concatenate([
        ids[y0:y0 + block_h, x0:x0 + block_w].ravel()
        for y0 in range(0, h, block_h)
        for x0 in range(0, w, block_w)
    ])


class RenderOutput(NamedTuple):
    image: np.ndarray      # (H, W, 3) linear float mean radiance, row 0 = top
    canvas: np.ndarray     # (H, W, 3) quantized 0..255 ints
    albedo: np.ndarray     # (H, W, 3) AOV mean
    normal: np.ndarray     # (H, W, 3) AOV mean


@torch.no_grad()
def render_image(scene: Scene, cam: Camera, cfg: RenderConfig,
                 key: Tensor) -> RenderOutput:
    """Full frame: tiles of ``cfg.pixel_tile`` pixel ids in block-major
    order, each rendered with all ``cfg.spp`` samples. The last tile is
    padded by repeating the last id; its duplicates compute identical
    sums, so scattering back by id is idempotent. Not differentiated: the
    frame leaves as numpy arrays."""
    n_pix = cfg.n_pixels
    tile = min(cfg.pixel_tile, n_pix)
    n_tiles = (n_pix + tile - 1) // tile
    all_ids = np.pad(blocked_pixel_order(cfg), (0, n_tiles * tile - n_pix),
                     mode="edge")
    rad = np.zeros((n_pix, 3), np.float32)
    alb = np.zeros((n_pix, 3), np.float32)
    nrm = np.zeros((n_pix, 3), np.float32)
    for t in range(n_tiles):
        ids = all_ids[t * tile:(t + 1) * tile]
        sums = render(scene, cam, cfg, ids, key)
        rad[ids] = sums.radiance.to_array().cpu().numpy()
        alb[ids] = sums.albedo.to_array().cpu().numpy()
        nrm[ids] = sums.normal.to_array().cpu().numpy()
    return assemble_image(cfg, rad, alb, nrm)


def assemble_image(cfg: RenderConfig, rad_sums: np.ndarray,
                   alb_sums: np.ndarray, nrm_sums: np.ndarray,
                   spp: Optional[int] = None) -> RenderOutput:
    """Means, tone map, quantize; flips rows so row 0 is the top."""
    spp = spp if spp is not None else cfg.spp
    h, w = cfg.height, cfg.width
    mean_rad = rad_sums.reshape(h, w, 3) / spp
    mean_alb = alb_sums.reshape(h, w, 3) / spp
    mean_nrm = nrm_sums.reshape(h, w, 3) / spp
    toned = tonemap(Vec3.from_array(torch.from_numpy(mean_rad)))
    canvas = quantize(toned).to_array().numpy()
    flip = lambda a: a[::-1]   # bottom-up rows -> top-down image
    return RenderOutput(
        image=flip(mean_rad),
        canvas=flip(canvas).astype(np.int32),
        albedo=flip(mean_alb),
        normal=flip(mean_nrm),
    )
