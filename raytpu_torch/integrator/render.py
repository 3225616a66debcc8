"""Render orchestration: ray generation, sample accumulation, tiling.

Port of ``raytpu/integrator/render.py``. Each sample starts with
``sample_start``: the per-(pixel, sample) threefry keys, the camera ray
of every pixel from the keys' draws 0-3 (camera jitter and aperture) and
the draw rows the route reads, in one launch of the sample-start kernel
(``csrc/rng.cu``) on the card and by its plain version (the eager stream,
then ``sample_rays``) on the CPU; then the bounce loop traces the rays.
K1 and K3 take the keys and hash their bounce draws themselves, so the
start makes no draw rows for them; the scan path reads every bounce row.
A camera leaf that requires grad gets its gradient through
``camera_rays_vjp``. Which loop follows
``raytpu.render``: with
``cfg.use_megakernel`` the sphere megakernel (K1) where
``trace_spheres.supported`` holds, else the mesh megakernel (K3) where
``trace_scene.supported`` holds; otherwise, and always without
``use_megakernel``, the scan path (``integrator/path.trace``, whose
closest-hit selection is K4 where ``integrator/hit`` turns it on). A
render that asked for a megakernel and is served by the scan path says
why once on stderr; so does one that needs gradients past
``trace_scene_bwd.MAX_BOUNCES`` bounces, where the megakernels' backward
stops and the scan path serves it (ROADMAP P-F14). Sums accumulate in f32 in sample order, as
``raytpu``'s scan does. Pixel coordinates follow the reference: u = (i +
U - .5)/(W-1), v = (j + U - .5)/(H-1) with j counted from the bottom row,
and the aperture jitter is (U - .5) * aperture.

The render runs on the device of the scene's tensors. It is
differentiable in every scene and camera leaf that requires grad: K1 or
K3 then record winner indices and the backward runs K2; the scan path is
differentiated by autograd. Each sample runs under ``checkpoint``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from raytpu_torch import observe
from raytpu_torch.camera import Camera, get_rays
from raytpu_torch.core import rng
from raytpu_torch.core.color import quantize, tonemap
from raytpu_torch.core.types import RenderConfig, Scene, requires_grad
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.hit import log_once
from raytpu_torch.integrator.path import n_bounce_draws, trace
from raytpu_torch.kernels import trace_scene, trace_spheres
from raytpu_torch.kernels.trace_scene_bwd import MAX_BOUNCES


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
    (``rng.sample_stream``, ``rng.ray_uniforms``). The divisors W - 1 and
    H - 1 are 0-dim tensors on the draws' device: a Python number there
    would be a reciprocal multiply on the card (ROADMAP P-F1), an IEEE
    division on the CPU and in the sample-start kernel."""
    full = lambda x: torch.full((), x, dtype=torch.float32, device=draws.device)
    i = (pixel_ids % cfg.width).to(torch.float32)
    j = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(torch.float32)
    u = (i + (draws[0] - 0.5)) / full(cfg.width - 1)
    v = (j + (draws[1] - 0.5)) / full(cfg.height - 1)
    dx = (draws[2] - 0.5) * cfg.aperture_x
    dy = (draws[3] - 0.5) * cfg.aperture_y
    return get_rays(cam, u, v, cfg.focus_distance, dx, dy)


def pack_camera(cam: Camera) -> Tensor:
    """The camera's 12 values, origin, horizontal, vertical, lower_left
    (``convert.CAMERA_LEAVES``' order), as one (12,) f32 tensor on their
    device: what the sample-start kernel reads. Differentiable in the
    camera's leaves; ``render`` packs once a call."""
    return torch.stack([*cam.origin, *cam.horizontal, *cam.vertical,
                        *cam.lower_left]).to(torch.float32)


def unpack_camera(cam: Tensor) -> Camera:
    """``pack_camera``'s inverse: a Camera of 0-dim views of ``cam``."""
    return Camera(*(Vec3(cam[k], cam[k + 1], cam[k + 2])
                    for k in range(0, 12, 3)))


def sample_start_reference(cam: Tensor, cfg: RenderConfig, key: Tensor,
                           pixel_ids: Tensor, s: int, n_rows: int):
    """Plain version of the sample-start kernel, on any device: the eager
    stream (``rng.stream_reference``), then ``sample_rays`` on its rows
    0-3. Returns (ray keys (2, B) int32, origin, direction, draw rows 4 ..
    n_rows-1 as (n_rows - 4, B))."""
    keys, draws = rng.stream_reference(key, pixel_ids, s, n_rows)
    origin, direction = sample_rays(unpack_camera(cam), cfg, pixel_ids,
                                    draws[:4])
    return keys, origin, direction, draws[4:]


def camera_rays_vjp(cam: Tensor, cfg: RenderConfig, pixel_ids: Tensor,
                    draws: Tensor, d_origin: Tensor,
                    d_direction: Tensor) -> Tensor:
    """The cotangent (12,) f32 of the packed camera (``pack_camera``) from
    the cotangents (3, B) of ``sample_rays``' origin and direction, given
    the rays' draws 0-3 (4, B). The rays are recomputed and the adjoint
    reduced over B in float64; with r = dest - origin the unnormalised
    direction (dest = o + f D, D = ll + h u + vv v - o, origin = o +
    jitter): g_r = inv d_dir - inv^3 (d_dir . r) r (the normalisation's
    adjoint; none where n2 < 1e-38, as through the clamp), then
    d_o = sum(d_origin) - f sum(g_r), d_h = f sum(g_r u), d_vv = f
    sum(g_r v), d_ll = f sum(g_r)."""
    f64 = torch.float64
    c = cam.detach().to(f64)
    i = (pixel_ids % cfg.width).to(f64)
    j = torch.div(pixel_ids, cfg.width, rounding_mode="floor").to(f64)
    d = draws.to(f64)
    u = (i + (d[0] - 0.5)) / (cfg.width - 1)
    v = (j + (d[1] - 0.5)) / (cfg.height - 1)
    jit = torch.stack([(d[2] - 0.5) * cfg.aperture_x,
                       (d[3] - 0.5) * cfg.aperture_y, torch.zeros_like(u)])
    o, h, vv, ll = (c[k:k + 3, None] for k in range(0, 12, 3))
    dd = ll + (h * u + (vv * v - o))
    r = (o + dd * cfg.focus_distance) - (o + jit)
    n2 = (r * r).sum(0)
    inv = torch.where(n2 > 0, 1.0 / torch.sqrt(n2.clamp(min=1e-38)), 0.0)
    g_dir = d_direction.to(f64)
    pass_n2 = (n2 >= 1e-38).to(f64)
    g_r = g_dir * inv - r * ((g_dir * r).sum(0) * inv ** 3 * pass_n2)
    f = cfg.focus_distance
    g_sum = g_r.sum(1)
    return torch.cat([d_origin.to(f64).sum(1) - f * g_sum,
                      f * (g_r * u).sum(1), f * (g_r * v).sum(1),
                      f * g_sum]).to(torch.float32)


class _CameraRays(torch.autograd.Function):
    """The sample-start kernel where a camera leaf requires grad: it also
    writes draw rows 0-3, and the backward is ``camera_rays_vjp`` of them.
    Outputs: ray keys (2, B) int32, the (6, B) origin and direction
    planes (differentiable in the packed camera), the draw rows 4 ..
    n_rows-1."""

    @staticmethod
    def forward(ctx, cam, cfg, key, pixel_ids, s, n_rows):
        out = rng.launch_start(key, pixel_ids, cam.detach(), s, cfg.width,
                               cfg.height, (cfg.aperture_x, cfg.aperture_y),
                               cfg.focus_distance, 0, n_rows)
        keys, rows = out[:2].view(torch.int32), out[12:]
        ctx.mark_non_differentiable(keys, rows)
        ctx.save_for_backward(cam, pixel_ids, out[8:12])
        ctx.cfg = cfg
        return keys, out[2:8], rows

    @staticmethod
    def backward(ctx, _keys, d_planes, _rows):
        cam, pixel_ids, draws = ctx.saved_tensors
        d_cam = camera_rays_vjp(cam, ctx.cfg, pixel_ids, draws, d_planes[:3],
                                d_planes[3:])
        return d_cam, None, None, None, None, None


def kernel_start(cam: Tensor, cfg: RenderConfig, key: Tensor,
                 pixel_ids: Tensor, s: int, n_rows: int):
    """``sample_start``'s kernel route (``rng.launch_start``): planes as
    views of the launch's one tensor, no copy."""
    if cam.requires_grad and torch.is_grad_enabled():
        keys, planes, rows = _CameraRays.apply(cam, cfg, key, pixel_ids, s,
                                               n_rows)
    else:
        out = rng.launch_start(key, pixel_ids, cam.detach(), s, cfg.width,
                               cfg.height, (cfg.aperture_x, cfg.aperture_y),
                               cfg.focus_distance, 4, n_rows)
        keys, planes, rows = out[:2].view(torch.int32), out[2:8], out[8:]
    return keys, Vec3(*planes[:3]), Vec3(*planes[3:]), rows


def sample_start(cam: Tensor, cfg: RenderConfig, key: Tensor,
                 pixel_ids: Tensor, s: int, n_rows: int):
    """The start of sample ``s``: (ray keys (2, B) int32, camera ray origin
    and direction (Vec3 of (B,)), draw rows 4 .. n_rows-1 (n_rows - 4, B)).
    cam: ``pack_camera``'s (12,) tensor; key (2,) int64 and pixel_ids (B,)
    int64 on its device. On CUDA tensors one launch of the sample-start
    kernel (``csrc/rng.cu``); on CPU tensors its plain version
    (``sample_start_reference``)."""
    dev = pixel_ids.device
    if dev.type == "cuda":
        return kernel_start(cam, cfg, key, pixel_ids, s, n_rows)
    if dev.type == "cpu":
        return sample_start_reference(cam, cfg, key, pixel_ids, s, n_rows)
    raise NotImplementedError(f"sample start: no kernel for {dev}")


def trace_fn(scene: Scene, cfg: RenderConfig, differentiate: bool = False):
    """The bounce loop ``render`` runs for this scene and config:
    ``trace_spheres.trace_megakernel``, ``trace_scene.trace_mesh_megakernel``
    or ``path.trace`` (see the module docstring). ``differentiate``: the
    render needs gradients; past ``MAX_BOUNCES`` bounces, where the
    megakernels' backward replay stops, the scan path (whose autograd has
    no cap) serves it, as ``raytpu``'s mesh route falls back to its scan
    replay past ``BWD_KERNEL_MAX_BOUNCES``."""
    if cfg.use_megakernel:
        if differentiate and cfg.max_bounces > MAX_BOUNCES:
            log_once(f"gradients of {cfg.max_bounces} bounces: the "
                     f"megakernels' backward stops at {MAX_BOUNCES}; scan "
                     "path serves this render")
            return trace
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
    scene's device, the camera is packed once (``pack_camera``). Per
    sample one ``sample_start`` call, then one
    bounce loop (``trace_fn``): a K1 or K3 call, or the scan path with one
    closest-hit selection per bounce (and one per AO probe). When a scene
    or camera leaf requires grad, the backward recomputes each sample once
    (the checkpoint): the sample start again, and a megakernel then adds a
    recording call and a K2 call per sample, the scan path its selections
    again.

    Spans (``observe.span``), each once a sample: ``render.sample_start``,
    ``render.bounce_loop`` (both again in the checkpoint's recompute) and
    ``render.accumulate`` (the 9 sum adds); on K3's route also
    ``render.frame_selection``, once a call (the selection tables).
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
    differentiate = torch.is_grad_enabled() and requires_grad(scene, cam)
    bounce_loop = trace_fn(scene, cfg, differentiate)
    # K1 and K3 hash their bounce draws from the ray keys; the scan path
    # reads them
    keyed = bounce_loop in (trace_spheres.trace_megakernel,
                            trace_scene.trace_mesh_megakernel)
    if bounce_loop is trace_scene.trace_mesh_megakernel:
        # K3's selection tables depend on the scene alone: built once here
        with observe.span("render.frame_selection"):
            selection = trace_scene.frame_selection(scene, cfg)
        bounce_loop = functools.partial(bounce_loop, selection=selection)
    n_draws = n_bounce_draws(cfg)
    n_rows = 4 if keyed else 4 + cfg.max_bounces * n_draws
    cam_pack = pack_camera(cam).to(dev)

    def one_sample(s):
        with observe.span("render.sample_start"):
            ray_keys, origin, direction, rows = sample_start(
                cam_pack, cfg, key, pixel_ids, s, n_rows)
        src = ray_keys if keyed else rows.view(cfg.max_bounces, n_draws, b)
        with observe.span("render.bounce_loop"):
            r, a, nm = bounce_loop(scene, cfg, origin, direction, src)
        return (*r, *a, *nm)

    # Differentiated, each sample runs under checkpoint (raytpu's
    # jax.checkpoint of mk_direct or scan_sample): its residuals (keys or
    # draws, rays, recorded indices or the scan's intermediates) are
    # dropped after the forward and rebuilt from the base key in the
    # backward, so memory holds one sample's worth, not spp's.
    for s in range(sample_offset, sample_offset + n):
        if differentiate:
            # the draws hang off the keys, not torch's generator: no RNG
            # state to stash for the recompute
            out = checkpoint(one_sample, s, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = one_sample(s)
        with observe.span("render.accumulate"):
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


@functools.lru_cache(maxsize=16)
def tiled_pixel_order(width: int, height: int, tile: int) -> np.ndarray:
    """``blocked_pixel_order`` of a width x height frame, padded to whole
    tiles of ``tile`` ids by repeating the last id; built once per
    (width, height, tile) and read-only."""
    n_pix = width * height
    n_tiles = (n_pix + tile - 1) // tile
    ids = np.pad(blocked_pixel_order(RenderConfig(width=width, height=height)),
                 (0, n_tiles * tile - n_pix), mode="edge")
    ids.setflags(write=False)
    return ids


@functools.lru_cache(maxsize=16)
def tiled_pixel_order_on(width: int, height: int, tile: int,
                         device: torch.device) -> Tensor:
    """``tiled_pixel_order`` as int64 on ``device``, copied there once."""
    ids = tiled_pixel_order(width, height, tile).astype(np.int64)
    return torch.from_numpy(ids).to(device)


class RenderOutput(NamedTuple):
    image: np.ndarray      # (H, W, 3) linear float mean radiance, row 0 = top
    canvas: np.ndarray     # (H, W, 3) quantized 0..255 ints
    albedo: np.ndarray     # (H, W, 3) AOV mean
    normal: np.ndarray     # (H, W, 3) AOV mean


@torch.no_grad()
def render_image(scene: Scene, cam: Camera, cfg: RenderConfig,
                 key: Tensor) -> RenderOutput:
    """Full frame: tiles of ``cfg.pixel_tile`` pixel ids in block-major
    order (``tiled_pixel_order_on``, made once), each rendered with all
    ``cfg.spp`` samples. The last tile is padded by repeating the last id;
    its duplicates are rendered and not scattered. Not differentiated: the
    frame leaves as numpy arrays.

    The sums stay on the scene's device: each tile's nine planes are
    written by pixel id into one (3, n_pixels, 3) f32 frame buffer of
    radiance, albedo and normal, and the buffer comes to the host once,
    into page-locked memory on CUDA (PyTorch's caching host allocator),
    used as it is on the CPU.

    Spans (``observe.span``): ``render_image`` the frame; in it, a tile's
    ``render_image.scatter`` (its sums into the frame buffer by pixel id,
    two launches), the frame's ``render_image.fetch`` (the buffer to the
    host, waiting for the frame's queued kernels), then
    ``render_image.assemble``."""
    with observe.span("render_image"):
        dev = scene.device
        n_pix = cfg.n_pixels
        tile = min(cfg.pixel_tile, n_pix)
        all_ids = tiled_pixel_order_on(cfg.width, cfg.height, tile, dev)
        frame = torch.empty((3, n_pix, 3), dtype=torch.float32, device=dev)
        for t in range(0, all_ids.shape[0], tile):
            ids = all_ids[t:t + tile]
            sums = render(scene, cam, cfg, ids, key)
            with observe.span("render_image.scatter"):
                m = min(tile, n_pix - t)
                planes = torch.stack([*sums.radiance, *sums.albedo,
                                      *sums.normal], dim=1)
                frame.index_copy_(1, ids[:m],
                                  planes[:m].view(m, 3, 3).transpose(0, 1))
        with observe.span("render_image.fetch"):
            if dev.type != "cpu":
                frame = torch.empty(frame.shape, dtype=frame.dtype,
                                    pin_memory=dev.type == "cuda"
                                    ).copy_(frame)
            rad, alb, nrm = frame.numpy()
        with observe.span("render_image.assemble"):
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
