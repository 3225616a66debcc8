"""Differentiable-rendering train step.

Port of ``raytpu/train/inverse.py`` without sharding (its ``mesh=None``
path). One step renders the frame (``integrator.render``: with
``use_megakernel`` K1 or, for a mesh scene, K3 records each bounce's
winner and the backward replays it in K2; otherwise autograd through the
scan path), takes the L2 photometric loss of the mean radiance against a
target, pulls gradients back to every float scene leaf (spheres and,
where the scene has them, triangles, atlas, material table and sky
texels; and with ``train_camera`` the camera) and applies one Adam
update.

Parameters are plain dicts of leaf tensors keyed by attribute path
(``"spheres.center.x"``, ``"triangles.a.y"``, ``"atlas.rgb.x"``,
``"mat_table.ior"``, ``"sky.rgb.x"``, ``"origin.x"``, ...; the names of
``convert``). They live on the scene's device: the CUDA card when the
scene was built with the default ``device``.

As in ``raytpu``, radiance is piecewise constant in geometry (sphere
centres and radii, triangle vertices, camera pose) under nearest-texel
fetch: those gradients are zero almost everywhere, and colours, texels,
emission and emission strength carry the signal. With
``bilinear_textures`` the vertices get gradients too; from one sample a
pixel they are noisy, and Adam moves every leaf by about the learning
rate whatever its gradient's size.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from raytpu_torch import observe
from raytpu_torch.camera import Camera
from raytpu_torch.convert import (camera_from_leaves, camera_leaves,
                                  scene_from_leaves, scene_leaves)
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.render import render

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def partition_scene(scene: Scene) -> tuple[dict, dict]:
    """(params, static): params maps every float leaf's path to its
    tensor (``convert.scene_leaves``: ``raytpu``'s float leaves, the sky
    texels ``sky.rgb.*`` among them when the scene has a sky texture);
    static holds the mesh parts, whose ``mat_id``, flags and atlas size
    stay fixed, the sky texture, whose width and height stay fixed, and
    the sky sphere index. Recombine with ``combine_scene``.

    The sky texels reach the loss only with ``cfg.sky_texture_grads``
    (``raytpu``'s stop_gradient otherwise); without it their gradient is
    zero (``make_train_step``)."""
    static = {"triangles": scene.triangles, "atlas": scene.atlas,
              "mat_table": scene.mat_table, "sky": scene.sky,
              "sky_sphere_index": scene.sky_sphere_index}
    return scene_leaves(scene), static


def combine_scene(params: dict, static: dict) -> Scene:
    """The scene of ``params`` (used as they are, so gradients reach them)."""
    return scene_from_leaves(params, **static)


def photometric_loss(mean_rad: Vec3, target: Tensor) -> Tensor:
    """L2 in linear radiance between the rendered mean and a (B, 3)
    target batch."""
    diff = mean_rad.to_array() - target
    return torch.mean(diff * diff)


class TrainState(NamedTuple):
    params: dict                  # scene leaves, requiring grad
    cam_params: Optional[dict]    # camera leaves, or None when frozen
    optimizer: torch.optim.Optimizer


def make_train_step(cfg: RenderConfig, lr: float, train_camera: bool = False):
    """Build (init_fn, step_fn).

    ``init_fn(scene, cam) -> (state, static)`` copies the scene's (and
    with ``train_camera`` the camera's) leaves into fresh tensors that
    require grad, on the scene's device, under ``torch.optim.Adam(lr)``
    with optax's defaults.

    ``step_fn(state, static, cam, pixel_ids, target, key) -> (state,
    loss)`` renders ``pixel_ids`` with ``cfg.spp`` samples, takes the loss
    against ``target`` (B, 3), and updates the parameters in place; the
    returned loss is the one before the update, as in ``raytpu``.

    Spans (``observe.span``): ``train.step`` the call; in it
    ``train.forward`` (the scene, the render and the loss),
    ``train.backward`` (autograd, the checkpoint's recompute, the
    backward kernels) and ``train.adam`` (zero gradients for the leaves
    the loss missed, then Adam's update).
    """

    def init_fn(scene: Scene, cam: Camera):
        params, static = partition_scene(scene)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        cam_params = None
        if train_camera:
            cam_params = {k: v.detach().clone().requires_grad_()
                          for k, v in camera_leaves(cam).items()}
        leaves = [*params.values(), *(cam_params or {}).values()]
        opt = torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        return TrainState(params, cam_params, opt), static

    def step_fn(state: TrainState, static: dict, cam: Camera, pixel_ids,
                target, key: Tensor):
        with observe.span("train.step"):
            with observe.span("train.forward"):
                scene = combine_scene(state.params, static)
                dev = scene.device
                if train_camera:
                    cam = camera_from_leaves(state.cam_params)
                target = torch.as_tensor(target, dtype=torch.float32,
                                         device=dev)
                state.optimizer.zero_grad(set_to_none=True)
                sums = render(scene, cam, cfg, pixel_ids, key)
                loss = photometric_loss(sums.radiance * (1.0 / cfg.spp),
                                        target)
            with observe.span("train.backward"):
                loss.backward()
            with observe.span("train.adam"):
                # a leaf the loss does not reach gets a zero gradient, as
                # from jax.grad, so that Adam still decays its moments as
                # optax does (torch.optim skips a parameter whose grad is
                # None)
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                state.optimizer.step()
            return state, loss.detach()

    return init_fn, step_fn
