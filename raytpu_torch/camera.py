"""Look-at camera with viewport-corner parameterization and DoF.

Port of ``raytpu/camera.py``: an orthonormal (u, v, w) basis from
origin/target/up, a viewport of height 2*tan(vfov/2), and the lower-left
corner ``origin - horizontal/2 - vertical/2 - w``. The DoF jitter moves
the ray origin along world x/y (not the camera plane), the reference
renderer's quirk, kept so renders match.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.vec3 import Vec3


@dataclass(frozen=True)
class Camera:
    origin: Vec3        # Vec3 of 0-d tensors
    horizontal: Vec3
    vertical: Vec3
    lower_left: Vec3


def make_camera(origin, target, up, vfov_deg, aspect_ratio,
                device=None) -> Camera:
    """init_camera, in f32 like ``raytpu.camera.make_camera``, on
    ``device`` (the CUDA card when ``None``)."""
    device = resolve_device(device)
    origin, target, up = (Vec3.create(*c, device=device)
                          for c in (origin, target, up))
    theta = torch.tensor(vfov_deg, dtype=torch.float32, device=device) * (
        math.pi / 180.0
    )
    viewport_h = 2.0 * torch.tan(theta / 2.0)
    viewport_w = aspect_ratio * viewport_h

    w = (origin - target).normalize()
    u = up.cross(w).normalize()
    v = w.cross(u)

    horizontal = u * viewport_w
    vertical = v * viewport_h
    lower_left = origin - (horizontal * 0.5 + (vertical * 0.5 + w))
    return Camera(origin, horizontal, vertical, lower_left)


def get_rays(cam: Camera, u: Tensor, v: Tensor, focus_distance,
             dx_aperture: Tensor, dy_aperture: Tensor) -> tuple[Vec3, Vec3]:
    """Vectorized get_ray. u, v: (B,) jittered viewport coordinates;
    dx/dy_aperture: (B,) world-space origin jitter. Returns (origin, dir)."""
    direction = cam.lower_left + (
        cam.horizontal * u + (cam.vertical * v - cam.origin)
    )
    destination = cam.origin + direction * focus_distance
    new_origin = cam.origin + Vec3(
        dx_aperture, dy_aperture, torch.zeros_like(dx_aperture)
    )
    return new_origin, (destination - new_origin).normalize()
