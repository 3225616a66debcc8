"""Built-in sphere scenes, as data.

Port of ``raytpu/scenes.py``: the 10-sphere Cornell scene, the CUDA
binary's variant (HSL boost + AO) and the DoF + AO configuration. Each
function returns (Scene, Camera, RenderConfig) with the scene and camera
tensors on ``device``: the CUDA card when it is ``None``, ``"cpu"`` for
the plain PyTorch path.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.camera import Camera, make_camera
from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.types import Materials, RenderConfig, Scene, Spheres
from raytpu_torch.core.vec3 import Vec3

RED = (1.0, 0.0, 0.0)
GREEN = (0.0, 1.0, 0.0)
BLUE = (0.0, 0.0, 1.0)
WHITE = (1.0, 1.0, 1.0)
BLACK = (0.0, 0.0, 0.0)
SKY = (0.784, 0.965, 1.0)


def spheres_from_rows(rows, device=None) -> Spheres:
    """rows: (center(3), radius, diffuse(3), emission(3), emission_strength,
    reflection, alpha, ior) tuples."""
    device = resolve_device(device)
    col = lambda k: np.array([r[k] for r in rows], np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    vec = lambda a: Vec3(t(a[:, 0]), t(a[:, 1]), t(a[:, 2]))
    return Spheres(
        center=vec(col(0)),
        radius=t(col(1)),
        mat=Materials(
            diffuse=vec(col(2)), emission=vec(col(3)),
            emission_strength=t(col(4)), reflection=t(col(5)),
            alpha=t(col(6)), ior=t(col(7)),
        ),
    )


def cornell_box(device=None) -> tuple[Scene, Camera, RenderConfig]:
    """The 10-sphere Cornell-style scene (BASELINE config 1)."""
    device = resolve_device(device)
    rows = [
        # center,              radius, diffuse, emission, e_str, refl, alpha, ior
        ((-501, 0, 0),   500.0, GREEN, BLACK, 0.0, 0.96, 1.0, 1.0),   # green wall
        ((0, -501, 0),   500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),    # white floor
        ((501, 0, 0),    500.0, RED,   BLACK, 0.0, 0.96, 1.0, 1.0),   # red wall
        ((-0.5, 1.4, -1.2), 0.5, BLACK, (1.0, 0.6, 0.2), 4.0, 0.0, 1.0, 1.0),  # orange light
        ((0.5, 1.4, -2.2), 0.5, BLACK, (0.7, 0.2, 1.0), 4.0, 0.0, 1.0, 1.0),   # violet light
        ((0.6, -1.4, -1.0), 0.5, BLACK, (0.55, 0.863, 1.0), 2.5, 0.0, 1.0, 1.0),
        ((-0.5, -1.4, -3.1), 0.5, BLACK, (0.431, 1.0, 0.596), 2.5, 0.0, 1.0, 1.0),
        ((0, 0, -504),   500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),    # back wall
        ((0, 501, 0),    500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),    # ceiling
        ((0.4, -0.5, -3.3), 0.5, SKY, BLACK, 0.0, 0.99, 1.0, 1.0),    # mirror ball
    ]
    scene = Scene(spheres_from_rows(rows, device))
    cam = make_camera(
        origin=(0.34, 0.3, 0.5), target=(0.0, -0.5, -3.0), up=(0.0, 1.0, 0.0),
        vfov_deg=70.0, aspect_ratio=4.0 / 3.0, device=device,
    )
    cfg = RenderConfig(width=400, height=300, spp=100, max_bounces=5)
    return scene, cam, cfg


def cornell_box_cuda(device=None) -> tuple[Scene, Camera, RenderConfig]:
    """The CUDA binary's default 10-sphere scene with its integrator knobs:
    emissive HSL boost L*=1.2 and AO at intensity 3."""
    device = resolve_device(device)
    rows = [
        ((-501, 0, 0),   500.0, GREEN, BLACK, 0.0, 0.96, 1.0, 1.0),
        ((0, -501, 0),   500.0, WHITE, BLACK, 0.0, 0.4, 1.0, 1.0),
        ((501, 0, 0),    500.0, RED,   BLACK, 0.0, 0.96, 1.0, 1.0),
        ((-0.5, 1.4, -3.0), 0.5, BLACK, (1.0, 0.6, 0.2), 8.0, 0.0, 1.0, 1.0),
        ((0.5, 1.4, -2.0), 0.5, BLACK, (0.7, 0.2, 1.0), 8.0, 0.0, 1.0, 1.0),
        ((-0.5, -1.4, -1.5), 0.5, BLACK, (0.55, 0.863, 1.0), 4.5, 0.0, 1.0, 1.0),
        ((0.5, -1.4, -3.1), 0.5, BLACK, (0.431, 1.0, 0.596), 4.5, 0.0, 1.0, 1.0),
        ((0, 0, -504),   500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 501, 0),    500.0, WHITE, BLACK, 0.0, 0.0, 1.0, 1.0),
        ((-0.4, -0.5, -3.3), 0.5, SKY, BLACK, 0.0, 1.0, 1.0, 1.0),
    ]
    scene = Scene(spheres_from_rows(rows, device))
    cam = make_camera(
        origin=(-0.7, 0.0, 0.0), target=(0.3, -0.5, -3.0), up=(0.0, 1.0, 0.0),
        vfov_deg=70.0, aspect_ratio=4.0 / 3.0, device=device,
    )
    cfg = RenderConfig(
        width=1000, height=750, spp=1000, max_bounces=5,
        hsl_l_factor=1.2, use_ao=True, ao_intensity=3.0,
    )
    return scene, cam, cfg


def cornell_box_dof_ao(device=None) -> tuple[Scene, Camera, RenderConfig]:
    """BASELINE config 2: the Cornell scene + DoF + AO, 800x600, 500 spp."""
    scene, cam, cfg = cornell_box(device)
    cfg = cfg.replace(
        width=800, height=600, spp=500,
        use_ao=True, ao_intensity=2.5,
        aperture_x=0.3, aperture_y=0.3, focus_distance=3.0,
    )
    return scene, cam, cfg


BUILTIN = {
    "cornell": cornell_box,
    "cornell_cuda": cornell_box_cuda,
    "cornell_dof_ao": cornell_box_dof_ao,
}
