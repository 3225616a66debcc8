"""The program's side of a sphere configuration: the config file's
spheres, camera and render settings handed to ``raytpu_torch``'s own
constructors, on the run's device, as ``cli render`` sets a scene up."""

from __future__ import annotations

import copy

DIFFUSE = 2   # the diffuse colour's column of a sphere row


def program(config: dict, dev):
    """(scene, camera, RenderConfig) of ``raytpu_torch`` on ``dev``."""
    from raytpu_torch.camera import make_camera
    from raytpu_torch.core.types import RenderConfig, Scene
    from raytpu_torch.scenes import spheres_from_rows

    rows = [(tuple(r[0]), r[1], tuple(r[2]), tuple(r[3]), *r[4:])
            for r in config["scene"]["spheres"]]
    scene = Scene(spheres_from_rows(rows, dev),
                  sky_sphere_index=config["scene"]["sky_sphere_index"])
    cam = make_camera(device=dev, **config["camera"])
    return scene, cam, RenderConfig(**config["render"])


def training_start(config: dict, generator, perturb: float) -> dict:
    """A copy of ``config`` whose diffuse colours are moved by up to
    ``perturb`` (uniform draws of ``generator``, on its device) and
    clamped to [0, 1]."""
    import torch

    rows = config["scene"]["spheres"]
    dev = generator.device
    diffuse = torch.tensor([r[DIFFUSE] for r in rows], dtype=torch.float32,
                           device=dev)
    moved = diffuse + perturb * (
        2.0 * torch.rand(diffuse.shape, generator=generator, device=dev)
        - 1.0)
    start = copy.deepcopy(config)
    for r, d in zip(start["scene"]["spheres"],
                    moved.clamp(0.0, 1.0).cpu().tolist()):
        r[DIFFUSE] = d
    return start
