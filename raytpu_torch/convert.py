"""Carry a ``raytpu`` scene and camera across to the port.

The JAX package's ``Scene`` and ``Camera`` are pytrees. A caller flattens
them to a plain dict of numpy arrays keyed by attribute path
(``"spheres.center.x"``, ``"spheres.mat.ior"``, ``"origin.x"``, ...; the
names ``jax.tree_util.keystr(path, simple=True, separator=".")`` gives)
and adds the static ``"sky_sphere_index"``. This module turns such a dict
into the port's ``Scene`` and ``Camera`` on a given device (the CUDA card
when ``device`` is ``None``); it imports no JAX. The same paths key the
trainer's parameter dicts (``scene_leaves`` / ``scene_from_leaves``).
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.types import Materials, Scene, Spheres
from raytpu_torch.core.vec3 import Vec3


SPHERE_LEAVES = tuple(
    "spheres." + k for k in (
        "center.x", "center.y", "center.z", "radius",
        "mat.diffuse.x", "mat.diffuse.y", "mat.diffuse.z",
        "mat.emission.x", "mat.emission.y", "mat.emission.z",
        "mat.emission_strength", "mat.reflection", "mat.alpha", "mat.ior",
    )
)
CAMERA_LEAVES = tuple(f"{v}.{c}" for v in ("origin", "horizontal", "vertical",
                                           "lower_left") for c in "xyz")


def _vec(leaves: dict, k: str) -> Vec3:
    return Vec3(leaves[k + ".x"], leaves[k + ".y"], leaves[k + ".z"])


def scene_leaves(scene: Scene) -> dict:
    """The scene's float tensors keyed by attribute path (``SPHERE_LEAVES``)."""
    s, m = scene.spheres, scene.spheres.mat
    return dict(zip(SPHERE_LEAVES, (
        *s.center, s.radius, *m.diffuse, *m.emission, m.emission_strength,
        m.reflection, m.alpha, m.ior,
    )))


def scene_from_leaves(leaves: dict, n_triangles: int = 0,
                      sky_sphere_index: int = -1) -> Scene:
    """Inverse of ``scene_leaves``: the tensors are used as they are."""
    return Scene(
        Spheres(
            center=_vec(leaves, "spheres.center"),
            radius=leaves["spheres.radius"],
            mat=Materials(
                diffuse=_vec(leaves, "spheres.mat.diffuse"),
                emission=_vec(leaves, "spheres.mat.emission"),
                emission_strength=leaves["spheres.mat.emission_strength"],
                reflection=leaves["spheres.mat.reflection"],
                alpha=leaves["spheres.mat.alpha"],
                ior=leaves["spheres.mat.ior"],
            ),
        ),
        n_triangles=n_triangles, sky_sphere_index=sky_sphere_index,
    )


def camera_leaves(cam: Camera) -> dict:
    """The camera's 0-d tensors keyed by attribute path (``CAMERA_LEAVES``)."""
    return dict(zip(CAMERA_LEAVES, (*cam.origin, *cam.horizontal,
                                    *cam.vertical, *cam.lower_left)))


def camera_from_leaves(leaves: dict) -> Camera:
    """Inverse of ``camera_leaves``."""
    return Camera(*(_vec(leaves, k) for k in
                    ("origin", "horizontal", "vertical", "lower_left")))


def _tensors(arrays: dict, keys, device) -> dict:
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
            for k in keys}


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """Port ``Scene`` from a flattened ``raytpu`` scene.

    Triangles and an equirect sky are recorded, not converted: the sky is
    on exactly when ``raytpu`` turns it on (a sky sphere index and a
    non-empty sky texture, ``trace_spheres._sky_statics``), and the kernel
    gates refuse both.
    """
    n_tri = int(np.shape(arrays.get("triangles.mat_id", ()))[0])
    sky_idx = int(arrays.get("sky_sphere_index", -1))
    sky_on = sky_idx >= 0 and np.size(arrays.get("sky.rgb.x", ())) > 0
    return scene_from_leaves(_tensors(arrays, SPHERE_LEAVES, device),
                             n_triangles=n_tri,
                             sky_sphere_index=sky_idx if sky_on else -1)


def camera_from_arrays(arrays: dict, device=None) -> Camera:
    """Port ``Camera`` from a flattened ``raytpu`` camera."""
    return camera_from_leaves(_tensors(arrays, CAMERA_LEAVES, device))
