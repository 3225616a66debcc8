"""Carry a ``raytpu`` scene and camera across to the port.

The JAX package's ``Scene`` and ``Camera`` are pytrees. A caller flattens
them to a plain dict of numpy arrays keyed by attribute path
(``"spheres.center.x"``, ``"spheres.mat.ior"``, ``"origin.x"``, ...; the
names ``jax.tree_util.keystr(path, simple=True, separator=".")`` gives)
and adds the static ``"sky_sphere_index"``. This module turns such a dict
into the port's ``Scene`` and ``Camera`` on a given device; it imports no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.core.types import Materials, Scene, Spheres
from raytpu_torch.core.vec3 import Vec3


def _getters(arrays: dict, device):
    t = lambda k: torch.tensor(
        np.asarray(arrays[k], np.float32), device=device
    )
    vec = lambda k: Vec3(t(k + ".x"), t(k + ".y"), t(k + ".z"))
    return t, vec


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """Port ``Scene`` from a flattened ``raytpu`` scene.

    Triangles and an equirect sky are recorded, not converted: the sky is
    on exactly when ``raytpu`` turns it on (a sky sphere index and a
    non-empty sky texture, ``trace_spheres._sky_statics``), and the kernel
    gates refuse both.
    """
    t, vec = _getters(arrays, device)
    spheres = Spheres(
        center=vec("spheres.center"),
        radius=t("spheres.radius"),
        mat=Materials(
            diffuse=vec("spheres.mat.diffuse"),
            emission=vec("spheres.mat.emission"),
            emission_strength=t("spheres.mat.emission_strength"),
            reflection=t("spheres.mat.reflection"),
            alpha=t("spheres.mat.alpha"),
            ior=t("spheres.mat.ior"),
        ),
    )
    n_tri = int(np.shape(arrays.get("triangles.mat_id", ()))[0])
    sky_idx = int(arrays.get("sky_sphere_index", -1))
    sky_on = sky_idx >= 0 and np.size(arrays.get("sky.rgb.x", ())) > 0
    return Scene(spheres, n_triangles=n_tri,
                 sky_sphere_index=sky_idx if sky_on else -1)


def camera_from_arrays(arrays: dict, device=None) -> Camera:
    """Port ``Camera`` from a flattened ``raytpu`` camera."""
    _, vec = _getters(arrays, device)
    return Camera(vec("origin"), vec("horizontal"), vec("vertical"),
                  vec("lower_left"))
