"""Carry a ``raytpu`` scene and camera across to the port.

The JAX package's ``Scene`` and ``Camera`` are pytrees. A caller flattens
them to a plain dict of numpy arrays keyed by attribute path
(``"spheres.center.x"``, ``"triangles.mat_id"``, ``"atlas.rgb.x"``,
``"mat_table.ior"``, ``"origin.x"``, ...; the names
``jax.tree_util.keystr(path, simple=True, separator=".")`` gives) and adds
the statics ``"sky_sphere_index"``, ``"atlas.width"``, ``"atlas.height"``
and, for a scene with a sky texture, ``"sky.width"`` and
``"sky.height"``. This module turns such a dict into the port's
``Scene`` and ``Camera`` on a given device (the CUDA card when ``device``
is ``None``); it imports no JAX. The float leaves' paths key the trainer's
parameter dicts (``scene_leaves`` / ``scene_from_leaves``).
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.types import (Materials, MatTable, Scene, SkyTexture,
                                     Spheres, TextureAtlas, Triangles)
from raytpu_torch.core.vec3 import Vec3


SPHERE_LEAVES = tuple(
    "spheres." + k for k in (
        "center.x", "center.y", "center.z", "radius",
        "mat.diffuse.x", "mat.diffuse.y", "mat.diffuse.z",
        "mat.emission.x", "mat.emission.y", "mat.emission.z",
        "mat.emission_strength", "mat.reflection", "mat.alpha", "mat.ior",
    )
)
TRIANGLE_LEAVES = tuple(
    "triangles." + k for k in (
        "a.x", "a.y", "a.z", "b.x", "b.y", "b.z", "c.x", "c.y", "c.z",
        "ua", "va", "ub", "vb", "uc", "vc",
    )
)
ATLAS_LEAVES = ("atlas.rgb.x", "atlas.rgb.y", "atlas.rgb.z", "atlas.alpha")
MAT_TABLE_LEAVES = tuple(
    "mat_table." + k for k in (
        "emission.x", "emission.y", "emission.z", "emission_strength",
        "reflection", "ior", "alpha_const",
    )
)
SKY_LEAVES = ("sky.rgb.x", "sky.rgb.y", "sky.rgb.z")
CAMERA_LEAVES = tuple(f"{v}.{c}" for v in ("origin", "horizontal", "vertical",
                                           "lower_left") for c in "xyz")


def _vec(leaves: dict, k: str) -> Vec3:
    return Vec3(leaves[k + ".x"], leaves[k + ".y"], leaves[k + ".z"])


def scene_leaves(scene: Scene) -> dict:
    """The scene's float tensors keyed by attribute path: ``SPHERE_LEAVES``
    and, where the scene has them, ``TRIANGLE_LEAVES`` and
    ``MAT_TABLE_LEAVES`` (a scene with triangles), ``ATLAS_LEAVES`` (a
    textured one) and ``SKY_LEAVES`` (a sky texture). ``mat_id``, the
    table's two flags and the atlas and sky sizes are not float leaves."""
    s, m = scene.spheres, scene.spheres.mat
    leaves = dict(zip(SPHERE_LEAVES, (
        *s.center, s.radius, *m.diffuse, *m.emission, m.emission_strength,
        m.reflection, m.alpha, m.ior,
    )))
    if scene.n_triangles > 0:
        t, mt = scene.triangles, scene.mat_table
        leaves.update(zip(TRIANGLE_LEAVES, (
            *t.a, *t.b, *t.c, t.ua, t.va, t.ub, t.vb, t.uc, t.vc)))
        leaves.update(zip(MAT_TABLE_LEAVES, (
            *mt.emission, mt.emission_strength, mt.reflection, mt.ior,
            mt.alpha_const)))
    if scene.atlas.alpha.shape[0] > 0:
        leaves.update(zip(ATLAS_LEAVES, (*scene.atlas.rgb, scene.atlas.alpha)))
    if scene.sky.rgb.x.shape[0] > 0:
        leaves.update(zip(SKY_LEAVES, scene.sky.rgb))
    return leaves


def scene_from_leaves(leaves: dict, triangles=None, atlas=None,
                      mat_table=None, sky_sphere_index: int = -1,
                      sky=None) -> Scene:
    """Inverse of ``scene_leaves``: the tensors are used as they are. A
    mesh or sky part whose leaves ``leaves`` holds is rebuilt from them,
    taking its other fields (``mat_id``, the flags, the atlas and sky
    sizes) from the part given here; a part whose leaves it does not hold
    is the part given here as it is, and the parts default to none."""
    if triangles is not None and TRIANGLE_LEAVES[0] in leaves:
        triangles = Triangles(
            *(_vec(leaves, "triangles." + v) for v in "abc"),
            *(leaves["triangles." + k] for k in ("ua", "va", "ub", "vb",
                                                  "uc", "vc")),
            mat_id=triangles.mat_id)
    if mat_table is not None and MAT_TABLE_LEAVES[0] in leaves:
        mat_table = MatTable(
            _vec(leaves, "mat_table.emission"),
            *(leaves["mat_table." + k] for k in (
                "emission_strength", "reflection", "ior", "alpha_const")),
            mat_table.use_alpha_const, mat_table.emission_from_texture)
    if atlas is not None and ATLAS_LEAVES[0] in leaves:
        atlas = TextureAtlas(_vec(leaves, "atlas.rgb"), leaves["atlas.alpha"],
                             atlas.width, atlas.height)
    if sky is not None and SKY_LEAVES[0] in leaves:
        sky = SkyTexture(_vec(leaves, "sky.rgb"), sky.width, sky.height)
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
        triangles, atlas, mat_table, sky_sphere_index, sky,
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


def _mesh_from_arrays(arrays: dict, device):
    """(Triangles, TextureAtlas, MatTable), or Nones for parts the dict
    does not hold (a sphere-only scene)."""
    tris = atlas = table = None
    if np.size(arrays.get("triangles.mat_id", ())) > 0:
        t = _tensors(arrays, TRIANGLE_LEAVES, device)
        tris = Triangles(
            *(_vec(t, "triangles." + v) for v in "abc"),
            *(t["triangles." + k] for k in ("ua", "va", "ub", "vb", "uc", "vc")),
            mat_id=torch.tensor(np.asarray(arrays["triangles.mat_id"],
                                           np.int32), device=device),
        )
    if np.size(arrays.get("atlas.alpha", ())) > 0:
        t = _tensors(arrays, ATLAS_LEAVES, device)
        atlas = TextureAtlas(_vec(t, "atlas.rgb"), t["atlas.alpha"],
                             int(arrays["atlas.width"]),
                             int(arrays["atlas.height"]))
    if "mat_table.ior" in arrays:
        n = np.size(arrays["mat_table.ior"])
        flag = lambda k: arrays.get("mat_table." + k, np.zeros(n, bool))
        table = MatTable.from_arrays(
            np.stack([arrays[f"mat_table.emission.{c}"] for c in "xyz"], -1),
            *(arrays["mat_table." + k] for k in
              ("emission_strength", "reflection", "ior", "alpha_const")),
            flag("use_alpha_const"), flag("emission_from_texture"), device)
    return tris, atlas, table


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """Port ``Scene`` from a flattened ``raytpu`` scene: spheres, the
    triangle mesh, its atlas (``"atlas.width"`` / ``"atlas.height"`` give
    the tile size), material table and equirect sky (``"sky.width"`` /
    ``"sky.height"``; ``raytpu``'s u8-packed ``"sky.packed"`` is not
    read). The sky is kept exactly when ``raytpu`` turns it on (a sky
    sphere index and a non-empty sky texture, ``_sky_statics``); else the
    index is -1 and the texture empty.
    """
    device = resolve_device(device)
    sky_idx = int(arrays.get("sky_sphere_index", -1))
    sky = SkyTexture.empty(device)
    if sky_idx >= 0 and np.size(arrays.get("sky.rgb.x", ())) > 0:
        sky = SkyTexture(_vec(_tensors(arrays, SKY_LEAVES, device), "sky.rgb"),
                         int(arrays["sky.width"]), int(arrays["sky.height"]))
    else:
        sky_idx = -1
    return scene_from_leaves(_tensors(arrays, SPHERE_LEAVES, device),
                             *_mesh_from_arrays(arrays, device),
                             sky_sphere_index=sky_idx, sky=sky)


def camera_from_arrays(arrays: dict, device=None) -> Camera:
    """Port ``Camera`` from a flattened ``raytpu`` camera."""
    return camera_from_leaves(_tensors(arrays, CAMERA_LEAVES, device))
