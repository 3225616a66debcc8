"""TOML scene specs: the reference's compile-time literals as data.

Port of ``raytpu/config.py`` (``load_scene_file``, ``load_scene``):

    [render]      width/height/spp/bounces/ao/ao_intensity/aperture/focus
    [camera]      origin/target/up/vfov
    [[spheres]]   center/radius/diffuse/emission/...
    [mesh]        obj/mtl/translate/textures/mtl_physics
                  + [[mesh.materials]] per-id overrides
    [[meshes]]    several meshes, concatenated
    [sky]         file (an equirect P3 PPM), sphere_index (default: the
                  last sphere, "derniere sphere = ciel")
    morton        top-level flag (default true)
    merge_quads   top-level flag (default true): detect the coplanar
                  triangle pairs for K3's merged-quad search

Paths resolve relative to the TOML file. The scene is built on ``device``
(the CUDA card when ``None``). Triangles are Morton-ordered as
``raytpu``'s are. Not ported yet: meshes other than ``.obj``
(``raytpu.io.mesh_formats``) raise ``NotImplementedError``. With
``merge_quads`` on (the default) and more than one triangle, the loader
detects the quad pairs (``geometry/quads``) and carries them on the
config (``quad_pairs``, ``quad_aa_rects``, ``quad_aa_tris``), as
``raytpu`` does; ``cfg.replace(merge_quads=False)`` after the load turns
the merged search off again.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib

import numpy as np
import torch

from raytpu_torch.camera import Camera, make_camera
from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.types import (MatTable, RenderConfig, Scene,
                                     SkyTexture, Spheres, TextureAtlas,
                                     Triangles)
from raytpu_torch.core.vec3 import Vec3


def _spheres_from_spec(rows: list[dict], device) -> Spheres:
    from raytpu_torch.scenes import spheres_from_rows

    return spheres_from_rows([
        (tuple(r["center"]), float(r["radius"]),
         tuple(r.get("diffuse", (0.0, 0.0, 0.0))),
         tuple(r.get("emission", (0.0, 0.0, 0.0))),
         float(r.get("emission_strength", 0.0)),
         float(r.get("reflection", 0.0)), float(r.get("alpha", 1.0)),
         float(r.get("ior", 1.0)))
        for r in rows
    ], device)


def _mat_table_from_spec(n: int, overrides: list[dict], device) -> MatTable:
    """[[mesh.materials]] entries {id, emission, emission_strength,
    reflection, ior, alpha, emission_from_texture}; ``alpha`` present
    forces that constant alpha for the id."""
    em = np.zeros((n, 3), np.float32)
    es, rf = np.zeros(n, np.float32), np.zeros(n, np.float32)
    io, ac = np.ones(n, np.float32), np.ones(n, np.float32)
    ua, eft = np.zeros(n, bool), np.zeros(n, bool)
    for o in overrides:
        i = int(o["id"])
        if not 0 <= i < n:
            raise ValueError(f"material override id {i} out of range [0,{n})")
        em[i] = np.asarray(o.get("emission", em[i]), np.float32)
        es[i] = float(o.get("emission_strength", es[i]))
        rf[i] = float(o.get("reflection", rf[i]))
        io[i] = float(o.get("ior", io[i]))
        if "alpha" in o:
            ac[i] = float(o["alpha"])
            ua[i] = True
        eft[i] = bool(o.get("emission_from_texture", False))
    return MatTable.from_arrays(em, es, rf, io, ac, ua, eft, device)


def _parse_mesh(path: str):
    from raytpu_torch.io.obj import parse_obj

    if not path.lower().endswith(".obj"):
        raise NotImplementedError(
            f"{path}: raytpu_torch reads .obj meshes only (raytpu's "
            ".ply/.stl/.gltf importers are not ported yet)")
    return parse_obj(path)


def _load_mesh(m: dict, base: str, device, single: bool):
    """One [mesh] (``single``) or [[meshes]] entry -> (Triangles, the MTL
    entry of each atlas tile, MatTable, slot count). A [[meshes]] entry
    gives every slot a tile; a single [mesh] gets tiles only with a MTL
    (else it renders untextured)."""
    from raytpu_torch.io.obj import mesh_to_triangles, parse_mtl

    mesh = _parse_mesh(os.path.join(base, m["obj"]))
    tris = mesh_to_triangles(mesh, tuple(m.get("translate", (0.0, 0.0, 0.0))),
                             device)
    n_mat = max(len(mesh.mat_names), 1)
    textured = m.get("textures", True) and "mtl" in m
    mtl = parse_mtl(os.path.join(base, m["mtl"])) if textured else {}
    entries = [mtl.get(n, {}) for n in mesh.mat_names]
    if not single:
        entries = (entries or [{}]) + [{}] * (n_mat - max(len(entries), 1))
    elif not textured:
        entries = []
    table = _mat_table_from_spec(n_mat, m.get("materials", []), device)
    if single and m.get("mtl_physics", False) and "mtl" in m and mesh.mat_names:
        # the CUDA fork's reflectionStrength = shininess / 100
        # (triangle.hu:118-124), where the spec sets no reflection
        mtl = parse_mtl(os.path.join(base, m["mtl"]))
        ns = np.array([(mtl.get(n, {}).get("ns") or 0.0) / 100.0
                       for n in mesh.mat_names], np.float32)
        explicit = {int(o["id"]) for o in m.get("materials", [])
                    if "reflection" in o}
        keep = torch.as_tensor([i in explicit for i in range(n_mat)],
                               device=device)
        table = dataclasses.replace(table, reflection=torch.where(
            keep, table.reflection, torch.as_tensor(ns[:n_mat], device=device)))
    return tris, entries, table, n_mat


def _cat(parts: list, cls):
    """Concatenate dataclasses of tensors / Vec3s field by field."""
    def cat(vals):
        if isinstance(vals[0], Vec3):
            return Vec3(*(torch.cat(c) for c in zip(*vals)))
        return torch.cat(vals)
    return cls(**{f: cat([getattr(p, f) for p in parts])
                  for f in cls.__dataclass_fields__})


def load_scene_file(path: str, device=None) -> tuple[Scene, Camera, RenderConfig]:
    """Parse a TOML scene spec into (Scene, Camera, RenderConfig)."""
    from raytpu_torch.io.obj import build_atlas

    device = resolve_device(device)
    with open(path, "rb") as f:
        spec = tomllib.load(f)
    base = os.path.dirname(os.path.abspath(path))

    r = spec.get("render", {})
    cfg = RenderConfig(
        width=int(r.get("width", 400)), height=int(r.get("height", 300)),
        spp=int(r.get("spp", 100)), max_bounces=int(r.get("bounces", 5)),
        use_ao=bool(r.get("ao", False)),
        ao_intensity=float(r.get("ao_intensity", 2.5)),
        focus_distance=float(r.get("focus_distance", 3.0)),
        aperture_x=float(r.get("aperture_x", 0.0)),
        aperture_y=float(r.get("aperture_y", 0.0)),
        bilinear_textures=bool(r.get("bilinear_textures", False)),
        merge_quads=bool(spec.get("merge_quads", True)),
    )
    c = spec.get("camera", {})
    cam = make_camera(
        origin=tuple(c.get("origin", (0.0, 0.0, 0.0))),
        target=tuple(c.get("target", (0.0, 0.0, -1.0))),
        up=tuple(c.get("up", (0.0, 1.0, 0.0))),
        vfov_deg=float(c.get("vfov", 70.0)),
        aspect_ratio=cfg.width / cfg.height, device=device,
    )
    spheres = (_spheres_from_spec(spec["spheres"], device)
               if "spheres" in spec else Spheres.empty(device))

    triangles = Triangles.empty(device)
    atlas = TextureAtlas.empty(device)
    mat_table = MatTable.default(1, device)
    meshes = spec.get("meshes", [spec["mesh"]] if "mesh" in spec else [])
    if meshes:
        tri_parts, table_parts, entries = [], [], []
        offset = 0
        for m in meshes:
            tris, ents, table, n_mat = _load_mesh(m, base, device,
                                                  "meshes" not in spec)
            tri_parts.append(dataclasses.replace(tris,
                                                 mat_id=tris.mat_id + offset))
            table_parts.append(table)
            entries += ents
            offset += n_mat
        triangles = _cat(tri_parts, Triangles)
        mat_table = _cat(table_parts, MatTable)
        if entries:
            # nearest fetch: collapsing is exact; bilinear would not be
            atlas = build_atlas([e.get("map_kd") for e in entries],
                                [e.get("kd") for e in entries],
                                [e.get("d") for e in entries],
                                collapse=not cfg.bilinear_textures,
                                device=device)
    if triangles.count > 1 and bool(spec.get("morton", True)):
        from raytpu_torch.geometry.morton import morton_order

        triangles = morton_order(triangles)
    sky, sky_index = SkyTexture.empty(device), -1
    if "sky" in spec:
        sky, sky_index = _load_sky(spec["sky"], base, spheres, path, device)
    if triangles.count > 1 and cfg.merge_quads:
        from raytpu_torch.geometry.quads import (classify_axis_aligned,
                                                 detect_quad_pairs)

        coords = (*triangles.a, *triangles.b, *triangles.c)
        pairs = detect_quad_pairs(*coords)
        aa_rects, aa_tris = classify_axis_aligned(*coords, pairs)
        cfg = cfg.replace(quad_pairs=pairs, quad_aa_rects=aa_rects,
                          quad_aa_tris=aa_tris)
    return (Scene(spheres, triangles, atlas, mat_table, sky_index, sky), cam,
            cfg)


def _load_sky(table: dict, base: str, spheres: Spheres, path: str, device):
    """The [sky] table -> (SkyTexture, sky sphere index). The sky sphere
    must be a pure emitter with black diffuse (the reference's convention,
    main.c:331/347): under it the first sky event ends the ray's sky
    contribution, which is what makes the megakernels' single sky slot
    exact."""
    from raytpu_torch.io.obj import load_sky

    sky = load_sky(os.path.join(base, table["file"]), device)
    index = int(table.get("sphere_index", spheres.count - 1))
    if any(abs(float(c[index])) > 0.0 for c in spheres.mat.diffuse):
        raise ValueError(
            f"{path}: the [sky] sphere (index {index}) must have black "
            "diffuse (the reference's pure-emitter sky convention; "
            "required for the megakernel fast path)")
    return sky, index


def load_scene(name_or_path: str, device=None) -> tuple[Scene, Camera, RenderConfig]:
    """A built-in scene name or a path to a .toml spec."""
    from raytpu_torch.scenes import BUILTIN

    if name_or_path in BUILTIN:
        return BUILTIN[name_or_path](device=device)
    if os.path.exists(name_or_path):
        return load_scene_file(name_or_path, device)
    raise ValueError(f"unknown scene {name_or_path!r}; built-ins: "
                     f"{sorted(BUILTIN)} or a path to a .toml scene spec")
