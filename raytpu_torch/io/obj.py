"""OBJ/MTL mesh loading into the scene's SoA tensors.

Port of ``raytpu/io/obj.py``:
  * ``parse_obj``: list_of_mesh (mesh.h:96-218). Each ``usemtl`` opens a
    new material slot (duplicate names get duplicate slots), faces are
    fan-triangulated, indices are 1-based ``v/t/n``. The C++ parser of
    ``native`` serves it where it builds; the Python parser here is the
    reference it equals (``use_native=False`` or ``RAYTPU_NO_NATIVE=1``).
  * ``parse_mtl``: ``map_Kd`` (relative to the MTL, a leading ``./``
    stripped), ``Kd``, ``Ns`` and ``d`` per ``newmtl``.
  * ``build_atlas``: create_mat_list_mtl (texture.h:175-354). One flat
    atlas of equal-size tiles; a material without a texture gets a solid
    tile of its ``Kd``/``d`` quantized to the u8 lattice; nearest-upscaled
    textures collapse to their true resolution (``collapse_factor``).
  * ``mesh_to_triangles`` / ``load_obj_scene``: the triangle SoA with
    move_mesh's translation (mesh.h:220-234) and the scene.
  * ``load_sky``: the equirect sky texture (create_mat_list on the sky
    file, main.c:374), a PPM or (through PIL) a PNG, without
    ``raytpu``'s u8-packed twin.
Arrays are built in numpy exactly as ``raytpu`` builds them and become
tensors on ``device`` (the CUDA card when ``None``).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from raytpu_torch.core.device import resolve_device
from raytpu_torch.core.types import (MatTable, Scene, SkyTexture, Spheres,
                                     TextureAtlas, Triangles)
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.io.image import load_rgb, load_texture_pair


class ObjMesh(NamedTuple):
    vertices: np.ndarray    # (V, 3) f32
    uvs: np.ndarray         # (VT, 2) f32
    face_v: np.ndarray      # (T, 3) int32, 0-based vertex indices
    face_t: np.ndarray      # (T, 3) int32, 0-based uv indices (-1 = none)
    face_mat: np.ndarray    # (T,) int32 material slot (-1 before any usemtl)
    mat_names: list         # usemtl name per slot (duplicates kept)


def parse_obj(path: str, use_native: bool = True) -> ObjMesh:
    """list_of_mesh's parse (mesh.h:96-218), one pass: by the C++ parser
    (``native.parse_obj_native``) unless ``use_native`` is False or
    ``RAYTPU_NO_NATIVE=1``, or it is unavailable or cannot read the file;
    else by this Python reference, which gives the same arrays."""
    if use_native and os.environ.get("RAYTPU_NO_NATIVE") != "1":
        from raytpu_torch.native import parse_obj_native

        mesh = parse_obj_native(path)
        if mesh is not None:
            return mesh
    vertices, uvs = [], []
    face_v, face_t, face_mat = [], [], []
    mat_names: list = []
    cur_mat = -1   # faces before any usemtl (path_mat_ind, mesh.h:167)
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                vertices.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt"):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("usemtl"):
                mat_names.append(line[6:].strip())
                cur_mat += 1
            elif line.startswith("f "):
                p = line.split()[1:]
                if len(p) < 3:
                    continue
                idx = []
                for tok in p:
                    parts = tok.split("/")
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    idx.append((int(parts[0]) - 1, ti - 1))
                for k in range(1, len(idx) - 1):   # fan triangulation
                    tri = (idx[0], idx[k], idx[k + 1])
                    face_v.append(tuple(t[0] for t in tri))
                    face_t.append(tuple(t[1] for t in tri))
                    face_mat.append(cur_mat)
    return ObjMesh(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        face_v=np.asarray(face_v, np.int32).reshape(-1, 3),
        face_t=np.asarray(face_t, np.int32).reshape(-1, 3),
        face_mat=np.asarray(face_mat, np.int32),
        mat_names=mat_names,
    )


def parse_mtl(mtl_path: str) -> dict:
    """name -> {map_kd, kd, ns, d} (rtutility.h:233-290, plus the CUDA
    fork's Kd/Ns)."""
    mtl_dir = os.path.dirname(mtl_path)
    mats: dict = {}
    cur = None
    with open(mtl_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = {"map_kd": None, "kd": None, "ns": None, "d": None}
                mats[line[7:].strip()] = cur
            elif cur is None:
                continue
            elif parts[0] == "map_Kd":
                tex = line.split(None, 1)[1].strip()
                if tex.startswith("./"):
                    tex = tex[2:]
                cur["map_kd"] = os.path.join(mtl_dir, tex)
            elif parts[0] == "Kd" and len(parts) >= 4:
                cur["kd"] = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif parts[0] == "Ns" and len(parts) >= 2:
                cur["ns"] = float(parts[1])
            elif parts[0] == "d" and len(parts) >= 2:
                cur["d"] = float(parts[1])
    return mats


def collapse_factor(tiles: Sequence[np.ndarray], h: int, w: int) -> int:
    """Largest k dividing h and w such that every tile ((h, w) or
    (h, w, C)) is constant on k x k blocks: the tiles are nearest upscales
    of an (h/k, w/k) original, and collapsing them is exact under the
    nearest fetch (floor(floor(u*w)/k) == floor(u*(w/k)))."""
    k = math.gcd(h, w)
    while k > 1:
        if h % k == 0 and w % k == 0:
            if all((v == v[:, :1, :, :1]).all() for v in
                   (t.reshape(h // k, k, w // k, k, -1) for t in tiles)):
                return k
        k -= 1   # next smaller divisor of gcd(h, w)
        while k > 1 and (h % k or w % k):
            k -= 1
    return 1


def _q8(v) -> float:
    """A solid tile's value on the u8 lattice (n * f32(1/255)), as the
    loaded textures are."""
    return float(np.float32(round(min(max(float(v), 0.0), 1.0) * 255))
                 * np.float32(1.0 / 255.0))


def build_atlas(tex_paths: Sequence[Optional[str]],
                fallback_colors: Optional[Sequence] = None,
                fallback_alphas: Optional[Sequence] = None,
                collapse: bool = True, device=None) -> TextureAtlas:
    """create_mat_list_mtl (texture.h:175-354): one tile per path (a
    ``None`` path gets a solid tile of its fallback colour and alpha, or
    the reference's 0.784 grey, opaque); every texture must share one
    size. ``collapse`` drops nearest-upscaled textures to their true
    resolution."""
    device = resolve_device(device)
    rgbs, alphas = [], []
    pending: list[int] = []   # solid tiles waiting for the common size
    shape = None
    for i, p in enumerate(tex_paths):
        if p is None:
            fc = fallback_colors[i] if fallback_colors else None
            color = tuple(_q8(c) for c in fc) if fc is not None else (_q8(0.784),) * 3
            fa = fallback_alphas[i] if fallback_alphas else None
            a_val = _q8(fa) if fa is not None else 1.0
            if shape is None:
                pending.append(len(rgbs))
                rgbs.append(color)
                alphas.append(a_val)
                continue
            rgb = np.full(shape + (3,), color, np.float32)
            alpha = np.full(shape, a_val, np.float32)
        else:
            rgb, alpha = load_texture_pair(p)
            if shape is None:
                shape = rgb.shape[:2]
                for j in pending:
                    rgbs[j] = np.full(shape + (3,), rgbs[j], np.float32)
                    alphas[j] = np.full(shape, alphas[j], np.float32)
                pending.clear()
            elif rgb.shape[:2] != shape:
                raise ValueError(
                    f"atlas textures must share one size (texture.h:221): "
                    f"{p} is {rgb.shape[:2]}, expected {shape}")
        rgbs.append(rgb)
        alphas.append(alpha)
    if shape is None:   # no textures at all: 1x1 solid tiles
        shape = (1, 1)
        for j in pending:
            rgbs[j] = np.asarray(rgbs[j], np.float32).reshape(1, 1, 3)
            alphas[j] = np.asarray(alphas[j], np.float32).reshape(1, 1)
    h, w = shape
    if collapse and (h > 1 or w > 1):
        k = collapse_factor(rgbs + alphas, h, w)
        if k > 1:
            rgbs = [t[::k, ::k] for t in rgbs]
            alphas = [t[::k, ::k] for t in alphas]
            h, w = h // k, w // k
    rgb_flat = np.concatenate([t.reshape(-1, 3) for t in rgbs], 0)
    alpha_flat = np.concatenate([t.reshape(-1) for t in alphas], 0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    return TextureAtlas(rgb=Vec3(*(t(rgb_flat[:, i]) for i in range(3))),
                        alpha=t(alpha_flat), width=w, height=h)


def mesh_to_triangles(mesh: ObjMesh, translate=(0.0, 0.0, 0.0),
                      device=None) -> Triangles:
    """Triangle SoA (mesh.h:197-207) moved by ``translate``. Faces before
    any ``usemtl`` clamp to slot 0; a missing UV index reads (0, 0)."""
    device = resolve_device(device)
    v = mesh.vertices + np.asarray(translate, np.float32)
    tri_v = v[mesh.face_v]        # (T, 3, 3)
    if mesh.uvs.shape[0] > 0:
        tri_uv = mesh.uvs[np.clip(mesh.face_t, 0, mesh.uvs.shape[0] - 1)]
        tri_uv = np.where(mesh.face_t[..., None] >= 0, tri_uv, 0.0)
    else:
        tri_uv = np.zeros(mesh.face_v.shape + (2,), np.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    vec = lambda i: Vec3(*(t(tri_v[:, i, k]) for k in range(3)))
    return Triangles(
        a=vec(0), b=vec(1), c=vec(2),
        ua=t(tri_uv[:, 0, 0]), va=t(tri_uv[:, 0, 1]),
        ub=t(tri_uv[:, 1, 0]), vb=t(tri_uv[:, 1, 1]),
        uc=t(tri_uv[:, 2, 0]), vc=t(tri_uv[:, 2, 1]),
        mat_id=torch.as_tensor(np.maximum(mesh.face_mat, 0).astype(np.int32),
                               device=device),
    )


def load_obj_scene(obj_path: str, mtl_path: Optional[str] = None,
                   translate=(0.0, 0.0, 0.0),
                   spheres: Optional[Spheres] = None,
                   mat_table: Optional[MatTable] = None,
                   with_textures: bool = True, device=None) -> Scene:
    """OBJ + MTL + textures -> Scene. ``mat_table=None`` uses neutral
    defaults; ``MatTable.reference_overrides`` is texture.h:71-88's."""
    device = resolve_device(device)
    mesh = parse_obj(obj_path)
    tris = mesh_to_triangles(mesh, translate, device)
    if with_textures and mtl_path is not None and mesh.mat_names:
        mtl = parse_mtl(mtl_path)
        entries = [mtl.get(n, {}) for n in mesh.mat_names]
        atlas = build_atlas([e.get("map_kd") for e in entries],
                            [e.get("kd") for e in entries],
                            [e.get("d") for e in entries], device=device)
    else:
        atlas = TextureAtlas.empty(device)
    if mat_table is None:
        mat_table = MatTable.default(max(len(mesh.mat_names), 1), device)
    return Scene(spheres if spheres is not None else Spheres.empty(device),
                 tris, atlas, mat_table)



def load_sky(path: str, device=None) -> SkyTexture:
    """Equirect sky texture from a ``.ppm`` or, through PIL, a PNG (rows
    bottom-up, as ``raytpu``'s ``load_sky`` leaves them), on ``device``."""
    device = resolve_device(device)
    rgb = load_rgb(path)
    h, w = rgb.shape[:2]
    flat = rgb.reshape(-1, 3)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return SkyTexture(rgb=Vec3(*(t(flat[:, i]) for i in range(3))),
                      width=w, height=h)
