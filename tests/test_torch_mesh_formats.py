"""The port's PLY / STL / glTF importers (``raytpu_torch.io.mesh_formats``)
against ``raytpu.io.mesh_formats``.

Every case writes its files from a numpy seed (the reference's assets are
absent, F1) and requires the port's ``ObjMesh`` arrays to equal
``raytpu``'s exactly: STL ASCII and binary (also a binary file whose
header starts with "solid"), PLY ASCII and binary with and without UVs
(the s/t, u/v and texture_u/texture_v aliases, polygons fan-triangulated),
glTF with a data URI and with a side file, GLB, node transforms. Then
``scenes.write_mesh_twins``' files, and a PLY scene spec and a glTF one
(a 60-triangle block world, water in the glTF's) rendered at 16x12 by
the port's plain versions (K3's per-triangle search, as ``raytpu``'s
scan searches) against ``raytpu``'s ``render_image`` under
``jax.disable_jit`` (F7: compiled, a water refraction takes the other
branch on 1-2% of rays; the sky dome shrunk to radius 100 on both sides,
as ``tests/test_torch_mesh_grad.py`` does), at
``tests/test_torch_render.py``'s tolerance. Cases adapted from
``tests/test_mesh_formats.py``.
"""

import base64
import json
import os
import struct

import jax
import numpy as np
import pytest

from raytpu import config as jconfig
from raytpu.integrator import render as jrender
from raytpu.io import mesh_formats as jmf
from raytpu_torch import config as tconfig
from raytpu_torch.core import rng as trng
from raytpu_torch.integrator import render as trender
from raytpu_torch.io import mesh_formats as tmf
from raytpu_torch.scenes import write_block_world, write_mesh_twins
from tests.test_torch_mesh_grad import _small_dome
from tests.test_torch_render import ATOL, OUTLIER_FRAC, RTOL


def _same(path, parse="parse_mesh"):
    """The port's ObjMesh of ``path`` equal to raytpu's; returns it."""
    got, want = getattr(tmf, parse)(path), getattr(jmf, parse)(path)
    for f in got._fields:
        if f == "mat_names":
            assert got.mat_names == want.mat_names
        else:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    return got


def _tris(seed, n):
    """n random triangles, coordinates in [-2, 2) in f32."""
    return np.random.default_rng(seed).uniform(-2, 2, (n, 3, 3)).astype(
        np.float32)


def _stl_binary(tris, header=b""):
    blob = header.ljust(80, b"\0") + struct.pack("<I", len(tris))
    for t in tris:
        blob += struct.pack("<3f", 0, 0, 1) + t.tobytes() + b"\0\0"
    return blob


def test_stl_ascii(tmp_path):
    tris = _tris(1, 7)
    p = tmp_path / "t.stl"
    p.write_text("solid tri\n" + "".join(
        " facet normal 0 0 1\n  outer loop\n"
        + "".join(f"   vertex {x!r} {y!r} {z!r}\n"
                  for x, y, z in t.tolist())
        + "  endloop\n endfacet\n" for t in tris) + "endsolid tri\n")
    m = _same(str(p), "parse_stl")
    assert m.face_v.shape == (7, 3) and (m.face_mat == -1).all()
    np.testing.assert_array_equal(m.vertices.reshape(-1, 3, 3), tris)


@pytest.mark.parametrize("header", [b"", b"solid but binary"])
def test_stl_binary(tmp_path, header):
    tris = _tris(2, 11)
    p = tmp_path / "b.stl"
    p.write_bytes(_stl_binary(tris, header))
    m = _same(str(p))
    np.testing.assert_array_equal(m.vertices.reshape(-1, 3, 3), tris)
    assert m.mat_names == [] and (m.face_t == -1).all()


def _ply_ascii(verts, faces, uv_names=None, uvs=None):
    props = "".join(f"property float {c}\n" for c in "xyz")
    if uv_names:
        props += "".join(f"property float {c}\n" for c in uv_names)
    rows = [" ".join(repr(float(c)) for c in v)
            + ("" if uvs is None else " " + " ".join(repr(float(c))
                                                     for c in uvs[i]))
            for i, v in enumerate(verts)]
    return ("ply\nformat ascii 1.0\ncomment generated\n"
            f"element vertex {len(verts)}\n{props}"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
            + "\n".join(rows) + "\n"
            + "\n".join(f"{len(f)} " + " ".join(map(str, f)) for f in faces)
            + "\n")


def _polys(seed, n_verts):
    """Faces of 3, 4 and 5 vertices over n_verts vertices."""
    rs = np.random.default_rng(seed)
    return [list(rs.choice(n_verts, k, replace=False)) for k in (3, 4, 5, 3)]


@pytest.mark.parametrize("uv_names", [None, ("s", "t"), ("u", "v"),
                                      ("texture_u", "texture_v")])
def test_ply_ascii(tmp_path, uv_names):
    rs = np.random.default_rng(3)
    verts = rs.uniform(-1, 1, (9, 3)).astype(np.float32)
    uvs = rs.random((9, 2)).astype(np.float32)
    faces = _polys(4, 9)
    p = tmp_path / "a.ply"
    p.write_text(_ply_ascii(verts, faces, uv_names,
                            uvs if uv_names else None))
    m = _same(str(p), "parse_ply")
    assert m.face_v.shape == (1 + 2 + 3 + 1, 3)        # fan-triangulated
    assert (m.face_t >= 0).all() == bool(uv_names)


@pytest.mark.parametrize("with_uv", [False, True])
def test_ply_binary_matches_ascii(tmp_path, with_uv):
    rs = np.random.default_rng(5)
    verts = rs.uniform(-1, 1, (8, 3)).astype(np.float32)
    uvs = rs.random((8, 2)).astype(np.float32)
    faces = _polys(6, 8)
    names = ("s", "t") if with_uv else None
    pa = tmp_path / "a.ply"
    pa.write_text(_ply_ascii(verts, faces, names, uvs if with_uv else None))
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 8\n"
            + "".join(f"property float {c}\n"
                      for c in "xyz" + ("st" if with_uv else ""))
            + f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    rows = np.concatenate([verts, uvs], 1) if with_uv else verts
    blob = head.encode() + rows.astype("<f4").tobytes() + b"".join(
        struct.pack(f"<B{len(f)}i", len(f), *map(int, f)) for f in faces)
    pb = tmp_path / "b.ply"
    pb.write_bytes(blob)
    ma, mb = _same(str(pa)), _same(str(pb))
    for f in ("vertices", "uvs", "face_v", "face_t", "face_mat"):
        np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))


def _gltf(seed):
    """(gltf dict, binary blob): two meshes of random triangles, u16 and
    u32 indices, one with UVs and a material; a parent node with scale,
    rotation and translation and a child with a matrix."""
    rs = np.random.default_rng(seed)
    pos0 = rs.uniform(-1, 1, (6, 3)).astype(np.float32)
    uv0 = rs.random((6, 2)).astype(np.float32)
    idx0 = np.uint16([0, 1, 2, 3, 4, 5, 0, 2, 4])
    pos1 = rs.uniform(-1, 1, (4, 3)).astype(np.float32)
    idx1 = np.uint32([0, 1, 2, 0, 2, 3])
    parts = [pos0, uv0, idx0, pos1, idx1]
    blob, views = b"", []
    for a in parts:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        blob += a.tobytes() + b"\0" * (-a.nbytes % 4)
    acc = lambda v, c, n, t: {"bufferView": v, "componentType": c,
                              "count": n, "type": t}
    q = rs.normal(size=4)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"mesh": 0, "children": [1], "scale": [1.5, 0.5, 2.0],
             "rotation": list(q / np.linalg.norm(q)),
             "translation": [1, 2, 3]},
            {"mesh": 1, "matrix": list(np.eye(4).ravel()
                                       + np.r_[np.zeros(12), 0.5, -1, 2, 0])},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                             "indices": 2, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 3}, "indices": 4}]},
        ],
        "materials": [{"name": "base"}],
        "accessors": [acc(0, 5126, 6, "VEC3"), acc(1, 5126, 6, "VEC2"),
                      acc(2, 5123, 9, "SCALAR"), acc(3, 5126, 4, "VEC3"),
                      acc(4, 5125, 6, "SCALAR")],
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    return gltf, blob


def _glb(gltf, blob) -> bytes:
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    return (struct.pack("<4sII", b"glTF", 2, 28 + len(js) + len(blob))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)


@pytest.mark.parametrize("container", ["data_uri", "side_file", "glb"])
def test_gltf(tmp_path, container):
    gltf, blob = _gltf(7)
    if container == "glb":
        p = tmp_path / "m.glb"
        p.write_bytes(_glb(gltf, blob))
    else:
        if container == "data_uri":
            uri = ("data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode())
        else:
            uri = "m.bin"
            (tmp_path / uri).write_bytes(blob)
        gltf["buffers"][0]["uri"] = uri
        p = tmp_path / "m.gltf"
        p.write_text(json.dumps(gltf))
    m = _same(str(p))
    assert m.face_v.shape == (5, 3) and m.mat_names == ["base"]
    np.testing.assert_array_equal(m.face_mat, [0, 0, 0, -1, -1])
    assert (m.face_t[:3] >= 0).all() and (m.face_t[3:] == -1).all()


def test_parse_mesh_routes_obj(tmp_path):
    o = tmp_path / "t.obj"
    o.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nusemtl a\nf 1/1 2/1 3/1\n")
    assert _same(str(o)).face_v.shape == (1, 3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 60-triangle block world and its PLY / GLB / STL twins."""
    toml = write_block_world(str(tmp_path_factory.mktemp("fmt")), 60, seed=3)
    return toml, write_mesh_twins(toml)


def test_twins_parse_equal_and_load_identical(world):
    """write_mesh_twins' files parse to raytpu's arrays; each format's
    scene equals its OBJ twin's in every tensor and in the config."""
    toml, twins = world
    base = os.path.dirname(toml)
    for fmt, (spec, twin) in twins.items():
        m = _same(os.path.join(base, f"block_world_{fmt}.{fmt}"))
        assert m.face_v.shape == (60, 3)
        assert (m.mat_names != []) == (fmt == "glb")
        a, b = (tconfig.load_scene_file(p, device="cpu") for p in (spec, twin))
        assert a[2] == b[2] and len(a[2].quad_pairs) > 0
        for x, y in zip(_leaves(a[0]), _leaves(b[0])):
            assert x.dtype == y.dtype and (x == y).all()


def _leaves(obj):
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))


def _gltf_side_file(glb_path: str) -> str:
    """The GLB as a .gltf with its binary chunk in a side .bin file."""
    data = open(glb_path, "rb").read()
    (jlen,) = struct.unpack_from("<I", data, 12)
    gltf = json.loads(data[20:20 + jlen])
    (blen,) = struct.unpack_from("<I", data, 20 + jlen)
    stem = os.path.splitext(glb_path)[0]
    with open(stem + ".bin", "wb") as f:
        f.write(data[28 + jlen:28 + jlen + blen])
    gltf["buffers"][0]["uri"] = os.path.basename(stem) + ".bin"
    with open(stem + ".gltf", "w") as f:
        json.dump(gltf, f)
    return stem + ".gltf"


@pytest.mark.parametrize("fmt", ["ply", "gltf"])
def test_scene_spec_renders_like_raytpu(world, fmt):
    toml, twins = world
    base = os.path.dirname(toml)
    spec = twins["ply" if fmt == "ply" else "glb"][0]
    if fmt == "gltf":
        gltf = _gltf_side_file(os.path.join(base, "block_world_glb.glb"))
        text = open(spec).read().replace("block_world_glb.glb",
                                         os.path.basename(gltf))
        spec = os.path.join(base, "block_world_gltf.toml")
        with open(spec, "w") as f:
            f.write(text)
    js, jc, jcfg = jconfig.load_scene_file(spec)
    ts, tc, tcfg = tconfig.load_scene_file(spec, device="cpu")
    assert ts.triangles.count == int(js.triangles.count) == 60
    js, ts = _small_dome(js, ts)
    # raytpu's scan searches triangle by triangle: so does K3 here
    over = dict(width=16, height=12, spp=2, max_bounces=3, merge_quads=False)
    with jax.disable_jit():     # F7: each operation rounded on its own
        want = jrender.render_image(js, jc, jcfg.replace(**over),
                                    jax.random.PRNGKey(11))
    got = trender.render_image(ts, tc, tcfg.replace(use_megakernel=True,
                                                    **over),
                               trng.prng_key(11))
    for name in ("image", "albedo", "normal"):
        x, y = getattr(want, name), getattr(got, name)
        assert np.isfinite(y).all()
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, f"{fmt} {name}: {bad.mean():.2%}"
    assert (got.canvas == want.canvas).all(-1).mean() >= 0.98
