"""PLY / STL / glTF mesh import, as ``raytpu.io.mesh_formats``.

Port of ``raytpu/io/mesh_formats.py`` (pure Python and numpy; the
reference's CUDA binary reads these formats through assimp,
triangle.hu:61-167):

  * STL: ASCII ("solid ... facet normal ... vertex x y z") and binary
    (80-byte header + u32 count + 50-byte records); a binary file whose
    header starts with "solid" is tried as ASCII first. STL has no UVs
    or materials: faces get material slot -1, like OBJ faces before any
    ``usemtl``.
  * PLY: ASCII and binary_little_endian 1.0; the vertex element's x/y/z
    (+ s/t, u/v or texture_u/texture_v when present) and the face
    element's vertex_indices list, fan-triangulated like the OBJ parser
    (``io/obj.py``); material slot -1.
  * glTF 2.0 (``.gltf`` with data URIs or side files, ``.glb``):
    triangle primitives' positions under the default scene's node
    transforms, TEXCOORD_0, and each primitive's material index as its
    slot (-1 without one).

Each returns the port's ``io.obj.ObjMesh``, with arrays equal to
``raytpu``'s, so a scene spec's ``obj =`` may name any of these files
(``config`` routes by extension through ``parse_mesh``).
"""

from __future__ import annotations

import struct

import numpy as np

from raytpu_torch.io.obj import ObjMesh


def parse_mesh(path: str) -> ObjMesh:
    """Extension-routed mesh import: .ply, .stl, .gltf/.glb, and any other
    suffix through the OBJ parser (native or Python, ``io.obj.parse_obj``)."""
    lower = path.lower()
    if lower.endswith(".ply"):
        return parse_ply(path)
    if lower.endswith(".stl"):
        return parse_stl(path)
    if lower.endswith((".gltf", ".glb")):
        return parse_gltf(path)
    from raytpu_torch.io.obj import parse_obj

    return parse_obj(path)


def _mesh(vertices, uvs, face_v, face_t, face_mat, mat_names) -> ObjMesh:
    return ObjMesh(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        face_v=np.asarray(face_v, np.int32).reshape(-1, 3),
        face_t=np.asarray(face_t, np.int32).reshape(-1, 3),
        face_mat=np.asarray(face_mat, np.int32),
        mat_names=mat_names,
    )


# ---------------------------------------------------------------------------
# STL
# ---------------------------------------------------------------------------
def parse_stl(path: str) -> ObjMesh:
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        try:
            return _parse_stl_ascii(path)
        except ValueError:
            pass  # some binary STLs start with "solid" — fall through
    return _parse_stl_binary(path)


def _parse_stl_ascii(path: str) -> ObjMesh:
    verts: list = []
    with open(path, errors="replace") as f:
        saw_facet = False
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "facet":
                saw_facet = True
            elif t[0] == "vertex":
                verts.append((float(t[1]), float(t[2]), float(t[3])))
    if not saw_facet or len(verts) % 3:
        raise ValueError(f"{path}: not a valid ASCII STL")
    n_tri = len(verts) // 3
    face_v = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    return _mesh(
        verts, np.zeros((0, 2)), face_v,
        np.full((n_tri, 3), -1, np.int32),
        np.full(n_tri, -1, np.int32), [],
    )


def _parse_stl_binary(path: str) -> ObjMesh:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 84:
        raise ValueError(f"{path}: truncated binary STL")
    (n_tri,) = struct.unpack_from("<I", data, 80)
    want = 84 + 50 * n_tri
    if len(data) < want:
        raise ValueError(
            f"{path}: binary STL claims {n_tri} triangles "
            f"({want} bytes) but has {len(data)}"
        )
    rec = np.frombuffer(
        data, dtype=np.uint8, count=50 * n_tri, offset=84
    ).reshape(n_tri, 50)
    tris = (
        rec[:, 12:48].copy().view(np.float32).reshape(n_tri, 3, 3)
    )  # skip the normal (12 bytes); ignore attribute bytes
    face_v = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    return _mesh(
        tris.reshape(-1, 3), np.zeros((0, 2)), face_v,
        np.full((n_tri, 3), -1, np.int32),
        np.full(n_tri, -1, np.int32), [],
    )


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------
_PLY_SIZES = {
    "char": "b", "int8": "b", "uchar": "B", "uint8": "B",
    "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
    "int": "i", "int32": "i", "uint": "I", "uint32": "I",
    "float": "f", "float32": "f", "double": "d", "float64": "d",
}
_UV_NAMES = {"s": 0, "t": 1, "u": 0, "v": 1, "texture_u": 0, "texture_v": 1}


def parse_ply(path: str) -> ObjMesh:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: missing 'ply' magic")
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: no end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[data.index(b"\n", end) + 1 :]

    fmt = None
    elements: list = []  # (name, count, [(prop, type, list_count_type)])
    for line in header[1:]:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append((t[4], t[3], t[2]))
            else:
                elements[-1][2].append((t[2], t[1], None))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")

    verts, uvs, faces = [], [], []
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            for _ in range(count):
                row = {}
                for pname, ptype, list_type in props:
                    if list_type is not None:
                        n = int(tokens[pos]); pos += 1
                        row[pname] = [
                            int(tokens[pos + k]) for k in range(n)
                        ]
                        pos += n
                    else:
                        row[pname] = float(tokens[pos]); pos += 1
                _ply_row(name, row, verts, uvs, faces)
    else:
        pos = 0
        for name, count, props in elements:
            for _ in range(count):
                row = {}
                for pname, ptype, list_type in props:
                    if list_type is not None:
                        cfmt = "<" + _PLY_SIZES[list_type]
                        (n,) = struct.unpack_from(cfmt, body, pos)
                        pos += struct.calcsize(cfmt)
                        ifmt = "<" + _PLY_SIZES[ptype] * n
                        row[pname] = list(struct.unpack_from(ifmt, body, pos))
                        pos += struct.calcsize(ifmt)
                    else:
                        vfmt = "<" + _PLY_SIZES[ptype]
                        (val,) = struct.unpack_from(vfmt, body, pos)
                        pos += struct.calcsize(vfmt)
                        row[pname] = float(val)
                _ply_row(name, row, verts, uvs, faces)

    face_v, face_t = [], []
    has_uv = len(uvs) == len(verts) and len(uvs) > 0
    for poly in faces:
        for k in range(1, len(poly) - 1):  # fan-triangulate like io/obj.py
            tri = (poly[0], poly[k], poly[k + 1])
            face_v.append(tri)
            face_t.append(tri if has_uv else (-1, -1, -1))
    n_tri = len(face_v)
    return _mesh(
        verts, uvs if has_uv else np.zeros((0, 2)), face_v, face_t,
        np.full(n_tri, -1, np.int32), [],
    )


# ---------------------------------------------------------------------------
# glTF 2.0 (minimal: triangles + TEXCOORD_0, .gltf JSON and .glb binary)
# ---------------------------------------------------------------------------
# Scope (raytpu's, COMPONENTS.md 2.21): assimp's glTF surface as the
# reference's CUDA loader would expose it — triangulated positions, one
# UV set, per-primitive material slot, node TRS/matrix transforms on the
# default scene. Animations, skins, morphs, and texture/material payloads
# are out of scope (the pipeline's materials come from scene specs /
# MatTable, matching how triangle.hu:61-167 only reads diffuse+shininess).
_GLTF_COMPONENT = {
    5120: ("b", 1), 5121: ("B", 1), 5122: ("h", 2),
    5123: ("H", 2), 5125: ("I", 4), 5126: ("f", 4),
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def parse_gltf(path: str) -> ObjMesh:
    import base64
    import json
    import os

    with open(path, "rb") as f:
        data = f.read()

    bin_chunk = None
    if data[:4] == b"glTF":                       # .glb container
        if len(data) < 12:
            raise ValueError(f"{path}: truncated GLB header")
        pos, gltf = 12, None
        while pos + 8 <= len(data):
            (clen, ctype) = struct.unpack_from("<II", data, pos)
            chunk = data[pos + 8 : pos + 8 + clen]
            if ctype == 0x4E4F534A:               # 'JSON'
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:             # 'BIN\0'
                bin_chunk = chunk
            pos += 8 + clen + (-clen % 4)
        if gltf is None:
            raise ValueError(f"{path}: GLB has no JSON chunk")
    else:
        gltf = json.loads(data)

    base = os.path.dirname(path)
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise ValueError(f"{path}: buffer without uri outside GLB")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as f:
                buffers.append(f.read())

    def read_accessor(idx: int) -> np.ndarray:
        acc = gltf["accessors"][idx]
        fmt, size = _GLTF_COMPONENT[acc["componentType"]]
        ncomp = _GLTF_NCOMP[acc["type"]]
        count = acc["count"]
        view = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[view["buffer"]]
        off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or size * ncomp
        out = np.empty((count, ncomp), np.float64)
        for i in range(count):
            out[i] = struct.unpack_from("<" + fmt * ncomp, buf, off + i * stride)
        if acc.get("normalized") and fmt in ("B", "H", "b", "h"):
            out /= float((1 << (8 * size - (0 if fmt.isupper() else 1))) - 1)
        return out

    verts, uvs, face_v, face_t, face_mat = [], [], [], [], []
    v_base = t_base = 0

    def emit_primitive(prim: dict, xform: np.ndarray) -> None:
        nonlocal v_base, t_base
        if prim.get("mode", 4) != 4:              # TRIANGLES only
            return
        pos = read_accessor(prim["attributes"]["POSITION"])[:, :3]
        pos = pos @ xform[:3, :3].T + xform[:3, 3]
        if "indices" in prim:
            idx = read_accessor(prim["indices"]).astype(np.int64).ravel()
        else:
            idx = np.arange(pos.shape[0], dtype=np.int64)
        tri = idx.reshape(-1, 3)
        verts.append(pos)
        face_v.append(tri + v_base)
        uv_acc = prim["attributes"].get("TEXCOORD_0")
        if uv_acc is not None:
            uvs.append(read_accessor(uv_acc)[:, :2])
            face_t.append(tri + t_base)
            t_base += pos.shape[0]
        else:
            face_t.append(np.full_like(tri, -1))
        face_mat.append(
            np.full(tri.shape[0], prim.get("material", -1), np.int32)
        )
        v_base += pos.shape[0]

    def node_matrix(node: dict) -> np.ndarray:
        if "matrix" in node:                       # column-major per spec
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m[:3, :3] *= np.asarray(node["scale"], np.float64)
        if "rotation" in node:                     # quaternion (x, y, z, w)
            x, y, z, w = node["rotation"]
            rot = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            m[:3, :3] = rot @ m[:3, :3]
        if "translation" in node:
            m[:3, 3] = node["translation"]
        return m

    def walk(node_idx: int, parent: np.ndarray) -> None:
        node = gltf["nodes"][node_idx]
        xform = parent @ node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                emit_primitive(prim, xform)
        for child in node.get("children", []):
            walk(child, xform)

    scenes = gltf.get("scenes", [])
    scene_idx = gltf.get("scene", 0)
    if scenes:
        for root in scenes[scene_idx].get("nodes", []):
            walk(root, np.eye(4))
    else:                                          # no scene: every mesh, raw
        for mesh in gltf.get("meshes", []):
            for prim in mesh["primitives"]:
                emit_primitive(prim, np.eye(4))

    if not face_v:
        raise ValueError(f"{path}: no triangle primitives")
    mat_names = [
        m.get("name", f"material_{i}")
        for i, m in enumerate(gltf.get("materials", []))
    ]
    return _mesh(
        np.concatenate(verts) if verts else np.zeros((0, 3)),
        np.concatenate(uvs) if uvs else np.zeros((0, 2)),
        np.concatenate(face_v), np.concatenate(face_t),
        np.concatenate(face_mat), mat_names,
    )


def _ply_row(element: str, row: dict, verts, uvs, faces) -> None:
    if element == "vertex":
        verts.append((row["x"], row["y"], row["z"]))
        uv = [None, None]
        for k, slot in _UV_NAMES.items():
            if k in row:
                uv[slot] = row[k]
        if uv[0] is not None and uv[1] is not None:
            uvs.append((uv[0], uv[1]))
    elif element == "face":
        idx = row.get("vertex_indices") or row.get("vertex_index")
        if idx and len(idx) >= 3:
            faces.append(idx)
