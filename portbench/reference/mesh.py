"""Plain reference of a textured mesh scene: its files, camera, sample
start and bounce loop over spheres and triangles.

Written from the configuration file and the files it names alone: the
OBJ (vertices, UVs, ``usemtl`` slots, faces fan-triangulated), the MTL
(``map_Kd`` read as the ``.ppm`` beside it with its ``_alpha.ppm``
companion, ``Kd`` and ``d`` for an untextured slot), the P3 PPM textures,
``scene.materials`` (the per-slot overrides) and ``scene.spheres``. The
triangles are ordered by their centroids' Morton codes, as a scene file
loads them, and the coplanar parallelogram pairs are found here, so the
merged search's candidates are the program's, in its order.

The bounce loop is the program's plain version of the merged search, op
for op where it computes a value (``0.5 / x`` is a reciprocal and a
multiply in PyTorch, a division by a tensor is a division): the spheres
first with the strict ``t < best`` and ``sqrt(max(disc, 0))``, then the
triangles ranked as fractions t = num / den. The six (normal axis, sign)
groups of axis-aligned rects and unpaired triangles share the denominator
-s d_k, so a group's winner is its first least valid numerator (rects
whose edge e1 lies on the lower in-plane axis, then the higher, then the
triangles, in pair order), joined to the running winner by a fraction
compare gated on a hit; then the general parallelograms and leftover
triangles, folded one at a time; a parallelogram's winner is the half on
its side of the diagonal; then the one division. Then the winner's
barycentric UVs with the fmod wrap, the nearest texel, the alpha
cut-out, the refraction stack, emission from the texture and the
accumulation with the x1.3 bright quirk.

Departures from the program's plain version, none of which changes a
value:

- no search structure: every candidate of a group, and every general
  parallelogram and leftover triangle, is tested for every ray, without
  the groups' skip, the walk or the chunk culls, which skip only where no
  hit can win;
- the radiance alone: the albedo and normal AOVs are not traced;
- the ~tri_eps crack along a pair's diagonal is kept: it belongs to the
  merged search, the default of every mesh scene file.

Covered: merged quads with nearest textures, without AO, HSL boost or a
sky texture, at most one mesh, which is what the configurations that use
this module state; ``build`` refuses the rest. ``dtype`` runs the trace
in another precision (the check's control runs it in bfloat16); sums
over samples stay in float32. The work a frame needs is counted in
``mesh_work``.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from portbench.reference import mesh_work, rng, spheres, work

ROOT = Path(__file__).resolve().parents[2]
BIG = spheres.BIG
TWO_PI = spheres.TWO_PI
N_CAMERA_DRAWS = spheres.N_CAMERA_DRAWS
N_BOUNCE_DRAWS = spheres.N_BOUNCE_DRAWS
CAND_BLOCK = 1 << 24   # (rays x candidates) entries traced at once


@dataclass(frozen=True)
class Settings(spheres.Settings):
    det_eps: float
    tri_eps: float


class Mesh(NamedTuple):
    """The scene's triangles as read, in the load's Morton order."""

    verts: np.ndarray     # (T, 3 vertices, 3 axes) f32
    uvs: np.ndarray       # (T, 3 vertices, 2) f32
    mat: np.ndarray       # (T,) int64 material slot
    mats: np.ndarray      # (M, 9) f32: emission3 estr refl ior alpha_c
                          # use_alpha_const emission_from_texture
    texels: np.ndarray    # (n_tex, 4) f32: r g b alpha, y * W + x + W H slot
    tex_w: int
    tex_h: int


class Plan(NamedTuple):
    """The merged search's candidates: pairs (i, j, oi) of triangles i and
    j sharing the diagonal opposite i's vertex oi, sorted."""

    groups: tuple     # 6 x (k, s, rects m = 0, rects m = 1, triangles)
    quads: tuple      # (i, j, oi) of the general parallelograms
    leftovers: tuple  # the general unpaired triangles


class Tables(NamedTuple):
    """The scene's tables; the winners' triangle indices are int32 apart
    from the rows they are chosen by, so no precision rounds them."""

    sph: Tensor       # (14, S) sphere rows
    tri: Tensor       # (18, T): a3 b3 c3 ab3 ac3 n3
    mat: Tensor       # (T,) int64 material slot
    uv: Tensor        # (6, T): ua va ub vb uc vc
    mats: Tensor      # (9, M)
    texels: Tensor    # (4, n_tex)
    groups: tuple     # per group: (k, s, rects m = 0 (6, n), m = 1 (6, n),
                      # triangles (8, n), their winners (2, n) int32: the
                      # halves i, j of a rect, t twice for a triangle)
    quad: Tensor      # (12, Q): a3 e1_3 e2_3 n3
    quad_win: Tensor  # (2, Q) int32: i j
    left: Tensor      # (12, L): a3 ab3 ac3 n3
    left_win: Tensor  # (L,) int32: t
    tex_w: int
    tex_h: int


# ---- the files --------------------------------------------------------------

def _path(p: str) -> str:
    return p if os.path.isabs(p) else str(ROOT / p)


def read_ppm(path: str) -> np.ndarray:
    """An ASCII P3 PPM as (H, W, 3) f32 samples n * f32(1 / maxval), rows
    bottom-up (row 0 the image's bottom, as texture v counts)."""
    with open(path) as f:
        words = []
        for line in f:
            words += line.split("#")[0].split()
    if words[0] != "P3":
        raise ValueError(f"{path}: not a P3 PPM")
    w, h, maxval = (int(x) for x in words[1:4])
    vals = np.asarray(words[4:4 + w * h * 3], np.float32).reshape(h, w, 3)
    return np.ascontiguousarray((vals * np.float32(1.0 / maxval))[::-1])


def read_obj(path: str):
    """(vertices (V, 3) f32, uvs (VT, 2) f32, faces [(v idx, uv idx, slot)]
    fan-triangulated, 0-based, uv -1 where absent, slot -1 before any
    ``usemtl``, the slots' material names)."""
    verts, uvs, faces, names = [], [], [], []
    with open(path) as f:
        for line in f:
            w = line.split()
            if line.startswith("v "):
                verts.append([float(x) for x in w[1:4]])
            elif line.startswith("vt"):
                uvs.append([float(x) for x in w[1:3]])
            elif line.startswith("usemtl"):
                names.append(line[6:].strip())
            elif line.startswith("f ") and len(w) >= 4:
                idx = [(int(t.split("/")[0]) - 1,
                        int(t.split("/")[1]) - 1
                        if len(t.split("/")) > 1 and t.split("/")[1] else -1)
                       for t in w[1:]]
                for q in range(1, len(idx) - 1):
                    tri = (idx[0], idx[q], idx[q + 1])
                    faces.append(([v for v, _ in tri], [t for _, t in tri],
                                  len(names) - 1))
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(uvs, np.float32).reshape(-1, 2), faces, names)


def read_mtl(path: str) -> dict:
    """name -> {"map_kd": path or None, "kd": rgb or None, "d": or None}."""
    out, cur = {}, None
    with open(path) as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            if w[0] == "newmtl":
                cur = out[line[7:].strip()] = {"map_kd": None, "kd": None,
                                                "d": None}
            elif cur is None:
                continue
            elif w[0] == "map_Kd":
                tex = line.split(None, 1)[1].strip()
                cur["map_kd"] = os.path.join(os.path.dirname(path),
                                             tex[2:] if tex.startswith("./")
                                             else tex)
            elif w[0] == "Kd" and len(w) >= 4:
                cur["kd"] = [float(x) for x in w[1:4]]
            elif w[0] == "d" and len(w) >= 2:
                cur["d"] = float(w[1])
    return out


def _u8(v: float) -> np.float32:
    """A solid colour on the textures' u8 lattice."""
    return (np.float32(round(min(max(float(v), 0.0), 1.0) * 255))
            * np.float32(1.0 / 255.0))


def _tile(entry: dict):
    """(rgb (H, W, 3), alpha (H, W)) of a slot's texture, or None for a
    slot without one."""
    if not entry.get("map_kd"):
        return None
    base = os.path.splitext(entry["map_kd"])[0]
    rgb = read_ppm(base + ".ppm")
    alpha = (read_ppm(base + "_alpha.ppm")[..., 0]
             if os.path.exists(base + "_alpha.ppm")
             else np.ones(rgb.shape[:2], np.float32))
    return rgb, alpha


def _collapse(tiles, h: int, w: int) -> int:
    """The largest k dividing h and w on whose k x k blocks every tile is
    constant: the nearest fetch reads such tiles at (h / k, w / k)."""
    for k in range(math.gcd(h, w), 1, -1):
        if h % k == 0 and w % k == 0 and all(
                (t == t[:, :1, :, :1]).all()
                for t in (x.reshape(h // k, k, w // k, k, -1)
                          for x in tiles)):
            return k
    return 1


def _atlas(entries: list):
    """(texels (n_tex, 4), W, H): each slot's tile, a slot without a
    texture solid in its Kd and d (0.784 grey, opaque, without them)."""
    tiles = [_tile(e) for e in entries]
    shape = next((t[0].shape[:2] for t in tiles if t is not None), (1, 1))
    rgbs, alphas = [], []
    for e, t in zip(entries, tiles):
        if t is None:
            kd = e.get("kd") or (0.784,) * 3
            a = _u8(e["d"]) if e.get("d") is not None else np.float32(1.0)
            t = (np.full(shape + (3,), [_u8(c) for c in kd], np.float32),
                 np.full(shape, a, np.float32))
        if t[0].shape[:2] != shape:
            raise ValueError("reference mesh: textures of different sizes")
        rgbs.append(t[0])
        alphas.append(t[1])
    h, w = shape
    k = _collapse(rgbs + alphas, h, w)
    rgbs, alphas = [x[::k, ::k] for x in rgbs], [x[::k, ::k] for x in alphas]
    texels = np.concatenate([np.concatenate([r, a[..., None]], -1)
                             .reshape(-1, 4) for r, a in zip(rgbs, alphas)])
    return texels.astype(np.float32), w // k, h // k


def _materials(n: int, overrides: list) -> np.ndarray:
    """(M, 9) of the slots with ``scene.materials``' overrides."""
    m = np.zeros((n, 9), np.float32)
    m[:, 5] = m[:, 6] = 1.0   # ior, alpha_c
    for o in overrides:
        i = int(o["id"])
        m[i, 0:3] = o.get("emission", m[i, 0:3])
        m[i, 3] = o.get("emission_strength", m[i, 3])
        m[i, 4] = o.get("reflection", m[i, 4])
        m[i, 5] = o.get("ior", m[i, 5])
        if "alpha" in o:
            m[i, 6], m[i, 7] = o["alpha"], 1.0
        m[i, 8] = float(bool(o.get("emission_from_texture", False)))
    return m


def morton_order(verts: np.ndarray) -> np.ndarray:
    """The stable order of the triangles by the 30-bit Morton code of
    their centroids (f32), each axis scaled to [0, 1023] over the
    centroids' range."""
    cen = [(verts[:, 0, a] + verts[:, 1, a] + verts[:, 2, a]) / 3.0
           for a in range(3)]
    code = np.zeros(verts.shape[0], np.uint64)
    for a, c in enumerate(cen):
        lo, hi = float(c.min()), float(c.max())
        q = (np.zeros_like(c) if hi - lo <= 0
             else np.clip((c - lo) / (hi - lo) * 1023.0, 0, 1023))
        v = q.astype(np.uint32).astype(np.uint64) & 0x3FF
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F),
                            (4, 0x030C30C3), (2, 0x09249249)):
            v = (v | (v << np.uint64(shift))) & np.uint64(mask)
        code |= v << np.uint64(a)
    return np.argsort(code, kind="stable")


def load(config: dict) -> Mesh:
    """The configuration's mesh, its materials and its textures."""
    sc = config["scene"]
    v, uv, faces, names = read_obj(_path(sc["obj"]))
    fv = np.asarray([f[0] for f in faces], np.int64).reshape(-1, 3)
    ft = np.asarray([f[1] for f in faces], np.int64).reshape(-1, 3)
    slot = np.maximum([f[2] for f in faces], 0).astype(np.int64)
    tuv = (np.where(ft[..., None] >= 0,
                    uv[np.clip(ft, 0, len(uv) - 1)], np.float32(0.0))
           if len(uv) else np.zeros(ft.shape + (2,), np.float32))
    verts = v[fv]
    order = morton_order(verts) if len(verts) > 1 else np.arange(1)
    mtl = read_mtl(_path(sc["mtl"]))
    texels, w, h = _atlas([mtl.get(n, {}) for n in names])
    return Mesh(verts[order], tuv[order].astype(np.float32), slot[order],
                _materials(max(len(names), 1), sc.get("materials", [])),
                texels, w, h)


# ---- the quad pairs ---------------------------------------------------------

def quad_pairs(verts: np.ndarray) -> tuple:
    """Sorted (i, j, oi): triangles i and j share an edge, the diagonal of
    the parallelogram they span exactly in float64 (i's vertex oi
    opposite it, plus j's opposite vertex, is the edge's two ends), and
    face the same way (their normals' dot product is positive). Each
    shared edge pairs greedily in triangle order, edges in the order the
    triangles first name them; a triangle joins one pair at most."""
    V = verts.astype(np.float64)
    n = np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])
    by_edge = defaultdict(list)
    for t in range(len(V)):
        for e in range(3):
            ends = sorted((tuple(V[t, (e + 1) % 3]), tuple(V[t, (e + 2) % 3])))
            by_edge[tuple(ends)].append((t, e))
    used, pairs = set(), []
    for (p, q), sides in by_edge.items():
        for x, (i, oi) in enumerate(sides):
            if i in used:
                continue
            for j, oj in sides[x + 1:]:
                if (j not in used and j != i
                        and (V[i, oi] + V[j, oj] == np.add(p, q)).all()
                        and float(n[i] @ n[j]) > 0.0):
                    used |= {i, j}
                    pairs.append((i, j, oi))
                    break
    return tuple(sorted(pairs))


def _axis(v: np.ndarray):
    nz = np.nonzero(v)[0]
    return int(nz[0]) if len(nz) == 1 else None


def plan(verts: np.ndarray) -> Plan:
    """The merged search's candidates from the pairs: a pair whose normal
    and both edges lie on one axis each is a rect of group (k, s) (s the
    normal's sign on axis k), with m = 0 where its edge e1 lies on the
    lower in-plane axis; an unpaired triangle whose normal lies on an
    axis joins its group; the rest are general."""
    V = verts.astype(np.float64)
    pairs = quad_pairs(verts)
    rects, quads = defaultdict(list), []
    for i, j, oi in pairs:
        a = V[i, oi]
        e1, e2 = V[i, (oi + 1) % 3] - a, V[i, (oi + 2) % 3] - a
        k = _axis(np.cross(e1, e2))
        if k is None or _axis(e1) is None or _axis(e2) is None:
            quads.append((i, j, oi))
            continue
        s = 1 if np.cross(e1, e2)[k] > 0 else -1
        rects[k, s, 0 if _axis(e1) == min({0, 1, 2} - {k}) else 1].append(
            (i, j, oi))
    paired = {t for p in pairs for t in p[:2]}
    tris, left = defaultdict(list), []
    for t in range(len(V)):
        if t in paired:
            continue
        nrm = np.cross(V[t, 1] - V[t, 0], V[t, 2] - V[t, 0])
        k = _axis(nrm)
        if k is None:
            left.append(t)
        else:
            tris[k, 1 if nrm[k] > 0 else -1].append(t)
    groups = tuple((k, s, tuple(rects[k, s, 0]), tuple(rects[k, s, 1]),
                    tuple(tris[k, s])) for k in range(3) for s in (1, -1))
    return Plan(groups, tuple(quads), tuple(left))


# ---- the tables -------------------------------------------------------------

def _index(rows, device) -> list[Tensor]:
    """Each column of ``rows`` (tuples of ints) as an int64 tensor."""
    return [torch.tensor(c, device=device) for c in zip(*rows)]


def _rect_rows(P: Tensor, rects, k: int, s: int, m: int, det_eps: float):
    """(6, n): s a_k | det_eps / |e1_m e2_o| | a_m | 1 / e1_m | a_o |
    1 / e2_o, the corner a being i's vertex oi and e1, e2 the diagonal's
    ends less it; m_ax is e1's axis and o_ax e2's."""
    if not rects:
        return P.new_zeros((6, 0))
    lo, hi = sorted({0, 1, 2} - {k})
    m_ax, o_ax = (lo, hi) if m == 0 else (hi, lo)
    i, _, oi = _index(rects, P.device)
    a, s1, s2 = P[i, oi], P[i, (oi + 1) % 3], P[i, (oi + 2) % 3]
    e1m = s1[:, m_ax] - a[:, m_ax]
    e2o = s2[:, o_ax] - a[:, o_ax]
    u = torch.abs(e1m * e2o)
    return torch.stack([s * a[:, k], torch.full_like(u, det_eps) / u,
                        a[:, m_ax], 1.0 / e1m, a[:, o_ax], 1.0 / e2o])


def _tri_rows(A: Tensor, AB: Tensor, AC: Tensor, tris, k: int, s: int,
              det_eps: float):
    """(8, n): s a_k | det_eps / |D| | a_i1 | a_i2 | ac_i2 / D | -ac_i1 / D
    | -ab_i2 / D | ab_i1 / D, D the in-plane determinant."""
    if not tris:
        return A.new_zeros((8, 0))
    i1, i2 = sorted({0, 1, 2} - {k})
    t = torch.tensor(tris, device=A.device)
    ab1, ab2, ac1, ac2 = AB[i1, t], AB[i2, t], AC[i1, t], AC[i2, t]
    D = ab1 * ac2 - ab2 * ac1
    return torch.stack([s * A[k, t], torch.full_like(D, det_eps) / torch.abs(D),
                        A[i1, t], A[i2, t], ac2 / D, -ac1 / D, -ab2 / D,
                        ab1 / D])


def _winners(r0, r1, tris, device) -> Tensor:
    """(2, n) int32 winners of a group's columns: i, j of each rect, t
    twice for each triangle."""
    w = [(i, j) for i, j, _ in (*r0, *r1)] + [(t, t) for t in tris]
    return torch.tensor(w, dtype=torch.int32, device=device).reshape(-1, 2).T


def tables(mesh: Mesh, pl: Plan, sphere_rows, det_eps: float,
           device=None) -> Tables:
    P = torch.as_tensor(mesh.verts, device=device)          # (T, 3, 3)
    A, B, C = (P[:, q, :].T.contiguous() for q in range(3))  # (3, T) each
    AB, AC = B - A, C - A
    N = torch.stack(spheres._cross(AB, AC))
    groups = tuple((k, s, _rect_rows(P, r0, k, s, 0, det_eps),
                    _rect_rows(P, r1, k, s, 1, det_eps),
                    _tri_rows(A, AB, AC, tt, k, s, det_eps),
                    _winners(r0, r1, tt, device))
                   for k, s, r0, r1, tt in pl.groups)
    quad = P.new_zeros((12, 0))
    if pl.quads:
        i, _, oi = _index(pl.quads, device)
        a = P[i, oi].T
        e1, e2 = P[i, (oi + 1) % 3].T - a, P[i, (oi + 2) % 3].T - a
        quad = torch.cat([a, e1, e2, torch.stack(spheres._cross(e1, e2))])
    t = torch.tensor(pl.leftovers, dtype=torch.int64, device=device)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    return Tables(
        sph=spheres.table(sphere_rows, device),
        tri=torch.cat([A, B, C, AB, AC, N]),
        mat=torch.as_tensor(mesh.mat, device=device),
        uv=torch.as_tensor(mesh.uvs.reshape(-1, 6).T.copy(), device=device),
        mats=torch.as_tensor(mesh.mats.T.copy(), device=device),
        texels=torch.as_tensor(mesh.texels.T.copy(), device=device),
        groups=groups, quad=quad,
        quad_win=i32([p[:2] for p in pl.quads]).reshape(-1, 2).T,
        left=torch.cat([A[:, t], AB[:, t], AC[:, t], N[:, t]]),
        left_win=i32(pl.leftovers), tex_w=mesh.tex_w, tex_h=mesh.tex_h)


def build(config: dict, device=None) -> tuple[Tables, Tensor, Settings]:
    """(tables, packed camera (12,), settings) of a configuration file's
    dict, on ``device``."""
    rc, sc = config["render"], config["scene"]
    if (rc.get("use_ao") or rc.get("hsl_l_factor", 1.0) != 1.0
            or rc.get("hsl_s_factor", 1.0) != 1.0
            or rc.get("bilinear_textures") or not rc.get("merge_quads", True)
            or sc.get("sky_sphere_index", -1) >= 0):
        raise NotImplementedError("reference mesh: AO, HSL boost, bilinear "
                                  "textures, the sky texture and the "
                                  "per-triangle search are not covered")
    mesh = load(config)
    pl = plan(mesh.verts)
    if not any(g[2] or g[3] for g in pl.groups) and not pl.quads:
        raise NotImplementedError("reference mesh: no quad pairs, so the "
                                  "program runs the per-triangle search")
    s = Settings(
        width=rc["width"], height=rc["height"], bounces=rc["max_bounces"],
        focus_distance=rc["focus_distance"], aperture_x=rc["aperture_x"],
        aperture_y=rc["aperture_y"], sphere_eps=rc["sphere_eps"],
        alpha_lo=rc["refr_alpha_lo"], alpha_hi=rc["refr_alpha_hi"],
        bright_boost=rc["bright_boost"],
        bright_threshold=rc["bright_threshold"], det_eps=rc["tri_det_eps"],
        tri_eps=rc["tri_eps"])
    c = config["camera"]
    cam = spheres.camera(c["origin"], c["target"], c["up"], c["vfov_deg"],
                         c["aspect_ratio"], device)
    return tables(mesh, pl, sc["spheres"], s.det_eps, device), cam, s


# ---- the search -------------------------------------------------------------

def _closest_sphere(sph: Tensor, o, d, eps):
    """(best t, winner or -1) over the spheres: strict t < best."""
    a_quad = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inv_2a = 0.5 / torch.clamp(a_quad, min=1e-20)
    best = torch.full_like(d[0], BIG)
    bidx = torch.full_like(d[0], -1, dtype=torch.int32)
    for q in range(sph.shape[1]):
        cx, cy, cz, r = sph[0, q], sph[1, q], sph[2, q], sph[3, q]
        ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
        b_ = 2.0 * (ocx * d[0] + ocy * d[1] + ocz * d[2])
        c_ = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b_ * b_ - 4.0 * a_quad * c_
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t1 = (-b_ - sq) * inv_2a
        t2 = (-b_ + sq) * inv_2a
        hit = disc > 0.0
        t = torch.where(hit & (t1 >= eps), t1,
                        torch.where(hit & (t2 >= eps), t2, BIG))
        better = t < best
        best = torch.where(better, t, best)
        bidx = torch.where(better, q, bidx)
    return best, bidx


def _group_candidates(tb_group, o, d, tri_eps: float):
    """A group's (numerator where valid else BIG (B, n), winner (B, n),
    the shared denominator detg (B,)) over its rects of both edge axes
    and its triangles, in that order."""
    k, s, rm0, rm1, tt, W = tb_group
    i1, i2 = sorted({0, 1, 2} - {k})
    col = lambda t: t[:, None]
    dg = col(-d[k] if s > 0 else d[k])
    so = col(o[k] if s > 0 else -o[k])
    epsd, hid = col(tri_eps * dg[:, 0]), col((1.0 - tri_eps) * dg[:, 0])
    X = (col(o[i1] * dg[:, 0]), col(o[i2] * dg[:, 0]))
    D = (col(d[i1]), col(d[i2]))
    vals, wins, c0 = [], [], 0
    for m, R in ((0, rm0), (1, rm1)):
        if not R.shape[1]:
            continue
        w = W[:, c0:c0 + R.shape[1]]
        c0 += R.shape[1]
        numr = so - R[0]
        pug = (X[m] - R[2] * dg + numr * D[m]) * R[3]
        pvg = (X[1 - m] - R[4] * dg + numr * D[1 - m]) * R[5]
        valid = ((dg >= R[1]) & (numr >= epsd) & (pug >= epsd)
                 & (pvg >= epsd) & (pug <= hid) & (pvg <= hid))
        vals.append(torch.where(valid, numr, BIG))
        wins.append(torch.where(pug + pvg <= dg, w[0], w[1]))
    if tt.shape[1]:
        numr = so - tt[0]
        P1 = X[0] - tt[2] * dg + numr * D[0]
        P2 = X[1] - tt[3] * dg + numr * D[1]
        ug = P1 * tt[4] + P2 * tt[5]
        vg = P1 * tt[6] + P2 * tt[7]
        valid = ((dg >= tt[1]) & (numr >= epsd) & (ug >= epsd)
                 & (vg >= epsd) & (ug + vg <= hid))
        vals.append(torch.where(valid, numr, BIG))
        wins.append(W[0, c0:].expand_as(numr))
    return torch.cat(vals, 1), torch.cat(wins, 1), dg[:, 0]


def _general(q: Tensor, w: Tensor, o, d, s: Settings, quad: bool):
    """(valid, num, det, winner) of every ray (rows) against the general
    parallelograms (``quad``: e1 rows 3-5, e2 rows 6-8, the winner the
    half of ``w`` on the ray's side of the diagonal) or leftover
    triangles (ab, ac; winners ``w``): Moller-Trumbore's terms times det,
    without the division."""
    o, d = [c[:, None] for c in o], [c[:, None] for c in d]
    aox, aoy, aoz = o[0] - q[0], o[1] - q[1], o[2] - q[2]
    daox = aoy * d[2] - aoz * d[1]
    daoy = aoz * d[0] - aox * d[2]
    daoz = aox * d[1] - aoy * d[0]
    det = -(d[0] * q[9] + d[1] * q[10] + d[2] * q[11])
    num = aox * q[9] + aoy * q[10] + aoz * q[11]
    pu = q[6] * daox + q[7] * daoy + q[8] * daoz
    pv = -(q[3] * daox + q[4] * daoy + q[5] * daoz)
    lo_ = s.tri_eps * det
    valid = ((det >= s.det_eps) & (num >= lo_) & (pu >= lo_) & (pv >= lo_))
    if quad:
        hi_ = (1.0 - s.tri_eps) * det
        valid = valid & (pu <= hi_) & (pv <= hi_)
        win = torch.where(pu + pv <= det, w[0], w[1])
    else:
        valid = valid & (pu + pv <= (1.0 - s.tri_eps) * det)
        win = w.expand_as(num)
    return valid, num, det, win


def closest(tb: Tables, s: Settings, o, d, active):
    """(t, winner or -1) of each ray: the spheres, then the triangles
    (winner n_spheres + t) ranked as fractions, then the division."""
    ns = tb.sph.shape[1]
    best, bidx = _closest_sphere(tb.sph, o, d, s.sphere_eps)
    bden = torch.ones_like(best)
    for g in tb.groups:
        if not g[5].shape[1]:
            continue
        vals, wins, detg = _group_candidates(g, o, d, s.tri_eps)
        bg = vals.amin(1)
        first = (vals == bg[:, None]).to(torch.uint8).argmax(1)
        gi = wins.gather(1, first[:, None])[:, 0]
        deng = torch.where(detg > 0.0, detg, 1.0)
        better = (bg < BIG) & (bg * bden < best * deng)
        best = torch.where(better, bg, best)
        bden = torch.where(better, deng, bden)
        bidx = torch.where(better, ns + gi, bidx)
    for q, w, is_quad in ((tb.quad, tb.quad_win, True),
                          (tb.left, tb.left_win, False)):
        if not q.shape[1]:
            continue
        valid, num, det, win = _general(q, w, o, d, s, is_quad)
        num_c = torch.where(valid, num, BIG)
        den_c = torch.where(valid, det, 1.0)
        for j in range(q.shape[1]):
            better = active & (num_c[:, j] * bden < best * den_c[:, j])
            best = torch.where(better, num_c[:, j], best)
            bden = torch.where(better, den_c[:, j], bden)
            bidx = torch.where(better, ns + win[:, j], bidx)
    return best / bden, bidx


# ---- the bounce loop --------------------------------------------------------

def _take(plane: Tensor, idx: Tensor) -> Tensor:
    """plane[idx], zero where idx is outside the plane."""
    ok = (idx >= 0) & (idx < plane.shape[-1])
    return torch.where(ok, plane[..., torch.where(ok, idx, 0)], 0.0)


def _wrap(u: Tensor) -> Tensor:
    u = torch.fmod(u, 1.0)
    return torch.where(u < 0.0, u + 1.0, u)


def triangle_hit(tb: Tables, t_idx: Tensor, p):
    """The winning triangles' unit normal, and their texel's material at
    hit point p: (normal, diffuse, emission, emission strength,
    reflection, alpha, ior), each a tuple of (B,) or a (B,)."""
    w = tb.tri[:, t_idx]
    a, b, c, n_raw = w[0:3], w[3:6], w[6:9], w[15:18]
    nrm = spheres._normalize(tuple(n_raw))
    dot = spheres._dot
    sub = lambda x, y: tuple(xc - yc for xc, yc in zip(x, y))
    area_abc = dot(nrm, spheres._cross(sub(b, a), sub(c, a)))
    area_pbc = dot(nrm, spheres._cross(sub(b, p), sub(c, p)))
    area_pca = dot(nrm, spheres._cross(sub(c, p), sub(a, p)))
    inv = 1.0 / torch.where(area_abc.abs() > 1e-20, area_abc, 1.0)
    w_a = area_pbc * inv
    w_b = area_pca * inv
    w_c = 1.0 - w_a - w_b
    uv = tb.uv[:, t_idx]
    u = _wrap(w_a * uv[0] + w_b * uv[2] + w_c * uv[4])
    v = _wrap(w_a * uv[1] + w_b * uv[3] + w_c * uv[5])
    mat = tb.mat[t_idx]
    tw, th = tb.tex_w, tb.tex_h
    x = torch.clamp(torch.floor(u * tw).to(torch.int64), 0, tw - 1)
    y = torch.clamp(torch.floor(v * th).to(torch.int64), 0, th - 1)
    texel = _take(tb.texels, (y * tw + x) + (th * tw) * mat)
    em, estr, refl, ior, alpha_c, use_c, eft = (
        _take(tb.mats[0:3], mat), *(_take(tb.mats[r], mat)
                                    for r in range(3, 9)))
    emission = tuple(torch.where(eft > 0.0, e * t, e)
                     for e, t in zip(em, texel[0:3]))
    alpha = torch.where(use_c > 0.0, alpha_c, texel[3])
    return nrm, tuple(texel[0:3]), emission, estr, refl, alpha, ior


def trace(tb: Tables, o, d, draws: Tensor, s: Settings,
          counts: dict | None = None) -> Tensor:
    """The bounce loop: (3, B) radiance of rays o, d (tuples of (B,)),
    with draw j of bounce b in row 3b + j of ``draws``. ``counts``
    receives the work: "live", the (ray, bounce) pairs still in the loop
    that hit; "tri", those whose winner is a triangle; "draws", the
    scatter and roulette draws those bounces use (two a bounce that
    scatters, one more where the material can refract)."""
    ns = tb.sph.shape[1]
    rox, roy, roz = o
    rdx, rdy, rdz = d
    f0, f1 = torch.zeros_like(rox), torch.ones_like(rox)
    rcx = rcy = rcz = f1
    ix = iy = iz = f0
    active_f, medium_n2 = f1, f1
    alpha_depth = torch.zeros_like(rox, dtype=torch.int32)
    stab = torch.cat([tb.sph, torch.zeros_like(tb.sph[:, :1])], dim=1)
    for i in range(s.bounces):
        active = active_f > 0.0
        best, bidx = closest(tb, s, (rox, roy, roz), (rdx, rdy, rdz), active)
        did_hit = bidx >= 0
        tri_wins = bidx >= ns
        safe_t = torch.where(did_hit, best, 0.0)
        px = rox + rdx * safe_t
        py = roy + rdy * safe_t
        pz = roz + rdz * safe_t
        sph_wins = did_hit & ~tri_wins
        (cx, cy, cz, _, sdfx, sdfy, sdfz, semx, semy, semz, sestr, srefl,
         salpha, sior) = stab[:, torch.where(sph_wins, bidx, ns).long()
                              ].unbind(0)
        svx, svy, svz = px - cx, py - cy, pz - cz
        n2s = svx * svx + svy * svy + svz * svz
        s_inv = torch.where((n2s > 0) & sph_wins,
                            1.0 / torch.sqrt(torch.clamp(n2s, min=1e-38)),
                            0.0)
        (tn, tdf, tem, testr, trefl, talpha, tior) = triangle_hit(
            tb, torch.where(tri_wins, bidx - ns, 0).long(), (px, py, pz))
        sel = lambda t, sp: torch.where(tri_wins, t, sp)
        nX, nY, nZ = (sel(tn[0], svx * s_inv), sel(tn[1], svy * s_inv),
                      sel(tn[2], svz * s_inv))
        dfx, dfy, dfz = (sel(tdf[0], sdfx), sel(tdf[1], sdfy),
                         sel(tdf[2], sdfz))
        emx, emy, emz = (sel(tem[0], semx), sel(tem[1], semy),
                         sel(tem[2], semz))
        estr, refl = sel(testr, sestr), sel(trefl, srefl)
        alpha, ior = sel(talpha, salpha), sel(tior, sior)
        u_d, v_d, roulette = draws[3 * i], draws[3 * i + 1], draws[3 * i + 2]

        was_live = active & did_hit
        emissive_ret = active & did_hit & (alpha_depth == i) & (estr > 0.0)
        ix = torch.where(emissive_ret, emx, ix)
        iy = torch.where(emissive_ret, emy, iy)
        iz = torch.where(emissive_ret, emz, iz)
        active = active & ~emissive_ret
        live = active & did_hit

        # scatter: diffuse/specular lerp
        theta = TWO_PI * u_d
        cph = torch.clamp(2.0 * v_d - 1.0, -1.0, 1.0)
        sph_ = torch.sqrt(torch.clamp(1.0 - cph * cph, min=0.0))
        ddx, ddy, ddz = spheres._normalize((nX + torch.cos(theta) * sph_,
                                            nY + torch.sin(theta) * sph_,
                                            nZ + cph))
        vdn = rdx * nX + rdy * nY + rdz * nZ
        rfx = rdx - 2.0 * vdn * nX
        rfy = rdy - 2.0 * vdn * nY
        rfz = rdz - 2.0 * vdn * nZ
        drx = ddx + (rfx - ddx) * refl
        dry = ddy + (rfy - ddy) * refl
        drz = ddz + (rfz - ddz) * refl

        # refraction through the reduced medium stack
        refr_case = live & (alpha <= s.alpha_hi) & (alpha >= s.alpha_lo)
        exiting = vdn > 0.0
        nex = torch.where(exiting, -nX, nX)
        ney = torch.where(exiting, -nY, nY)
        nez = torch.where(exiting, -nZ, nZ)
        n1_ = torch.where(exiting, ior, medium_n2)
        n2_ = torch.where(exiting, medium_n2, ior)
        medium_n2 = torch.where(refr_case & ~exiting, ior, medium_n2)
        n1s = n1_ * n1_
        n2s = n2_ * n2_
        n2s_safe = torch.where(n2s > 1e-20, n2s, 1.0)
        ratio = torch.clamp(n1s / n2s_safe, 0.0, 1e6)
        ndotv = nex * rdx + ney * rdy + nez * rdz
        radical = 1.0 - (ratio * ratio) * (1.0 - ndotv * ndotv)
        ct_scale = rdx * nex + rdy * ney + rdz * nez
        sqr = torch.sqrt(torch.clamp(radical, min=1e-20))
        refx = (rdx - nex * ct_scale) * ratio - nex * sqr
        refy = (rdy - ney * ct_scale) * ratio - ney * sqr
        refz = (rdz - nez * ct_scale) * ratio - nez * sqr
        vdne = rdx * nex + rdy * ney + rdz * nez
        tir = radical <= 0.0
        refx = torch.where(tir, rdx - 2.0 * vdne * nex, refx)
        refy = torch.where(tir, rdy - 2.0 * vdne * ney, refy)
        refz = torch.where(tir, rdz - 2.0 * vdne * nez, refz)
        do_refract = refr_case & (roulette > alpha)

        # opaque / cutout
        cutout = live & (alpha < s.alpha_lo)
        alpha_depth = torch.where(cutout, alpha_depth + 1, alpha_depth)

        accum = live & ~do_refract & ~cutout
        rox = torch.where(live, px, rox)
        roy = torch.where(live, py, roy)
        roz = torch.where(live, pz, roz)
        rdx = torch.where(do_refract, refx, torch.where(accum, drx, rdx))
        rdy = torch.where(do_refract, refy, torch.where(accum, dry, rdy))
        rdz = torch.where(do_refract, refz, torch.where(accum, drz, rdz))

        # accumulate; the bright test reads the throughput before the update
        ix = torch.where(accum, ix + emx * estr * rcx, ix)
        iy = torch.where(accum, iy + emy * estr * rcy, iy)
        iz = torch.where(accum, iz + emz * estr * rcz, iz)
        th, bb = s.bright_threshold, s.bright_boost
        bright = (rcx > th) | (rcy > th) | (rcz > th)
        nbx = torch.where(bright, dfx * (dfx * (rcx * bb)), dfx * rcx)
        nby = torch.where(bright, dfy * (dfy * (rcy * bb)), dfy * rcy)
        nbz = torch.where(bright, dfz * (dfz * (rcz * bb)), dfz * rcz)
        rcx = torch.where(accum, nbx, rcx)
        rcy = torch.where(accum, nby, rcy)
        rcz = torch.where(accum, nbz, rcz)
        active_f = torch.where(active & did_hit, f1, f0)
        if counts is not None:
            for name, n in (("live", int(was_live.sum())),
                            ("tri", int((was_live & tri_wins).sum())),
                            ("draws", 2 * int(accum.sum())
                             + int(refr_case.sum()))):
                counts[name] = counts.get(name, 0) + n
    return torch.stack([ix, iy, iz])


def _in(tb: Tables, dtype) -> Tables:
    """The tables in ``dtype``."""
    f = lambda t: t.to(dtype)
    return tb._replace(
        sph=f(tb.sph), tri=f(tb.tri), uv=f(tb.uv), mats=f(tb.mats),
        texels=f(tb.texels), quad=f(tb.quad), left=f(tb.left),
        groups=tuple((k, s, f(a), f(b), f(c), w)
                     for k, s, a, b, c, w in tb.groups))


def trace_rays(tb: Tables, cam: Tensor, s: Settings, k: Tensor,
               pixel_ids: Tensor, sample_ids, dtype=torch.float32,
               counts: dict | None = None) -> Tensor:
    """(3, B) radiance of the rays (pixel_ids[i], sample_ids[i]) under the
    frame key ``k``: their keys, camera rays and bounce loop, computed in
    ``dtype``, in blocks of at most ``CAND_BLOCK`` (ray, candidate)
    entries of the largest group."""
    keys = rng.ray_keys(k, pixel_ids, sample_ids)
    d = rng.draws(keys, range(N_CAMERA_DRAWS + s.bounces * N_BOUNCE_DRAWS))
    d = d.to(dtype)
    o, direction = spheres.camera_rays(cam, s, pixel_ids, d[:N_CAMERA_DRAWS])
    tb = _in(tb, dtype)
    widest = max([1, tb.quad.shape[1], tb.left.shape[1]]
                 + [g[5].shape[1] for g in tb.groups])
    step = max(1, CAND_BLOCK // widest)
    return torch.cat([
        trace(tb, tuple(c[r:r + step] for c in o),
              tuple(c[r:r + step] for c in direction),
              d[N_CAMERA_DRAWS:, r:r + step], s, counts)
        for r in range(0, pixel_ids.shape[0], step)], dim=1)


def render_pixels(tb: Tables, cam: Tensor, s: Settings, k: Tensor,
                  pixel_ids: Tensor, spp: int, dtype=torch.float32,
                  max_rays: int = 1 << 20,
                  counts: dict | None = None) -> Tensor:
    """(3, P) f32 radiance sums of ``spp`` samples of the pixels
    ``pixel_ids``, added in sample order from zero as the program adds
    them. Samples are traced together, at most ``max_rays`` rays a call."""
    p = pixel_ids.shape[0]
    acc = torch.zeros((3, p), dtype=torch.float32, device=pixel_ids.device)
    step = max(1, max_rays // p)
    for s0 in range(0, spp, step):
        n = min(spp, s0 + step) - s0
        sids = torch.arange(s0, s0 + n, device=pixel_ids.device
                            ).repeat_interleave(p)
        rad = trace_rays(tb, cam, s, k, pixel_ids.repeat(n), sids, dtype,
                         counts).float().view(3, n, p)
        for t in range(n):
            acc = acc + rad[:, t]
    return acc


def train_steps(config: dict, *args, **kwargs):
    raise NotImplementedError("reference mesh: no training cell yet")


def layer_work(config: dict, rays: float, counts: dict, counted_rays: float,
               train: bool = False) -> dict:
    """The least work of each layer of a frame of ``rays`` rays of the
    configuration's scene, from ``counts`` taken over ``counted_rays``
    rays of the same traffic (``trace``'s live pairs, triangle winners
    and draws, scaled): the sample start, the forward bounce loop and the
    per-sample sums."""
    if train:
        raise NotImplementedError("reference mesh: no training cell yet")
    mesh = load(config)
    scale = rays / counted_rays
    return {"sample_start": work.sample_start(rays),
            "bounce_loop": mesh_work.bounce_loop(
                rays, counts["live"] * scale, counts["tri"] * scale,
                counts["draws"] * scale, len(config["scene"]["spheres"]),
                len(mesh.verts), len(mesh.mats), len(mesh.texels)),
            "sums": work.sums(rays)}
