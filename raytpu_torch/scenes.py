"""Built-in sphere scenes, as data, and a block-world scene writer.

Port of ``raytpu/scenes.py``: the 10-sphere Cornell scene, the CUDA
binary's variant (HSL boost + AO) and the DoF + AO configuration. Each
function returns (Scene, Camera, RenderConfig) with the scene and camera
tensors on ``device``: the CUDA card when it is ``None``, ``"cpu"`` for
the plain PyTorch path.

``write_block_world`` writes a textured mesh scene as files (OBJ, MTL,
PPM textures, TOML) for ``config.load_scene_file``: the reference's mesh
assets are not part of the repository, and this procedural world has the
shape of its largest one. ``write_quad_fixture`` writes a mesh that
reaches every branch of K3's merged-quad search, which the block world's
all axis-aligned faces do not. The reference's sky texture is not part of it
either: ``equirect_sky`` makes one with numpy, ``write_equirect_sky``
writes it as a PPM, and ``write_sky_showcase`` writes
``scenes/sky.toml``'s scene around it. ``write_mesh_twins`` writes a
mesh scene's mesh as PLY, GLB and STL, each with an OBJ twin of the
same arrays (``write_obj``), for the other importers.
"""

from __future__ import annotations

import os
from typing import Optional

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


# Block-world materials in usemtl order (slot = index): name, base colour,
# textured. Slots 6 and 7 are water and 9 is emissive, set in the TOML as
# scenes/mcworld_water.toml sets its water; 8 has an alpha companion of
# 0 / 128 / 255 texels (cutout, refraction window, opaque); 10 has no
# texture, so the atlas gets a solid tile of its Kd.
BLOCK_MATERIALS = (
    ("grass", (0.35, 0.62, 0.22), True), ("dirt", (0.55, 0.38, 0.24), True),
    ("stone", (0.5, 0.5, 0.52), True), ("sand", (0.86, 0.8, 0.56), True),
    ("planks", (0.7, 0.52, 0.3), True), ("leaves", (0.2, 0.45, 0.15), True),
    ("water_still", (0.2, 0.35, 0.8), True),
    ("water_flow", (0.25, 0.4, 0.85), True),
    ("glass", (0.8, 0.9, 0.95), True), ("glowstone", (0.95, 0.8, 0.45), True),
    ("snow", (0.94, 0.95, 0.97), False),
)
BLOCK_TILE = 16   # texels per texture side
_BLOCK_TOML = """\
# Procedural block world at the shape of BASELINE config 5
# (scenes/mcworld_water.toml): {n_tris} textured triangles, 11 materials of
# {tile}x{tile} texels, water slots 6 and 7 with the reference's water
# physics (alpha .6, ior 1.33, refl .93), a glass slot with a cut-out /
# window / opaque alpha texture and an emissive slot lit by its texels.
# Written by raytpu_torch.scenes.write_block_world(seed={seed}).
[render]
width = 1200
height = 900
spp = 1000
bounces = 6

[camera]
origin = [2.4, 2.6, 3.2]
target = [0.07, 0.9, 0.0]
up = [0.0, 1.0, 0.0]
vfov = 38.0

[mesh]
obj = "block_world.obj"
mtl = "block_world.mtl"

[[mesh.materials]]   # water_still
id = 6
alpha = 0.6
ior = 1.33
reflection = 0.93

[[mesh.materials]]   # water_flow
id = 7
alpha = 0.6
ior = 1.33
reflection = 0.93

[[mesh.materials]]   # glass: the alpha texture picks the branch
id = 8
ior = 1.5
reflection = 0.1

[[mesh.materials]]   # glowstone
id = 9
emission = [1.0, 0.85, 0.6]
emission_strength = 4.0
emission_from_texture = true

[[spheres]]   # ground
center = [0, -500.0, 0]
radius = 500.0
diffuse = [0.55, 0.6, 0.45]

[[spheres]]   # sun
center = [8.0, 12.0, 6.0]
radius = 2.0
emission = [1.0, 0.98, 0.9]
emission_strength = 40.0

[[spheres]]   # sky dome
center = [0.0, 0.0, 0.0]
radius = 100000.0
emission = [0.784, 0.965, 1.0]
emission_strength = 1.0
"""


def _block_faces(n: int, seed: int):
    """Exposed faces of an n x n heightmap of cubes: (material, corner,
    edge 1, edge 2) in block units, cross(edge 1, edge 2) outward."""
    rs = np.random.default_rng([seed, n])
    top = max(3, n // 2)
    i, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    wave = np.sin(0.9 * i + rs.uniform(0, 6)) * np.cos(0.7 * k + rs.uniform(0, 6))
    h = np.clip(np.rint(1 + (top - 1) * (0.5 + 0.45 * wave)
                        + rs.normal(0, 0.4, (n, n))), 1, top).astype(int)
    # the first columns of a seeded order get glass, glowstone, planks
    # and leaves blocks on top; the rest sand, grass or snow by height
    tops = np.where(h == 1, 3, np.where(h == top, 10, 0))
    for slot, c in zip((8, 9, 4, 5), rs.permutation(n * n)):
        tops.flat[c] = slot
    faces = []
    for x in range(n):
        for z in range(n):
            hc, mt = h[x, z], tops[x, z]
            faces.append((mt, (x, hc, z), (0, 0, 1), (1, 0, 0)))
            for (dx, dz), p0, e1, e2 in (
                ((1, 0), (x + 1, 0, z), (0, 1, 0), (0, 0, 1)),
                ((-1, 0), (x, 0, z), (0, 0, 1), (0, 1, 0)),
                ((0, 1), (x, 0, z + 1), (1, 0, 0), (0, 1, 0)),
                ((0, -1), (x, 0, z), (0, 1, 0), (1, 0, 0)),
            ):
                nx, nz = x + dx, z + dz
                hn = h[nx, nz] if 0 <= nx < n and 0 <= nz < n else 0
                for y in range(hn, hc):
                    m = (mt if y == hc - 1 and mt in (4, 5, 8, 9)
                         else 1 if y == 0 else 2)
                    faces.append((m, (p0[0], y, p0[2]), e1, e2))
    return faces


def _water_tiles(n: int, count: int):
    """``count`` water surface tiles in rings around the n x n columns,
    0.4 blocks above the ground, alternating the two water slots."""
    tiles = []
    d = 0
    while len(tiles) < count:
        ring = [(x, z) for x in range(-d - 1, n + d + 1)
                for z in range(-d - 1, n + d + 1)
                if max(-x - 1, x - n, -z - 1, z - n) == d]
        tiles += [(6 + (x + z) % 2, (x, 0.4, z), (0, 0, 1), (1, 0, 0))
                  for x, z in ring]
        d += 1
    return tiles[:count]


def write_block_world(directory: str, n_triangles: int = 600,
                      seed: int = 0, sky: Optional[str] = None) -> str:
    """Write a procedural block world in the reference's file formats
    (OBJ, MTL, 16x16 P3 PPM textures with an ``_alpha.ppm`` companion,
    TOML spec) into ``directory`` and return the TOML's path.

    The world is the shape of the reference's largest mesh scene, BASELINE
    config 5 (mcworld, ``scenes/mcworld_water.toml``): the exposed faces
    of a heightmap of cubes, two triangles per face, in a ring of water
    tiles, under the same camera, ground, sun and sky-dome spheres, at
    1200x900 and 6 bounces. Everything is made from ``seed`` with numpy.
    The heightmap is the widest that fits ``n_triangles`` (an even count);
    water tiles make up the rest, so the OBJ holds exactly
    ``n_triangles`` triangles, each material's faces written together
    after its ``usemtl``.

    ``sky``, a sky texture's path as the TOML should name it (relative to
    ``directory`` or absolute), adds a ``[sky]`` table: the sky dome, the
    last sphere with black diffuse, becomes the sky sphere
    (``scenes/mesh_sky.toml``'s shape). Without it the files are as they
    always were.
    """
    from raytpu_torch.io.ppm import write_ppm

    if n_triangles % 2:
        raise ValueError(f"n_triangles={n_triangles}: need an even count")
    n_faces = n_triangles // 2
    n = 1
    while len(_block_faces(n + 1, seed)) + 2 <= n_faces:
        n += 1
    faces = _block_faces(n, seed)
    if len(faces) + 2 > n_faces:
        raise ValueError(f"n_triangles={n_triangles} is below the smallest world")
    faces += _water_tiles(n, n_faces - len(faces))
    size = 2.4 / n                 # the columns span [-1.2, 1.2] in x and z
    to_world = lambda p: (-1.2 + size * p[0], size * p[1], -1.2 + size * p[2])

    os.makedirs(os.path.join(directory, "tex"), exist_ok=True)
    obj = ["# block world: exposed cube faces, 2 triangles each",
           "mtllib block_world.mtl",
           "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1"]
    mtl = []
    rs = np.random.default_rng(seed)
    n_v = 0
    for slot, (name, base, textured) in enumerate(BLOCK_MATERIALS):
        obj.append(f"usemtl {name}")
        for m, p0, e1, e2 in faces:
            if m != slot:
                continue
            corners = (p0, np.add(p0, e1), np.add(np.add(p0, e1), e2),
                       np.add(p0, e2))
            obj += ["v %.6f %.6f %.6f" % to_world(c) for c in corners]
            obj += [f"f {n_v + 1}/1 {n_v + 2}/2 {n_v + 3}/3",
                    f"f {n_v + 1}/1 {n_v + 3}/3 {n_v + 4}/4"]
            n_v += 4
        mtl += [f"newmtl {name}", "Kd %.3f %.3f %.3f" % base, "d 1.0"]
        if not textured:
            continue
        mtl.append(f"map_Kd tex/{name}.png")   # read as tex/<name>.ppm
        shade = np.asarray(base) * rs.uniform(0.55, 1.0, (BLOCK_TILE, BLOCK_TILE, 1))
        write_ppm(os.path.join(directory, "tex", f"{name}.ppm"),
                  np.rint(255 * shade).astype(np.int64))
        if name == "glass":
            a = rs.choice([0, 128, 255], size=(BLOCK_TILE, BLOCK_TILE),
                          p=[0.3, 0.3, 0.4])
            write_ppm(os.path.join(directory, "tex", "glass_alpha.ppm"),
                      np.repeat(a[..., None], 3, -1))
    with open(os.path.join(directory, "block_world.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")
    with open(os.path.join(directory, "block_world.mtl"), "w") as f:
        f.write("\n".join(mtl) + "\n")
    path = os.path.join(directory, "block_world.toml")
    with open(path, "w") as f:
        f.write(_BLOCK_TOML.format(n_tris=n_triangles, tile=BLOCK_TILE,
                                   seed=seed))
        if sky is not None:
            f.write(f'\n[sky]   # the sky dome shows this texture\nfile = "{sky}"\n')
    return path


_QUAD_TOML = """\
# A mesh fixture for K3's merged-quad search, written by
# raytpu_torch.scenes.write_quad_fixture(seed={seed}): {n_tris} triangles,
# {n_boxes} boxes whose faces are axis-aligned rects of both edge
# orientations in all six (normal axis, sign) groups, {n_aa} unpaired
# axis-aligned triangles, {n_quads} tilted parallelograms (one with a
# different material on each half), {n_left} tilted unpaired triangles.
[render]
width = 320
height = 240
spp = 16
bounces = 4

[camera]
origin = [0.4, 2.2, 5.6]
target = [0.0, 0.2, 0.0]
up = [0.0, 1.0, 0.0]
vfov = 48.0

[mesh]
obj = "quads.obj"
mtl = "quads.mtl"

[[mesh.materials]]   # glow
id = 3
emission = [1.0, 0.8, 0.5]
emission_strength = 3.0

[[spheres]]   # ground
center = [0, -500.0, 0]
radius = 498.5
diffuse = [0.5, 0.55, 0.5]

[[spheres]]   # sun
center = [6.0, 10.0, 5.0]
radius = 2.0
emission = [1.0, 0.98, 0.9]
emission_strength = 30.0

[[spheres]]   # sky dome
center = [0.0, 0.0, 0.0]
radius = 100.0
emission = [0.784, 0.965, 1.0]
emission_strength = 1.0
"""
QUAD_MATERIALS = (("red", (0.8, 0.3, 0.25), True), ("blue", (0.25, 0.35, 0.8), True),
                  ("grey", (0.6, 0.6, 0.6), False), ("glow", (0.95, 0.8, 0.45), False))


def write_quad_fixture(directory: str, seed: int = 0, n_boxes: int = 24,
                       n_aa: int = 12, n_quads: int = 80,
                       n_left: int = 80) -> str:
    """Write a mesh fixture that reaches every branch of K3's merged-quad
    search (OBJ, MTL, 16x16 PPM textures, TOML) into ``directory`` and
    return the TOML's path; everything is made from ``seed`` with numpy.

    The block world's faces are all axis-aligned rects; this adds what it
    lacks. ``n_boxes`` boxes give rects in all six (normal axis, sign)
    groups, their corners and the triangles' first vertices rotated in
    turn, so both edge orientations (m) and every opposite-vertex slot
    (oi) occur; ``n_aa`` single triangles in axis planes are unpaired
    axis-aligned triangles; ``n_quads`` tilted parallelograms (more than
    64, so the search's chunk cull runs on them; the first has a
    different material on each half) and ``n_left`` tilted single
    triangles (also more than 64) are the general loops' candidates.
    Coordinates are multiples of 1/64 below 4, exact in f32, so every
    parallelogram closes exactly and is detected."""
    from raytpu_torch.io.ppm import write_ppm

    rs = np.random.default_rng(seed)
    grid = lambda v: np.round(np.asarray(v, np.float64) * 64.0) / 64.0
    faces = {m: [] for m in range(len(QUAD_MATERIALS))}   # material -> [tri]
    turn = [0]

    def rect(m, p0, e1, e2, m2=None):
        """Rect / parallelogram p0, p0+e1, p0+e1+e2, p0+e2 (normal e1 x e2)
        as two triangles, its corners rotated by the running turn and
        each triangle's vertices rotated too."""
        c = [p0, p0 + e1, p0 + e1 + e2, p0 + e2]
        r = turn[0] % 4
        c = c[r:] + c[:r]
        for t, mat in (((c[0], c[1], c[2]), m),
                       ((c[0], c[2], c[3]), m if m2 is None else m2)):
            k = (turn[0] + (mat != m)) % 3
            faces[mat].append(t[k:] + t[:k])
        turn[0] += 1

    for b in range(n_boxes):
        lo = grid(rs.uniform(-2.5, 2.0, 3) * [1.0, 0.5, 1.0])
        size = grid(rs.uniform(0.2, 0.6, 3))
        m = b % 3
        x, y, z = np.eye(3) * size
        for p0, e1, e2 in ((lo, y, z), (lo + x, z, y), (lo, z, x),
                           (lo + y, x, z), (lo, x, y), (lo + z, y, x)):
            rect(m, p0, e1, e2)
        turn[0] += 1     # 7 turns a box: each face takes every rotation
    for t in range(n_aa):
        k = t % 3
        p = grid(rs.uniform(-2.5, 2.5, (3, 3)))
        p[:, k] = p[0, k]                       # one plane of axis k
        faces[t % 3].append(tuple(p) if t % 2 else tuple(p[::-1]))
    for q in range(n_quads):
        p0 = grid(rs.uniform(-2.5, 2.5, 3))
        e1, e2 = (grid(rs.uniform(-0.5, 0.5, 3)) for _ in range(2))
        rect(q % 3, p0, e1, e2, m2=3 if q == 0 else None)
    for t in range(n_left):
        p0 = grid(rs.uniform(-2.5, 2.5, 3))
        faces[(t + 1) % 3].append((p0, p0 + grid(rs.uniform(-0.5, 0.5, 3)),
                                   p0 + grid(rs.uniform(-0.5, 0.5, 3))))

    os.makedirs(os.path.join(directory, "tex"), exist_ok=True)
    obj = ["# K3 merged-search fixture", "mtllib quads.mtl",
           "vt 0 0", "vt 1 0", "vt 1 1"]
    mtl = []
    n_v = 0
    for slot, (name, base, textured) in enumerate(QUAD_MATERIALS):
        obj.append(f"usemtl {name}")
        for tri in faces[slot]:
            obj += ["v %.6f %.6f %.6f" % tuple(v) for v in tri]
            obj.append(f"f {n_v + 1}/1 {n_v + 2}/2 {n_v + 3}/3")
            n_v += 3
        mtl += [f"newmtl {name}", "Kd %.3f %.3f %.3f" % base, "d 1.0"]
        if textured:
            mtl.append(f"map_Kd tex/{name}.png")   # read as tex/<name>.ppm
            shade = np.asarray(base) * rs.uniform(0.5, 1.0, (16, 16, 1))
            write_ppm(os.path.join(directory, "tex", f"{name}.ppm"),
                      np.rint(255 * shade).astype(np.int64))
    with open(os.path.join(directory, "quads.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")
    with open(os.path.join(directory, "quads.mtl"), "w") as f:
        f.write("\n".join(mtl) + "\n")
    path = os.path.join(directory, "quads.toml")
    with open(path, "w") as f:
        f.write(_QUAD_TOML.format(seed=seed, n_tris=n_v // 3, n_boxes=n_boxes,
                                  n_aa=n_aa, n_quads=n_quads, n_left=n_left))
    return path


MESH_FORMATS = ("ply", "glb", "stl")


def _corners(mesh, faces: np.ndarray):
    """Positions (3F, 3) and UVs (3F, 2) of the faces' corners, in face
    order (a missing UV index reads (0, 0), as ``io.obj`` does)."""
    pos = mesh.vertices[mesh.face_v[faces]].reshape(-1, 3)
    ft = mesh.face_t[faces]
    uv = (np.where(ft[..., None] >= 0,
                   mesh.uvs[np.clip(ft, 0, len(mesh.uvs) - 1)], 0.0)
          if len(mesh.uvs) else np.zeros(ft.shape + (2,)))
    return pos.astype("<f4"), uv.reshape(-1, 2).astype("<f4")


def _write_ply(path: str, mesh) -> None:
    """Binary little-endian PLY: a vertex (x y z s t) per face corner."""
    pos, uv = _corners(mesh, np.arange(len(mesh.face_v)))
    n_f = len(mesh.face_v)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {3 * n_f}\n"
            + "".join(f"property float {c}\n" for c in "xyzst")
            + f"element face {n_f}\n"
            "property list uchar int vertex_indices\nend_header\n")
    faces = np.zeros(n_f, [("n", "u1"), ("v", "<i4", 3)])
    faces["n"] = 3
    faces["v"] = np.arange(3 * n_f).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(np.concatenate([pos, uv], 1).astype("<f4").tobytes())
        f.write(faces.tobytes())


def _write_stl(path: str, mesh) -> None:
    """Binary STL (no UVs, no materials), its header starting "solid"."""
    pos, _ = _corners(mesh, np.arange(len(mesh.face_v)))
    rec = np.zeros(len(mesh.face_v), [("n", "<f4", 3), ("v", "<f4", 9),
                                      ("attr", "<u2")])
    rec["v"] = pos.reshape(-1, 9)
    with open(path, "wb") as f:
        f.write(b"solid binary STL from raytpu_torch".ljust(80, b"\0"))
        f.write(np.uint32(len(rec)).astype("<u4").tobytes() + rec.tobytes())


def _write_glb(path: str, mesh) -> None:
    """GLB: one triangle primitive a material slot (positions,
    TEXCOORD_0, u32 indices; faces before any material first, without a
    material), one node, the slots' names as materials."""
    import json
    import struct

    blob, views, accessors, prims = bytearray(), [], [], []

    def add(arr, kind, comp):
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": comp, "count": len(arr),
                          "type": kind})
        blob.extend(arr.tobytes())
        return len(accessors) - 1

    for slot in range(-1, len(mesh.mat_names)):
        faces = np.flatnonzero(mesh.face_mat == slot)
        if faces.size == 0:
            continue
        pos, uv = _corners(mesh, faces)
        p = add(pos, "VEC3", 5126)
        accessors[p].update(min=pos.min(0).tolist(), max=pos.max(0).tolist())
        prim = {"attributes": {"POSITION": p, "TEXCOORD_0": add(uv, "VEC2", 5126)},
                "indices": add(np.arange(len(pos), dtype="<u4"), "SCALAR", 5125)}
        if slot >= 0:
            prim["material"] = slot
        prims.append(prim)
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": prims}],
            "materials": [{"name": n} for n in mesh.mat_names],
            "accessors": accessors, "bufferViews": views,
            "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))


def write_obj(path: str, mesh) -> None:
    """An OBJ of ``io.obj.ObjMesh`` ``mesh`` that parses back to the same
    arrays: faces before any material first, then a ``usemtl`` a slot
    (``mesh.face_mat`` must not decrease), a corner's UV index written
    only where it has one."""
    if (np.diff(mesh.face_mat) < 0).any():
        raise ValueError(f"{path}: faces are not grouped by material slot")
    num = lambda v: repr(float(v))    # exact for f32 values
    lines = [f"v {num(a)} {num(b)} {num(c)}" for a, b, c in mesh.vertices]
    lines += [f"vt {num(a)} {num(b)}" for a, b in mesh.uvs]
    corner = lambda v, t: f"{v + 1}/{t + 1}" if t >= 0 else f"{v + 1}"
    for slot in range(-1, len(mesh.mat_names)):
        if slot >= 0:
            lines.append(f"usemtl {mesh.mat_names[slot]}")
        for fv, ft in zip(mesh.face_v[mesh.face_mat == slot],
                          mesh.face_t[mesh.face_mat == slot]):
            lines.append("f " + " ".join(map(corner, fv, ft)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _spec(text: str, obj: str, materials: bool) -> str:
    """A TOML scene spec's text with its mesh file replaced by ``obj``;
    without ``materials`` also without its MTL and material overrides."""
    out, keep = [], True
    for line in text.splitlines():
        if line.startswith("["):
            keep = materials or not line.startswith("[[mesh.materials]]")
        if line.startswith("obj = "):
            line = f'obj = "{obj}"'
        elif line.startswith("mtl = ") and not materials:
            continue
        if keep:
            out.append(line)
    return "\n".join(out) + "\n"


def write_mesh_twins(toml_path: str, formats=MESH_FORMATS) -> dict:
    """Beside a mesh scene spec (``write_block_world``'s), write its mesh
    in each of ``formats`` (binary PLY with UVs, GLB, binary STL) and an
    OBJ twin of each, written from the arrays that format parses to
    (``io.mesh_formats``), with a TOML for each file: the spec with its
    mesh replaced, its material overrides and MTL kept for GLB and
    dropped for PLY and STL, which carry no materials. Returns {format:
    (its TOML, its twin's TOML)}: the two scenes are identical."""
    from raytpu_torch.io.mesh_formats import parse_mesh
    from raytpu_torch.io.obj import parse_obj

    base = os.path.dirname(toml_path)
    text = open(toml_path).read()
    src = [ln for ln in text.splitlines() if ln.startswith("obj = ")][0]
    mesh = parse_obj(os.path.join(base, src.split('"')[1]))
    writers = {"ply": _write_ply, "glb": _write_glb, "stl": _write_stl}
    stem = os.path.splitext(os.path.basename(toml_path))[0]
    out = {}
    for fmt in formats:
        name = f"{stem}_{fmt}"
        writers[fmt](os.path.join(base, f"{name}.{fmt}"), mesh)
        write_obj(os.path.join(base, f"{name}_twin.obj"),
                  parse_mesh(os.path.join(base, f"{name}.{fmt}")))
        tomls = []
        for obj in (f"{name}.{fmt}", f"{name}_twin.obj"):
            path = os.path.join(base, os.path.splitext(obj)[0] + ".toml")
            with open(path, "w") as f:
                f.write(_spec(text, obj, fmt == "glb"))
            tomls.append(path)
        out[fmt] = tuple(tomls)
    return out


def equirect_sky(width: int, height: int, seed: int = 0) -> np.ndarray:
    """A procedural equirect sky, (height, width, 3) int64 samples in
    0..255 with row 0 at the top (the zenith): a sky gradient above the
    horizon and ground below it, in 10-degree bands of elevation and
    30-degree stripes of longitude, a sun disc, and noise on every texel,
    so that a texel index off by one row or column changes the colour."""
    rs = np.random.default_rng([seed, width, height])
    v = (np.arange(height) + 0.5) / height                # 0 at the top
    u = (np.arange(width) + 0.5) / width
    elev = (90.0 - 180.0 * v)[:, None, None]              # degrees
    lon = 360.0 * u[None, :, None]
    up = np.clip(elev / 90.0, 0.0, 1.0)
    sky = (1 - up) * np.array([205, 222, 240]) + up * np.array([55, 115, 215])
    ground = np.array([112, 96, 70]) * (1.0 + np.clip(elev / 90.0, -1.0, 0.0) * 0.5)
    img = np.where(elev >= 0.0, sky, ground)
    img = img + 10.0 * (np.floor(elev / 10.0) % 2) + 6.0 * (np.floor(lon / 30.0) % 2)
    sun_lon, sun_elev = 110.0, 35.0
    dist = np.hypot((lon - sun_lon) * np.cos(np.radians(elev)), elev - sun_elev)
    img = np.where(dist < 4.0, np.array([255, 245, 210]), img)
    img = img + rs.integers(-12, 13, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.int64)


def write_equirect_sky(path: str, width: int, height: int,
                       seed: int = 0) -> str:
    """Write ``equirect_sky(width, height, seed)`` as a P3 PPM at ``path``
    (read back bottom-up by ``io.obj.load_sky``) and return the path."""
    from raytpu_torch.io.ppm import write_ppm

    write_ppm(path, equirect_sky(width, height, seed))
    return path


_SKY_TOML = """\
# scenes/sky.toml's equirect sky showcase, its spheres, camera and render
# settings, under a procedural {w}x{h} sky written by
# raytpu_torch.scenes.write_sky_showcase(seed={seed}): mirror, glass and
# marble spheres on a pale ground, lit only by the sky sphere.
[render]
width = 1000
height = 750
spp = 200
bounces = 4

[camera]
origin = [0.0, 0.6, 3.2]
target = [0.0, 0.3, -2.0]
up = [0.0, 1.0, 0.0]
vfov = 55.0

[sky]
file = "sky.ppm"
# sphere_index defaults to the last sphere (the reference's convention)

[[spheres]]   # pale ground
center = [0, -500.5, 0]
radius = 500.0
diffuse = [0.95, 0.86, 0.95]

[[spheres]]   # big mirror ball
center = [-0.9, 0.35, -2.0]
radius = 0.85
diffuse = [0.92, 0.96, 1.0]
reflection = 0.97

[[spheres]]   # glass ball
center = [0.9, 0.1, -1.4]
radius = 0.6
diffuse = [1.0, 1.0, 1.0]
reflection = 0.2
alpha = 0.1
ior = 1.5

[[spheres]]   # small blue marble
center = [0.1, -0.2, -0.7]
radius = 0.3
diffuse = [0.35, 0.45, 1.0]
reflection = 0.6

[[spheres]]   # sky sphere (last = ciel): pure emitter, texel-driven
center = [0, 0, 0]
radius = 1000.0
diffuse = [0.0, 0.0, 0.0]
emission = [1.0, 1.0, 1.0]
emission_strength = 1.0
"""


def write_sky_showcase(directory: str, sky_size=(4096, 2048),
                       seed: int = 0) -> str:
    """Write ``scenes/sky.toml``'s scene (5 spheres, 1000x750, 4 bounces)
    with its ``[sky]`` pointing at a generated ``sky.ppm`` of ``sky_size``
    (width, height; the reference's MinecraftSkyDay is 4096x2048) into
    ``directory``; return the TOML's path."""
    os.makedirs(directory, exist_ok=True)
    w, h = sky_size
    write_equirect_sky(os.path.join(directory, "sky.ppm"), w, h, seed)
    path = os.path.join(directory, "sky.toml")
    with open(path, "w") as f:
        f.write(_SKY_TOML.format(w=w, h=h, seed=seed))
    return path


def mesh_branch_scene(device=None) -> tuple[Scene, Camera, RenderConfig]:
    """Two textured quads (4 triangles, 2 materials, an 8x8 atlas) over
    ground, sun and sky-dome spheres: ``tests/test_mesh_megakernel``'s
    synthetic scene in the port's types. Its atlas alpha holds cutout
    (0), refraction-window (0.5) and opaque (1) texels, and material 1
    is emissive with texture-modulated emission, so every shading branch
    of a triangle hit runs."""
    from raytpu_torch.core.types import MatTable, TextureAtlas, Triangles

    device = resolve_device(device)
    rs = np.random.default_rng(7)
    w = h = 8
    rgb = rs.random((2 * h * w, 3), np.float32)
    alpha = rs.choice(np.float32([0.0, 0.5, 1.0]), size=2 * h * w,
                      p=[0.2, 0.2, 0.6])

    def quad(x0, z0):
        # two triangles spanning [x0, x0+1] x [z0, z0+1], rising to y=0.5
        return ([(x0, 0.0, z0), (x0, 0.5, z0 + 1), (x0 + 1, 0.0, z0)],
                [(x0 + 1, 0.5, z0 + 1), (x0 + 1, 0.0, z0), (x0, 0.5, z0 + 1)])

    t = np.float32([*quad(-1.0, -2.5), *quad(0.2, -2.0)])        # (4, 3, 3)
    u = np.float32([[(0, 0), (0, 1), (1, 0)], [(1, 1), (1, 0), (0, 1)]] * 2)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    v3 = lambda a: Vec3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))
    tris = Triangles(v3(t[:, 0]), v3(t[:, 1]), v3(t[:, 2]),
                     *(f(u[:, i, j]) for i in range(3) for j in range(2)),
                     mat_id=f(np.int32([0, 0, 1, 1])))
    atlas = TextureAtlas(v3(rgb), f(alpha), w, h)
    table = MatTable.from_arrays([(0, 0, 0), (1, 1, 0.8)], [0.0, 2.0],
                                 [0.3, 0.0], [1.33, 1.0], [1.0, 1.0],
                                 [False, False], [False, True], device)
    rows = [
        ((0, -501, 0), 500.0, (0.8, 0.8, 0.75), BLACK, 0.0, 0.0, 1.0, 1.0),
        ((4, 6, 2), 1.0, BLACK, WHITE, 20.0, 0.0, 1.0, 1.0),
        ((0, 0, 0), 1e4, BLACK, SKY, 1.0, 0.0, 1.0, 1.0),
    ]
    scene = Scene(spheres_from_rows(rows, device), tris, atlas, table)
    cam = make_camera(origin=(0.3, 0.8, 1.5), target=(0, 0.2, -2),
                      up=(0, 1, 0), vfov_deg=55.0, aspect_ratio=1.5,
                      device=device)
    return scene, cam, RenderConfig(width=14, height=10, spp=4, max_bounces=5)
