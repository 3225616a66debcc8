"""The port's mesh scene pipeline against raytpu's.

``raytpu_torch.scenes.write_block_world`` writes a procedural block world
in the reference's file formats (OBJ, MTL, P3 PPM tiles with an
``_alpha.ppm`` companion, TOML); ``raytpu.config.load_scene_file`` and the
port's loader read the same files and must give exactly the same arrays:
Morton-ordered triangles, the texture atlas, the material table, the
camera and the config fields (``raytpu``'s merged-quad tables aside: the
port does not detect quads). The loader's pieces (OBJ parsing, the atlas
collapse, solid tiles, the PPM-only texture route) are compared on their
own.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.io import obj as jobj
from raytpu_torch import config as tconfig
from raytpu_torch.io import image as timage
from raytpu_torch.io import obj as tobj
from raytpu_torch.scenes import BLOCK_MATERIALS, BLOCK_TILE, write_block_world

# raytpu leaves the port does not hold: the u8-packed twins of the atlas
# and the sky (the port keeps the f32 texels they unpack to)
NOT_PORTED = ("atlas.packed", "sky.packed")
QUAD_FIELDS = ("quad_pairs", "quad_aa_rects", "quad_aa_tris")


def _jarrays(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaf(obj, path: str) -> np.ndarray:
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj.detach().cpu().numpy()


def _assert_same_scene(tscene, jscene):
    """Every raytpu leaf the port holds, bit for bit and in dtype."""
    arrays = _jarrays(jscene)
    checked = 0
    for path, want in arrays.items():
        if path.startswith(NOT_PORTED):
            continue
        got = _leaf(tscene, path)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        checked += 1
    assert checked == len(arrays) - 1      # atlas.packed
    assert (tscene.atlas.width, tscene.atlas.height) == (
        jscene.atlas.width, jscene.atlas.height)
    assert tscene.sky_sphere_index == jscene.sky_sphere_index == -1


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """TOML paths of a small (60-triangle) and the 600-triangle world."""
    base = tmp_path_factory.mktemp("block_world")
    return {n: write_block_world(str(base / f"w{n}"), n_triangles=n, seed=s)
            for n, s in ((60, 3), (600, 0))}


@pytest.mark.parametrize("n", [60, 600])
def test_loader_matches_raytpu(worlds, n):
    jscene, jcam, jcfg = jconfig.load_scene_file(worlds[n])
    tscene, tcam, tcfg = tconfig.load_scene_file(worlds[n], device="cpu")
    assert tscene.triangles.count == jscene.triangles.count == n
    _assert_same_scene(tscene, jscene)
    for path, want in _jarrays(jcam).items():
        np.testing.assert_array_equal(_leaf(tcam, path), want, err_msg=path)
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    # both detect the same quad pairs for K3's merged search
    assert tcfg.quad_pairs and all(
        getattr(tcfg, f) == getattr(jcfg, f) for f in QUAD_FIELDS)


def test_load_obj_scene_matches_raytpu(worlds):
    d = os.path.dirname(worlds[60])
    obj, mtl = (os.path.join(d, f"block_world.{e}") for e in ("obj", "mtl"))
    jscene = jobj.load_obj_scene(obj, mtl, translate=(0.5, -1.0, 2.0))
    tscene = tobj.load_obj_scene(obj, mtl, translate=(0.5, -1.0, 2.0),
                                 device="cpu")
    _assert_same_scene(tscene, jscene)


def test_block_world_shape(worlds, tmp_path):
    """The world has mcworld's shape: 11 materials of 16x16 random texels
    (nothing to collapse), water at alpha .6 / ior 1.33 / refl .93 in
    slots 6 and 7, a glass tile whose alpha holds cutout, window and
    opaque texels, an emissive slot lit by its texels, ground / sun /
    sky-dome spheres, 1200x900 at 6 bounces; 2048 triangles also fit."""
    scene, _, cfg = tconfig.load_scene_file(worlds[600], device="cpu")
    assert (cfg.width, cfg.height, cfg.max_bounces) == (1200, 900, 6)
    assert scene.spheres.count == 3
    m = scene.mat_table
    assert m.count == len(BLOCK_MATERIALS) == 11
    assert scene.atlas.count == 11
    assert (scene.atlas.width, scene.atlas.height) == (BLOCK_TILE, BLOCK_TILE)
    for slot in (6, 7):
        assert bool(m.use_alpha_const[slot])
        np.testing.assert_allclose(
            [m.alpha_const[slot], m.ior[slot], m.reflection[slot]],
            [0.6, 1.33, 0.93], rtol=1e-6)
    assert bool(m.emission_from_texture[9]) and m.emission_strength[9] > 0
    assert set(np.unique(scene.triangles.mat_id.numpy())) == set(range(11))
    tile = BLOCK_TILE * BLOCK_TILE
    glass = scene.atlas.alpha[8 * tile:9 * tile].numpy()
    assert set(np.unique(glass)) == {0.0, np.float32(128) * np.float32(1 / 255), 1.0}
    big = write_block_world(str(tmp_path), n_triangles=2048)
    assert tconfig.load_scene_file(big, device="cpu")[0].triangles.count == 2048
    with pytest.raises(ValueError, match="even"):
        write_block_world(str(tmp_path), n_triangles=61)


OBJ_TEXT = """\
# faces before any usemtl clamp to slot 0
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
usemtl red
f 1/1 2/2 3/3 4/4
usemtl blue
f 1//1 2//1 3//1 5//1 4//1
usemtl red
f 2 3 5
"""


def test_parse_obj_matches_raytpu(tmp_path):
    """Fan triangulation of quads and pentagons, v, v/t, v//n and v/t/n
    indices, faces before any usemtl, and a repeated usemtl name (its own
    slot)."""
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT)
    want = jobj.parse_obj(str(path), use_native=False)
    got = tobj.parse_obj(str(path))
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.face_mat.tolist() == [-1, 0, 0, 1, 1, 1, 2]
    assert got.mat_names == ["red", "blue", "red"]
    tris = tobj.mesh_to_triangles(got, device="cpu")
    assert tris.mat_id.tolist() == [0, 0, 0, 1, 1, 1, 2]
    jtris = jobj.mesh_to_triangles(want)
    for path_, arr in _jarrays(jtris).items():
        np.testing.assert_array_equal(_leaf(tris, path_), arr, err_msg=path_)


@pytest.mark.parametrize("h,w,k", [(16, 16, 1), (16, 16, 4), (12, 8, 2),
                                   (30, 45, 15)])
def test_collapse_factor_matches_raytpu(h, w, k):
    rs = np.random.default_rng(h * w + k)
    small = rs.integers(0, 4, (3, h // k, w // k, 3)).astype(np.float32)
    tiles = [np.repeat(np.repeat(t, k, 0), k, 1) for t in small]
    alpha = [t[..., 0] for t in tiles]
    want = jobj.collapse_factor(tiles + alpha, h, w)
    assert tobj.collapse_factor(tiles + alpha, h, w) == want
    assert want % k == 0 and want >= k


def test_build_atlas_solid_tiles_match_raytpu(worlds):
    """Untextured slots become solid tiles of their Kd and d on the u8
    lattice, sized like the textured ones; without any texture, 1x1."""
    tex = os.path.join(os.path.dirname(worlds[60]), "tex", "grass.png")
    cases = [
        ([None, tex, None], [(0.2, 0.5, 0.9), None, None], [0.5, None, None]),
        ([None, None], [(0.3, 0.3, 0.3), None], [None, 0.25]),
    ]
    for paths, colors, alphas in cases:
        want = jobj.build_atlas(paths, colors, alphas)
        got = tobj.build_atlas(paths, colors, alphas, device="cpu")
        assert (got.width, got.height) == (want.width, want.height)
        for c in "xyz":
            np.testing.assert_array_equal(getattr(got.rgb, c).numpy(),
                                          np.asarray(getattr(want.rgb, c)))
        np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(want.alpha))


def test_png_textures_raise(tmp_path, monkeypatch):
    """A PNG texture needs PIL: without it (the card's machine) a PNG
    with no PPM beside it raises an ImportError that names PIL and the
    .ppm alternative, and so do PNG images handed to the image loaders;
    a missing texture raises FileNotFoundError. PNG reads with PIL are
    tests/test_torch_png.py's."""
    png = tmp_path / "t.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for call in (lambda: timage.load_texture_pair(str(png)),
                 lambda: timage.load_rgb(str(png)),
                 lambda: timage.load_gray(str(png)),
                 lambda: tobj.build_atlas([str(png)], device="cpu")):
        with pytest.raises(ImportError, match=r"PIL.*\.ppm"):
            call()
    with pytest.raises(FileNotFoundError):
        timage.load_texture_pair(str(tmp_path / "missing.png"))


def test_texture_pair_reads_alpha_companion(tmp_path):
    from raytpu.io.image import load_texture_pair as j_pair
    from raytpu_torch.io.ppm import write_ppm

    rs = np.random.default_rng(4)
    rgb = rs.integers(0, 256, (5, 7, 3))
    write_ppm(str(tmp_path / "t.ppm"), rgb)
    for with_alpha in (False, True):
        if with_alpha:
            write_ppm(str(tmp_path / "t_alpha.ppm"), rs.integers(0, 256, (5, 7, 3)))
        want = j_pair(str(tmp_path / "t.png"))
        got = timage.load_texture_pair(str(tmp_path / "t.png"))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 4, 11])
def test_material_tables_match_raytpu(n):
    """The default table and the reference's hardcoded overrides
    (texture.h:71-88: emissive id 1, glass id 3, water id 4)."""
    from raytpu.core.types import MatTable as JMatTable
    from raytpu_torch.core.types import MatTable as TMatTable

    for make in ("default", "reference_overrides"):
        want = getattr(JMatTable, make)(n)
        got = getattr(TMatTable, make)(n, "cpu")
        assert got.count == n
        for path, arr in _jarrays(want).items():
            got_arr = _leaf(got, path)
            assert got_arr.dtype == arr.dtype, (make, path)
            np.testing.assert_array_equal(got_arr, arr, err_msg=f"{make} {path}")


def test_unported_spec_parts_raise(worlds, tmp_path):
    """A mesh of another suffix goes to its importer (io.mesh_formats,
    tests/test_torch_mesh_formats.py): a missing .ply raises there."""
    text = open(worlds[60]).read()
    ply = tmp_path / "ply.toml"
    ply.write_text(text.replace('obj = "block_world.obj"', 'obj = "m.ply"'))
    with pytest.raises(FileNotFoundError, match="m.ply"):
        tconfig.load_scene_file(str(ply), device="cpu")
    with pytest.raises(ValueError, match="unknown scene"):
        tconfig.load_scene("no_such_scene", device="cpu")


def test_meshes_array_concatenates(worlds, tmp_path):
    """[[meshes]]: two copies of the world, the second translated, with
    per-mesh material offsets and one atlas over both."""
    d = os.path.dirname(worlds[60])
    spec = open(worlds[60]).read().split("[mesh]")[0]
    spec += "".join(
        f'[[meshes]]\nobj = "{d}/block_world.obj"\nmtl = "{d}/block_world.mtl"\n'
        f"translate = [{x}, 0.0, 0.0]\n" for x in (0.0, 3.0))
    path = tmp_path / "two.toml"
    path.write_text(spec)
    jscene, _, _ = jconfig.load_scene_file(str(path))
    tscene, _, _ = tconfig.load_scene_file(str(path), device="cpu")
    assert tscene.triangles.count == 120 and tscene.mat_table.count == 22
    _assert_same_scene(tscene, jscene)
    ids = set(torch.unique(tscene.triangles.mat_id).tolist())
    assert {i for i in ids if i >= 11} == {i + 11 for i in ids if i < 11}
