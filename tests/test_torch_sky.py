"""The port's equirect sky against raytpu's, on the CPU.

Skies are generated with numpy (``scenes.equirect_sky``; 16x8 and 64x32
texels) or taken from ``tests/test_sky.py``'s ``_sky_scene``; rays,
draws and cotangents come from numpy seeds and go to both packages.
Tolerances:

* texel indices (``sky_texel_index``): equal on at least 99.9% of random
  directions, and where they differ u*w or v*h lies within 1e-5 of an
  integer (XLA's and torch's acos/atan2 round an ulp apart there); the
  signed zeros and the poles exactly;
* loaders: arrays bit for bit;
* forward planes, the sky slot's seven among them: a ray is an outlier if
  any channel differs by more than 1e-4 + 1e-5|x|, at most 2% may be
  (``tests/test_megakernel._compare``); recorded winners equal on at
  least 98% of the (ray, bounce) entries;
* K2's sky cotangent: each leaf (a row of a table) within 1e-3 of its
  largest |entry|, floored at 1e-6 of its table's largest; ray
  cotangents at most 2% outliers at 1e-4 + 1e-4|x|;
* render gradients: ``test_torch_grad``'s |port - raytpu| <= 1e-3|raytpu|
  + 1e-5 (the leaf's largest |gradient|) + 1e-8;
* sky-texel gradients within 5% of central differences.

Mesh scenes are the 60-triangle block world with ``sky=``, its dome
(the sky sphere) shrunk to radius 100 on both sides where winners are
compared (``test_torch_mesh_grad``), and raytpu's scan runs under
``jax.disable_jit`` on meshes (ROADMAP F7).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.types import SkyTexture as JSky
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator import render as jrender
from raytpu.integrator.path import n_bounce_draws
from raytpu.integrator.path import trace as jtrace
from raytpu.io.obj import load_sky as j_load_sky
from raytpu.kernels import trace_scene as jtsc
from raytpu.kernels import trace_spheres as jts
from raytpu.kernels.trace_scene_bwd import mesh_backward as j_mesh_backward
from raytpu.materials.texture import sky_texel_index as j_texel_index
from raytpu.train import combine_scene as j_combine
from raytpu.train import make_train_step as j_make_train_step
from raytpu.train import partition_scene as j_partition
from raytpu_torch import cli, convert
from raytpu_torch import config as tconfig
from raytpu_torch.camera import make_camera as t_make_camera
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.types import TextureAtlas as TAtlas
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator.render import render as t_render
from raytpu_torch.io.obj import load_sky as t_load_sky
from raytpu_torch.io.ppm import read_ppm
from raytpu_torch.kernels import trace_scene as ttsc
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.kernels import trace_spheres as tts
from raytpu_torch.materials.texture import sky_texel_index as t_texel_index
from raytpu_torch.scenes import (write_block_world, write_equirect_sky,
                                 write_sky_showcase)
from raytpu_torch.train import make_train_step as t_make_train_step
from raytpu_torch.train import partition_scene as t_partition
from tests.test_sky import _sky_scene

ATOL, RTOL, OUTLIER_FRAC, IDX_AGREE = 1e-4, 1e-5, 0.02, 0.98
TEXEL_AGREE, SEAM = 0.999, 1e-5
ROW_REL, TABLE_FLOOR = 1e-3, 1e-6
G_ATOL, G_RTOL = 1e-4, 1e-4
GRAD_RTOL, GRAD_SCALE, GRAD_ATOL = 1e-3, 1e-5, 1e-8
FD_REL = 0.05
DOME_RADIUS = 100.0


def _arrays(tree, **static):
    d = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    d.update(static)
    return d


def _convert(js):
    """raytpu scene -> the port's, on the CPU."""
    return convert.scene_from_arrays(_arrays(
        js, sky_sphere_index=js.sky_sphere_index,
        **{"atlas.width": js.atlas.width, "atlas.height": js.atlas.height,
           "sky.width": js.sky.width, "sky.height": js.sky.height}),
        device="cpu")


def _cfg(jcfg) -> TConfig:
    return TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """TOMLs: the showcase under a 16x8 sky, and the 60-triangle block
    world with a 16x8 sky."""
    base = tmp_path_factory.mktemp("sky")
    show = write_sky_showcase(str(base / "show"), (16, 8), seed=1)
    bw = str(base / "bw")
    os.makedirs(bw)
    write_equirect_sky(os.path.join(bw, "sky.ppm"), 16, 8, seed=2)
    world = write_block_world(bw, n_triangles=60, seed=3, sky="sky.ppm")
    return {"show": show, "world": world}


def _small_dome(js, ts):
    """The block world's sky dome (its last sphere) at radius 100 on both
    sides."""
    i = ts.spheres.count - 1
    r = ts.spheres.radius.clone()
    r[i] = DOME_RADIUS
    return (js.replace(spheres=js.spheres.replace(
                radius=js.spheres.radius.at[i].set(DOME_RADIUS))),
            dataclasses.replace(ts, spheres=dataclasses.replace(
                ts.spheres, radius=r)))


def _scene(files, name):
    """(raytpu scene, camera, port scene, camera, raytpu config)."""
    if name == "sky_scene":
        from raytpu.camera import make_camera

        js = _sky_scene()
        kw = dict(origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
                  vfov_deg=60.0, aspect_ratio=1.5)
        return (js, make_camera(**kw), _convert(js),
                t_make_camera(**kw, device="cpu"),
                JConfig(width=12, height=8, spp=2, max_bounces=3))
    path = files["world" if name == "world" else "show"]
    js, jc, jcfg = jconfig.load_scene_file(path)
    ts, tc, _ = tconfig.load_scene_file(path, device="cpu")
    if name == "world":
        js, ts = _small_dome(js, ts)
        jcfg = jcfg.replace(merge_quads=False)
    return js, jc, ts, tc, jcfg.replace(width=12, height=8, spp=2,
                                        max_bounces=4)


def _inputs(jcam, cfg, seed):
    """Camera rays and (bounces, draws, B) draws from a numpy seed, as
    raytpu arrays and port tensors."""
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = jrender.sample_rays(jcam, cfg, jnp.arange(b, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    t = lambda v: tuple(torch.tensor(np.asarray(c)) for c in v)
    return (o, d, jnp.asarray(draws)), (*t(o), *t(d)), torch.tensor(draws)


def _planes(vecs) -> np.ndarray:
    """raytpu's (Vec3 | plane, ...) outputs as one (P, B) array."""
    rows = []
    for v in vecs:
        rows += [np.asarray(c) for c in v] if isinstance(v, JVec3) else [
            np.asarray(v)]
    return np.stack(rows)


def _assert_planes(got, want, what):
    got = np.asarray(got)
    assert np.isfinite(got).all(), what
    bad = (np.abs(got - want) > ATOL + RTOL * np.abs(want)).any(0)
    assert bad.mean() <= OUTLIER_FRAC, (
        f"{what}: {bad.mean():.2%} rays differ (max "
        f"{np.abs(got - want).max():.3e})")


# ---- sky_texel_index -----------------------------------------------------

def _directions(n, seed, w, h):
    """Seeded unit directions, then the poles, the four signed-zero
    combinations of the horizontal axes and directions on texel seams."""
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    special = [(0, 1, 0), (0, -1, 0), (-1, 0, 0.0), (-1, 0, -0.0),
               (1, 0, 0.0), (1, 0, -0.0), (0.0, 0, 1), (-0.0, 0, -1)]
    seams = []
    for k in range(w + 1):
        phi = 2 * np.pi * k / w - np.pi        # u * w == k exactly
        for j in range(1, h):
            theta = np.pi * j / h               # v * h == j exactly
            s = np.sin(theta)
            seams.append((s * np.cos(phi), -np.cos(theta), -s * np.sin(phi)))
    return np.concatenate([d, np.array(special).T, np.array(seams).T],
                          axis=1).astype(np.float32)


def _uv_times_size(d, w, h):
    """u*w and v*h in float64 from the f32 direction."""
    d = d.astype(np.float64)
    theta = np.arccos(np.clip(-d[1], -1, 1))
    phi = np.arctan2(-d[2], d[0]) + np.pi
    return phi / (2 * np.pi) * w, theta / np.pi * h


@pytest.mark.parametrize("w,h", [(16, 8), (64, 32)])
def test_sky_texel_index_matches_raytpu(w, h):
    d = _directions(20000, w, w, h)
    want = np.asarray(j_texel_index(JVec3(*map(jnp.asarray, d)), w, h))
    got = t_texel_index(TVec3(*map(torch.tensor, d)), w, h)
    assert got.dtype == torch.int64
    got = got.numpy()
    assert ((got >= 0) & (got < w * h)).all()
    same = got == want
    n = 20000                      # the random ones; seams may round apart
    assert same[:n].mean() >= TEXEL_AGREE, f"{same[:n].mean():.5f}"
    uw, vh = _uv_times_size(d, w, h)
    near = lambda x: np.abs(x - np.rint(x)) <= SEAM * max(w, h)
    off = ~same
    assert (near(uw[off]) | near(vh[off])).all(), (
        f"{off.sum()} texels differ away from a seam")


def test_sky_texel_index_signed_zero_and_poles():
    """-d.z of +0.0 is -0.0: atan2 gives -pi, column 0; -d.z of -0.0 is
    +0.0: +pi, column w - 1. The poles read the top and bottom rows."""
    w, h = 16, 8
    d = np.array([(-1, 0, 0.0), (-1, 0, -0.0), (0, 1, 0), (0, -1, 0)],
                 np.float32).T
    want = np.asarray(j_texel_index(JVec3(*map(jnp.asarray, d)), w, h))
    got = t_texel_index(TVec3(*map(torch.tensor, d)), w, h).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] % w == 0 and got[1] % w == w - 1
    assert got[2] // w == h - 1 and got[3] // w == 0


# ---- loaders ---------------------------------------------------------------

def test_load_sky_matches_raytpu(tmp_path):
    path = write_equirect_sky(str(tmp_path / "sky.ppm"), 16, 8, seed=5)
    want = j_load_sky(path)
    got = t_load_sky(path, device="cpu")
    assert (got.width, got.height) == (want.width, want.height) == (16, 8)
    for a, b in zip(got.rgb, want.rgb):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # bottom-up rows: texel 0 is the bottom-left sample of the file
    np.testing.assert_array_equal(
        got.rgb.x.numpy()[:16], read_ppm(path, bottom_up=True)[0, :, 0])


@pytest.mark.parametrize("name", ["show", "world"])
def test_load_scene_file_matches_raytpu(files, name):
    js, _, _ = jconfig.load_scene_file(files[name])
    ts, _, _ = tconfig.load_scene_file(files[name], device="cpu")
    assert ts.sky_sphere_index == js.sky_sphere_index == ts.spheres.count - 1
    assert ts.sky_index == ts.sky_sphere_index
    assert (ts.sky.width, ts.sky.height) == (js.sky.width, js.sky.height)
    for path, want in _arrays(js).items():
        if path.startswith(("atlas.packed", "sky.packed")):
            continue
        got = ts
        for part in path.split("."):
            got = getattr(got, part)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_sky_table_index_and_black_diffuse_rule(files, tmp_path):
    text = open(files["show"]).read()
    base = os.path.dirname(files["show"])
    at0 = tmp_path / "at0.toml"
    at0.write_text(text.replace(
        "# sphere_index defaults", "sphere_index = 0\n# sphere_index defaults")
        .replace('file = "sky.ppm"', f'file = "{base}/sky.ppm"'))
    with pytest.raises(ValueError, match="black diffuse") as jerr:
        jconfig.load_scene_file(str(at0))
    with pytest.raises(ValueError, match="black diffuse") as terr:
        tconfig.load_scene_file(str(at0), device="cpu")
    assert str(terr.value) == str(jerr.value)
    last = tmp_path / "last.toml"
    last.write_text(text.replace(
        "# sphere_index defaults", "sphere_index = 4\n# sphere_index defaults")
        .replace('file = "sky.ppm"', f'file = "{base}/sky.ppm"'))
    ts, _, _ = tconfig.load_scene_file(str(last), device="cpu")
    assert ts.sky_index == 4 == jconfig.load_scene_file(str(last))[0].sky_sphere_index


def test_convert_keeps_the_sky_exactly_when_raytpu_does(files):
    js, _, _ = jconfig.load_scene_file(files["show"])
    ts = _convert(js)
    assert ts.sky_index == js.sky_sphere_index == 4
    np.testing.assert_array_equal(ts.sky.rgb.y.numpy(), np.asarray(js.sky.rgb.y))
    leaves = convert.scene_leaves(ts)
    assert set(convert.SKY_LEAVES) <= set(leaves)
    back = convert.scene_from_leaves(leaves, sky_sphere_index=4, sky=ts.sky)
    assert back.sky.rgb.x is leaves["sky.rgb.x"] and back.sky_index == 4
    # an index with an empty texture is a plain emitter, as in raytpu
    plain = _convert(js.replace(sky=JSky.empty()))
    assert plain.sky_index == plain.sky_sphere_index == -1


# ---- the scan path ---------------------------------------------------------

@pytest.mark.parametrize("name", ["sky_scene", "show", "world"])
def test_scan_render_matches_raytpu(files, name):
    js, jc, ts, tc, cfg = _scene(files, name)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    if name == "world":
        with jax.disable_jit():
            want = jrender.render(js, jc, cfg, jnp.asarray(pids),
                                  jax.random.PRNGKey(21))
    else:
        want = jrender.render(js, jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(21))
    got = t_render(ts, tc, _cfg(cfg), pids, trng.prng_key(21))
    for label, a, b in zip(("radiance", "albedo", "normal"), got[:3], want[:3]):
        _assert_planes(a.to_array().T.numpy(), _planes([b]), f"{name} {label}")
    assert got.radiance.to_array().std() > 0.01     # the sky shows


# ---- K1's sky slot, compose_sky -------------------------------------------

SPHERE_CASES = {
    "sky_scene": ("sky_scene", {}),
    "show": ("show", {}),
    "show_ao": ("show", dict(use_ao=True, ao_samples=2)),
    "show_hsl": ("show", dict(hsl_l_factor=1.2, hsl_s_factor=1.1)),
}


@pytest.mark.parametrize("case", sorted(SPHERE_CASES))
def test_k1_sky_slot_matches_raytpu_kernel(files, case):
    """The plain version's 16 planes and recording against raytpu's K1 in
    interpret mode, then ``compose_sky`` on each side's planes."""
    name, over = SPHERE_CASES[case]
    js, jc, ts, tc, cfg = _scene(files, name)
    cfg = cfg.replace(**over)
    jin, rays, draws = _inputs(jc, cfg, 11 + sorted(SPHERE_CASES).index(case))
    jout, jidx, jaof = jts._mk_forward(js, cfg, *jin, True, with_indices=True)
    tcfg = _cfg(cfg)
    k = tts.Knobs.create(tcfg, ts.spheres.count, draws.shape[1], ts.sky_index)
    flat = draws.reshape(-1, cfg.n_pixels)
    out, idx, aof = tts.trace_spheres_reference(tts.pack_spheres(ts), *rays,
                                                flat, k, record=True)
    assert out.shape == (16, cfg.n_pixels)
    want = _planes(jout)
    _assert_planes(out.numpy(), want, f"{case} planes")
    assert (out[15] > 0).any() and (out[9:12] != 0).any()
    idx = idx.numpy()
    assert (idx == np.asarray(jidx)).mean() >= IDX_AGREE
    if cfg.use_ao:
        # where the factor is used: the same hit, not on the sky sphere
        # (whose black diffuse zeroes the throughput whatever the factor,
        # and from whose surface a probe meets it again or not by rounding)
        used = (idx == np.asarray(jidx)) & (idx >= 0) & (idx != ts.sky_index)
        assert used.any()
        assert (aof.numpy() != np.asarray(jaof))[used].mean() <= OUTLIER_FRAC
    got = tts.compose_sky(ts, tcfg, out)
    jcomp = jts.compose_sky(js, cfg, jout)
    _assert_planes(torch.cat([v.to_array().T for v in got]).numpy(),
                   _planes(jcomp), f"{case} composed")
    # the wrapper on CPU tensors gives the composed planes, no launch
    before = tts.launches
    wrapped = tts.trace_megakernel(ts, tcfg, TVec3(*rays[:3]), TVec3(*rays[3:]),
                                   draws)
    assert tts.launches == before
    for a, b in zip(wrapped, got):
        assert torch.equal(a.to_array(), b.to_array())


# ---- K3's sky slot ---------------------------------------------------------

@pytest.mark.parametrize("ao", [False, True])
def test_k3_sky_slot_matches_raytpu_kernel(files, ao):
    """The plain version's 16 planes and recording against raytpu's K3 in
    interpret mode at 16x12 rays, and its composed planes against
    raytpu's scan run eagerly. raytpu's compiled K3 sends a water
    refraction down the other branch on 1-2% of the rays (ROADMAP F7),
    where the port's plain version equals the eager scan; the planes are
    held against the kernel on the rays whose recorded winners agree, at
    least 95% of them."""
    js, jc, ts, tc, cfg = _scene(files, "world")
    cfg = cfg.replace(width=16, height=12)
    if ao:
        cfg = cfg.replace(use_ao=True, ao_samples=2, max_bounces=3)
    jin, rays, draws = _inputs(jc, cfg, 31 + ao)
    jout, jidx, jaof = jtsc._mkm_forward(js, cfg, *jin, True,
                                         with_indices=True)
    tcfg = _cfg(cfg)
    k = ttsc.MeshKnobs.for_scene(tcfg, ts, draws.shape[1])
    assert k.sky_idx == ts.spheres.count - 1
    out, idx, aof = ttsc.trace_scene_reference(
        ttsc.pack_scene(ts), *rays, draws.reshape(-1, cfg.n_pixels), k,
        record=True)
    assert out.shape == (16, cfg.n_pixels)
    same = idx.numpy() == np.asarray(jidx)
    assert same.mean() >= IDX_AGREE
    kept = same.all(0)
    assert kept.mean() >= 0.95, f"{kept.mean():.3f}"
    _assert_planes(out.numpy()[:, kept], _planes(jout)[:, kept],
                   f"ao={ao} planes")
    assert (out[9:12] != 0).any()
    got = torch.cat([v.to_array().T for v in tts.compose_sky(ts, tcfg, out)])
    _assert_planes(got.numpy()[:, kept],
                   _planes(jts.compose_sky(js, cfg, jout))[:, kept],
                   f"ao={ao} composed")
    with jax.disable_jit():
        scan = jtrace(js, cfg, *jin)
    _assert_planes(got.numpy(), _planes(scan), f"ao={ao} vs the eager scan")


# ---- K2's sky cotangent ----------------------------------------------------

def _assert_rows(got: dict, want: dict, what):
    """Each leaf within ROW_REL of its largest |entry|, floored at
    TABLE_FLOOR of its table's (the leaves sharing a first path part)."""
    top = {}
    for path, w in want.items():
        t = path.split(".")[0]
        top[t] = max(top.get(t, 0.0), float(np.abs(w).max(initial=0.0)))
    for path, w in want.items():
        g = got[path]
        assert np.isfinite(g).all(), path
        scale = max(np.abs(w).max(initial=0.0), TABLE_FLOOR * top[path.split(".")[0]])
        err = np.abs(g - w).max(initial=0.0)
        assert err <= ROW_REL * scale, (
            f"{what} {path}: off by {err:.3e}, row max {scale:.3e}")


def _port_leaf_grads(ts, d_tabs):
    """Table cotangents pulled back through the packers onto the leaves."""
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    tabs = (tts.pack_spheres(scene), ttsc.pack_tri(scene),
            ttsc.pack_mats(scene), ttsc.pack_atlas(scene))
    pairs = [(t, d) for t, d in zip(tabs, d_tabs) if t.requires_grad]
    torch.autograd.backward(*map(list, zip(*pairs)))
    return {p: v.grad.numpy() for p, v in leaves.items() if v.grad is not None}


@pytest.mark.parametrize("name", ["show", "world"])
def test_k2_sky_cotangent_matches_raytpu(files, name):
    """The plain K2 on raytpu's recorded winners with four cotangent
    vectors (radiance, albedo, normal, the sky slot's scale) against
    raytpu's ``mesh_backward`` in interpret mode, on the rays whose
    winners the port's recording reproduces."""
    js, jc, ts, tc, cfg = _scene(files, name)
    jin, rays, draws = _inputs(jc, cfg, 41 + (name == "world"))
    b = cfg.n_pixels
    tcfg = _cfg(cfg)
    flat = draws.reshape(-1, b)
    if name == "world":
        _, jidx, jaof = jtsc._mkm_forward(js, cfg, *jin, True, with_indices=True)
        k = ttsc.MeshKnobs.for_scene(tcfg, ts, draws.shape[1])
        mt = ttsc.pack_scene(ts)
        tabs = tbwd.Tables(mt.sph, mt.tri, mt.mats, mt.atlas)
        port_idx = ttsc.trace_scene_reference(mt, *rays, flat, k, record=True)[1]
    else:
        _, jidx, jaof = jts._mk_forward(js, cfg, *jin, True, with_indices=True)
        k = ttsc.MeshKnobs.of_spheres(tts.Knobs.create(
            tcfg, ts.spheres.count, draws.shape[1], ts.sky_index))
        tabs = tbwd.Tables.of_spheres(tts.pack_spheres(ts))
        port_idx = tts.trace_spheres_reference(tabs.sph, *rays, flat, k,
                                               record=True)[1]
    jidx = np.asarray(jidx)
    kept = (port_idx.numpy() == jidx).all(0)
    assert kept.mean() >= 0.9, f"{kept.mean():.3f}"
    g = np.random.default_rng(51).uniform(-1, 1, (12, b)).astype(np.float32)
    g[:, ~kept] = 0.0
    g_vecs = [JVec3(*map(jnp.asarray, g[3 * j:3 * j + 3])) for j in range(4)]
    d_scene, d_o, d_d, _ = j_mesh_backward(
        js, cfg, *jin, jnp.asarray(jidx), g_vecs, True,
        aof=None if jaof is None else jnp.asarray(jaof))
    before = tbwd.launches
    *d_tabs, d_rays = tbwd.mesh_backward(
        tabs, rays, flat, torch.tensor(jidx),
        None if jaof is None else torch.tensor(jaof), torch.tensor(g), k)
    assert tbwd.launches == before
    got = _port_leaf_grads(ts, d_tabs)
    want = {p: _leaf(d_scene, p) for p in got}
    _assert_rows(got, want, name)
    # the slot's route: the sky sphere's emission strength
    assert np.abs(want["spheres.mat.emission_strength"][ts.sky_index]) > 0
    want_rays = np.stack([np.asarray(c) for c in (*d_o, *d_d)])
    got_rays = torch.stack(d_rays).numpy()
    bad = np.abs(got_rays - want_rays) > G_ATOL + G_RTOL * np.abs(want_rays)
    assert bad.any(0).mean() <= OUTLIER_FRAC


def _leaf(tree, path):
    for part in path.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree)


def test_k2_sky_cotangent_reaches_throughput_and_strength():
    """Only the sky scale's cotangent is set: it reaches the sky sphere's
    emission strength (the slot's e_scale) and the earlier bounces'
    surfaces (the throughput before the take), and no sky emission."""
    js = _sky_scene()
    ts = _convert(js)
    from raytpu.camera import make_camera

    jc = make_camera(origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
                     vfov_deg=60.0, aspect_ratio=1.5)
    cfg = JConfig(width=12, height=8, spp=1, max_bounces=3)
    _, rays, draws = _inputs(jc, cfg, 61)
    tcfg = _cfg(cfg)
    k = tts.Knobs.create(tcfg, 2, draws.shape[1], 1)
    flat = draws.reshape(-1, cfg.n_pixels)
    sph = tts.pack_spheres(ts)
    _, idx, aof = tts.trace_spheres_reference(sph, *rays, flat, k, record=True)
    g = torch.zeros((12, cfg.n_pixels))
    g[9:12] = 1.0
    d_sph, d_rays = tbwd.sphere_backward(sph, rays, flat, idx, aof, g, k)
    assert d_sph[10, 1] > 0                 # the sky sphere's strength
    assert (d_sph[7:10, 1] == 0).all()      # its emission is the texel's
    assert (d_sph[4:7, 0] != 0).any()       # the ball's diffuse, via rc


# ---- gradients through render ----------------------------------------------

@pytest.mark.parametrize("texel_grads", [False, True])
@pytest.mark.parametrize("route", ["megakernel", "scan"])
def test_render_grads_match_raytpu(files, route, texel_grads):
    """Every float leaf of the showcase, the sky texels among them,
    through the port's ``render`` (K1 recording then K2, or the scan path)
    against ``jax.grad`` through raytpu's scan path."""
    js, jc, ts, tc, cfg = _scene(files, "show")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=3,
                      sky_texture_grads=texel_grads)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    params, static = j_partition(js)

    def j_loss(p):
        sums = jrender.render(j_combine(p, static), jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(71))
        return jnp.mean((sums.radiance.to_array() / cfg.spp - 0.2) ** 2)

    want = _arrays(jax.grad(j_loss)(params))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, sky_sphere_index=ts.sky_sphere_index,
                                      sky=ts.sky)
    tcfg = _cfg(cfg).replace(use_megakernel=route == "megakernel")
    before = tbwd.launches
    sums = t_render(scene, tc, tcfg, pids, trng.prng_key(71))
    torch.mean((sums.radiance.to_array() / tcfg.spp - 0.2) ** 2).backward()
    assert (tbwd.launches == before)       # CPU tensors: no launch
    for path, leaf in leaves.items():
        w = np.asarray(want[path], np.float64)
        got = (np.zeros_like(w) if leaf.grad is None
               else np.asarray(leaf.grad.numpy(), np.float64))
        assert np.isfinite(got).all(), path
        tol = GRAD_RTOL * np.abs(w) + GRAD_SCALE * np.abs(w).max() + GRAD_ATOL
        assert (np.abs(got - w) <= tol).all(), (
            f"{path}: max |diff| {np.abs(got - w).max():.3e}, max |grad| "
            f"{np.abs(w).max():.3e}")
    sky_grad = np.abs(want["sky.rgb.x"]).max()
    assert (sky_grad > 0) == texel_grads
    assert np.abs(want["spheres.mat.emission_strength"]).max() > 0


@pytest.mark.parametrize("route", ["megakernel", "scan"])
def test_sky_texel_grads_match_finite_differences(route):
    """``tests/test_sky.py``'s scene: radiance is linear in the texels, so
    the most- and least-hit texels' gradients (``sky_texture_grads``)
    match central differences."""
    js = _sky_scene()
    ts = _convert(js)
    cam = t_make_camera(origin=(0, 0, 2), target=(0, 0, -3), up=(0, 1, 0),
                        vfov_deg=60.0, aspect_ratio=1.5, device="cpu")
    cfg = TConfig(width=12, height=8, spp=3, max_bounces=3,
                  sky_texture_grads=True, use_megakernel=route == "megakernel")
    pids = np.arange(cfg.n_pixels)
    key = trng.prng_key(12)

    def loss(rgb_x):
        sky = dataclasses.replace(ts.sky, rgb=TVec3(rgb_x, ts.sky.rgb.y,
                                                    ts.sky.rgb.z))
        sums = t_render(dataclasses.replace(ts, sky=sky), cam, cfg, pids, key)
        return sums.radiance.x.double().sum()

    x0 = ts.sky.rgb.x.clone().requires_grad_()
    loss(x0).backward()
    g = x0.grad.numpy()
    assert np.abs(g).max() > 0
    eps = 1e-2
    with torch.no_grad():
        for t in (int(np.argmax(np.abs(g))), int(np.argmin(np.abs(g)))):
            x = ts.sky.rgb.x.clone()
            x[t] += eps
            lp = loss(x).item()
            x[t] -= 2 * eps
            fd = (lp - loss(x).item()) / (2 * eps)
            assert abs(g[t] - fd) <= FD_REL * abs(fd) + 1e-6, (t, g[t], fd)


# ---- branches: cutout then sky --------------------------------------------

def test_cutout_then_sky_matches_scan(files):
    """Every atlas texel a cutout: mesh hits pass through to the ground or
    the sky, whose early return must replace radiance and albedo after
    the alpha bookkeeping. K3's plain version (composed) against the
    port's scan path and raytpu's."""
    js, jc, ts, tc, cfg = _scene(files, "world")
    js = js.replace(atlas=js.atlas.replace(alpha=jnp.zeros_like(js.atlas.alpha)))
    ts = dataclasses.replace(ts, atlas=TAtlas(
        ts.atlas.rgb, torch.zeros_like(ts.atlas.alpha), ts.atlas.width,
        ts.atlas.height))
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    tcfg = _cfg(cfg)
    mk = t_render(ts, tc, tcfg.replace(use_megakernel=True), pids,
                  trng.prng_key(81))
    scan = t_render(ts, tc, tcfg, pids, trng.prng_key(81))
    with jax.disable_jit():
        want = jrender.render(js, jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(81))
    for label, a, b, c in zip(("radiance", "albedo", "normal"), mk[:3],
                              scan[:3], want[:3]):
        _assert_planes(a.to_array().T.numpy(), b.to_array().T.numpy(),
                       f"{label} K3 vs scan")
        _assert_planes(b.to_array().T.numpy(), _planes([c]),
                       f"{label} scan vs raytpu")


# ---- training and the CLI --------------------------------------------------

def test_adam_step_with_sky_leaf_matches_optax(files):
    js, jc, ts, tc, cfg = _scene(files, "show")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=3,
                      sky_texture_grads=True)
    lr = 1e-2
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    target = np.random.default_rng(9).uniform(
        0.0, 0.5, (cfg.n_pixels, 3)).astype(np.float32)
    j_init, j_step = j_make_train_step(cfg, optax.adam(lr))
    t_init, t_step = t_make_train_step(_cfg(cfg).replace(use_megakernel=True),
                                       lr)
    j_state, j_static = j_init(js, jc)
    t_state, t_static = t_init(ts, tc)
    assert set(convert.SKY_LEAVES) <= set(t_state.params)
    assert t_static["sky"].width == 16 and t_static["sky_sphere_index"] == 4
    for step in range(2):
        j_state, j_l = j_step(j_state, j_static, jc, jnp.asarray(pids),
                              jnp.asarray(target), jax.random.PRNGKey(step))
        t_state, t_l = t_step(t_state, t_static, tc, pids, target,
                              trng.prng_key(step))
        np.testing.assert_allclose(t_l.item(), float(j_l), rtol=1e-5)
        want = _arrays(j_state.params)
        for leaf, p in t_state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[leaf],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {leaf}")
    moved = t_state.params["sky.rgb.x"].detach().numpy() != ts.sky.rgb.x.numpy()
    assert moved.any()


def test_sky_leaf_without_texel_grads_gets_zeros(files):
    ts, tc, cfg = tconfig.load_scene_file(files["show"], device="cpu")
    cfg = cfg.replace(width=6, height=4, spp=1, max_bounces=2,
                      use_megakernel=True)
    init, step = t_make_train_step(cfg, 1e-2)
    state, static = init(ts, tc)
    step(state, static, tc, np.arange(24), np.zeros((24, 3), np.float32),
         trng.prng_key(0))
    g = state.params["sky.rgb.x"].grad
    assert g is not None and (g == 0).all()
    assert t_partition(ts)[1]["sky"].height == 8


def test_cli_render_and_train_sky_scene(files, tmp_path):
    target = str(tmp_path / "t.ppm")
    assert cli.main(["render", files["show"], "--device", "cpu", "--width", "12",
                     "--height", "8", "--spp", "1", "--bounces", "3",
                     "--out", target]) == 0
    img = read_ppm(target)
    assert img.shape == (8, 12, 3) and img.std() > 0
    out = str(tmp_path / "fit.ppm")
    assert cli.main(["train", files["world"], "--device", "cpu", "--target",
                     target, "--width", "12", "--height", "8", "--spp", "1",
                     "--bounces", "2", "--steps", "1", "--out", out]) == 0
    assert read_ppm(out).shape == (8, 12, 3)
