"""K5, the AD sphere backward: its plain version against raytpu's and K2's.

The same numpy-seeded rays, bounce draws and output cotangent ``g`` go
through raytpu's K5, through the port's ``trace_spheres.ad_reference``
(``torch.autograd.grad`` through ``trace_spheres_reference``) and through
K2's plain version on the winners the port's recording records. Scenes:
Cornell, Cornell with DoF + AO, a refraction and cutout scene, and the
sky showcase under a 16x8 sky (12 cotangent planes), at 8x6 pixels x 2
samples and 3 bounces. raytpu's K5 runs as ``_mk_bwd`` with
``RAYTPU_SPH_BWD=ad`` (the Pallas kernel ``_bwd_kernel`` in interpret
mode) on the refraction scene and the showcase; on the two ten-sphere
Cornell scenes its compile takes 2-3 minutes on the CPU, so there the
test takes what ``_bwd_kernel`` computes, ``jax.vjp`` of
``_forward_body`` on the same packed tiles, eagerly (~10 s).
Tolerance, ``PERF.md`` section 2's K2 rule: each row of d_sph within 1e-3
of the row's largest |entry|, floored at 1e-6 of the table's largest; a
ray is an outlier if one of its six cotangents differs by more than
1e-4 + 1e-4|x|, and at most 2% of rays may be (the three sum the same
terms in other orders, and a grazing hit's distance gradient grows as
1/sqrt(disc)). Then the dispatch of ``TraceSpheres``' backward on
``RAYTPU_SPH_BWD``, the depth cap (F4), and the build hashing the header
K2 and K5 share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu import scenes as jscenes
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator.path import n_bounce_draws
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu.kernels import trace_spheres as jts
from raytpu_torch import config as tconfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.kernels import trace_spheres as tts
from raytpu_torch.scenes import write_sky_showcase
from tests.test_torch_sky import _cfg, _convert
from tests.test_torch_trace_scene_bwd import _refractive_cutout, _sphere_rows

ROW_REL, TABLE_FLOOR = 1e-3, 1e-6
G_ATOL, G_RTOL, OUTLIER_FRAC = 1e-4, 1e-4, 0.02
SCENES = ("cornell", "cornell_dof_ao", "refractive_cutout", "sky_showcase")
KERNEL_SCENES = ("refractive_cutout", "sky_showcase")   # through _mk_bwd


@pytest.fixture(scope="module")
def showcase(tmp_path_factory):
    return write_sky_showcase(str(tmp_path_factory.mktemp("show")), (16, 8),
                              seed=1)


def _scene(name, showcase):
    """(raytpu scene, camera, config, port scene)."""
    if name == "sky_showcase":
        js, jc, cfg = jconfig.load_scene_file(showcase)
        ts = tconfig.load_scene_file(showcase, device="cpu")[0]
    else:
        make = {"cornell": jscenes.cornell_box,
                "cornell_dof_ao": jscenes.cornell_box_dof_ao,
                "refractive_cutout": _refractive_cutout}[name]
        js, jc, cfg = make()
        ts = _convert(js)
    return js, jc, cfg.replace(width=8, height=6, max_bounces=3), ts


def _forward_body_vjp(js, cfg, o, d, draws, g):
    """(d_sph (14, S), ray cotangents (6, B)): ``jax.vjp`` of raytpu's
    ``_forward_body`` on the tiles ``_mk_bwd`` packs, run eagerly, as
    ``_bwd_kernel`` runs it inside the kernel."""
    b, n_s = g.shape[1], js.spheres.count
    sph, *rays, tiles, nd = jts._pack_inputs(js, o, d, jnp.asarray(draws), 1)
    statics = dict(n_spheres=n_s, **jts._statics(cfg, nd),
                   **jts._sky_statics(js))
    tiles = [tiles[j] for j in range(tiles.shape[0])]
    pad = lambda x: jnp.pad(jnp.asarray(x), (0, rays[0].size - b)).reshape(
        rays[0].shape)

    def f(sv, *r):
        return jts._forward_body(sv, *r, tiles, **statics)[:g.shape[0]]

    sv = tuple(tuple(sph[k, s] for s in range(n_s)) for k in range(14))
    with jax.disable_jit():
        _, pull = jax.vjp(f, sv, *rays)
        dsv, *d_rays = pull(tuple(pad(x) for x in g))
    return (np.array([[float(v) for v in row] for row in dsv]),
            np.stack([np.asarray(r).reshape(-1)[:b] for r in d_rays]))


def _assert_rows(got, want, what):
    """PERF.md section 2's rule for a table cotangent."""
    floor = TABLE_FLOOR * np.abs(want).max()
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), floor)
    err = np.abs(got - want)
    assert (err <= ROW_REL * scale).all(), (
        f"{what}: d_sph rows off by {(err / scale).max(1)}")


def _assert_rays(got, want, what):
    bad = (np.abs(got - want) > G_ATOL + G_RTOL * np.abs(want)).any(0)
    assert bad.mean() <= OUTLIER_FRAC, f"{what}: {bad.mean():.2%} rays differ"


@pytest.mark.parametrize("name", SCENES)
def test_ad_reference_matches_raytpu_ad_and_k2(name, showcase, monkeypatch):
    js, jc, cfg, ts = _scene(name, showcase)
    rs = np.random.default_rng(SCENES.index(name) + 40)
    b = 2 * cfg.n_pixels                       # two samples a pixel
    pids = jnp.tile(jnp.arange(cfg.n_pixels, dtype=jnp.int32), 2)
    o, d = j_sample_rays(jc, cfg, pids,
                         jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    sky = js.sky_sphere_index >= 0
    g = rs.uniform(-1, 1, (12 if sky else 9, b)).astype(np.float32)

    if name in KERNEL_SCENES:
        monkeypatch.setenv("RAYTPU_SPH_BWD", "ad")
        g_vecs = tuple(JVec3(*map(jnp.asarray, g[3 * j:3 * j + 3]))
                       for j in range(len(g) // 3))
        if sky:    # the direction and early planes: never differentiated
            g_vecs += (g_vecs[0], jnp.zeros(b))
        res = (js, o, d, jnp.asarray(draws), None, None)
        d_scene, d_o, d_d, _ = jts._mk_bwd(cfg, True, res, g_vecs)
        want_sph = _sphere_rows(d_scene)
        want_rays = np.stack([np.asarray(c) for c in (*d_o, *d_d)])
    else:
        want_sph, want_rays = _forward_body_vjp(js, cfg, o, d, draws, g)

    k = tts.Knobs.create(_cfg(cfg), ts.spheres.count, draws.shape[1],
                         ts.sky_index)
    sph = tts.pack_spheres(ts)
    rays = tuple(torch.tensor(np.asarray(c)) for c in (*o, *d))
    flat = torch.tensor(draws.reshape(-1, b))
    before = tts.ad_launches
    d_sph, d_rays = tts.spheres_ad(sph, rays, flat, torch.tensor(g), k)
    assert tts.ad_launches == before      # CPU tensors: the plain version
    got_sph, got_rays = d_sph.numpy(), torch.stack(d_rays).numpy()
    assert np.isfinite(got_sph).all() and np.isfinite(got_rays).all()
    assert np.abs(want_sph[4:11]).max() > 0     # colours carry gradient
    _assert_rows(got_sph, want_sph, f"{name} vs raytpu")
    _assert_rays(got_rays, want_rays, f"{name} vs raytpu")

    # K2's plain version on the port's recorded winners
    _, idx, aof = tts.trace_spheres_reference(sph, *rays, flat, k, record=True)
    k2_sph, k2_rays = tbwd.sphere_backward(sph, rays, flat, idx, aof,
                                           torch.tensor(g), k)
    _assert_rows(got_sph, k2_sph.numpy(), f"{name} vs K2")
    _assert_rays(got_rays, torch.stack(k2_rays).numpy(), f"{name} vs K2")


def _tiny(bounces=3):
    scene, _, cfg = jscenes.cornell_box()
    cfg = cfg.replace(max_bounces=bounces)
    ts = _convert(scene)
    rs = np.random.default_rng(5)
    b = 16
    origin = TVec3(*(torch.zeros(b) for _ in range(3)))
    direction = TVec3(*torch.tensor(rs.normal(size=(3, b)).astype(np.float32)))
    draws = torch.tensor(rs.random((bounces, 3, b), np.float32))
    return ts, _cfg(cfg), origin, direction, draws


@pytest.mark.parametrize("mode", ["replay", "ad"])
def test_backward_follows_raytpu_sph_bwd(mode, monkeypatch):
    """``TraceSpheres``' backward reads RAYTPU_SPH_BWD when it runs:
    "replay" (and unset) gives K2's plain version, "ad" K5's; both give
    the same gradient within the section 2 rule."""
    ts, cfg, origin, direction, draws = _tiny()
    grads = {}
    for env in (mode, None):
        if env is None:
            monkeypatch.delenv("RAYTPU_SPH_BWD", raising=False)
        else:
            monkeypatch.setenv("RAYTPU_SPH_BWD", env)
        o = TVec3(*(c.clone().requires_grad_() for c in origin))
        out = tts.trace_megakernel(ts, cfg, o, direction, draws)
        sum(v.sum() for vec in out for v in vec).backward()
        grads[env] = torch.stack([c.grad for c in o])
    assert torch.isfinite(grads[mode]).all()
    if mode == "replay":
        assert torch.equal(grads[mode], grads[None])
    want = grads[None].numpy()
    _assert_rays(grads[mode].numpy(), want, f"RAYTPU_SPH_BWD={mode}")


def test_unknown_sph_bwd_raises(monkeypatch):
    ts, cfg, origin, direction, draws = _tiny()
    monkeypatch.setenv("RAYTPU_SPH_BWD", "scan")
    o = TVec3(*(c.clone().requires_grad_() for c in origin))
    out = tts.trace_megakernel(ts, cfg, o, direction, draws)
    with pytest.raises(ValueError, match="RAYTPU_SPH_BWD"):
        out[0].x.sum().backward()


def test_ad_depth_cap_raises():
    """F4: K5 takes gradients to 48 bounces and raises past that."""
    ts, cfg, origin, direction, draws = _tiny(bounces=49)
    k = tts.Knobs.create(cfg, ts.spheres.count, 3)
    with pytest.raises(NotImplementedError, match="MAX_BOUNCES = 48"):
        tts.spheres_ad(tts.pack_spheres(ts), (*origin, *direction),
                       draws.reshape(-1, 16), torch.ones(9, 16), k)


def test_library_hash_follows_included_headers(tmp_path, monkeypatch):
    """K2 and K5 share csrc/replay.cuh (K1 and K5 sphere_search.cuh): each
    library's name hashes its source and the headers it includes, so an
    edited header is rebuilt."""
    import shutil

    from raytpu_torch.kernels import _build

    assert [p.name for p in _build.sources("trace_spheres_bwd")] == [
        "trace_spheres_bwd.cu", "replay.cuh", "sphere_search.cuh",
        "threefry.cuh"]
    assert [p.name for p in _build.sources("trace_scene_bwd")] == [
        "trace_scene_bwd.cu", "replay.cuh", "threefry.cuh"]
    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("trace_scene_bwd",
                                                  "trace_spheres_bwd",
                                                  "trace_spheres")}
    with open(tmp_path / "replay.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["trace_scene_bwd"] != before["trace_scene_bwd"]
    assert after["trace_spheres_bwd"] != before["trace_spheres_bwd"]
    assert after["trace_spheres"] == before["trace_spheres"]
