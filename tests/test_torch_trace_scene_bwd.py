"""The port's index-replay backward (K2's plain version) against raytpu's.

The same numpy-seeded rays, bounce draws and output cotangent ``g``, and
the winner indices and AO factors that raytpu's sphere megakernel records
(``_mk_forward(with_indices=True)`` in interpret mode), go through
raytpu's ``trace_scene_bwd.mesh_backward`` in interpret mode (sphere mode)
and through the port's ``replay_reference``. Tolerance: each row of the
sphere-table cotangent within 1e-4 of that row's largest |entry| (+1e-6
for rows that are zero); a ray is an outlier if one of its six
cotangents differs by more than 1e-4 + 1e-4*|x|, and at most 2% of rays
may be (both sides sum the same terms in another order, and a grazing
hit's distance gradient grows as 1/sqrt(disc), which magnifies rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import scenes as jscenes
from raytpu.camera import make_camera as j_make_camera
from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.types import Scene as JScene
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator.path import n_bounce_draws
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu.kernels import trace_spheres as jts
from raytpu.kernels.trace_scene_bwd import mesh_backward
from raytpu_torch import convert
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.kernels import trace_spheres as tts

ROW_RTOL, ROW_ATOL = 1e-4, 1e-6
G_ATOL, G_RTOL, OUTLIER_FRAC = 1e-4, 1e-4, 0.02


def _arrays(tree, **static):
    d = {
        jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    d.update(static)
    return d


def _refractive_cutout():
    rows = [
        ((0, -501, 0), 500.0, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 1.5, -3), 0.8, jscenes.BLACK, (1.0, 0.9, 0.7), 5.0, 0.0, 1.0, 1.0),
        ((0, 0, -3), 0.7, jscenes.WHITE, jscenes.BLACK, 0.0, 0.2, 0.1, 1.5),
        ((0.9, 0, -2.2), 0.4, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 0.0, 1.0),
    ]
    cam = j_make_camera(origin=(0, 0, 1), target=(0, 0, -3), up=(0, 1, 0),
                        vfov_deg=50.0, aspect_ratio=1.5)
    return JScene.from_spheres(jscenes.spheres_from_rows(rows)), cam, JConfig()


SCENES = {
    "cornell": (jscenes.cornell_box, {}),
    "cornell_cuda": (jscenes.cornell_box_cuda, {}),           # HSL + AO
    "cornell_dof_ao": (jscenes.cornell_box_dof_ao, {}),
    "refractive_cutout": (_refractive_cutout, dict(max_bounces=4)),
}


def _sphere_rows(d_scene):
    s = d_scene.spheres
    m = s.mat
    return np.stack([np.asarray(x) for x in (
        *s.center, s.radius, *m.diffuse, *m.emission, m.emission_strength,
        m.reflection, m.alpha, m.ior)])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_replay_reference_matches_mesh_backward(name):
    make, over = SCENES[name]
    scene, cam, cfg = make()
    cfg = cfg.replace(**{"width": 8, "height": 6, "max_bounces": 3, **over})
    rs = np.random.default_rng(sorted(SCENES).index(name) + 10)
    b = cfg.n_pixels
    o, d = j_sample_rays(cam, cfg, jnp.arange(b, dtype=jnp.int32),
                         jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    g = rs.uniform(-1, 1, (9, b)).astype(np.float32)

    _, idx, aof = jts._mk_forward(scene, cfg, o, d, jnp.asarray(draws), True,
                                  with_indices=True)
    g_vecs = [JVec3(*map(jnp.asarray, g[3 * j:3 * j + 3])) for j in range(3)]
    d_scene, d_o, d_d, _ = mesh_backward(scene, cfg, o, d, jnp.asarray(draws),
                                         idx, g_vecs, True, aof=aof)
    want_sph = _sphere_rows(d_scene)
    want_rays = np.stack([np.asarray(c) for c in (*d_o, *d_d)])

    tscene = convert.scene_from_arrays(
        _arrays(scene, sky_sphere_index=scene.sky_sphere_index), device="cpu")
    tcfg = TConfig(**{f: getattr(cfg, f) for f in TConfig.__dataclass_fields__})
    k = tts.Knobs.create(tcfg, tscene.spheres.count, draws.shape[1])
    rays = tuple(torch.tensor(np.asarray(c)) for c in (*o, *d))
    before = tbwd.launches
    d_sph, d_rays = tbwd.sphere_backward(
        tts.pack_spheres(tscene), rays, torch.tensor(draws.reshape(-1, b)),
        torch.tensor(np.asarray(idx)),
        None if aof is None else torch.tensor(np.asarray(aof)),
        torch.tensor(g), k)
    assert tbwd.launches == before      # CPU tensors: the plain version

    got_sph = d_sph.numpy()
    got_rays = torch.stack(d_rays).numpy()
    assert np.isfinite(got_sph).all() and np.isfinite(got_rays).all()
    assert np.abs(want_sph[4:11]).max() > 0     # colours carry gradient
    scale = np.abs(want_sph).max(axis=1, keepdims=True)
    err = np.abs(got_sph - want_sph)
    assert (err <= ROW_RTOL * scale + ROW_ATOL).all(), (
        f"d_sph rows off by {(err / np.maximum(scale, 1e-30)).max(1)}, "
        f"row scales {scale.ravel()}")
    bad = (np.abs(got_rays - want_rays)
           > G_ATOL + G_RTOL * np.abs(want_rays)).any(0)
    assert bad.mean() <= OUTLIER_FRAC, f"{bad.mean():.2%} rays differ"


def _tiny(bounces=3, ao=False):
    scene, _, cfg = jscenes.cornell_box()
    cfg = cfg.replace(max_bounces=bounces, use_ao=ao)
    tscene = convert.scene_from_arrays(_arrays(scene, sky_sphere_index=-1),
                                       device="cpu")
    tcfg = TConfig(**{f: getattr(cfg, f) for f in TConfig.__dataclass_fields__})
    rs = np.random.default_rng(3)
    b = 16
    rays = tuple(torch.zeros(b) for _ in range(3)) + tuple(
        torch.tensor(rs.normal(size=(3, b)).astype(np.float32)))
    nd = 3 + (2 if ao else 0)
    draws = torch.tensor(rs.random((bounces * nd, b), np.float32))
    return tscene, tcfg, rays, draws, tts.Knobs.create(tcfg, 10, nd)


def test_depth_cap_raises():
    """One depth policy (ROADMAP F4): gradients to MAX_BOUNCES bounces,
    NotImplementedError past it, for the plain version and the kernel."""
    assert tbwd.MAX_BOUNCES == 48
    tscene, tcfg, rays, draws, k = _tiny(bounces=49)
    idx = torch.full((49, 16), -1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MAX_BOUNCES = 48"):
        tbwd.sphere_backward(tts.pack_spheres(tscene), rays, draws, idx, None,
                             torch.ones(9, 16), k)
    with pytest.raises(NotImplementedError, match="MAX_BOUNCES = 48"):
        tts.TraceSpheres.apply(tts.pack_spheres(tscene), *rays, draws, k)


def test_replay_is_finite_on_misses_and_zero_emitters():
    """Rays that miss everything, lanes with ior == 0 and black emitters:
    the select-based floors keep every cotangent finite."""
    tscene, tcfg, rays, draws, k = _tiny()
    sph = tts.pack_spheres(tscene).clone()
    sph[13] = 0.0                        # ior == 0 on every sphere
    emitter = int(torch.nonzero(sph[10] > 0)[0])
    sph[7:10, emitter] = 0.0             # an emitter with black emission
    z = torch.zeros(16)
    away = (z, z, z + 2000.0, z, z, z + 1.0)      # outside the box, leaving
    misses = 0
    for r in (rays, away):
        _, idx, _ = tts.trace_spheres_reference(sph, *r, draws, k, record=True)
        misses += int((idx[0] == -1).sum())
        d_sph, *_, d_rays = tbwd.replay_reference(
            tbwd.Tables.of_spheres(sph), r, draws, idx, None,
            torch.ones(9, 16), k)
        assert torch.isfinite(d_sph).all()
        assert all(torch.isfinite(t).all() for t in d_rays)
    assert misses > 0


def test_replay_forward_equals_recording_forward():
    """Replaying the recorded winners reproduces the forward's planes."""
    tscene, tcfg, rays, draws, k = _tiny(bounces=4, ao=True)
    sph = tts.pack_spheres(tscene)
    out, idx, aof = tts.trace_spheres_reference(sph, *rays, draws, k,
                                                record=True)
    replayed = tbwd.replay_forward(tbwd.Tables.of_spheres(sph), rays, draws,
                                   idx, aof, k)
    torch.testing.assert_close(replayed, out, rtol=1e-6, atol=1e-6)
