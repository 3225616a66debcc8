"""The port's sphere megakernel module against raytpu.

``trace_spheres_reference`` (what the wrapper runs on CPU tensors, and
what the CUDA kernel is held against on the card) is compared with the
Pallas megakernel in interpret mode and with the scan integrator
(``raytpu.integrator.path.trace``), on the same rays and draws made from
numpy seeds. Tolerance: a ray is an outlier if any channel differs by
more than 1e-4 + 1e-5*|x|, and at most 2% of rays may be outliers
(``tests/test_megakernel._compare``): the sides round a few products
differently, so grazing hits on the radius-500 walls can flip.
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
from raytpu.integrator.path import n_bounce_draws, trace
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu.kernels import trace_spheres as jts
from raytpu_torch import convert
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.types import Scene as TScene
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.kernels import trace_spheres as tts
from raytpu_torch.scenes import cornell_box as t_cornell_box

ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


def _arrays(tree, **static):
    d = {
        jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    d.update(static)
    return d


def _refractive():
    rows = [
        ((0, -501, 0), 500.0, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 1.5, -3), 0.8, jscenes.BLACK, (1.0, 0.9, 0.7), 5.0, 0.0, 1.0, 1.0),
        ((0, 0, -3), 0.7, jscenes.WHITE, jscenes.BLACK, 0.0, 0.2, 0.1, 1.5),
        ((0.9, 0, -2.2), 0.4, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 0.0, 1.0),
    ]
    cam = j_make_camera(origin=(0, 0, 1), target=(0, 0, -3), up=(0, 1, 0),
                        vfov_deg=50.0, aspect_ratio=1.5)
    return JScene.from_spheres(jscenes.spheres_from_rows(rows)), cam, JConfig()


# the four scenes of the chip check, at 12x8 rays
SCENES = {
    "cornell": (jscenes.cornell_box, dict(max_bounces=5)),
    "refractive_cutout": (_refractive, dict(max_bounces=6)),
    "dof_ao_1": (jscenes.cornell_box_dof_ao, dict(max_bounces=4, ao_samples=1)),
    "dof_ao_2": (jscenes.cornell_box_dof_ao, dict(max_bounces=3, ao_samples=2)),
    "cornell_cuda": (jscenes.cornell_box_cuda, dict(max_bounces=4)),
}


def _inputs(name):
    """JAX scene/config, port scene/config, and numpy rays + draws."""
    make, over = SCENES[name]
    scene, cam, cfg = make()
    cfg = cfg.replace(width=12, height=8, **over)
    rs = np.random.default_rng(sorted(SCENES).index(name))
    ids = np.arange(cfg.n_pixels, dtype=np.int32)
    o, d = j_sample_rays(cam, cfg, jnp.asarray(ids),
                         jnp.asarray(rs.random((4, ids.size), np.float32)))
    rays = [np.asarray(c) for c in (*o, *d)]
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), ids.size),
                      np.float32)
    tscene = convert.scene_from_arrays(
        _arrays(scene, sky_sphere_index=scene.sky_sphere_index), device="cpu")
    tcfg = TConfig(**{f: getattr(cfg, f) for f in TConfig.__dataclass_fields__})
    return scene, cfg, tscene, tcfg, rays, draws


def _check(name, got, want):
    for label, a, b in zip(("radiance", "albedo", "normal"), got, want):
        x = np.stack([np.asarray(c) for c in b], -1)
        y = np.stack([c.numpy() for c in a], -1)
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert np.isfinite(y).all(), f"{name} {label}: non-finite"
        assert bad.mean() <= OUTLIER_FRAC, (
            f"{name} {label}: {bad.mean():.2%} rays differ "
            f"(max {np.abs(x - y).max():.4g})"
        )


@pytest.mark.parametrize("against", ["pallas_interpret", "scan"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_reference_matches_raytpu(name, against):
    scene, cfg, tscene, tcfg, rays, draws = _inputs(name)
    o, d = JVec3(*map(jnp.asarray, rays[:3])), JVec3(*map(jnp.asarray, rays[3:]))
    if against == "scan":
        want = trace(scene, cfg, o, d, jnp.asarray(draws))
    else:
        assert jts.supported(scene, cfg)
        want = jts.trace_megakernel(scene, cfg, o, d, jnp.asarray(draws),
                                    interpret=True)
    trays = [torch.tensor(c) for c in rays]
    got = tts.trace_megakernel(tscene, tcfg, TVec3(*trays[:3]),
                               TVec3(*trays[3:]), torch.tensor(draws))
    _check(name, got, want)


def test_cpu_wrapper_runs_plain_version_without_launching():
    scene, cam, cfg = t_cornell_box(device="cpu")
    cfg = cfg.replace(max_bounces=3)
    rs = np.random.default_rng(0)
    o = TVec3(*(torch.zeros(16) for _ in range(3)))
    d = TVec3(*torch.tensor(rs.normal(size=(3, 16)).astype(np.float32)))
    draws = torch.tensor(rs.random((3, 3, 16), np.float32))
    before = tts.launches
    got = tts.trace_megakernel(scene, cfg, o, d, draws)
    assert before == tts.launches == 0
    k = tts.Knobs.create(cfg, scene.spheres.count, 3)
    want = tts.trace_spheres_reference(tts.pack_spheres(scene), *o, *d,
                                       draws.reshape(9, 16), k)
    assert torch.equal(torch.cat([v.to_array().T for v in got]), want)


def _rays(n=8):
    o = TVec3(*(torch.zeros(n) for _ in range(3)))
    d = TVec3(torch.zeros(n), torch.zeros(n), -torch.ones(n))
    return o, d


def test_unsupported_scenes_raise():
    scene, _, cfg = t_cornell_box(device="cpu")
    cfg = cfg.replace(max_bounces=2)
    o, d = _rays()
    draws = torch.rand(2, 3, 8)
    from raytpu_torch.scenes import mesh_branch_scene

    mesh = mesh_branch_scene(device="cpu")[0]
    for bad, why in (
        (TScene(scene.spheres, mesh.triangles, mesh.atlas, mesh.mat_table),
         "triangles"),
        (TScene(scene.spheres, sky_sphere_index=10), "sky"),
    ):
        assert not tts.supported(bad, cfg)
        with pytest.raises(NotImplementedError, match=why):
            tts.trace_megakernel(bad, cfg, o, d, draws)
    rows = [((i, 0, -5), 0.1, (1, 1, 1), (0, 0, 0), 0.0, 0.0, 1.0, 1.0)
            for i in range(65)]
    from raytpu_torch.scenes import spheres_from_rows

    many = TScene(spheres_from_rows(rows, device="cpu"))
    assert tts.unsupported_reasons(many, cfg) == ["65 spheres > 64"]
    with pytest.raises(NotImplementedError, match="65 spheres"):
        tts.trace_megakernel(many, cfg, o, d, draws)


def test_converted_mesh_and_sky_scenes_are_refused():
    """convert carries triangles over as facts, so K1 refuses such a
    scene instead of rendering its spheres alone; a textured sky comes
    over with its texels, and K1 serves it."""
    scene, _, _ = jscenes.cornell_box()
    arrays = _arrays(scene, sky_sphere_index=-1)
    assert tts.supported(convert.scene_from_arrays(arrays, device="cpu"), TConfig())
    mesh = dict(arrays, **{k: np.zeros(3, np.float32)
                           for k in convert.TRIANGLE_LEAVES},
                **{"triangles.mat_id": np.zeros(3, np.int32)})
    mesh_scene = convert.scene_from_arrays(mesh, device="cpu")
    assert mesh_scene.n_triangles == 3
    assert not tts.supported(mesh_scene, TConfig())
    sky = dict(arrays, **{k: np.ones(4, np.float32) for k in convert.SKY_LEAVES},
               **{"sky.width": 2, "sky.height": 2}, sky_sphere_index=9)
    sky_scene = convert.scene_from_arrays(sky, device="cpu")
    assert sky_scene.sky_sphere_index == sky_scene.sky_index == 9
    assert (sky_scene.sky.width, sky_scene.sky.height) == (2, 2)
    assert tts.supported(sky_scene, TConfig())
    # a sky index with no sky texture is a plain emitter in raytpu too
    plain = dict(arrays, sky_sphere_index=9)
    assert convert.scene_from_arrays(plain, device="cpu").sky_sphere_index == -1


@pytest.mark.parametrize("name", sorted(SCENES))
def test_recording_matches_raytpu(name):
    """The plain version's recording mode against raytpu's K1 with
    ``with_indices`` in interpret mode: the same winner indices (-1 for a
    miss or a finished ray) and AO factors on all but 2% of entries
    (grazing-hit flips, as for the planes), and with recording on the nine
    planes are unchanged."""
    scene, cfg, tscene, tcfg, rays, draws = _inputs(name)
    o, d = JVec3(*map(jnp.asarray, rays[:3])), JVec3(*map(jnp.asarray, rays[3:]))
    _, want_idx, want_aof = jts._mk_forward(scene, cfg, o, d, jnp.asarray(draws),
                                            True, with_indices=True)
    k = tts.Knobs.create(tcfg, tscene.spheres.count, draws.shape[1])
    sph = tts.pack_spheres(tscene)
    trays = [torch.tensor(c) for c in rays]
    flat = torch.tensor(draws.reshape(-1, draws.shape[-1]))
    out, idx, aof = tts.trace_spheres_reference(sph, *trays, flat, k, record=True)
    assert idx.dtype == torch.int32 and idx.shape == (cfg.max_bounces, flat.shape[1])
    assert torch.equal(out, tts.trace_spheres_reference(sph, *trays, flat, k))
    same = idx.numpy() == np.asarray(want_idx)
    assert same.mean() >= 1 - OUTLIER_FRAC, f"{1 - same.mean():.2%} differ"
    assert (idx >= 0).any() and (idx == -1).any() == (np.asarray(want_idx) == -1).any()
    if cfg.use_ao:
        diff = np.abs(aof.numpy() - np.asarray(want_aof))[same]
        assert (diff > 0).mean() <= OUTLIER_FRAC
    else:
        assert aof is None and want_aof is None


def test_requires_grad_runs_record_and_replay():
    """With a leaf that requires grad the wrapper records winners and its
    backward is the replay: on CPU tensors both plain versions, no launch,
    the same cotangents as ``replay_reference`` and none for the draws."""
    from raytpu_torch.kernels import trace_scene_bwd as tbwd

    scene, _, cfg = t_cornell_box(device="cpu")
    cfg = cfg.replace(max_bounces=3)
    rs = np.random.default_rng(5)
    o = TVec3(*(torch.zeros(16) for _ in range(3)))
    d = TVec3(*torch.tensor(rs.normal(size=(3, 16)).astype(np.float32)))
    draws = torch.tensor(rs.random((3, 3, 16), np.float32)).requires_grad_()
    leaves = convert.scene_leaves(scene)
    leaves = {n: v.clone().requires_grad_() for n, v in leaves.items()}
    dz = d.z.clone().requires_grad_()
    before = (tts.launches, tbwd.launches)
    r, a, n = tts.trace_megakernel(convert.scene_from_leaves(leaves), cfg, o,
                                   TVec3(d.x, d.y, dz), draws)
    g = torch.tensor(rs.uniform(-1, 1, (9, 16)).astype(np.float32))
    torch.autograd.backward([*r, *a, *n], list(g.unbind(0)))
    assert (tts.launches, tbwd.launches) == before
    assert draws.grad is None
    k = tts.Knobs.create(cfg, 10, 3)
    sph = tts.pack_spheres(scene)
    flat = draws.detach().reshape(9, 16)
    _, idx, aof = tts.trace_spheres_reference(sph, *o, *d, flat, k, record=True)
    d_sph, *_, d_rays = tbwd.replay_reference(tbwd.Tables.of_spheres(sph),
                                              (*o, *d), flat, idx, aof, g, k)
    got = torch.stack([leaves[p].grad for p in convert.SPHERE_LEAVES])
    torch.testing.assert_close(got, d_sph, rtol=0, atol=0)
    torch.testing.assert_close(dz.grad, d_rays[5], rtol=0, atol=0)


def test_bad_draw_shapes_raise():
    scene, _, cfg = t_cornell_box(device="cpu")
    cfg = cfg.replace(max_bounces=2, use_ao=True, ao_samples=2)
    o, d = _rays()
    with pytest.raises(ValueError, match="bounce_draws"):
        tts.trace_megakernel(scene, cfg, o, d, torch.rand(2, 3, 8))
    with pytest.raises(ValueError, match="must be f32 with B=9"):
        tts.trace_megakernel(scene, cfg, o, d, torch.rand(2, 7, 9))
    flat = TVec3(d.x, d.y, d.z.reshape(1, 8))
    with pytest.raises(ValueError, match=r"got torch.float32 \(1, 8\)"):
        tts.trace_megakernel(scene, cfg, o, flat, torch.rand(2, 7, 8))
