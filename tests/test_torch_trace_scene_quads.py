"""K3's merged-quad search in the port (``trace_scene_reference`` with a
``QuadPlan``) against raytpu's.

Scenes, each loaded by both packages with ``merge_quads`` on (the
default): ``scenes.write_quad_fixture`` (rects of both orientations in all
six axis groups, unpaired axis-aligned triangles, 80 tilted
parallelograms and 80 tilted leftovers behind the chunk cull, a
mixed-material pair), and the 60-triangle block world under a 16x8 sky
with AO. The block world's sky dome is shrunk to radius 100 on both sides
(``test_torch_mesh_grad``'s reason: a ray scattered from the 1e5 dome
meets it again or not by rounding). Inputs come from numpy seeds.

* Forward and recording against raytpu's K3 in interpret mode
  (``_mkm_forward(with_indices=True)``, merged), 16x12 rays, 3-4
  bounces, ``test_torch_trace_scene``'s tolerance: a ray is an outlier if
  a channel of its planes (9, 16 with the sky) differs by more than
  1e-4 + 1e-5|x|, at most 2% may be; at least 98% of the winners equal,
  AO factors equal where used on the rays whose winners agree (at most
  2% of entries differ); recording leaves the planes as they are.
* Merged against per-triangle, the bars of
  ``tests/test_quad_merge.py::test_merged_matches_scan``: radiance, albedo
  and normal against raytpu's scan (run eagerly, F7) at most 2% outlier
  rays; winners against the port's per-triangle search at least 99% equal
  at bounce 0 and 95% over all bounces.
* A mesh with no pairs: the flag on and off give the same bits.
* The ``|d| = 2`` miss (``test_miss_with_nonunit_direction_no_phantom_hit``):
  no group's miss becomes a hit.
* Gradients of every float leaf through the port's ``render`` on the
  default-loaded world (merged K3 recording, K2) against ``jax.grad``
  through raytpu's interpret merged K3 and its K2 on the same sample's
  rays, the loss over the rays whose winners agree,
  ``test_torch_mesh_grad`` (c)'s tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core import rng as jrng
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator import render as jrender
from raytpu.integrator.path import n_bounce_draws, trace
from raytpu.kernels import trace_scene as jts
from raytpu.train import combine_scene as j_combine
from raytpu.train import partition_scene as j_partition
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator import render as trender
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.scenes import (write_block_world, write_equirect_sky,
                                 write_quad_fixture)
from tests.test_torch_mesh_grad import _arrays
from tests.test_torch_sky import _cfg

ATOL, RTOL, OUTLIER_FRAC, IDX_AGREE = 1e-4, 1e-5, 0.02, 0.98
AGREE0, AGREE_ALL = 0.99, 0.95
GRAD_RTOL, GRAD_SCALE, GRAD_ATOL = 1e-3, 1e-5, 1e-8
DOME_RADIUS = 100.0
SCENES = {"fixture": dict(width=16, height=12, max_bounces=4),
          "world_sky_ao": dict(width=16, height=12, max_bounces=3,
                               use_ao=True, ao_samples=1)}


@pytest.fixture(scope="module")
def tomls(tmp_path_factory):
    base = tmp_path_factory.mktemp("merged")
    sky = str(base / "world")
    os.makedirs(sky)
    write_equirect_sky(os.path.join(sky, "sky.ppm"), 16, 8, seed=2)
    return {
        "fixture": write_quad_fixture(str(base / "fixture"), seed=0),
        "world": write_block_world(str(base / "w60"), 60, seed=3),
        "world_sky_ao": write_block_world(sky, 60, seed=3, sky="sky.ppm"),
    }


def _small_dome(js, ts):
    """The block world's sky dome (its last sphere) at radius 100."""
    i = ts.spheres.count - 1
    r = ts.spheres.radius.clone()
    r[i] = DOME_RADIUS
    return (js.replace(spheres=js.spheres.replace(
                radius=js.spheres.radius.at[i].set(DOME_RADIUS))),
            dataclasses.replace(ts, spheres=dataclasses.replace(
                ts.spheres, radius=r)))


def _load(path, **over):
    """(raytpu scene, camera, port scene, raytpu config), merged."""
    js, jc, jcfg = jconfig.load_scene_file(path)
    ts = tconfig.load_scene_file(path, device="cpu")[0]
    if js.spheres.radius[-1] > DOME_RADIUS:
        js, ts = _small_dome(js, ts)
    assert jcfg.merge_quads and jcfg.quad_pairs
    return js, jc, ts, jcfg.replace(**over)


def _inputs(jcam, cfg, seed):
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = jrender.sample_rays(jcam, cfg, jnp.arange(b, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    rays = tuple(torch.tensor(np.asarray(c)) for c in (*o, *d))
    return (o, d, jnp.asarray(draws)), rays, torch.tensor(draws)


@pytest.fixture(scope="module")
def recorded(tomls):
    """One batch per scene through raytpu's interpret merged K3 and the
    port's plain merged and per-triangle versions, shared by the tests."""
    out = {}
    for i, (name, over) in enumerate(SCENES.items()):
        js, jc, ts, cfg = _load(tomls[name], **over)
        jin, rays, draws = _inputs(jc, cfg, 70 + i)
        jout, jidx, jaof = jts._mkm_forward(js, cfg, *jin, True,
                                            with_indices=True)
        flat = draws.reshape(-1, cfg.n_pixels)
        k = tts.MeshKnobs.for_scene(_cfg(cfg), ts, draws.shape[1])
        tri = tts.MeshKnobs.for_scene(_cfg(cfg.replace(merge_quads=False)),
                                      ts, draws.shape[1])
        assert k.plan is not None and tri.plan is None
        out[name] = dict(
            js=js, ts=ts, cfg=cfg, jin=jin, rays=rays, flat=flat, k=k,
            jout=np.concatenate([np.stack([np.asarray(c) for c in v])
                                 if isinstance(v, JVec3) else
                                 np.asarray(v)[None] for v in jout]),
            jidx=np.asarray(jidx), jaof=None if jaof is None else np.asarray(jaof),
            port=tts.trace_scene_reference(tts.pack_scene(ts, k), *rays, flat,
                                           k, record=True),
            tri=tts.trace_scene_reference(tts.pack_scene(ts), *rays, flat, tri,
                                          record=True))
    return out


def _outlier_frac(got, want):
    return (np.abs(got - want) > ATOL + RTOL * np.abs(want)).any(0).mean()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_merged_matches_raytpu_kernel(recorded, name):
    r = recorded[name]
    out, idx, aof = r["port"]
    plain = tts.trace_scene_reference(tts.pack_scene(r["ts"], r["k"]),
                                      *r["rays"], r["flat"], r["k"])
    assert torch.equal(out, plain)          # recording leaves the planes
    assert out.shape[0] == r["jout"].shape[0] == (
        16 if name == "world_sky_ao" else 9)
    assert np.isfinite(out.numpy()).all()
    frac = _outlier_frac(out.numpy(), r["jout"])
    assert frac <= OUTLIER_FRAC, f"{frac:.2%} rays differ"
    idx, jidx = idx.numpy(), r["jidx"]
    assert (idx == jidx).mean() >= IDX_AGREE, f"{(idx == jidx).mean():.4f}"
    assert (idx >= r["ts"].spheres.count).any()      # triangle winners
    if r["cfg"].use_ao:
        used = (idx == jidx).all(0, keepdims=True) & (idx >= 0)
        assert used.sum() > 0
        differ = (aof.numpy() != r["jaof"]) & used
        assert differ.sum() <= OUTLIER_FRAC * used.sum()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_merged_against_per_triangle(recorded, name):
    r = recorded[name]
    with jax.disable_jit():
        want = trace(r["js"], r["cfg"], *r["jin"])
    want = np.concatenate([np.stack([np.asarray(c) for c in v])
                           for v in want[:3]])
    cfg, rays = _cfg(r["cfg"]), r["rays"]     # the sky texel composed
    got = tts.trace_mesh_megakernel(
        r["ts"], cfg, TVec3(*rays[:3]), TVec3(*rays[3:]),
        r["flat"].reshape(cfg.max_bounces, -1, cfg.n_pixels))
    frac = _outlier_frac(torch.cat([v.to_array().T for v in got]).numpy(),
                         want)
    assert frac <= OUTLIER_FRAC, f"merged vs scan: {frac:.2%} rays differ"
    q, p = r["port"][1].numpy(), r["tri"][1].numpy()
    assert (q[0] == p[0]).mean() >= AGREE0, f"bounce 0 {(q[0] == p[0]).mean()}"
    assert (q == p).mean() >= AGREE_ALL, f"all bounces {(q == p).mean()}"


def test_zero_pair_mesh_identical(tmp_path):
    """A mesh with no quad pairs takes the per-triangle search with the
    flag on or off: the same bits."""
    path = write_quad_fixture(str(tmp_path), seed=5, n_boxes=0, n_aa=6,
                              n_quads=0, n_left=70)
    ts, tc, cfg = tconfig.load_scene_file(path, device="cpu")
    assert cfg.merge_quads and cfg.quad_pairs == ()
    cfg = cfg.replace(width=8, height=6, max_bounces=3)
    assert tts.quad_plan(cfg, ts.triangles.count) is None
    rs = np.random.default_rng(9)
    o, d = trender.sample_rays(tc, cfg, torch.arange(cfg.n_pixels),
                               torch.tensor(rs.random((4, 48), np.float32)))
    draws = torch.tensor(rs.random((3, 3, 48), np.float32))
    on = tts.trace_mesh_megakernel(ts, cfg, o, d, draws)
    off = tts.trace_mesh_megakernel(ts, cfg.replace(merge_quads=False), o, d,
                                    draws)
    for a, b in zip(on, off):
        assert torch.equal(a.to_array(), b.to_array())
    assert float(on[0].to_array().abs().sum()) > 0


def test_miss_with_nonunit_direction_no_phantom_hit(tomls):
    """Rays far outside the geometry, pointing away, |d| = 2: every group
    misses, and the bg < BIG gate keeps BIG * bden < best * deng (an
    overflow to inf) from fabricating a hit; the same bits as raytpu's
    scan and the per-triangle search."""
    js, _, ts, cfg = _load(tomls["world"], max_bounces=2, width=16, height=8)
    b = 128
    o = (jnp.full((b,), 500.0),) * 3
    d = (jnp.full((b,), 2.0), jnp.zeros((b,)), jnp.zeros((b,)))
    draws = np.full((2, n_bounce_draws(cfg), b), 0.5, np.float32)
    with jax.disable_jit():
        want = trace(js, cfg, JVec3(*o), JVec3(*d), jnp.asarray(draws))
    t = lambda v: TVec3(*(torch.tensor(np.asarray(c)) for c in v))
    tcfg = _cfg(cfg)
    got = tts.trace_mesh_megakernel(ts, tcfg, t(o), t(d), torch.tensor(draws))
    k = tts.MeshKnobs.for_scene(tcfg, ts, draws.shape[1])
    assert k.plan is not None
    _, idx, _ = tts.trace_scene_reference(
        tts.pack_scene(ts, k), *(torch.tensor(np.asarray(c)) for c in o + d),
        torch.tensor(draws.reshape(-1, b)), k, record=True)
    assert (idx == -1).all()
    per_tri = tts.trace_mesh_megakernel(ts, tcfg.replace(merge_quads=False),
                                        t(o), t(d), torch.tensor(draws))
    for g, w, p in zip(got, want, per_tri):
        np.testing.assert_array_equal(g.to_array().numpy(),
                                      np.stack(list(map(np.asarray, w)), -1))
        assert torch.equal(g.to_array(), p.to_array())


def test_render_grads_merged_match_raytpu(tomls):
    """Every float leaf's gradient through the port's ``render`` on the
    default-loaded world (the merged search) against ``jax.grad`` through
    raytpu's interpret merged K3 and K2 on the same sample's rays (1 spp:
    render's sum is the kernel's output), the loss over the rays whose
    recorded winners agree."""
    js, jc, ts, cfg = _load(tomls["world"], width=8, height=6, spp=1,
                            max_bounces=3)
    tc = tconfig.load_scene_file(tomls["world"], device="cpu")[1]
    b = cfg.n_pixels
    pids = np.arange(b, dtype=np.int32)
    ray_keys = jrng.sample_keys(
        jrng.pixel_keys(jax.random.PRNGKey(61), jnp.asarray(pids)), jnp.int32(0))
    cam_draws, draws = jrng.ray_uniforms(ray_keys, 4, n_bounce_draws(cfg),
                                         cfg.max_bounces)
    o, d = jrender.sample_rays(jc, cfg, jnp.asarray(pids), cam_draws)
    _, jidx, _ = jts._mkm_forward(js, cfg, o, d, draws, True,
                                  with_indices=True)
    k = tts.MeshKnobs.for_scene(_cfg(cfg), ts, draws.shape[1])
    _, idx, _ = tts.trace_scene_reference(
        tts.pack_scene(ts, k), *(torch.tensor(np.asarray(c)) for c in (*o, *d)),
        torch.tensor(np.asarray(draws).reshape(-1, b)), k, record=True)
    agree = (idx.numpy() == np.asarray(jidx)).all(0)
    assert agree.mean() >= 0.9, f"{agree.mean():.3f}"
    mask = agree.astype(np.float32)

    params, static = j_partition(js)

    def j_loss(p):
        rad, _, nrm = jts.trace_mesh_megakernel(j_combine(p, static), cfg, o,
                                                d, draws, interpret=True)
        m = jnp.asarray(mask)
        return (jnp.mean(m * (rad.to_array().T - 0.2) ** 2)
                + jnp.mean(m * nrm.to_array().T ** 2))

    want = _arrays(jax.grad(j_loss)(params))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    tcfg = _cfg(cfg).replace(use_megakernel=True)
    assert trender.trace_fn(scene, tcfg) is tts.trace_mesh_megakernel
    sums = trender.render(scene, tc, tcfg, pids, trng.prng_key(61))
    m = torch.tensor(mask)
    (torch.mean(m * (sums.radiance.to_array().T - 0.2) ** 2)
     + torch.mean(m * sums.normal.to_array().T ** 2)).backward()
    groups = set()
    for path, leaf in leaves.items():
        got = np.asarray(leaf.grad.numpy(), np.float64)
        w = np.asarray(want[path], np.float64)
        assert np.isfinite(got).all(), path
        tol = GRAD_RTOL * np.abs(w) + GRAD_SCALE * np.abs(w).max() + GRAD_ATOL
        assert (np.abs(got - w) <= tol).all(), (
            f"{path}: max |diff| {np.abs(got - w).max():.3e}, max |grad| "
            f"{np.abs(w).max():.3e}")
        if np.abs(w).max() > 0:
            groups.add(path.rsplit(".", 1)[0] if path[-2:] in (".x", ".y", ".z")
                       else path)
    assert len(groups) >= 5, sorted(groups)
