"""Gradients through mesh scenes: the port's K3 recording mode, K2's mesh
mode and the trainer against raytpu.

Scenes: the 60-triangle ``write_block_world(..., seed=3)`` (water, glass
cutout/window tiles, an emissive tile), the same mesh untextured, its AO
variant (2 samples), and ``mesh_branch_scene``. In every scene the sky-dome
sphere (index 2; radius 1e5 in the block world, 1e4 in the branch scene)
is shrunk to radius 100, in raytpu's copy and the port's alike: a ray
scattered from the dome's own surface hits it again or not by rounding
(|p - c|^2 is 1e10 there, so the quadratic cannot resolve an ulp of the
scatter direction, whose sin/cos XLA and torch round differently), which
flips up to 9% of the recorded winners and every later gradient of those
rays. At radius 100 the self-hit test is decided by the geometry.

Inputs come from numpy seeds. Tolerances:

* (a) K3 recording: the port's plain version against raytpu's K3 in
  interpret mode (``_mkm_forward(with_indices=True)``, no merged quads):
  at least 98% of the winners equal (a water refraction can take the other
  branch on 1-2% of the rays against the compiled side, ``ROADMAP.md``
  F7), and the AO factors equal where they are used: on the live entries
  of the rays whose winners all agree, at most 2% may differ. The
  recording leaves the nine planes bit for bit as they are.
* (b) K2's plain mesh mode (``replay_reference``) against raytpu's
  ``mesh_backward`` in interpret mode, on raytpu's recorded winners, AO
  factors, draws and a random output cotangent, compared on the scene
  leaves (the port's table cotangents pulled back through its packers by
  autograd) by ``test_torch_trace_scene_bwd``'s rules: each leaf within
  1e-4 of its largest |entry| + 1e-6; a ray is an outlier if one of its
  six cotangents differs by more than 1e-4 + 1e-4|x|, and at most 2% may.
  The cotangent is zero on the rays whose winners the port's own
  recording does not reproduce (the flips of (a), and hits recorded
  within an ulp of an epsilon gate, such as a refracted ray that meets
  its own water triangle again at t ~ tri_eps): each replay recomputes
  such a hit with its own rounding, so one side may keep it and the
  other turn it into a miss. At least 90% of the rays are compared.
  Once more on the block world as written (dome radius 1e5), the same
  way: there the dome's self-hits flip the winners of ~25% of the rays
  at 16x12 and 4 bounces, so at least 70% are compared.
* (c) Gradients through the port's ``render`` against ``jax.grad`` through
  raytpu's ``render`` at 8x6 pixels, 1 spp, 3 bounces, on every float
  leaf, with ``test_torch_grad``'s tolerance: |port - raytpu| <= 1e-3
  |raytpu| + 1e-5 (the leaf's largest |gradient|) + 1e-8. raytpu runs its
  scan path under ``jax.disable_jit``, as the forward tests of
  ``test_torch_trace_scene`` do: with its K3 and mesh backward in
  interpret mode (compiled), one ray takes F7's other branch and moves
  the sky dome's emission gradient by 0.6% of an entry (1.4e-4 against a
  tolerance of 2.6e-5).
* (e) The replay reproduces the recording forward's planes to 1e-6, and
  its cotangents stay finite on misses, on a zero-area triangle and on a
  material with ior == 0.

The trainer on a mesh scene (Adam steps against raytpu's, ``cli train
<world.toml>``) is tested in ``test_torch_train.py``, so that the two
files run on two workers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.types import TextureAtlas as JAtlas
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator import render as jrender
from raytpu.integrator.path import n_bounce_draws
from raytpu.kernels import trace_scene as jts
from raytpu.kernels.trace_scene_bwd import mesh_backward as j_mesh_backward
from raytpu.train import combine_scene as j_combine
from raytpu.train import partition_scene as j_partition
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.types import TextureAtlas as TAtlas
from raytpu_torch.integrator.render import render as t_render
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.kernels.trace_spheres import pack_spheres
from raytpu_torch.scenes import mesh_branch_scene, write_block_world
from tests.test_mesh_megakernel import _synthetic_textured_scene

IDX_AGREE, OUTLIER_FRAC = 0.98, 0.02
ATOL, RTOL = 1e-4, 1e-5                   # forward planes
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6         # (b), per leaf
G_ATOL, G_RTOL = 1e-4, 1e-4               # (b), ray cotangents
GRAD_RTOL, GRAD_SCALE, GRAD_ATOL = 1e-3, 1e-5, 1e-8   # (c)
DOME, DOME_RADIUS = 2, 100.0
SHIPPED_KEPT = 0.7
SCENES = ("block_world", "block_world_ao", "untextured", "branches")
SEEDS = {name: i for i, name in enumerate((*SCENES, "shipped"))}


def _arrays(tree, **static):
    d = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    d.update(static)
    return d


def _small_dome(js, ts):
    r = ts.spheres.radius.clone()
    r[DOME] = DOME_RADIUS
    return (js.replace(spheres=js.spheres.replace(
                radius=js.spheres.radius.at[DOME].set(DOME_RADIUS))),
            dataclasses.replace(ts, spheres=dataclasses.replace(
                ts.spheres, radius=r)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)


def _scene(world, name):
    """(raytpu scene, camera, port scene, camera, raytpu config); "shipped"
    is the block world with its sky dome as written."""
    if name == "branches":
        js, jc = _synthetic_textured_scene()
        ts, tc, cfg = mesh_branch_scene(device="cpu")
        jcfg = JConfig(**dataclasses.asdict(cfg))
    else:
        js, jc, jcfg = jconfig.load_scene_file(world)
        ts, tc, _ = tconfig.load_scene_file(world, device="cpu")
    if name == "untextured":
        js = js.replace(atlas=JAtlas.empty())
        ts = dataclasses.replace(ts, atlas=TAtlas.empty("cpu"))
    over = dict(max_bounces=4, merge_quads=False)
    if name == "block_world_ao":
        over.update(use_ao=True, ao_samples=2)
    if name != "shipped":
        js, ts = _small_dome(js, ts)
    return js, jc, ts, tc, jcfg.replace(**over)


def _inputs(jcam, cfg, seed):
    """Camera rays and (bounces, draws, B) bounce draws from a numpy seed,
    as raytpu arrays and as port tensors."""
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = jrender.sample_rays(jcam, cfg, jnp.arange(b, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    t = lambda v: tuple(torch.tensor(np.asarray(c)) for c in v)
    return (o, d, jnp.asarray(draws)), (*t(o), *t(d)), torch.tensor(draws)


def _knobs(cfg, ts, draws):
    return tts.MeshKnobs.for_scene(TConfig(**dataclasses.asdict(cfg)), ts,
                                   draws.shape[1])


@pytest.fixture(scope="module")
def recordings():
    """(a)'s and (b)'s shared batches, by scene name (``_recorded``)."""
    return {}


def _recorded(cache, world, name):
    """One 16x12 batch per scene, recorded by raytpu's K3 in interpret
    mode and by the port's plain version, shared by (a) and (b)."""
    if name not in cache:
        js, jc, ts, tc, cfg = _scene(world, name)
        cfg = cfg.replace(width=16, height=12)
        jin, rays, draws = _inputs(jc, cfg, SEEDS[name] + 31)
        jout, jidx, jaof = jts._mkm_forward(js, cfg, *jin, True,
                                            with_indices=True)
        port = tts.trace_scene_reference(
            tts.pack_scene(ts), *rays, draws.reshape(-1, cfg.n_pixels),
            _knobs(cfg, ts, draws), record=True)
        cache[name] = (js, ts, cfg, jin, rays, draws, jout, np.asarray(jidx),
                       None if jaof is None else np.asarray(jaof), port)
    return cache[name]


@pytest.mark.parametrize("name", SCENES)
def test_recording_matches_raytpu_kernel(recordings, world, name):
    """(a)"""
    _, ts, cfg, _, rays, draws, jout, jidx, jaof, port = _recorded(
        recordings, world, name)
    k = _knobs(cfg, ts, draws)
    tb = tts.pack_scene(ts)
    flat = draws.reshape(-1, draws.shape[-1])
    out, idx, aof = port
    assert torch.equal(out, tts.trace_scene_reference(tb, *rays, flat, k))
    want = np.concatenate([np.stack([np.asarray(c) for c in v]) for v in jout])
    bad = (np.abs(out.numpy() - want) > ATOL + RTOL * np.abs(want))
    assert bad.any(0).mean() <= OUTLIER_FRAC
    assert idx.dtype == torch.int32 and idx.shape == jidx.shape
    idx = idx.numpy()
    assert (idx == jidx).mean() >= IDX_AGREE, f"{(idx == jidx).mean():.4f}"
    if name != "branches":     # its quads face away from the camera
        assert (idx >= ts.spheres.count).any()      # triangle winners
    if cfg.use_ao:
        rays_agree = (idx == jidx).all(0, keepdims=True)
        used = rays_agree & (idx >= 0)
        assert used.sum() > 0
        differ = (aof.numpy() != jaof) & used
        assert differ.sum() <= OUTLIER_FRAC * used.sum()
    else:
        assert aof is None and jaof is None


def _port_leaf_grads(ts, d_tabs):
    """The table cotangents pulled back through the packers onto the
    scene's float leaves (what raytpu's ``jax.vjp`` of ``_pack_diff``
    does)."""
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    tabs = (pack_spheres(scene), tts.pack_tri(scene), tts.pack_mats(scene),
            tts.pack_atlas(scene))
    pairs = [(t, d) for t, d in zip(tabs, d_tabs) if t.requires_grad]
    torch.autograd.backward(*map(list, zip(*pairs)))
    return {p: v.grad for p, v in leaves.items()}


def _leaf(tree, path):
    for part in path.split("."):
        tree = getattr(tree, part)
    return np.asarray(tree)


def _check_replay(recordings, world, name, min_kept):
    """(b) on one scene; returns the fraction of rays compared."""
    js, ts, cfg, jin, rays, draws, _, jidx, jaof, port = _recorded(
        recordings, world, name)
    b = cfg.n_pixels
    g = np.random.default_rng(SEEDS[name] + 41).uniform(
        -1, 1, (9, b)).astype(np.float32)
    kept = (port[1].numpy() == jidx).all(0)
    assert kept.mean() >= min_kept, f"{kept.mean():.3f}"
    g[:, ~kept] = 0.0
    g_vecs = [JVec3(*map(jnp.asarray, g[3 * j:3 * j + 3])) for j in range(3)]
    d_scene, d_o, d_d, _ = j_mesh_backward(
        js, cfg, *jin, jnp.asarray(jidx), g_vecs, True,
        aof=None if jaof is None else jnp.asarray(jaof))

    k = _knobs(cfg, ts, draws)
    tb = tts.pack_scene(ts)
    before = tbwd.launches
    *d_tabs, d_rays = tbwd.mesh_backward(
        tbwd.Tables(tb.sph, tb.tri, tb.mats, tb.atlas), rays,
        draws.reshape(-1, b), torch.tensor(jidx),
        None if jaof is None else torch.tensor(jaof), torch.tensor(g), k)
    assert tbwd.launches == before        # CPU tensors: the plain version
    got = _port_leaf_grads(ts, d_tabs)
    groups = set()
    for path, grad in got.items():
        want = _leaf(d_scene, path)
        assert np.isfinite(grad.numpy()).all(), path
        scale = np.abs(want).max(initial=0.0)
        err = np.abs(grad.numpy() - want)
        assert (err <= LEAF_RTOL * scale + LEAF_ATOL).all(), (
            f"{path}: off by {err.max():.3e}, leaf max {scale:.3e}")
        if scale > 0:
            groups.add(path.split(".")[0])
    if name != "branches":
        assert {"spheres", "triangles", "mat_table"} <= groups
    assert "spheres" in groups
    want_rays = np.stack([np.asarray(c) for c in (*d_o, *d_d)])
    got_rays = torch.stack(d_rays).numpy()
    assert np.isfinite(got_rays).all()
    bad = (np.abs(got_rays - want_rays) > G_ATOL + G_RTOL * np.abs(want_rays))
    assert bad.any(0).mean() <= OUTLIER_FRAC
    return kept.mean()


@pytest.mark.parametrize("name", SCENES)
def test_replay_matches_raytpu_mesh_backward(recordings, world, name):
    """(b)"""
    _check_replay(recordings, world, name, 0.9)


def test_replay_matches_raytpu_at_shipped_dome(recordings, world):
    """(b) on the block world as written, sky dome of radius 1e5: on the
    rays whose winners raytpu's K3 and the port's plain version record
    alike, at least SHIPPED_KEPT of them."""
    _check_replay(recordings, world, "shipped", SHIPPED_KEPT)


def test_render_grads_match_raytpu(world):
    """(c): every float leaf, through ``render`` on both sides; the loss
    reads radiance and the normal AOV (``test_mesh_megakernel``), so the
    triangle vertices carry gradient too. At least five leaf groups (a
    vector leaf's three components count once) have a nonzero reference
    gradient."""
    js, jc, ts, tc, cfg = _scene(world, "block_world")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=3)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    params, static = j_partition(js)

    def j_loss(p):
        sums = jrender.render(j_combine(p, static), jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(61))
        return (jnp.mean((sums.radiance.to_array() / cfg.spp - 0.2) ** 2)
                + jnp.mean((sums.normal.to_array() / cfg.spp) ** 2))

    with jax.disable_jit():
        want = _arrays(jax.grad(j_loss)(params))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    # the port's kernel route (K3 recording, K2); raytpu's config its scan
    tcfg = TConfig(**dataclasses.asdict(cfg)).replace(use_megakernel=True)
    sums = t_render(scene, tc, tcfg, pids, trng.prng_key(61))
    (torch.mean((sums.radiance.to_array() / tcfg.spp - 0.2) ** 2)
     + torch.mean((sums.normal.to_array() / tcfg.spp) ** 2)).backward()
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


def _small_batch(world):
    _, jc, ts, _, cfg = _scene(world, "block_world")
    cfg = cfg.replace(width=6, height=4, max_bounces=3)
    _, rays, draws = _inputs(jc, cfg, 71)
    return ts, cfg, rays, draws.reshape(-1, cfg.n_pixels), _knobs(cfg, ts, draws)


def test_replay_reproduces_recording_and_stays_finite(world):
    """(e)"""
    ts, cfg, rays, flat, k = _small_batch(world)
    tb = tts.pack_scene(ts)
    tabs = tbwd.Tables(tb.sph, tb.tri, tb.mats, tb.atlas)
    out, idx, aof = tts.trace_scene_reference(tb, *rays, flat, k, record=True)
    torch.testing.assert_close(tbwd.replay_forward(tabs, rays, flat, idx,
                                                   aof, k),
                               out, rtol=1e-6, atol=1e-6)

    b = cfg.n_pixels
    tri = tb.tri.clone()
    t0 = int(idx[0][idx[0] >= k.n_spheres][0]) - k.n_spheres
    tri[3:12, t0] = 0.0                  # the winner's edges and normal: zero area
    mats = tb.mats.clone()
    mats[5] = 0.0                        # ior == 0 on every material
    z = torch.zeros(b)
    away = (z, z + 50.0, z, z, z + 1.0, z)     # above the world, leaving
    misses = 0
    for r in (rays, away):
        i2 = tts.trace_scene_reference(tts.mesh_tables(tb.sph, tri, mats,
                                                       tb.atlas),
                                       *r, flat, k, record=True)[1]
        i2[0, :2] = k.n_spheres + t0      # recorded on the zero-area triangle
        misses += int((i2 == -1).sum())
        d = tbwd.replay_reference(tbwd.Tables(tb.sph, tri, mats, tb.atlas),
                                  r, flat, i2, None, torch.ones(9, b), k)
        for t in (*d[:4], *d[4]):
            assert torch.isfinite(t).all()
    assert misses > 0
