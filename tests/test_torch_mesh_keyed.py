"""The keyed mesh route against raytpu: each ray's threefry key in place of
a draw buffer for K3 and K2's mesh mode.

K3 (per-triangle and merged search, forward and recording, with and
without the sky slot) and K2's mesh mode take the rays' keys ((2, B)
int32 words of ``rng.sample_stream``) and hash each draw where they read
it: draw j of bounce b at counter ``4 + b * n_draws + j``, the AO probes'
pairs at ``3 + 2s`` and ``4 + 2s`` of their bounce. On CPU tensors their
plain versions read the same draws from the eager stream
(``rng.bounce_draws``). Held here, tolerance none unless stated, on the
60-triangle block world (with and without AO), the 600-triangle one,
``write_quad_fixture`` and the 60-triangle world under a 16x8 sky:

* K3's plain entry on the keys bit-equal to its buffer entry, forward and
  recording, per-triangle and merged, AO probes included, through
  ``trace_mesh_megakernel`` too (the sky world's 16 planes composed);
* K2's mesh plain entry on the keys bit-equal to its buffer entry;
* both against raytpu with JAX's draws of the same keys (K3 in interpret
  mode, ``mesh_backward``), at ``test_torch_mesh_grad``'s tolerances;
* ``render`` on the CPU mesh route bit-identical to the buffer route it
  replaced, sums and every leaf's gradient;
* the RNG rows each route's sample start asks for: 4 on the mesh
  megakernel route, 4 + bounces x n_bounce_draws on the scan path;
* K3's and K2's ``_launch`` refuse a draw buffer before anything is
  built.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core import rng as jrng
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator import render as jrender
from raytpu.kernels import trace_scene as jts
from raytpu.kernels.trace_scene_bwd import mesh_backward as j_mesh_backward
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator import render as trender
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.kernels import _build
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.scenes import (write_block_world, write_equirect_sky,
                                 write_quad_fixture)
from raytpu_torch.train import combine_scene, partition_scene
from tests.test_torch_keyed import _key_pairs, _words
from tests.test_torch_mesh_grad import (G_ATOL, G_RTOL, IDX_AGREE, LEAF_ATOL,
                                        LEAF_RTOL, OUTLIER_FRAC, _leaf,
                                        _port_leaf_grads, _small_dome)

ATOL, RTOL = 1e-4, 1e-5                   # forward planes vs raytpu
CASES = {
    "world60": ("world60", dict(max_bounces=4)),
    "world60_ao": ("world60", dict(max_bounces=3, use_ao=True,
                                   ao_samples=2)),
    "world600": ("world600", dict(max_bounces=6)),
    "quad_fixture": ("quads", dict(max_bounces=5)),
    "sky60": ("sky60", dict(max_bounces=4)),
}
SEEDS = {name: 11 * i for i, name in enumerate(CASES)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """TOML paths: the 60- and 600-triangle block worlds, the quad
    fixture and the 60-triangle world under a 16x8 sky."""
    base = tmp_path_factory.mktemp("mesh_keyed")
    sky = str(base / "sky60")
    os.makedirs(sky)
    write_equirect_sky(os.path.join(sky, "sky.ppm"), 16, 8, seed=2)
    return {
        "world60": write_block_world(str(base / "w60"), n_triangles=60,
                                     seed=3),
        "world600": write_block_world(str(base / "w600"), n_triangles=600),
        "quads": write_quad_fixture(str(base / "quads")),
        "sky60": write_block_world(sky, n_triangles=60, seed=3,
                                   sky="sky.ppm"),
    }


def _load(worlds, case, search, width=12, height=8):
    """(port scene, camera, config) of a case, with the per-triangle or
    the merged search."""
    path, over = CASES[case]
    ts, tc, tcfg = tconfig.load_scene_file(worlds[path], device="cpu")
    tcfg = tcfg.replace(width=width, height=height, **over)
    if search == "per_triangle":
        tcfg = tcfg.replace(merge_quads=False)
    return ts, tc, tcfg


def _batch(ts, tc, tcfg, seed):
    """Random ray keys, their camera rays, the bounce draws of the keys
    and K3's knobs and tables."""
    b = tcfg.n_pixels
    words = _words(_key_pairs(seed, b))
    o, d = trender.sample_rays(tc, tcfg, torch.arange(b),
                               trng.draws_at(words, range(4)))
    nd = n_bounce_draws(tcfg)
    k = tts.MeshKnobs.for_scene(tcfg, ts, nd)
    flat = trng.bounce_draws(words, nd, tcfg.max_bounces)
    return words, o, d, flat, k, tts.pack_scene(ts, k)


def _assert_same(a, b):
    """Bit equality of tensors and Vec3s, or of (nested) tuples of them and
    None."""
    if isinstance(a, TVec3):
        a, b = a.to_array(), b.to_array()
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        assert torch.equal(a, b)


# ---- the plain entries: keys against the draw buffer -----------------------

@pytest.mark.parametrize("search", ["per_triangle", "merged"])
@pytest.mark.parametrize("case", list(CASES))
def test_k3_on_keys_equals_buffer_entry(worlds, case, search):
    """K3's plain entry on the keys gives the buffer entry's planes,
    winners and AO factors bit for bit, through ``trace_mesh_megakernel``
    too."""
    ts, tc, tcfg = _load(worlds, case, search)
    words, o, d, flat, k, tb = _batch(ts, tc, tcfg, SEEDS[case])
    assert (k.plan is not None) == (search == "merged")
    assert k.use_ao == (case == "world60_ao")
    assert (k.sky_idx >= 0) == (case == "sky60")
    rays = (*o, *d)
    for record in (False, True):
        keyed = tts._forward(tb, rays, words, k, record)
        _assert_same(keyed, tts.trace_scene_reference(tb, *rays, flat, k,
                                                      record=record))
    out = keyed[0]
    assert out.shape[0] == (16 if case == "sky60" else 9)
    assert (keyed[1] >= k.n_spheres).any()          # triangle winners
    mb, nd, b = tcfg.max_bounces, k.n_draws, tcfg.n_pixels
    _assert_same(tts.trace_mesh_megakernel(ts, tcfg, o, d, words),
                 tts.trace_mesh_megakernel(ts, tcfg, o, d,
                                           flat.view(mb, nd, b)))


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("case", ["world60", "world60_ao"])
def test_k3_counts_the_draws_it_hashes(worlds, case, record):
    """The plain version's counts of the draws K3 hashes (its bound): at
    most three scatter and roulette draws a live (ray, bounce) entry, and
    with AO two a probe of each bounce that accumulates, or of every live
    entry when recording."""
    ts, tc, tcfg = _load(worlds, case, "per_triangle")
    words, o, d, flat, k, tb = _batch(ts, tc, tcfg, 7)
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    tts.trace_scene_reference(tb, *o, *d, flat, k, counts, record=record)
    assert 0 < counts["draws"] <= 3 * counts["live"]
    probes = 2 * k.ao_samples * counts["live"]
    if not k.use_ao:
        assert counts["probe_draws"] == 0
    elif record:
        assert counts["probe_draws"] == probes
    else:
        assert 0 < counts["probe_draws"] < probes


@pytest.mark.parametrize("search", ["per_triangle", "merged"])
@pytest.mark.parametrize("case", list(CASES))
def test_k2_mesh_on_keys_equals_buffer_entry(worlds, case, search):
    """K2's mesh plain entry on the keys gives the buffer entry's four
    table cotangents and ray cotangents bit for bit, on K3's recording."""
    ts, tc, tcfg = _load(worlds, case, search)
    words, o, d, flat, k, tb = _batch(ts, tc, tcfg, SEEDS[case] + 1)
    rays = (*o, *d)
    _, idx, aof = tts.trace_scene_reference(tb, *rays, flat, k, record=True)
    g = torch.tensor(np.random.default_rng(SEEDS[case] + 2).uniform(
        -1, 1, (tbwd.g_planes(k), tcfg.n_pixels)).astype(np.float32))
    tabs = tbwd.Tables(tb.sph, tb.tri, tb.mats, tb.atlas)
    keyed = tbwd.mesh_backward(tabs, rays, words, idx, aof, g, k)
    _assert_same(keyed, tbwd.mesh_backward(tabs, rays, flat, idx, aof, g, k))
    assert keyed[1][9:12].abs().max() > 0           # the triangles' normals


# ---- against raytpu, with JAX's draws of the same keys ----------------------

@pytest.fixture(scope="module")
def recordings():
    return {}


def _recorded(cache, worlds, case):
    """One 16x12 batch per case (the sky dome shrunk to radius 100 on
    both sides, as ``test_torch_mesh_grad``; per-triangle search):
    raytpu's K3 in interpret mode on JAX's draws of the keys, and the
    port's plain K3 on the keys."""
    if case not in cache:
        path, over = CASES[case]
        js, jc, jcfg = jconfig.load_scene_file(worlds[path])
        ts, tc, _ = tconfig.load_scene_file(worlds[path], device="cpu")
        js, ts = _small_dome(js, ts)
        jcfg = jcfg.replace(width=16, height=12, merge_quads=False, **over)
        tcfg = TConfig(**dataclasses.asdict(jcfg))
        b, nd, mb = jcfg.n_pixels, n_bounce_draws(tcfg), jcfg.max_bounces
        pairs = _key_pairs(SEEDS[case] + 5, b)
        cam_d, jdraws = jrng.ray_uniforms(jnp.asarray(pairs), 4, nd, mb)
        jo, jd = jrender.sample_rays(jc, jcfg, jnp.arange(b, dtype=jnp.int32),
                                     cam_d)
        jout, jidx, jaof = jts._mkm_forward(js, jcfg, jo, jd, jdraws, True,
                                            with_indices=True)
        words = _words(pairs)
        t = lambda v: tuple(torch.tensor(np.asarray(c)) for c in v)
        rays = (*t(jo), *t(jd))
        k = tts.MeshKnobs.for_scene(tcfg, ts, nd)
        port = tts._forward(tts.pack_scene(ts, k), rays, words, k,
                            record=True)
        cache[case] = (js, jcfg, ts, k, (jo, jd, jdraws), rays, words, jout,
                       np.asarray(jidx),
                       None if jaof is None else np.asarray(jaof), port)
    return cache[case]


@pytest.mark.parametrize("case", ["world60", "world60_ao"])
def test_keyed_k3_matches_raytpu(recordings, worlds, case):
    """The port's plain K3 on the keys against raytpu's K3 on JAX's draws
    of the same keys: planes (a ray is an outlier past 1e-4 + 1e-5|x|, at
    most 2%), winners (at least 98% equal) and AO factors where used."""
    *_, jout, jidx, jaof, (out, idx, aof) = _recorded(recordings, worlds,
                                                      case)
    want = np.concatenate([np.stack([np.asarray(c) for c in v]) for v in jout])
    bad = np.abs(out.numpy() - want) > ATOL + RTOL * np.abs(want)
    assert bad.any(0).mean() <= OUTLIER_FRAC
    idx = idx.numpy()
    assert (idx == jidx).mean() >= IDX_AGREE
    if case == "world60_ao":
        used = (idx == jidx).all(0, keepdims=True) & (idx >= 0)
        assert used.sum() > 0
        assert ((aof.numpy() != jaof) & used).sum() <= OUTLIER_FRAC * used.sum()
    else:
        assert aof is None and jaof is None


@pytest.mark.parametrize("case", ["world60", "world60_ao"])
def test_keyed_k2_mesh_matches_raytpu(recordings, worlds, case):
    """The port's plain K2 mesh mode on the keys against raytpu's
    ``mesh_backward`` on JAX's draws of them, on raytpu's recorded
    winners and a random cotangent (zero on the rays whose winners the
    port's recording does not reproduce, at least 90% kept), compared on
    the scene leaves by ``test_torch_mesh_grad``'s rules."""
    (js, jcfg, ts, k, jin, rays, words, _, jidx, jaof,
     port) = _recorded(recordings, worlds, case)
    b = jcfg.n_pixels
    g = np.random.default_rng(SEEDS[case] + 41).uniform(
        -1, 1, (9, b)).astype(np.float32)
    kept = (port[1].numpy() == jidx).all(0)
    assert kept.mean() >= 0.9, f"{kept.mean():.3f}"
    g[:, ~kept] = 0.0
    g_vecs = [JVec3(*map(jnp.asarray, g[3 * j:3 * j + 3])) for j in range(3)]
    d_scene, d_o, d_d, _ = j_mesh_backward(
        js, jcfg, *jin, jnp.asarray(jidx), g_vecs, True,
        aof=None if jaof is None else jnp.asarray(jaof))
    tb = tts.pack_scene(ts, k)
    *d_tabs, d_rays = tbwd.mesh_backward(
        tbwd.Tables(tb.sph, tb.tri, tb.mats, tb.atlas), rays, words,
        torch.tensor(jidx), None if jaof is None else torch.tensor(jaof),
        torch.tensor(g), k)
    groups = set()
    for path, grad in _port_leaf_grads(ts, d_tabs).items():
        want = _leaf(d_scene, path)
        assert np.isfinite(grad.numpy()).all(), path
        scale = np.abs(want).max(initial=0.0)
        err = np.abs(grad.numpy() - want)
        assert (err <= LEAF_RTOL * scale + LEAF_ATOL).all(), (
            f"{path}: off by {err.max():.3e}, leaf max {scale:.3e}")
        if scale > 0:
            groups.add(path.split(".")[0])
    assert {"spheres", "triangles", "mat_table"} <= groups
    want_rays = np.stack([np.asarray(c) for c in (*d_o, *d_d)])
    got_rays = torch.stack(d_rays).numpy()
    bad = np.abs(got_rays - want_rays) > G_ATOL + G_RTOL * np.abs(want_rays)
    assert bad.any(0).mean() <= OUTLIER_FRAC


# ---- render: the keyed route is the buffer route ----------------------------

def _leafy(ts):
    """The scene rebuilt from fresh copies of its float leaves that
    require grad (the trainer's partition)."""
    params, static = partition_scene(ts)
    leaves = {n: p.detach().clone().requires_grad_()
              for n, p in params.items()}
    return leaves, combine_scene(leaves, static)


@pytest.mark.parametrize("case,search", [("world60", "per_triangle"),
                                         ("world60", "merged"),
                                         ("sky60", "merged")])
def test_render_mesh_route_is_the_buffer_route(worlds, case, search):
    """``render`` on the CPU mesh route (4 RNG rows, K3 on the keys)
    gives the sums of the buffer route it replaced (every row of the
    eager stream, ``trace_mesh_megakernel`` on the bounce draws) bit for
    bit, and the same gradient of every leaf."""
    ts, tc, tcfg = _load(worlds, case, search, width=6, height=4)
    tcfg = tcfg.replace(spp=2, max_bounces=3, use_megakernel=True,
                        sky_texture_grads=case == "sky60")
    assert trender.trace_fn(ts, tcfg) is tts.trace_mesh_megakernel
    pids = torch.arange(tcfg.n_pixels)
    key = trng.prng_key(21)
    nd, mb, b = n_bounce_draws(tcfg), tcfg.max_bounces, tcfg.n_pixels

    def loss(sums):
        return ((sums[0].to_array() - 0.2) ** 2).mean() + (
            sums[2].to_array() ** 2).mean()

    leaves, scene = _leafy(ts)
    sums = trender.render(scene, tc, tcfg, pids, key)
    loss(sums).backward()

    b_leaves, b_scene = _leafy(ts)
    zeros = TVec3.zeros((b,))
    acc = [zeros, zeros, zeros]
    for s in range(tcfg.spp):
        _, draws = trng.stream_reference(key, pids, s, 4 + mb * nd)
        o, d = trender.sample_rays(tc, tcfg, pids, draws[:4])
        out = tts.trace_mesh_megakernel(b_scene, tcfg, o, d,
                                        draws[4:].view(mb, nd, b))
        acc = [a + v for a, v in zip(acc, out)]
    loss(acc).backward()
    for got, want in zip(sums[:3], acc):
        assert torch.equal(got.to_array(), want.to_array())
    for path, leaf in leaves.items():
        assert torch.equal(leaf.grad, b_leaves[path].grad), path
    assert sum(bool(leaf.grad.abs().max() > 0) for leaf in leaves.values()) >= 3


@pytest.mark.parametrize("megakernel", [True, False])
@pytest.mark.parametrize("case", ["world60", "world60_ao"])
def test_rng_rows_of_each_route(worlds, case, megakernel, monkeypatch):
    """The mesh megakernel route starts each sample
    (``render.sample_start``) with the 4 camera rows (K3 hashes its bounce
    draws from the keys); the scan path with every bounce row as well, AO
    probes included."""
    ts, tc, tcfg = _load(worlds, case, "per_triangle", width=3, height=2)
    tcfg = tcfg.replace(spp=2, max_bounces=2, use_megakernel=megakernel)
    rows = []
    start = trender.sample_start

    def counted(cam, cfg, key, pixel_ids, sample_id, n_rows):
        rows.append(n_rows)
        return start(cam, cfg, key, pixel_ids, sample_id, n_rows)

    monkeypatch.setattr(trender, "sample_start", counted)
    sums = trender.render(ts, tc, tcfg, torch.arange(tcfg.n_pixels),
                          trng.prng_key(5))
    assert torch.isfinite(sums.radiance.to_array()).all()
    want = 4 if megakernel else 4 + tcfg.max_bounces * n_bounce_draws(tcfg)
    assert rows == [want] * tcfg.spp
    if not megakernel and case == "world60_ao":
        assert want == 4 + tcfg.max_bounces * (3 + 2 * tcfg.ao_samples)


# ---- refusals ----------------------------------------------------------------

def test_mesh_kernels_refuse_draw_buffers(worlds, monkeypatch):
    """K3's and K2's ``_launch`` take the ray keys, not a draw buffer (nor
    keys of another shape), and refuse one before any library is built
    or loaded."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    ts, tc, tcfg = _load(worlds, "world60", "per_triangle", width=4, height=2)
    words, o, d, flat, k, tb = _batch(ts, tc, tcfg, 3)
    rays, b = (*o, *d), tcfg.n_pixels
    tabs = tbwd.Tables(tb.sph, tb.tri, tb.mats, tb.atlas)
    idx = torch.zeros((k.bounces, b), dtype=torch.int32)
    g = torch.zeros(9, b)
    for src in (flat, words[:, :-1], words.to(torch.int64)):
        with pytest.raises(ValueError, match="ray keys"):
            tts._launch(tb, rays, src, k)
        with pytest.raises(ValueError, match="ray keys"):
            tts._launch(tb, rays, src, k, record=True)
        with pytest.raises(ValueError, match="ray keys"):
            tbwd._launch(tabs, rays, src, idx, None, g, k)


def test_mesh_entry_checks_its_draw_source(worlds):
    """``trace_mesh_megakernel`` takes (2, B) keys, or on the CPU a
    (max_bounces, >= n_bounce_draws, B) buffer, and names what it wants."""
    ts, tc, tcfg = _load(worlds, "world60", "per_triangle", width=4, height=2)
    words, o, d, flat, k, _ = _batch(ts, tc, tcfg, 4)
    with pytest.raises(ValueError, match="ray keys"):
        tts.trace_mesh_megakernel(ts, tcfg, o, d, torch.cat([words, words]))
    with pytest.raises(ValueError, match="B=7"):
        tts.trace_mesh_megakernel(ts, tcfg, o, d, words[:, :-1])
    with pytest.raises(ValueError, match="bounce_draws"):
        tts.trace_mesh_megakernel(ts, tcfg, o, d, flat[:1].view(1, 1, -1))
