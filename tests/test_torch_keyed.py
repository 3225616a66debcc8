"""The keyed sphere route against raytpu: each ray's threefry key in place
of a draw buffer.

K1, K2's sphere mode and K5 take the rays' keys ((2, B) int32 words of
``rng.sample_stream``) and hash each draw where they read it, draw j of
bounce b at counter ``4 + b * n_draws + j``. On CPU tensors their plain
versions read the same draws from the eager stream (``rng.bounce_draws``).
Held here, tolerance none unless stated:

* ``rng.draws_at`` (the kernels' per-draw formula) against
  ``jax.random.uniform`` and ``rng.ray_uniforms`` at the layout's
  counters, for strides with and without AO; ``rng.sample_stream`` on the
  CPU against JAX's keys and draws;
* the keyed plain entries bit-equal to the buffer plain entries (forward,
  recording, K2, K5, ``TraceSpheres``' gradients) and, through them,
  against raytpu's scan path with JAX's draws for the same keys, at the
  chip check's tolerance (a ray is an outlier past 1e-4 + 1e-5|x|, at most
  2% of rays), on Cornell, DoF+AO, the refraction stack, the HSL boost and
  the sky showcase;
* ``render`` on the CPU bit-identical to the buffer route it replaced;
* the kernel wrappers refuse draw buffers, and the build hashes
  ``csrc/threefry.cuh`` into every library that includes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu import scenes as jscenes
from raytpu.config import load_scene
from raytpu.core import rng as jrng
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator.path import trace as j_trace
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator import render as trender
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.kernels import _build
from raytpu_torch.kernels import trace_scene_bwd as tbwd
from raytpu_torch.kernels import trace_spheres as tts
from raytpu_torch.scenes import write_sky_showcase
from tests.test_torch_sky import _convert

ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _key_pairs(seed, n):
    """n random uint32 key pairs (numpy), the extremes among them."""
    k = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint32)
    k[:3] = [[0, 0], [2**31, 2**31 - 1], [2**32 - 1, 1]]
    return k


def _words(k):
    """numpy (B, 2) uint32 keys -> the port's (2, B) int32 words."""
    return torch.tensor(k.T.astype(np.uint32).view(np.int32).copy())


# ---- the per-draw formula -------------------------------------------------

def test_key_words_round_trip():
    k = _key_pairs(1, 50)
    pairs = torch.tensor(k.astype(np.int64))
    words = trng.key_words(pairs)
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, 50)
    assert torch.equal(words, _words(k))
    assert torch.equal(trng.key_pairs(words), pairs)


@pytest.mark.parametrize("n_draws,bounces", [(3, 6), (5, 4), (7, 5)])
def test_draws_at_matches_jax_uniform_and_ray_uniforms(n_draws, bounces):
    """Draw c of a key is jax.random.uniform(key, (n,))[c]; the bounce
    draws sit at counters 4 + b * n_draws + j (3 draws without AO, 3 + 2
    per AO probe)."""
    k = _key_pairs(2 + n_draws, 33)
    total = 4 + bounces * n_draws
    want = np.stack([np.asarray(jax.random.uniform(jnp.asarray(key), (total,)))
                     for key in k], -1)
    words = _words(k)
    got = trng.draws_at(words, range(total))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    cam, bounce = trng.ray_uniforms(torch.tensor(k.astype(np.int64)), 4,
                                    n_draws, bounces)
    flat = trng.bounce_draws(words, n_draws, bounces)
    assert tuple(flat.shape) == (bounces * n_draws, 33)
    assert torch.equal(flat, bounce.reshape(-1, 33))
    assert torch.equal(trng.draws_at(words, range(4)), cam)
    # any counter on its own: draw j of bounce b
    b, j = bounces - 1, n_draws - 1
    one = trng.draws_at(words, [4 + b * n_draws + j])
    assert torch.equal(one[0], bounce[b, j])


@pytest.mark.parametrize("rows", [4, 22, 46])
def test_sample_stream_on_cpu_matches_jax(rows):
    ids = np.random.default_rng(rows).integers(0, 1200 * 900, 40)
    ids[:2] = [0, 1200 * 900 - 1]
    jkeys = jrng.sample_keys(jrng.pixel_keys(jax.random.PRNGKey(3),
                                             jnp.asarray(ids, jnp.int32)), 9)
    before = trng.launches
    keys, draws = trng.sample_stream(trng.prng_key(3),
                                     torch.tensor(ids, dtype=torch.int64), 9,
                                     rows)
    assert trng.launches == before
    assert torch.equal(keys, _words(np.asarray(jkeys)))
    want = np.stack([np.asarray(jax.random.uniform(key, (rows,)))
                     for key in jkeys], -1)
    np.testing.assert_array_equal(_bits(draws.numpy()), _bits(want))


# ---- keyed K1 against the buffer entry and raytpu ------------------------

def _refraction_stack():
    scene, cam, cfg = load_scene("scenes/refraction_stack.toml")
    return scene, cam, cfg.replace(max_bounces=19)


SCENES = {
    "cornell": (jscenes.cornell_box, dict(max_bounces=5)),
    "dof_ao": (jscenes.cornell_box_dof_ao, dict(max_bounces=4, ao_samples=2)),
    "hsl_ao": (jscenes.cornell_box_cuda, dict(max_bounces=4)),
    "refraction_stack": (_refraction_stack, {}),
    "sky_showcase": (None, dict(max_bounces=4)),
}


@pytest.fixture(scope="module")
def showcase(tmp_path_factory):
    return write_sky_showcase(str(tmp_path_factory.mktemp("show")), (16, 8),
                              seed=1)


def _case(name, showcase):
    """(raytpu scene, config, port scene, port config, numpy keys (B, 2),
    raytpu rays, port rays) at 12x8 rays."""
    make, over = SCENES[name]
    if make is None:
        js, jc, jcfg = jconfig.load_scene_file(showcase)
        ts = tconfig.load_scene_file(showcase, device="cpu")[0]
    else:
        js, jc, jcfg = make()
        ts = _convert(js)
    jcfg = jcfg.replace(width=12, height=8, **over)
    tcfg = TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})
    k = _key_pairs(sorted(SCENES).index(name), jcfg.n_pixels)
    cam_d = jax.vmap(lambda key: jax.random.uniform(key, (4,)))(jnp.asarray(k))
    o, d = j_sample_rays(jc, jcfg, jnp.arange(jcfg.n_pixels, dtype=jnp.int32),
                         cam_d.T)
    trays = [torch.tensor(np.asarray(c)) for c in (*o, *d)]
    return js, jcfg, ts, tcfg, k, (o, d), trays


def _check(name, got, want):
    for label, a, b in zip(("radiance", "albedo", "normal"), got, want):
        x = np.stack([np.asarray(c) for c in b], -1)
        y = np.stack([c.numpy() for c in a], -1)
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert np.isfinite(y).all(), f"{name} {label}: non-finite"
        assert bad.mean() <= OUTLIER_FRAC, (
            f"{name} {label}: {bad.mean():.2%} rays differ")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_keyed_k1_equals_buffer_entry_and_matches_raytpu(name, showcase):
    js, jcfg, ts, tcfg, k, (o, d), trays = _case(name, showcase)
    nd, mb = n_bounce_draws(tcfg), tcfg.max_bounces
    words = _words(k)
    bounce = trng.bounce_draws(words, nd, mb).view(mb, nd, -1)
    before = tts.launches
    keyed = tts.trace_megakernel(ts, tcfg, TVec3(*trays[:3]),
                                 TVec3(*trays[3:]), words)
    buffered = tts.trace_megakernel(ts, tcfg, TVec3(*trays[:3]),
                                    TVec3(*trays[3:]), bounce)
    assert tts.launches == before
    for a, b in zip(keyed, buffered):
        assert torch.equal(a.to_array(), b.to_array())
    # raytpu's scan path with JAX's draws of the same keys
    jdraws = jrng.ray_uniforms(jnp.asarray(k), 4, nd, mb)[1]
    _check(name, keyed, j_trace(js, jcfg, o, d, jdraws))

    # recording: the same planes, winners and AO factors
    kn = tts.Knobs.create(tcfg, ts.spheres.count, nd, ts.sky_index)
    sph = tts.pack_spheres(ts)
    rec = tts._forward(sph, tuple(trays), words, kn, record=True)
    want = tts.trace_spheres_reference(sph, *trays, bounce.reshape(-1, len(k)),
                                       kn, record=True)
    assert torch.equal(rec[0], want[0]) and torch.equal(rec[1], want[1])
    assert (rec[2] is None) == (want[2] is None)
    if rec[2] is not None:
        assert torch.equal(rec[2], want[2])


def test_counts_follow_the_recording(showcase):
    """The plain version's work counts (the keyed kernels' bounds): live
    entries are the recorded hits, at most three scatter and roulette
    draws a live entry are hashed, and with AO two a probe of every entry
    (recording)."""
    for name in ("cornell", "dof_ao", "refraction_stack"):
        _, _, ts, tcfg, k, _, trays = _case(name, showcase)
        kn = tts.Knobs.create(tcfg, ts.spheres.count, n_bounce_draws(tcfg))
        flat = trng.bounce_draws(_words(k), kn.n_draws, kn.bounces)
        counts = {}
        _, idx, _ = tts.trace_spheres_reference(
            tts.pack_spheres(ts), *trays, flat, kn, record=True, counts=counts)
        assert counts["live"] == int((idx >= 0).sum()) > 0
        assert 0 < counts["draws"] <= 3 * counts["live"]
        probes = 2 * kn.ao_samples * idx.numel() if kn.use_ao else 0
        assert counts["probe_draws"] == probes


# ---- the backward --------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "dof_ao", "refraction_stack"])
def test_keyed_backward_equals_buffer_entries(name, showcase):
    """K2's and K5's plain versions and TraceSpheres' gradients: the keys
    give the buffer's results bit for bit."""
    _, _, ts, tcfg, k, _, trays = _case(name, showcase)
    kn = tts.Knobs.create(tcfg, ts.spheres.count, n_bounce_draws(tcfg))
    words = _words(k)
    flat = trng.bounce_draws(words, kn.n_draws, kn.bounces)
    sph, rays = tts.pack_spheres(ts), tuple(trays)
    _, idx, aof = tts.trace_spheres_reference(sph, *rays, flat, kn, record=True)
    g = torch.tensor(np.random.default_rng(5).uniform(
        -1, 1, (9, len(k))).astype(np.float32))
    for fn, args in ((tbwd.sphere_backward, (idx, aof, g, kn)),
                     (tts.spheres_ad, (g, kn))):
        a = fn(sph, rays, words, *args)
        b = fn(sph, rays, flat, *args)
        assert torch.equal(a[0], b[0]), fn.__name__
        assert all(torch.equal(x, y) for x, y in zip(a[1], b[1])), fn.__name__

    def grads(src):
        leaves = [t.clone().requires_grad_() for t in (sph, *rays)]
        out = tts.TraceSpheres.apply(*leaves, src, kn)
        (out[:9] * g).sum().backward()
        return [t.grad for t in leaves]

    for a, b in zip(grads(words), grads(flat)):
        assert torch.equal(a, b)


def test_render_on_cpu_is_the_buffer_route_bit_for_bit():
    """render's keyed K1 route on the CPU gives the sums of the buffer
    route (eager keys, ray_uniforms, trace_megakernel on the draws)."""
    scene, cam, cfg = jscenes.cornell_box_dof_ao()
    cfg = cfg.replace(width=10, height=6, spp=2, max_bounces=3, ao_samples=1,
                      use_megakernel=True)
    ts = _convert(scene)
    tcam = convert.camera_from_arrays(
        {kk: np.asarray(v) for kk, v in zip(
            [jax.tree_util.keystr(p, simple=True, separator=".")
             for p, _ in jax.tree_util.tree_flatten_with_path(cam)[0]],
            jax.tree_util.tree_leaves(cam))}, device="cpu")
    tcfg = TConfig(**{f: getattr(cfg, f) for f in TConfig.__dataclass_fields__})
    assert trender.trace_fn(ts, tcfg) is tts.trace_megakernel
    pids = torch.arange(tcfg.n_pixels)
    key = trng.prng_key(21)
    sums = trender.render(ts, tcam, tcfg, pids, key)
    pix = trng.pixel_keys(key, pids)
    want = torch.zeros(9, tcfg.n_pixels)
    for s in range(tcfg.spp):
        cam_d, bounce = trng.ray_uniforms(trng.sample_keys(pix, s), 4,
                                          n_bounce_draws(tcfg),
                                          tcfg.max_bounces)
        o, d = trender.sample_rays(tcam, tcfg, pids, cam_d)
        r, a, n = tts.trace_megakernel(ts, tcfg, o, d, bounce)
        want = want + torch.cat([v.to_array().T for v in (r, a, n)])
    got = torch.cat([v.to_array().T for v in sums[:3]])
    assert torch.equal(got, want)


# ---- refusals and the build ------------------------------------------------

def test_kernel_wrappers_take_keys_not_draw_buffers():
    """The kernels hash their draws: a draw buffer (or keys of the wrong
    shape) is refused before any library is built or loaded."""
    scene, _, cfg = jscenes.cornell_box()
    ts = _convert(scene)
    tcfg = TConfig(**{f: getattr(cfg, f) for f in TConfig.__dataclass_fields__})
    kn = tts.Knobs.create(tcfg, ts.spheres.count, n_bounce_draws(tcfg))
    sph, b = tts.pack_spheres(ts), 8
    rays = tuple(torch.zeros(b) for _ in range(6))
    flat = torch.rand(kn.bounces * kn.n_draws, b)
    with pytest.raises(ValueError, match="ray keys"):
        tts._launch(sph, rays, flat, kn)
    with pytest.raises(ValueError, match="ray keys"):
        tts._launch(sph, rays, torch.zeros(2, b + 1, dtype=torch.int32), kn)
    with pytest.raises(ValueError, match="ray keys"):
        tts._launch_ad(sph, rays, flat, torch.zeros(9, b), kn)
    with pytest.raises(ValueError, match="int32"):
        tbwd._launch(tbwd.Tables.of_spheres(sph), rays, flat,
                     torch.zeros(kn.bounces, b, dtype=torch.int32), None,
                     torch.zeros(9, b), tbwd.MeshKnobs.of_spheres(kn))
    with pytest.raises(ValueError, match="int64"):
        trng._launch(trng.prng_key(0), torch.arange(b, dtype=torch.int32), 0, 4)


def test_threefry_header_is_hashed_into_every_keyed_library(tmp_path,
                                                            monkeypatch):
    import shutil

    keyed = ("rng", "trace_spheres", "trace_scene_bwd", "trace_spheres_bwd")
    for name in keyed:
        assert "threefry.cuh" in [p.name for p in _build.sources(name)]
    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = keyed + ("trace_scene", "intersect")
    before = {n: _build.library_path(n) for n in names}
    with open(tmp_path / "threefry.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in keyed)
    assert all(after[n] == before[n] for n in ("trace_scene", "intersect"))

