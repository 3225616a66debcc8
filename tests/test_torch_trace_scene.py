"""The mesh megakernel's plain version (``raytpu_torch.kernels.trace_scene``)
against raytpu.

Same scene, rays and bounce draws (from a numpy seed) on both sides:
``raytpu``'s scan trace (``integrator.path.trace``) and its K3 in
interpret mode on one side, the port's ``trace_mesh_megakernel`` on CPU
tensors (``trace_scene_reference``) on the other, both searching triangle
by triangle (``merge_quads=False``; the merged search is
``test_torch_trace_scene_quads.py``'s). The scan trace runs under
``jax.disable_jit``, so that each of its operations rounds on its own
as the port's do: compiled, XLA fuses
and contracts them, and a water refraction in the block world then takes
the other branch on 1-2% of the rays (the jitted scan and the interpret
K3 agree with each other there, and the eager scan with the port). Scenes: a 60-triangle block world with water (with and without
AO), the same mesh untextured, and the 4-triangle cutout / window /
emissive scene of ``tests/test_mesh_megakernel.py``. Tolerance of
``tests/test_megakernel._compare``: a ray is an outlier if a channel
differs by more than 1e-4 + 1e-5|x|, and at most 2% of rays may be.
Then the gates, the packers, and the slice end to end (``render``,
``convert``, ``cli render <toml>``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.types import TextureAtlas as JAtlas
from raytpu.geometry.triangle import precompute as j_precompute
from raytpu.integrator import render as jrender
from raytpu.integrator.path import n_bounce_draws, trace
from raytpu.kernels import trace_scene as jts
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.types import TextureAtlas as TAtlas
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator import render as trender
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.scenes import mesh_branch_scene, write_block_world
from tests.test_mesh_megakernel import _synthetic_textured_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


def _arrays(tree, **static):
    d = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    d.update(static)
    return d


def _convert(jscene):
    return convert.scene_from_arrays(_arrays(
        jscene, sky_sphere_index=jscene.sky_sphere_index,
        **{"atlas.width": jscene.atlas.width,
           "atlas.height": jscene.atlas.height}), device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)


def _scenes(world):
    """name -> (raytpu scene, camera, port scene, camera, config)."""
    js, jc, jcfg = jconfig.load_scene_file(world)
    ts, tc, _ = tconfig.load_scene_file(world, device="cpu")
    bs, bc = _synthetic_textured_scene()
    ps, pc, pcfg = mesh_branch_scene(device="cpu")
    # the per-triangle search on both sides (raytpu's scan has no other);
    # the merged search is tests/test_torch_trace_scene_quads.py's
    small = dict(width=16, height=12, max_bounces=6, merge_quads=False)
    return {
        "block_world": (js, jc, ts, tc, jcfg.replace(**small)),
        "block_world_ao": (js, jc, ts, tc, jcfg.replace(
            width=16, height=12, max_bounces=4, use_ao=True, ao_samples=2,
            merge_quads=False)),
        "untextured": (js.replace(atlas=JAtlas.empty()), jc,
                       dataclasses.replace(ts, atlas=TAtlas.empty("cpu")), tc,
                       jcfg.replace(**small)),
        "branches": (bs, bc, ps, pc, JConfig(**dataclasses.asdict(pcfg))),
    }


SCENES = ("block_world", "block_world_ao", "untextured", "branches")


def _inputs(jcam, cfg, seed):
    """Camera rays and (bounces, draws, B) bounce draws from a numpy seed,
    as raytpu arrays and as port tensors."""
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = jrender.sample_rays(jcam, cfg, jnp.arange(b, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, n_bounce_draws(cfg), b), np.float32)
    t = lambda v: TVec3(*(torch.tensor(np.asarray(c)) for c in v))
    return (o, d, jnp.asarray(draws)), (t(o), t(d), torch.tensor(draws))


def _assert_close(got, want, what):
    for name, a, b in zip(("radiance", "albedo", "normal"), got, want):
        x = np.stack([np.asarray(c) for c in b], -1)
        y = np.stack([c.numpy() for c in a], -1)
        assert np.isfinite(y).all(), f"{what} {name}: non-finite"
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, (
            f"{what} {name}: {bad.mean():.2%} rays differ "
            f"(max {np.abs(x - y).max():.4g})")


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_raytpu_scan(world, name):
    js, jc, ts, _, cfg = _scenes(world)[name]
    (jo, jd, jdraws), (to, td, tdraws) = _inputs(jc, cfg, SCENES.index(name))
    with jax.disable_jit():
        want = trace(js, cfg, jo, jd, jdraws)
    got = tts.trace_mesh_megakernel(ts, TConfig(**dataclasses.asdict(cfg)),
                                    to, td, tdraws)
    _assert_close(got, want, name)
    assert float(got[0].x.abs().sum()) > 0.0


def test_plain_matches_raytpu_kernel_interpret(world):
    """Against raytpu's K3 itself (Pallas interpret mode, no merged
    quads) on the 4-triangle scene of every shading branch."""
    js, jc, ts, _, cfg = _scenes(world)["branches"]
    cfg = cfg.replace(merge_quads=False)
    (jo, jd, jdraws), (to, td, tdraws) = _inputs(jc, cfg, 11)
    want = jts.trace_mesh_megakernel(js, cfg, jo, jd, jdraws, interpret=True)
    got = tts.trace_mesh_megakernel(ts, TConfig(**dataclasses.asdict(cfg)),
                                    to, td, tdraws)
    _assert_close(got, want, "branches vs interpret K3")


def test_branch_scene_matches_raytpu_build(world):
    """``scenes.mesh_branch_scene`` holds exactly the arrays of raytpu's
    synthetic textured scene, and ``convert`` carries them over."""
    js, jc, ts, tc, _ = _scenes(world)["branches"]
    conv = _convert(js)
    for path, want in _arrays(js).items():
        if path.startswith(("atlas.packed", "sky.")):
            continue
        obj, cobj = ts, conv
        for k in path.split("."):
            obj, cobj = getattr(obj, k), getattr(cobj, k)
        np.testing.assert_array_equal(obj.numpy(), want, err_msg=path)
        np.testing.assert_array_equal(cobj.numpy(), want, err_msg=path)
    for path, want in _arrays(jc).items():
        v, c = path.split(".")
        np.testing.assert_array_equal(
            getattr(getattr(tc, v), c).numpy(), want, err_msg=path)


def test_packers_match_raytpu(world):
    """pack_scene's sphere, triangle, box and material tables equal the
    unpadded part of raytpu's (its bf16 limbs and one-hots aside)."""
    for name in ("block_world", "branches"):
        js, _, ts, _, _ = _scenes(world)[name]
        j_sph, j_tri, _, j_boxes, j_mats, _ = jts.pack_scene(
            js, j_precompute(js.triangles))
        tb = tts.pack_scene(ts)
        n_s, n_t, n_m = ts.spheres.count, ts.triangles.count, ts.mat_table.count
        for what, got, want in (("sph", tb.sph, j_sph[:, :n_s]),
                                ("tri", tb.tri, j_tri[:, :n_t]),
                                ("boxes", tb.boxes, j_boxes),
                                ("mats", tb.mats, j_mats[:, :n_m])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} {what}")
        assert torch.equal(tb.search, tb.tri[:12].T)


@pytest.mark.parametrize("name", SCENES)
def test_gates_match_raytpu(world, name):
    js, _, ts, _, cfg = _scenes(world)[name]
    tcfg = TConfig(**dataclasses.asdict(cfg))
    for jc, tc in ((cfg, tcfg), (cfg.replace(bilinear_textures=True),
                                 tcfg.replace(bilinear_textures=True))):
        assert tts.unsupported_reasons(ts, tc) == jts.unsupported_reasons(js, jc)
        assert tts.supported(ts, tc) == jts.supported(js, jc)
    assert tts.supported(ts, tcfg)


def test_sphere_scene_and_limits_refused(world):
    from raytpu.scenes import cornell_box as j_cornell
    from raytpu_torch.scenes import cornell_box as t_cornell

    js, _, jcfg = j_cornell()
    ts, _, tcfg = t_cornell(device="cpu")
    assert tts.unsupported_reasons(ts, tcfg) == jts.unsupported_reasons(js, jcfg)
    assert not tts.supported(ts, tcfg)
    # 65 materials: the table's bound, in both packages
    _, _, bw, _, cfg = _scenes(world)["block_world"]
    big = dataclasses.replace(bw, mat_table=type(bw.mat_table).default(65, "cpu"))
    assert tts.unsupported_reasons(big, TConfig()) == ["65 materials > 64"]


def _wrapper_args(world):
    _, jc, ts, _, cfg = _scenes(world)["branches"]
    cfg = cfg.replace(width=4, height=2, max_bounces=2)
    _, (to, td, tdraws) = _inputs(jc, cfg, 5)
    return ts, TConfig(**dataclasses.asdict(cfg)), to, td, tdraws


def test_sky_and_gradient_requests_raise(world):
    """The sky gate raises on a sky sphere index out of range; a gradient
    request runs ``TraceMesh`` (the plain K3 recording, then K2's plain
    mesh mode) on CPU tensors, with finite gradients and no kernel
    launch; bad draws raise."""
    from raytpu_torch.kernels import trace_scene_bwd as tbwd

    ts, cfg, to, td, tdraws = _wrapper_args(world)
    sky = dataclasses.replace(ts, sky_sphere_index=ts.spheres.count)
    assert not tts.supported(sky, cfg)
    with pytest.raises(NotImplementedError, match="sky"):
        tts.trace_mesh_megakernel(sky, cfg, to, td, tdraws)
    with pytest.raises(ValueError, match="bounce_draws"):
        tts.trace_mesh_megakernel(ts, cfg, to, td, tdraws[:1])
    _, jc, ts, _, jcfg = _scenes(world)["block_world"]
    cfg = TConfig(**dataclasses.asdict(jcfg.replace(width=8, height=6,
                                                    max_bounces=3)))
    _, (to, td, tdraws) = _inputs(jc, cfg, 5)
    a, rgb = ts.triangles.a, ts.atlas.rgb
    leaf = TVec3(a.x.clone().requires_grad_(), a.y, a.z)
    texels = rgb.x.clone().requires_grad_()
    grad_scene = dataclasses.replace(
        ts, triangles=dataclasses.replace(ts.triangles, a=leaf),
        atlas=dataclasses.replace(ts.atlas, rgb=TVec3(texels, rgb.y, rgb.z)))
    grad_rays = TVec3(to.x.clone().requires_grad_(), to.y, to.z)
    before = (tts.launches, tbwd.launches)
    out = tts.trace_mesh_megakernel(grad_scene, cfg, grad_rays, td, tdraws)
    assert out[0].x.grad_fn is not None
    with torch.no_grad():      # the same planes as without a gradient
        plain = tts.trace_mesh_megakernel(ts, cfg, to, td, tdraws)
    for got, want in zip(out, plain):
        assert torch.equal(torch.stack(list(got)), torch.stack(list(want)))
    loss = sum(v.sum() for vec in out for v in vec)
    loss.backward()
    assert (tts.launches, tbwd.launches) == before
    for g in (leaf.x.grad, texels.grad, grad_rays.x.grad):
        assert g is not None and torch.isfinite(g).all()
    assert float(texels.grad.abs().sum()) > 0.0


def test_search_counts(world):
    """``counts`` records the search work without changing the result:
    one slab test per (live ray, bounce, chunk), and the chunk cull
    skips triangles without losing a winner."""
    _, jc, ts, _, cfg = _scenes(world)["block_world"]
    tcfg = TConfig(**dataclasses.asdict(cfg))
    _, (to, td, tdraws) = _inputs(jc, cfg, 9)
    k = tts.MeshKnobs.for_scene(tcfg, ts, tdraws.shape[1])
    tb = tts.pack_scene(ts)
    flat = tdraws.reshape(-1, tdraws.shape[-1])
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    got = tts.trace_scene_reference(tb, *to, *td, flat, k, counts)
    assert torch.equal(got, tts.trace_scene_reference(tb, *to, *td, flat, k))
    assert cfg.n_pixels <= counts["live"] <= cfg.n_pixels * cfg.max_bounces
    assert counts["sphere"] == counts["live"] * ts.spheres.count
    assert counts["slab"] == counts["live"] * k.n_chunks == counts["live"] * 2
    assert 0 < counts["tri"] < counts["live"] * k.n_tris


def test_render_matches_raytpu_and_convert(world):
    """``render`` sums through K3's plain version against raytpu's render
    (scan path, eager as above) at the same key; the scene ``convert``
    builds from the flattened raytpu scene renders the same sums bit for
    bit."""
    js, jc, jcfg = jconfig.load_scene_file(world)
    ts, tc, _ = tconfig.load_scene_file(world, device="cpu")
    cfg = jcfg.replace(width=12, height=8, spp=2, max_bounces=4,
                       merge_quads=False)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    with jax.disable_jit():
        want = jrender.render(js, jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(23))
    tcfg = TConfig(**dataclasses.asdict(cfg)).replace(use_megakernel=True)
    assert trender.trace_fn(ts, tcfg) is tts.trace_mesh_megakernel
    got = trender.render(ts, tc, tcfg, pids, trng.prng_key(23))
    assert got.samples == int(want.samples) == 2
    _assert_close(got[:3], want[:3], "render")
    conv = trender.render(_convert(js), tc, tcfg, pids, trng.prng_key(23))
    for a, b in zip(conv[:3], got[:3]):
        assert torch.equal(a.to_array(), b.to_array())


def test_cli_renders_toml_on_cpu(world, tmp_path):
    out = tmp_path / "bw.ppm"
    res = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", world,
         "--device", "cpu", "--width", "12", "--height", "9", "--spp", "1",
         "--bounces", "3", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    text = out.read_text()
    assert text.startswith("P3\n12 9\n255\n")
    assert len(text.split()) == 4 + 12 * 9 * 3
