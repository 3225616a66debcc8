"""The port's scan path (``integrator/hit``, ``integrator/path``, the
dispatch in ``integrator/render``) against raytpu's.

Same scenes (carried over by ``convert`` or loaded by both packages from a
generated block world), rays and draws from a numpy seed or the same PRNG
key on both sides:
- ``closest_hit`` / ``any_hit`` on both selection routes (the distance
  matrices; K4, whose plain version runs on CPU tensors, against raytpu's
  interpret-mode kernel): a ray is an outlier if its hit flag differs or a
  field (distance, point, normal, material) differs by more than
  1e-4 + 1e-4 |x| (a root of a radius-500 wall rounds by ~ulp(1e3) in
  either package); at most 0.5% of rays may be;
- ``trace`` and ``render(use_megakernel=False)`` against raytpu's scan
  path, which runs under ``jax.disable_jit`` on meshes (ROADMAP F7):
  ``tests/test_megakernel._compare``'s tolerance, a ray is an outlier if a
  channel differs by more than 1e-4 + 1e-5 |x|, at most 2% of rays;
- the scan path against ``tests/oracle.py``'s float64 oracle on a few
  Cornell pixels (``tests/test_golden_oracle._compare``'s tolerance);
- the render dispatch (``use_megakernel``, ``use_pallas`` and the logged
  fallback reasons) against raytpu's gates, the CLI's flags and
  environment values, and a check that the port imports no JAX.
"""

import ast
import dataclasses
from contextlib import nullcontext
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu import scenes as jscenes
from raytpu.core import vec3 as jvec
from raytpu.core.types import RenderConfig as JConfig
from raytpu.geometry.triangle import precompute as j_precompute
from raytpu.integrator import hit as jhit
from raytpu.integrator import path as jpath
from raytpu.integrator import render as jrender
from raytpu.kernels import intersect as jint
from raytpu.kernels import trace_scene as jts
from raytpu.kernels import trace_spheres as jtsph
from raytpu_torch import cli as tcli
from raytpu_torch.core import rng as trng
from raytpu_torch.core import vec3 as tvec
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.geometry.triangle import precompute as t_precompute
from raytpu_torch.integrator import hit as thit
from raytpu_torch.integrator import path as tpath
from raytpu_torch.integrator import render as trender
from raytpu_torch.kernels import intersect as tint
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.kernels import trace_spheres as ttsph
from raytpu_torch.scenes import mesh_branch_scene, write_block_world
from tests.test_mesh_megakernel import _synthetic_textured_scene
from tests.test_torch_render import _arrays, _port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT_TOL, HIT_OUTLIERS = 1e-4, 0.005
ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)


def _port_scene(js):
    from raytpu_torch import convert

    return convert.scene_from_arrays(_arrays(
        js, sky_sphere_index=js.sky_sphere_index,
        **{"atlas.width": js.atlas.width, "atlas.height": js.atlas.height}),
        device="cpu")


def _scene(world, name):
    """(raytpu scene, camera, port scene, camera, raytpu config)."""
    from raytpu_torch import convert

    if name == "cornell":
        js, jc, cfg = jscenes.cornell_box()
    elif name == "cornell_dof_ao":
        js, jc, cfg = jscenes.cornell_box_dof_ao()
    elif name == "branches":
        js, jc = _synthetic_textured_scene()
        cfg = JConfig(**dataclasses.asdict(mesh_branch_scene("cpu")[2]))
    else:
        js, jc, cfg = jconfig.load_scene_file(world)
        if name == "block_world_bilinear":
            cfg = cfg.replace(bilinear_textures=True)
        if name == "block_world_ao":
            cfg = cfg.replace(use_ao=True, ao_samples=2)
    tc = convert.camera_from_arrays(_arrays(jc), device="cpu")
    return js, jc, _port_scene(js), tc, cfg


HIT_SCENES = ("cornell", "block_world", "block_world_bilinear", "branches")


def _rays(jc, cfg, seed, b=768):
    """Half camera rays, half random rays (a third of those with d.x = 0),
    as raytpu and port vectors."""
    rs = np.random.default_rng(seed)
    o, d = jrender.sample_rays(jc, cfg.replace(width=32, height=24),
                               jnp.arange(b // 2, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b // 2), np.float32)))
    ro = rs.uniform(-2, 2, (3, b // 2)).astype(np.float32)
    ro[1] = np.abs(ro[1])
    rd = rs.normal(size=(3, b // 2)).astype(np.float32)
    rd[0, : b // 6] = 0.0
    rd /= np.linalg.norm(rd, axis=0)
    o = np.concatenate([np.stack([np.asarray(c) for c in o]), ro], 1)
    d = np.concatenate([np.stack([np.asarray(c) for c in d]), rd], 1)
    return ((jvec.Vec3(*map(jnp.asarray, o)), jvec.Vec3(*map(jnp.asarray, d))),
            (tvec.Vec3(*map(torch.tensor, o)), tvec.Vec3(*map(torch.tensor, d))))


def _hit_planes(h):
    m = h.mat
    return [h.dst, *h.point, *h.normal, *m.diffuse, *m.emission,
            m.emission_strength, m.reflection, m.alpha, m.ior]


@pytest.mark.parametrize("route", ["matrices", "kernel"])
@pytest.mark.parametrize("name", HIT_SCENES)
def test_closest_and_any_hit_match_raytpu(world, name, route):
    js, jc, ts, _, cfg = _scene(world, name)
    (jo, jd), (to, td) = _rays(jc, cfg, HIT_SCENES.index(name))
    use = route == "kernel"
    jcfg = cfg.replace(use_pallas=use, pallas_interpret=use)
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    jg = j_precompute(js.triangles) if js.triangles.count else None
    tg = t_precompute(ts.triangles) if ts.n_triangles else None
    want = jhit.closest_hit(js, jg, jo, jd, jcfg)
    got = thit.closest_hit(ts, tg, to, td, tcfg)
    w_hit, g_hit = np.asarray(want.did_hit), got.did_hit.numpy()
    bad = w_hit != g_hit
    for gp, wp in zip(_hit_planes(got), _hit_planes(want)):
        x, y = np.asarray(wp), gp.detach().numpy()
        both = w_hit & g_hit
        bad |= both & (np.abs(x - y) > HIT_TOL + HIT_TOL * np.abs(x))
    assert bad.mean() <= HIT_OUTLIERS, f"{bad.mean():.2%} rays differ"
    assert w_hit.mean() > 0.5
    any_w = np.asarray(jhit.any_hit(js, jg, jo, jd, jcfg))
    any_g = thit.any_hit(ts, tg, to, td, tcfg).numpy()
    assert (any_w != any_g).mean() <= HIT_OUTLIERS
    np.testing.assert_array_equal(any_g, g_hit)


def _assert_close(got, want, what):
    for name, a, b in zip(("radiance", "albedo", "normal"), got, want):
        x = np.stack([np.asarray(c) for c in b], -1)
        y = np.stack([c.detach().numpy() for c in a], -1)
        assert np.isfinite(y).all(), f"{what} {name}: non-finite"
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, (
            f"{what} {name}: {bad.mean():.2%} rays differ "
            f"(max {np.abs(x - y).max():.4g})")


TRACE_SCENES = ("cornell", "cornell_dof_ao", "block_world",
                "block_world_bilinear", "block_world_ao", "branches")


@pytest.mark.parametrize("name", TRACE_SCENES)
def test_trace_matches_raytpu_scan(world, name):
    """``path.trace`` on both selection routes against raytpu's scan
    (matrices; eager on meshes), the same rays and draws."""
    js, jc, ts, _, cfg = _scene(world, name)
    cfg = cfg.replace(width=16, height=12, max_bounces=4 if "ao" in name else 6)
    rs = np.random.default_rng(TRACE_SCENES.index(name))
    b = cfg.n_pixels
    o, d = jrender.sample_rays(jc, cfg, jnp.arange(b, dtype=jnp.int32),
                               jnp.asarray(rs.random((4, b), np.float32)))
    draws = rs.random((cfg.max_bounces, jpath.n_bounce_draws(cfg), b),
                      np.float32)
    eager = jax.disable_jit() if js.triangles.count else nullcontext()
    with eager:
        want = jpath.trace(js, cfg, o, d, jnp.asarray(draws))
    to, td = (tvec.Vec3(*(torch.tensor(np.asarray(c)) for c in v))
              for v in (o, d))
    for pallas in (False, True):
        tcfg = TConfig(**dataclasses.asdict(cfg)).replace(use_pallas=pallas)
        got = tpath.trace(ts, tcfg, to, td, torch.tensor(draws))
        _assert_close(got, want, f"{name} use_pallas={pallas}")


def test_render_scan_path_matches_raytpu_bilinear(world):
    """``render`` with ``use_megakernel=False`` (and bilinear textures,
    which no megakernel takes) against raytpu's render, eager."""
    js, jc, ts, tc, cfg = _scene(world, "block_world_bilinear")
    cfg = cfg.replace(width=10, height=8, spp=2, max_bounces=4)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    with jax.disable_jit():
        want = jrender.render(js, jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(17))
    got = trender.render(ts, tc, TConfig(**dataclasses.asdict(cfg)), pids,
                         trng.prng_key(17))
    assert got.samples == int(want.samples) == 2
    _assert_close(got[:3], want[:3], "render bilinear")


def test_scan_path_matches_f64_oracle():
    """M3: the port's scan path against the scalar float64 oracle on a
    few Cornell pixels, at equal RNG streams."""
    from tests.oracle import render_oracle

    js, jc, cfg = jscenes.cornell_box()
    cfg = cfg.replace(width=6, height=4, spp=2, max_bounces=4)
    ts, tc, tcfg = _port(js, jc, cfg)
    sums = trender.render(ts, tc, tcfg, np.arange(cfg.n_pixels),
                          trng.prng_key(3))
    want = render_oracle(js, jc, cfg, jax.random.PRNGKey(3))
    for name, g, w in zip(("radiance", "albedo", "normal"), sums[:3], want):
        g = g.to_array().numpy().astype(np.float64)
        bad = (np.abs(g - w) > 0.02 * cfg.spp + 0.02 * np.abs(w)).any(-1)
        assert bad.mean() <= 0.02, f"{name}: {bad.mean():.2%} pixels differ"
    assert np.abs(want[0]).max() > 0


# --- dispatch ----------------------------------------------------------


def _raytpu_choice(js, jcfg):
    if jcfg.use_megakernel:
        if jtsph.supported(js, jcfg):
            return "K1"
        if jts.supported(js, jcfg):
            return "K3"
    return "scan"


def _port_choice(ts, tcfg):
    fn = trender.trace_fn(ts, tcfg)
    return {ttsph.trace_megakernel: "K1", tts.trace_mesh_megakernel: "K3",
            tpath.trace: "scan"}[fn]


def test_render_dispatch_matches_raytpu(world, tmp_path, capsys,
                                       monkeypatch):
    """``render``'s loop is raytpu's for every config: K1, K3 or the scan
    path, and the fallback reasons once per combination on stderr."""
    monkeypatch.setattr(thit, "_logged", set())
    big = write_block_world(str(tmp_path / "big"), n_triangles=4096)
    jbig, _, _ = jconfig.load_scene_file(big)
    cases = {"cornell": jscenes.cornell_box()[0],
             "world": jconfig.load_scene_file(world)[0], "world_4096": jbig}
    seen = []
    for name, js in cases.items():
        ts = _port_scene(js)
        for mk in (False, True):
            for bil in (False, True):
                jcfg = JConfig(use_megakernel=mk, bilinear_textures=bil)
                tcfg = TConfig(use_megakernel=mk, bilinear_textures=bil)
                want = _raytpu_choice(js, jcfg)
                assert _port_choice(ts, tcfg) == want, (name, mk, bil)
                seen.append(want)
    assert set(seen) == {"K1", "K3", "scan"}
    err = capsys.readouterr().err
    assert err.count("megakernel unavailable") == 3
    assert err.count("bilinear texture filtering") == 2  # 60 and 4096 tris
    assert err.count("4096 triangles > 2048") == 2     # nearest, bilinear
    trender.trace_fn(_port_scene(jbig), TConfig(use_megakernel=True))
    assert "megakernel unavailable" not in capsys.readouterr().err


def test_pallas_resolution_matches_raytpu(world, monkeypatch):
    """K4 runs exactly where raytpu's ``_resolve_use_pallas`` and
    ``pallas_supported`` turn it on: ``use_pallas``, or None with 128 or
    more triangles on an accelerator (raytpu: a non-CPU backend; the port:
    a CUDA device), and at most 4096 spheres and triangles."""
    for n_tri in (0, 60, 127, 128, 4096, 4097):
        for n_sph in (3, 4097):
            for use in (None, False, True):
                for accel in (False, True):
                    counts = SimpleNamespace(
                        triangles=SimpleNamespace(count=n_tri),
                        spheres=SimpleNamespace(count=n_sph))
                    monkeypatch.setattr(jax, "default_backend",
                                        lambda a=accel: "gpu" if a else "cpu")
                    want = (jhit._resolve_use_pallas(counts, JConfig(use_pallas=use))
                            and jint.pallas_supported(counts))
                    port = SimpleNamespace(
                        **vars(counts), device=torch.device("cuda" if accel
                                                            else "cpu"))
                    got = thit._use_kernel(port, TConfig(use_pallas=use))
                    assert got == want, (n_tri, n_sph, use, accel)


def test_kernel_bounds_fall_back_to_matrices_once(capsys, monkeypatch):
    """``use_pallas=True`` on more than 4096 triangles: the distance
    matrices serve, said once on stderr, with the matrices' winners."""
    monkeypatch.setattr(thit, "_logged", set())
    from raytpu_torch.core.types import Scene, Triangles

    rs = np.random.default_rng(5)
    n = tint.MAX_PRIMS + 4
    v = lambda: tvec.Vec3(*(torch.tensor(rs.uniform(-1, 1, n).astype(np.float32))
                            for _ in range(3)))
    z = torch.zeros(n)
    scene, _, _ = jscenes.cornell_box()
    sph = _port_scene(scene).spheres
    ts = Scene(sph, Triangles(v(), v(), v(), z, z, z, z, z, z,
                              torch.zeros(n, dtype=torch.int32)))
    o = tvec.Vec3(*(torch.tensor(rs.uniform(-0.5, 0.5, 64).astype(np.float32))
                    for _ in range(3)))
    d = tvec.Vec3(*(torch.tensor(rs.normal(size=64).astype(np.float32))
                    for _ in range(3))).normalize()
    a = thit.closest_hit(ts, None, o, d, TConfig(use_pallas=True))
    thit.closest_hit(ts, None, o, d, TConfig(use_pallas=True))
    c = thit.closest_hit(ts, None, o, d, TConfig(use_pallas=False))
    for x, y in zip(_hit_planes(a), _hit_planes(c)):
        assert torch.equal(x, y)
    assert capsys.readouterr().err.count("closest-hit kernel unavailable") == 1


def test_sky_scene_raises_naming_m7():
    """M7 is ported, so a sky scene no longer raises on the scan path: a
    sky index without a texture is a plain emitter, as in raytpu, and
    with a 16x8 texture on Cornell's ceiling (index 8) ``closest_hit``
    gives raytpu's hits, the ceiling's emission the texel it shows."""
    from raytpu.core.types import SkyTexture as JSky
    from raytpu_torch import convert

    js, jc, cfg = jscenes.cornell_box()
    (jo, jd), (to, td) = _rays(jc, cfg, 9)
    ts = _port_scene(js)
    idx_only = dataclasses.replace(ts, sky_sphere_index=8)
    assert idx_only.sky_index == -1
    for x, y in zip(_hit_planes(thit.closest_hit(ts, None, to, td, TConfig())),
                    _hit_planes(thit.closest_hit(idx_only, None, to, td,
                                                 TConfig()))):
        assert torch.equal(x, y)
    tex = np.random.default_rng(9).random((3, 16 * 8)).astype(np.float32)
    js = js.replace(sky=JSky(jvec.Vec3(*map(jnp.asarray, tex)), None, 16, 8),
                    sky_sphere_index=8)
    ts = convert.scene_from_arrays(_arrays(
        js, sky_sphere_index=8, **{"sky.width": 16, "sky.height": 8}),
        device="cpu")
    assert ts.sky_index == 8
    want = jhit.closest_hit(js, None, jo, jd, cfg)
    got = thit.closest_hit(ts, None, to, td, TConfig())
    w_hit, g_hit = np.asarray(want.did_hit), got.did_hit.numpy()
    bad = w_hit != g_hit
    for gp, wp in zip(_hit_planes(got), _hit_planes(want)):
        x, y = np.asarray(wp), gp.detach().numpy()
        bad |= w_hit & g_hit & (np.abs(x - y) > HIT_TOL + HIT_TOL * np.abs(x))
    assert bad.mean() <= HIT_OUTLIERS, f"{bad.mean():.2%} rays differ"
    on_sky = np.isin(got.mat.emission.x.numpy(), tex[0])
    assert on_sky.mean() > 0.05
    np.testing.assert_array_equal(
        thit.any_hit(ts, None, to, td, TConfig()).numpy(), g_hit)


@pytest.mark.parametrize("value,want", [("", False), ("0", False),
                                        ("1", True), ("true", True),
                                        ("yes", True)])
def test_no_megakernel_env(monkeypatch, value, want):
    """F5: any non-empty value other than "0" opts out; none crashes."""
    monkeypatch.setenv("RAYTPU_NO_MEGAKERNEL", value)
    assert tcli.no_megakernel(False) is want
    assert tcli.no_megakernel(True) is True


def test_cli_config_overrides(monkeypatch):
    monkeypatch.delenv("RAYTPU_NO_MEGAKERNEL", raising=False)
    ap = tcli._parser("t")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    over = lambda argv, dev: tcli.config_overrides(ap.parse_args(argv), dev)
    assert over(["cornell"], cuda) == {"use_megakernel": True}
    assert over(["cornell"], cpu) == {}
    assert over(["cornell", "--no-megakernel"], cuda) == {}
    assert over(["x.toml", "--pallas", "--bilinear", "--spp", "3"], cpu) == {
        "spp": 3, "use_pallas": True, "bilinear_textures": True}
    monkeypatch.setenv("RAYTPU_NO_MEGAKERNEL", "true")
    assert over(["cornell"], cuda) == {}


def test_cli_render_flags_on_cpu(world, tmp_path):
    """``cli render <toml> --no-megakernel --pallas --bilinear`` on the CPU
    with RAYTPU_NO_MEGAKERNEL=true runs the scan path (K4's plain
    version) and writes the frame."""
    out = tmp_path / "bw.ppm"
    res = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", world,
         "--device", "cpu", "--width", "12", "--height", "9", "--spp", "1",
         "--bounces", "3", "--no-megakernel", "--pallas", "--bilinear",
         "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           RAYTPU_NO_MEGAKERNEL="true"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert out.read_text().startswith("P3\n12 9\n255\n")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax():
    """No module of raytpu_torch and not chip_smoke.py imports jax or the
    JAX package, even inside a function."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "raytpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "raytpu", "flax", "optax"), (
                f"{os.path.relpath(f, ROOT)} imports {mod}")


def test_bilinear_keeps_the_atlas_uncollapsed(world, tmp_path):
    """A TOML with ``bilinear_textures = true`` keeps nearest-upscaled
    textures at their stored size (collapsing would change the bilinear
    blend), and collapses them without it, in both packages alike."""
    import shutil

    from raytpu_torch import config as tconfig
    from raytpu_torch.io.ppm import read_ppm, write_ppm

    d = tmp_path / "w"
    shutil.copytree(os.path.dirname(world), d)
    for f in (d / "tex").iterdir():             # 2x2 upscales of 8x8 tiles
        img = np.rint(read_ppm(str(f), bottom_up=False) * 255)
        write_ppm(str(f), np.repeat(np.repeat(img[::2, ::2], 2, 0), 2, 1))
    toml = d / os.path.basename(world)
    text = toml.read_text()
    for bil, size in ((False, 8), (True, 16)):
        toml.write_text(text.replace(
            "[render]\n", f"[render]\nbilinear_textures = {str(bil).lower()}\n"))
        js, _, jcfg = jconfig.load_scene_file(str(toml))
        ts, _, tcfg = tconfig.load_scene_file(str(toml), device="cpu")
        assert tcfg.bilinear_textures is jcfg.bilinear_textures is bil
        assert ts.atlas.width == js.atlas.width == size
        np.testing.assert_array_equal(ts.atlas.rgb.x.numpy(),
                                      np.asarray(js.atlas.rgb.x))
