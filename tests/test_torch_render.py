"""The slice as a whole: raytpu_torch's forward render against raytpu's.

Same scene (carried over by ``convert``), camera, config and PRNG key on
both sides; ``raytpu`` renders through its scan path and through the
Pallas megakernel in interpret mode, the port through the K1 wrapper's
plain version (CPU tensors). Sums are compared with the megakernel
tolerance: a pixel is an outlier if any channel differs by more than
1e-4 + 1e-5*|x|, at most 2% of pixels may be (grazing-hit flips between
roundings). Image assembly and PPM output are compared exactly.
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

from raytpu import scenes as jscenes
from raytpu.integrator import render as jrender
from raytpu.io.ppm import write_ppm as j_write_ppm
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.integrator import render as trender
from raytpu_torch.io.ppm import write_ppm as t_write_ppm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL, OUTLIER_FRAC = 1e-4, 1e-5, 0.02


def _arrays(tree, **static):
    d = {
        jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    d.update(static)
    return d


def _port(scene, cam, cfg):
    tscene = convert.scene_from_arrays(
        _arrays(scene, sky_sphere_index=scene.sky_sphere_index), device="cpu")
    tcam = convert.camera_from_arrays(_arrays(cam), device="cpu")
    return tscene, tcam, TConfig(**dataclasses.asdict(cfg))


CASES = {
    "cornell": (jscenes.cornell_box,
                dict(width=16, height=12, spp=4, max_bounces=5)),
    "cornell_cuda": (jscenes.cornell_box_cuda,
                     dict(width=12, height=8, spp=2, max_bounces=4)),
    "cornell_dof_ao": (jscenes.cornell_box_dof_ao,
                       dict(width=12, height=8, spp=2, max_bounces=4)),
}


def _assert_sums_close(got, want, what):
    assert got.samples == int(want.samples)
    for name in ("radiance", "albedo", "normal"):
        x = np.asarray(getattr(want, name).to_array())
        y = getattr(got, name).to_array().numpy()
        assert np.isfinite(y).all()
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, (
            f"{what} {name}: {bad.mean():.2%} pixels differ "
            f"(max {np.abs(x - y).max():.4g})"
        )


@pytest.mark.parametrize("path", ["scan", "megakernel_interpret"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_render_matches_raytpu(name, path):
    make, over = CASES[name]
    scene, cam, cfg = make()
    cfg = cfg.replace(**over)
    if path == "megakernel_interpret":
        cfg = cfg.replace(use_megakernel=True, pallas_interpret=True)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    want = jrender.render(scene, cam, cfg, jnp.asarray(pids),
                          jax.random.PRNGKey(41))
    got = trender.render(*_port(scene, cam, cfg), pids, trng.prng_key(41))
    _assert_sums_close(got, want, f"{name}/{path}")


def test_render_resumes_from_offset():
    """Samples [0, 2) then [2, 4) with init= equal samples [0, 4): the
    per-(pixel, sample) streams do not depend on how the loop is cut."""
    scene, cam, cfg = _port(*jscenes.cornell_box())
    cfg = cfg.replace(width=8, height=6, spp=4, max_bounces=3)
    pids = np.arange(cfg.n_pixels)
    key = trng.prng_key(5)
    full = trender.render(scene, cam, cfg, pids, key)
    half = trender.render(scene, cam, cfg, pids, key, n_samples=2)
    rest = trender.render(scene, cam, cfg, pids, key, sample_offset=2,
                          n_samples=2, init=half)
    assert rest.samples == full.samples == 4
    for a, b in zip(rest[:3], full[:3]):
        assert torch.equal(a.to_array(), b.to_array())


def test_blocked_pixel_order_matches():
    for w, h in ((1200, 900), (130, 70), (16, 12)):
        cfg = TConfig(width=w, height=h)
        np.testing.assert_array_equal(
            trender.blocked_pixel_order(cfg),
            jrender.blocked_pixel_order(jscenes.cornell_box()[2].replace(
                width=w, height=h)),
        )


def test_assemble_image_matches_exactly():
    rs = np.random.default_rng(0)
    sums = [rs.uniform(-0.1, 5.0, (20 * 15, 3)).astype(np.float32)
            for _ in range(3)]
    jcfg = jscenes.cornell_box()[2].replace(width=20, height=15, spp=7)
    want = jrender.assemble_image(jcfg, *sums)
    got = trender.assemble_image(TConfig(**dataclasses.asdict(jcfg)), *sums)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_render_image_canvas_matches():
    """Tiled full frame (pixel_tile 96 over 20x15: three tiles, the last
    padded) against raytpu's render_image: >= 98% of pixels equal."""
    scene, cam, cfg = jscenes.cornell_box()
    cfg = cfg.replace(width=20, height=15, spp=2, max_bounces=4, pixel_tile=96)
    want = jrender.render_image(scene, cam, cfg, jax.random.PRNGKey(7))
    got = trender.render_image(*_port(scene, cam, cfg), trng.prng_key(7))
    assert got.canvas.shape == want.canvas.shape == (15, 20, 3)
    same = (got.canvas == want.canvas).all(-1)
    assert same.mean() >= 0.98, f"{1 - same.mean():.2%} pixels differ"


def _frame_setup(**over):
    from raytpu_torch.scenes import cornell_box
    scene, cam, cfg = cornell_box(device="cpu")
    return scene, cam, cfg.replace(width=20, height=15, spp=2, max_bounces=3,
                                   **over)


def test_render_image_tiles_equal_one_tile_and_hand_scatter():
    """pixel_tile 96 over 20x15 (three tiles, the last padded) against one
    tile of the whole frame, and against render's per-tile sums scattered
    by hand over blocked_pixel_order: bit-identical."""
    scene, cam, cfg = _frame_setup(pixel_tile=96)
    key = trng.prng_key(7)
    got = trender.render_image(scene, cam, cfg, key)
    one = trender.render_image(scene, cam, cfg.replace(pixel_tile=10**6), key)
    ids = np.pad(trender.blocked_pixel_order(cfg), (0, 4 * 96 - 300),
                 mode="edge")
    sums = [np.zeros((300, 3), np.float32) for _ in range(3)]
    for t in range(0, 4 * 96, 96):
        tile = trender.render(scene, cam, cfg, ids[t:t + 96], key)
        for arr, v in zip(sums, tile[:3]):
            arr[ids[t:t + 96]] = v.to_array().numpy()
    hand = trender.assemble_image(cfg, *sums)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f), f)
        np.testing.assert_array_equal(getattr(got, f), getattr(hand, f), f)


@pytest.mark.parametrize("tile", [96, 128])
def test_tiled_pixel_order_is_made_once(tile, monkeypatch):
    """The cached order is blocked_pixel_order padded by its last id to
    whole tiles, read-only, and a second frame does not rebuild it or its
    device copy."""
    scene, cam, cfg = _frame_setup(pixel_tile=tile)
    fresh = trender.blocked_pixel_order(cfg)
    n = -(-300 // tile) * tile
    cached = trender.tiled_pixel_order(20, 15, tile)
    np.testing.assert_array_equal(
        cached, np.pad(fresh, (0, n - 300), mode="edge"))
    assert not cached.flags.writeable
    trender.tiled_pixel_order.cache_clear()
    trender.tiled_pixel_order_on.cache_clear()
    built = []
    real = trender.blocked_pixel_order
    monkeypatch.setattr(trender, "blocked_pixel_order",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    trender.render_image(scene, cam, cfg, trng.prng_key(1))
    on = trender.tiled_pixel_order_on(20, 15, tile, scene.device)
    trender.render_image(scene, cam, cfg, trng.prng_key(2))
    assert built == [1]
    assert trender.tiled_pixel_order_on(20, 15, tile, scene.device) is on
    assert on.dtype == torch.int64
    np.testing.assert_array_equal(on.numpy(), cached)


def test_render_image_frames_do_not_alias():
    """Two back-to-back frames with different keys: the first frame's
    arrays are unchanged after the second, and share no memory with it."""
    scene, cam, cfg = _frame_setup(pixel_tile=96)
    first = trender.render_image(scene, cam, cfg, trng.prng_key(3))
    kept = [np.array(a) for a in first]
    second = trender.render_image(scene, cam, cfg, trng.prng_key(4))
    assert not np.array_equal(first.image, second.image)
    for a, b, k in zip(first, second, kept):
        np.testing.assert_array_equal(a, k)
        assert not np.shares_memory(a, b)


def test_write_ppm_byte_identical(tmp_path):
    rs = np.random.default_rng(1)
    canvas = rs.integers(0, 256, (7, 9, 3)).astype(np.int32)
    a, b = tmp_path / "jax.ppm", tmp_path / "torch.ppm"
    j_write_ppm(str(a), canvas)
    t_write_ppm(str(b), canvas)
    assert a.read_bytes() == b.read_bytes()


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *code_or_args], cwd=kw.get("cwd", ROOT),
                          env=env, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['raytpu'] = None\n"
        "sys.modules['optax'] = None\n"
        "import raytpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(raytpu_torch.__path__, "
        "'raytpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = set(sys.modules) - before\n"
        "assert not [k for k in new if sys.modules[k] is not None and "
        "k.split('.')[0] in ('jax', 'flax', 'optax', 'raytpu')], new\n"
        "print(len(names))\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 22


def test_cli_renders_on_cpu_and_refuses_missing_cuda(tmp_path):
    out = tmp_path / "x.ppm"
    res = _run(["-m", "raytpu_torch.cli", "render", "cornell", "--device",
                "cpu", "--width", "8", "--height", "6", "--spp", "1",
                "--bounces", "2", "--out", str(out)])
    assert res.returncode == 0, res.stderr
    assert "Mrays/s" in res.stderr
    assert out.read_text().startswith("P3\n8 6\n255\n")
    if not torch.cuda.is_available():
        res = _run(["-m", "raytpu_torch.cli", "render", "cornell",
                    "--out", str(out)])
        assert res.returncode != 0 and "CUDA is not available" in res.stderr
