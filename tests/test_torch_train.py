"""The port's trainer, target I/O, CLI and device defaults.

* One and two Adam steps of ``raytpu_torch.train.make_train_step`` against
  ``raytpu.train.make_train_step`` with ``optax.adam`` at the same learning
  rate (raytpu on its scan path), same scene, target and keys: the losses
  within 1e-5 relative and every parameter within 1e-6 + 1e-5*|x| (Adam
  moves a leaf by about lr * sign(grad), so the parameters agree as
  closely as the signs of their gradients do). On sphere scenes, and on
  the 60-triangle block world of ``test_torch_mesh_grad`` (its sky dome
  shrunk as there) over every float leaf, with ``partition_scene`` giving
  raytpu's float-leaf paths but the sky's. There raytpu's scan runs
  eagerly (``jax.disable_jit``): compiled, it takes the other branch of a
  water refraction on 1-2% of the rays (``ROADMAP.md`` F7), and Adam turns
  a gradient of the other sign into a step of 2 lr.
* ``read_ppm`` / ``load_rgb`` against raytpu's readers; PNG refused.
* ``cli train --device cpu`` on a tiny PPM target, for a built-in sphere
  scene and for a block-world TOML.
* The default-device repair: without ``device`` the constructors put
  their tensors on the CUDA card, and raise where there is none.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu import scenes as jscenes
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.io.ppm import read_ppm as j_read_ppm
from raytpu.train import partition_scene as j_partition
from raytpu.train import make_train_step as j_make_train_step
from raytpu.train import photometric_loss as j_photometric_loss
from raytpu_torch import camera as tcamera
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch import scenes as tscenes
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator.render import render_image
from raytpu_torch.io.image import load_rgb
from raytpu_torch.io.ppm import read_ppm, write_ppm
from raytpu_torch.train import (combine_scene, make_train_step,
                                partition_scene, photometric_loss)
from tests.test_torch_mesh_grad import _scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("name", ["cornell", "cornell_cuda"])
def test_adam_steps_match_raytpu(name):
    make = {"cornell": jscenes.cornell_box,
            "cornell_cuda": jscenes.cornell_box_cuda}[name]
    scene, cam, cfg = make()
    cfg = cfg.replace(width=8, height=6, spp=2, max_bounces=3)
    lr = 1e-2
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    target = np.random.default_rng(4).uniform(
        0.0, 0.5, (cfg.n_pixels, 3)).astype(np.float32)

    j_init, j_step = j_make_train_step(cfg, optax.adam(lr))
    j_state, j_static = j_init(scene, cam)
    tscene, tcam, tcfg = _port(scene, cam, cfg)
    # the port's kernel route (K1, K2); raytpu's default config takes its scan
    t_init, t_step = make_train_step(tcfg.replace(use_megakernel=True), lr)
    t_state, t_static = t_init(tscene, tcam)
    assert t_state.cam_params is None
    for step in range(2):
        j_state, j_loss = j_step(j_state, j_static, cam, jnp.asarray(pids),
                                 jnp.asarray(target), jax.random.PRNGKey(step))
        t_state, t_loss = t_step(t_state, t_static, tcam, pids, target,
                                 trng.prng_key(step))
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        want = _arrays(j_state.params)
        moved = 0
        for leaf in convert.SPHERE_LEAVES:
            got = t_state.params[leaf].detach().numpy()
            np.testing.assert_allclose(got, want[leaf], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {leaf}")
            moved += int((got != _arrays(scene)[leaf]).sum())
        assert moved > 0


def test_partition_combine_and_loss():
    scene, _, _ = tscenes.cornell_box(device="cpu")
    params, static = partition_scene(scene)
    assert tuple(params) == convert.SPHERE_LEAVES
    assert sorted(static) == ["atlas", "mat_table", "sky", "sky_sphere_index",
                              "triangles"]
    assert static["triangles"].count == 0 and static["atlas"].count == 0
    assert static["mat_table"].count == 1 and static["sky_sphere_index"] == -1
    back = combine_scene(params, static)
    assert all(a is b for a, b in zip(convert.scene_leaves(back).values(),
                                      params.values()))
    rs = np.random.default_rng(0)
    rad, tgt = rs.random((2, 20, 3), np.float32)
    want = j_photometric_loss(JVec3.from_array(jnp.asarray(rad)),
                              jnp.asarray(tgt))
    got = photometric_loss(TVec3.from_array(torch.tensor(rad)), torch.tensor(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_camera_updates_camera_leaves():
    scene, cam, cfg = tscenes.cornell_box(device="cpu")
    cfg = cfg.replace(width=6, height=4, spp=1, max_bounces=2)
    init_fn, step_fn = make_train_step(cfg, 1e-2, train_camera=True)
    state, static = init_fn(scene, cam)
    assert tuple(state.cam_params) == convert.CAMERA_LEAVES
    state, loss = step_fn(state, static, cam, np.arange(cfg.n_pixels),
                          np.zeros((cfg.n_pixels, 3), np.float32),
                          trng.prng_key(0))
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in state.cam_params.values())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tscenes.write_block_world(str(tmp_path_factory.mktemp("bw")),
                                     n_triangles=60, seed=3)


def test_mesh_adam_steps_match_raytpu(world):
    js, jc, ts, tc, cfg = _scene(world, "block_world")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=3)
    lr = 1e-2
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    target = np.random.default_rng(6).uniform(
        0.0, 0.5, (cfg.n_pixels, 3)).astype(np.float32)
    j_paths = {p for p in _arrays(j_partition(js)[0])
               if not p.startswith("sky.")}
    assert set(partition_scene(ts)[0]) == j_paths

    j_init, j_step = j_make_train_step(cfg, optax.adam(lr))
    # the port's kernel route (K3, K2); raytpu's default config takes its scan
    t_init, t_step = make_train_step(
        TConfig(**dataclasses.asdict(cfg)).replace(use_megakernel=True), lr)
    j_state, j_static = j_init(js, jc)
    t_state, t_static = t_init(ts, tc)
    start = convert.scene_leaves(ts)
    for step in range(2):
        with jax.disable_jit():
            j_state, j_loss = j_step(j_state, j_static, jc, jnp.asarray(pids),
                                     jnp.asarray(target),
                                     jax.random.PRNGKey(step))
        t_state, t_loss = t_step(t_state, t_static, tc, pids, target,
                                 trng.prng_key(step))
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        want = _arrays(j_state.params)
        moved = set()
        for path, p in t_state.params.items():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[path], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {path}")
            if (got != start[path].numpy()).any():
                moved.add(path.split(".")[0])
        assert {"atlas", "mat_table", "spheres"} <= moved


def test_cli_train_mesh_on_cpu(world, tmp_path):
    ts, tc, cfg = tconfig.load_scene_file(world, device="cpu")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=2, pixel_tile=48)
    target = tmp_path / "target.ppm"
    write_ppm(str(target), render_image(ts, tc, cfg, trng.prng_key(9)).canvas)
    out = tmp_path / "trained.ppm"
    res = _cli("train", world, "--target", str(target), "--steps", "2",
               "--log-every", "1", "--out", str(out), "--device", "cpu",
               "--width", "8", "--height", "6", "--spp", "1", "--bounces", "2")
    assert res.returncode == 0, res.stderr
    losses = [float(line.split()[-1]) for line in res.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.read_text().startswith("P3\n8 6\n255\n")


_PPM = b"""P3
# a comment line
3 2
# another
255
0 0 0   255 255 255  10 20 30
1 2 3   4 5 6        250 251 252 # trailing
"""


@pytest.mark.parametrize("bottom_up", [True, False])
def test_read_ppm_matches_raytpu(tmp_path, bottom_up):
    p = tmp_path / "t.ppm"
    p.write_bytes(_PPM)
    got = read_ppm(str(p), bottom_up=bottom_up)
    for native in (False, True):
        want = j_read_ppm(str(p), bottom_up=bottom_up, use_native=native)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(load_rgb(str(p)), read_ppm(str(p)))


def test_read_ppm_round_trip_and_png_refused(tmp_path, monkeypatch):
    """PPM round trip; a PNG is refused where PIL is missing (the card's
    machine), naming PIL (tests/test_torch_png.py reads PNG with it)."""
    canvas = np.random.default_rng(2).integers(0, 256, (5, 7, 3))
    p = tmp_path / "c.ppm"
    write_ppm(str(p), canvas)
    img = read_ppm(str(p), bottom_up=False)
    np.testing.assert_array_equal(np.rint(img * 255), canvas)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        load_rgb(str(tmp_path / "t.png"))
    bad = tmp_path / "b.ppm"
    bad.write_bytes(b"P6\n1 1\n255\n")
    with pytest.raises(ValueError, match="not an ASCII P3"):
        read_ppm(str(bad))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "raytpu_torch.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_train_on_cpu(tmp_path):
    scene, cam, cfg = tscenes.cornell_box(device="cpu")
    cfg = cfg.replace(width=8, height=6, spp=1, max_bounces=2,
                      pixel_tile=48)
    target = tmp_path / "target.ppm"
    write_ppm(str(target), render_image(scene, cam, cfg, trng.prng_key(9)).canvas)
    out = tmp_path / "trained.ppm"
    common = ["--device", "cpu", "--width", "8", "--height", "6",
              "--spp", "1", "--bounces", "2"]
    res = _cli("train", "cornell", "--target", str(target), "--steps", "3",
               "--lr", "0.05", "--log-every", "1", "--out", str(out), *common)
    assert res.returncode == 0, res.stderr
    losses = [float(line.split()[-1]) for line in res.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.read_text().startswith("P3\n8 6\n255\n")
    res = _cli("train", "cornell", "--target", str(target), "--steps", "1",
               "--width", "9", "--height", "6", "--device", "cpu",
               "--out", str(out))
    assert res.returncode != 0 and "target is 8x6" in res.stderr


def test_constructors_default_to_the_card():
    """Without ``device`` every constructor builds on CUDA: with no card
    that raises instead of quietly building CPU tensors."""
    j_scene, j_cam, _ = jscenes.cornell_box()
    rows = [((0, 0, -1), 0.5, (1, 1, 1), (0, 0, 0), 0.0, 0.0, 1.0, 1.0)]
    calls = {
        "spheres_from_rows": lambda d: tscenes.spheres_from_rows(rows, d).radius,
        "cornell_box": lambda d: tscenes.cornell_box(d)[0].device,
        "cornell_box_cuda": lambda d: tscenes.cornell_box_cuda(d)[0].device,
        "cornell_box_dof_ao": lambda d: tscenes.cornell_box_dof_ao(d)[0].device,
        "make_camera": lambda d: tcamera.make_camera(
            (0, 0, 1), (0, 0, -1), (0, 1, 0), 50.0, 1.5, d).origin.x,
        "scene_from_arrays": lambda d: convert.scene_from_arrays(
            _arrays(j_scene), d).device,
        "camera_from_arrays": lambda d: convert.camera_from_arrays(
            _arrays(j_cam), d).origin.x,
    }
    for name, call in calls.items():
        got = call("cpu")
        assert getattr(got, "device", got).type == "cpu", name
        if torch.cuda.is_available():
            got = call(None)
            assert getattr(got, "device", got).type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(None)
