"""Sharded rendering in the port (``raytpu_torch.sharding``) against its
straight render and ``raytpu.sharding``.

Cornell at 16x12, 8 spp, 4 bounces. In one process, the grids (1, 2),
(2, 1) and (2, 4) of a repeated CPU device against the port's
``render_image`` (rel. 1e-5: the cells sum the same per-(pixel, sample)
terms in another order) and against ``raytpu``'s
``render_image_sharded`` on the conftest's 8 virtual devices, at
``tests/test_torch_render.py``'s tolerance; ``raytpu``'s two
``ValueError``s (pixels not divisible by tiles, spp not divisible by
samples) and the grid's size. ``init_distributed`` without a
configuration is a no-op; a partial one raises. Two localhost processes
(``tests/_torch_multihost_worker.py``, gloo, a free port, 120 s) over
the grids (1, 2) and (2, 1) give every rank the single-process frame.
``cli render --sharded`` in one process gives the straight frame.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytpu import scenes as jscenes
from raytpu.sharding import make_mesh as j_make_mesh
from raytpu.sharding import render_image_sharded as j_render_image_sharded
from raytpu_torch import cli
from raytpu_torch.core import rng as trng
from raytpu_torch.integrator.render import render_image
from raytpu_torch.io.ppm import read_ppm
from raytpu_torch.sharding import (init_distributed, make_mesh,
                                   render_image_sharded, render_sharded)
from tests.test_torch_render import ATOL, OUTLIER_FRAC, RTOL, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=16, height=12, spp=8, max_bounces=4)
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cornell():
    js, jc, jcfg = jscenes.cornell_box()
    jcfg = jcfg.replace(**SMALL)
    ts, tc, tcfg = _port(js, jc, jcfg)
    straight = render_image(ts, tc, tcfg, trng.prng_key(0))
    return js, jc, jcfg, ts, tc, tcfg, straight


def _close_to(got, want, what):
    for name in ("image", "albedo", "normal"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=SHARD_RTOL, atol=SHARD_ATOL,
                                   err_msg=f"{what} {name}")
    assert (got.canvas == want.canvas).all(-1).mean() > 0.99, what


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 4)])
def test_grids_match_straight_render_and_raytpu(cornell, grid):
    js, jc, jcfg, ts, tc, tcfg, straight = cornell
    mesh = make_mesh(*grid, devices=["cpu"] * (grid[0] * grid[1]))
    assert mesh.shape == {"tiles": grid[0], "samples": grid[1]}
    got = render_image_sharded(ts, tc, tcfg, trng.prng_key(0), mesh)
    _close_to(got, straight, f"grid {grid}")
    want = j_render_image_sharded(js, jc, jcfg, jax.random.PRNGKey(0),
                                  j_make_mesh(*grid, jax.devices()[:8][
                                      :grid[0] * grid[1]]))
    for name in ("image", "albedo", "normal"):
        x, y = getattr(want, name), getattr(got, name)
        bad = (np.abs(x - y) > ATOL + RTOL * np.abs(x)).any(-1)
        assert bad.mean() <= OUTLIER_FRAC, f"{grid} {name}: {bad.mean():.2%}"


def test_render_sharded_sums_and_errors(cornell):
    _, _, _, ts, tc, tcfg, _ = cornell
    key, ids = trng.prng_key(0), np.arange(30)
    mesh = make_mesh(3, 2, devices=["cpu"] * 6)
    sums = render_sharded(ts, tc, tcfg, ids, key, mesh)
    from raytpu_torch.integrator.render import render

    ref = render(ts, tc, tcfg, ids, key)
    assert sums.samples == ref.samples == tcfg.spp
    for a, b in zip(sums[:3], ref[:3]):
        torch.testing.assert_close(a.to_array(), b.to_array(),
                                   rtol=SHARD_RTOL, atol=SHARD_ATOL)
    with pytest.raises(ValueError, match="not divisible by tiles=4"):
        render_sharded(ts, tc, tcfg, ids, key, make_mesh(4, 1, ["cpu"] * 4))
    with pytest.raises(ValueError, match="spp=8 not divisible by samples=3"):
        render_sharded(ts, tc, tcfg, ids, key, make_mesh(1, 3, ["cpu"] * 3))
    with pytest.raises(ValueError, match="spp=8 not divisible by samples=3"):
        render_image_sharded(ts, tc, tcfg, key, make_mesh(1, 3, ["cpu"] * 3))
    with pytest.raises(ValueError, match="mesh 2x2 != 3 devices"):
        make_mesh(2, 2, ["cpu"] * 3)
    assert make_mesh(devices=["cpu"] * 4).shape == {"tiles": 1, "samples": 4}
    assert make_mesh(n_samples=2, devices=["cpu"] * 4).shape["tiles"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_init_distributed_noop_and_partial(monkeypatch):
    for k in ("RAYTPU_COORDINATOR", "RAYTPU_NUM_PROCESSES",
              "RAYTPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RAYTPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="RAYTPU_NUM_PROCESSES"):
        init_distributed()
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("grid", ["1x2", "2x1"])
def test_two_processes_match_single_process(cornell, tmp_path, grid):
    straight = cornell[-1]
    out = str(tmp_path / "mh")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               RAYTPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               WORKER_NUM_PROCESSES="2", WORKER_GRID=grid, WORKER_OUT=out)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_multihost_worker.py")],
        env=dict(env, WORKER_PROCESS_ID=str(pid)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(logs)
    for pid in range(2):
        z = np.load(f"{out}.p{pid}.npz")
        for name in ("image", "albedo", "normal"):
            np.testing.assert_allclose(z[name], getattr(straight, name),
                                       rtol=SHARD_RTOL, atol=SHARD_ATOL,
                                       err_msg=f"rank {pid} {name}")
        assert (z["canvas"] == straight.canvas).all(-1).mean() > 0.99


def test_cli_sharded_matches_straight(tmp_path):
    size = ["cornell", "--device", "cpu", "--width", "16", "--height", "12",
            "--spp", "8", "--bounces", "4"]
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    assert cli.main(["render", *size, "--out", a]) == 0
    assert cli.main(["render", *size, "--sharded", "--out", b]) == 0
    x, y = read_ppm(a), read_ppm(b)
    assert np.abs(x - y).max() <= 1 / 255 + 1e-7
    assert (x == y).all(-1).mean() > 0.99
