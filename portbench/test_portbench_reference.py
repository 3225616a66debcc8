"""The benchmark's plain reference against ``raytpu_torch`` on the CPU, at
a tiny size: the configuration file is the scene ``raytpu_torch.scenes``
builds; the reference's threefry stream, camera, camera rays and bounce
loop equal the port's plain versions to the bit; its per-pixel sums and
pixels equal ``render`` and ``assemble_image``'s; its work counts equal
K1's plain version's; its training loss and gradient agree with the
port's step function. The test imports both; the reference imports
nothing of the port (``test_portbench_harness``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import image, rng, spheres, train, work
from raytpu_torch import scenes
from raytpu_torch.core import rng as trng
from raytpu_torch.integrator import render as trender
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.kernels import trace_spheres as ts
from raytpu_torch.kernels.trace_scene import Knobs
from raytpu_torch.train import make_train_step

CONFIG = json.loads((Path(__file__).parent / "configs" / "cornell.json")
                    .read_text())
SMALL = dict(width=16, height=12, max_bounces=4)


def _config(**render):
    c = json.loads(json.dumps(CONFIG))
    c["render"].update(SMALL, **render)
    return c


def _port(config):
    from portbench.scenes.spheres import program

    return program(config, torch.device("cpu"))


def test_config_is_the_ported_cornell_box():
    scene, cam, cfg = scenes.cornell_box("cpu")
    ours, our_cam, our_cfg = _port(CONFIG)
    for a, b in zip(ts.pack_spheres(scene), ts.pack_spheres(ours)):
        assert torch.equal(a, b)
    assert torch.equal(trender.pack_camera(cam), trender.pack_camera(our_cam))
    cornell = cfg.replace(width=1200, height=900, spp=1000, max_bounces=6,
                          use_megakernel=True, pixel_tile=1200 * 900)
    assert our_cfg == cornell
    sph, ref_cam, _ = spheres.build(CONFIG)
    assert torch.equal(sph, ts.pack_spheres(scene))
    assert torch.equal(ref_cam, trender.pack_camera(cam))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_stream_and_camera_rays_equal_the_sample_start(seed):
    config = _config()
    _, cam, cfg = _port(config)
    _, ref_cam, s = spheres.build(config)
    k = trng.prng_key(seed)
    ids = torch.arange(cfg.n_pixels)
    for sample in (0, 3):
        keys, o, d, rows = trender.sample_start_reference(
            trender.pack_camera(cam), cfg, k, ids, sample, 10)
        ref_keys = rng.ray_keys(rng.key(0, seed), ids,
                                torch.full_like(ids, sample))
        assert torch.equal(trng.key_pairs(keys), ref_keys)
        draws = rng.draws(ref_keys, range(10))
        assert torch.equal(draws[4:], rows)
        ro, rd = spheres.camera_rays(ref_cam, s, ids, draws[:4])
        for a, b in zip((*o, *d), (*ro, *rd)):
            assert torch.equal(a, b)


def test_bounce_loop_and_work_equal_k1_plain_version():
    config = _config(max_bounces=6)
    scene, _, cfg = _port(config)
    sph, cam, s = spheres.build(config)
    ids = torch.arange(cfg.n_pixels).repeat(3)
    sids = torch.arange(3).repeat_interleave(cfg.n_pixels)
    keys = rng.ray_keys(rng.key(0, 11), ids, sids)
    d = rng.draws(keys, range(4 + 6 * 3))
    o, direction = spheres.camera_rays(cam, s, ids, d[:4])
    k = Knobs.create(cfg, scene.spheres.count, n_bounce_draws(cfg))
    port_counts, counts = {}, {}
    port = ts.trace_spheres_reference(ts.pack_spheres(scene), *o, *direction,
                                      d[4:], k, counts=port_counts)
    ref = spheres.trace(sph, o, direction, d[4:], s, counts)
    assert torch.equal(port[:3], ref)
    assert counts == {"live": port_counts["live"],
                      "draws": port_counts["draws"]}
    assert counts["live"] > 0
    w = spheres.layer_work(config, ids.numel(), counts, ids.numel(),
                           train=True)
    assert w["bounce_loop"].ops == (counts["live"] * 163
                                    + counts["draws"] * work.DRAW_OPS)
    assert w["backward"].least_s > w["bounce_loop"].least_s > 0


@pytest.mark.parametrize("seed", [3, 2**32 + 9])
def test_pixel_sums_and_pixels_equal_the_render(seed):
    config = _config(spp=5)
    scene, cam, cfg = _port(config)
    sph, ref_cam, s = spheres.build(config)
    hi, lo = (seed >> 32) & rng.MASK, seed & rng.MASK
    key = torch.tensor([hi, lo], dtype=torch.int64)
    ids = torch.tensor([0, 5, 17, 100, cfg.n_pixels - 1])
    sums = trender.render(scene, cam, cfg, ids, key)
    ref = spheres.render_pixels(sph, ref_cam, s, rng.key(hi, lo), ids,
                                cfg.spp, max_rays=7)
    assert torch.equal(sums.radiance.to_array().T, ref)
    full = trender.render_image(scene, cam, cfg, key)
    mean, canvas = image.pixels(ref.T.numpy(), cfg.spp)
    rows = cfg.height - 1 - ids.numpy() // cfg.width
    cols = ids.numpy() % cfg.width
    np.testing.assert_array_equal(full.image[rows, cols], mean)
    np.testing.assert_array_equal(full.canvas[rows, cols], canvas)


def test_training_loss_and_gradient_agree_with_the_step():
    config = _config(spp=2)
    scene, cam, cfg = _port(config)
    sph, ref_cam, s = spheres.build(config)
    init_fn, step_fn = make_train_step(cfg, 0.01)
    state, static = init_fn(scene, cam)
    g = torch.Generator().manual_seed(1)
    target = torch.rand((cfg.n_pixels, 3), generator=g) ** 2
    pids = torch.arange(cfg.n_pixels)
    state, loss = step_fn(state, static, cam, pids, target, trng.prng_key(4))
    exp_avg = torch.stack([state.optimizer.state[p]["exp_avg"] / 0.1
                           for p in state.params.values()])
    ref_loss, ref_grad = train.loss_and_grad(
        lambda p, k, ids, sids, c: spheres.trace_rays(p, ref_cam, s, k, ids,
                                                      sids, counts=c),
        sph, rng.key(0, 4), cfg.spp, target, block=50)
    assert abs(float(loss) - ref_loss) <= 1e-6 * ref_loss
    scale = float(ref_grad.abs().max())
    assert scale > 0
    torch.testing.assert_close(exp_avg, ref_grad, atol=1e-5 * scale,
                               rtol=1e-4)
    assert list(state.params) == list(spheres.LEAVES)


def test_adam_steps_move_like_torch_adam():
    p0 = torch.tensor([[0.5, -1.0], [2.0, 0.0]])
    grads = [torch.tensor([[0.1, -0.2], [0.0, 3.0]]),
             torch.tensor([[-0.3, 0.2], [1e-3, 1.0]])]
    leaf = p0.clone().requires_grad_()
    opt = torch.optim.Adam([leaf], lr=0.01, betas=train.ADAM_BETAS,
                           eps=train.ADAM_EPS)
    p, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for t, g in enumerate(grads, start=1):
        leaf.grad = g.clone()
        opt.step()
        p, m, v = train.adam(p, g, m, v, t, 0.01)
    torch.testing.assert_close(p, leaf.detach(), rtol=1e-6, atol=1e-7)


def test_training_start_moves_only_the_diffuse_colours():
    from portbench.scenes.spheres import DIFFUSE, training_start

    starts = [training_start(CONFIG, torch.Generator().manual_seed(5), 0.2)
              for _ in range(2)]
    assert starts[0] == starts[1]
    moved = 0
    for row, start in zip(CONFIG["scene"]["spheres"],
                          starts[0]["scene"]["spheres"]):
        assert start[:DIFFUSE] == row[:DIFFUSE]
        assert start[DIFFUSE + 1:] == row[DIFFUSE + 1:]
        for a, b in zip(start[DIFFUSE], row[DIFFUSE]):
            assert 0.0 <= a <= 1.0 and abs(a - b) <= 0.2 + 1e-6
            moved += a != b
    assert moved > 0
    assert starts[0]["camera"] == CONFIG["camera"]
