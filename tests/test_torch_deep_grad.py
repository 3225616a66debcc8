"""Gradients past the megakernels' backward cap (ROADMAP P-F14).

The port's K2 and K5 replay at most ``trace_scene_bwd.MAX_BOUNCES`` = 48
bounces. A render that asks for a megakernel (``use_megakernel=True``)
and needs gradients of more bounces goes through the scan path, whose
autograd has no cap (``integrator/render.trace_fn``), and says so once on
stderr; a forward-only render of the same depth stays on the megakernel.
Its gradients are held against ``jax.grad`` through raytpu's scan path
(F2: raytpu's deep kernel sweeps have no CPU coverage) at 50 bounces,
8x6 pixels, 2 spp, with ``tests/test_torch_grad.py``'s tolerance, on
every float leaf: Cornell and ``scenes.write_quad_fixture``, both jitted
on raytpu's side. F7's jit-against-eager flips are water refraction on
the block world; the fixture has no refractive material, its jitted
gradients meet the tolerance, and ``jax.disable_jit`` at this depth
takes 150 s where the jitted run takes 25 s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu import scenes as jscenes
from raytpu.integrator import render as jrender
from raytpu.train import combine_scene as j_combine
from raytpu.train import partition_scene as j_partition
from raytpu_torch import config as tconfig
from raytpu_torch import convert
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.integrator import hit, path
from raytpu_torch.integrator import render as trender
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.kernels import trace_spheres as tsp
from raytpu_torch.kernels.trace_scene_bwd import MAX_BOUNCES
from raytpu_torch.scenes import write_quad_fixture
from tests.test_torch_grad import _close
from tests.test_torch_render import _arrays, _port

DEEP = 50
SIZE = dict(width=8, height=6, spp=2, max_bounces=DEEP)


def _loss(sums, spp, mod):
    return (mod.mean((sums.radiance.to_array() / spp - 0.2) ** 2)
            + mod.mean((sums.normal.to_array() / spp) ** 2))


def _grads(js, jc, ts, tc, cfg, seed):
    """(port with ``use_megakernel=True``, raytpu's scan) gradients of the
    loss on every float scene leaf, keyed by leaf path."""
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    params, static = j_partition(js)

    def j_loss(p):
        sums = jrender.render(j_combine(p, static), jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(seed))
        return _loss(sums, cfg.spp, jnp)

    want = _arrays(jax.grad(j_loss)(params))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    tcfg = TConfig(**dataclasses.asdict(cfg)).replace(use_megakernel=True)
    sums = trender.render(scene, tc, tcfg, pids, trng.prng_key(seed))
    _loss(sums, tcfg.spp, torch).backward()
    got = {p: torch.zeros_like(v) if v.grad is None else v.grad
           for p, v in leaves.items()}
    return got, want, scene, tcfg


def _check_route(scene, cam, tcfg, megakernel, capfd):
    """The route at DEEP bounces: the scan path with gradients (said once
    on stderr), the megakernel without, whose forward runs."""
    err = capfd.readouterr().err
    assert err.count("scan path") == 1 and f"gradients of {DEEP}" in err, err
    assert trender.trace_fn(scene, tcfg, differentiate=True) is path.trace
    assert trender.trace_fn(scene, tcfg) is megakernel
    with torch.no_grad():
        sums = trender.render(scene, cam, tcfg, np.arange(4),
                              trng.prng_key(0), n_samples=1)
    assert torch.isfinite(sums.radiance.to_array()).all()


@pytest.fixture
def fresh_log(monkeypatch):
    """Each test sees its own first ``log_once`` line."""
    monkeypatch.setattr(hit, "_logged", set())


def test_megakernel_cap_is_48():
    assert MAX_BOUNCES == 48 < DEEP


def test_cornell_deep_grads_match_raytpu_scan(fresh_log, capfd):
    js, jc, cfg = jscenes.cornell_box()
    cfg = cfg.replace(**SIZE)
    ts, tc, _ = _port(js, jc, cfg)
    got, want, scene, tcfg = _grads(js, jc, ts, tc, cfg, 83)
    _check_route(scene, tc, tcfg, tsp.trace_megakernel, capfd)
    assert len(got) == len(convert.SPHERE_LEAVES)
    for leaf, g in got.items():
        _close(g.numpy(), want[leaf], f"cornell {DEEP}b {leaf}")
    for leaf in ("spheres.mat.diffuse.x", "spheres.mat.emission_strength"):
        assert np.abs(want[leaf]).max() > 0, leaf


@pytest.fixture(scope="module")
def fixture_toml(tmp_path_factory):
    return write_quad_fixture(str(tmp_path_factory.mktemp("quads")), seed=0)


def test_quad_fixture_deep_grads_match_raytpu_scan(fixture_toml, fresh_log,
                                                   capfd):
    js, jc, jcfg = jconfig.load_scene_file(fixture_toml)
    ts, tc, _ = tconfig.load_scene_file(fixture_toml, device="cpu")
    cfg = jcfg.replace(**SIZE)
    assert cfg.quad_pairs and tts.supported(ts, TConfig(
        **dataclasses.asdict(cfg)).replace(use_megakernel=True))
    got, want, scene, tcfg = _grads(js, jc, ts, tc, cfg, 89)
    _check_route(scene, tc, tcfg, tts.trace_mesh_megakernel, capfd)
    assert set(convert.TRIANGLE_LEAVES) <= set(got)
    lit = 0
    for leaf, g in got.items():
        if want[leaf].size == 0:    # the fixture has no sky texels
            assert g.numel() == 0, leaf
            continue
        _close(g.numpy(), want[leaf], f"quad fixture {DEEP}b {leaf}")
        lit += np.abs(want[leaf]).max() > 0
    assert lit >= 20, lit
