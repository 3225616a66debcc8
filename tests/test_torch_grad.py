"""Gradients through the port against raytpu's.

* The colour and vector helpers that the backward differentiates: the
  port's autograd against ``jax.vjp`` at the edge cases (gray and black
  inputs, d == 0, zero-length vectors), finite and equal.
* The slice as a whole: gradients of a loss through the port's ``render``
  (K1's plain version recording winners, K2's plain version replaying
  them, under a per-sample checkpoint) against ``jax.grad`` through
  raytpu's ``render`` with the sphere megakernel in interpret mode, on
  every sphere leaf (a photometric loss plus a normal-AOV term, so the
  geometry leaves carry gradient too) and, with the normal-AOV loss of
  ``tests/test_megakernel.py``, on every camera leaf. 8x6 pixels, 2 spp,
  3 bounces.
* F2 (``ROADMAP.md``): the 19-bounce refraction stack at 4x3 pixels and
  1 spp against raytpu's scan path, whose reverse sweep runs on the CPU.

Tolerance for a leaf: |port - raytpu| <= 1e-3 * |raytpu| + 1e-5 * (the
leaf's largest |gradient|) + 1e-8. Both sides sum the same per-ray terms
in another order, and the geometry and camera gradients pass through a
grazing hit's distance, whose gradient grows as 1/sqrt(disc), and the
normal's 1/|p - c|: rounding differences of a few ulps in the two
frameworks' forward values came out as up to 3.4e-4 of a sphere's centre
gradient at these sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import scenes as jscenes
from raytpu.config import load_scene
from raytpu.core import color as jcolor
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator.render import render as j_render
from raytpu.train import combine_scene as j_combine
from raytpu.train import partition_scene as j_partition
from raytpu_torch import convert
from raytpu_torch.core import color as tcolor
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator.render import render as t_render

RTOL, SCALE_TOL, ATOL = 1e-3, 1e-5, 1e-8


def _arrays(tree, **static):
    d = {
        jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }
    d.update(static)
    return d


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), f"{what}: non-finite"
    tol = RTOL * np.abs(want) + SCALE_TOL * np.abs(want).max() + ATOL
    assert (np.abs(got - want) <= tol).all(), (
        f"{what}: max |diff| {np.abs(got - want).max():.3e}, "
        f"max |grad| {np.abs(want).max():.3e}")


# ---- colour and vector helpers at their edge cases -------------------------

EDGE_RGB = np.array([
    [0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0],
    [1.0, 0.5, 0.5], [0.5, 1.0, 0.5], [0.5, 0.5, 1.0], [1.0, 1.0, 0.0],
    [0.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.97, 0.9], [0.2, 0.2, 0.1],
], np.float32)


@pytest.mark.parametrize("lf,sf", [(1.2, 1.0), (1.0, 1.5), (1.2, 0.7)])
@pytest.mark.parametrize("weights", ["ramp", "zero"])
def test_hsl_boost_grad_matches_jax(lf, sf, weights):
    """Gray, black and white emitters (cmax == cmin, d == 0), ties in the
    max/min (split halves on both sides) and a zero cotangent (the
    untaken side of a select) give finite gradients equal to JAX's."""
    w = (np.arange(36, dtype=np.float32).reshape(3, 12) / 10.0
         if weights == "ramp" else np.zeros((3, 12), np.float32))
    x = EDGE_RGB.T.copy()
    _, pull = jax.vjp(lambda r, g, b: tuple(jcolor.hsl_boost(JVec3(r, g, b), lf, sf)),
                      *map(jnp.asarray, x))
    want = np.stack(pull(tuple(map(jnp.asarray, w))))
    xt = torch.tensor(x, requires_grad=True)
    out = tcolor.hsl_boost(TVec3(*xt), lf, sf)
    torch.autograd.backward(list(out), list(torch.tensor(w)))
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normalize_grad_matches_jax_at_zero_length():
    v = np.array([[0.0, 1e-30, 3.0, -2.0], [0.0, 0.0, 4.0, 1e-20],
                  [0.0, 0.0, 0.0, 0.0]], np.float32)
    w = np.ones((3, 4), np.float32)
    _, pull = jax.vjp(lambda a, b, c: tuple(JVec3(a, b, c).normalize()),
                      *map(jnp.asarray, v))
    want = np.stack(pull(tuple(map(jnp.asarray, w))))
    vt = torch.tensor(v, requires_grad=True)
    torch.autograd.backward(list(TVec3(*vt).normalize()), list(torch.tensor(w)))
    got = vt.grad.numpy()
    assert np.isfinite(got).all()
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6)
    assert (got[:, 0] == 0).all()        # zero-length input: zero gradient


# ---- the slice: gradients through render -----------------------------------

def _port(scene, cam, cfg):
    tscene = convert.scene_from_arrays(
        _arrays(scene, sky_sphere_index=scene.sky_sphere_index), device="cpu")
    tcam = convert.camera_from_arrays(_arrays(cam), device="cpu")
    return tscene, tcam, TConfig(**dataclasses.asdict(cfg))


def _refractive_cutout():
    rows = [
        ((0, -501, 0), 500.0, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 1.0, 1.0),
        ((0, 1.5, -3), 0.8, jscenes.BLACK, (1.0, 0.9, 0.7), 5.0, 0.0, 1.0, 1.0),
        ((0, 0, -3), 0.7, jscenes.WHITE, jscenes.BLACK, 0.0, 0.2, 0.1, 1.5),
        ((0.9, 0, -2.2), 0.4, jscenes.WHITE, jscenes.BLACK, 0.0, 0.0, 0.0, 1.0),
    ]
    from raytpu.camera import make_camera
    from raytpu.core.types import RenderConfig, Scene

    cam = make_camera(origin=(0, 0, 1), target=(0, 0, -3), up=(0, 1, 0),
                      vfov_deg=50.0, aspect_ratio=1.5)
    return (Scene.from_spheres(jscenes.spheres_from_rows(rows)), cam,
            RenderConfig())


SCENES = {
    "cornell": jscenes.cornell_box,
    "cornell_cuda": jscenes.cornell_box_cuda,        # HSL + AO
    "cornell_dof_ao": jscenes.cornell_box_dof_ao,    # DoF + AO
    "refractive_cutout": _refractive_cutout,
}


def _scene_grads(scene, cam, cfg, key_seed, radiance_target=0.2, **port_over):
    """(port, raytpu) gradients of a photometric + normal-AOV loss on
    every sphere leaf, keyed by leaf path; ``port_over`` replaces fields
    of the port's config."""
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    params, static = j_partition(scene)

    def j_loss(p):
        sums = j_render(j_combine(p, static), cam, cfg, jnp.asarray(pids),
                        jax.random.PRNGKey(key_seed))
        return (jnp.mean((sums.radiance.to_array() / cfg.spp
                          - radiance_target) ** 2)
                + jnp.mean((sums.normal.to_array() / cfg.spp) ** 2))

    want = _arrays(jax.grad(j_loss)(params))

    tscene, tcam, tcfg = _port(scene, cam, cfg)
    tcfg = tcfg.replace(**port_over)
    leaves = {k: v.clone().requires_grad_()
              for k, v in convert.scene_leaves(tscene).items()}
    sums = t_render(convert.scene_from_leaves(leaves), tcam, tcfg, pids,
                    trng.prng_key(key_seed))
    loss = (torch.mean((sums.radiance.to_array() / tcfg.spp
                        - radiance_target) ** 2)
            + torch.mean((sums.normal.to_array() / tcfg.spp) ** 2))
    loss.backward()
    return {k: v.grad for k, v in leaves.items()}, want


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sphere_leaf_grads_match_raytpu_megakernel(name):
    scene, cam, cfg = SCENES[name]()
    cfg = cfg.replace(width=8, height=6, spp=2, max_bounces=3,
                      use_megakernel=True, pallas_interpret=True)
    got, want = _scene_grads(scene, cam, cfg, sorted(SCENES).index(name) + 45)
    for leaf in convert.SPHERE_LEAVES:
        _close(got[leaf].numpy(), want[leaf], f"{name} {leaf}")
    for leaf in ("spheres.mat.diffuse.x", "spheres.mat.emission_strength"):
        assert np.abs(want[leaf]).max() > 0, leaf


def test_camera_leaf_grads_match_raytpu_megakernel():
    """Camera gradients flow through K2's ray cotangents and get_rays'
    pullback. Radiance is piecewise constant in the camera, so the loss
    reads the normal AOV (``tests/test_megakernel.py``)."""
    scene, cam, cfg = jscenes.cornell_box()
    cfg = cfg.replace(width=8, height=6, spp=2, max_bounces=3,
                      use_megakernel=True, pallas_interpret=True)
    pids = np.arange(cfg.n_pixels, dtype=np.int32)

    def j_loss(c):
        sums = j_render(scene, c, cfg, jnp.asarray(pids), jax.random.PRNGKey(47))
        return jnp.mean(sums.normal.to_array() * jnp.arange(3.0))

    want = _arrays(jax.grad(j_loss)(cam))
    tscene, tcam, tcfg = _port(scene, cam, cfg)
    leaves = {k: v.clone().requires_grad_()
              for k, v in convert.camera_leaves(tcam).items()}
    sums = t_render(tscene, convert.camera_from_leaves(leaves), tcfg, pids,
                    trng.prng_key(47))
    torch.mean(sums.normal.to_array() * torch.arange(3.0)).backward()
    assert max(abs(float(want[k])) for k in convert.CAMERA_LEAVES) > 0
    for leaf in convert.CAMERA_LEAVES:
        _close(leaves[leaf].grad.numpy(), want[leaf], f"camera {leaf}")


def test_refraction_stack_19_bounces_matches_scan_path():
    """F2: deep-bounce gradients of the port's kernel route (K1
    recording, K2) against raytpu's scan path (its windowed kernel sweep
    has no CPU coverage), on every sphere leaf."""
    scene, cam, cfg = load_scene("scenes/refraction_stack.toml")
    assert cfg.max_bounces == 19
    cfg = cfg.replace(width=4, height=3, spp=1, use_megakernel=False)
    got, want = _scene_grads(scene, cam, cfg, 79, radiance_target=0.3,
                             use_megakernel=True)
    for leaf in convert.SPHERE_LEAVES:
        _close(got[leaf].numpy(), want[leaf], f"stack {leaf}")
    assert np.abs(want["spheres.mat.diffuse.x"]).max() > 0
