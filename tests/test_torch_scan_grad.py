"""Gradients through the port's scan path against ``jax.grad`` through
raytpu's.

``render`` with ``use_megakernel=False`` on both sides (the port's scan
path differentiated by autograd, raytpu's scan under ``jax.grad``), the
same scene, camera, config and PRNG key, every float leaf of the scene
requiring grad; the loss reads radiance and the normal AOV
(``tests/test_mesh_megakernel``), so geometry carries gradient. Scenes:
Cornell (jitted on raytpu's side) and the 60-triangle block world with
``bilinear_textures=True``, the differentiable texture mode in which the
triangle vertices get gradients, run eagerly on raytpu's side
(``jax.disable_jit``, ROADMAP F7) at 4x3 pixels, 1 spp, 3 bounces, with
its sky dome shrunk to radius 100 on both sides as in
``tests/test_torch_mesh_grad``: a ray leaving the 1e5 dome meets it
again or not by rounding (F7), which moves the dome's gradients. Both
selection routes of the port are run (distance matrices and K4's plain
version). Tolerance of ``tests/test_torch_mesh_grad`` (c): each entry
within 1e-3 |g| + 1e-5 max|g| + 1e-8 of raytpu's; the ``triangles.a.*``
gradients must be non-zero on both sides.

And in absolute terms, without raytpu: on one bilinear-textured triangle
under an emissive dome, where no ray meets an edge or a knife edge, the
vertex gradient is a descent direction whose size a central difference
of the loss reproduces to FD_RTOL (bilinear fetch is only piecewise
smooth, so the difference converges linearly in the step: 17% off at a
step of 1e-2, 3.5% at 1e-3, 0.5% at 1e-4).
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
from raytpu_torch.camera import make_camera
from raytpu_torch.core.types import MatTable, Scene, TextureAtlas, Triangles
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator import render as trender
from raytpu_torch.scenes import BLACK, WHITE, spheres_from_rows
from raytpu_torch.scenes import write_block_world
from tests.test_torch_mesh_grad import _small_dome
from tests.test_torch_render import _arrays, _port

GRAD_RTOL, GRAD_SCALE, GRAD_ATOL = 1e-3, 1e-5, 1e-8
FD_STEP, FD_RTOL = 1e-4, 0.02


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)


def _loss(sums, spp, mod):
    return (mod.mean((sums.radiance.to_array() / spp - 0.2) ** 2)
            + mod.mean((sums.normal.to_array() / spp) ** 2))


def _grads(js, jc, ts, tc, cfg, seed, eager, use_pallas):
    """(port, raytpu) gradients of the loss on every float scene leaf,
    keyed by leaf path."""
    pids = np.arange(cfg.n_pixels, dtype=np.int32)
    params, static = j_partition(js)

    def j_loss(p):
        sums = jrender.render(j_combine(p, static), jc, cfg, jnp.asarray(pids),
                              jax.random.PRNGKey(seed))
        return _loss(sums, cfg.spp, jnp)

    if eager:
        with jax.disable_jit():
            want = _arrays(jax.grad(j_loss)(params))
    else:
        want = _arrays(jax.grad(j_loss)(params))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in convert.scene_leaves(ts).items()}
    scene = convert.scene_from_leaves(leaves, ts.triangles, ts.atlas,
                                      ts.mat_table)
    tcfg = TConfig(**dataclasses.asdict(cfg)).replace(use_pallas=use_pallas)
    sums = trender.render(scene, tc, tcfg, pids, trng.prng_key(seed))
    _loss(sums, tcfg.spp, torch).backward()
    return {p: torch.zeros_like(v) if v.grad is None else v.grad
            for p, v in leaves.items()}, want


def _check(got, want):
    assert set(got) <= set(want)
    for path, g in got.items():
        g = np.asarray(g.numpy(), np.float64)
        w = np.asarray(want[path], np.float64)
        assert np.isfinite(g).all(), path
        tol = GRAD_RTOL * np.abs(w) + GRAD_SCALE * np.abs(w).max() + GRAD_ATOL
        assert (np.abs(g - w) <= tol).all(), (
            f"{path}: max |diff| {np.abs(g - w).max():.3e}, max |grad| "
            f"{np.abs(w).max():.3e}")


def test_cornell_leaf_grads_match_raytpu_scan():
    js, jc, cfg = jscenes.cornell_box()
    cfg = cfg.replace(width=8, height=6, spp=2, max_bounces=3)
    ts, tc, _ = _port(js, jc, cfg)
    got, want = _grads(js, jc, ts, tc, cfg, 53, eager=False, use_pallas=None)
    assert len(got) == len(convert.SPHERE_LEAVES)
    _check(got, want)
    for leaf in ("spheres.center.x", "spheres.mat.diffuse.x",
                 "spheres.mat.emission_strength"):
        assert np.abs(want[leaf]).max() > 0, leaf


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bilinear_mesh_leaf_grads_match_raytpu_scan(world, use_pallas):
    js, jc, jcfg = jconfig.load_scene_file(world)
    ts, tc, _ = tconfig.load_scene_file(world, device="cpu")
    js, ts = _small_dome(js, ts)
    cfg = jcfg.replace(width=4, height=3, spp=1, max_bounces=3,
                       bilinear_textures=True)
    got, want = _grads(js, jc, ts, tc, cfg, 71, eager=True,
                       use_pallas=use_pallas)
    assert set(convert.TRIANGLE_LEAVES) <= set(got)
    _check(got, want)
    for c in "xyz":
        leaf = f"triangles.a.{c}"
        assert np.abs(want[leaf]).max() > 0, leaf
        assert got[leaf].abs().max() > 0, leaf



def _textured_triangle():
    """One triangle with UVs over a random 8x8 atlas, inside a radius-100
    emissive dome, and a camera whose pixels all hit the triangle."""
    rs = np.random.default_rng(5)
    f = lambda a: torch.as_tensor(np.float32(a))
    v = lambda *p: Vec3(*(f([c]) for c in p))
    tris = Triangles(v(-1.0, -1.0, -2.0), v(1.0, -1.0, -2.0),
                     v(0.0, 1.5, -2.0), f([0.0]), f([0.0]), f([1.0]),
                     f([0.0]), f([0.5]), f([1.0]),
                     mat_id=torch.tensor([0], dtype=torch.int32))
    rgb = rs.random((64, 3), np.float32)
    atlas = TextureAtlas(Vec3(*(f(rgb[:, i]) for i in range(3))),
                         f(np.ones(64)), 8, 8)
    sph = spheres_from_rows([((0, 0, 0), 100.0, BLACK, WHITE, 1.0, 0.0, 1.0,
                              1.0)], "cpu")
    cam = make_camera(origin=(0, -0.1, 0), target=(0, -0.1, -2),
                      up=(0, 1, 0), vfov_deg=20.0, aspect_ratio=1.0,
                      device="cpu")
    return Scene(sph, tris, atlas, MatTable.default(1, "cpu")), cam


def test_bilinear_vertex_grad_is_a_descent_direction():
    ts, cam = _textured_triangle()
    cfg = TConfig(width=8, height=8, spp=2, max_bounces=2,
                  bilinear_textures=True)
    pids = torch.arange(cfg.n_pixels)
    leaves = convert.scene_leaves(ts)
    verts = [f"triangles.{v}.{c}" for v in "abc" for c in "xyz"]

    def loss(moved):
        scene = convert.scene_from_leaves({**leaves, **moved}, ts.triangles,
                                          ts.atlas, ts.mat_table)
        sums = trender.render(scene, cam, cfg, pids, trng.prng_key(3))
        assert bool(sums.normal.to_array().abs().sum(1).gt(0).all())
        return torch.mean((sums.radiance.to_array() / cfg.spp - 0.2) ** 2)

    x = {p: leaves[p].detach().clone().requires_grad_() for p in verts}
    l0 = loss(x)
    l0.backward()
    g = torch.cat([x[p].grad for p in verts]).double()
    step = -g / g.norm()
    with torch.no_grad():
        at = lambda h: loss({p: x[p] + h * float(step[i])
                             for i, p in enumerate(verts)}).item()
        l_fwd, l_back = at(FD_STEP), at(-FD_STEP)
    slope = (l_fwd - l_back) / (2 * FD_STEP)
    assert l_fwd < l0.item() < l_back
    assert abs(slope + g.norm().item()) <= FD_RTOL * g.norm().item(), (
        slope, -g.norm().item())
