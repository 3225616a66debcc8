"""raytpu_torch color and camera functions against raytpu on the same
numpy inputs. Tolerance atol 1e-6: both sides compute in f32 with the
same operation order, but XLA on the CPU and PyTorch may round tan,
division chains or fused products differently by an ulp or two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import scenes as jscenes
from raytpu.camera import get_rays as j_get_rays
from raytpu.camera import make_camera as j_make_camera
from raytpu.core import color as jcolor
from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu_torch import convert
from raytpu_torch import scenes as tscenes
from raytpu_torch.camera import get_rays as t_get_rays
from raytpu_torch.camera import make_camera as t_make_camera
from raytpu_torch.core import color as tcolor
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.vec3 import Vec3 as TVec3
from raytpu_torch.integrator.render import sample_rays as t_sample_rays

ATOL = 1e-6


def _arrays(tree):
    return {
        jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _close(t_vec, j_vec, atol=ATOL):
    for a, b in zip(t_vec, j_vec):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _rgb(seed, n=512):
    rgb = np.random.default_rng(seed).random((3, n), np.float32)
    rgb[:, :8] = rgb[0, :8]                   # gray: the s == 0 branch
    rgb[:, 8] = (1.0, 0.6, 0.2)               # scene emission colors
    rgb[:, 9] = (0.431, 1.0, 0.596)
    return rgb


@pytest.mark.parametrize("l_f,s_f", [(1.2, 1.0), (1.0, 1.0), (1.2, 0.8)])
def test_hsl_boost_matches(l_f, s_f):
    rgb = _rgb(0)
    want = jcolor.hsl_boost(JVec3(*map(jnp.asarray, rgb)), l_f, s_f)
    got = tcolor.hsl_boost(TVec3(*map(torch.tensor, rgb)), l_f, s_f)
    _close(got, want)


def test_tonemap_and_quantize_match():
    x = np.random.default_rng(1).uniform(-0.5, 2.0, (3, 1024)).astype(np.float32)
    jt = jcolor.tonemap(JVec3(*map(jnp.asarray, x)))
    tt = tcolor.tonemap(TVec3(*map(torch.tensor, x)))
    _close(tt, jt)
    _close(tcolor.quantize(tt), jcolor.quantize(jt))


CAMERAS = [
    dict(origin=(0.34, 0.3, 0.5), target=(0.0, -0.5, -3.0), up=(0.0, 1.0, 0.0),
         vfov_deg=70.0, aspect_ratio=4.0 / 3.0),
    dict(origin=(0, 0, 1), target=(0, 0, -3), up=(0, 1, 0),
         vfov_deg=50.0, aspect_ratio=1.5),
    dict(origin=(1.5, -2.0, 3.0), target=(-0.2, 0.4, -1.0), up=(0.1, 1.0, 0.2),
         vfov_deg=35.0, aspect_ratio=16.0 / 9.0),
]


@pytest.mark.parametrize("spec", CAMERAS)
def test_make_camera_matches(spec):
    jc = j_make_camera(**spec)
    tc = t_make_camera(**spec, device="cpu")
    for f in ("origin", "horizontal", "vertical", "lower_left"):
        _close(getattr(tc, f), getattr(jc, f))


def test_builtin_scene_cameras_match():
    for name, t_make in tscenes.BUILTIN.items():
        j_make = {"cornell": jscenes.cornell_box,
                  "cornell_cuda": jscenes.cornell_box_cuda,
                  "cornell_dof_ao": jscenes.cornell_box_dof_ao}[name]
        _, jc, jcfg = j_make()
        _, tc, tcfg = t_make(device="cpu")
        assert tcfg.__dict__ == jcfg.__dict__, name
        for f in ("origin", "horizontal", "vertical", "lower_left"):
            _close(getattr(tc, f), getattr(jc, f))


def test_get_rays_matches():
    rs = np.random.default_rng(2)
    u, v = rs.random((2, 300), np.float32)
    dx, dy = (rs.random((2, 300), np.float32) - 0.5) * 0.3
    jc = j_make_camera(**CAMERAS[0])
    tc = convert.camera_from_arrays(_arrays(jc), device="cpu")
    jo, jd = j_get_rays(jc, *map(jnp.asarray, (u, v)), 3.0,
                        *map(jnp.asarray, (dx, dy)))
    to, td = t_get_rays(tc, *map(torch.tensor, (u, v)), 3.0,
                        *map(torch.tensor, (dx, dy)))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_sample_rays_matches(aperture):
    kw = dict(width=40, height=30, aperture_x=aperture, aperture_y=aperture,
              focus_distance=3.0)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rs = np.random.default_rng(3)
    ids = rs.permutation(jcfg.n_pixels).astype(np.int32)
    draws = rs.random((4, ids.size), np.float32)
    jc = j_make_camera(**CAMERAS[0])
    tc = t_make_camera(**CAMERAS[0], device="cpu")
    jo, jd = j_sample_rays(jc, jcfg, jnp.asarray(ids), jnp.asarray(draws))
    to, td = t_sample_rays(tc, tcfg, torch.tensor(ids), torch.tensor(draws))
    _close(to, jo)
    _close(td, jd)
