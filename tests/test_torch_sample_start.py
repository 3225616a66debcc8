"""The start of a sample (``render.sample_start``): the ray keys, the
camera rays and the draw rows of one sample, made in one launch of the
sample-start kernel (``csrc/rng.cu``) on the card and by its plain
version on the CPU, held against ``raytpu``'s ``rng.ray_uniforms`` and
``render.sample_rays``; the camera's backward ``camera_rays_vjp`` against
autograd through ``sample_rays`` and ``jax.grad`` of ``raytpu``'s; the
kernel route's layout, views and autograd function, driven on the CPU by
an emulated launch (the plain version writing the kernel's output
layout); the sphere modes' table sum (``csrc/replay.cuh``:
``warp_table_sum``) emulated in numpy.

Tolerances: keys and draws bit-equal (the same threefry); rays atol 1e-6
(``tests/test_torch_color_camera.py``: XLA on the CPU and PyTorch may
round division chains differently by an ulp); the camera's cotangent
rtol 1e-5 against autograd run in float64 (a float32 sum over B rays
carries an error relative to the sum of |terms|, which cancellation can
make larger than 1e-5 of the sum), rtol 1e-4 against ``jax.grad`` in
float32 over 1,200 rays."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.camera import make_camera as j_make_camera
from raytpu.core import rng as jrng
from raytpu.core.types import RenderConfig as JConfig
from raytpu.integrator.render import sample_rays as j_sample_rays
from raytpu_torch import scenes as tscenes
from raytpu_torch.camera import make_camera as t_make_camera
from raytpu_torch.core import rng as trng
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.integrator import render as trender
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.kernels import _build

CAMERA = dict(origin=(0.34, 0.3, 0.5), target=(0.0, -0.5, -3.0),
              up=(0.0, 1.0, 0.0), vfov_deg=70.0, aspect_ratio=4.0 / 3.0)
ATOL = 1e-6
REPLAY = Path(__file__).resolve().parent.parent / "raytpu_torch/csrc/replay.cuh"


def _cfg(aperture, **over):
    kw = dict(width=40, height=30, aperture_x=aperture, aperture_y=aperture,
              focus_distance=3.0, max_bounces=6, **over)
    return JConfig(**kw), TConfig(**kw)


def _ids(n, seed=3):
    return np.random.default_rng(seed).permutation(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _words(jkeys):
    """(B, 2) JAX uint32 keys -> the (2, B) int32 words of the port."""
    return torch.tensor(np.asarray(jkeys).astype(np.uint32).T.view(np.int32))


def _vec_np(v):
    return np.stack([np.asarray(c) for c in v])


# ---- the plain version against raytpu ---------------------------------------

@pytest.mark.parametrize("rows", [4, 4 + 6 * 3])
@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_sample_start_matches_raytpu(aperture, rows):
    jcfg, tcfg = _cfg(aperture)
    ids = _ids(jcfg.n_pixels)
    s = 5
    jkeys = jrng.sample_keys(jrng.pixel_keys(jax.random.PRNGKey(7),
                                             jnp.asarray(ids, jnp.int32)), s)
    nd = (rows - 4) // jcfg.max_bounces if rows > 4 else 3
    cam_d, bounce = jrng.ray_uniforms(jkeys, 4, nd, jcfg.max_bounces)
    jo, jd = j_sample_rays(j_make_camera(**CAMERA), jcfg,
                           jnp.asarray(ids, jnp.int32), cam_d)
    cam = trender.pack_camera(t_make_camera(**CAMERA, device="cpu"))
    keys, o, d, got_rows = trender.sample_start(
        cam, tcfg, trng.prng_key(7), torch.tensor(ids), s, rows)
    assert keys.dtype == torch.int32
    assert torch.equal(keys, _words(jkeys))
    np.testing.assert_allclose(_vec_np(o), _vec_np(jo), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_vec_np(d), _vec_np(jd), rtol=0, atol=ATOL)
    assert tuple(got_rows.shape) == (rows - 4, jcfg.n_pixels)
    if rows > 4:
        want = np.asarray(bounce).reshape(rows - 4, -1)
        np.testing.assert_array_equal(_bits(got_rows.numpy()), _bits(want))


def test_sample_start_is_the_streams_and_sample_rays():
    """The plain version is ``rng.stream_reference`` then ``sample_rays`` on
    the same camera, bit for bit (the render's CPU route is unchanged)."""
    _, tcfg = _cfg(0.3)
    cam = t_make_camera(**CAMERA, device="cpu")
    ids = torch.tensor(_ids(tcfg.n_pixels, 4))
    key = trng.prng_key(11)
    keys, o, d, rows = trender.sample_start(trender.pack_camera(cam), tcfg,
                                            key, ids, 2, 22)
    w_keys, draws = trng.stream_reference(key, ids, 2, 22)
    wo, wd = trender.sample_rays(cam, tcfg, ids, draws[:4])
    assert torch.equal(keys, w_keys) and torch.equal(rows, draws[4:])
    for a, b in zip((*o, *d), (*wo, *wd)):
        assert torch.equal(a, b)


# ---- the camera's backward ---------------------------------------------------

def _cotangents(b, seed):
    rs = np.random.default_rng(seed)
    return (torch.tensor(rs.uniform(-1, 1, (3, b)).astype(np.float32)),
            torch.tensor(rs.uniform(-1, 1, (3, b)).astype(np.float32)))


def _inputs(aperture, seed=9):
    jcfg, tcfg = _cfg(aperture)
    ids = torch.tensor(_ids(tcfg.n_pixels, seed))
    draws = torch.tensor(np.random.default_rng(seed).random(
        (4, tcfg.n_pixels), np.float32))
    cam = trender.pack_camera(t_make_camera(**CAMERA, device="cpu"))
    return jcfg, tcfg, ids, draws, cam


def _autograd64(cam, cfg, ids, draws, g_o, g_d):
    """d(<g_o, origin> + <g_d, direction>) / d cam through ``sample_rays``,
    in float64."""
    c = cam.detach().double().requires_grad_()
    o, d = trender.sample_rays(trender.unpack_camera(c), cfg, ids,
                               draws.double())
    loss = sum((g * x).sum() for g, x in zip(g_o.double(), o)) + sum(
        (g * x).sum() for g, x in zip(g_d.double(), d))
    return torch.autograd.grad(loss, c)[0]


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_camera_rays_vjp_matches_autograd(aperture):
    _, tcfg, ids, draws, cam = _inputs(aperture)
    g_o, g_d = _cotangents(tcfg.n_pixels, 1)
    got = trender.camera_rays_vjp(cam, tcfg, ids, draws, g_o, g_d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (12,)
    want = _autograd64(cam, tcfg, ids, draws, g_o, g_d)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), rtol=1e-5,
                               atol=0)
    # float32 autograd as the port's CPU route takes it: the same within
    # its own rounding of sums over 1,200 rays
    c = cam.detach().clone().requires_grad_()
    o, d = trender.sample_rays(trender.unpack_camera(c), tcfg, ids, draws)
    loss = sum((g * x).sum() for g, x in zip(g_o, o)) + sum(
        (g * x).sum() for g, x in zip(g_d, d))
    f32 = torch.autograd.grad(loss, c)[0]
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=1e-3,
                               atol=1e-3 * float(f32.abs().max()))


@pytest.mark.parametrize("aperture", [0.0, 0.3])
def test_camera_rays_vjp_matches_jax_grad(aperture):
    jcfg, tcfg, ids, draws, cam = _inputs(aperture, 10)
    g_o, g_d = _cotangents(tcfg.n_pixels, 2)
    jg_o, jg_d, jdraws = map(jnp.asarray, (g_o.numpy(), g_d.numpy(),
                                           draws.numpy()))
    jids = jnp.asarray(ids.numpy(), jnp.int32)

    def loss(jcam):
        o, d = j_sample_rays(jcam, jcfg, jids, jdraws)
        return (sum(jnp.sum(g * x) for g, x in zip(jg_o, (o.x, o.y, o.z)))
                + sum(jnp.sum(g * x) for g, x in zip(jg_d, (d.x, d.y, d.z))))

    jgrad = jax.grad(loss)(j_make_camera(**CAMERA))
    want = np.array([float(getattr(getattr(jgrad, v), c))
                     for v in ("origin", "horizontal", "vertical",
                               "lower_left") for c in "xyz"], np.float32)
    got = trender.camera_rays_vjp(cam, tcfg, ids, draws, g_o, g_d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


# ---- the kernel route, its launch emulated on the CPU ------------------------

def _emulated_launch(calls):
    """``rng.launch_start`` on the CPU: the plain version written in the
    kernel's layout (keys' words, origin, direction, rows row0 ..)."""
    def launch(key, pixel_ids, cam, sample_id, width, height, aperture,
               focus, row0, n_rows):
        calls.append((row0, n_rows))
        cfg = TConfig(width=width, height=height, aperture_x=aperture[0],
                      aperture_y=aperture[1], focus_distance=focus)
        keys, draws = trng.stream_reference(key, pixel_ids, sample_id, n_rows)
        o, d = trender.sample_rays(trender.unpack_camera(cam), cfg,
                                   pixel_ids, draws[:4])
        return torch.cat([keys.view(torch.float32), torch.stack([*o, *d]),
                          draws[row0:]]).contiguous()
    return launch


@pytest.mark.parametrize("grad", [False, True])
def test_kernel_route_layout_and_grads(grad, monkeypatch):
    """The kernel route's outputs are views of the launch's one tensor
    (no copy), equal to the plain version's; with a camera that requires
    grad the launch also writes rows 0-3 and the camera's gradient is
    ``camera_rays_vjp``'s, equal to autograd through the plain version."""
    calls = []
    monkeypatch.setattr(trng, "launch_start", _emulated_launch(calls))
    _, tcfg, ids, _, cam = _inputs(0.3, 12)
    key = trng.prng_key(4)
    cam = cam.detach().requires_grad_(grad)
    keys, o, d, rows = trender.kernel_start(cam, tcfg, key, ids, 3, 22)
    assert calls == [(0 if grad else 4, 22)]
    base = keys.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in (*o, *d, rows))
    w_keys, wo, wd, w_rows = trender.sample_start_reference(
        cam.detach(), tcfg, key, ids, 3, 22)
    assert torch.equal(keys, w_keys) and torch.equal(rows, w_rows)
    for a, b in zip((*o, *d), (*wo, *wd)):
        assert torch.equal(a, b)
    assert all(t.requires_grad == grad for t in (*o, *d))
    if grad:
        g_o, g_d = _cotangents(tcfg.n_pixels, 5)
        loss = sum((g * x).sum() for g, x in zip(g_o, o)) + sum(
            (g * x).sum() for g, x in zip(g_d, d))
        got = torch.autograd.grad(loss, cam)[0]
        want = _autograd64(cam, tcfg, ids, trng.stream_reference(
            key, ids, 3, 4)[1], g_o, g_d)
        np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                                   rtol=1e-5, atol=0)


def _aov_loss(sums):
    return (sums.radiance.to_array().sum()
            + (sums.normal.to_array() * torch.tensor([0.3, -0.7, 1.1])).sum())


@pytest.mark.parametrize("megakernel", [True, False])
def test_render_through_the_kernel_route(megakernel, monkeypatch):
    """``render`` starts each sample with one sample-start call, the keys'
    4 camera rows on the K1 route and every bounce row on the scan path;
    through the kernel route (its launch emulated) the sums equal the
    plain route's bit for bit, and with a trained camera the camera's
    gradient agrees with the plain route's (autograd in float32). The loss
    reads the normal AOV: the radiance of constant emitters and albedos
    is piecewise constant in the camera rays, its gradient 0."""
    scene, cam, cfg = tscenes.cornell_box(device="cpu")
    cfg = cfg.replace(width=6, height=4, spp=2, max_bounces=2,
                      use_megakernel=megakernel)
    ids = np.arange(cfg.n_pixels)
    key = trng.prng_key(0)
    plain = trender.render(scene, cam, cfg, ids, key)
    calls = []
    monkeypatch.setattr(trng, "launch_start", _emulated_launch(calls))
    monkeypatch.setattr(trender, "sample_start", trender.kernel_start)
    got = trender.render(scene, cam, cfg, ids, key)
    rows = 4 if megakernel else 4 + cfg.max_bounces * n_bounce_draws(cfg)
    assert calls == [(4, rows)] * cfg.spp
    for a, b in zip(got[:3], plain[:3]):
        assert torch.equal(a.to_array(), b.to_array())

    leaves = [c.detach().clone().requires_grad_()
              for v in (cam.origin, cam.horizontal, cam.vertical,
                        cam.lower_left) for c in v]
    tcam = trender.unpack_camera(torch.stack(leaves))
    calls.clear()
    loss = _aov_loss(trender.render(scene, tcam, cfg, ids, key))
    g_kernel = torch.autograd.grad(loss, leaves)
    # the forward and the checkpoint's recompute, rows 0-3 written for the
    # camera's backward
    assert calls == [(0, rows)] * (2 * cfg.spp)
    monkeypatch.undo()
    loss = _aov_loss(trender.render(scene, tcam, cfg, ids, key))
    g_plain = torch.autograd.grad(loss, leaves)
    got, want = torch.stack(g_kernel).numpy(), torch.stack(g_plain).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    assert np.abs(got).max() > 0


def test_launch_start_refuses_before_building(monkeypatch):
    """The wrapper checks its inputs before any library is built."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    ids, key = torch.arange(8), trng.prng_key(0)
    cam = torch.zeros(12)
    for bad in (dict(cam=torch.zeros(11)), dict(cam=torch.zeros(12).double()),
                dict(pixel_ids=ids.int()), dict(key=key[:1]),
                dict(row0=2), dict(n_rows=3)):
        args = {**dict(key=key, pixel_ids=ids, cam=cam, sample_id=0, width=4,
                       height=2, aperture=(0.0, 0.0), focus=1.0, row0=4,
                       n_rows=4), **bad}
        with pytest.raises(ValueError):
            trng.launch_start(**args)


# ---- the sphere modes' table sum, emulated -----------------------------------

def _constant(name) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         REPLAY.read_text())[1])


def _groups(hit, bidx):
    """The warp's groups in the kernel's order: the lowest pending hit
    lane's winner, then its lanes (ballot)."""
    todo = [lane for lane in range(32) if hit[lane]]
    out = []
    while todo:
        win = bidx[todo[0]]
        grp = [lane for lane in todo if bidx[lane] == win]
        todo = [lane for lane in todo if bidx[lane] != win]
        out.append((win, grp))
    return out


def _table_sum_runs(wsum, hit, bidx, gw, rows, pitch):
    """``warp_table_sum``: the groups (``__match_any_sync``) in the order of
    their lowest lanes; each hit lane's column its group's first column
    (the exclusive scan of the leaders' sizes over the lanes) plus its rank
    in the group; then each (group, row) pair summed over its run."""
    key = [int(bidx[lane]) if hit[lane] else -1 for lane in range(32)]
    peers = [[j for j in range(32) if key[j] == key[lane]]
             for lane in range(32)]
    leads = [hit[lane] and peers[lane][0] == lane for lane in range(32)]
    sizes = [len(peers[lane]) if leads[lane] else 0 for lane in range(32)]
    first = np.cumsum(sizes) - np.array(sizes)    # exclusive scan
    stage = np.full((rows, pitch), np.nan, np.float32)
    table = []
    for lane in range(32):
        if hit[lane]:
            lead = peers[lane][0]
            col = first[lead] + peers[lane].index(lane)
            assert np.isnan(stage[0, col])
            stage[:, col] = gw[lane]
        if leads[lane]:
            table.append((key[lane], first[lane], sizes[lane]))
    assert [g[0] for g in table] == [g[0] for g in _groups(hit, bidx)]
    for p in range(len(table) * rows):
        win, start, n = table[p // rows]
        r = p % rows
        acc = np.float32(0.0)
        for t in range(start, start + n):
            acc = np.float32(acc + stage[r, t])
        wsum[win, r] = np.float32(wsum[win, r] + acc)


def _table_sum_walk(wsum, hit, bidx, gw, rows):
    """A walk over each group's lanes in lane order (a member found by its
    bit): the order the runs must reproduce."""
    for win, grp in _groups(hit, bidx):
        for r in range(rows):
            acc = np.float32(0.0)
            for lane in grp:
                acc = np.float32(acc + gw[lane][r])
            wsum[win, r] = np.float32(wsum[win, r] + acc)


@pytest.mark.parametrize("case", ["one_winner", "few_winners", "scattered"])
def test_warp_table_sum_emulated(case):
    """The sphere modes' table sum (runs of a group's adjacent columns) adds
    in the order of a walk over each group's lanes in lane order, bit for
    bit, and lands within float32 rounding of the exact sums over several
    bounces; the stage has a column for every lane, the warp's staging
    room for its rows and a group table of 3 words a lane."""
    rows, pitch = _constant("kRows"), _constant("kStagePitch")
    assert rows == 14 and pitch >= 32
    assert re.search(r"constexpr int kWarpStage = kRows \* kStagePitch \+ "
                     r"3 \* 32;", REPLAY.read_text())
    rs = np.random.default_rng({"one_winner": 1, "few_winners": 2,
                                "scattered": 3}[case])
    n_sph = 10
    runs = np.zeros((n_sph, rows), np.float32)
    walk = np.zeros((n_sph, rows), np.float32)
    want = np.zeros((n_sph, rows), np.float64)
    scale = np.zeros((n_sph, rows), np.float64)
    for _ in range(6):
        hit = rs.uniform(size=32) < 0.9
        if case == "one_winner":
            bidx = np.full(32, 4)
        elif case == "few_winners":
            bidx = rs.choice([1, 3, 4], size=32, p=[0.6, 0.3, 0.1])
        else:
            bidx = rs.integers(0, n_sph, 32)
        gw = rs.uniform(-1, 1, (32, rows)).astype(np.float32)
        _table_sum_runs(runs, hit, bidx, gw, rows, pitch)
        _table_sum_walk(walk, hit, bidx, gw, rows)
        for lane in np.flatnonzero(hit):
            want[bidx[lane]] += gw[lane]
            scale[bidx[lane]] += np.abs(gw[lane])
    np.testing.assert_array_equal(runs.view(np.uint32), walk.view(np.uint32))
    np.testing.assert_array_less(np.abs(runs - want), 1e-6 * scale + 1e-30)
