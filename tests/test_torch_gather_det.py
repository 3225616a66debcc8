"""The scan path's winner gathers with a deterministic backward
(``raytpu_torch.kernels.gather``) against ``index_add_`` and raytpu.

``gather`` is the indexed load; its backward sums each row's cotangents
(``segment_sum``): the hand-written kernel ``csrc/segment_sum.cu`` on the
card, whose plain version, ``index_add_`` on the CPU, these tests run.
The checks: the plain backward equals ``index_add_`` bit for bit, and
``jax.vjp`` of raytpu's ``gather_channels`` (its one-hot / sorted
segment sums) to f32 rounding of the sums (1e-5 of each row's sum of
|g|, plus 1e-7); the stable sort each index is made with once
(``GatherIndex.sorted_plan``) against numpy's; the planes that take no
gradient (ints, bools) pass through; out-of-range indices in
``materials.texture._take`` read zero and take no gradient; the scan
path's autograd graph holds no ``index_select`` backward (an
``index_add_``) and one gather node an index; two backward runs through
the scan path are bit-identical on every float leaf; the kernel's order
of f32 additions, emulated in numpy (``segment_sum_schedule``), gives
each row's sum within 1e-6 of its sum of |g| from the exact sums, its
warp branch taken by the long rows, and a dropped cross-warp carry shows.
The scan path's
gradients against ``jax.grad`` stay in ``tests/test_torch_scan_grad.py``
and ``tests/test_torch_grad.py``, unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.gather import gather_channels
from raytpu_torch import config as tconfig
from raytpu_torch.core import rng
from raytpu_torch.integrator import render as trender
from raytpu_torch.integrator.path import trace
from raytpu_torch.kernels import gather as tg
from raytpu_torch.materials import texture
from raytpu_torch.scenes import cornell_box, write_block_world
from raytpu_torch.train import combine_scene, partition_scene

SUM_RTOL, SUM_ATOL = 1e-5, 1e-7

# (channels, entries, rows, share of entries on the first 3 rows): a few
# rows a million rays hit, as spheres and materials are, and many light
# ones, as triangles and texels are; rows no entry takes
SHAPES = [(14, 4000, 11, 0.9), (25, 5000, 600, 0.5), (3, 3000, 65536, 0.0),
          (1, 1, 1, 0.0), (2, 700, 300, 0.3)]


def _case(c, b, n, heavy, seed):
    rs = np.random.default_rng(seed)
    idx = np.where(rs.random(b) < heavy, rs.integers(0, min(n, 3), b),
                   rs.integers(0, n, b))
    planes = rs.normal(size=(c, n)).astype(np.float32)
    g = rs.normal(size=(c, b)).astype(np.float32)
    return idx, planes, g


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}:{s[2]}")
def test_plain_backward_is_index_add(shape):
    idx, planes, g = _case(*shape, seed=shape[1])
    index = tg.GatherIndex(torch.tensor(idx), shape[2])
    leaves = [torch.tensor(p, requires_grad=True) for p in planes]
    out = tg.gather(index, leaves)
    for o, p in zip(out, leaves):
        assert torch.equal(o, p.detach()[index.idx])
    torch.autograd.backward(out, [torch.tensor(x) for x in g])
    for p, gc in zip(leaves, g):
        want = torch.zeros(shape[2]).index_add_(0, index.idx, torch.tensor(gc))
        assert torch.equal(p.grad, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}:{s[2]}")
def test_backward_matches_raytpu_gather_vjp(shape):
    idx, planes, g = _case(*shape, seed=7 + shape[1])
    _, vjp = jax.vjp(lambda *t: gather_channels(list(t), jnp.asarray(idx)),
                     *(jnp.asarray(p) for p in planes))
    want = np.stack([np.asarray(x) for x in vjp([jnp.asarray(x) for x in g])])
    index = tg.GatherIndex(torch.tensor(idx), shape[2])
    got = tg.segment_sum(torch.tensor(g), index).numpy()
    scale = np.zeros_like(want)
    for j in range(shape[0]):
        np.add.at(scale[j], idx, np.abs(g[j]))
    assert np.all(np.abs(got - want) <= SUM_RTOL * scale + SUM_ATOL)


def segment_sum_schedule(g, idx, n_rows, tile, heavy, carry=True):
    """numpy emulation of csrc/segment_sum.cu's order of f32 additions on
    (C, B) cotangents: ``tile_sums`` (per block of ``tile`` sorted
    entries and warp of 32, a five-round segmented shuffle scan, then the
    warps below a run that crosses them added in warp order; each run's
    sum at its last entry) and ``row_sums`` (a row spanning at most
    ``heavy`` tiles adds its runs in tile order; a longer one is the
    warp's: lane l adds tiles l, l + 32, ... in order, then a butterfly of
    xor 16, 8, 4, 2, 1). ``carry=False`` drops the cross-warp carry (a
    planted fault)."""
    c, b = g.shape
    perm = np.argsort(idx, kind="stable")
    seg = idx[perm]
    off = np.searchsorted(seg, np.arange(n_rows + 1))
    n_tiles = -(-b // tile)
    pad = n_tiles * tile - b
    r = np.concatenate([seg, -1 - np.arange(pad)])      # a pad: its own run
    v = np.concatenate([g[:, perm], np.zeros((c, pad), np.float32)], 1)
    lane = np.arange(tile) % 32
    pos = np.arange(n_tiles * tile)
    w = r.reshape(-1, 32)
    head = np.ones_like(w, bool)
    head[:, 1:] = w[:, 1:] != w[:, :-1]
    run0 = np.maximum.accumulate(np.where(head, np.arange(32), 0), 1).ravel()
    v = v.reshape(c, -1, 32).copy()
    for s in (1, 2, 4, 8, 16):
        up = np.zeros_like(v)
        up[..., s:] = v[..., :-s]
        take = (np.arange(32) - s >= run0.reshape(-1, 32))
        v = np.where(take, (v + up).astype(np.float32), v)
    v = v.reshape(c, -1)
    tails = v[:, 31::32].reshape(c, n_tiles, tile // 32)
    first, last = w[:, 0].reshape(n_tiles, -1), w[:, 31].reshape(n_tiles, -1)
    out_v = v.copy()
    for p in np.flatnonzero((run0 == 0) & (pos % tile >= 32)):
        t, wi = p // tile, (p % tile) // 32
        if last[t, wi - 1] != r[p]:
            continue
        below = 1
        while (wi - below > 0 and first[t, wi - below] == r[p]
               and last[t, wi - below - 1] == r[p]):
            below += 1
        acc = tails[:, t, wi - below].copy()
        for x in range(wi - below + 1, wi):
            acc = (acc + tails[:, t, x]).astype(np.float32)
        if carry:
            out_v[:, p] = (acc + v[:, p]).astype(np.float32)
    # the runs' sums at their last entries in the tile
    part = out_v[:, :b]
    out = np.zeros((c, n_rows), np.float32)
    for row in range(n_rows):
        a, e = off[row], off[row + 1]
        if e == a:
            continue
        t0, t1 = a // tile, (e - 1) // tile
        ends = [min(e, (t + 1) * tile) - 1 for t in range(t0, t1 + 1)]
        if t1 - t0 + 1 <= heavy:
            acc = np.zeros(c, np.float32)
            for x in ends:
                acc = (acc + part[:, x]).astype(np.float32)
        else:
            lanes = np.zeros((32, c), np.float32)
            for j, x in enumerate(ends):
                lanes[j % 32] = (lanes[j % 32] + part[:, x]).astype(np.float32)
            for m in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ m]).astype(np.float32)
            acc = lanes[0]
        out[:, row] = acc
    return out


@pytest.mark.parametrize("tile,heavy", [(256, 8), (64, 2)])
@pytest.mark.parametrize("shape", SHAPES + [(4, 30000, 5, 0.9)],
                         ids=lambda s: f"{s[0]}x{s[1]}:{s[2]}")
def test_segment_sum_schedule_is_exact_to_rounding(shape, tile, heavy):
    """The kernel's order of additions (emulated) gives each row's sum
    within 1e-6 of its sum of |g| from the exact (float64) sums, on rows
    spanning many tiles and runs crossing warps; without the cross-warp
    carry it does not (the check sees that fault)."""
    c, b, n, share = shape
    idx, _, g = _case(c, b, n, share, 5)
    exact = np.zeros((c, n))
    scale = np.zeros((c, n))
    np.add.at(exact.T, idx, g.T.astype(np.float64))
    np.add.at(scale.T, idx, np.abs(g.T.astype(np.float64)))
    got = segment_sum_schedule(g, idx, n, tile, heavy)
    worst = (np.abs(got - exact) / (scale + 1e-30)).max()
    assert worst <= 1e-6, worst
    off = np.searchsorted(np.sort(idx), np.arange(n + 1))
    a, e = off[:-1][off[1:] > off[:-1]], off[1:][off[1:] > off[:-1]]
    if share * b / 3 > (heavy + 2) * tile:   # the warp's branch ran
        assert ((e - 1) // tile - a // tile + 1).max() > heavy
    crossing = segment_sum_schedule(g, idx, n, tile, heavy, carry=False)
    if b > 32 and n < b // 32:   # runs cross warps: the fault shows
        assert (np.abs(crossing - exact) / (scale + 1e-30)).max() > 1e-3


def test_sorted_plan_is_the_stable_sort():
    idx, _, _ = _case(1, 5000, 300, 0.5, seed=3)
    perm, seg, off = tg.GatherIndex(torch.tensor(idx), 300).sorted_plan()
    order = np.argsort(idx, kind="stable")
    assert np.array_equal(perm.numpy(), order)
    assert np.array_equal(seg.numpy(), idx[order])
    assert np.array_equal(off.numpy(), np.searchsorted(idx[order],
                                                       np.arange(301)))
    assert perm.dtype == seg.dtype == off.dtype == torch.int32
    index = tg.GatherIndex(torch.tensor(idx), 300)
    assert index.sorted_plan() is index.sorted_plan()   # made once


def test_integer_and_bool_planes_pass_through():
    idx = torch.tensor([2, 0, 2, 1])
    f = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    i = torch.tensor([7, 8, 9], dtype=torch.int32)
    m = torch.tensor([True, False, True])
    out_f, out_i, out_m = tg.gather(tg.GatherIndex(idx, 3), (f, i, m))
    assert out_i.tolist() == [9, 7, 9, 8] and out_m.tolist() == [True] * 2 + [
        True, False]
    assert not out_i.requires_grad and not out_m.requires_grad
    (out_f * torch.tensor([1.0, 10.0, 100.0, 1000.0])).sum().backward()
    assert f.grad.tolist() == [10.0, 1000.0, 101.0]
    with pytest.raises(ValueError):
        tg.gather(tg.GatherIndex(idx, 4), (f,))


def test_take_out_of_range_reads_zero_without_gradient():
    plane = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    flags = torch.tensor([True, True, False])
    idx = torch.tensor([-1, 0, 3, 2, 2])
    got, flag = texture._take((plane, flags), idx)
    assert got.tolist() == [0.0, 1.0, 0.0, 3.0, 3.0]
    assert flag.tolist() == [False, True, False, False, False]
    got.sum().backward()
    assert plane.grad.tolist() == [1.0, 0.0, 2.0]


def _scan_grads(scene, cam, cfg, seed):
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in
              params.items()}
    sums = trender.render(combine_scene(params, static), cam, cfg,
                          torch.arange(cfg.n_pixels), rng.prng_key(seed))
    loss = ((sums.radiance.to_array() / cfg.spp - 0.2) ** 2).mean() + (
        (sums.normal.to_array() / cfg.spp) ** 2).mean()
    return loss, params


def _graph_names(loss):
    seen, todo, names = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    return names


@pytest.fixture(scope="module")
def scan_scenes(tmp_path_factory):
    world = write_block_world(str(tmp_path_factory.mktemp("gd")),
                              n_triangles=60, seed=3)
    ws, wc, wcfg = tconfig.load_scene_file(world, "cpu")
    cs, cc, ccfg = cornell_box("cpu")
    small = dict(width=6, height=4, spp=1, max_bounces=3,
                 use_megakernel=False)
    return {"cornell": (cs, cc, ccfg.replace(**small)),
            "block world 60 bilinear": (ws, wc, wcfg.replace(
                bilinear_textures=True, **small))}


@pytest.mark.parametrize("name", ["cornell", "block world 60 bilinear"])
def test_scan_path_gathers_have_no_index_add(scan_scenes, name):
    scene, cam, cfg = scan_scenes[name]
    loss, _ = _scan_grads(scene, cam, cfg, 0)
    calls = []
    plain = tg.segment_sum

    def count(g, index):
        calls.append(tuple(g.shape))
        return plain(g, index)

    tg.segment_sum = count
    try:
        loss.backward()
    finally:
        tg.segment_sum = plain
    # one call an index: the sphere channels that take a cotangent (13 of
    # 14 on Cornell: alpha only meets compares) at once, or the triangle
    # channels (18 of the 24 float ones here)
    assert max(c[0] for c in calls) == (13 if name == "cornell" else 18)
    # the scan path's graph (render checkpoints it): no index_select
    # backward
    params, static = partition_scene(scene)
    params = {n: p.detach().clone().requires_grad_() for n, p in
              params.items()}
    o, d = trender.sample_rays(cam, cfg, torch.arange(cfg.n_pixels),
                               torch.full((4, cfg.n_pixels), 0.5))
    draws = torch.full((cfg.max_bounces, 3, cfg.n_pixels), 0.25)
    out = trace(combine_scene(params, static), cfg, o, d, draws)
    names = _graph_names(out[0].x.sum() + out[2].x.sum())
    assert "_GatherBackward" in names
    assert not any(n.startswith("IndexSelectBackward") for n in names)


@pytest.mark.parametrize("name", ["cornell", "block world 60 bilinear"])
def test_scan_backward_twice_bit_identical(scan_scenes, name):
    scene, cam, cfg = scan_scenes[name]
    first = None
    for _ in range(2):
        loss, params = _scan_grads(scene, cam, cfg, 3)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if first is None:
            first = grads
            continue
        for n, g in grads.items():
            assert (g is None) == (first[n] is None), n
            assert g is None or torch.equal(g, first[n]), n
    assert any(g is not None and float(g.abs().sum()) > 0
               for g in first.values())
