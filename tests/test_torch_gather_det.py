"""The scan path's winner gathers with a deterministic backward
(``raytpu_torch.kernels.gather``) against ``index_add_`` and raytpu.

``gather`` is the indexed load; its backward sums each row's cotangents
(``segment_sum``): the hand-written kernel ``csrc/segment_sum.cu`` on the
card, whose plain version, ``index_add_`` on the CPU, these tests run.
The checks: the plain backward equals ``index_add_`` bit for bit, and
``jax.vjp`` of raytpu's ``gather_channels`` (its one-hot / sorted
segment sums) to f32 rounding of the sums (1e-5 of each row's sum of
|g|, plus 1e-7); the stable sort each index is made with once
(``GatherIndex.sorted_plan``'s plain version) against numpy's; the
planes that take no gradient (ints, bools) pass through; out-of-range
indices in ``materials.texture._take`` read zero and take no gradient;
the scan path's autograd graph holds no ``index_select`` backward (an
``index_add_``) and one gather node an index; two backward runs through
the scan path are bit-identical on every float leaf; the kernel's order
of f32 additions, emulated in numpy (``segment_sum_schedule``), gives
each row's sum within 1e-6 of its sum of |g| from the exact sums, its
warp branch taken by the long rows (over several second-level blocks at
300,000 entries), and a dropped cross-warp carry shows; the plan's
kernel, ``csrc/index_sort.cu``, emulated in numpy
(``index_sort_schedule``: its radix passes and row offsets), equals
numpy's stable argsort and searchsorted from 1 to 2^23 rows, and a
reversed in-round rank shows. The scan path's gradients against
``jax.grad`` stay in ``tests/test_torch_scan_grad.py`` and
``tests/test_torch_grad.py``, unchanged.
"""

import re
from pathlib import Path

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


CSRC = Path(tg.__file__).resolve().parent.parent / "csrc"


def _constants(name):
    """The ``constexpr int`` constants of ``csrc/<name>.cu``, so the
    emulations below follow the kernels' tile sizes."""
    text = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}


def _scan_tiles(v, r, tile, carry=True):
    """numpy emulation of ``tile_sums``' order of f32 additions on (C, L)
    values keyed by r (L,): per block of ``tile`` entries and warp of 32,
    a five-round segmented shuffle scan, then the warps below a run that
    crosses them added in warp order. Each run's sum in the tile lands at
    its last entry. ``carry=False`` drops the cross-warp carry (a planted
    fault)."""
    c, n = v.shape
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    r = np.concatenate([r, -1 - np.arange(pad)])        # a pad: its own run
    v = np.concatenate([v, np.zeros((c, pad), np.float32)], 1)
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
    return out_v[:, :n]


def segment_sum_schedule(g, idx, n_rows, tile, heavy, carry=True):
    """numpy emulation of csrc/segment_sum.cu's order of f32 additions on
    (C, B) cotangents: ``tile_sums`` at level 0 over the sorted entries
    and at level 1 over the tiles' last entries (each tile's partial of
    the row that reaches its end), ``tile`` of them a block; then
    ``row_sums``: a row spanning at most ``heavy`` tiles adds its level-0
    partials in tile order; a longer one is the warp's: lane l adds the
    level-1 partials l, l + 32, ... of the row's run of tile ends in
    order, a butterfly of xor 16, 8, 4, 2, 1 joins the lanes, and the
    row's partial in its last tile comes last where that tile's end is
    another row's. ``carry=False`` drops the cross-warp carry (a planted
    fault)."""
    c, b = g.shape
    perm = np.argsort(idx, kind="stable")
    seg = idx[perm]
    off = np.searchsorted(seg, np.arange(n_rows + 1))
    part = _scan_tiles(g[:, perm], seg, tile, carry)
    n_tiles = -(-b // tile)
    ends = np.minimum((np.arange(n_tiles) + 1) * tile, b) - 1
    part1 = _scan_tiles(part[:, ends], seg[ends], tile, carry)
    out = np.zeros((c, n_rows), np.float32)
    for row in range(n_rows):
        a, e = off[row], off[row + 1]
        if e == a:
            continue
        t0, t1 = a // tile, (e - 1) // tile
        if t1 - t0 + 1 <= heavy:
            acc = np.zeros(c, np.float32)
            for t in range(t0, t1 + 1):
                acc = (acc + part[:, min(e, (t + 1) * tile) - 1]).astype(
                    np.float32)
        else:
            ends_tile = e == min((t1 + 1) * tile, b)
            last_t = t1 if ends_tile else t1 - 1
            lanes = np.zeros((32, c), np.float32)
            for j, u in enumerate(range(t0 // tile, last_t // tile + 1)):
                x = part1[:, min(last_t + 1, (u + 1) * tile) - 1]
                lanes[j % 32] = (lanes[j % 32] + x).astype(np.float32)
            for m in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ m]).astype(np.float32)
            acc = lanes[0]
            if not ends_tile:
                acc = (acc + part[:, e - 1]).astype(np.float32)
        out[:, row] = acc
    return out


def test_schedules_follow_the_kernels_constants():
    seg = _constants("segment_sum")
    assert (seg["kTile"], seg["kHeavy"]) == (256, 8)
    srt = _constants("index_sort")
    assert (srt["kThreads"] * srt["kItems"], 32 * srt["kItems"],
            srt["kMaxBits"], srt["kRowChunk"], srt["kStage"]) == (
                SORT_TILE, SORT_SPAN, SORT_BITS, ROW_CHUNK, STAGE)


@pytest.mark.parametrize("tile,heavy", [(256, 8), (64, 2)])
@pytest.mark.parametrize("shape", SHAPES + [(4, 30000, 5, 0.9),
                                            (2, 300000, 3, 0.99)],
                         ids=lambda s: f"{s[0]}x{s[1]}:{s[2]}")
def test_segment_sum_schedule_is_exact_to_rounding(shape, tile, heavy):
    """The kernel's order of additions (emulated) gives each row's sum
    within 1e-6 of its sum of |g| from the exact (float64) sums, on rows
    spanning many tiles (and, at 300,000 entries, more tiles than one
    level-1 block takes) and runs crossing warps; without the cross-warp
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
    span = ((e - 1) // tile - a // tile + 1).max()
    if share * b / 3 > (heavy + 2) * tile:   # the warp's branch ran
        assert span > heavy
    if share * b / 3 > (tile + 2) * tile:    # over several level-1 blocks
        assert span > tile
    crossing = segment_sum_schedule(g, idx, n, tile, heavy, carry=False)
    if b > 32 and n < b // 32:   # runs cross warps: the fault shows
        assert (np.abs(crossing - exact) / (scale + 1e-30)).max() > 1e-3


# csrc/index_sort.cu's sizes (test_schedules_follow_the_kernels_constants)
SORT_TILE, SORT_SPAN, SORT_BITS, ROW_CHUNK, STAGE = 4096, 512, 8, 1024, 4096


def radix_widths(n_rows):
    """The key bits of each radix pass, lowest first: ceil(log2 n_rows)
    bits in passes of at most SORT_BITS, as even as possible."""
    bits = max(0, int(n_rows - 1).bit_length())
    passes = 1 if bits == 0 else -(-bits // SORT_BITS)
    return [bits // passes + (i < bits % passes) for i in range(passes)]


def _radix_pass(keys, vals, shift, width, unstable=False):
    """One pass of the kernel (numpy): each block of SORT_TILE entries
    counts its digits; (digit, block) bases by an exclusive scan in that
    order; inside a block each warp of SORT_SPAN consecutive entries
    ranks them 32 a round, a lane after the lower lanes of its round
    with its digit (``unstable``: the higher ones, a planted fault) and
    the warp's earlier rounds, then the warps below. Returns the keys
    and values scattered to their ranks."""
    n, nd = keys.shape[0], 1 << width
    d = (keys >> shift) & (nd - 1)
    n_blocks = -(-n // SORT_TILE)
    valid = np.arange(n_blocks * SORT_TILE) < n
    dp = np.concatenate([d, np.zeros(n_blocks * SORT_TILE - n, d.dtype)])
    blk = np.arange(dp.shape[0]) // SORT_TILE
    counts = np.zeros((nd, n_blocks), np.int64)
    np.add.at(counts, (dp[valid], blk[valid]), 1)
    flat = counts.ravel()
    base = (np.cumsum(flat) - flat).reshape(nd, n_blocks)
    # (block, warp, round, lane)
    shape = (n_blocks, SORT_TILE // SORT_SPAN, SORT_SPAN // 32, 32)
    w, ok = dp.reshape(shape), valid.reshape(shape)
    same = (w[..., :, None] == w[..., None, :]) & ok[..., None, :]
    lanes = np.arange(32)
    if unstable:
        in_round = (same & (lanes[None, :] > lanes[:, None])).sum(-1)
    else:
        in_round = (same & (lanes[None, :] < lanes[:, None])).sum(-1)
    per_round = np.zeros(shape[:3] + (nd,), np.int64)
    idx3 = np.indices(shape)
    np.add.at(per_round, (idx3[0][ok], idx3[1][ok], idx3[2][ok], w[ok]), 1)
    before_rounds = np.cumsum(per_round, 2) - per_round
    per_warp = per_round.sum(2)
    before_warps = np.cumsum(per_warp, 1) - per_warp
    dest = (np.take_along_axis(before_rounds, w, -1) + in_round
            + np.take_along_axis(np.broadcast_to(
                before_warps[:, :, None, :], shape[:3] + (nd,)), w, -1)
            + np.take_along_axis(np.broadcast_to(
                base.T[:, None, None, :], shape[:3] + (nd,)), w, -1))
    dest = dest.ravel()[:n]
    assert np.array_equal(np.sort(dest), np.arange(n))
    k_out, v_out = np.empty_like(keys), np.empty_like(vals)
    k_out[dest], v_out[dest] = keys, vals
    return k_out, v_out


def _warp_lower_bound(seg, keys):
    """The kernel's 32-ary search (numpy, every query at once): the first
    j with seg[j] >= key, len(seg) if none."""
    n = seg.shape[0]
    lo, hi = np.zeros(keys.shape, np.int64), np.full(keys.shape, n)
    lanes = np.arange(32)
    while True:
        go = hi - lo > 32
        if not go.any():
            break
        step = (hi - lo + 31) // 32
        j = lo[:, None] + lanes * step[:, None]
        k = ((j < hi[:, None]) & (seg[np.minimum(j, n - 1)] < keys[:, None])
             ).sum(1)
        new_lo = np.where(k == 0, lo, lo + (k - 1) * step + 1)
        new_hi = np.where(k == 0, lo, np.minimum(hi, lo + k * step))
        lo, hi = np.where(go, new_lo, lo), np.where(go, new_hi, hi)
    j = lo[:, None] + lanes
    if n == 0:
        return lo
    return lo + ((j < hi[:, None]) & (seg[np.minimum(j, n - 1)]
                                      < keys[:, None])).sum(1)


def index_sort_schedule(idx, n_rows, unstable=False):
    """numpy emulation of csrc/index_sort.cu: the radix passes over
    ``radix_widths(n_rows)`` (the first reading the index, its positions
    the values), then the offsets: each chunk of ROW_CHUNK rows' first
    sorted entry by the 32-ary search, each row's first entry searched
    only inside its chunk's entries (staged where there are at most STAGE
    of them). Returns (perm, seg, off)."""
    keys, vals = idx.astype(np.int64), np.arange(idx.shape[0])
    shift = 0
    for width in radix_widths(n_rows):
        keys, vals = _radix_pass(keys, vals, shift, width, unstable)
        shift += width
    n_chunks = -(-(n_rows + 1) // ROW_CHUNK)
    chunk_lo = _warp_lower_bound(keys, np.arange(n_chunks + 1) * ROW_CHUNK)
    rows = np.arange(n_rows + 1)
    c = rows // ROW_CHUNK
    off = np.clip(np.searchsorted(keys, rows), chunk_lo[c], chunk_lo[c + 1])
    return vals, keys, off


@pytest.mark.parametrize("n_rows,b", [(1, 9000), (11, 20000), (4096, 20000),
                                      (2 ** 23, 12000)])
def test_index_sort_schedule_is_the_stable_sort(n_rows, b):
    """The kernel's radix passes and offsets (emulated) give numpy's
    stable argsort and searchsorted, at the tables' row counts (a
    material table, the 4,096-triangle world, a 4096x2048 sky), with a
    few rows taking most entries; a rank that puts equal digits of a
    round in reverse lane order is not the stable sort (the check sees
    that fault; in one pass it still sorts the keys, over several the
    later passes lose the earlier digits' order)."""
    assert radix_widths(n_rows) == {1: [0], 11: [4], 4096: [6, 6],
                                    2 ** 23: [8, 8, 7]}[n_rows]
    rs = np.random.default_rng(n_rows)
    idx = np.where(rs.random(b) < 0.6, rs.integers(0, min(n_rows, 3), b),
                   rs.integers(0, n_rows, b))
    order = np.argsort(idx, kind="stable")
    want = (order, idx[order], np.searchsorted(idx[order],
                                               np.arange(n_rows + 1)))
    got = index_sort_schedule(idx, n_rows)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    plain = tg.sorted_plan_reference(torch.tensor(idx), n_rows)
    for x, y in zip(plain, want):
        assert np.array_equal(x.numpy(), y)
    perm, seg, off = index_sort_schedule(idx, n_rows, unstable=True)
    assert not np.array_equal(perm, want[0])
    if len(radix_widths(n_rows)) == 1:   # one pass: the keys still sort
        assert np.array_equal(seg, want[1]) and np.array_equal(off, want[2])


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
        calls.append(len(g))     # channels: (C, B) or C (B,) tensors
        return plain(g, index)

    tg.segment_sum = count
    try:
        loss.backward()
    finally:
        tg.segment_sum = plain
    # one call an index: the sphere channels that take a cotangent (13 of
    # 14 on Cornell: alpha only meets compares) at once, or the triangle
    # channels (18 of the 24 float ones here)
    assert max(calls) == (13 if name == "cornell" else 18)
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
