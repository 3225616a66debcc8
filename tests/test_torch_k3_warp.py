"""The per-triangle search's warp schedule (``csrc/trace_scene.cu``:
``warp_search``) emulated in torch, bit-equal to the plain version's
``_closest_triangle``.

The kernel's warp takes 32 consecutive rays. For each chunk in index
order it takes the ballot of the lanes whose line enters the chunk's box
before their running best. At ``coop_min`` lanes or more, each of them
folds the chunk's triangles in order (the plain version's sequential
strict fold); below it, lane j holds triangle 32c + j, every lane tests
it against each ballot lane's ray in lane order, a 5-round butterfly of
(t, index) minima gives the chunk's first least t, and that lane folds it
in with the strict t < best. The emulation does the same with tensors,
the butterfly included, on the rays every bounce of the plain version's
trace meets (``trace_scene_reference`` with ``_closest_triangle``
wrapped), and on rays made to hit the NaN slab: an origin on a chunk
box's plane with a zero direction component. ``coop_min`` runs at 1
(no chunk searched together: the union of the lanes' chunks, as the
kernel issued it before its warp search), 16 (the kernel's), 20 and 33
(every chunk together). The
emulation's issue counts match the plain version's new ``counts``.
Imports no JAX: the plain version is held against ``raytpu`` in
``tests/test_torch_trace_scene.py``.
"""

import numpy as np
import pytest
import torch

from raytpu_torch.config import load_scene_file
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.path import n_bounce_draws
from raytpu_torch.integrator.render import sample_rays
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.scenes import mesh_branch_scene, write_block_world

COOP_MINS = (1, tts.COOP_MIN, 20, 33)


def warp_schedule(tb, k, o, d, active, best, bidx, coop_min, counts):
    """The kernel's warp search over ``tb``'s chunks from (best, bidx);
    ``counts`` gets its issue in lane slots: ``union`` (the chunks any of
    a warp's lanes enters, 32 lanes times the chunk's triangles each),
    ``loop`` (those that ``coop_min`` lanes or more enter) and ``coop``
    ((ray, chunk) entries searched together)."""
    n = best.shape[0]
    inv = [1.0 / c for c in d]
    lanes = torch.arange(tts.WARP)
    for c, lo, hi in tts._chunks(k):
        hit_box, tmin = tts._slab(tb.boxes, c, *o, *inv)
        enter = hit_box & active & (tmin < best)
        pc = tts.warp_entries(enter)
        counts["union"] += int((pc > 0).sum()) * tts.WARP * (hi - lo)
        counts["loop"] += int((pc >= coop_min).sum()) * tts.WARP * (hi - lo)
        counts["coop"] += int(pc[pc < coop_min].sum())
        many = pc.repeat_interleave(tts.WARP)[:n] >= coop_min
        if not bool(enter.any()):
            continue
        dist, _ = tts._triangle_hits(tb.tri, lo, hi, o, d, k)      # (B, L)
        loop = enter & many
        for j in range(hi - lo):          # each lane on its own, in order
            better = loop & (dist[:, j] < best)
            best = torch.where(better, dist[:, j], best)
            bidx = torch.where(better, k.n_spheres + lo + j, bidx)
        coop = enter & ~many
        if not bool(coop.any()):
            continue
        # lane j's triangle lo + j, BIG past the chunk's end
        dv = torch.full((int(coop.sum()), tts.WARP), tts.BIG)
        dv[:, :hi - lo] = dist[coop]
        tv = (lo + lanes).expand_as(dv).clone()
        for off in (16, 8, 4, 2, 1):
            d2, t2 = dv[:, lanes ^ off], tv[:, lanes ^ off]
            take = (d2 < dv) | ((d2 == dv) & (t2 < tv))
            dv, tv = torch.where(take, d2, dv), torch.where(take, t2, tv)
        assert (dv == dv[:, :1]).all() and (tv == tv[:, :1]).all()
        better = torch.zeros_like(coop)
        better[coop] = dv[:, 0] < best[coop]
        best = best.clone()
        bidx = bidx.clone()
        best[better] = dv[:, 0][better[coop]]
        bidx[better] = (k.n_spheres + tv[:, 0][better[coop]]).to(bidx.dtype)
    return best, bidx


def _scenes(root):
    world600 = write_block_world(str(root / "w600"), n_triangles=600, seed=0)
    world60 = write_block_world(str(root / "w60"), n_triangles=60, seed=3)
    per_tri = lambda path, **over: (lambda s, c, g: (s, c, g.replace(
        merge_quads=False, **over)))(*load_scene_file(path, "cpu"))
    return {
        "block world 600 6b": per_tri(world600, max_bounces=6),
        "block world 60 ao_samples=2": per_tri(world60, max_bounces=4,
                                              use_ao=True, ao_samples=2),
        "branches 4 tris 5b": (lambda s, c, g: (s, c, g.replace(
            max_bounces=5)))(*mesh_branch_scene("cpu")),
    }


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return _scenes(tmp_path_factory.mktemp("k3warp"))


def _trace(scene, cam, cfg, seed):
    """The plain version's trace of 64x48 camera rays from a numpy seed,
    with every bounce's triangle search held against the emulation at each
    COOP_MINS value. Returns the plain version's counts and the
    emulations'."""
    cfg = cfg.replace(width=64, height=48)
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = sample_rays(cam, cfg, torch.arange(b),
                       torch.tensor(rs.random((4, b), np.float32)))
    nd = n_bounce_draws(cfg)
    draws = torch.tensor(rs.random((cfg.max_bounces * nd, b), np.float32))
    k = tts.MeshKnobs.for_scene(cfg, scene, nd)
    assert k.plan is None
    tb = tts.pack_scene(scene, k)
    emulated = {m: {"union": 0, "loop": 0, "coop": 0, "calls": 0}
                for m in COOP_MINS}
    plain = tts._closest_triangle

    def both(tb_, k_, o_, d_, active, best, bidx, counts):
        want = plain(tb_, k_, o_, d_, active, best, bidx, counts)
        for m, em in emulated.items():
            got = warp_schedule(tb_, k_, o_, d_, active, best, bidx, m, em)
            assert torch.equal(got[0], want[0]), f"coop_min {m}: best"
            assert torch.equal(got[1], want[1]), f"coop_min {m}: bidx"
            em["calls"] += 1
        return want

    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    tts._closest_triangle = both
    try:
        tts.trace_scene_reference(tb, *o, *d, draws, k, counts)
    finally:
        tts._closest_triangle = plain
    return counts, emulated


@pytest.mark.parametrize("name", ["block world 600 6b",
                                  "block world 60 ao_samples=2",
                                  "branches 4 tris 5b"])
def test_warp_schedule_bit_equal_to_plain(scenes, name):
    scene, cam, cfg = scenes[name]
    counts, emulated = _trace(scene, cam, cfg, seed=len(name))
    for m, em in emulated.items():
        assert em["calls"] >= 3, f"coop_min {m}: bounces searched"
        # the union a warp issues is what the plain version counts
        assert em["union"] == counts["tri_issued"] >= counts["tri"] > 0
    # 1: every chunk scanned lane by lane; 33: every chunk together
    assert emulated[1]["coop"] == 0 and emulated[33]["loop"] == 0
    assert emulated[1]["loop"] == counts["tri_issued"]
    at = emulated[tts.COOP_MIN]
    assert (at["loop"], at["coop"]) == (counts["tri_loop"], counts["coop"])
    if name.startswith("block world 600"):
        # the rays of later bounces spread: warps issue more than they need,
        # and both branches run
        assert counts["tri_issued"] > 1.5 * counts["tri"]
        assert at["loop"] > 0 and at["coop"] > 0


@pytest.mark.parametrize("coop_min", COOP_MINS)
def test_warp_schedule_nan_slab(scenes, coop_min):
    """Rays whose origin lies on a chunk box's plane with that direction
    component zero: the slab product is 0 * inf = NaN, which the plain
    version's torch.minimum / maximum (and the kernel's nan_min /
    nan_max) carry into a skipped chunk on that lane alone."""
    scene, _, cfg = scenes["block world 60 ao_samples=2"]
    k = tts.MeshKnobs.for_scene(cfg, scene, n_bounce_draws(cfg))
    tb = tts.pack_scene(scene, k)
    rs = np.random.default_rng(11)
    b = 96
    c = torch.tensor(rs.integers(0, k.n_chunks, b))
    axis = torch.tensor(rs.integers(0, 3, b))
    lo, hi = tb.boxes[:3, c], tb.boxes[3:, c]
    mid = 0.5 * (lo + hi)
    # on the box's lower or upper plane along `axis`, mid-box elsewhere
    plane = torch.where(torch.tensor(rs.random(b) < 0.5), lo, hi)
    sel = torch.nn.functional.one_hot(axis, 3).T.bool()
    origin = torch.where(sel, plane, mid)
    direction = torch.tensor(rs.normal(size=(3, b)).astype(np.float32))
    direction = torch.where(sel, 0.0, direction)
    # every other ray a plain ray through the same box, so warps mix
    plain_ray = torch.arange(b) % 2 == 1
    origin = torch.where(plain_ray, mid - 5.0 * direction, origin)
    direction = torch.where(plain_ray & sel, 0.3, direction)
    o, d = Vec3(*origin), Vec3(*direction)
    inv = [1.0 / v for v in d]
    tmin = torch.stack([tts._slab(tb.boxes, j, *o, *inv)[1]
                        for j in range(k.n_chunks)])
    assert bool(tmin.isnan().any())
    active = torch.ones(b, dtype=torch.bool)
    best = torch.full((b,), tts.BIG)
    bidx = torch.full((b,), -1, dtype=torch.int32)
    counts = {"tri": 0}
    want = tts._closest_triangle(tb, k, o, d, active, best, bidx, counts)
    em = {"union": 0, "loop": 0, "coop": 0}
    got = warp_schedule(tb, k, o, d, active, best, bidx, coop_min, em)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1] >= 0).any())
    assert em["union"] == counts["tri_issued"]


def test_search_counts_unchanged_by_issue_counters(scenes):
    """The new counters leave the result and the existing counts as they
    were, and the issue counters add up: every issued chunk is scanned
    lane by lane or together."""
    scene, cam, cfg = scenes["block world 600 6b"]
    cfg = cfg.replace(width=32, height=24)
    rs = np.random.default_rng(5)
    b = cfg.n_pixels
    o, d = sample_rays(cam, cfg, torch.arange(b),
                       torch.tensor(rs.random((4, b), np.float32)))
    nd = n_bounce_draws(cfg)
    draws = torch.tensor(rs.random((cfg.max_bounces * nd, b), np.float32))
    k = tts.MeshKnobs.for_scene(cfg, scene, nd)
    tb = tts.pack_scene(scene, k)
    counts = {"live": 0, "sphere": 0, "slab": 0, "tri": 0}
    got = tts.trace_scene_reference(tb, *o, *d, draws, k, counts)
    assert torch.equal(got, tts.trace_scene_reference(tb, *o, *d, draws, k))
    assert counts["tri_loop"] <= counts["tri_issued"]
    assert 0 < counts["coop"] <= counts["tri"]
