"""The plane-order walk of K3's merged search and K4's culled count.

K3's kernel walks each axis-aligned group's sub-lists (rects with m = 0,
rects with m = 1, unpaired triangles) in the order of ``walk_tables``:
sorted by plane offset, so a ray's numerator rises along them, from the
first plane past tri_eps to the first valid candidate's plane.
``trace_scene._aa_walk`` emulates that walk in torch and returns its
winner; it must equal the table-order fold of the plain version
(``_aa_groups``, which ``_closest_merged`` runs) bit for bit: the running
numerator, denominator and winner after the groups, and the whole merged
search's distance and winner. Checked on ``write_quad_fixture`` and the
600- and 2048-triangle block worlds (loaded by default: merge_quads on),
for camera rays and the bounce rays the scan path sends from them, and on
hand-built tables with planted ties: coplanar overlapping rects, and two
offsets one ulp apart whose numerators round to one value, where the
table-order scan keeps the earlier column.

K4's plain version counts the triangle tests of the kernel's cull at ray
granularity: the chunks each ray enters before its running best, in
index order.
"""

import types

import numpy as np
import pytest
import torch

from raytpu_torch import config as tconfig
from raytpu_torch.geometry import triangle as ttri
from raytpu_torch.integrator import path as tpath
from raytpu_torch.integrator.render import n_bounce_draws, sample_rays
from raytpu_torch.kernels import intersect as tint
from raytpu_torch.kernels import trace_scene as tsc
from raytpu_torch.scenes import write_block_world, write_quad_fixture

WIDTH, HEIGHT = 48, 36


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("walk")
    paths = {"fixture": write_quad_fixture(str(d / "fixture"))}
    for n in (600, 2048):
        paths[n] = write_block_world(str(d / str(n)), n_triangles=n, seed=0)
    out = {}
    for name, p in paths.items():
        scene, cam, cfg = tconfig.load_scene_file(p, device="cpu")
        cfg = cfg.replace(width=WIDTH, height=HEIGHT, max_bounces=4)
        k = tsc.MeshKnobs.for_scene(cfg, scene, n_bounce_draws(cfg))
        assert k.plan is not None, f"{name}: no quad plan by default"
        out[name] = (scene, cam, cfg, k, tsc.pack_scene(scene, k))
    return out


def _sub_lists(layout):
    """(table, first column, end) of every sub-list in table order."""
    r = t = 0
    for _, _, ca, cb, ct in layout:
        yield "aa", r, r + ca
        yield "aa", r + ca, r + ca + cb
        yield "aa3", t, t + ct
        r, t = r + ca + cb, t + ct


@pytest.mark.parametrize("name", ["fixture", 600, 2048])
def test_walk_tables_sort_each_sub_list_by_offset(scenes, name):
    """Each sub-list of the walk tables is a stable permutation of
    ``pack_aa``'s columns in that sub-list, sorted by plane offset
    descending; the last row names the original column."""
    *_, k, tb = scenes[name]
    walks = {"aa": (tb.aa, tb.aa_walk), "aa3": (tb.aa3, tb.aa3_walk)}
    assert tb.aa_walk.shape == (9, tb.aa.shape[1])
    assert tb.aa3_walk.shape == (10, tb.aa3.shape[1])
    n_cols = 0
    for key, lo, hi in _sub_lists(k.aa_layout):
        tab, walk = walks[key]
        orig = walk[-1, lo:hi].long()
        assert sorted(orig.tolist()) == list(range(lo, hi))
        assert torch.equal(walk[:-1, lo:hi], tab[:, orig])
        off = walk[0, lo:hi]
        assert bool((off[1:] <= off[:-1]).all()), "not sorted by offset"
        tie = off[1:] == off[:-1]
        assert bool((orig[1:][tie] > orig[:-1][tie]).all()), "not stable"
        n_cols += hi - lo
    assert n_cols == tb.aa.shape[1] + tb.aa3.shape[1] > 0
    # each chunk box holds the corners of its columns' triangles
    box_of = {"aa": (tb.aa_box, (6, 7)), "aa3": (tb.aa3_box, (8,))}
    n_box = {"aa": 0, "aa3": 0}
    for key, lo, hi in _sub_lists(k.aa_layout):
        boxes, rows = box_of[key]
        walk = walks[key][1]
        for c0 in range(lo, hi, tsc.WALK_CHUNK):
            t = walk[list(rows), c0:min(hi, c0 + tsc.WALK_CHUNK)].long()
            a = tb.tri[0:3, t.flatten()]
            pts = torch.cat([a, a + tb.tri[3:6, t.flatten()],
                             a + tb.tri[6:9, t.flatten()]], dim=1)
            box = boxes[:, n_box[key]]
            assert bool((pts >= box[:3, None]).all()
                        and (pts <= box[3:, None]).all())
            n_box[key] += 1
    assert n_box["aa"] == tb.aa_box.shape[1]
    assert n_box["aa3"] == tb.aa3_box.shape[1]


def _ray_sets(scene, cam, cfg, seed):
    """Camera rays and each later bounce's rays through the scan path."""
    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = sample_rays(cam, cfg, torch.arange(b),
                       torch.tensor(rs.random((4, b), np.float32)))
    draws = torch.tensor(rs.random((cfg.max_bounces, n_bounce_draws(cfg), b),
                                   np.float32))
    geom = ttri.precompute(scene.triangles)
    state = tpath.init_state(o, d)
    for i in range(cfg.max_bounces):
        yield f"bounce {i}", state.origin, state.direction
        state = tpath.bounce(scene, geom, cfg.replace(use_pallas=True), i,
                             state, draws[i])


def _assert_walk_equal(tb, k, o, d, what, chunk=tsc.WALK_CHUNK):
    """The walk's groups and the table-order fold's, bit for bit (the
    running numerator, denominator and winner, so the distance too);
    returns the walk's (best, bden, bidx) and its work, which
    ``_closest_merged`` counts alike."""
    best, bidx = tsc._closest_sphere(
        [[tb.sph[r, s] for s in range(k.n_spheres)] for r in range(4)],
        k.n_spheres, *o, *d, k.sphere_eps)
    active = torch.ones_like(best, dtype=torch.bool)
    cand = {"aa_rect": 0, "aa_tri": 0, "aa_head": 0, "aa_slab": 0}
    want = tsc._aa_groups(tb, k, o, d, best, bidx)
    got = tsc._aa_walk(tb, k, o, d, active, best, bidx, cand, chunk)
    for name, w, g in zip(("numerator", "denominator", "winner"), want, got):
        assert torch.equal(w, g), (f"{what}: {name} differs on "
                                   f"{(w != g).sum().item()} rays")
    if chunk == tsc.WALK_CHUNK:
        counts = {}
        tsc._closest_merged(tb, k, o, d, active, best, bidx, counts)
        assert all(counts[c] == v for c, v in cand.items())
    return got, cand


@pytest.mark.parametrize("name", ["fixture", 600, 2048])
def test_walk_equals_table_order_fold(scenes, name):
    scene, cam, cfg, k, tb = scenes[name]
    n_aa = sum(g[2] + g[3] for g in k.aa_layout)
    for what, o, d in _ray_sets(scene, cam, cfg, 7):
        _, cand = _assert_walk_equal(tb, k, tuple(o), tuple(d),
                                     f"{name} {what}")
        # the walk tests a fraction of what the full scan tests
        assert cand["aa_rect"] < cfg.n_pixels * max(n_aa, 1)


def _planted():
    """Tables of one group, (k, s) = (1, +1) (detg = -d_y, in-plane axes
    x and z): rects with m = 0 at heights 1, 1 (coplanar, overlapping),
    1 + ulp(1) (its numerator rounds to the others' from a high origin)
    and 0 (off to the side), in that table order; two coplanar
    overlapping triangles at 0.5, then one at 0.5 + ulp(0.5). Each rect's
    two triangles and each triangle stand in a ``pack_tri``-style table
    (rows a, b - a, c - a), from which ``walk_tables`` boxes them."""
    up = float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    half_up = float(np.nextafter(np.float32(0.5), np.float32(1.0)))
    tri = torch.zeros((25, 53))

    def put(t, a, ab, ac):
        tri[0:9, t] = torch.tensor([*a, *ab, *ac])

    def rect(h, x, z, e, ids, det_eps=1e-6):
        # pack_aa's rows: s a_k, det_eps / u, a_m, 1 / e1_m, a_o, 1 / e2_o,
        # i, j; triangle i from the corner, j from the opposite one
        put(ids[0], (x, h, z), (e, 0.0, 0.0), (0.0, 0.0, e))
        put(ids[1], (x + e, h, z + e), (-e, 0.0, 0.0), (0.0, 0.0, -e))
        return [h, det_eps / (e * e), x, 1.0 / e, z, 1.0 / e, *ids]

    def tri_aa(h, x, z, e, t, det_eps=1e-6):
        # s a_k, det_eps / |D|, a_i1, a_i2, ac_i2 / D, -ac_i1 / D,
        # -ab_i2 / D, ab_i1 / D, t for ab = (e, 0), ac = (0, e)
        put(t, (x, h, z), (e, 0.0, 0.0), (0.0, 0.0, e))
        D = e * e
        return [h, det_eps / D, x, z, e / D, 0.0, 0.0, e / D, t]

    rects = [rect(1.0, -1.0, -1.0, 2.0, (20, 21)),
             rect(1.0, -0.5, -0.5, 2.0, (30, 31)),
             rect(up, -1.0, -1.0, 2.0, (10, 11)),
             rect(0.0, 1.6, 1.6, 1.4, (40, 41))]
    tris = [tri_aa(0.5, -2.0, -2.0, 4.0, 50),
            tri_aa(0.5, -1.0, -1.0, 3.0, 51),
            tri_aa(half_up, -2.0, -2.0, 4.0, 52)]
    aa = torch.tensor(rects, dtype=torch.float32).T.contiguous()
    aa3 = torch.tensor(tris, dtype=torch.float32).T.contiguous()
    layout = ((0, 1, 0, 0, 0), (0, -1, 0, 0, 0), (1, 1, 4, 0, 3),
              (1, -1, 0, 0, 0), (2, 1, 0, 0, 0), (2, -1, 0, 0, 0))
    plan = tsc.QuadPlan(aa_layout=layout,
                        rects=tuple((0, 1, 0, 1, 1, 0) for _ in rects),
                        aa_tris=tuple((50 + i, 1, 1) for i in range(3)),
                        quads=(), leftovers=())
    tb = tsc.MeshTables(torch.zeros((14, 0)), tri, None, None, None, None,
                        aa, aa3, torch.zeros((14, 0)), torch.zeros((6, 0)),
                        torch.zeros((13, 0)), torch.zeros((6, 0)),
                        *tsc.walk_tables(tri, aa, aa3, plan, chunk=2))
    k = types.SimpleNamespace(plan=plan, aa_layout=layout, n_spheres=0,
                              sphere_eps=1e-4, tri_eps=1e-7, det_eps=1e-6,
                              n_quads=0, n_leftover=0)
    return tb, k


def test_walk_keeps_planted_ties():
    """From a high origin the rects at 1 and 1 + ulp(1) give one
    numerator: the table-order scan keeps column 0 (ids 20, 21), which
    the walk meets after column 2, and skips column 1 (coplanar); the
    triangles at 0.5 and 0.5 + ulp(0.5) tie likewise; from nearer, the
    plane one ulp closer wins. Then random downward rays."""
    tb, k = _planted()
    planted = [((0.1, 1000.0, 0.2), 21), ((-0.7, 1000.0, -0.3), 20),
               ((1.2, 1000.0, 1.2), 31), ((2.5, 1000.0, 2.5), 41),
               ((-1.5, 1000.0, -1.5), 50), ((-0.5, 0.75, -0.5), 52),
               ((0.1, 1.5, 0.2), 11)]
    rs = np.random.default_rng(3)
    ro = rs.uniform(-3.5, 3.5, (256, 3))
    ro[:, 1] = rs.choice([0.25, 0.75, 1.5, 1000.0, 1e5], 256)
    rd = rs.normal(size=(256, 3))
    rd[:, 1] = -np.abs(rd[:, 1]) - 0.2
    rd[:64, 0] = 0.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.tensor(np.concatenate([[p for p, _ in planted], ro]),
                     dtype=torch.float32).T
    d = torch.tensor(np.concatenate([[(0.0, -1.0, 0.0)] * len(planted), rd]),
                     dtype=torch.float32).T
    o, d = tuple(o), tuple(d)
    (best, bden, idx), cand = _assert_walk_equal(tb, k, o, d, "planted",
                                                 chunk=2)
    t = best / bden
    assert idx[:len(planted)].tolist() == [w for _, w in planted]
    assert t[0].item() == 999.0 and t[4].item() == 999.5
    assert 0 < cand["aa_rect"] < 4 * o[0].shape[0] and cand["aa_slab"] > 0


def test_k4_counts_cull_against_the_running_best():
    """One triangle a chunk, both facing the ray, the near one first: the
    far chunk's box is entered behind the running best and not counted;
    far first, both are; a sphere in front of both culls both."""
    o = (torch.tensor([0.25]), torch.tensor([0.25]), torch.tensor([-1.0]))
    d = (torch.tensor([0.0]), torch.tensor([0.0]), torch.tensor([1.0]))

    def tri_at(z):
        # a = (0, 0, z), b - a = (0, 1, 0), c - a = (1, 0, 0): the raw
        # normal (0, 0, -1) faces the ray
        return [0.0, 0.0, z, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0]

    for zs, sph, want_tri, want_idx in (
            ((1.0, 2.0), [], 1, 0), ((2.0, 1.0), [], 2, 1),
            ((1.0, 2.0), [[0.25, 0.25, 0.0, 0.5]], 0, 0)):
        tri = torch.tensor([tri_at(z) for z in zs]).T.contiguous()
        corners = [(tri[r], tri[r] + tri[r + 3], tri[r] + tri[r + 6])
                   for r in range(3)]
        boxes = tsc.chunk_boxes(*map(list, corners), 2, 1)
        sph_t = torch.tensor(sph, dtype=torch.float32).reshape(-1, 4).T
        counts = {"sphere": 0, "slab": 0, "tri": 0}
        t, i = tint.intersect_reference(sph_t.contiguous(), tri, boxes, *o, *d,
                                        1e-4, 1e-6, 1e-7, counts, chunk=1)
        assert counts == {"sphere": len(sph), "slab": 2, "tri": want_tri}
        assert i.tolist() == [want_idx]
