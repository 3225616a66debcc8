"""The closest-hit kernel K4's plain version and the scan path's geometry
against raytpu.

K4 (``raytpu_torch.kernels.intersect``) on CPU tensors runs
``intersect_reference``, which scans every primitive; ``raytpu``'s
``pallas_select`` runs its Pallas kernel in interpret mode. Both get the
same rays, made from a numpy seed, on Cornell (spheres only) and on
block worlds of 60 (with water, AO, untextured), 600, 2048 and 4096
triangles and the 4-triangle cutout / window / emissive scene.
Tolerances:
- random rays (a quarter with d.x = 0, a quarter with d.z = 0): the
  winner equal on every ray;
- camera rays and the bounce rays the port's scan path sends from them:
  the winner equal on at least 99.9% of the (ray, bounce) entries that
  are not self-hit knife edges. A bounce ray starts on the surface it
  left, and meets it again or not by rounding: on the block worlds' 1e5
  sky dome at a t of rounding noise of |o|^2 ~ 1e10 (ROADMAP F7; 1-2% of
  entries), on Cornell's radius-500 walls at a t just above sphere_eps.
  An entry is such a knife edge when either side's winner lies within
  SELF_T s of the origin, s the larger of 1 and |o|_inf / 100; those are
  left out of the count (at most 10% of the entries: on the block worlds
  every ray that escaped to the dome is one, about 5%);
- where the winners agree (knife edges left out), t within
  1e-4 |t| + 1e-6 s + 2 e_root, s the larger of 1 and |o|_inf, and for a
  sphere winner e_root the first-order f32 rounding of its root
  (-b +- sq) / 2a, computed in float64: u (|b| + (b^2 + 8 a max(|oc|^2,
  r^2)) / 2 sq) / 2a with u = 2^-24. b and c = |oc|^2 - r^2 both cancel
  on a radius-500 wall, so either package's t carries up to ~ulp(b) / 2a
  (a near root) and ~ulp(r^2) / sq (a shallow one), checked against
  float64: neither side is nearer. raytpu's compiled interpret run also
  rounds t on the sky dome by up to 1.5e-5 relative. The test prints the
  largest ratio of error to tolerance.
Then the geometry, vector, material and texture functions the scan path
adds, against raytpu's on the same inputs, to 1e-5 relative: XLA's CPU
kernels and PyTorch's round a few operations (and cos, sin) differently
in the last place, which the barycentric ratios amplify.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu import scenes as jscenes
from raytpu.core import types as jtypes
from raytpu.core import vec3 as jvec
from raytpu.core.types import TextureAtlas as JAtlas
from raytpu.geometry import sphere as jsphere
from raytpu.geometry import triangle as jtri
from raytpu.integrator.path import n_bounce_draws
from raytpu.kernels.intersect import pallas_select as j_select
from raytpu.materials import texture as jtex
from raytpu_torch import convert
from raytpu_torch.core import types as ttypes
from raytpu_torch.core import vec3 as tvec
from raytpu_torch.core.types import RenderConfig as TConfig
from raytpu_torch.core.types import TextureAtlas as TAtlas
from raytpu_torch.geometry import sphere as tsphere
from raytpu_torch.geometry import triangle as ttri
from raytpu_torch.integrator import path as tpath
from raytpu_torch.kernels import intersect as tint
from raytpu_torch.materials import texture as ttex
from raytpu_torch.scenes import mesh_branch_scene, write_block_world
from tests.test_mesh_megakernel import _synthetic_textured_scene
from tests.test_torch_render import _arrays

WIDTH, HEIGHT = 64, 48          # phase (a)'s ray count
REAL_AGREE, T_RTOL, T_ATOL = 0.999, 1e-4, 1e-6
SELF_T, SELF_FRAC = 1e-3, 0.1
FN_RTOL = 1e-5                  # last-place rounding of two libraries


def _port_scene(js):
    return convert.scene_from_arrays(_arrays(
        js, sky_sphere_index=js.sky_sphere_index,
        **{"atlas.width": js.atlas.width, "atlas.height": js.atlas.height}),
        device="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("bw")
    return {n: write_block_world(str(d / str(n)), n_triangles=n,
                                 seed=3 if n == 60 else 0)
            for n in (60, 600, 2048, 4096)}


def _case(worlds, name):
    """(raytpu scene, camera, port scene, port config)."""
    if name == "cornell":
        js, jc, cfg = jscenes.cornell_box()
        cfg = cfg.replace(max_bounces=5)
    elif name == "branches":
        js, jc = _synthetic_textured_scene()
        cfg = TConfig(**dataclasses.asdict(mesh_branch_scene("cpu")[2]))
    else:
        n = int(name.split("_")[0])
        js, jc, cfg = jconfig.load_scene_file(worlds[n])
        cfg = cfg.replace(max_bounces=6)
        if name.endswith("ao"):
            cfg = cfg.replace(max_bounces=4, use_ao=True, ao_samples=2)
        if name.endswith("untextured"):
            js = js.replace(atlas=JAtlas.empty())
    tcam = convert.camera_from_arrays(_arrays(jc), device="cpu")
    tcfg = TConfig(**dataclasses.asdict(cfg)).replace(width=WIDTH,
                                                      height=HEIGHT)
    return js, jc, _port_scene(js), tcam, tcfg


CASES = ("cornell", "60", "60_ao", "60_untextured", "branches", "600",
         "2048", "4096")


def _both(js, ts, cfg, o, d):
    """(port, raytpu) (best_t, best_idx) as numpy for the same rays."""
    geom = ttri.precompute(ts.triangles) if ts.n_triangles else None
    got = tint.pallas_select(ts, geom, o, d, cfg.sphere_eps, cfg.tri_det_eps,
                             cfg.tri_eps)
    jgeom = jtri.precompute(js.triangles) if ts.n_triangles else None
    jv = lambda v: jvec.Vec3(*(jnp.asarray(c.numpy()) for c in v))
    want = j_select(js, jgeom, jv(o), jv(d), cfg.sphere_eps, cfg.tri_det_eps,
                    cfg.tri_eps, interpret=True)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _o_inf(origin):
    return np.max([np.abs(np.asarray(c)) for c in origin], 0)


def _t_close(got, want, idx, origin, direction, sph):
    """Assert t agrees within the tolerance above; the largest ratio of
    error to tolerance. ``sph`` is the (4, S) table: centre, radius."""
    is_s = (idx >= 0) & (idx < sph.shape[1])
    e_root = np.zeros(got.shape)
    if sph.shape[1]:
        cen = sph.astype(np.float64)[:, np.where(is_s, idx, 0)]
        o, d = (np.stack([np.asarray(v, np.float64) for v in x])
                for x in (origin, direction))
        oc = o - cen[:3]
        a, b = (d * d).sum(0), 2.0 * (oc * d).sum(0)
        oc2, r2 = (oc * oc).sum(0), cen[3] ** 2
        sq = np.sqrt(np.maximum(b * b - 4.0 * a * (oc2 - r2), 1e-30))
        e = (np.abs(b) + (b * b + 8.0 * a * np.maximum(oc2, r2)) / (2 * sq))
        e_root = np.where(is_s, 2.0 ** -24 * e / (2.0 * a), 0.0)
    tol = (T_RTOL * np.abs(want) + T_ATOL * np.maximum(1.0, _o_inf(origin))
           + 2.0 * e_root)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.sum()} t differ: {got[bad][:4]} against "
                           f"{want[bad][:4]}")
    return float((np.abs(got - want) / tol).max(initial=0.0))


def _sph_table(ts):
    return torch.stack([*ts.spheres.center, ts.spheres.radius]).numpy()


def _random_rays(seed, b):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-2.0, 2.0, (3, b)).astype(np.float32)
    o[1] = np.abs(o[1])                     # above the ground
    d = rs.normal(size=(3, b)).astype(np.float32)
    d[0, : b // 4] = 0.0
    d[2, b // 4: b // 2] = 0.0
    d /= np.linalg.norm(d, axis=0)
    t = lambda a: tvec.Vec3(*(torch.tensor(c) for c in a))
    return t(o), t(d)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_raytpu_on_random_rays(worlds, name):
    js, _, ts, _, cfg = _case(worlds, name)
    o, d = _random_rays(CASES.index(name), WIDTH * HEIGHT)
    (gt, gi), (wt, wi) = _both(js, ts, cfg, o, d)
    np.testing.assert_array_equal(gi, wi)
    assert (gi >= 0).mean() > 0.3, "too few hits to compare"
    ratio = _t_close(gt, wt, gi, o, d, _sph_table(ts))
    print(f"{name}: largest t error / tolerance {ratio:.3g}")


def _bounce_rays(ts, tcam, cfg, seed):
    """Camera rays of a WIDTH x HEIGHT frame and each later bounce's rays
    through the port's scan path, draws from a numpy seed."""
    from raytpu_torch.integrator.render import sample_rays

    rs = np.random.default_rng(seed)
    b = cfg.n_pixels
    o, d = sample_rays(tcam, cfg, torch.arange(b),
                       torch.tensor(rs.random((4, b), np.float32)))
    draws = torch.tensor(rs.random((cfg.max_bounces, n_bounce_draws(cfg), b),
                                   np.float32))
    geom = ttri.precompute(ts.triangles) if ts.n_triangles else None
    state = tpath.init_state(o, d)
    for i in range(cfg.max_bounces):
        yield state.origin, state.direction
        state = tpath.bounce(ts, geom, cfg, i, state, draws[i])


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_raytpu_on_bounce_rays(worlds, name):
    js, _, ts, tcam, cfg = _case(worlds, name)
    same, n, edges, hits, ratio = 0, 0, 0, 0, 0.0
    for o, d in _bounce_rays(ts, tcam, cfg, 100 + CASES.index(name)):
        (gt, gi), (wt, wi) = _both(js, ts, cfg, o, d)
        edge = np.minimum(gt, wt) < SELF_T * np.maximum(1.0, _o_inf(o) / 100)
        keep = (gi == wi) & ~edge
        same += keep.sum()
        n += (~edge).sum()
        edges += edge.sum()
        hits += (gi >= 0).sum()
        ratio = max(ratio, _t_close(gt[keep], wt[keep], gi[keep],
                                    [c[keep] for c in o],
                                    [c[keep] for c in d], _sph_table(ts)))
    print(f"{name}: largest t error / tolerance {ratio:.3g}")
    assert same / n >= REAL_AGREE, f"{1 - same / n:.3%} of entries differ"
    assert edges <= SELF_FRAC * (n + edges) and hits > 0


def test_cull_keeps_axis_planes_and_counts():
    """The kernel's slab test (mirrored by ``_entered_chunks``): an origin
    on a box plane with a zero direction component lies in that slab;
    ``counts`` sees the chunks each ray enters."""
    boxes = torch.tensor([[0.0], [0.0], [0.0], [1.0], [1.0], [1.0]])
    o = (torch.tensor([0.0, 0.5, 2.0]), torch.tensor([0.5, 0.5, 0.5]),
         torch.tensor([-1.0, -1.0, -1.0]))
    d = (torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, 0.0]),
         torch.tensor([1.0, -1.0, 1.0]))
    assert tint._entered_chunks(boxes, o, d)[:, 0].tolist() == [True, False,
                                                                False]
    sph = torch.zeros((4, 0))
    tri = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1]]).T.contiguous()
    counts = {"sphere": 0, "slab": 0, "tri": 0}
    t, i = tint.intersect_reference(sph, tri, boxes, *o, *d, 1e-4, 1e-6,
                                    1e-7, counts)
    assert counts == {"sphere": 0, "slab": 3, "tri": 1}
    assert i.tolist() == [-1, -1, -1]      # the triangle faces away


def test_select_bounds_and_no_launch_on_cpu(worlds):
    js, _, ts, _, cfg = _case(worlds, "60")
    o, d = _random_rays(0, 64)
    before = tint.launches
    tint.pallas_select(ts, ttri.precompute(ts.triangles), o, d, 1e-4, 1e-6,
                       1e-7)
    assert tint.launches == before           # CPU tensors: the plain version
    z = torch.zeros(tint.MAX_PRIMS + 1)
    big = dataclasses.replace(ts, spheres=ttypes.Spheres(
        tvec.Vec3(z, z, z), z + 1, ttypes.Materials.zeros(z.shape)))
    assert tint.pallas_supported(ts) and not tint.pallas_supported(big)
    with pytest.raises(ValueError, match="at most 4096"):
        tint.pallas_select(big, ttri.precompute(ts.triangles), o, d, 1e-4,
                           1e-6, 1e-7)


# --- the scan path's building blocks against raytpu's -----------------


def _rs(seed):
    return np.random.default_rng(seed)


def _pair(a):
    """(raytpu Vec3, port Vec3) of a (3, n) f32 array."""
    return (jvec.Vec3(*(jnp.asarray(c) for c in a)),
            tvec.Vec3(*(torch.tensor(c) for c in a)))


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=FN_RTOL, atol=1e-7)


def test_vec3_helpers_match_raytpu():
    rs = _rs(1)
    (ja, ta), (jb, tb) = (_pair(rs.normal(size=(3, 500)).astype(np.float32))
                          for _ in range(2))
    (jn, tn) = _pair((lambda v: v / np.linalg.norm(v, axis=0))(
        rs.normal(size=(3, 500))).astype(np.float32))
    s = rs.uniform(0, 1, 500).astype(np.float32)
    js, ts_ = jnp.asarray(s), torch.tensor(s)
    mask = s > 0.5
    _eq(tvec.Vec3.where(torch.tensor(mask), ta, tb),
        jvec.Vec3.where(jnp.asarray(mask), ja, jb))
    _eq(ta.lerp(tb, ts_), ja.lerp(jb, js))
    _eq(-ta, -ja)
    _eq(ta * tb, ja * jb)
    _eq(tvec.Vec3.full((4,), 1.0, 2.0, 3.0), jvec.Vec3.full((4,), 1.0, 2.0, 3.0))
    _eq(tvec.reflect(ta, tn), jvec.reflect(ja, jn))
    n1 = rs.uniform(0.0, 2.0, 500).astype(np.float32)
    n2 = rs.uniform(0.0, 2.0, 500).astype(np.float32)
    _eq(tvec.refract(ta.normalize(), tn, torch.tensor(n1), torch.tensor(n2)),
        jvec.refract(ja.normalize(), jn, jnp.asarray(n1), jnp.asarray(n2)))
    u, v = rs.random((2, 500)).astype(np.float32)
    _eq(tvec.random_unit_vector(torch.tensor(u), torch.tensor(v)),
        jvec.random_unit_vector(jnp.asarray(u), jnp.asarray(v)))


def test_materials_where_and_zeros_match_raytpu():
    rs = _rs(2)
    parts = [rs.random((3, 6)).astype(np.float32) for _ in range(2)]
    scal = rs.random((8, 6)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 0], bool)

    def mats(mod, vec, arr, k):
        return mod.Materials(vec(*map(arr, parts[k])), vec(*map(arr, parts[1 - k])),
                             *map(arr, scal[4 * k: 4 * k + 4]))

    jm = [mats(jtypes, jvec.Vec3, jnp.asarray, k) for k in (0, 1)]
    tm = [mats(ttypes, tvec.Vec3, torch.tensor, k) for k in (0, 1)]
    got = ttypes.Materials.where(torch.tensor(mask), *tm)
    want = jtypes.Materials.where(jnp.asarray(mask), *jm)
    flat = lambda m: [*m.diffuse, *m.emission, m.emission_strength,
                      m.reflection, m.alpha, m.ior]
    _eq(flat(got), flat(want))
    _eq(flat(ttypes.Materials.zeros((6,))), flat(jtypes.Materials.zeros((6,))))


def test_sphere_and_triangle_distances_match_raytpu():
    rs = _rs(3)
    jo, to = _pair(rs.uniform(-2, 2, (3, 300)).astype(np.float32))
    jd, td = _pair((lambda v: v / np.linalg.norm(v, axis=0))(
        rs.normal(size=(3, 300))).astype(np.float32))
    jc, tc = _pair(rs.uniform(-1, 1, (3, 20)).astype(np.float32))
    r = rs.uniform(0.1, 1.0, 20).astype(np.float32)
    _eq([tsphere.sphere_distances(to, td, tc, torch.tensor(r))],
        [jsphere.sphere_distances(jo, jd, jc, jnp.asarray(r))])
    idx = rs.integers(0, 20, 300)
    jcs, tcs = _pair(rs.uniform(-1, 1, (3, 20)).astype(np.float32)[:, idx])
    _eq([tsphere.sphere_distance_one(to, td, tcs, torch.tensor(r[idx]))],
        [jsphere.sphere_distance_one(jo, jd, jcs, jnp.asarray(r[idx]))])
    _eq(tsphere.sphere_normal(to, tcs), jsphere.sphere_normal(jo, jcs))

    verts = rs.uniform(-1, 1, (3, 3, 40)).astype(np.float32)
    jg = jtri.precompute(jtri_tris(verts))
    tg = ttri.precompute(ttri_tris(verts))
    _eq([ttri.triangle_distances(to, td, tg)],
        [jtri.triangle_distances(jo, jd, jg)])
    k = rs.integers(0, 40, 300)
    pick_t = lambda v: tvec.Vec3(*(c[k] for c in v))
    pick_j = lambda v: jvec.Vec3(*(c[k] for c in v))
    _eq([ttri.triangle_distance_one(to, td, pick_t(tg.a), pick_t(tg.edge_ab),
                                    pick_t(tg.edge_ac),
                                    pick_t(tg.normal_raw))],
        [jtri.triangle_distance_one(jo, jd, pick_j(jg.a), pick_j(jg.edge_ab),
                                    pick_j(jg.edge_ac),
                                    pick_j(jg.normal_raw))])


def _tris(mod, vec, arr, verts):
    n = verts.shape[-1]
    z = arr(np.zeros(n, np.float32))
    return mod.Triangles(*(vec(*map(arr, verts[i])) for i in range(3)),
                         z, z, z, z, z, z, arr(np.zeros(n, np.int32)))


def jtri_tris(verts):
    return _tris(jtypes, jvec.Vec3, jnp.asarray, verts)


def ttri_tris(verts):
    return _tris(ttypes, tvec.Vec3, torch.tensor, verts)


@pytest.mark.parametrize("bilinear", [False, True])
def test_triangle_material_matches_raytpu(bilinear):
    """tri_uvmapping on random hits of random triangles, both fetches."""
    rs = _rs(4)
    n, w, h, m = 400, 8, 4, 3
    verts = rs.uniform(-1, 1, (3, 3, n)).astype(np.float32)
    bary = rs.dirichlet((1, 1, 1), n).T.astype(np.float32)
    p = sum(verts[i] * bary[i] for i in range(3)).astype(np.float32)
    uv = rs.uniform(-1.5, 2.5, (6, n)).astype(np.float32)
    mat_id = rs.integers(0, m, n).astype(np.int32)
    rgb = rs.random((3, m * w * h)).astype(np.float32)
    alpha = rs.choice(np.float32([0.0, 0.5, 1.0]), m * w * h)
    table = [rs.random((3, m)).astype(np.float32), *rs.random((4, m))
             .astype(np.float32), rs.random(m) > 0.5, rs.random(m) > 0.5]
    jn, tn = _pair(np.cross(verts[1] - verts[0], verts[2] - verts[0], axis=0)
                   .astype(np.float32))
    jn, tn = jn.normalize(), tn.normalize()

    def args(vec, arr, mod, atlas_t, table_t):
        v = lambda a: vec(*map(arr, a))
        return (v(verts[0]), v(verts[1]), v(verts[2]),
                (arr(uv[0]), arr(uv[1])), (arr(uv[2]), arr(uv[3])),
                (arr(uv[4]), arr(uv[5]))), v(p), arr(mat_id), \
            atlas_t(v(rgb), arr(alpha), w, h), table_t(
                v(table[0]), *map(arr, table[1:]))

    jt, jp, jm, ja, jtab = args(jvec.Vec3, jnp.asarray, jtypes,
                                jtypes.TextureAtlas, jtypes.MatTable)
    tt, tp, tm, ta, ttab = args(tvec.Vec3, torch.tensor, ttypes,
                                TAtlas, ttypes.MatTable)
    got = ttex.triangle_material(*tt, tn, tp, tm, ta, ttab, bilinear=bilinear)
    want = jtex.triangle_material(*jt, jn, jp, jm, ja, jtab, bilinear=bilinear)
    flat = lambda x: [*x.diffuse, *x.emission, x.emission_strength,
                      x.reflection, x.alpha, x.ior]
    _eq(flat(got), flat(want))
