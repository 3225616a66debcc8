"""Quad merging in the port (``raytpu_torch.geometry.quads``, the loader's
detection and K3's merged-search packers) against raytpu's.

The port's detection and classification give ``raytpu``'s tuples exactly
on generated block worlds, on ``scenes.write_quad_fixture`` and on the
hand-built cases of ``tests/test_quad_merge.py``; ``load_scene_file``
carries them on the config as raytpu's does; the merged search's tables
(``pack_aa``, ``pack_quads``) hold ``raytpu``'s values bit for bit (its
tables without their SMEM padding). Host code only: no kernel runs.
"""

import os

import numpy as np
import pytest
import torch

from raytpu import config as jconfig
from raytpu.geometry import quads as jquads
from raytpu.geometry.triangle import precompute as j_precompute
from raytpu.kernels import trace_scene as jts
from raytpu_torch import config as tconfig
from raytpu_torch.geometry import quads as tquads
from raytpu_torch.kernels import trace_scene as tts
from raytpu_torch.scenes import write_block_world, write_quad_fixture
from tests.test_torch_sky import _cfg

GROUPS = [(k, s) for k in range(3) for s in (1, -1)]


@pytest.fixture(scope="module")
def tomls(tmp_path_factory):
    base = tmp_path_factory.mktemp("quads")
    return {
        "world60": write_block_world(str(base / "w60"), 60, seed=3),
        "world600": write_block_world(str(base / "w600"), 600, seed=0),
        "fixture": write_quad_fixture(str(base / "fixture"), seed=0),
    }


def _coords(tris):
    return [np.asarray(c) for v in (tris.a, tris.b, tris.c) for c in v]


@pytest.mark.parametrize("name", ["world60", "world600", "fixture"])
def test_detection_and_loader_match_raytpu(tomls, name):
    js, _, jcfg = jconfig.load_scene_file(tomls[name])
    ts, _, tcfg = tconfig.load_scene_file(tomls[name], device="cpu")
    coords = _coords(js.triangles)
    pairs = tquads.detect_quad_pairs(*coords)
    assert pairs == jquads.detect_quad_pairs(*coords) == jcfg.quad_pairs
    assert pairs
    classes = tquads.classify_axis_aligned(*coords, pairs)
    assert classes == jquads.classify_axis_aligned(*coords, pairs)
    assert (tquads.leftover_indices(len(coords[0]), pairs)
            == jquads.leftover_indices(len(coords[0]), pairs))
    # the loader: the same fields, from the port's own triangle tensors
    assert tcfg.quad_pairs == jcfg.quad_pairs
    assert (tcfg.quad_aa_rects, tcfg.quad_aa_tris) == classes
    assert tquads.detect_quad_pairs(*(c for v in (ts.triangles.a,
                                                  ts.triangles.b,
                                                  ts.triangles.c)
                                      for c in v)) == pairs


def _tris(verts):
    v = np.float32(verts)
    return [v[:, i, j] for i in range(3) for j in range(3)]


HAND_BUILT = {   # tests/test_quad_merge.py's cases: (triangles, pairs found)
    "exact_parallelogram": ([[(0, 0, 0), (1, 0, 0), (1, 1, 0)],
                             [(0, 0, 0), (1, 1, 0), (0, 1, 0)]], 1),
    "broken_closure": ([[(0, 0, 0), (1, 0, 0), (1, 1, 0)],
                        [(0, 0, 0), (1, 1, 0), (0.25, 1, 0)]], 0),
    "opposite_winding": ([[(0, 0, 0), (1, 0, 0), (1, 1, 0)],
                          [(0, 0, 0), (0, 1, 0), (1, 1, 0)]], 0),
    "non_coplanar": ([[(0, 0, 0), (1, 0, 0), (1, 1, 0)],
                      [(0, 0, 0), (1, 1, 0), (0, 1, 0.5)]], 0),
}


@pytest.mark.parametrize("name", sorted(HAND_BUILT))
def test_hand_built_cases_match_raytpu(name):
    verts, n_pairs = HAND_BUILT[name]
    coords = _tris(verts)
    pairs = tquads.detect_quad_pairs(*coords)
    assert pairs == jquads.detect_quad_pairs(*coords)
    assert len(pairs) == n_pairs
    if pairs:
        assert {pairs[0][0], pairs[0][1]} == {0, 1}
        classes = tquads.classify_axis_aligned(*coords, pairs)
        assert classes == jquads.classify_axis_aligned(*coords, pairs)
        assert classes[0][0][:2] == (2, 1)    # normal +z: an aa rect


@pytest.mark.parametrize("name", ["world60", "fixture"])
def test_packed_tables_match_raytpu(tomls, name):
    """The port's merged tables hold raytpu's ``pack_aa`` / ``pack_quads``
    values bit for bit (raytpu pads its general tables to whole chunks;
    the port does not), and its plan is raytpu's ``_aa_partition``."""
    js, _, jcfg = jconfig.load_scene_file(tomls[name])
    ts, _, tcfg = tconfig.load_scene_file(tomls[name], device="cpu")
    pairs = jcfg.quad_pairs
    layout, rect_sel, tri_sel = jts._aa_partition(jcfg.quad_aa_rects,
                                                  jcfg.quad_aa_tris)
    gen = tuple(p for p, c in zip(pairs, jcfg.quad_aa_rects) if c == ())
    geom = j_precompute(js.triangles)
    aatab, aat3 = jts.pack_aa(js, geom, pairs, rect_sel, tri_sel,
                              jcfg.tri_det_eps)
    qtab, qbox, ltab, lbox = jts.pack_quads(
        js, geom, gen, all_pairs=pairs,
        exclude_tris=frozenset(t for t, _, _ in jcfg.quad_aa_tris))

    k = tts.MeshKnobs.for_scene(tcfg, ts, 3)
    assert k.aa_layout == layout
    assert k.n_quads == len(gen)
    assert k.n_leftover == ts.triangles.count - 2 * len(pairs) - len(tri_sel)
    tb = tts.pack_scene(ts, k)
    for got, want in ((tb.aa, aatab), (tb.aa3, aat3), (tb.quad, qtab),
                      (tb.qbox, qbox), (tb.left, ltab), (tb.lbox, lbox)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want)[:, :got.shape[1]])
    if name == "fixture":     # every table holds columns
        assert min(t.shape[1] for t in tb[6:]) > 0


def test_fixture_reaches_every_branch(tomls):
    """What the fixture is for: rects of both edge orientations in all
    six (axis, sign) groups, unpaired axis-aligned triangles, more than
    64 general parallelograms and more than 64 general leftovers (the
    chunk-culled loops), a pair whose halves have different materials,
    pairs of every opposite-vertex slot, at most 2048 triangles."""
    ts, _, cfg = tconfig.load_scene_file(tomls["fixture"], device="cpu")
    k = tts.MeshKnobs.for_scene(cfg, ts, 3)
    assert ts.triangles.count <= tts.MAX_TRIS
    assert [g[:2] for g in k.aa_layout] == GROUPS
    assert all(ca > 0 and cb > 0 for _, _, ca, cb, _ in k.aa_layout)
    assert sum(g[4] for g in k.aa_layout) > 0
    assert k.n_quads > 2 * tts.CULL_CHUNK < k.n_leftover
    mat = ts.triangles.mat_id
    assert any(int(mat[i]) != int(mat[j]) for i, j, _ in cfg.quad_pairs)
    assert {oi for _, _, oi in cfg.quad_pairs} == {0, 1, 2}


def test_merge_quads_flag(tomls):
    """``merge_quads = false`` in the spec skips the detection;
    ``cfg.replace(merge_quads=False)`` after the load turns the merged
    search off (no plan), as in raytpu."""
    ts, _, cfg = tconfig.load_scene_file(tomls["world60"], device="cpu")
    assert tts.quad_plan(cfg, ts.triangles.count) is not None
    assert tts.quad_plan(cfg.replace(merge_quads=False),
                         ts.triangles.count) is None
    assert tts.MeshKnobs.for_scene(cfg.replace(merge_quads=False), ts,
                                   3).plan is None
    off = os.path.join(os.path.dirname(tomls["world60"]), "off.toml")
    with open(off, "w") as f:
        f.write("merge_quads = false\n" + open(tomls["world60"]).read())
    _, _, jcfg = jconfig.load_scene_file(str(off))
    _, _, tcfg = tconfig.load_scene_file(str(off), device="cpu")
    assert tcfg.merge_quads is False and tcfg.quad_pairs == ()
    assert (jcfg.merge_quads, jcfg.quad_pairs) == (False, ())
    assert tts.MeshKnobs.for_scene(_cfg(jcfg), ts, 3).plan is None


def test_merged_knobs_need_merged_tables(tomls):
    """Knobs with a quad plan and tables packed without it: the plain
    version refuses them rather than searching the wrong tables."""
    ts, _, cfg = tconfig.load_scene_file(tomls["world60"], device="cpu")
    k = tts.MeshKnobs.for_scene(cfg.replace(max_bounces=1), ts, 3)
    rays = [torch.zeros(4) for _ in range(6)]
    with pytest.raises(ValueError, match="merged search needs"):
        tts.trace_scene_reference(tts.pack_scene(ts), *rays,
                                  torch.zeros(3, 4), k)
    assert tts.pack_scene(ts, k).aa is not None
