"""The benchmark's mesh configuration and its plain reference on the CPU.

* The reference (``portbench/reference/mesh.py``, which reads the OBJ, MTL
  and PPM files itself) sums each pixel's radiance to the bit as the
  program's plain K3 version does with the merged search: on a
  60-triangle block world with water, glass and glowstone, and on the
  quad fixture, whose general parallelograms and leftover triangles the
  block world lacks.
* Its quad pairs are the loader's on the committed world; the committed
  configuration's camera, spheres and material overrides are the
  committed scene file's, and the OBJ holds 600 triangles in 11
  materials.
* The harness finds ``block600.render``'s files; a traced CPU run of the
  cell reports the metrics a CPU run can read, and the bfloat16 control
  and each fault make ``correct`` false at the cell's limits.
"""

import ast
import copy
import json
import subprocess
import sys
import time
import tomllib
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference import mesh, mesh_work, rng, work
from portbench.scenes import mesh as scene_mesh
from raytpu_torch.integrator import render as trender
from raytpu_torch.scenes import write_block_world, write_quad_fixture

ROOT = Path(__file__).resolve().parent.parent
SPEC = harness.load_spec()
CONFIG = json.loads((ROOT / "portbench/configs/block600.json").read_text())
TOML = ROOT / CONFIG["scene"]["toml"]
CELL = "block600.render"
TINY = {"render": {"width": 8, "height": 6, "spp": 3, "pixel_tile": 48,
                   "max_bounces": 4},
        "mix": {"check_pixels": 16}}
CPU = torch.device("cpu")


def _sphere_rows(spec: dict) -> list:
    return [[r["center"], r["radius"], r.get("diffuse", [0.0] * 3),
             r.get("emission", [0.0] * 3), r.get("emission_strength", 0.0),
             r.get("reflection", 0.0), r.get("alpha", 1.0), r.get("ior", 1.0)]
            for r in spec["spheres"]]


def _config_of(toml: str, **render) -> dict:
    """The block600 configuration moved onto another scene file."""
    spec = tomllib.loads(Path(toml).read_text())
    base = Path(toml).parent
    c = copy.deepcopy(CONFIG)
    c["scene"].update(toml=toml, obj=str(base / spec["mesh"]["obj"]),
                      mtl=str(base / spec["mesh"]["mtl"]),
                      materials=spec["mesh"].get("materials", []),
                      spheres=_sphere_rows(spec))
    cam = spec["camera"]
    c["camera"] = {"origin": cam["origin"], "target": cam["target"],
                   "up": cam["up"], "vfov_deg": cam["vfov"],
                   "aspect_ratio": 1200 / 900}
    c["render"].update(render)
    return c


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("worlds")
    return {"block_world": write_block_world(str(d / "bw"), n_triangles=60,
                                             seed=3),
            "quad_fixture": write_quad_fixture(str(d / "qf"), seed=1)}


# (world, seed, width, spp, bounces): the quad fixture's general loops fold
# one candidate at a time, so it runs a smaller frame
@pytest.mark.parametrize("world,seed,w,spp,bounces", [
    ("block_world", 3, 24, 3, 5), ("block_world", 2**32 + 9, 24, 3, 5),
    ("quad_fixture", 77, 12, 2, 3)])
def test_pixel_sums_equal_the_plain_merged_k3(worlds, world, seed, w, spp,
                                               bounces):
    h = w * 3 // 4
    config = _config_of(worlds[world], width=w, height=h, spp=spp,
                        pixel_tile=w * h, max_bounces=bounces)
    scene, cam, cfg = scene_mesh.program(config, CPU)
    tb, ref_cam, s = mesh.build(config)
    assert torch.equal(ref_cam, trender.pack_camera(cam))
    if world == "block_world":
        # water, glass and glowstone in the frame's materials
        assert {6, 7, 8, 9} <= set(scene.triangles.mat_id.tolist())
        assert sum(g[4].shape[1] for g in tb.groups) > 0
    else:
        assert tb.quad.shape[1] > 64 and tb.left.shape[1] > 64
    hi, lo = (seed >> 32) & rng.MASK, seed & rng.MASK
    key = torch.tensor([hi, lo], dtype=torch.int64)
    ids = torch.arange(cfg.n_pixels)
    sums = trender.render(scene, cam, cfg, ids, key)
    counts = {}
    ref = mesh.render_pixels(tb, ref_cam, s, rng.key(hi, lo), ids, cfg.spp,
                             max_rays=500, counts=counts)
    assert torch.equal(sums.radiance.to_array().T, ref)
    assert 0 < counts["tri"] < counts["live"] and counts["draws"] > 0


def test_quad_pairs_are_the_loaders():
    _, _, cfg = scene_mesh.program(CONFIG, CPU)
    loaded = mesh.load(CONFIG)
    assert mesh.quad_pairs(loaded.verts) == cfg.quad_pairs
    assert len(cfg.quad_pairs) == 300
    plan = mesh.plan(loaded.verts)
    assert not plan.quads and not plan.leftovers
    assert sum(len(g[2]) + len(g[3]) for g in plan.groups) == 300


def test_config_is_the_committed_scene_file():
    spec = tomllib.loads(TOML.read_text())
    sc = CONFIG["scene"]
    assert sc["kind"] == "mesh" and sc["sky_sphere_index"] == -1
    assert sc["spheres"] == _sphere_rows(spec)
    assert sc["materials"] == spec["mesh"]["materials"]
    assert [sc["obj"], sc["mtl"]] == [
        str((TOML.parent / spec["mesh"][k]).relative_to(ROOT))
        for k in ("obj", "mtl")]
    cam = spec["camera"]
    assert CONFIG["camera"] == {
        "origin": cam["origin"], "target": cam["target"], "up": cam["up"],
        "vfov_deg": cam["vfov"], "aspect_ratio": 1200 / 900}
    r = CONFIG["render"]
    assert (r["width"], r["height"], r["spp"], r["max_bounces"]) == (
        spec["render"]["width"], spec["render"]["height"],
        spec["render"]["spp"], spec["render"]["bounces"])
    assert r["use_megakernel"] and r["merge_quads"]
    assert r["pixel_tile"] == 1200 * 900 and not r["bilinear_textures"]
    loaded = mesh.load(CONFIG)
    assert loaded.verts.shape == (600, 3, 3) and len(loaded.mats) == 11
    assert (ROOT / "portbench/configs/block600/tex/glass_alpha.ppm").is_file()
    scene, cam_, cfg = scene_mesh.program(CONFIG, CPU)
    assert scene.triangles.count == 600 and scene.mat_table.count == 11
    assert cfg.spp == 1000 and cfg.use_megakernel
    assert torch.equal(mesh.build(CONFIG)[1], trender.pack_camera(cam_))


@pytest.mark.parametrize("name", ["mesh.py", "mesh_work.py"])
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "portbench/reference" / name).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"raytpu_torch", "raytpu", "jax", "jaxlib"}


def test_harness_finds_the_cell():
    p = harness.plan(SPEC, CELL)
    assert p.config_file == ROOT / "portbench/configs/block600.json"
    assert p.mix_file == ROOT / "portbench/mixes/render.json"
    assert p.scene is scene_mesh and p.reference is mesh
    assert set(p.limits) == {"px_off_pct", "canvas_off_pct"}
    assert [m["name"] for m in p.end_to_end] == ["render_rays_per_s",
                                                 "setup_s"]
    out = subprocess.run([sys.executable, "-m", "portbench", "--list"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    line = [l for l in out.stdout.splitlines() if l.startswith(CELL + ":")]
    assert len(line) == 1
    assert ("config portbench/configs/block600.json mix "
            "portbench/mixes/render.json") in line[0]
    assert "scene portbench.scenes.mesh " in line[0]


METRICS = ["bounce_loop_roofline_pct.block600", "kernels_per_sample.block600",
           "idle_pct.block600", "mfu.block600", "mesh_tables_host_us",
           "frame_selection_ms", "search_candidates_per_tri"]
# a CPU run has no device trace to read
DEVICE_METRICS = {"bounce_loop_roofline_pct.block600",
                  "kernels_per_sample.block600", "idle_pct.block600"}


def test_traced_cpu_run_reports_its_metrics():
    p = harness.plan(SPEC, CELL, TINY)
    assert [m["name"] for m, _ in p.per_layer] == METRICS
    out, run = harness.run_cell(p, 2**33 + 11, 1.0, True, CPU,
                                time.perf_counter())
    assert out["correct"] is True
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    expected = set(METRICS) - DEVICE_METRICS
    if out["attempted"] == 1:
        # the profiled frame outlasted the window: the step's share of the
        # peak reads the frames after it
        expected.remove("mfu.block600")
    else:
        assert 0 < metrics["mfu.block600"] < 100
    assert set(metrics) == expected
    assert metrics["search_candidates_per_tri"] == 0.5
    assert metrics["mesh_tables_host_us"] > 0
    assert metrics["frame_selection_ms"] > 0
    c = run.counts
    counted = sum(len(a[1]) for a in run.answers)
    w = mesh.layer_work(run.plan.config, run.cfg.n_pixels, c, counted)
    scale = run.cfg.n_pixels / counted
    assert w["bounce_loop"].ops == pytest.approx(scale * (
        (c["live"] - c["tri"]) * 163 + c["draws"] * work.DRAW_OPS
        + c["tri"] * (mesh_work.TRI_TEST_OPS + mesh_work.TRI_SHADE_OPS)))


@pytest.mark.parametrize("how", ["control", "answer_altered", "half_batch"])
def test_control_and_faults_fail_the_limits(how):
    p = harness.plan(SPEC, CELL, TINY)
    fault = None if how == "control" else p.driver.FAULTS[how]
    run = p.driver.Run(p, 9, CPU, fault)
    run.setup(False)
    run.window(0.1)
    run.release()
    ok, checks = harness.judge(run.check(), p.limits)
    assert ok is (how == "control"), checks
    if how == "control":
        ok, checks = harness.judge(run.control(torch.bfloat16), p.limits)
        assert not ok, checks
