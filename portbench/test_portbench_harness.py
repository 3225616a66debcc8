"""The harness on the CPU: discovery by name, the contract's shape of
``BENCHMARK.json`` and of the result line, no fallback to the CPU, no
JAX or ``raytpu`` import anywhere in ``portbench/``, and ``correct``
false under the control and under each fault planted underneath a run.
The one test that needs a card is marked ``card`` and skips without
one."""

import ast
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import device, harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = harness.load_spec()
TINY = {"render": {"width": 16, "height": 12, "spp": 4, "pixel_tile": 192,
                   "max_bounces": 4},
        "mix": {"check_pixels": 24, "ref_block_pixels": 50}}
FORBIDDEN = {"jax", "jaxlib", "flax", "raytpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every import in a module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_raytpu(path):
    names = _imports(path)
    assert not names & FORBIDDEN, f"{path}: imports {names & FORBIDDEN}"
    if "reference" in path.parts:
        assert "raytpu_torch" not in names, f"{path} imports the program"


def test_loaded_forbidden_compares_whole_top_level_names():
    mods = ["raytpu_torch.kernels", "jax.numpy", "raytpu", "flax.linen",
            "jaxlib", "jaxtyping", "raytpu_torchx", "numpy"]
    assert device.loaded_forbidden(mods) == ["flax.linen", "jax.numpy",
                                             "jaxlib", "raytpu"]


def _spec_shape(spec):
    """The contract's keys, names and cross-references."""
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        reports = {m for m, e in e2e.items()
                   if w["name"] in e.get("workloads", [w["name"]])}
        assert "setup_s" in reports and len(reports) >= 2
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(spec["paths"][0] + "/")


def test_benchmark_json_keeps_the_contract_shape():
    _spec_shape(SPEC)
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    for w in SPEC["workloads"]:
        for entry, reader in harness.plan(SPEC, w["name"]).per_layer:
            assert callable(reader.read), entry["name"]


def test_a_metric_without_a_file_is_read_by_its_base_name():
    assert Path(harness.metric_reader("idle_pct.render").__file__).name == \
        "idle_pct.py"
    assert Path(harness.metric_reader("assemble_ms").__file__).name == \
        "assemble_ms.py"
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.render")


def test_list_finds_every_cell_by_name():
    out = subprocess.run([sys.executable, "-m", "portbench", "--list"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    assert [l.split(":")[0] for l in lines] == [w["name"] for w in
                                                 SPEC["workloads"]]
    for w, line in zip(SPEC["workloads"], lines):
        assert f"mix portbench/mixes/{w['traffic']}.json" in line
        p = harness.plan(SPEC, w["name"])
        for m, _ in p.per_layer:
            base = m["name"].split(".")[0]
            assert f"{m['name']}={base}.py" in line


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# a second scene kind: spheres listed under ``scene.objects``, so a driver
# that read ``scene.spheres`` or a sphere row would fail on it
STUB_SCENE = """
import copy

from portbench.scenes import spheres


def as_spheres(config):
    c = copy.deepcopy(config)
    c["scene"] = {"kind": "spheres", "sky_sphere_index": -1,
                  "spheres": c["scene"]["objects"]}
    return c


def program(config, dev):
    return spheres.program(as_spheres(config), dev)


def training_start(config, generator, perturb):
    start = spheres.training_start(as_spheres(config), generator, perturb)
    out = copy.deepcopy(config)
    out["scene"]["objects"] = start["scene"]["spheres"]
    return out
"""
STUB_REFERENCE = """
from portbench.reference import spheres
from portbench.scenes.stub import as_spheres

render_pixels = spheres.render_pixels


def build(config, device=None):
    return spheres.build(as_spheres(config), device)


def train_steps(config, *a, **k):
    return spheres.train_steps(as_spheres(config), *a, **k)


def layer_work(config, *a, **k):
    return spheres.layer_work(as_spheres(config), *a, **k)
"""
STUB_RUN = """
import json, time, torch
from portbench import harness
spec = harness.load_spec()
for w in ("stub_small.preview", "stub_small.train"):
    p = harness.plan(spec, w)
    out, _ = harness.run_cell(p, 2**33 + 5, 0.2, True, torch.device("cpu"),
                              time.perf_counter())
    print(json.dumps({"cell": w, "correct": out["correct"],
                      "per_layer": sorted(out["metrics"]),
                      "checks": sorted(out["checks"])}))
"""


def test_new_config_mix_metric_and_cell_are_picked_up(tmp_path):
    """A throwaway configuration of a second scene kind, a mix, a metric
    and two cells added as new files and entries of a copy: listed, and
    run on the CPU at a tiny size with ``correct`` true; no file already
    there is edited."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "cornell.json").read_text())
    cfg["name"] = "stub_small"
    cfg["scene"] = {"kind": "stub", "objects": cfg["scene"]["spheres"]}
    cfg["render"].update(TINY["render"])
    (pb / "configs" / "stub_small.json").write_text(json.dumps(cfg))
    (pb / "scenes" / "stub.py").write_text(STUB_SCENE)
    (pb / "reference" / "stub.py").write_text(STUB_REFERENCE)
    mix = json.loads((pb / "mixes" / "render.json").read_text())
    mix["check_pixels"] = 16
    (pb / "mixes" / "preview.json").write_text(json.dumps(mix))
    (pb / "metrics" / "frame_count.py").write_text(
        "def read(r):\n    return r.units_traced\n")
    (pb / "limits" / "stub_small.preview.json").write_text(
        json.dumps({"px_off_pct": 1.0}))
    (pb / "limits" / "stub_small.train.json").write_text(
        (pb / "limits" / "cornell.train.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub_small", "source": "https://x.y",
                            "file": "portbench/configs/stub_small.json",
                            "reduced": ["width", "height"], "why": "test"})
    for traffic in ("preview", "train"):
        spec["workloads"].append({"name": f"stub_small.{traffic}",
                                  "config": "stub_small",
                                  "traffic": traffic, "chips": 1,
                                  "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_rays_per_s":
            m["workloads"].append("stub_small.preview")
        if m["name"].startswith("train_step"):
            m["workloads"].append("stub_small.train")
    spec["per_layer"].append({
        "name": "frame_count", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "render_rays_per_s", "workloads": ["stub_small.preview"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    _spec_shape(spec)
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-m", "portbench", "--list"],
                         cwd=tmp_path, capture_output=True, text=True,
                         check=True, env=env)
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("stub_small.preview: config "
                                "portbench/configs/stub_small.json mix "
                                "portbench/mixes/preview.json")
    assert "scene portbench.scenes.stub" in lines[-2]
    assert "per_layer frame_count=frame_count.py" in lines[-2]
    assert lines[-1].startswith("stub_small.train: ")
    out = subprocess.run([sys.executable, "-c", STUB_RUN], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(l) for l in out.stdout.strip().splitlines()]
    assert runs == [
        {"cell": "stub_small.preview", "correct": True,
         "per_layer": ["frame_count"], "checks": ["px_off_pct"]},
        {"cell": "stub_small.train", "correct": True, "per_layer": [],
         "checks": ["change_gap", "grad_gap", "loss_gap"]}]
    after = _digest(pb)
    assert {k: after[k] for k in before} == before


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero with nothing on standard
    output; so it does in a directory holding only BENCHMARK.json and
    portbench/."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "cornell.render", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": ""})
        assert out.returncode != 0 and out.stdout == ""
        assert "no CUDA card" in out.stderr


def _run(workload, seed, fault=None, trace=False):
    p = harness.plan(SPEC, workload, TINY)
    return harness.run_cell(p, seed, 0.2, trace, torch.device("cpu"),
                            time.perf_counter(), fault)[0]


def _faults():
    """(cell, fault name) of every fault of every cell's driver."""
    return [(w["name"], name) for w in SPEC["workloads"]
            for name in harness.plan(SPEC, w["name"]).driver.FAULTS]


@pytest.mark.parametrize("workload", ["cornell.render", "cornell.train"])
def test_sound_run_is_correct_and_keeps_the_contract_keys(workload):
    for trace in (False, True):
        out = _run(workload, 2**31 + 77, trace=trace)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(out) == keys + (["breakdown"] if trace else []) + [
            "checks"]
        assert out["correct"] is True and out["attempted"] >= 1
        assert set(out["checks"]) == set(
            json.loads((HERE / "limits" / f"{workload}.json").read_text()))
        json.dumps(out)
    assert set(_run(workload, 5)["metrics"]) == {
        m["name"] for m in SPEC["end_to_end"]
        if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload,fault", _faults())
def test_fault_underneath_makes_correct_false(workload, fault):
    out = _run(workload, 31, harness.plan(SPEC, workload).driver.FAULTS[fault])
    assert out["correct"] is False


@pytest.mark.parametrize("workload", ["cornell.render", "cornell.train"])
def test_bfloat16_control_fails_the_limits(workload):
    p = harness.plan(SPEC, workload, TINY)
    run = p.driver.Run(p, 9, torch.device("cpu"))
    run.setup(False)
    run.window(0.1)
    run.release()
    ok, _ = harness.judge(run.check(), p.limits)
    assert ok
    ok, checks = harness.judge(run.control(torch.bfloat16), p.limits)
    assert not ok, checks


def test_judge_fails_what_is_not_finite():
    assert harness.judge({"a": 0.5}, {"a": 1.0})[0]
    assert not harness.judge({"a": math.nan}, {"a": 1.0})[0]
    assert not harness.judge({}, {"a": 1.0})[0]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["cornell.render", "cornell.train"])
def test_cell_on_the_card(workload, tmp_path):
    """A short run of each cell on the card, as the driver runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "4242", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_calibrate_reads_the_control_and_the_faults(tmp_path, capsys):
    """calibrate's summary at a tiny size: the sound runs under each
    limit, the control and each fault over one of the limits."""
    from portbench import calibrate

    out = tmp_path / "cal.jsonl"
    calibrate.main(["--workload", "cornell.render", "--seeds", "3", "4",
                    "--seconds", "0.1", "--control", "1", "--faults", "1",
                    "--device", "cpu", "--overrides", json.dumps(TINY),
                    "--out", str(out)])
    summary = json.loads(out.read_text().splitlines()[-1])["summary"]
    assert {k: v["lower"] for k, v in summary.items()} == {
        "px_off_pct": 0.0, "canvas_off_pct": 0.0}
    for fault in ("control_min", "fault_min answer_altered",
                  "fault_min half_batch"):
        assert any(v[fault] > v["limit"] for v in summary.values()), fault
