"""The port's own spans (``raytpu_torch.observe.span``) on the CPU.

* Under a ``torch.profiler``, a two-tile ``render_image`` and two
  ``step_fn`` calls emit every span of the frame, the sample loop and the
  train step, each inside its caller's span in the trace, with one call
  a tile or a sample (the sample's start and bounce loop again in the
  checkpoint's recompute; the frame's fetch once), and ``span_stats``
  counts what the trace holds.
* With no profiler recording (none, or one in its warm-up phase) a span
  is the shared no-op and the tally does not move; a second profiled
  session starts its tally from zero.
* The tally loses no update from many threads.
* The frame's sums and image, and the steps' losses and leaves, are
  bit-equal with and without a profiler.
* The benchmark's traced run reports each span metric, finite and above
  zero, in its own cell alone.
"""

import math
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from raytpu_torch import observe
from raytpu_torch.core.rng import prng_key
from raytpu_torch.integrator.render import render, render_image
from raytpu_torch.scenes import cornell_box
from raytpu_torch.train import make_train_step

SPP = 3
FRAME = ["render_image", "render_image.fetch", "render_image.scatter",
         "render_image.assemble", "render.sample_start",
         "render.bounce_loop", "render.accumulate"]
STEP = ["train.step", "train.forward", "train.backward", "train.adam",
        "render.sample_start", "render.bounce_loop", "render.accumulate"]


def _scene(n_tiles=2):
    scene, cam, cfg = cornell_box(device="cpu")
    cfg = cfg.replace(width=8, height=6, spp=SPP, max_bounces=3,
                      pixel_tile=48 // n_tiles)
    return scene, cam, cfg


@pytest.fixture(autouse=True)
def _between_sessions():
    """A span with no profiler recording, as a traced run's set-up opens
    before its profiled window: the next profiled span starts a new
    tally."""
    with observe.span("set-up"):
        pass


def _steps(scene, cam, cfg, n, seed=3):
    init_fn, step_fn = make_train_step(cfg, 0.01)
    state, static = init_fn(scene, cam)
    g = torch.Generator().manual_seed(seed)
    target = torch.rand((cfg.n_pixels, 3), generator=g)
    pids = torch.arange(cfg.n_pixels)
    losses = []
    for i in range(n):
        state, loss = step_fn(state, static, cam, pids, target,
                              prng_key(seed + i))
        losses.append(loss)
    return losses, state.params


def _profiled(work):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = work()
    spans = [e for e in prof.events()
             if e.name.startswith(("render", "train."))]
    return out, spans


def _inside(ev, parents) -> bool:
    a, b = ev.time_range.start, ev.time_range.end
    return any(p.time_range.start <= a and b <= p.time_range.end
               for p in parents)


def _check_tally(spans):
    """span_stats has the trace's calls of each span, and seconds that
    are positive and no more than the trace's time for it."""
    stats = observe.span_stats()
    calls = Counter(e.name for e in spans)
    assert {k: v[0] for k, v in stats.items()} == dict(calls)
    for name, (_, seconds) in stats.items():
        traced = sum(e.time_range.elapsed_us() for e in spans
                     if e.name == name) * 1e-6
        assert 0 < seconds <= traced, name


def test_frame_spans_nest_and_count():
    scene, cam, cfg = _scene(n_tiles=2)
    _, spans = _profiled(lambda: render_image(scene, cam, cfg, prng_key(1)))
    calls = Counter(e.name for e in spans)
    # the sums stay on the device: one fetch a frame, a scatter a tile
    assert calls == {"render_image": 1, "render_image.fetch": 1,
                     "render_image.scatter": 2, "render_image.assemble": 1,
                     "render.sample_start": 2 * SPP,
                     "render.bounce_loop": 2 * SPP,
                     "render.accumulate": 2 * SPP}
    frame = [e for e in spans if e.name == "render_image"]
    for ev in spans:
        if ev.name != "render_image":
            assert _inside(ev, frame), ev.name
    _check_tally(spans)


def test_step_spans_nest_and_count():
    """Two steps: the sample start and the bounce loop run spp times in
    the forward and spp times in the backward (the recompute)."""
    scene, cam, cfg = _scene()
    _, spans = _profiled(lambda: _steps(scene, cam, cfg, 2))
    by = lambda name: [e for e in spans if e.name == name]
    calls = Counter(e.name for e in spans)
    assert calls == {"train.step": 2, "train.forward": 2,
                     "train.backward": 2, "train.adam": 2,
                     "render.sample_start": 4 * SPP,
                     "render.bounce_loop": 4 * SPP,
                     "render.accumulate": 2 * SPP}
    for phase in ("train.forward", "train.backward", "train.adam"):
        assert all(_inside(e, by("train.step")) for e in by(phase)), phase
    for name in ("render.sample_start", "render.bounce_loop"):
        fwd = [e for e in by(name) if _inside(e, by("train.forward"))]
        bwd = [e for e in by(name) if _inside(e, by("train.backward"))]
        assert (len(fwd), len(bwd)) == (2 * SPP, 2 * SPP), name
    assert all(_inside(e, by("train.forward"))
               for e in by("render.accumulate"))
    _check_tally(spans)


def test_no_profiler_records_nothing():
    scene, cam, cfg = _scene()
    _profiled(lambda: render_image(scene, cam, cfg, prng_key(1)))
    before = observe.span_stats()
    off = observe.span("render_image")
    assert off is observe.span("train.step") and type(off).__name__ == "_Off"
    render_image(scene, cam, cfg, prng_key(2))
    _steps(scene, cam, cfg, 1)
    # a profiler in its warm-up phase records nothing either
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with prof:
        assert observe.span("render_image") is off
        render_image(scene, cam, cfg, prng_key(3))
    assert observe.span_stats() == before


def test_second_session_starts_from_zero():
    """As the benchmark's traced run: set-up without a profiler, a warm-up
    phase, then the recorded window; the tally holds that window alone,
    and a later session's only."""
    scene, cam, cfg = _scene(n_tiles=1)
    _profiled(lambda: _steps(scene, cam, cfg, 1))
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with prof:
        render_image(scene, cam, cfg, prng_key(1))   # warm-up phase
        prof.step()
        render_image(scene, cam, cfg, prng_key(2))   # recorded
        prof.step()
    stats = observe.span_stats()
    assert set(stats) == set(FRAME)
    assert stats["render_image"][0] == 1
    assert stats["render.sample_start"][0] == SPP
    render_image(scene, cam, cfg, prng_key(4))
    assert observe.span_stats() == stats
    _profiled(lambda: _steps(scene, cam, cfg, 1))
    stats = observe.span_stats()
    assert set(stats) == set(STEP) and stats["train.step"][0] == 1


def test_tally_loses_no_update_across_threads():
    n_threads, n_spans = 8, 400
    names = [f"t{i % 3}" for i in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with observe.span("main"):
                def work(name):
                    for _ in range(n_spans):
                        with observe.span(name):
                            pass
                threads = [threading.Thread(target=work, args=(n,))
                           for n in names]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    stats = observe.span_stats()
    assert {k: v[0] for k, v in stats.items()} == {
        "main": 1, **{k: v * n_spans for k, v in Counter(names).items()}}


def test_results_bit_equal_with_and_without_profiler():
    scene, cam, cfg = _scene()
    pids = torch.arange(cfg.n_pixels)

    def work():
        with torch.no_grad():
            sums = render(scene, cam, cfg, pids, prng_key(7))
        frame = render_image(scene, cam, cfg, prng_key(8))
        return sums, frame, _steps(scene, cam, cfg, 2)

    plain = work()
    traced, _ = _profiled(work)
    for field in ("radiance", "albedo", "normal"):
        a, b = getattr(plain[0], field), getattr(traced[0], field)
        assert torch.equal(a.to_array(), b.to_array()), field
    for a, b in zip(plain[1], traced[1]):
        np.testing.assert_array_equal(a, b)
    (la, pa), (lb, pb) = plain[2], traced[2]
    assert [float(x) for x in la] == [float(x) for x in lb]
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


SPAN_METRICS = {
    "cornell.render": ["sample_start_host_us", "bounce_loop_host_us",
                       "accumulate_host_us", "frame_fetch_ms",
                       "frame_scatter_ms", "frame_assemble_ms"],
    "cornell.train": ["forward_host_ms", "backward_host_ms",
                      "adam_host_ms"],
}
TINY = {"render": {"width": 8, "height": 6, "spp": 2, "pixel_tile": 48,
                   "max_bounces": 3},
        "mix": {"check_pixels": 12, "ref_block_pixels": 48}}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_cell_reports_its_span_metrics(workload):
    from portbench import harness

    spec = harness.load_spec()
    p = harness.plan(spec, workload, TINY)
    out, _ = harness.run_cell(p, 2**33 + 11, 0.1, True, torch.device("cpu"),
                              time.perf_counter())
    assert out["correct"] is True
    metrics = out["metrics"]
    for name in SPAN_METRICS[workload]:
        v = metrics[name]["value"]
        assert math.isfinite(v) and v > 0, name
    others = {n for w, ns in SPAN_METRICS.items() if w != workload
              for n in ns}
    assert not others & set(metrics)
    units = {m["name"]: m["unit"] for m in spec["per_layer"]}
    for name in SPAN_METRICS[workload]:
        assert metrics[name]["unit"] == units[name]
    # the untraced line keeps its keys
    untraced, _ = harness.run_cell(p, 2**33 + 11, 0.1, False,
                                   torch.device("cpu"), time.perf_counter())
    assert set(untraced["metrics"]) == {
        m["name"] for m in spec["end_to_end"]
        if workload in m.get("workloads", [workload])}


# ---- the mesh route's spans and counters ------------------------------------

MESH = ["render_image", "render_image.fetch", "render_image.scatter",
        "render_image.assemble", "render.frame_selection",
        "render.sample_start", "render.bounce_loop", "render.accumulate",
        "trace_scene.tables"]


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """A 60-triangle block world at 8x6, two tiles, K3's merged search."""
    from raytpu_torch.config import load_scene_file
    from raytpu_torch.scenes import write_block_world

    toml = write_block_world(str(tmp_path_factory.mktemp("bw")),
                             n_triangles=60, seed=3)
    scene, cam, cfg = load_scene_file(toml, "cpu")
    cfg = cfg.replace(width=8, height=6, spp=SPP, max_bounces=3,
                      pixel_tile=24, use_megakernel=True)
    return scene, cam, cfg


def _mesh_profiled(work):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = work()
    return out, [e for e in prof.events() if e.name in MESH]


def _mesh_counts(scene, cfg, calls: int) -> dict:
    """The counters of ``calls`` render calls: the world's triangles and
    its merged plan's candidates, each once a call."""
    from raytpu_torch.kernels.trace_scene import quad_plan

    p = quad_plan(cfg, scene.triangles.count)
    n = len(p.rects) + len(p.aa_tris) + len(p.quads) + len(p.leftovers)
    assert 0 < n < scene.triangles.count
    return {"trace_scene.triangles": calls * scene.triangles.count,
            "trace_scene.candidates": calls * n}


def test_mesh_spans_count_once_a_call_and_a_sample(mesh_scene):
    scene, cam, cfg = mesh_scene
    _, spans = _mesh_profiled(
        lambda: render_image(scene, cam, cfg, prng_key(1)))
    calls = Counter(e.name for e in spans)
    # a render call a tile: the selection once a call, the tables a sample
    assert calls == {"render_image": 1, "render_image.fetch": 1,
                     "render_image.scatter": 2, "render_image.assemble": 1,
                     "render.frame_selection": 2,
                     "render.sample_start": 2 * SPP,
                     "render.bounce_loop": 2 * SPP,
                     "render.accumulate": 2 * SPP,
                     "trace_scene.tables": 2 * SPP}
    by = lambda name: [e for e in spans if e.name == name]
    assert all(_inside(e, by("render.bounce_loop"))
               for e in by("trace_scene.tables"))
    assert all(_inside(e, by("render_image"))
               for e in by("render.frame_selection"))
    _check_tally(spans)
    assert observe.count_stats() == _mesh_counts(scene, cfg, 2)


def test_counters_record_only_under_a_profiler(mesh_scene):
    scene, cam, cfg = mesh_scene
    with profile(activities=[ProfilerActivity.CPU]):
        observe.count("c", 2)
        observe.count("c", 3)
    assert observe.count_stats() == {"c": 5}
    observe.count("c", 7)   # no profiler: nothing stored
    render_image(scene, cam, cfg, prng_key(2))
    assert observe.count_stats() == {"c": 5}
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with prof:
        observe.count("c", 11)   # warm-up phase: nothing stored
        prof.step()
        # the next recorded session starts the counters with the spans
        render_image(scene, cam, cfg, prng_key(3))
        prof.step()
    assert observe.count_stats() == _mesh_counts(scene, cfg, 2)
    assert observe.span_stats()["render.frame_selection"][0] == 2


def test_mesh_results_bit_equal_with_and_without_profiler(mesh_scene):
    scene, cam, cfg = mesh_scene
    pids = torch.arange(cfg.n_pixels)

    def work():
        with torch.no_grad():
            sums = render(scene, cam, cfg, pids, prng_key(7))
        return sums, render_image(scene, cam, cfg, prng_key(8))

    plain = work()
    traced, spans = _mesh_profiled(work)
    assert {e.name for e in spans} == set(MESH)
    for field in ("radiance", "albedo", "normal"):
        a, b = getattr(plain[0], field), getattr(traced[0], field)
        assert torch.equal(a.to_array(), b.to_array()), field
    for a, b in zip(plain[1], traced[1]):
        np.testing.assert_array_equal(a, b)
