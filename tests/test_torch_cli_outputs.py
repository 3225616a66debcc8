"""The render command's output path in raytpu_torch: the progress monitor
and its preview, the profiler trace, ``cli render`` with every output
flag on the CPU (the denoised canvas against the library calls'), and the
small parity pieces (``checker_value``, ``AABB`` / ``build_aabb`` /
``hit_aabb``), each against raytpu on the same inputs.
"""

import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.types import RenderConfig as JConfig
from raytpu.core.vec3 import Vec3 as JVec3
from raytpu.observe import RenderMonitor as JMonitor
from raytpu_torch import cli
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.observe import RenderMonitor, trace_profile

SIZE = ["--width", "24", "--height", "18", "--spp", "4", "--bounces", "3"]


def _read_ints(path):
    """A P3 PPM's samples as ints (H, W, 3), rows as stored (top first)."""
    tok = open(path).read().split()
    assert tok[0] == "P3" and tok[3] == "255"
    w, h = int(tok[1]), int(tok[2])
    return np.array(tok[4:], np.int64).reshape(h, w, 3)


def test_monitor_lines():
    cfg = RenderConfig(width=8, height=4, spp=10, max_bounces=3)
    buf = io.StringIO()
    RenderMonitor(cfg, out=buf).update(5)
    line = buf.getvalue()
    assert re.fullmatch(r"\[render\] 5/10 spp \(50\.0%\)  \d+\.\d Mrays/s  "
                        r"elapsed \d+\.\ds  eta \d+\.\ds\n", line), line
    buf = io.StringIO()
    mon = RenderMonitor(cfg, out=buf, structured=True)
    mon.update(10)
    rec = json.loads(buf.getvalue())
    assert list(rec) == ["samples", "spp", "elapsed_s", "rays_per_s", "eta_s"]
    assert rec["samples"] == 10 and rec["spp"] == 10
    assert rec["rays_per_s"] > 0 and rec["eta_s"] == 0.0
    assert mon.rays_per_sample == 8 * 4 * 3
    # the same keys as raytpu's JSON line
    jbuf = io.StringIO()
    JMonitor(JConfig(width=8, height=4, spp=10), out=jbuf,
             structured=True).update(10)
    assert list(json.loads(jbuf.getvalue())) == list(rec)


def test_preview_equals_raytpus(tmp_path):
    """The port's PPM preview has the pixels of raytpu's PNG preview of
    the same sums; a preview is written once ``preview_every`` samples
    have passed since the last."""
    from PIL import Image

    cfg = RenderConfig(width=8, height=4, spp=4, max_bounces=2)
    sums = np.random.default_rng(0).uniform(0, 4, (cfg.n_pixels, 3)).astype(
        np.float32)
    png, ppm = str(tmp_path / "prev.png"), str(tmp_path / "prev.ppm")
    JMonitor(JConfig(width=8, height=4, spp=4, max_bounces=2),
             out=io.StringIO(), preview_path=png, preview_every=1).update(
        2, sums=sums)
    mon = RenderMonitor(cfg, out=io.StringIO(), preview_path=ppm,
                        preview_every=2)
    mon.update(1, sums=sums)
    assert not os.path.exists(ppm)
    mon.update(2, sums=sums)
    np.testing.assert_array_equal(_read_ints(ppm), np.asarray(Image.open(png)))
    with pytest.raises(ValueError, match="ppm"):
        RenderMonitor(cfg, preview_path=png)


def test_trace_profile(tmp_path):
    with trace_profile(None):
        pass
    with trace_profile("", device="cpu"):
        pass
    d = tmp_path / "prof"
    with trace_profile(str(d), device="cpu"):
        torch.ones(8).cumsum(0)
    (trace,) = list(d.iterdir())
    assert trace.name.startswith("trace_") and trace.suffix == ".json"
    assert json.loads(trace.read_text())["traceEvents"]


def _library_canvas(denoiser):
    """What ``cli render cornell`` at SIZE writes with ``--denoise``,
    through the library calls."""
    from raytpu_torch.config import load_scene
    from raytpu_torch.core.color import quantize, tonemap
    from raytpu_torch.core.rng import prng_key
    from raytpu_torch.integrator.render import render_image

    scene, cam, cfg = load_scene("cornell", device="cpu")
    cfg = cfg.replace(width=24, height=18, spp=4, max_bounces=3)
    out = render_image(scene, cam, cfg, prng_key(0))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with torch.no_grad():
        img = denoiser(t(out.image), t(out.albedo), t(out.normal))
    return out, quantize(tonemap(Vec3.from_array(img))).to_array().numpy()


def test_cli_render_outputs(tmp_path, capsys):
    """Every output flag: --scene, bare --denoise (the bilateral), --aov,
    --checkpoint, --flush-every, --preview, --log-json, --profile-dir."""
    from raytpu_torch.denoise import denoise

    p = lambda name: str(tmp_path / name)
    assert cli.main(["render", "--scene", "cornell", "--device", "cpu", *SIZE,
                     "--denoise", "--aov", "--checkpoint", p("ck.npz"),
                     "--flush-every", "2", "--preview", p("prev.ppm"),
                     "--log-json", "--profile-dir", p("prof"),
                     "--out", p("o.ppm")]) == 0
    out, want = _library_canvas(denoise)
    assert not np.array_equal(want, out.canvas)        # it denoised
    np.testing.assert_array_equal(_read_ints(p("o.ppm")), want)
    for name in ("albedo", "normal"):
        np.testing.assert_array_equal(
            _read_ints(p(f"o_{name}.ppm")),
            np.clip(np.abs(getattr(out, name)) * 255.0, 0, 255).astype(int))
    np.testing.assert_array_equal(_read_ints(p("prev.ppm")), out.canvas)
    assert int(np.load(p("ck.npz"))["samples_done"]) == 4
    assert os.path.exists(p("ck.npz.json"))
    (trace,) = os.listdir(p("prof"))
    assert json.loads(open(os.path.join(p("prof"), trace)).read())
    lines = capsys.readouterr().err.splitlines()
    progress = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["samples"] for r in progress] == [2, 4]
    assert not any(ln.startswith("[render]") for ln in lines)


def test_cli_render_learned_default_name(tmp_path, monkeypatch, capsys):
    """--denoise learned, text progress lines, and the default output
    name with raytpu's date stamp; a preview must be a .ppm."""
    from raytpu_torch.denoise.learned import denoise_learned

    monkeypatch.chdir(tmp_path)
    assert cli.main(["render", "cornell", "--device", "cpu", *SIZE,
                     "--denoise", "learned", "--checkpoint", "ck.npz",
                     "--flush-every", "2"]) == 0
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".ppm")]
    assert re.fullmatch(r"cornell_4RAYS_2RB_\d\d-\d\d_\d\dh\d\d\.ppm", name)
    np.testing.assert_array_equal(_read_ints(name),
                                  _library_canvas(denoise_learned)[1])
    err = capsys.readouterr().err
    assert "[render] 2/4 samples checkpointed" in err
    assert "[render] 4/4 spp (100.0%)" in err
    with pytest.raises(SystemExit):
        cli.main(["render", "cornell", "--device", "cpu", *SIZE,
                  "--checkpoint", "ck2.npz", "--preview", "prev.png"])


def _vec(*rows):
    a = np.array(rows, np.float32)
    return (JVec3(*(jnp.asarray(a[:, k]) for k in range(3))),
            Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def test_checker_value_matches_raytpu():
    from raytpu.materials.texture import checker_value as j_checker
    from raytpu_torch.materials.texture import checker_value as t_checker

    pts = np.random.default_rng(0).uniform(-3, 3, (64, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [-0.5, 0.5, 1.0], [0.25, -0.25, -0.75],
               [1.0, 1.0, 1.0]]
    jp, tp = _vec(*pts)
    jc1, tc1 = _vec((1.0, 0.0, 0.0))
    jc2, tc2 = _vec((0.0, 0.0, 1.0))
    for scale in (0.5, 0.3):
        want = j_checker(jc1, jc2, scale, jp)
        got = t_checker(tc1, tc2, scale, tp)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert 0 < got.x.sum() < len(pts)          # both colors appear


def test_aabb_matches_raytpu():
    """tests/test_geometry.py's TestAABB cases and random rays."""
    from raytpu.core.types import Triangles as JTris
    from raytpu.geometry.triangle import build_aabb as j_build
    from raytpu.geometry.triangle import hit_aabb as j_hit
    from raytpu_torch.core.types import Triangles as TTris
    from raytpu_torch.geometry.triangle import AABB, build_aabb, hit_aabb

    def tris(verts):
        (ja, ta), (jb, tb), (jc, tc) = (_vec(*[v[k] for v in verts])
                                        for k in range(3))
        jz, tz = jnp.zeros((len(verts),)), torch.zeros(len(verts))
        ji, ti = jnp.zeros(len(verts), jnp.int32), torch.zeros(
            len(verts), dtype=torch.int32)
        return (JTris(ja, jb, jc, jz, jz, jz, jz, jz, jz, ji),
                TTris(ta, tb, tc, tz, tz, tz, tz, tz, tz, ti))

    rng = np.random.default_rng(1)
    cases = [
        ([((-1, -1, -3), (1, -1, -3), (0, 1, -3))],
         [(0, 0, 0), (0, 5, 0)], [(0, 0, -1), (0, 0, -1)], [True, False]),
        ([((-1, -1, -1), (1, -1, -1), (0, 1, 1))],
         [(0, 0, 0)], [(1, 0, 0)], [True]),
        ([tuple(map(tuple, rng.uniform(-1, 1, (3, 3)))) for _ in range(5)],
         [tuple(o) for o in rng.uniform(-3, 3, (64, 3))],
         [tuple(d) for d in rng.normal(size=(64, 3))], None),
    ]
    for verts, orig, dirs, want in cases:
        jt, tt = tris(verts)
        jbox, tbox = j_build(jt), build_aabb(tt)
        assert isinstance(tbox, AABB)
        for a, b in zip((*jbox.mn, *jbox.mx), (*tbox.mn, *tbox.mx)):
            assert float(a) == b.item()
        (jo, to), (jd, td) = _vec(*orig), _vec(*dirs)
        got = hit_aabb(to, td, tbox).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_hit(jo, jd, jbox)))
        if want is not None:
            np.testing.assert_array_equal(got, want)
        else:
            assert 0 < got.sum() < len(orig)
