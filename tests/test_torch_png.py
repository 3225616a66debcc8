"""PNG through PIL in the port (``raytpu_torch.io.image``, the CLI's
outputs) against ``raytpu.io.image`` and ``raytpu.cli``.

Images are written from a numpy seed. Read: ``load_rgb`` and
``load_gray`` of RGB, RGBA, L and LA PNGs; ``load_png_alpha`` of each
(None without alpha); ``load_texture_pair``'s whole resolution
order (the PPM pair beside the named file, a PNG with an ``_alpha.png``,
a PNG's own alpha, opaque); ``build_atlas`` of PNG textures: all equal to
``raytpu``'s arrays exactly. Write: ``cli render --out x.png`` (with its
AOVs) and ``cli train`` with a PNG target and output, against the
canvases written as PPM and ``raytpu``'s ``_save``. Without PIL (as on
the card's machine) a PNG output fails before the render and names PIL.
The tests skip, with a reason, only where PIL is not installed.
"""

import os
import sys

import numpy as np
import pytest

from raytpu.io import image as jimage
from raytpu.io import obj as jobj
from raytpu_torch import cli
from raytpu_torch.io import image as timage
from raytpu_torch.io import obj as tobj
from raytpu_torch.io.ppm import read_ppm, write_ppm


@pytest.fixture
def Image():
    return pytest.importorskip("PIL.Image", reason="PIL is not installed")


def _png(Image, path, mode, seed, shape=(6, 9)):
    rs = np.random.default_rng(seed)
    chans = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    a = rs.integers(0, 256, shape + (chans,), dtype=np.uint8)
    Image.fromarray(a[..., 0] if chans == 1 else a, mode).save(path)
    return a


def _eq(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_read_rgb_gray_alpha_match_raytpu(Image, tmp_path, mode):
    p = str(tmp_path / f"t_{mode}.png")
    a = _png(Image, p, mode, {"RGB": 1, "RGBA": 2, "L": 3, "LA": 4}[mode])
    _eq(timage.load_rgb(p), jimage.load_rgb(p))
    _eq(timage.load_gray(p), jimage.load_gray(p))
    got, want = timage.load_png_alpha(p), jimage.load_png_alpha(p)
    if mode in ("RGBA", "LA"):
        _eq(got, want)
        np.testing.assert_array_equal(np.rint(got[::-1] * 255), a[..., -1])
    else:
        assert got is None and want is None
    if mode == "RGB":   # rows bottom-up, samples n * f32(1/255)
        _eq(timage.load_rgb(p), np.ascontiguousarray(
            (a * np.float32(1 / 255))[::-1]))


@pytest.mark.parametrize("case", ["ppm_pair", "ppm_opaque", "png_alpha_file",
                                  "png_own_alpha", "png_opaque"])
def test_texture_pair_resolution_order(Image, tmp_path, case):
    rs = np.random.default_rng(7)
    tex = str(tmp_path / "tex.png")
    if case.startswith("ppm"):
        write_ppm(str(tmp_path / "tex.ppm"), rs.integers(0, 256, (4, 5, 3)))
        if case == "ppm_pair":
            write_ppm(str(tmp_path / "tex_alpha.ppm"),
                      rs.integers(0, 256, (4, 5, 3)))
        _png(Image, tex, "RGBA", 8, (4, 5))     # not read: the PPM wins
    else:
        _png(Image, tex, "RGB" if case != "png_own_alpha" else "RGBA", 9,
             (4, 5))
        if case == "png_alpha_file":
            _png(Image, str(tmp_path / "tex_alpha.png"), "L", 10, (4, 5))
    got, want = timage.load_texture_pair(tex), jimage.load_texture_pair(tex)
    for g, w in zip(got, want):
        _eq(g, w)
    if case in ("ppm_opaque", "png_opaque"):
        assert (got[1] == 1).all()


def test_atlas_of_png_textures(Image, tmp_path):
    paths = []
    for i, mode in enumerate(("RGB", "RGBA", "RGB")):
        paths.append(str(tmp_path / f"m{i}.png"))
        _png(Image, paths[-1], mode, 20 + i, (8, 8))
    want = jobj.build_atlas(paths + [None], fallback_colors=[None] * 3
                            + [(0.2, 0.4, 0.6)])
    got = tobj.build_atlas(paths + [None], [None] * 3 + [(0.2, 0.4, 0.6)],
                           device="cpu")
    assert (got.width, got.height) == (want.width, want.height)
    for c in "xyz":
        _eq(getattr(got.rgb, c).numpy(), np.asarray(getattr(want.rgb, c)))
    _eq(got.alpha.numpy(), np.asarray(want.alpha))


SIZE = ["--device", "cpu", "--width", "12", "--height", "9", "--spp", "2",
        "--bounces", "3"]


def test_cli_render_png_and_aovs(Image, tmp_path):
    from raytpu.cli import _save as j_save

    png, ppm = str(tmp_path / "c.png"), str(tmp_path / "c.ppm")
    assert cli.main(["render", "cornell", *SIZE, "--aov", "--out", png]) == 0
    assert cli.main(["render", "cornell", *SIZE, "--aov", "--out", ppm]) == 0
    for suffix in ("", "_albedo", "_normal"):
        want = read_ppm(str(tmp_path / f"c{suffix}.ppm"), bottom_up=False)
        got = np.asarray(Image.open(str(tmp_path / f"c{suffix}.png")))
        assert got.shape == (9, 12, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.rint(want * 255))
        # raytpu's writer gives the same pixels
        j_save(str(tmp_path / "j.png"), np.rint(want * 255).astype(np.int32),
               None)
        np.testing.assert_array_equal(got, np.asarray(Image.open(
            str(tmp_path / "j.png"))))


def test_cli_train_png_target_and_output(Image, tmp_path, capsys):
    tgt = str(tmp_path / "t.png")
    assert cli.main(["render", "cornell", *SIZE, "--out", tgt]) == 0
    out = str(tmp_path / "fit.png")
    assert cli.main(["train", "cornell", *SIZE, "--target", tgt, "--steps",
                     "2", "--log-every", "1", "--out", out]) == 0
    assert "step    1" in capsys.readouterr().out
    assert np.asarray(Image.open(out)).shape == (9, 12, 3)
    _eq(timage.load_rgb(tgt), jimage.load_rgb(tgt))


def test_png_output_without_pil_fails_first(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(cli, "_setup", lambda args: pytest.fail(
        "the scene loaded before the output was checked"))
    out = str(tmp_path / "x.png")
    for argv in (["render", "cornell", *SIZE, "--out", out],
                 ["train", "cornell", *SIZE, "--target", "t.ppm", "--out",
                  out]):
        with pytest.raises(SystemExit, match=r"PIL.*\.ppm"):
            cli.main(argv)
    assert not os.listdir(tmp_path)
