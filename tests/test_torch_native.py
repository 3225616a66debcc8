"""The port's native C++ loaders (``raytpu_torch.native``) against its
pure-Python parsers and ``raytpu``'s.

On files the test writes from a numpy seed (the reference's assets are
absent, F1): OBJ (block worlds, faces with and without UV indices,
polygons, material slots, duplicate names) and ASCII P3 PPM (also with
``#`` comments), native and Python equal, and equal to ``raytpu``'s
parsers; ``RAYTPU_NO_NATIVE=1`` and ``use_native=False`` take the Python
parser; a missing file falls back to it (which raises). The build: into
``raytpu_torch/_build/``, again when the source is newer than the
library, and when it cannot build, the Python parsers serve and stderr
says so once. Adapted from ``tests/test_native.py``.
"""

import os

import numpy as np
import pytest

from raytpu.io.obj import parse_obj as j_parse_obj
from raytpu.io.ppm import read_ppm as j_read_ppm
from raytpu_torch import native
from raytpu_torch.io import obj as tobj
from raytpu_torch.io import ppm as tppm
from raytpu_torch.io.obj import parse_obj
from raytpu_torch.io.ppm import read_ppm, write_ppm
from raytpu_torch.scenes import write_block_world


def _same_mesh(a, b):
    for f in a._fields:
        if f == "mat_names":
            assert a.mat_names == b.mat_names
        else:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    """Two block worlds and a hand-made OBJ of every face form."""
    base = tmp_path_factory.mktemp("native")
    paths = [os.path.join(os.path.dirname(write_block_world(
        str(base / f"w{n}"), n, seed=n)), "block_world.obj") for n in (60, 600)]
    rs = np.random.default_rng(9)
    v = rs.uniform(-3, 3, (12, 3)).astype(np.float32)
    vt = rs.random((6, 2)).astype(np.float32)
    lines = [f"v {a!r} {b!r} {c!r}" for a, b, c in v.tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in vt.tolist()]
    lines += ["f 1 2 3", "usemtl red", "f 4/1 5/2 6/3 7/4",
              "f 8/5/1 9/6/1 10/1/1", "usemtl red\t ", "f 11//1 12//1 1//1",
              "usemtl blue", "f 2/2 3/3 4/4 5/5 6/6"]
    hand = base / "hand.obj"
    hand.write_text("\n".join(lines) + "\n")
    return paths + [str(hand)]


def test_library_builds_into_build_dir():
    lib = native.load()
    assert lib is not None
    assert os.path.dirname(native._SO) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("raytpu_torch", "_build"))
    assert os.path.exists(native._SO)
    assert not [f for f in os.listdir(os.path.dirname(native._SRC))
                if f.endswith(".so")]


def test_obj_native_matches_python_and_raytpu(objs):
    for path in objs:
        nat = native.parse_obj_native(path)
        assert nat is not None
        _same_mesh(nat, parse_obj(path, use_native=False))
        _same_mesh(nat, parse_obj(path))
        _same_mesh(nat, j_parse_obj(path, use_native=False))
    hand = parse_obj(objs[-1])
    assert hand.mat_names == ["red", "red", "blue"]
    np.testing.assert_array_equal(hand.face_mat, [-1, 0, 0, 0, 1, 2, 2, 2])


def _ppm_text(seed, comments):
    rs = np.random.default_rng(seed)
    rgb = rs.integers(0, 256, (5, 7, 3))
    head = "P3\n# made by gimp\n7 5 # inline\n255\n" if comments else \
        "P3\n7 5\n255\n"
    body = "\n".join(" ".join(map(str, px)) for px in rgb.reshape(-1, 3))
    if comments:
        body = "# row 0\n" + body
    return head + body + "\n", rgb


@pytest.mark.parametrize("comments", [False, True])
@pytest.mark.parametrize("bottom_up", [True, False])
def test_ppm_native_matches_python_and_raytpu(tmp_path, comments, bottom_up):
    text, rgb = _ppm_text(11 + comments, comments)
    p = str(tmp_path / "t.ppm")
    with open(p, "w") as f:
        f.write(text)
    got = read_ppm(p, bottom_up=bottom_up)
    want = read_ppm(p, bottom_up=bottom_up, use_native=False)
    assert got.dtype == want.dtype == np.float32 and got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_read_ppm(p, bottom_up=bottom_up,
                                                  use_native=False))
    top = got[::-1] if bottom_up else got
    np.testing.assert_array_equal(np.rint(top * 255), rgb)
    # comments in the header only: the native parser reads it itself
    nat = native.read_ppm_native(p, bottom_up=bottom_up)
    if not comments:
        np.testing.assert_array_equal(nat, want)


def test_written_ppm_reads_natively(tmp_path):
    rgb = np.random.default_rng(13).integers(0, 256, (9, 4, 3))
    p = str(tmp_path / "w.ppm")
    write_ppm(p, rgb)
    np.testing.assert_array_equal(native.read_ppm_native(p),
                                  read_ppm(p, use_native=False))


def test_no_native_env_and_flag_take_python(objs, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(native, "parse_obj_native",
                        lambda p: calls.append(p))
    monkeypatch.setattr(native, "read_ppm_native",
                        lambda p, bottom_up=True: calls.append(p))
    p = str(tmp_path / "t.ppm")
    write_ppm(p, np.zeros((2, 2, 3), np.int64))
    parse_obj(objs[0], use_native=False)
    read_ppm(p, use_native=False)
    assert calls == []
    monkeypatch.setenv("RAYTPU_NO_NATIVE", "1")
    parse_obj(objs[0])
    read_ppm(p)
    assert calls == []
    monkeypatch.setenv("RAYTPU_NO_NATIVE", "0")
    parse_obj(objs[0])
    read_ppm(p)
    assert calls == [objs[0], p]


def test_missing_file_falls_back():
    assert native.parse_obj_native("/nonexistent/x.obj") is None
    assert native.read_ppm_native("/nonexistent/x.ppm") is None
    with pytest.raises(FileNotFoundError):
        parse_obj("/nonexistent/x.obj", use_native=True)
    with pytest.raises(FileNotFoundError):
        read_ppm("/nonexistent/x.ppm", use_native=True)


def _fresh_state(monkeypatch, so):
    monkeypatch.setattr(native, "_SO", so)
    monkeypatch.setattr(native, "BUILD_DIR", os.path.dirname(so))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    so = str(tmp_path / "build" / "libraytpu_native.so")
    _fresh_state(monkeypatch, so)
    assert native.load() is not None and os.path.exists(so)
    first = os.stat(so).st_mtime_ns
    src = os.path.getmtime(native._SRC)
    os.utime(so, (src - 100, src - 100))     # older than the source
    _fresh_state(monkeypatch, so)
    assert native.load() is not None
    assert os.path.getmtime(so) >= src and os.stat(so).st_mtime_ns != first
    assert [f for f in os.listdir(tmp_path / "build")] == [os.path.basename(so)]


def test_no_toolchain_falls_back_once(objs, tmp_path, monkeypatch, capfd):
    _fresh_state(monkeypatch, str(tmp_path / "none" / "libraytpu_native.so"))
    monkeypatch.setenv("PATH", str(tmp_path))      # no g++
    assert native.load() is None and native.load() is None
    err = capfd.readouterr().err
    assert err.count("native loaders are unavailable") == 1, err
    _same_mesh(tobj.parse_obj(objs[0]), j_parse_obj(objs[0], use_native=False))
    p = str(tmp_path / "t.ppm")
    write_ppm(p, np.ones((2, 3, 3), np.int64))
    np.testing.assert_array_equal(tppm.read_ppm(p), j_read_ppm(
        p, use_native=False))
    assert capfd.readouterr().err == ""
