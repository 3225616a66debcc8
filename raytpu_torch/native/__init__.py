"""ctypes bindings and the on-demand build of the C++ asset loaders.

Port of ``raytpu/native/__init__.py``. ``raytpu_native.cpp`` is a byte
copy of ``raytpu``'s: single-pass parsers of OBJ (``io.obj.parse_obj``'s
grammar) and ASCII P3 PPM (``io.ppm.read_ppm``'s), with the same arrays
as the pure-Python parsers, which stay the semantic reference.

``load()`` returns the shared library, compiling it with
``g++ -O3 -std=c++17 -shared -fPIC`` the first time, and again whenever
the source is newer than the library, into ``raytpu_torch/_build/``
(listed in ``.gitignore``), never beside the source. A build goes to a
file of its own process and is renamed into place, so processes that
build at once never load a half-written library. Without a toolchain it
returns None, and says so once on stderr: the callers (``io.obj``,
``io.ppm``) then use the Python parsers, which give the same arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "raytpu_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libraytpu_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    """Compile the library; None on success, else why it failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        return str(e)
    return None


def _fresh() -> bool:
    return (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC))


def load() -> Optional[ctypes.CDLL]:
    """The loaders' library, built if missing or older than its source;
    None (said once on stderr) when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        why = None if _fresh() else _build()
        if why is None:
            try:
                lib = ctypes.CDLL(_SO)
            except OSError as e:
                why = str(e)
        if why is not None:
            print(f"raytpu_torch: the native loaders are unavailable ({why});"
                  " the Python parsers serve OBJ and PPM", file=sys.stderr)
            return None

        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.obj_parse.restype = ctypes.c_int64
        lib.obj_parse.argtypes = [ctypes.c_char_p, i64p]
        lib.obj_fill.restype = None
        lib.obj_fill.argtypes = [
            ctypes.c_int64, f32p, f32p, i32p, i32p, i32p, ctypes.c_char_p]
        lib.ppm_parse.restype = ctypes.c_int64
        lib.ppm_parse.argtypes = [ctypes.c_char_p, i64p]
        lib.ppm_fill.restype = None
        lib.ppm_fill.argtypes = [ctypes.c_int64, f32p]
        _lib = lib
        return _lib


def parse_obj_native(path: str):
    """``io.obj.ObjMesh`` of ``path`` by the native parser, or None when
    the library is unavailable or the file cannot be read."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    counts = (ctypes.c_int64 * 6)()
    h = lib.obj_parse(path.encode(), counts)
    if h == 0:
        return None
    nv, nuv, nf, _, nb, _ = list(counts)
    vertices = np.empty((nv, 3), np.float32)
    uvs = np.empty((nuv, 2), np.float32)
    face_v = np.empty((nf, 3), np.int32)
    face_t = np.empty((nf, 3), np.int32)
    face_mat = np.empty((nf,), np.int32)
    names_buf = ctypes.create_string_buffer(int(nb) + 1)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    lib.obj_fill(h, ptr(vertices, ctypes.c_float), ptr(uvs, ctypes.c_float),
                 ptr(face_v, ctypes.c_int32), ptr(face_t, ctypes.c_int32),
                 ptr(face_mat, ctypes.c_int32), names_buf)
    raw = names_buf.raw[:nb].decode()
    from raytpu_torch.io.obj import ObjMesh

    return ObjMesh(vertices=vertices, uvs=uvs, face_v=face_v, face_t=face_t,
                   face_mat=face_mat, mat_names=raw.split("\n") if raw else [])


def read_ppm_native(path: str, bottom_up: bool = True):
    """(H, W, 3) float32 of an ASCII P3 PPM by the native parser (rows
    bottom-up unless ``bottom_up`` is False), or None when the library is
    unavailable or the parser refuses the file."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    dims = (ctypes.c_int64 * 2)()
    h = lib.ppm_parse(path.encode(), dims)
    if h == 0:
        return None
    w, ht = int(dims[0]), int(dims[1])
    rgb = np.empty((ht, w, 3), np.float32)
    lib.ppm_fill(h, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if bottom_up:
        rgb = np.ascontiguousarray(rgb[::-1])
    return rgb
