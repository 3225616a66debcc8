"""Build the CUDA sources under ``raytpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside
``csrc/`` (listed in ``.gitignore``), and loaded with ``ctypes``. The
library's file name carries a hash of the source, of the ``csrc/``
headers it includes (``#include "x.cuh"``, followed into the headers'
own includes) and of the flags, so an edited source or header is rebuilt
and a stale library is never loaded. ptxas's report of each build
(``-Xptxas -v``: registers, stack, spills and static shared memory of
each kernel) is kept beside its library, so ``ptxas_report`` holds for a
library built by an earlier process too.

No fast-math flags: the kernels keep IEEE ``sqrtf``/division and the
accurate ``cosf``/``sinf``, which the comparison with ``raytpu`` needs.
No FMA contraction either (``-fmad=false``): every product and sum is
rounded on its own, as in the plain PyTorch versions, whose elementwise
kernels round each operation. With contraction, K1's winners flipped
against the plain version on grazing hits, and K2's sphere-table
cotangent, a sum in which a few grazing hits weigh most, differed from
the plain version by up to a third of a row's largest entry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    quotes, directly or through another, each once, in the order met."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.
    ``verbose`` prints the compiler's report."""
    return build_all(verbose, [name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_all(verbose: bool = False, names=None) -> list[Path]:
    """Build ``csrc/<name>.cu`` for every name (default: every source), one
    ``nvcc`` per source, all started together and all waited for; returns
    the library paths, or raises after the last ``nvcc`` has ended."""
    if names is None:
        names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, proc, tmp, out))
    done = [(name, *proc.communicate(), proc.returncode, tmp, out)
            for name, proc, tmp, out in jobs]
    for name, stdout, stderr, rc, tmp, out in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) on {name}.cu:\n{stderr}")
        if verbose:
            print(f"{name}.cu: {stdout}{stderr}", flush=True)
        report = tmp.with_suffix(".ptxas.tmp")
        report.write_text(stderr)
        os.replace(report, _report_path(out))
        os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
    return outs


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas")


def ptxas_report(name: str) -> str:
    """ptxas's report (nvcc's stderr) of the library of ``csrc/<name>.cu``
    as built from the sources now on disk; raises if it was never built."""
    return _report_path(library_path(name)).read_text()


def func_attrs(query, *args) -> dict:
    """A library's ``*_attrs`` query (``cudaFuncGetAttributes`` of one
    kernel), called with ``args`` and an int[4] it fills."""
    out = (ctypes.c_int * 4)()
    err = query(*args, out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem"), out))
