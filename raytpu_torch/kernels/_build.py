"""Build the CUDA sources under ``raytpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside
``csrc/`` (listed in ``.gitignore``), and loaded with ``ctypes``. The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.

No fast-math flags: the kernels keep IEEE ``sqrtf``/division and the
accurate ``cosf``/``sinf``, which the comparison with ``raytpu`` needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
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


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) on {name}.cu:\n{res.stderr}"
        )
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_all(verbose: bool = False) -> list[Path]:
    """Build every ``csrc/*.cu``; returns the library paths."""
    return [build(p.stem, verbose) for p in sorted(CSRC.glob("*.cu"))]
