"""Variant builds of the keyed sphere kernels, timed on the card.

    python3 kernel_variants.py [--tree DIR ...]   # from the repo's root

Each variant is a copy of ``raytpu_torch/csrc`` with text substitutions
(``VARIANTS``), built with the port's nvcc flags and ``-Xptxas -v``, loaded
in place of the shipped library and timed with CUDA events at the Cornell
sample (1200x900 rays, 6 bounces, the RNG kernel's keys), beside the
shipped build in the same process; its ptxas registers and spill stores
are printed. A text that does not occur exactly once in its library's
sources stops the script before anything is built. Some variants compute wrong results on purpose, to measure
what a part of a kernel costs (``no_hash``: draws from the key bits
without threefry; ``sums_in_registers``: K2's table sums kept per lane).
``--tree DIR`` first times K1, K1's recording, K2 and K5 in another
checkout (for example the parent commit, unpacked by ``git archive``), in
a subprocess, with that tree's own API (ray keys, or a draw buffer), so
two versions compare in one call. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

# the draws of a key without threefry (wrong values, the same data flow)
_NO_HASH = ("    return uniform_draw(k0, k1, base + (uint32_t)j);",
            "    return __uint_as_float((((k0 ^ k1) + base + (uint32_t)j) >> 9)"
            " | 0x3F800000u) - 1.0f;")
_K2_BOUNDS = ("__launch_bounds__(kSphereThreads, kSphereMinBlocks)\n"
              "sphere_backward_kernel(")
_K5_BOUNDS = ("__launch_bounds__(kSphereThreads, kSphereMinBlocks)\n"
              "spheres_ad_kernel(")
_K2_SUM = ("    warp_table_sum(wsum, stage, lane, i < last && is_hit(bidx, ns), "
           "bidx, gw);\n  }\n  if (ray < n_rays) {\n    for (int j = 0; j < 3; "
           "++j) {\n      d_rays[j * B + ray] = g.o[j];")

# name -> (library, [(text, replacement), ...]); each text occurs once in
# the library's sources
VARIANTS = {
    "k1_no_hash": ("trace_spheres", [_NO_HASH]),
    "k1_no_early_exit": ("trace_spheres", [("if (!active && may_leave) {",
                                            "if (false) {")]),
    "k2_unbounded": ("trace_scene_bwd", [(_K2_BOUNDS, _K2_BOUNDS.replace(
        ", kSphereMinBlocks", ""))]),
    "k2_min_blocks_6": ("trace_scene_bwd", [(_K2_BOUNDS, _K2_BOUNDS.replace(
        "kSphereMinBlocks", "6"))]),
    "k2_no_hash": ("trace_scene_bwd", [_NO_HASH]),
    "k2_sums_in_registers": ("trace_scene_bwd", [(_K2_SUM, (
        "    if (i < last && is_hit(bidx, ns)) {\n      for (int r = 0; r < "
        "kRows; ++r) racc[r] += gw[r];\n    }\n  }\n  {\n    float t = 0.0f;\n"
        "    for (int r = 0; r < kRows; ++r) t += racc[r];\n    atomicAdd("
        "&sm.wsum[tid], t);\n  }\n  if (ray < n_rays) {\n    for (int j = 0; "
        "j < 3; ++j) {\n      d_rays[j * B + ray] = g.o[j];")), (
        "  float gw[kRows];\n  TriCot gt;\n  for (int i = k.bounces - 1;",
        "  float gw[kRows], racc[kRows] = {};\n  TriCot gt;\n  for (int i = "
        "k.bounces - 1;")]),
    "k5_unbounded": ("trace_spheres_bwd", [(_K5_BOUNDS, _K5_BOUNDS.replace(
        ", kSphereMinBlocks", ""))]),
}

# times K1, K1 recording, K2 and K5 at the Cornell sample with the API of
# the checkout it runs in
_TREE_TIMING = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
from raytpu_torch import scenes
from raytpu_torch.core import rng
from raytpu_torch.integrator.render import blocked_pixel_order, n_bounce_draws, sample_rays
from raytpu_torch.kernels import _build, trace_scene_bwd as tb, trace_spheres as ts
dev = torch.device("cuda", 0)
_build.build_all()
scene, cam, cfg = scenes.cornell_box(dev)
cfg = cfg.replace(width=1200, height=900, max_bounces=6)
pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
key = rng.prng_key(0, device=dev)
if hasattr(rng, "sample_stream"):
    src, cam_d = rng.sample_stream(key, pids, 0, 4)
else:
    cam_d, d = rng.ray_uniforms(rng.sample_keys(rng.pixel_keys(key, pids), 0), 4,
                                n_bounce_draws(cfg), 6)
    src = d.reshape(-1, pids.shape[0])
o, d = sample_rays(cam, cfg, pids, cam_d)
rays = tuple(t.contiguous() for t in (*o, *d))
sph = ts.pack_spheres(scene)
k = ts.Knobs.create(cfg, scene.spheres.count, n_bounce_draws(cfg))
_, idx, aof = ts._launch(sph, rays, src, k, record=True)
g = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
fns = {"k1": lambda: ts._launch(sph, rays, src, k),
       "k1_rec": lambda: ts._launch(sph, rays, src, k, record=True),
       "k2": lambda: tb.sphere_backward(sph, rays, src, idx, aof, g, k),
       "k5": lambda: ts._launch_ad(sph, rays, src, g, k)}
res = {}
for n, f in fns.items():
    f(); f()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(30):
        f()
    e.record(); torch.cuda.synchronize()
    res[n] = round(s.elapsed_time(e) / 30, 4)
print(json.dumps(res))
'''


def _time_ms(fn, iters=30):
    import torch

    fn(), fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cornell_sample():
    """(timed callables by library name) at the Cornell sample."""
    import numpy as np
    import torch

    from raytpu_torch import scenes
    from raytpu_torch.core import rng
    from raytpu_torch.integrator.render import (blocked_pixel_order,
                                                n_bounce_draws, sample_rays)
    from raytpu_torch.kernels import trace_scene_bwd as tb
    from raytpu_torch.kernels import trace_spheres as ts

    dev = torch.device("cuda", 0)
    scene, cam, cfg = scenes.cornell_box(dev)
    cfg = cfg.replace(width=1200, height=900, max_bounces=6)
    pids = torch.as_tensor(blocked_pixel_order(cfg), device=dev).long()
    keys, cam_d = rng.sample_stream(rng.prng_key(0, device=dev), pids, 0, 4)
    o, d = sample_rays(cam, cfg, pids, cam_d)
    rays = tuple(t.contiguous() for t in (*o, *d))
    sph = ts.pack_spheres(scene)
    k = ts.Knobs.create(cfg, scene.spheres.count, n_bounce_draws(cfg))
    _, idx, aof = ts._launch(sph, rays, keys, k, record=True)
    g = torch.tensor(np.random.default_rng(7).uniform(
        -1, 1, (9, cfg.n_pixels)).astype(np.float32), device=dev)
    return {"trace_spheres": lambda: ts._launch(sph, rays, keys, k),
            "trace_scene_bwd": lambda: tb.sphere_backward(sph, rays, keys, idx,
                                                          aof, g, k),
            "trace_spheres_bwd": lambda: ts._launch_ad(sph, rays, keys, g, k)}


def check_variants() -> None:
    """Each text a variant replaces occurs exactly once in its library's
    sources, so every variant builds what it says."""
    from raytpu_torch.kernels import _build

    for name, (lib, subs) in VARIANTS.items():
        text = "".join(p.read_text() for p in _build.sources(lib))
        for old, _ in subs:
            if text.count(old) != 1:
                raise SystemExit(f"kernel_variants: {name}: {old[:60]!r} "
                                 f"occurs {text.count(old)} times in {lib}")


def variant_source(root: str, lib: str, subs) -> None:
    """Apply the substitutions to the library's sources in the csrc copy
    under ``root``."""
    from raytpu_torch.kernels import _build

    for name in (p.name for p in _build.sources(lib)):
        path = os.path.join(root, name)
        text = open(path).read()
        for old, new in subs:
            text = text.replace(old, new)
        open(path, "w").write(text)


def main() -> int:
    import torch

    from raytpu_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout whose K1/K2/K5 to time first")
    args = ap.parse_args()
    check_variants()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    for tree in args.tree:
        out = subprocess.run([sys.executable, "-c", _TREE_TIMING], cwd=tree,
                             capture_output=True, text=True, check=True)
        print(f"tree {tree}: ms {out.stdout.strip().splitlines()[-1]}")
    _build.build_all()
    fns = _cornell_sample()
    shipped = {lib: _time_ms(fn) for lib, fn in fns.items()}
    print("shipped build: ms " + json.dumps(
        {lib: round(t, 4) for lib, t in shipped.items()}))
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, subs) in VARIANTS.items():
            src = os.path.join(tmp, name)
            shutil.copytree(_build.CSRC, src)
            variant_source(src, lib, subs)
            so = os.path.join(src, f"lib{lib}.so")
            r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                "-Xptxas", "-v", "-o", so,
                                os.path.join(src, f"{lib}.cu")],
                               capture_output=True, text=True, check=True)
            regs = re.findall(r"Used (\d+) registers", r.stderr)
            spills = re.findall(r"(\d+) bytes spill stores", r.stderr)
            shipped_lib = _build._loaded.get(lib)
            _build._loaded[lib] = ctypes.CDLL(so)
            ms = _time_ms(fns[lib])
            _build._loaded[lib] = shipped_lib
            again = _time_ms(fns[lib])
            print(f"{name}: {ms:.4f} ms (shipped {again:.4f} ms after it); "
                  f"ptxas registers {regs}, spill stores {spills}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
