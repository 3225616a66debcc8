"""Observability: progress lines, rays/s, previews and profiler traces.

Port of ``raytpu/observe.py``:

  * :class:`RenderMonitor`: a progress line after every flushed batch,
    with rays/s (pixels x samples x bounces over wall seconds), percent
    done and ETA, as text or as one JSON object a line, and an optional
    preview of the running mean. The preview is a ``.ppm``
    (``io/ppm.write_ppm``), the port's one output format: the card's
    machine has no PIL.
  * :func:`trace_profile`: ``torch.profiler`` around a block, CPU activity
    plus CUDA on a CUDA device, written as a Chrome trace JSON into a
    directory.

``raytpu``'s ``enable_compilation_cache`` (a persistent XLA cache) has no
counterpart: the port compiles nothing at run time but its CUDA kernel
libraries, and those are built once and kept in ``raytpu_torch/_build/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from raytpu_torch.core.color import quantize, tonemap
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.io.ppm import write_ppm


class RenderMonitor:
    """Tracks one render's samples and prints a line per update.

    >>> mon = RenderMonitor(cfg)
    >>> mon.update(samples_done=64)   # after each flushed batch
    """

    def __init__(self, cfg: RenderConfig, out=None,
                 preview_path: Optional[str] = None, preview_every: int = 0,
                 structured: bool = False):
        if preview_path and not preview_path.endswith(".ppm"):
            raise ValueError(f"preview {preview_path}: raytpu_torch writes "
                             "only .ppm images")
        self.cfg = cfg
        self.out = out  # None: sys.stderr at each line (bound late)
        self.preview_path = preview_path
        self.preview_every = preview_every
        self.structured = structured
        self.t0 = time.perf_counter()
        self.samples_done = 0
        self._last_preview = 0

    @property
    def rays_per_sample(self) -> int:
        return self.cfg.n_pixels * self.cfg.max_bounces

    def update(self, samples_done: int, sums: Optional[np.ndarray] = None
               ) -> None:
        """One progress line; a preview of ``sums`` ((n_pixels, 3) radiance
        sums) when ``preview_every`` samples have passed since the last."""
        self.samples_done = samples_done
        elapsed = time.perf_counter() - self.t0
        rps = samples_done * self.rays_per_sample / elapsed if elapsed > 0 \
            else 0.0
        frac = samples_done / self.cfg.spp
        eta = elapsed * (1 - frac) / frac if frac > 0 else float("inf")
        if self.structured:
            line = json.dumps({
                "samples": samples_done, "spp": self.cfg.spp,
                "elapsed_s": round(elapsed, 2),
                "rays_per_s": round(rps, 1), "eta_s": round(eta, 1),
            })
        else:
            line = (f"[render] {samples_done}/{self.cfg.spp} spp "
                    f"({100 * frac:.1f}%)  {rps / 1e6:.1f} Mrays/s  "
                    f"elapsed {elapsed:.1f}s  eta {eta:.1f}s")
        print(line, file=self.out or sys.stderr, flush=True)
        if (self.preview_path and self.preview_every and sums is not None
                and samples_done - self._last_preview >= self.preview_every):
            self._last_preview = samples_done
            self.write_preview(sums, samples_done)

    def write_preview(self, rad_sums: np.ndarray, samples_done: int) -> None:
        """The tone-mapped mean of ``rad_sums`` ((n_pixels, 3) radiance sums
        over ``samples_done`` samples), top row first, as a PPM."""
        h, w = self.cfg.height, self.cfg.width
        mean = rad_sums.reshape(h, w, 3) / max(samples_done, 1)
        toned = tonemap(Vec3.from_array(torch.from_numpy(mean)))
        canvas = quantize(toned).to_array().numpy().astype(np.int32)[::-1]
        write_ppm(self.preview_path, canvas)


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str], device=None):
    """``torch.profiler`` over the block, its trace written into
    ``log_dir`` as ``trace_<time>_<pid>.json`` (Chrome trace format, for
    Perfetto or chrome://tracing). CPU activity, plus CUDA when ``device``
    is a CUDA device. A no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"))
