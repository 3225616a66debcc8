"""The card: what it is, what a run used of it, and what its trace says.

``PowerLimit`` reads the card's power limit; ``Trace``
wraps ``torch.profiler`` around a part of the window and reduces it to
device busy time, time and launches by kernel, and the idle gaps by what
the host was doing. Nothing here falls back to the CPU: a run that finds
no card stops before it prints a result.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "raytpu")


def loaded_forbidden(modules) -> list[str]:
    """Names among ``modules`` whose top-level name, the part before the
    first dot, is one of ``FORBIDDEN`` (``raytpu_torch`` is not
    ``raytpu``)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class PowerLimit:
    """``nvidia-smi``'s power limit of card 0, asked for at once and read
    later, so that the query does not wait inside the run's set-up."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError as e:
            self.proc, self.why = None, f"unknown ({type(e).__name__})"

    def read(self) -> str:
        """The limit; waits for the query (30 s at most) and ends it."""
        if self.proc is None:
            return self.why
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            out = ""
        finally:
            self.close()
        lines = out.strip().splitlines()
        self.why = (lines[0].strip() if self.proc.returncode == 0 and lines
                    else "unknown")
        self.proc = None
        return self.why

    def close(self) -> None:
        """Ends the query if it still runs, and waits for it."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def short_name(kernel: str) -> str:
    """A kernel's function name: no return type, namespace, template
    arguments or argument list (``void ns::k<4, F>(int)`` is ``k``)."""
    if kernel.startswith(("Memcpy", "Memset")):
        return kernel.split("(")[0].strip()
    k = kernel.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in k:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).split("(")[0].split()
    return s[-1].split("::")[-1] if s else kernel


class Trace:
    """``torch.profiler`` over part of the window. ``warm_up`` opens it and
    runs its warm-up step (its events are dropped: a window opened cold
    loses kernels); ``start`` and ``stop`` bound the active window."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0

    def warm_up(self, work) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1))
        self.prof.__enter__()
        work()
        self._sync()

    def start(self) -> None:
        self._sync()
        self.prof.step()
        self._t0 = time.perf_counter()
        self._events = self._event(), None

    def stop(self) -> None:
        end = self._event()
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._events = self._events[0], end
        self.prof.step()
        self.prof.__exit__(None, None, None)

    def span(self, name: str):
        """A host span named ``name`` in the profiled window."""
        from torch.profiler import record_function

        return record_function(name)

    def _event(self):
        """A CUDA event recorded now, or None without a card."""
        if not self.torch.cuda.is_available():
            return None
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def reduce(self, max_gaps: int = 500) -> dict:
        """busy_s (the union of the device's operations), time and count
        by kernel name, the device operations that took most time, and
        the longest idle gaps between device operations by the innermost
        host event that spans each gap's middle."""
        cuda = self.torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.name.startswith("ProfilerStep"):
                continue
            if ev.device_type != cuda:
                host.append((tr.start, tr.end, ev.name))
            elif not getattr(ev, "is_user_annotation", False):
                dev.append((tr.start, tr.end, ev.name))
        # a host span's name on the device's timeline is its annotation
        named = {h[2] for h in host}
        dev = [d for d in dev if d[2] not in named]
        kernel_s, kernel_n = defaultdict(float), defaultdict(int)
        for s, e, name in dev:
            kernel_s[short_name(name)] += (e - s) * 1e-6
            kernel_n[short_name(name)] += 1
        busy_s, gaps = 0.0, []
        if dev:
            iv = sorted((s, e) for s, e, _ in dev)
            cur_s, cur_e = iv[0]
            for s, e in iv[1:]:
                if s > cur_e:
                    busy_s += cur_e - cur_s
                    gaps.append((cur_e, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy_s = (busy_s + cur_e - cur_s) * 1e-6
        idle = defaultdict(float)
        if gaps and host:
            hs = np.array([h[0] for h in host], np.float64)
            he = np.array([h[1] for h in host], np.float64)
            for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:max_gaps]:
                mid = 0.5 * (a + b)
                cover = np.nonzero((hs <= mid) & (he >= mid))[0]
                name = ("no host event" if cover.size == 0 else
                        host[cover[np.argmin(he[cover] - hs[cover])]][2])
                idle[name] += (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        a, b = self._events
        return {"busy_s": busy_s, "window_s": self.window_s,
                "events_s": a.elapsed_time(b) * 1e-3 if a else None,
                "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
                "n_kernels": sum(kernel_n.values()),
                "breakdown": {"device_ops": top(kernel_s),
                              "idle_gaps": top(idle)}}
