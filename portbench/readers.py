"""What the per-layer metric readers share. Each reader takes the run's
reading (the drivers' ``reading``: the profiled window reduced by
``device.Trace.reduce``, the units and samples in it, the work of each
layer a unit as the reference counted it, the host spans, and the
window's unprofiled part) and returns the metric, or None where the run
has nothing to read for it."""

from __future__ import annotations

from statistics import fmean

from portbench.reference import work


def kernels_per_sample(r):
    if not r.n_kernels or not r.samples_traced:
        return None
    return r.n_kernels / r.samples_traced


def roofline_pct(r, layer: str, kernels) -> float | None:
    """The layer's least time over the profiled units against the device
    time there of ``kernels`` (the program's kernels of the layer, by
    function name), in percent."""
    t = sum(r.kernel_s.get(k, 0.0) for k in kernels)
    w = r.work.get(layer)
    if not t or w is None or not r.units_traced:
        return None
    return 100.0 * w.least_s * r.units_traced / t


def idle_pct(r):
    if not r.window_s or not r.n_kernels:
        return None
    return 100.0 * max(0.0, 1.0 - r.busy_s / r.window_s)


def mfu_pct(r):
    """The operations every layer of a unit needs, over the unprofiled
    units' seconds at the card's issue limit, in percent."""
    if not r.untraced_units or not r.untraced_s:
        return None
    ops = sum(w.ops for w in r.work.values())
    return 100.0 * ops * r.untraced_units / (r.untraced_s * work.ISSUE_PER_S)


def mean_ms(values):
    return 1e3 * fmean(values) if values else None
