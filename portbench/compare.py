"""The numbers that decide ``correct``: what the timed path produced
against the plain reference's answer to the same inputs.

Frames: the checked pixels of every frame of the window (a sample of
pixels drawn from the seed, each at the frame's full sample count).

- ``px_off_pct``: the share of checked pixels whose mean radiance differs
  from the reference's by more than 1e-6 + 1e-5 |reference| in a channel
  (a NaN differs);
- ``canvas_off_pct``: the share whose 8-bit canvas differs.

Training: the first steps of the step function the window drives, from
the same start, keys and target as the reference's.

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the gap between the norms of the
  program's first gradient (as Adam holds it after one step) and the
  reference's, over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the same of the leaves' change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's: a leaf with no gradient moves under Adam by round-off
  alone.
"""

from __future__ import annotations

import math

import numpy as np

PX_ATOL, PX_RTOL = 1e-6, 1e-5
QUIET_LEAF = 1e-3


def frame_numbers(img, canvas, ref_img, ref_canvas) -> dict:
    """img, ref_img (N, 3) f32 and canvas, ref_canvas (N, 3) int of the N
    checked pixels of all frames."""
    img, ref_img = np.asarray(img, np.float64), np.asarray(ref_img, np.float64)
    off = ~(np.abs(img - ref_img) <= PX_ATOL + PX_RTOL * np.abs(ref_img))
    c_off = np.asarray(canvas) != np.asarray(ref_canvas)
    n = max(1, img.shape[0])
    return {"px_off_pct": 100.0 * off.any(axis=1).sum() / n,
            "canvas_off_pct": 100.0 * c_off.any(axis=1).sum() / n}


def _norms(leaves: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in leaves.items()}


def _gap(a: float, b: float, den: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    if a == b:
        return 0.0
    return abs(a - b) / den if den > 0 else math.inf


def train_numbers(losses, grad1: dict, change: dict, ref_losses,
                  ref_grad1: dict, ref_change: dict) -> dict:
    """Each of the program's and the reference's: the checked steps'
    losses, the first gradient and the change by leaf name."""
    loss_gap = max((_gap(float(a), float(b), abs(float(b)))
                    for a, b in zip(losses, ref_losses)), default=math.inf)
    if len(losses) != len(ref_losses):
        loss_gap = math.inf
    g, gr = _norms(grad1), _norms(ref_grad1)
    med_g = float(np.median(list(gr.values())))
    grad_gap = max(_gap(g.get(k, math.inf), v, max(v, med_g)) for k, v in
                   gr.items())
    keep = [k for k, v in gr.items()
            if v >= QUIET_LEAF * med_g and v > 0]
    c, cr = _norms(change), _norms(ref_change)
    med_c = float(np.median([cr[k] for k in keep])) if keep else 0.0
    change_gap = max((_gap(c.get(k, math.inf), cr[k], max(cr[k], med_c))
                      for k in keep), default=math.inf)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
