"""The reference's training steps, for any scene kind: the L2 photometric
loss of the frame's mean radiance against a target, its gradient in the
scene's parameter table by autograd through the kind's ``trace_rays``,
and Adam with optax's defaults.

``trace_rays(table, key, pixel_ids, sample_ids, counts)`` is the kind's
differentiable trace: the (3, B) radiance of the rays (pixel_ids[i],
sample_ids[i]) under the frame key. The frame is rendered in blocks of
pixels whose gradients add up, so the reference fits beside whatever the
process already holds.
"""

from __future__ import annotations

import torch
from torch import Tensor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def loss_and_grad(trace_rays, table: Tensor, k: Tensor, spp: int,
                  target: Tensor, block: int, counts: dict | None = None):
    """(loss, d loss / d table, f32): the mean over the (N, 3) target of
    (mean radiance - target)^2, the frame's pixels 0 .. N-1 rendered with
    ``spp`` samples under key ``k``."""
    p = table.detach().clone().requires_grad_()
    n = target.shape[0]
    total = 0.0
    for b0 in range(0, n, block):
        ids = torch.arange(b0, min(n, b0 + block), device=target.device)
        nb = ids.shape[0]
        sids = torch.arange(spp, device=ids.device).repeat_interleave(nb)
        rad = trace_rays(p, k, ids.repeat(spp), sids,
                         counts).float().view(3, spp, nb)
        acc = torch.zeros((3, nb), dtype=torch.float32, device=ids.device)
        for t in range(spp):
            acc = acc + rad[:, t]
        diff = (acc * (1.0 / spp)).T - target[b0:b0 + nb]
        part = (diff * diff).sum() / (3 * n)
        part.backward()
        total += float(part.detach())
        del rad, acc, diff, part
    return total, p.grad


def adam(p: Tensor, g: Tensor, m: Tensor, v: Tensor, t: int, lr: float):
    """Step ``t`` (from 1) of Adam: (p, m, v) after gradient ``g``."""
    b1, b2 = ADAM_BETAS
    m = m + (g - m) * (1 - b1)
    v = v * b2 + g * g * (1 - b2)
    denom = torch.sqrt(v) / (1 - b2 ** t) ** 0.5 + ADAM_EPS
    return p - (lr / (1 - b1 ** t)) * m / denom, m, v


def steps(trace_rays, table: Tensor, keys, spp: int, target: Tensor,
          lr: float, block: int, counts: dict | None = None):
    """Adam steps from ``table``, one a key of ``keys``: (the loss of each
    step before its update, the first step's gradient, the table's change
    over all the steps)."""
    p = table.detach().clone().float()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    losses, g1 = [], None
    for t, k in enumerate(keys, start=1):
        loss, g = loss_and_grad(trace_rays, p, k, spp, target, block,
                                counts)
        losses.append(loss)
        g1 = g if g1 is None else g1
        p, m, v = adam(p, g, m, v, t, lr)
    return losses, g1, p - table.float()
