"""JAX's threefry2x32 stream in eager int64 PyTorch, bit for bit.

uint32 arithmetic is held in int64 tensors masked with 0xFFFFFFFF, so
``>>`` is a logical shift. A key is a (..., 2) int64 tensor of uint32
values, the layout of ``jax.random.PRNGKey``. A ray's key is
``fold_in(fold_in(key, pixel_id), sample_id)``; its draw ``c`` is the hash
of the counter words (0, c) under that key, turned into a float in
[0, 1) through 23 mantissa bits. Draws 0-3 make the camera ray; draw j of
bounce b is draw ``4 + b * n_draws + j``.
"""

from __future__ import annotations

import torch
from torch import Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: Tensor, k2: Tensor, x1, x2) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); every argument broadcasts."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(hi: int, lo: int, device=None) -> Tensor:
    """The (2,) key of two uint32 words; ``key(0, seed)`` is
    ``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return torch.tensor([hi & MASK, lo & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: k (..., 2), data an int or an int tensor
    that broadcasts against k[..., 0]."""
    if isinstance(data, Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack([y1, y2], dim=-1)


def unit_float(bits: Tensor) -> Tensor:
    """uint32 bits -> U[0, 1) f32 (``random._uniform``)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def ray_keys(k: Tensor, pixel_ids: Tensor, sample_ids) -> Tensor:
    """(B, 2) keys of the rays (pixel_ids[i], sample_ids[i]); sample_ids an
    int or a (B,) tensor."""
    return fold_in(fold_in(k, pixel_ids), sample_ids)


def draws(keys: Tensor, counters) -> Tensor:
    """(len(counters), B) draws of (B, 2) keys."""
    c = torch.as_tensor(counters, dtype=torch.int64,
                        device=keys.device).reshape(-1, 1)
    y1, y2 = threefry2x32(keys[:, 0], keys[:, 1], 0, c)
    return unit_float(y1 ^ y2)
