"""Counter-based RNG: JAX's threefry2x32 stream, bit for bit.

Port of ``raytpu/core/rng.py``. Every draw is keyed by (pixel_id,
sample_id, slot) through ``fold_in`` chains exactly as ``raytpu`` keys it,
so the port's renders consume the same random numbers as the JAX package
and the two can be compared pixel by pixel.

uint32 arithmetic is emulated in int64 tensors masked with 0xFFFFFFFF
(torch has no uint32 arithmetic on every device); values stay in
[0, 2**32), so ``>>`` is a logical shift. Keys are (..., 2) int64 tensors
holding uint32 values, the layout of ``jax.random.PRNGKey``. The hash
follows JAX 0.9.0 (``jax/_src/prng.py``: ``_threefry2x32_lowering``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable`` with
``jax_threefry_partitionable=True``) and ``jax/_src/random.py:_uniform``.
"""

from __future__ import annotations

import torch
from torch import Tensor

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: Tensor, k2: Tensor, x1, x2) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2). All arguments broadcast; returns two uint32-valued int64
    tensors."""
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


def prng_key(seed: int, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: hash of the counter words (0, data).
    key (..., 2); data an int or an int tensor broadcasting against
    key[..., 0]. Returns (..., 2)."""
    if isinstance(data, Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y1, y2], dim=-1)


def _bits_to_unit_float(bits: Tensor) -> Tensor:
    """uint32 bits -> U[0, 1) f32: 23 mantissa bits under exponent 0
    (``random._uniform``; with minval 0 and maxval 1 its final
    ``max(0, f * 1 + 0)`` is the identity)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Tensor, shape) -> Tensor:
    """``jax.random.uniform(key, shape)`` for one key (2,): f32 in [0, 1)."""
    n = 1
    for d in shape:
        n *= d
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], 0, counts)
    return _bits_to_unit_float(y1 ^ y2).reshape(shape)


def pixel_keys(key: Tensor, pixel_ids: Tensor) -> Tensor:
    """One key per pixel: fold_in(key, pixel_id). (B,) -> (B, 2)."""
    return fold_in(key, pixel_ids)


def sample_keys(pix_keys: Tensor, sample_id: int) -> Tensor:
    """Per-(pixel, sample) keys. pix_keys (B, 2), int sample_id -> (B, 2)."""
    return fold_in(pix_keys, sample_id)


def ray_uniforms(
    ray_keys: Tensor, n_cam: int, n_bounce: int, max_bounces: int
) -> tuple[Tensor, Tensor]:
    """All U(0,1) draws a (pixel, sample) ray consumes: ``uniform(k,
    (total,))`` for each ray key, with draw j of bounce b at flat index
    n_cam + b * n_bounce + j (the layout ``raytpu`` and its f64 oracle
    share).

    The hash is evaluated directly in the (total, B) layout, so both
    results are contiguous without a transpose: cam_draws (n_cam, B),
    bounce_draws (max_bounces, n_bounce, B).
    """
    total = n_cam + max_bounces * n_bounce
    counts = torch.arange(total, dtype=torch.int64, device=ray_keys.device)
    y1, y2 = threefry2x32(
        ray_keys[:, 0], ray_keys[:, 1], 0, counts[:, None]
    )
    d = _bits_to_unit_float(y1 ^ y2)                     # (total, B)
    return d[:n_cam], d[n_cam:].view(max_bounces, n_bounce, -1)
