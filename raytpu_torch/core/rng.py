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

``sample_stream`` is what ``render`` calls once per sample: each ray's key
``fold_in(fold_in(key, pixel_id), sample_id)`` as (2, B) int32 words
(uint32 bits; ``key_words`` / ``key_pairs`` convert) and the first
``n_rows`` draws of that key. On CUDA tensors it launches the RNG kernel
(``csrc/rng.cu``, hashing in native uint32 with ``csrc/threefry.cuh``); on
CPU tensors it runs the eager code above, its plain version. The sphere
kernels (K1, K2's sphere mode, K5) take the keys and hash their bounce
draws themselves (``draws_at`` is their per-draw formula); K3 and the scan
path read every row.
"""

from __future__ import annotations

import ctypes

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


def key_words(keys: Tensor) -> Tensor:
    """(B, 2) int64 keys -> (2, B) int32 words holding the same uint32
    bits: the key planes the kernels read (8 B a ray)."""
    k = keys.T
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()


def key_pairs(words: Tensor) -> Tensor:
    """(2, B) int32 words -> (B, 2) int64 keys (``key_words``' inverse)."""
    return (words.to(torch.int64) & MASK).T


def draws_at(ray_keys: Tensor, counters) -> Tensor:
    """Draw c of each ray key for each counter c: (len(counters), B) f32,
    the hash of (0, c) under the key as ``uniform`` makes it, so that
    ``draws_at(k, range(n))`` is ``ray_uniforms``' flat layout and draw j
    of bounce b is counter ``4 + b * n_draws + j``: the formula each
    thread of the keyed kernels evaluates (``csrc/threefry.cuh``).
    ray_keys: (2, B) int32 words."""
    k = key_pairs(ray_keys)
    c = torch.as_tensor(counters, dtype=torch.int64,
                        device=ray_keys.device).reshape(-1, 1)
    y1, y2 = threefry2x32(k[:, 0], k[:, 1], 0, c)
    return _bits_to_unit_float(y1 ^ y2)


def is_keys(src: Tensor) -> bool:
    """Whether a kernel's draw source holds ray keys ((2, B) int32 words)
    rather than a draw buffer (f32)."""
    return src.dtype == torch.int32


def bounce_draws(ray_keys: Tensor, n_draws: int, bounces: int) -> Tensor:
    """The (bounces * n_draws, B) bounce draws of the keys, counters
    4 .. 4 + bounces * n_draws - 1: the buffer the plain versions of the
    keyed kernels read for the draws those kernels hash."""
    return draws_at(ray_keys, range(4, 4 + bounces * n_draws))


def plain_draws(src: Tensor, n_draws: int, bounces: int) -> Tensor:
    """The (bounces * n_draws, B) draws of a kernel's draw source: the
    keys' bounce draws (``bounce_draws``), or the draw buffer itself."""
    return bounce_draws(src, n_draws, bounces) if is_keys(src) else src


launches = 0   # RNG kernel launches by sample_stream (CPU calls do not count)


def _launch(key: Tensor, pixel_ids: Tensor, sample_id: int, n_rows: int):
    """Launch ``csrc/rng.cu`` on the current stream: (ray keys (2, B)
    int32, draws (n_rows, B) f32)."""
    from raytpu_torch.kernels import _build

    global launches
    dev = pixel_ids.device
    for t, shape in ((key, (2,)), (pixel_ids, (pixel_ids.shape[0],))):
        if (t.dtype != torch.int64 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"rng kernel: want contiguous int64 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    b = pixel_ids.shape[0]
    fn = _build.load("rng").raytpu_rng_sample
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_uint,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    keys = torch.empty((2, b), dtype=torch.int32, device=dev)
    draws = torch.empty((n_rows, b), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(key.data_ptr(), pixel_ids.data_ptr(), b, sample_id & MASK,
                 n_rows, keys.data_ptr(),
                 draws.data_ptr() if n_rows else None, stream)
    if err != 0:
        raise RuntimeError(f"rng kernel launch failed: cudaError {err}")
    launches += 1
    return keys, draws


def stream_reference(key: Tensor, pixel_ids: Tensor, sample_id: int,
                     n_rows: int) -> tuple[Tensor, Tensor]:
    """Plain version of the RNG kernel: ``sample_stream``'s result from the
    eager int64 threefry above, on any device."""
    keys = key_words(sample_keys(pixel_keys(key, pixel_ids), sample_id))
    return keys, draws_at(keys, range(n_rows))


def sample_stream(key: Tensor, pixel_ids: Tensor, sample_id: int,
                  n_rows: int) -> tuple[Tensor, Tensor]:
    """The keys and draws of one sample: (ray keys (2, B) int32 words of
    ``sample_keys(pixel_keys(key, pixel_ids), sample_id)``, their draws
    0 .. n_rows-1 (n_rows, B) f32). key: (2,) int64 (``prng_key``) on the
    device of ``pixel_ids`` (B,) int64. The RNG kernel for CUDA tensors,
    the plain version (``stream_reference``) for CPU tensors."""
    dev = pixel_ids.device
    if dev.type == "cuda":
        return _launch(key, pixel_ids, sample_id, n_rows)
    if dev.type == "cpu":
        return stream_reference(key, pixel_ids, sample_id, n_rows)
    raise NotImplementedError(f"rng: no kernel for {dev}")
