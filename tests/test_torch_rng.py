"""raytpu_torch.core.rng against raytpu.core.rng / jax.random: the port's
threefry2x32 stream must reproduce JAX's bits exactly (tolerance: none),
because whole-render comparisons rest on both packages drawing the same
random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core import rng as jrng
from raytpu_torch.core import rng as trng


def _keys(seed, n):
    """n random uint32 key pairs: (numpy uint32 for JAX, int64 for torch)."""
    k = np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.uint32)
    return k, torch.tensor(k.astype(np.int64))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key_matches(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(trng.prng_key(seed).numpy(), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_fold_in_matches(seed):
    kj, kt = _keys(seed, 64)
    data = np.random.default_rng(seed + 100).integers(
        0, 2**32, 64, dtype=np.uint32)
    data[:4] = [0, 1, 2**31 - 1, 2**32 - 1]
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(kj), jnp.asarray(data))
    got = trng.fold_in(kt, torch.tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    # scalar data, as sample_keys passes it
    want1 = np.asarray(jax.random.fold_in(jnp.asarray(kj[3]), 999))
    np.testing.assert_array_equal(trng.fold_in(kt[3], 999).numpy(),
                                  want1.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (22,), (37,), (3, 5)])
def test_uniform_matches(shape):
    kj, kt = _keys(3, 8)
    for a, b in zip(kj, kt):
        want = jax.random.uniform(jnp.asarray(a), shape)
        got = trng.uniform(b, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pixel_and_sample_keys_match():
    rs = np.random.default_rng(5)
    ids = rs.integers(0, 1200 * 900, 200).astype(np.int32)
    ids[:2] = [0, 1200 * 900 - 1]
    key = jax.random.PRNGKey(11)
    pj = jrng.pixel_keys(key, jnp.asarray(ids))
    pt = trng.pixel_keys(trng.prng_key(11), torch.tensor(ids))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj).astype(np.int64))
    for s in (0, 7, 999):
        np.testing.assert_array_equal(
            trng.sample_keys(pt, s).numpy(),
            np.asarray(jrng.sample_keys(pj, s)).astype(np.int64),
        )


@pytest.mark.parametrize("n_bounce,max_bounces", [(3, 1), (3, 6), (5, 4), (7, 5)])
def test_ray_uniforms_match(n_bounce, max_bounces):
    kj, kt = _keys(9, 33)
    cj, bj = jrng.ray_uniforms(jnp.asarray(kj), 4, n_bounce, max_bounces)
    ct, bt = trng.ray_uniforms(kt, 4, n_bounce, max_bounces)
    assert tuple(ct.shape) == (4, 33)
    assert tuple(bt.shape) == (max_bounces, n_bounce, 33)
    assert ct.is_contiguous() and bt.is_contiguous()
    np.testing.assert_array_equal(_bits(ct.numpy()), _bits(cj))
    np.testing.assert_array_equal(_bits(bt.numpy()), _bits(bj))
