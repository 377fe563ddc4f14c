"""The hash noise stream of the port against the JAX package's.

The integer part (splitmix finalizer, stream words) must match bit for bit;
the normals go through log/sqrt/sin/cos of two libraries and agree within
1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu.ops.pallas import mathx as jmathx
from dnn_mppi_mpc_tpu_torch.ops.cuda import mathx as tmathx


def _jax_bits(seed, block, shape):
    """The two uint32 words of jmathx.hash_normal_pair, computed as it does."""
    s = jnp.asarray(seed).astype(jnp.uint32)
    b = jnp.asarray(block).astype(jnp.uint32)
    base = jmathx._splitmix32(s * jnp.uint32(0x9E3779B9) ^ jmathx._splitmix32(b + jnp.uint32(0x85EBCA6B)))
    ctr = jnp.arange(int(np.prod(shape)), dtype=jnp.uint32).reshape(shape)
    bits1 = jmathx._splitmix32(base ^ (ctr * jnp.uint32(0x9E3779B1)))
    bits2 = jmathx._splitmix32(base ^ (ctr * jnp.uint32(0xC2B2AE35) + jnp.uint32(0x1234567)))
    return np.asarray(bits1).astype(np.int64), np.asarray(bits2).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_splitmix_bits_exact(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 0xFFFFFFFF]
    want = np.asarray(jmathx._splitmix32(jnp.asarray(x))).astype(np.int64)
    got = tmathx.splitmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


CASES = [(1234, 0, (4, 2, 128)), (0xFFFFFFFF, 7, (3, 1, 128)), (0x80000001, 123456, (2, 4, 128))]


@pytest.mark.parametrize("seed, block, shape", CASES)
def test_hash_stream_bits_exact(seed, block, shape):
    want1, want2 = _jax_bits(seed, block, shape)
    got1, got2 = tmathx.hash_bits(seed, block, shape)
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(got2.numpy(), want2)


@pytest.mark.parametrize("seed, block, shape", CASES)
def test_hash_normal_pair_matches(seed, block, shape):
    # the JAX seed is the int32 bit pattern of the uint32 seed
    jseed = np.array(seed, np.uint32).view(np.int32)
    w0, w1 = jmathx.hash_normal_pair(jnp.asarray(jseed), jnp.asarray(block, jnp.int32), shape)
    g0, g1 = tmathx.hash_normal_pair(seed, block, shape)
    assert g0.dtype == torch.float32 and g0.shape == shape
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k_blk", [256, 1024])
def test_hash_noise_layout_matches_blocked_stream(k_blk):
    """Sample k = b·K_BLK + r·128 + lane at step t is position (t, r, lane)
    of block b's stream, colored by the Cholesky factor."""
    K, T, seed = 1024, 5, 99
    chol = torch.tensor([[0.3, 0.0], [0.05, 0.2]])
    eps = tmathx.hash_noise(seed, chol, K, T, k_blk)
    assert eps.shape == (K, T, 2)
    for b in range(K // k_blk):
        z0, z1 = jmathx.hash_normal_pair(jnp.asarray(seed, jnp.int32), jnp.asarray(b, jnp.int32),
                                          (T, k_blk // 128, 128))
        z0 = np.asarray(z0).reshape(T, k_blk).T
        z1 = np.asarray(z1).reshape(T, k_blk).T
        blk = eps[b * k_blk:(b + 1) * k_blk].numpy()
        np.testing.assert_allclose(blk[..., 0], 0.3 * z0, rtol=0, atol=1e-6)
        np.testing.assert_allclose(blk[..., 1], 0.05 * z0 + 0.2 * z1, rtol=0, atol=1e-6)
