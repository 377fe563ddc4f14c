// Counter-based N(0, 1) pairs: the (seed, block) -> noise stream.
//
// Replaces dnn_mppi_mpc_tpu/ops/pallas/mathx.py:86 _splitmix32 and
// :96 hash_normal_pair. The integer part is bit-exact with the JAX package
// (uint32 arithmetic wraps the same way as jnp.uint32); the two normals then
// go through Box-Muller with full-precision logf/sqrtf/cosf/sinf, so they
// agree with the JAX and PyTorch versions to about one ulp of the transcendentals.
//
// Stream contract (mppi_tick_blocked.py:84-91): the sample at local index
// `local` of block `block` at step t uses counter t * k_blk + local, i.e.
// position (t, local / 128, local % 128) of hash_normal_pair(seed, block,
// (T, k_blk / 128, 128)).
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t dmm_splitmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-(seed, block) stream base; hoisted out of the per-step loop.
__device__ __forceinline__ uint32_t dmm_stream_base(uint32_t seed, uint32_t block) {
  return dmm_splitmix32((seed * 0x9E3779B9u) ^ dmm_splitmix32(block + 0x85EBCA6Bu));
}

__device__ __forceinline__ void dmm_hash_normal_pair(uint32_t base, uint32_t ctr,
                                                     float* z0, float* z1) {
  const uint32_t bits1 = dmm_splitmix32(base ^ (ctr * 0x9E3779B1u));
  const uint32_t bits2 = dmm_splitmix32(base ^ (ctr * 0xC2B2AE35u + 0x1234567u));
  const float scale = 1.0f / 16777216.0f;
  // top 24 bits -> u1 in (0, 1], u2 in [0, 1); both products are exact
  const float u1 = 1.0f - static_cast<float>(bits1 >> 8) * scale;
  const float u2 = static_cast<float>(bits2 >> 8) * scale;
  const float rad = sqrtf(-2.0f * logf(u1));
  const float ang = 6.28318530717958647692f * u2;  // float32(2*pi) * u2
  *z0 = rad * cosf(ang);
  *z1 = rad * sinf(ang);
}
