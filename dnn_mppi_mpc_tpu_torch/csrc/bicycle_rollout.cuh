// Race-car MPPI rollout: the device function of both bicycle kernels.
//
// Semantics of the Pallas bicycle rollout body (dnn_mppi_mpc_tpu/ops/pallas/
// rollout_bicycle.py:122-167, bicycle_tick.py:183-246), in its order of
// operations: exploration split on global sample indices, NaN-propagating
// in-rollout clamp, Euler kinematic-bicycle step with tanf(steer) and the
// pre-step yaw and speed, yaw wrapped to [0, 2π) as yaw − 2π·floor(yaw/2π),
// running-min nearest waypoint over the (W, 4) window with the first-strict-<
// rule, the 4-term tracking cost (or, with ISO, w0·dmin + w2·Δyaw² + w3·Δv²),
// the 9-point vehicle outline against the obstacle circles at the post-step
// pose (×penalty), the energy row a_t·v, SUM accumulation and the terminal
// cost.
//
// Layout: one thread per sample k carries (x, y, yaw, v, S) in registers
// through the T loop, and the sin/cos of its yaw: the post-step values of
// step t (which the outline needs) are the pre-step values of step t + 1, so
// each step calls sincosf once. ε is read from (T, K, 2) so neighbouring
// threads read neighbouring addresses. The library is built with
// -fmad=false, so every a*b+c rounds twice, like the plain PyTorch version.
#pragma once

#include <cstdint>

#include "hash_normal.cuh"

constexpr int kOutlinePoints = 9;

// Argument block of dmm_bicycle_rollout_costs and dmm_bicycle_tick. Field
// order is mirrored by DmmBicycleArgs in dnn_mppi_mpc_tpu_torch/_build.py:
// pointers, then 32-bit ints, then floats. Row-major float32 unless noted.
struct DmmBicycleArgs {
  // inputs
  const long long* seed;    // (1,) int64 holding the uint32 tick seed
  const float* u;           // (T, 2) nominal (steer, accel)
  const float* a;           // (T, 2) energy rows γ·u_tᵀΣ⁻¹
  const float* chol;        // (2, 2) lower Cholesky factor of Σ
  const float* x0;          // (4,) (x, y, yaw, v)
  const float* window;      // (W, 4) waypoint window (x, y, yaw, v)
  const float* stage_w;     // (4,)
  const float* term_w;      // (4,)
  const float* u_min;       // (2,)
  const float* u_max;       // (2,)
  const float* obstacles;   // (n_obs, 3) circles (x, y, r)
  // ε buffer (T, K, 2): read (eps_mode 0) or written (eps_mode 1)
  float* eps;
  // outputs
  float* S;                 // (K,)
  float* w;                 // (K,)
  float* w_eps;             // (T, 2)
  float* stats;             // (2,) rho, eta
  // sizes and modes
  int K, T, W, n_obs;
  int eps_mode;             // 0 read, 1 generate (one hash block of K) and store
  int iso_xy;
  float dt, n_exploit, k_offset, inv_temp;
  float inv_wheel_base;     // 1 / L
  float half_l, half_w;     // 0.5·length·margin, 0.5·width·margin
  float penalty;            // collision cost
  float outline_x[kOutlinePoints], outline_y[kOutlinePoints];  // unit body outline
};

__device__ __forceinline__ float dmm_bicycle_clip(float v, float lo, float hi) {
  // jnp.clip / torch.clamp semantics: NaN passes through
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Stage cost at pose (x, y, yaw, v) with sin/cos (s, c) of yaw: tracking
// against the window's running-min row, plus the outline test. `win` is the
// (W, 4) window in shared memory, one float4 per row.
template <bool ISO>
__device__ __forceinline__ float dmm_bicycle_cost(const DmmBicycleArgs& p, float x, float y,
                                                  float yaw, float v, float c, float s,
                                                  const float4& wgt, const float4* win,
                                                  const float* obs) {
  const float two_pi = 6.28318530717958647692f;  // float32(2π)
  // running min over the window, first-strict-< rule
  float4 row = win[0];
  float dx = x - row.x;
  float dy = y - row.y;
  float dmin = dx * dx + dy * dy;
  float rx = row.x, ry = row.y, ryaw = row.z, rv = row.w;
  for (int i = 1; i < p.W; ++i) {
    row = win[i];
    dx = x - row.x;
    dy = y - row.y;
    const float d = dx * dx + dy * dy;
    if (d < dmin) {
      dmin = d;
      ryaw = row.z;
      rv = row.w;
      if (!ISO) {
        rx = row.x;
        ry = row.y;
      }
    }
  }
  const float yaw_w = yaw - two_pi * floorf(yaw / two_pi);
  const float eyaw = yaw_w - ryaw;
  const float ev = v - rv;
  float cost;
  if (ISO) {
    cost = wgt.x * dmin + wgt.z * eyaw * eyaw + wgt.w * ev * ev;
  } else {
    const float ex = x - rx;
    const float ey = y - ry;
    cost = wgt.x * ex * ex + wgt.y * ey * ey + wgt.z * eyaw * eyaw + wgt.w * ev * ev;
  }
  if (p.n_obs > 0) {
    float hit = 0.0f;
    for (int j = 0; j < kOutlinePoints; ++j) {
      const float bx = p.outline_x[j] * p.half_l;
      const float by = p.outline_y[j] * p.half_w;
      const float px = bx * c - by * s + x;
      const float py = bx * s + by * c + y;
      for (int o = 0; o < p.n_obs; ++o) {
        const float ox = px - obs[3 * o];
        const float oy = py - obs[3 * o + 1];
        const float r = obs[3 * o + 2];
        if (ox * ox + oy * oy < r * r) hit = 1.0f;
      }
    }
    cost = cost + hit * p.penalty;
  }
  return cost;
}

// The cost S of sample k. `su`, `sa`, `swin`, `sobs` are the block's shared
// copies of u, a, the window and the obstacles. GEN draws ε from the hash
// stream as one block of K samples and stores it to p.eps.
template <bool ISO, bool GEN>
__device__ float dmm_bicycle_sample(const DmmBicycleArgs& p, int k, const float* su,
                                    const float* sa, const float4* swin, const float* sobs) {
  const int T = p.T, K = p.K;
  const float dt = p.dt, inv_L = p.inv_wheel_base;
  const float4 sw = make_float4(p.stage_w[0], p.stage_w[1], p.stage_w[2], p.stage_w[3]);
  const float4 tw = make_float4(p.term_w[0], p.term_w[1], p.term_w[2], p.term_w[3]);
  const float smin = p.u_min[0], smax = p.u_max[0];
  const float amin = p.u_min[1], amax = p.u_max[1];
  const bool exploit = static_cast<float>(k) + p.k_offset < p.n_exploit;

  uint32_t base = 0;
  float l00 = 0.0f, l10 = 0.0f, l11 = 0.0f;
  if (GEN) {
    base = dmm_stream_base(static_cast<uint32_t>(p.seed[0]), 0u);
    l00 = p.chol[0];
    l10 = p.chol[2];
    l11 = p.chol[3];
  }

  float x = p.x0[0], y = p.x0[1], yaw = p.x0[2], v = p.x0[3];
  float s, c;
  sincosf(yaw, &s, &c);
  float S = 0.0f;
  for (int t = 0; t < T; ++t) {
    float e0, e1;
    const size_t at = static_cast<size_t>(t) * K + k;
    if (GEN) {
      float z0, z1;
      dmm_hash_normal_pair(base, static_cast<uint32_t>(at), &z0, &z1);
      e0 = l00 * z0;
      e1 = l10 * z0 + l11 * z1;
      reinterpret_cast<float2*>(p.eps)[at] = make_float2(e0, e1);
    } else {
      const float2 e = reinterpret_cast<const float2*>(p.eps)[at];
      e0 = e.x;
      e1 = e.y;
    }
    float st = exploit ? su[2 * t] + e0 : e0;
    float ac = exploit ? su[2 * t + 1] + e1 : e1;
    st = dmm_bicycle_clip(st, smin, smax);
    ac = dmm_bicycle_clip(ac, amin, amax);

    x = x + v * c * dt;
    y = y + v * s * dt;
    yaw = yaw + v * inv_L * tanf(st) * dt;
    v = v + ac * dt;
    sincosf(yaw, &s, &c);

    float cost = dmm_bicycle_cost<ISO>(p, x, y, yaw, v, c, s, sw, swin, sobs);
    cost = cost + sa[2 * t] * st + sa[2 * t + 1] * ac;
    S = S + cost;
  }
  return S + dmm_bicycle_cost<ISO>(p, x, y, yaw, v, c, s, tw, swin, sobs);
}
