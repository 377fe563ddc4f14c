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
// Layout: a group of G consecutive lanes of a warp (G = 8 or 16, a template
// constant) shares one sample k. Every lane of the group runs the dynamics
// on the same inputs, so every lane holds the same (x, y, yaw, v, S) and the
// sin/cos of the yaw, bit for bit: the post-step values of step t (which the
// outline needs) are the pre-step values of step t + 1, so each step calls
// sincosf once. The window search is split: lane j keeps the running min of
// rows i ≡ j (mod G), then log2 G xor-shuffle rounds merge the partials into
// the sequential scan's row (dmm_window_row, window_search.cuh, shared with
// the diff-drive rollout); the 9 outline points are dealt over
// the lanes (each tested against every obstacle) and ORed by a ballot. With hash ε, lane j draws the steps
// t ≡ j (mod G) of its sample (the stream's counters unchanged) and hands
// each out by shuffle at its step. ε is read from and written to (T, K, 2).
// The library is built with -fmad=false, so every a*b+c rounds twice, like
// the plain PyTorch version.
#pragma once

#include <cmath>
#include <cstdint>

#include "hash_normal.cuh"
#include "window_search.cuh"

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

// Stage cost of the group's sample at pose (x, y, yaw, v) with sin/cos
// (s, c) of yaw: tracking against the window's running-min row, plus the
// outline test. `sxy` and `syv` are the window's (x, y) and (yaw, v) rows,
// `sout` the outline's scaled points (bx, by), all in shared memory.
template <int G, bool ISO>
__device__ __forceinline__ float dmm_bicycle_cost(const DmmBicycleArgs& p, int lane, float x,
                                                  float y, float yaw, float v, float c, float s,
                                                  const float4& wgt, const float2* sxy,
                                                  const float2* syv, const float2* sout,
                                                  const float* obs) {
  static_assert(G >= 2 && G <= 16 && (G & (G - 1)) == 0, "G: a power of two, 2 to 16");
  const float two_pi = 6.28318530717958647692f;  // float32(2π)
  float dmin;
  const int row = dmm_window_row<G>(p.W, lane, x, y, sxy, &dmin);
  const float2 yv = syv[row];
  const float yaw_w = yaw - two_pi * floorf(yaw / two_pi);
  const float eyaw = yaw_w - yv.x;
  const float ev = v - yv.y;
  float cost;
  if (ISO) {
    cost = wgt.x * dmin + wgt.z * eyaw * eyaw + wgt.w * ev * ev;
  } else {
    const float2 xy = sxy[row];
    const float ex = x - xy.x;
    const float ey = y - xy.y;
    cost = wgt.x * ex * ex + wgt.y * ey * ey + wgt.z * eyaw * eyaw + wgt.w * ev * ev;
  }
  if (p.n_obs > 0) {
    bool h = false;
    for (int j = lane; j < kOutlinePoints; j += G) {
      const float2 b = sout[j];
      const float px = b.x * c - b.y * s + x;
      const float py = b.x * s + b.y * c + y;
      for (int o = 0; o < p.n_obs; ++o) {
        const float ox = px - obs[3 * o];
        const float oy = py - obs[3 * o + 1];
        const float r = obs[3 * o + 2];
        h = h | (ox * ox + oy * oy < r * r);
      }
    }
    const unsigned group = __ballot_sync(kFullMask, h) >> ((threadIdx.x & 31) & ~(G - 1));
    const float hit = (group & ((1u << G) - 1)) != 0 ? 1.0f : 0.0f;
    cost = cost + hit * p.penalty;
  }
  return cost;
}

// The cost S of sample k, in every lane of its group; `active` is false for
// a group past K (it runs on sample K − 1 for the shuffles and stores
// nothing). `su`, `sa`, `sxy`, `syv`, `sout`, `sobs` are the block's shared
// copies of u, a, the window, the outline and the obstacles. GEN draws ε
// from the hash stream as one block of K samples and stores it to p.eps.
template <int G, bool ISO, bool GEN>
__device__ float dmm_bicycle_sample(const DmmBicycleArgs& p, int k, int lane, bool active,
                                    const float* su, const float* sa, const float2* sxy,
                                    const float2* syv, const float2* sout, const float* sobs) {
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
  float g0 = 0.0f, g1 = 0.0f;  // GEN: this lane's ε of step t0 + lane
  for (int t = 0; t < T; ++t) {
    float e0, e1;
    if (GEN) {
      const int r = t & (G - 1);
      if (r == 0 && t + lane < T) {
        const size_t at = static_cast<size_t>(t + lane) * K + k;
        float z0, z1;
        dmm_hash_normal_pair(base, static_cast<uint32_t>(at), &z0, &z1);
        g0 = l00 * z0;
        g1 = l10 * z0 + l11 * z1;
        if (active) reinterpret_cast<float2*>(p.eps)[at] = make_float2(g0, g1);
      }
      e0 = dmm_group_shfl<G>(g0, r);
      e1 = dmm_group_shfl<G>(g1, r);
    } else {
      const float2 e = reinterpret_cast<const float2*>(p.eps)[static_cast<size_t>(t) * K + k];
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

    float cost = dmm_bicycle_cost<G, ISO>(p, lane, x, y, yaw, v, c, s, sw, sxy, syv, sout, sobs);
    cost = cost + sa[2 * t] * st + sa[2 * t + 1] * ac;
    S = S + cost;
  }
  return S + dmm_bicycle_cost<G, ISO>(p, lane, x, y, yaw, v, c, s, tw, sxy, syv, sout, sobs);
}
