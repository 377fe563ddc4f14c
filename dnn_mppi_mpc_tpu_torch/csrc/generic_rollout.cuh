// Generic MPPI rollout: the device function of the generic kernels, over a
// tile step of any of the four built-in model families.
//
// Semantics of the Pallas generic tick body (dnn_mppi_mpc_tpu/ops/pallas/
// generic_tick.py:69-369), in its order of operations: exploration split on
// global sample indices, NaN-propagating in-rollout clamp of each control,
// the energy term Σ_j a[t,j]·v_j summed in j order, the tile step, the
// running-min nearest waypoint over (x, y) of the (W, n_track) window with
// the first-strict-< rule, the tracking cost Σ_i w_i (x_i − ref_i)² over the
// first n_track state dims (dim 2 wrapped to [0, 2π) as x − 2π·floor(x·1/2π)
// with wrap_yaw), circle (×1e7, 1 if any obstacle is hit) or soft obstacles
// drifting by t·dt at stage t (terminal cost at the initial positions), SUM
// or LAST accumulation.
//
// Tile steps are functors: a struct with static NX, NU and a step on
// register arrays, its constants read from DmmGenericArgs::c in the order of
// the Python factory (dnn_mppi_mpc_tpu_torch/models/tile.py). The kernels
// are templates on the functor, so each family compiles to its own rollout.
//
// Layout: one thread per sample k carries its state and S in registers; ε
// is (T, K, NU), so neighbouring threads read neighbouring addresses. The
// library is built with -fmad=false, so every a*b+c rounds twice, like the
// plain PyTorch version (ops/cuda/generic_tick.py); sincosf/tanf/sinf/cosf
// stay full precision, and atan is the polynomial of models/tile.py, never
// atanf.
#pragma once

#include <cstddef>
#include <cstdint>

#include "diffdrive_rollout.cuh"
#include "hash_normal.cuh"

// Argument block of dmm_generic_rollout_costs and dmm_generic_tick. Field
// order is mirrored by DmmGenericArgs in dnn_mppi_mpc_tpu_torch/_build.py:
// pointers, then 32-bit ints, then floats. Row-major float32 unless noted.
struct DmmGenericArgs {
  // inputs
  const long long* seed;    // (1,) int64 holding the uint32 tick seed
  const float* u;           // (T, NU) nominal controls
  const float* a;           // (T, NU) energy rows γ·u_tᵀΣ⁻¹
  const float* chol;        // (NU, NU) lower Cholesky factor of Σ
  const float* x0;          // (NX,)
  const float* window;      // (W, n_track) waypoint window
  const float* stage_w;     // (n_track,)
  const float* term_w;      // (n_track,)
  const float* u_min;       // (NU,)
  const float* u_max;       // (NU,)
  const float* obstacles;   // (n_obs, 5) rows (x, y, r, vx, vy)
  const float* filter_t;    // (T, T) Fᵀ of the smoothing filter, or null
  // ε buffer (T, K, NU): read (eps_mode 0) or written (eps_mode 1)
  float* eps;
  // outputs
  float* S;                 // (K,)
  float* w;                 // (K,)
  float* w_eps;             // (T, NU)
  float* stats;             // (2,) rho, eta
  float* u_new;             // (T, NU)
  float* u_shift;           // (T, NU)
  float* finite;            // (1,) 1.0 when the update was applied
  // sizes and modes
  int model;                // 0 unicycle, 1 kinematic bicycle, 2 four-wheel torque,
                            // 3 dynamic bicycle (tile.FAMILIES)
  int K, T, W, n_track, n_obs;
  int eps_mode;             // 0 read, 1 generate and store, 2 generate only
  int last_only;
  int obs_mode;             // 0 circle, 1 soft
  int drift;                // obstacles move at (vx, vy) during the rollout
  int wrap_yaw;             // wrap state dim 2 before differencing
  int fuse_epilogue;
  float dt;                 // the config's dt (obstacle drift)
  float n_exploit, k_offset, inv_temp;
  float obs_radius;         // effective robot radius (circle mode)
  float soft_dist, soft_w;
  float c[8];               // the tile step's float32 constants, dt first
};

constexpr float kGenericTwoPi = 6.2831855f;       // float32(2π)
constexpr float kGenericInvTwoPi = 0.15915494f;   // float32(1/(2π))

// arctan as the A&S 4.4.49 odd polynomial (models/tile.py atan_tile), range
// reduced through atan(x) = sign(x)·π/2 − atan(1/x) for |x| > 1.
__device__ __forceinline__ float dmm_atan_poly(float x) {
  const float ax = fabsf(x);
  const bool big = ax > 1.0f;
  const float t = big ? 1.0f / fmaxf(ax, 1e-30f) : ax;
  const float t2 = t * t;
  float p = -0.004054058f;
  p = p * t2 + 0.02186123f;
  p = p * t2 + -0.055909887f;
  p = p * t2 + 0.09642004f;
  p = p * t2 + -0.13908534f;
  p = p * t2 + 0.19946536f;
  p = p * t2 + -0.33329856f;
  p = p * t2 + 0.99999934f;
  float r = t * p;
  r = big ? 1.5707964f - r : r;
  return x < 0.0f ? -r : r;
}

// --- the four tile steps (models/tile.py), operation for operation ---------

struct DmmUnicycleTile {
  static constexpr int NX = 3, NU = 2;
  float dt;
  __device__ explicit DmmUnicycleTile(const float* c) : dt(c[0]) {}
  __device__ __forceinline__ void step(float* x, const float* v) const {
    float s, c;
    sincosf(x[2], &s, &c);
    x[0] = x[0] + v[0] * c * dt;
    x[1] = x[1] + v[0] * s * dt;
    x[2] = x[2] + v[1] * dt;
  }
};

struct DmmKinematicBicycleTile {
  static constexpr int NX = 4, NU = 2;
  float dt, inv_l;
  __device__ explicit DmmKinematicBicycleTile(const float* c) : dt(c[0]), inv_l(c[1]) {}
  __device__ __forceinline__ void step(float* x, const float* v) const {
    const float yaw = x[2], vel = x[3];
    float s, c;
    sincosf(yaw, &s, &c);
    x[0] = x[0] + vel * c * dt;
    x[1] = x[1] + vel * s * dt;
    x[2] = yaw + vel * tanf(v[0]) * inv_l * dt;
    x[3] = vel + v[1] * dt;
  }
};

struct DmmFourWheelTile {
  static constexpr int NX = 5, NU = 4;
  float dt, cv, cw;
  __device__ explicit DmmFourWheelTile(const float* c) : dt(c[0]), cv(c[1]), cw(c[2]) {}
  __device__ __forceinline__ void step(float* x, const float* v) const {
    const float theta = x[2], vel = x[3], omega = x[4];
    float s, c;
    sincosf(theta, &s, &c);
    x[0] = x[0] + vel * c * dt;
    x[1] = x[1] + vel * s * dt;
    x[2] = theta + omega * dt;
    x[3] = vel + cv * (v[0] + v[1] + v[2] + v[3]) * dt;
    x[4] = omega + cw * ((v[0] + v[2]) - (v[1] + v[3])) * dt;
  }
};

struct DmmDynamicBicycleTile {
  static constexpr int NX = 4, NU = 2;
  float dt, beta_gain, lf, lr, cf, cr, inv_m;
  __device__ explicit DmmDynamicBicycleTile(const float* c)
      : dt(c[0]), beta_gain(c[1]), lf(c[2]), lr(c[3]), cf(c[4]), cr(c[5]), inv_m(c[6]) {}
  __device__ __forceinline__ void step(float* x, const float* v) const {
    const float yaw = x[2], vel = x[3];
    const float acc = v[0], steer = v[1];
    const float beta = dmm_atan_poly(beta_gain * tanf(steer));
    float sb, cb;
    sincosf(beta, &sb, &cb);
    const float vx = vel * cb;
    const float vx_safe = fabsf(vx) < 1e-6f ? 1e-6f : vx;
    const float vs = vel * sb;
    float ss, cs;
    sincosf(steer, &ss, &cs);
    const float fy = 2.0f * (cf * sinf(dmm_atan_poly((vs + lf * yaw) / vx_safe)) * cs +
                             cr * sinf(dmm_atan_poly((vs - lr * yaw) / vx_safe)));
    float syb, cyb;
    sincosf(yaw + beta, &syb, &cyb);
    x[0] = x[0] + vel * cyb * dt;
    x[1] = x[1] + vel * syb * dt;
    x[2] = yaw + vs / lr * dt;
    x[3] = vel + (acc - fy * ss) * inv_m * dt;
  }
};

// --- the cost ----------------------------------------------------------------

// Tracking cost of the state x against the nearest row of the (W, n_track)
// window; w holds the n_track weights (zero past n_track).
template <int NX>
__device__ __forceinline__ float dmm_generic_tracking(const float* x, const float* win, int W,
                                                      int n_track, const float* w, bool wrap) {
  float dx = x[0] - win[0];
  float dy = x[1] - win[1];
  float best = dx * dx + dy * dy;
  int row = 0;
  for (int r = 1; r < W; ++r) {
    dx = x[0] - win[r * n_track];
    dy = x[1] - win[r * n_track + 1];
    const float d = dx * dx + dy * dy;
    if (d < best) {
      best = d;
      row = r;
    }
  }
  const float* ref = win + row * n_track;
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (i < n_track) {
      float xi = x[i];
      if (i == 2 && wrap) xi = xi - kGenericTwoPi * floorf(xi * kGenericInvTwoPi);
      const float e = xi - ref[i];
      c = c + w[i] * e * e;
    }
  }
  return c;
}

// The cost S of sample k. `su`, `sa`, `swin`, `sobs` are the block's shared
// copies of u, a (T, NU each), the (W, n_track) window and the obstacles.
// GEN draws ε from the hash stream (one block of K samples, seed p.seed[0])
// and, when p.eps_mode == 1, stores it to p.eps.
template <class F, bool LAST, bool GEN>
__device__ float dmm_generic_sample(const DmmGenericArgs& p, int k, const float* su,
                                    const float* sa, const float* swin, const float* sobs) {
  constexpr int NX = F::NX, NU = F::NU;
  const F f(p.c);
  const int T = p.T, K = p.K;
  float umin[NU], umax[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    umin[j] = p.u_min[j];
    umax[j] = p.u_max[j];
  }
  float sw[NX], tw[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    sw[i] = i < p.n_track ? p.stage_w[i] : 0.0f;
    tw[i] = i < p.n_track ? p.term_w[i] : 0.0f;
  }
  const bool wrap = p.wrap_yaw != 0;
  const bool exploit = static_cast<float>(k) + p.k_offset < p.n_exploit;
  float L[NU * NU];
  uint32_t base = 0;
  if (GEN) {
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) L[i] = p.chol[i];
    base = dmm_stream_base(static_cast<uint32_t>(p.seed[0]), 0u);
  }

  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = p.x0[i];
  float S = 0.0f;
  for (int t = 0; t < T; ++t) {
    float e[NU];
    float* at = p.eps + (static_cast<size_t>(t) * K + k) * NU;
    if (GEN) {
      float z[2 * ((NU + 1) / 2)];
      dmm_hash_normals<NU>(base, t, T, K, static_cast<uint32_t>(k), z);
      dmm_color<NU>(L, z, e);
      if (p.eps_mode == 1) {
#pragma unroll
        for (int j = 0; j < NU; ++j) at[j] = e[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NU; ++j) e[j] = at[j];
    }
    float v[NU];
    float energy = 0.0f;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float vj = exploit ? su[t * NU + j] + e[j] : e[j];
      vj = dmm_clip(vj, umin[j], umax[j]);
      v[j] = vj;
      const float term = sa[t * NU + j] * vj;
      energy = j == 0 ? term : energy + term;
    }
    f.step(x, v);
    float cost = dmm_generic_tracking<NX>(x, swin, p.W, p.n_track, sw, wrap) + energy;
    if (p.n_obs > 0)
      cost = cost + dmm_obstacle_cost(x[0], x[1], sobs, p, p.drift != 0, static_cast<float>(t) * p.dt);
    S = LAST ? cost : S + cost;
  }
  S = S + dmm_generic_tracking<NX>(x, swin, p.W, p.n_track, tw, wrap);
  if (p.n_obs > 0) S = S + dmm_obstacle_cost(x[0], x[1], sobs, p, false, 0.0f);
  return S;
}
