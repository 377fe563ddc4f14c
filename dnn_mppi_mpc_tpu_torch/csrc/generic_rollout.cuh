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
// Layout: the diff-drive rollout's (diffdrive_rollout.cuh). A group of G
// consecutive lanes of a warp (G a power of two, a template constant; the
// launcher picks it, generic_kernels.cu) shares one sample k. Every lane of
// the group runs the tile step on the same inputs, so every lane holds the
// same state and S bit for bit. The window search is split: lane j keeps the
// running min of rows i ≡ j (mod G) over the window's (x, y) rows, staged as
// float2, and dmm_window_row merges the partials into the sequential scan's
// row; the tracking sum then reads that row's n_track columns in dimension
// order, so S is the same for every G, G = 1 (one thread a sample) included.
// With hash ε, lane j draws the ⌈NU/2⌉ normal pairs of the steps t ≡ j
// (mod G) (the stream's counters unchanged), colours them and hands the NU
// values out by shuffle at their step; only the drawing lane stores them
// (eps_mode 1). Injected ε is read from (T, K, NU) a step ahead, so that
// the load waits off the state's chain: the lanes of a group read one
// address, neighbouring groups neighbouring ones. Every lane computes
// every obstacle, in obstacle order. The library is built with -fmad=false,
// so every a*b+c rounds twice, like the plain PyTorch version
// (ops/cuda/generic_tick.py); sincosf/tanf/sinf/cosf stay full precision,
// and atan is the polynomial of models/tile.py, never atanf.
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
  float* scratch;           // the chunked reductions' partials (dmm_generic_scratch_floats)
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
  int scratch_floats;       // floats at scratch
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

// Tracking cost of the group's sample at state x against the window's
// running-min row over (x, y) (dmm_window_row): Σ_i w_i (x_i − ref_i)² over
// the first n_track dims in dimension order; w holds the n_track weights
// (zero past n_track). `sxy` is the window's (x, y) rows, `srest` its other
// n_track − 2 columns, row-major (W, n_track − 2).
template <int G, int NX>
__device__ __forceinline__ float dmm_generic_tracking(const float* x, int W, int lane,
                                                      const float2* sxy, const float* srest,
                                                      int n_track, const float* w, bool wrap) {
  float dmin;
  const int row = dmm_window_row<G>(W, lane, x[0], x[1], sxy, &dmin);
  const float2 r = sxy[row];
  const float* rest = srest + row * (n_track - 2);
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (i < n_track) {
      float xi = x[i];
      if (i == 2 && wrap) xi = xi - kGenericTwoPi * floorf(xi * kGenericInvTwoPi);
      const float e = xi - (i == 0 ? r.x : i == 1 ? r.y : rest[i - 2]);
      c = c + w[i] * e * e;
    }
  }
  return c;
}

// The NU floats of an injected ε row (T, K, NU) at `at`.
template <int NU>
__device__ __forceinline__ void dmm_generic_eps_row(const float* at, float* e) {
  if constexpr (NU == 2) {
    const float2 v = *reinterpret_cast<const float2*>(at);
    e[0] = v.x;
    e[1] = v.y;
  } else if constexpr (NU == 4) {
    const float4 v = *reinterpret_cast<const float4*>(at);
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < NU; ++j) e[j] = at[j];
  }
}

// The cost S of sample k, in every lane of its group (`lane` its index in
// the group); `active` is false for a group past K (it runs on sample K − 1
// for the shuffles and stores nothing). `su`, `sa`, `sxy`, `srest`, `sobs`
// are the block's shared copies of u, a (T, NU each), the window's (x, y)
// rows and other columns and the obstacles. GEN draws ε from the hash stream
// (one block of K samples, seed p.seed[0]) and, when p.eps_mode == 1, stores
// it to p.eps.
template <int G, class F, bool LAST, bool GEN>
__device__ float dmm_generic_sample(const DmmGenericArgs& p, int k, int lane, bool active,
                                    const float* su, const float* sa, const float2* sxy,
                                    const float* srest, const float* sobs) {
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
  float g[NU];   // GEN: this lane's ε of step t0 + lane
  float en[NU];  // injected: the next step's row, loaded a step ahead, off the state's chain
#pragma unroll
  for (int j = 0; j < NU; ++j) g[j] = 0.0f;
  if (!GEN) dmm_generic_eps_row<NU>(p.eps + static_cast<size_t>(k) * NU, en);
  for (int t = 0; t < T; ++t) {
    float e[NU];
    if (GEN) {
      const int r = t & (G - 1);
      if (r == 0 && t + lane < T) {
        const int td = t + lane;
        float z[2 * ((NU + 1) / 2)];
        dmm_hash_normals<NU>(base, td, T, K, static_cast<uint32_t>(k), z);
        dmm_color<NU>(L, z, g);
        if (p.eps_mode == 1 && active) {
          float* at = p.eps + (static_cast<size_t>(td) * K + k) * NU;
#pragma unroll
          for (int j = 0; j < NU; ++j) at[j] = g[j];
        }
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) e[j] = dmm_group_shfl<G>(g[j], r);
    } else {
#pragma unroll
      for (int j = 0; j < NU; ++j) e[j] = en[j];
      if (t + 1 < T) dmm_generic_eps_row<NU>(p.eps + (static_cast<size_t>(t + 1) * K + k) * NU, en);
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
    float cost =
        dmm_generic_tracking<G, NX>(x, p.W, lane, sxy, srest, p.n_track, sw, wrap) + energy;
    if (p.n_obs > 0)
      cost = cost + dmm_obstacle_cost(x[0], x[1], sobs, p, p.drift != 0, static_cast<float>(t) * p.dt);
    S = LAST ? cost : S + cost;
  }
  S = S + dmm_generic_tracking<G, NX>(x, p.W, lane, sxy, srest, p.n_track, tw, wrap);
  if (p.n_obs > 0) S = S + dmm_obstacle_cost(x[0], x[1], sobs, p, false, 0.0f);
  return S;
}
