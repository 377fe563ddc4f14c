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
// or LAST accumulation. With waypoint_carry="rollout" (carry_span > 0,
// generic_tick.py:226-244 and 334-356) each sample carries its window start
// through the rollout by the diff-drive rollout's rule (dmm_carried_row;
// no row found: the reference (0, ..., 0)), and the furthest final start
// over K goes to wp_adv.
//
// Tile steps are functors: a struct with static NX, NU, TAKES_T, WEIGHTS, a
// constructor F(c, w) and a step on register arrays,
// step(x, v), or step(x, v, t) with the int rollout step t when TAKES_T; a
// built-in family reads its constants from DmmGenericArgs::c in the order of
// the Python factory (dnn_mppi_mpc_tpu_torch/models/tile.py). A library
// built with -DDMM_USER_TILE also holds a functor generated from a traced
// tile step of the user's (dnn_mppi_mpc_tpu_torch/ops/cuda/user_tile.py):
// the header dmm_user_tile.cuh defines it as DmmUserTile, its constants baked
// in; its weights (WEIGHTS > 0: its matrix products') it reads at w, the
// WEIGHTS floats of DmmGenericArgs::weights, which the rollout stages in
// shared memory. The
// kernels are templates on the functor, so each compiles to its own rollout.
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
#include <cstring>

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
  const float* weights;     // (F::WEIGHTS,) a generated functor's weights, or null
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
  int* wp_adv;              // (1,) the furthest carried window row over K (carry_span > 0);
                            // the caller zeroes it
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
  int carry_span;           // waypoint_carry="rollout": the per-step search span over the
                            // W carry-window rows; 0: one window for the tick
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
  static constexpr bool TAKES_T = false;
  static constexpr int WEIGHTS = 0;
  float dt;
  __device__ DmmUnicycleTile(const float* c, const float*) : dt(c[0]) {}
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
  static constexpr bool TAKES_T = false;
  static constexpr int WEIGHTS = 0;
  float dt, inv_l;
  __device__ DmmKinematicBicycleTile(const float* c, const float*) : dt(c[0]), inv_l(c[1]) {}
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
  static constexpr bool TAKES_T = false;
  static constexpr int WEIGHTS = 0;
  float dt, cv, cw;
  __device__ DmmFourWheelTile(const float* c, const float*) : dt(c[0]), cv(c[1]), cw(c[2]) {}
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
  static constexpr bool TAKES_T = false;
  static constexpr int WEIGHTS = 0;
  float dt, beta_gain, lf, lr, cf, cr, inv_m;
  __device__ DmmDynamicBicycleTile(const float* c, const float*)
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

// --- what generated tile steps call (ops/cuda/user_tile.py) ---------------------

// minimum / maximum as PyTorch's: NaN in either operand gives NaN.
__device__ __forceinline__ float dmm_user_min(float a, float b) {
  return a != a || b != b ? a + b : (b < a ? b : a);
}
__device__ __forceinline__ float dmm_user_max(float a, float b) {
  return a != a || b != b ? a + b : (a < b ? b : a);
}

// The float32 of the bits `b`: a literal that is not finite.
__device__ __forceinline__ float dmm_user_bits(unsigned b) {
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
}

// Full-precision math by names of their own, so that a CPU build of the
// kernels (tests/cuda_emu.h, which defines DMM_USER_MATH) can point them at
// PyTorch's. sincosf and tanf the generated code calls as the built-in
// functors do.
#ifndef DMM_USER_MATH
__device__ __forceinline__ float dmm_user_atan(float x) { return atanf(x); }
__device__ __forceinline__ float dmm_user_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float dmm_user_exp(float x) { return expf(x); }
__device__ __forceinline__ float dmm_user_log(float x) { return logf(x); }
__device__ __forceinline__ float dmm_user_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ float dmm_user_pow(float x, float e) { return powf(x, e); }
__device__ __forceinline__ float dmm_user_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
#endif

#ifdef DMM_USER_TILE
#include "dmm_user_tile.cuh"
#endif

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

// dmm_generic_tracking from the carried window start `idx`
// (waypoint_carry="rollout"): the masked search from idx (dmm_carried_row),
// with `advance` idx moving to the row found; with no row found (a NaN
// state) idx stays and every reference column reads 0, as in the Pallas
// kernel.
template <int G, int NX>
__device__ __forceinline__ float dmm_generic_tracking_carried(
    const float* x, int W, int span, int* idx, bool advance, int lane, const float2* sxy,
    const float* srest, int n_track, const float* w, bool wrap) {
  float dmin;
  const int row = dmm_carried_row<G>(W, span, *idx, lane, x[0], x[1], sxy, &dmin);
  const bool found = row >= 0;
  if (found && advance) *idx = row;
  const float2 r = found ? sxy[row] : make_float2(0.0f, 0.0f);
  const float* rest = srest + (found ? row : 0) * (n_track - 2);
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    if (i < n_track) {
      float xi = x[i];
      if (i == 2 && wrap) xi = xi - kGenericTwoPi * floorf(xi * kGenericInvTwoPi);
      const float ref = i == 0 ? r.x : i == 1 ? r.y : (found ? rest[i - 2] : 0.0f);
      const float e = xi - ref;
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
// it to p.eps. CARRY carries the window start (p.carry_span > 0) and leaves
// the final one at `carried`. `wts` is the functor's weights, staged in
// shared memory.
template <int G, class F, bool LAST, bool GEN, bool CARRY>
__device__ __forceinline__ float dmm_generic_sample(
    const DmmGenericArgs& p, int k, int lane, bool active, const float* su, const float* sa,
    const float2* sxy, const float* srest, const float* sobs, const float* wts, int* carried) {
  constexpr int NX = F::NX, NU = F::NU;
  const F f(p.c, wts);
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
  int idx = 0;   // CARRY: the carried window start, a row of the carry window
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
    if constexpr (F::TAKES_T)
      f.step(x, v, t);
    else
      f.step(x, v);
    const float track =
        CARRY ? dmm_generic_tracking_carried<G, NX>(x, p.W, p.carry_span, &idx, true, lane, sxy,
                                                    srest, p.n_track, sw, wrap)
              : dmm_generic_tracking<G, NX>(x, p.W, lane, sxy, srest, p.n_track, sw, wrap);
    float cost = track + energy;
    if (p.n_obs > 0)
      cost = cost + dmm_obstacle_cost(x[0], x[1], sobs, p, p.drift != 0, static_cast<float>(t) * p.dt);
    S = LAST ? cost : S + cost;
  }
  if (CARRY) {
    S = S + dmm_generic_tracking_carried<G, NX>(x, p.W, p.carry_span, &idx, false, lane, sxy,
                                                srest, p.n_track, tw, wrap);
    *carried = idx;
  } else {
    S = S + dmm_generic_tracking<G, NX>(x, p.W, lane, sxy, srest, p.n_track, tw, wrap);
  }
  if (p.n_obs > 0) S = S + dmm_obstacle_cost(x[0], x[1], sobs, p, false, 0.0f);
  return S;
}
