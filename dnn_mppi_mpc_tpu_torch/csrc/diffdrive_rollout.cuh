// Diff-drive MPPI rollout: the device function shared by the diff-drive kernels
// (split rollout, fused and K-blocked tick, fleet tick).
//
// Semantics of the Pallas rollout body (dnn_mppi_mpc_tpu/ops/pallas/
// mppi_tick.py:526-688, rollout.py:31-139, mppi_tick_blocked.py:94-214):
// exploration split on global sample indices, NaN-propagating in-rollout
// clamp, unicycle Euler step, running-min nearest waypoint over the W-row
// window with the first-strict-< tie rule, γ·uᵀΣ⁻¹v energy term, optional
// diagonal action cost, circle (×1e7) or soft obstacles with drift measured
// from rollout start (terminal cost at the initial positions), SUM or LAST
// accumulation.
//
// Layout: one thread per sample k carries (x, y, yaw, S) in registers
// through the T loop; ε is read from (T, K, 2) so neighbouring threads read
// neighbouring addresses. The library is compiled with -fmad=false, so
// every a*b+c here rounds twice, operation for operation like the plain
// PyTorch version; sincosf/expf/sqrtf stay full precision.
#pragma once

#include <cstddef>
#include <cstdint>

#include "hash_normal.cuh"

// Argument block of every C entry point. Field order is mirrored by the
// ctypes.Structure in dnn_mppi_mpc_tpu_torch/_build.py: pointers first,
// then 32-bit ints and floats. Shapes are row-major float32 unless noted.
struct DmmArgs {
  // inputs
  const long long* seed;    // (1,) int64 holding the uint32 tick seed
  const float* u;           // (T, 2) nominal controls
  const float* a;           // (T, 2) energy rows γ·u_tᵀΣ⁻¹
  const float* chol;        // (2, 2) lower Cholesky factor of Σ
  const float* x0;          // (3,)
  const float* window;      // (W, 3) waypoint window (x, y, yaw)
  const float* stage_w;     // (3,)
  const float* term_w;      // (3,)
  const float* u_min;       // (2,)
  const float* u_max;       // (2,)
  const float* obstacles;   // (n_obs, 5) rows (x, y, r, vx, vy)
  const float* control_w;   // (2,) diagonal action cost, or null
  const float* filter_t;    // (T, T) Fᵀ of the smoothing filter, or null
  // ε buffer (T, K, 2): read (eps_mode 0) or written (eps_mode 1)
  float* eps;
  // outputs
  float* S;                 // (K,)
  float* w;                 // (K,)
  float* w_eps;             // (T, 2)
  float* stats;             // (2,) rho, eta
  float* u_new;             // (T, 2)
  float* u_shift;           // (T, 2)
  float* finite;            // (1,) 1.0 when the update was applied
  // sizes and modes
  int K, T, W, n_obs;
  int k_blk;                // samples per noise-stream block (generated ε)
  int eps_mode;             // 0 read, 1 generate and store, 2 generate only
  int iso_xy, last_only;
  int obs_mode;             // 0 circle, 1 soft
  int drift;                // obstacles move at (vx, vy) during the rollout
  int fuse_epilogue;
  int block_offset;         // generated ε: sample k draws from block block_offset + k / k_blk
  int s_only;               // dmm_mppi_tick in eps_mode 2: the rollout (S) only
  float dt, n_exploit, k_offset, inv_temp;
  float obs_radius;         // effective robot radius (circle mode)
  float soft_dist, soft_w;
};

// A fleet of B controllers in one launch: `m` holds member 0's pointers;
// member b's are member 0's plus b times the member's size (dmm_member and
// the reductions). The seed pointer holds B seeds; chol, the weights and the
// bounds are shared.
struct DmmFleetArgs {
  DmmArgs m;
  int B;
};

// Member b's view of the fields the rollout reads and writes (b = 0: the
// argument block itself).
__device__ __forceinline__ DmmArgs dmm_member(const DmmArgs& p, int b) {
  DmmArgs q = p;
  q.seed = p.seed + b;
  q.u = p.u + static_cast<size_t>(b) * 2 * p.T;
  q.a = p.a + static_cast<size_t>(b) * 2 * p.T;
  q.x0 = p.x0 + static_cast<size_t>(b) * 3;
  q.window = p.window + static_cast<size_t>(b) * 3 * p.W;
  if (p.obstacles != nullptr) q.obstacles = p.obstacles + static_cast<size_t>(b) * 5 * p.n_obs;
  q.S = p.S + static_cast<size_t>(b) * p.K;
  return q;
}

__device__ __forceinline__ float dmm_clip(float v, float lo, float hi) {
  // jnp.clip / torch.clamp semantics: NaN passes through
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Running-min nearest waypoint. ISO returns the min squared distance in
// `dmin` (cost sw0·dmin); otherwise the winning row's (rx, ry).
template <bool ISO>
__device__ __forceinline__ void dmm_window_lookup(float xc, float yc, const float* win,
                                                  int W, float* dmin, float* rx,
                                                  float* ry, float* ryaw) {
  float dx = xc - win[0];
  float dy = yc - win[1];
  float best = dx * dx + dy * dy;
  float bx = win[0], by = win[1], byaw = win[2];
  for (int i = 1; i < W; ++i) {
    dx = xc - win[3 * i];
    dy = yc - win[3 * i + 1];
    const float d = dx * dx + dy * dy;
    if (d < best) {
      best = d;
      byaw = win[3 * i + 2];
      if (!ISO) {
        bx = win[3 * i];
        by = win[3 * i + 1];
      }
    }
  }
  *dmin = best;
  *rx = bx;
  *ry = by;
  *ryaw = byaw;
}

template <bool ISO>
__device__ __forceinline__ float dmm_tracking(float x, float y, float yaw, const float* win,
                                              int W, float w0, float w1, float w2) {
  float dmin, rx, ry, ryaw;
  dmm_window_lookup<ISO>(x, y, win, W, &dmin, &rx, &ry, &ryaw);
  const float eyaw = yaw - ryaw;
  if (ISO) return w0 * dmin + w2 * eyaw * eyaw;
  const float ex = x - rx;
  const float ey = y - ry;
  return w0 * ex * ex + w1 * ey * ey + w2 * eyaw * eyaw;
}

// Obstacle cost at rollout time t_f (drift applied when `drift`). `Args` is
// any argument block with n_obs, obs_mode, obs_radius, soft_dist and soft_w
// (DmmArgs, DmmGenericArgs).
template <class Args>
__device__ __forceinline__ float dmm_obstacle_cost(float xc, float yc, const float* obs,
                                                   const Args& p, bool drift, float t_f) {
  float pen = 0.0f;
  for (int o = 0; o < p.n_obs; ++o) {
    float ox = obs[5 * o], oy = obs[5 * o + 1];
    if (drift) {
      ox = ox + obs[5 * o + 3] * t_f;
      oy = oy + obs[5 * o + 4] * t_f;
    }
    const float dxo = xc - ox;
    const float dyo = yc - oy;
    const float d2 = dxo * dxo + dyo * dyo;
    if (p.obs_mode == 0) {
      const float rr = obs[5 * o + 2] + p.obs_radius;
      if (d2 < rr * rr) pen = 1.0f;
    } else {
      const float d = sqrtf(d2 + 1e-12f);
      pen = pen + (d < p.soft_dist ? expf(p.soft_dist - d) : 0.0f);
    }
  }
  return p.obs_mode == 0 ? pen * 1.0e7f : pen * p.soft_w;
}

// The cost S of sample k. `su`, `sa`, `swin`, `sobs` are the block's shared
// copies of u, a, the window and the obstacles. GEN draws ε from the hash
// stream and, when p.eps_mode == 1, stores it to p.eps.
template <bool ISO, bool LAST, bool GEN>
__device__ float dmm_rollout_sample(const DmmArgs& p, int k, const float* su, const float* sa,
                                    const float* swin, const float* sobs) {
  const int T = p.T, K = p.K;
  const float dt = p.dt;
  const float umin0 = p.u_min[0], umax0 = p.u_max[0];
  const float umin1 = p.u_min[1], umax1 = p.u_max[1];
  const float sw0 = p.stage_w[0], sw1 = p.stage_w[1], sw2 = p.stage_w[2];
  const bool has_cw = p.control_w != nullptr;
  const float rc0 = has_cw ? p.control_w[0] : 0.0f;
  const float rc1 = has_cw ? p.control_w[1] : 0.0f;
  const bool exploit = static_cast<float>(k) + p.k_offset < p.n_exploit;

  uint32_t base = 0, local = 0;
  float l00 = 0.0f, l10 = 0.0f, l11 = 0.0f;
  if (GEN) {
    const uint32_t blk = static_cast<uint32_t>(k / p.k_blk);
    local = static_cast<uint32_t>(k - static_cast<int>(blk) * p.k_blk);
    base = dmm_stream_base(static_cast<uint32_t>(p.seed[0]),
                           blk + static_cast<uint32_t>(p.block_offset));
    l00 = p.chol[0];
    l10 = p.chol[2];
    l11 = p.chol[3];
  }

  float x = p.x0[0], y = p.x0[1], yaw = p.x0[2];
  float S = 0.0f;
  for (int t = 0; t < T; ++t) {
    float e0, e1;
    const size_t at = static_cast<size_t>(t) * K + k;
    if (GEN) {
      float z0, z1;
      dmm_hash_normal_pair(base, static_cast<uint32_t>(t) * p.k_blk + local, &z0, &z1);
      e0 = l00 * z0;
      e1 = l10 * z0 + l11 * z1;
      if (p.eps_mode == 1) reinterpret_cast<float2*>(p.eps)[at] = make_float2(e0, e1);
    } else {
      const float2 e = reinterpret_cast<const float2*>(p.eps)[at];
      e0 = e.x;
      e1 = e.y;
    }
    const float u0 = su[2 * t], u1 = su[2 * t + 1];
    float v0 = exploit ? u0 + e0 : e0;
    float v1 = exploit ? u1 + e1 : e1;
    v0 = dmm_clip(v0, umin0, umax0);
    v1 = dmm_clip(v1, umin1, umax1);

    float s, c;
    sincosf(yaw, &s, &c);
    x = x + v0 * c * dt;
    y = y + v0 * s * dt;
    yaw = yaw + v1 * dt;

    float cost = dmm_tracking<ISO>(x, y, yaw, swin, p.W, sw0, sw1, sw2);
    cost = cost + sa[2 * t] * v0 + sa[2 * t + 1] * v1;
    if (has_cw) cost = cost + rc0 * v0 * v0 + rc1 * v1 * v1;
    if (p.n_obs > 0)
      cost = cost + dmm_obstacle_cost(x, y, sobs, p, p.drift != 0, static_cast<float>(t) * dt);
    S = LAST ? cost : S + cost;
  }
  S = S + dmm_tracking<ISO>(x, y, yaw, swin, p.W, p.term_w[0], p.term_w[1], p.term_w[2]);
  if (p.n_obs > 0) S = S + dmm_obstacle_cost(x, y, sobs, p, false, 0.0f);
  return S;
}
