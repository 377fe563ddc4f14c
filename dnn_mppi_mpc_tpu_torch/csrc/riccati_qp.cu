// Fused barrier-Riccati QP kernel for Hopper (sm_90a), behind a plain C ABI:
// the whole relaxed-barrier QP of one NMPC linearization in one launch.
//
// Replaces two Pallas TPU kernels, which share one kernel body there as here:
//   dmm_barrier_qp (B = 1) <- dnn_mppi_mpc_tpu/ops/pallas/riccati_qp.py:493
//                             pallas_barrier_qp_solve (one problem)
//   dmm_barrier_qp (B > 1) <- dnn_mppi_mpc_tpu/ops/pallas/riccati_qp.py:582
//                             pallas_batched_barrier_qp_solve (B independent
//                             problems; also reached by :706's batching rule)
//
// What it computes, per problem: num_iters damped Newton steps on the
// relaxed-barrier QP (μ from the schedule; the barrier derivatives of the x,
// u and h rows folded into the stage Hessians and gradients; the backward
// Riccati sweep with a partial-pivot LU of Luu; the forward sweep; the
// fraction-to-boundary step α; the update; kkt = the ∞-norm of the last step),
// then the condensing roll of δU through the linear dynamics.
//
// What bounds it on the card. Neither bytes nor operations: at the NMPC
// tick's shape (N = 30, nx = 3, nu = 2, 12 iterations) a problem reads ~10 KB
// once and does ~0.2 MFLOP, but as a chain of 12·(2N + 1) stage steps, each a
// few hundred dependent scalar operations. The bound is the latency of that
// chain on one thread. Design: one thread per problem (⌈B/32⌉ blocks of 32
// threads, the thread index guarded, no padding); every stage table laid out
// (stage, row·col, B) with B innermost, so a warp's 32 problems read
// neighbouring words; the value function and the stage matrices in registers,
// every loop over a matrix dimension unrolled (templates on NX and NU); the
// Newton iterate in the output tensors, updated in place; gains, Newton step
// and residual in scratch the wrapper allocates. A warp per problem with the
// stage tables in shared memory is later work.
//
// The operations run in the Pallas body's order (sums left to right from the
// first term, the same symmetrisations, pivoting and selects), and the library
// is built with -fmad=false (see _build.py), so the kernel rounds op for op
// like its plain PyTorch version (ops/cuda/riccati_qp.py). min and max pass a
// NaN on, as jnp.minimum/torch.minimum do.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" {

// One launch's arguments. Stage tables are (stage, row·col, Bn) float32 with
// the problem index innermost; mus (num_iters,) and misc (5,) = (δ, bound
// stiffness, h stiffness, h slope, Luu regularisation) are shared by all.
struct DmmQPArgs {
  const float* mus;
  const float* misc;
  const float* A;    // (N, nx·nx, Bn)
  const float* B;    // (N, nx·nu, Bn)
  const float* c;    // (N, nx, Bn)
  const float* Q;    // (N+1, nx·nx, Bn)
  const float* qx;   // (N+1, nx, Bn) LS gradient at δ = 0
  const float* R;    // (N, nu·nu, Bn)
  const float* ru;   // (N, nu, Bn)
  const float* lbx;  // (N+1, nx, Bn) margins at δ = 0
  const float* ubx;  // (N+1, nx, Bn)
  const float* lbu;  // (N, nu, Bn)
  const float* ubu;  // (N, nu, Bn)
  const float* Jh;   // (N+1, n_h·nx, Bn), unused when n_h = 0
  const float* h0;   // (N+1, n_h, Bn)
  const float* S;    // (N, nu·nx, Bn), unused unless has_S
  const float* dx0;  // (nx, Bn)
  float* dX;         // out (N+1, nx, Bn): the Newton iterate, then the roll
  float* dU;         // out (N, nu, Bn)
  float* kkt;        // out (Bn,)
  float* K;          // scratch (N, nu·nx, Bn) feedback gains
  float* k;          // scratch (N, nu, Bn)
  float* ddX;        // scratch (N+1, nx, Bn) Newton step
  float* ddU;        // scratch (N, nu, Bn)
  float* cres;       // scratch (N, nx, Bn) dynamics residual at the iterate
  int Bn;
  int N;
  int nx;
  int nu;
  int n_h;
  int num_iters;
  int has_S;
};

}  // extern "C"

namespace {

constexpr float kInf = 3.0e38f;

// element j of stage i of a (stage, cols, Bn) table, problem b
struct Table {
  const float* p;
  int cols;
  int Bn;
  int b;
  __device__ float operator()(int i, int j) const {
    return p[(static_cast<size_t>(i) * cols + j) * Bn + b];
  }
};

struct OutTable {
  float* p;
  int cols;
  int Bn;
  int b;
  __device__ float& operator()(int i, int j) const {
    return p[(static_cast<size_t>(i) * cols + j) * Bn + b];
  }
};

__device__ __forceinline__ float maxp(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float minp(float a, float b) { return (a < b || a != a) ? a : b; }

// (ψ', ψ'') of the relaxed log barrier (solvers/qp.py relaxed_barrier)
__device__ __forceinline__ void rb(float w, float mu, float kappa, float delta, float& g,
                                   float& h) {
  const bool use_log = w > delta;
  const float ws = maxp(w, delta);
  g = use_log ? (-mu) / ws : (-mu) / delta - kappa * (delta - w);
  h = use_log ? mu / (ws * ws) : kappa;
}

// step α bound of one margin: max α with w + α·dw ≥ δ/2 for a shrinking
// margin in the log region
__device__ __forceinline__ float ftb(float w, float dw, float amin, float delta) {
  const bool shrink = dw < 0.0f && w > delta;
  const float a = shrink ? (w - 0.5f * delta) / maxp(-dw, 1e-30f) : kInf;
  return minp(amin, a);
}

struct Consts {
  float delta, stiff, h_stiff, h_slope, reg;
};

template <int NX, int NU>
struct Problem {
  Table A, B, c, Q, qx, R, ru, lbx, ubx, lbu, ubu, Jh, h0, S;
  OutTable dX, dU, K, k, ddX, ddU, cres;
  int N, n_h;
  bool has_S;

  // folded state Hessian and gradient at stage i for the current iterate:
  // Q + barrier diag + Jhᵀ·h''·Jh ;  qx + Q·δx + barrier + Jhᵀ·h'
  __device__ void fold_x(int i, float mu, const Consts& k_, float Qxx[NX][NX], float q[NX],
                         float dXi[NX]) const {
#pragma unroll
    for (int d = 0; d < NX; ++d) dXi[d] = dX(i, d);
#pragma unroll
    for (int r = 0; r < NX; ++r)
#pragma unroll
      for (int e = 0; e < NX; ++e) Qxx[r][e] = Q(i, r * NX + e);
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float s = Qxx[d][0] * dXi[0];
#pragma unroll
      for (int e = 1; e < NX; ++e) s = s + Qxx[d][e] * dXi[e];
      q[d] = qx(i, d) + s;
    }
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float gl, hl, gu, hu;
      rb(lbx(i, d) + dXi[d], mu, k_.stiff, k_.delta, gl, hl);
      rb(ubx(i, d) - dXi[d], mu, k_.stiff, k_.delta, gu, hu);
      q[d] = q[d] + gl - gu;
      Qxx[d][d] = Qxx[d][d] + hl + hu;
    }
    for (int r = 0; r < n_h; ++r) {
      float Jr[NX];
#pragma unroll
      for (int d = 0; d < NX; ++d) Jr[d] = Jh(i, r * NX + d);
      float s = Jr[0] * dXi[0];
#pragma unroll
      for (int d = 1; d < NX; ++d) s = s + Jr[d] * dXi[d];
      const float wh = h0(i, r) + s;
      float gh, hh;
      rb(wh, mu, k_.h_stiff, k_.delta, gh, hh);
      gh = gh - k_.h_slope * (wh < 0.0f ? 1.0f : 0.0f);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        q[d] = q[d] + Jr[d] * gh;
#pragma unroll
        for (int e = 0; e < NX; ++e) Qxx[d][e] = Qxx[d][e] + Jr[d] * hh * Jr[e];
      }
    }
  }

  // one stage of the backward sweep: reads (P, p) of stage i+1, stores the
  // gains and the residual of stage i, leaves (P, p) of stage i
  __device__ void backward_stage(int i, float mu, const Consts& k_, float P[NX][NX],
                                 float p[NX]) const {
    float Qxx[NX][NX], q[NX], dXi[NX];
    fold_x(i, mu, k_, Qxx, q, dXi);

    float dUi[NU], Ruu[NU][NU], r_u[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) dUi[a] = dU(i, a);
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int b = 0; b < NU; ++b) Ruu[a][b] = R(i, a * NU + b);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float s = Ruu[a][0] * dUi[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) s = s + Ruu[a][b] * dUi[b];
      r_u[a] = ru(i, a) + s;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float gl, hl, gu, hu;
      rb(lbu(i, a) + dUi[a], mu, k_.stiff, k_.delta, gl, hl);
      rb(ubu(i, a) - dUi[a], mu, k_.stiff, k_.delta, gu, hu);
      r_u[a] = r_u[a] + gl - gu;
      Ruu[a][a] = Ruu[a][a] + hl + hu;
    }
    float Sm[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int d = 0; d < NX; ++d) Sm[a][d] = has_S ? S(i, a * NX + d) : 0.0f;
    if (has_S) {
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        float s = Sm[0][d] * dUi[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) s = s + Sm[a][d] * dUi[a];
        q[d] = q[d] + s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = Sm[a][0] * dXi[0];
#pragma unroll
        for (int d = 1; d < NX; ++d) s = s + Sm[a][d] * dXi[d];
        r_u[a] = r_u[a] + s;
      }
    }

    float Am[NX][NX], Bm[NX][NU], cr[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int e = 0; e < NX; ++e) Am[r][e] = A(i, r * NX + e);
#pragma unroll
      for (int a = 0; a < NU; ++a) Bm[r][a] = B(i, r * NU + a);
    }
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float sa = Am[d][0] * dXi[0];
#pragma unroll
      for (int e = 1; e < NX; ++e) sa = sa + Am[d][e] * dXi[e];
      float sb = Bm[d][0] * dUi[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) sb = sb + Bm[d][a] * dUi[a];
      cr[d] = sa + sb + c(i, d) - dX(i + 1, d);
      cres(i, d) = cr[d];
    }

    float PA[NX][NX], PB[NX][NU], Pc[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) {
        float s = P[r][0] * Am[0][cc];
#pragma unroll
        for (int e = 1; e < NX; ++e) s = s + P[r][e] * Am[e][cc];
        PA[r][cc] = s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = P[r][0] * Bm[0][a];
#pragma unroll
        for (int e = 1; e < NX; ++e) s = s + P[r][e] * Bm[e][a];
        PB[r][a] = s;
      }
      float s = P[r][0] * cr[0];
#pragma unroll
      for (int e = 1; e < NX; ++e) s = s + P[r][e] * cr[e];
      Pc[r] = s;
    }

    float Lraw[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        float s = Bm[0][a] * PB[0][b];
#pragma unroll
        for (int r = 1; r < NX; ++r) s = s + Bm[r][a] * PB[r][b];
        Lraw[a][b] = Ruu[a][b] + s;
      }
    // the augmented rows [Luu | Lux | lu] of the LU solve
    constexpr int W = NU + NX + 1;
    float rows[NU][W];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int b = 0; b < NU; ++b)
        rows[a][b] = 0.5f * (Lraw[a][b] + Lraw[b][a]) + (a == b ? k_.reg : 0.0f);
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) {
        float s = Bm[0][a] * PA[0][cc];
#pragma unroll
        for (int r = 1; r < NX; ++r) s = s + Bm[r][a] * PA[r][cc];
        rows[a][NU + cc] = Sm[a][cc] + s;
      }
      float s = Bm[0][a] * (p[0] + Pc[0]);
#pragma unroll
      for (int r = 1; r < NX; ++r) s = s + Bm[r][a] * (p[r] + Pc[r]);
      rows[a][NU + NX] = r_u[a] + s;
    }
    float Lux[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a)
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) Lux[a][cc] = rows[a][NU + cc];

    // partial-pivot LU: bubble the max-|column i| row into position i
#pragma unroll
    for (int ii = 0; ii < NU; ++ii) {
#pragma unroll
      for (int j = ii + 1; j < NU; ++j) {
        const bool swap = fabsf(rows[j][ii]) > fabsf(rows[ii][ii]);
#pragma unroll
        for (int t = 0; t < W; ++t) {
          const float hi = swap ? rows[j][t] : rows[ii][t];
          const float lo = swap ? rows[ii][t] : rows[j][t];
          rows[ii][t] = hi;
          rows[j][t] = lo;
        }
      }
      const float inv_p = 1.0f / rows[ii][ii];
#pragma unroll
      for (int j = ii + 1; j < NU; ++j) {
        const float f = rows[j][ii] * inv_p;
#pragma unroll
        for (int t = ii; t < W; ++t) rows[j][t] = rows[j][t] - f * rows[ii][t];
      }
    }
    float x[NU][NX + 1];  // solution column ci of row a
#pragma unroll
    for (int ci = 0; ci < NX + 1; ++ci) {
#pragma unroll
      for (int ii = NU - 1; ii >= 0; --ii) {
        float s = rows[ii][NU + ci];
#pragma unroll
        for (int t = ii + 1; t < NU; ++t) s = s - rows[ii][t] * x[t][ci];
        x[ii][ci] = s / rows[ii][ii];
      }
    }
    float Kg[NU][NX], kg[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) {
        Kg[a][cc] = -x[a][cc];
        K(i, a * NX + cc) = Kg[a][cc];
      }
      kg[a] = -x[a][NX];
      k(i, a) = kg[a];
    }

    float Pn[NX][NX], pn[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) {
        float sa = Am[0][r] * PA[0][cc];
#pragma unroll
        for (int e = 1; e < NX; ++e) sa = sa + Am[e][r] * PA[e][cc];
        float sl = Lux[0][r] * Kg[0][cc];
#pragma unroll
        for (int a = 1; a < NU; ++a) sl = sl + Lux[a][r] * Kg[a][cc];
        Pn[r][cc] = Qxx[r][cc] + sa + sl;
      }
      float sa = Am[0][r] * (p[0] + Pc[0]);
#pragma unroll
      for (int e = 1; e < NX; ++e) sa = sa + Am[e][r] * (p[e] + Pc[e]);
      float sl = Lux[0][r] * kg[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) sl = sl + Lux[a][r] * kg[a];
      pn[r] = q[r] + sa + sl;
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) P[r][cc] = 0.5f * (Pn[r][cc] + Pn[cc][r]);
      p[r] = pn[r];
    }
  }

  __device__ void newton_iter(float mu, const Consts& k_, float* kkt_out) const {
    float P[NX][NX], p[NX], dXN[NX];
    fold_x(N, mu, k_, P, p, dXN);
#pragma unroll 1
    for (int j = 0; j < N; ++j) backward_stage(N - 1 - j, mu, k_, P, p);

    // forward sweep on the residual problem (ddx₀ = 0)
    float ddx[NX];
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      ddx[d] = 0.0f;
      ddX(0, d) = 0.0f;
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      float ddu[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = K(i, a * NX) * ddx[0];
#pragma unroll
        for (int cc = 1; cc < NX; ++cc) s = s + K(i, a * NX + cc) * ddx[cc];
        ddu[a] = k(i, a) + s;
        ddU(i, a) = ddu[a];
      }
      float nxt[NX];
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        float sa = A(i, d * NX) * ddx[0];
#pragma unroll
        for (int e = 1; e < NX; ++e) sa = sa + A(i, d * NX + e) * ddx[e];
        float sb = B(i, d * NU) * ddu[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) sb = sb + B(i, d * NU + a) * ddu[a];
        nxt[d] = sa + sb + cres(i, d);
      }
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        ddx[d] = nxt[d];
        ddX(i + 1, d) = nxt[d];
      }
    }

    // fraction-to-boundary damping
    float amin = kInf;
#pragma unroll 1
    for (int i = 0; i <= N; ++i) {
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        const float dxv = dX(i, d), ddv = ddX(i, d);
        amin = ftb(lbx(i, d) + dxv, ddv, amin, k_.delta);
        amin = ftb(ubx(i, d) - dxv, -ddv, amin, k_.delta);
      }
      for (int r = 0; r < n_h; ++r) {
        float wh = h0(i, r);
        float dwh = 0.0f;
#pragma unroll
        for (int d = 0; d < NX; ++d) {
          wh = wh + Jh(i, r * NX + d) * dX(i, d);
          dwh = dwh + Jh(i, r * NX + d) * ddX(i, d);
        }
        amin = ftb(wh, dwh, amin, k_.delta);
      }
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const float duv = dU(i, a), ddv = ddU(i, a);
        amin = ftb(lbu(i, a) + duv, ddv, amin, k_.delta);
        amin = ftb(ubu(i, a) - duv, -ddv, amin, k_.delta);
      }
    }
    const float alpha = minp(1.0f, amin);

    // update and step norm
    float mx = 0.0f;
#pragma unroll 1
    for (int i = 0; i <= N; ++i) {
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        const float s = alpha * ddX(i, d);
        dX(i, d) = dX(i, d) + s;
        mx = maxp(mx, fabsf(s));
      }
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const float s = alpha * ddU(i, a);
        dU(i, a) = dU(i, a) + s;
        mx = maxp(mx, fabsf(s));
      }
    }
    *kkt_out = mx;
  }
};

template <int NX, int NU>
__global__ void __launch_bounds__(32) barrier_qp_kernel(DmmQPArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.Bn) return;
  const int Bn = a.Bn;
  const int hx = a.n_h * NX;
  Problem<NX, NU> pr{
      Table{a.A, NX * NX, Bn, b},   Table{a.B, NX * NU, Bn, b},   Table{a.c, NX, Bn, b},
      Table{a.Q, NX * NX, Bn, b},   Table{a.qx, NX, Bn, b},       Table{a.R, NU * NU, Bn, b},
      Table{a.ru, NU, Bn, b},       Table{a.lbx, NX, Bn, b},      Table{a.ubx, NX, Bn, b},
      Table{a.lbu, NU, Bn, b},      Table{a.ubu, NU, Bn, b},      Table{a.Jh, hx, Bn, b},
      Table{a.h0, a.n_h, Bn, b},    Table{a.S, NU * NX, Bn, b},   OutTable{a.dX, NX, Bn, b},
      OutTable{a.dU, NU, Bn, b},    OutTable{a.K, NU * NX, Bn, b}, OutTable{a.k, NU, Bn, b},
      OutTable{a.ddX, NX, Bn, b},   OutTable{a.ddU, NU, Bn, b},   OutTable{a.cres, NX, Bn, b},
      a.N,                          a.n_h,                        a.has_S != 0};
  const Consts k_{a.misc[0], a.misc[1], a.misc[2], a.misc[3], a.misc[4]};
  const Table dx0{a.dx0, NX, Bn, b};

  // initial iterate: δX = 0 except δx₀ = dx0, δU = 0
#pragma unroll
  for (int d = 0; d < NX; ++d) pr.dX(0, d) = dx0(0, d);
#pragma unroll 1
  for (int i = 0; i < a.N; ++i) {
#pragma unroll
    for (int d = 0; d < NX; ++d) pr.dX(i + 1, d) = 0.0f;
#pragma unroll
    for (int u = 0; u < NU; ++u) pr.dU(i, u) = 0.0f;
  }

#pragma unroll 1
  for (int it = 0; it < a.num_iters; ++it) pr.newton_iter(a.mus[it], k_, &a.kkt[b]);

  // condensing roll: exact linear-dynamics propagation of δU
  float dx[NX];
#pragma unroll
  for (int d = 0; d < NX; ++d) dx[d] = dx0(0, d);
#pragma unroll 1
  for (int i = 0; i < a.N; ++i) {
    float nxt[NX];
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float sa = pr.A(i, d * NX) * dx[0];
#pragma unroll
      for (int e = 1; e < NX; ++e) sa = sa + pr.A(i, d * NX + e) * dx[e];
      float sb = pr.B(i, d * NU) * pr.dU(i, 0);
#pragma unroll
      for (int u = 1; u < NU; ++u) sb = sb + pr.B(i, d * NU + u) * pr.dU(i, u);
      nxt[d] = sa + sb + pr.c(i, d);
    }
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      dx[d] = nxt[d];
      pr.dX(i + 1, d) = nxt[d];
    }
  }
}

template <int NX, int NU>
cudaError_t launch_qp(const DmmQPArgs& a, cudaStream_t s) {
  constexpr int kThreads = 32;
  barrier_qp_kernel<NX, NU><<<(a.Bn + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(DmmQPArgs), checked against the ctypes mirror at load time.
int dmm_qp_args_size() { return static_cast<int>(sizeof(DmmQPArgs)); }

// The fused QP for Bn problems (Bn = 1: the per-problem solve). Shapes
// instantiated: 2 ≤ nx ≤ 5, 1 ≤ nu ≤ min(nx, 4); any other returns
// cudaErrorInvalidValue without launching.
int dmm_barrier_qp(const DmmQPArgs* args, void* stream) {
  const DmmQPArgs a = *args;
  if (a.Bn < 1 || a.N < 1 || a.n_h < 0 || a.num_iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.nx * 8 + a.nu) {
    case 2 * 8 + 1: return static_cast<int>(launch_qp<2, 1>(a, s));
    case 2 * 8 + 2: return static_cast<int>(launch_qp<2, 2>(a, s));
    case 3 * 8 + 1: return static_cast<int>(launch_qp<3, 1>(a, s));
    case 3 * 8 + 2: return static_cast<int>(launch_qp<3, 2>(a, s));
    case 3 * 8 + 3: return static_cast<int>(launch_qp<3, 3>(a, s));
    case 4 * 8 + 1: return static_cast<int>(launch_qp<4, 1>(a, s));
    case 4 * 8 + 2: return static_cast<int>(launch_qp<4, 2>(a, s));
    case 4 * 8 + 3: return static_cast<int>(launch_qp<4, 3>(a, s));
    case 4 * 8 + 4: return static_cast<int>(launch_qp<4, 4>(a, s));
    case 5 * 8 + 1: return static_cast<int>(launch_qp<5, 1>(a, s));
    case 5 * 8 + 2: return static_cast<int>(launch_qp<5, 2>(a, s));
    case 5 * 8 + 3: return static_cast<int>(launch_qp<5, 3>(a, s));
    case 5 * 8 + 4: return static_cast<int>(launch_qp<5, 4>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
