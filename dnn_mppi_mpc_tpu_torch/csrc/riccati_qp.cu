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
// once and does ~0.2 MFLOP, but the Riccati recursion is a chain of 12·N
// dependent stage steps, each a few dozen dependent operations and two or
// three IEEE divisions. The bound is the latency of that chain.
//
// Design: one warp per problem, one problem a block (grid = the problem
// count; __syncwarp is the only barrier). The warp first copies its problem's
// tables into shared memory, coalesced, as one record per stage: the fixed
// fields at compile-time offsets (templates on NX, NU), then the h rows and
// S, the record length rounded up to an odd number of floats so that 32
// lanes reading 32 stages hit 32 banks. The record also holds the iterate
// (δx, δu), the Newton step, the gains, the dynamics residual and the folded
// stage terms: nothing but the result goes back to device memory. A Newton
// iteration is four phases:
//   A (stage-parallel): lane ℓ folds stages ℓ, ℓ+32, …: Qxx and q with the
//     x-bound and h-row barriers (the terminal stage too), Ruu and r_u with
//     the u-bound barriers, the S terms, cr = A·δx + B·δu + c − δx₊;
//   B (serial over the stages): the P-dependent core of the backward sweep
//     (PA, PB, Pc, Luu, Lux, lu, the pivoted LU, K, k, the value update),
//     its products spread over the warp's lanes and exchanged with
//     __shfl_sync, the elimination replicated in every lane and the back
//     substitution one right-hand column a lane;
//   C (serial, one lane): the forward sweep for the step (δ²x, δ²u);
//   D (stage-parallel): each lane bounds α over its stages' x, u and h rows,
//     a __shfl_xor_sync tree of minp gives α; each lane updates its stages,
//     a tree of maxp gives kkt.
// Then one lane rolls δU through the dynamics and the warp writes δX, δU
// out, coalesced. Shared memory a problem: (N + 1) records (qp_stage_floats
// in ops/cuda/riccati_qp.py mirrors the count; the launch checks it).
//
// The operations run in the Pallas body's order (sums left to right from the
// first term, the same symmetrisations, pivoting and selects; every element
// of phases A and D and every product of phase B with the same operations as
// a serial sweep), and the library is built with -fmad=false (see
// _build.py), so the kernel rounds op for op like its plain PyTorch version
// (ops/cuda/riccati_qp.py). min and max pass a NaN on, as
// jnp.minimum/torch.minimum do; both are exact, so the trees' order does not
// matter.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" {

// The stage tables, in the order of DmmQPArgs::tab (ops/cuda/riccati_qp.py
// TABLES): A (N, nx·nx), B (N, nx·nu), c (N, nx), Q (N+1, nx·nx), qx (N+1,
// nx) the LS gradient at δ = 0, R (N, nu·nu), ru (N, nu), lbx / ubx (N+1,
// nx) and lbu / ubu (N, nu) the margins at δ = 0, Jh (N+1, n_h·nx) and h0
// (N+1, n_h) (unused when n_h = 0), S (N, nu·nx) (unused unless has_S), dx0
// (nx). Element (row, col) of problem b's stage i of table t lies at
// tab[t] + b·b_stride[t] + i·s_stride[t] + row·r_stride[t] + col: a stage is
// rows of contiguous elements (a vector table has one row).
enum DmmQPTable {
  kTabA, kTabB, kTabC, kTabQ, kTabQx, kTabR, kTabRu, kTabLbx, kTabUbx, kTabLbu, kTabUbu,
  kTabJh, kTabH0, kTabS, kTabDx0, kNumQPTables
};

// One launch's arguments. mus (num_iters,) and misc (5,) = (δ, bound
// stiffness, h stiffness, h slope, Luu regularisation) are shared by all.
struct DmmQPArgs {
  const float* mus;
  const float* misc;
  const float* tab[kNumQPTables];
  long long b_stride[kNumQPTables];  // floats between problems (0: shared)
  long long s_stride[kNumQPTables];  // floats between stages (0: one stage for all)
  long long r_stride[kNumQPTables];  // floats between a stage's rows
  float* dX;   // out (Bn, N+1, nx)
  float* dU;   // out (Bn, N, nu)
  float* kkt;  // out (Bn,)
  int Bn;
  int N;
  int nx;
  int nu;
  int n_h;
  int num_iters;
  int has_S;
  int stage_floats;  // floats a stage record takes, as the wrapper counted them
};

}  // extern "C"

namespace {

constexpr float kInf = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

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

// The stage record: offsets (in floats) of its fixed fields. The x part is
// used by all N + 1 stages, the u part by stages 0..N-1; the h rows (Jh, h0)
// and S follow at FIXED.
template <int NX, int NU>
struct Rec {
  // x part: the tables, the iterate, the step, the folded terms
  static constexpr int Q = 0, QX = Q + NX * NX, LBX = QX + NX, UBX = LBX + NX, DX = UBX + NX,
                       DDX = DX + NX, QF = DDX + NX, QFV = QF + NX * NX,
                       // u part
      A = QFV + NX, B = A + NX * NX, C = B + NX * NU, R = C + NX, RU = R + NU * NU,
                       LBU = RU + NU, UBU = LBU + NU, DU = UBU + NU, DDU = DU + NU,
                       K = DDU + NU, KV = K + NU * NX, CR = KV + NU, RF = CR + NX,
                       RFV = RF + NU * NU, FIXED = RFV + NU;
};

// floats of one stage record, odd (qp_stage_floats in ops/cuda/riccati_qp.py)
template <int NX, int NU>
__host__ __device__ constexpr int stage_floats(int n_h, int has_S) {
  return (Rec<NX, NU>::FIXED + n_h * (NX + 1) + (has_S ? NU * NX : 0)) | 1;
}

// where table t goes in the record, its floats a stage, the floats of one of
// its rows, and its stages
template <int NX, int NU>
__device__ __forceinline__ void table_spec(int t, int N, int n_h, int has_S, int& off, int& per,
                                           int& cols, int& stages) {
  using RC = Rec<NX, NU>;
  const int N1 = N + 1;
  switch (t) {
    case kTabA: off = RC::A; per = NX * NX; cols = NX; stages = N; break;
    case kTabB: off = RC::B; per = NX * NU; cols = NU; stages = N; break;
    case kTabC: off = RC::C; per = NX; cols = NX; stages = N; break;
    case kTabQ: off = RC::Q; per = NX * NX; cols = NX; stages = N1; break;
    case kTabQx: off = RC::QX; per = NX; cols = NX; stages = N1; break;
    case kTabR: off = RC::R; per = NU * NU; cols = NU; stages = N; break;
    case kTabRu: off = RC::RU; per = NU; cols = NU; stages = N; break;
    case kTabLbx: off = RC::LBX; per = NX; cols = NX; stages = N1; break;
    case kTabUbx: off = RC::UBX; per = NX; cols = NX; stages = N1; break;
    case kTabLbu: off = RC::LBU; per = NU; cols = NU; stages = N; break;
    case kTabUbu: off = RC::UBU; per = NU; cols = NU; stages = N; break;
    case kTabJh: off = RC::FIXED; per = n_h * NX; cols = NX; stages = N1; break;
    case kTabH0: off = RC::FIXED + n_h * NX; per = n_h; cols = n_h; stages = N1; break;
    default:
      off = RC::FIXED + n_h * (NX + 1); per = NU * NX; cols = NX; stages = has_S ? N : 0;
      break;
  }
}

// the partial-pivot LU of the augmented rows [Luu | Lux | lu]: bubble the
// max-|column i| row into position i, eliminate below it
template <int NX, int NU>
__device__ __forceinline__ void lu_eliminate(float rows[NU][NU + NX + 1]) {
  constexpr int W = NU + NX + 1;
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
    if (ii + 1 < NU) {
      const float inv_p = 1.0f / rows[ii][ii];
#pragma unroll
      for (int j = ii + 1; j < NU; ++j) {
        const float f = rows[j][ii] * inv_p;
#pragma unroll
        for (int t = ii; t < W; ++t) rows[j][t] = rows[j][t] - f * rows[ii][t];
      }
    }
  }
}

// back substitution of one right-hand column b (column NU + ci of the
// eliminated rows): x[ii] = (b[ii] − Σ_{t>ii} rows[ii][t]·x[t]) / rows[ii][ii]
template <int NX, int NU>
__device__ __forceinline__ void back_substitute(const float rows[NU][NU + NX + 1],
                                                const float b[NU], float x[NU]) {
#pragma unroll
  for (int ii = NU - 1; ii >= 0; --ii) {
    float s = b[ii];
#pragma unroll
    for (int t = ii + 1; t < NU; ++t) s = s - rows[ii][t] * x[t];
    x[ii] = s / rows[ii][ii];
  }
}

// element idx of a product spread over the warp, E elements in all: lane
// idx mod 32 holds it, in v[0] below 32 and v[1] above
template <int E>
__device__ __forceinline__ float spread_get(const float (&v)[2], int idx) {
  const float g0 = __shfl_sync(kFull, v[0], idx & 31);
  if (E <= 32) return g0;
  const float g1 = __shfl_sync(kFull, v[1], idx & 31);
  return idx < 32 ? g0 : g1;
}

template <int NX, int NU>
struct Problem {
  using RC = Rec<NX, NU>;
  float* rec;  // stage i's record at rec + i·SS
  int SS, N, n_h, lane;
  bool has_S;

  __device__ float* st(int i) const { return rec + i * SS; }
  __device__ int jh() const { return RC::FIXED; }
  __device__ int h0() const { return RC::FIXED + n_h * NX; }
  __device__ int s_off() const { return RC::FIXED + n_h * (NX + 1); }

  // Phase A for stage i: Qxx = Q + barrier diag + Jhᵀ·h''·Jh and
  // q = qx + Q·δx + barrier + Jhᵀ·h' (+ Sᵀ·δu); below N also Ruu, r_u
  // (+ S·δx) and the dynamics residual cr.
  __device__ void fold(int i, float mu, const Consts& k_) const {
    float* s_ = st(i);
    float Qxx[NX][NX], q[NX], dXi[NX];
#pragma unroll
    for (int d = 0; d < NX; ++d) dXi[d] = s_[RC::DX + d];
#pragma unroll
    for (int r = 0; r < NX; ++r)
#pragma unroll
      for (int e = 0; e < NX; ++e) Qxx[r][e] = s_[RC::Q + r * NX + e];
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float s = Qxx[d][0] * dXi[0];
#pragma unroll
      for (int e = 1; e < NX; ++e) s = s + Qxx[d][e] * dXi[e];
      q[d] = s_[RC::QX + d] + s;
    }
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      float gl, hl, gu, hu;
      rb(s_[RC::LBX + d] + dXi[d], mu, k_.stiff, k_.delta, gl, hl);
      rb(s_[RC::UBX + d] - dXi[d], mu, k_.stiff, k_.delta, gu, hu);
      q[d] = q[d] + gl - gu;
      Qxx[d][d] = Qxx[d][d] + hl + hu;
    }
    for (int r = 0; r < n_h; ++r) {
      float Jr[NX];
#pragma unroll
      for (int d = 0; d < NX; ++d) Jr[d] = s_[jh() + r * NX + d];
      float s = Jr[0] * dXi[0];
#pragma unroll
      for (int d = 1; d < NX; ++d) s = s + Jr[d] * dXi[d];
      const float wh = s_[h0() + r] + s;
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

    if (i < N) {
      float dUi[NU], Ruu[NU][NU], r_u[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) dUi[a] = s_[RC::DU + a];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int b = 0; b < NU; ++b) Ruu[a][b] = s_[RC::R + a * NU + b];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = Ruu[a][0] * dUi[0];
#pragma unroll
        for (int b = 1; b < NU; ++b) s = s + Ruu[a][b] * dUi[b];
        r_u[a] = s_[RC::RU + a] + s;
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float gl, hl, gu, hu;
        rb(s_[RC::LBU + a] + dUi[a], mu, k_.stiff, k_.delta, gl, hl);
        rb(s_[RC::UBU + a] - dUi[a], mu, k_.stiff, k_.delta, gu, hu);
        r_u[a] = r_u[a] + gl - gu;
        Ruu[a][a] = Ruu[a][a] + hl + hu;
      }
      if (has_S) {
        const float* Sm = s_ + s_off();  // (NU, NX)
#pragma unroll
        for (int d = 0; d < NX; ++d) {
          float s = Sm[d] * dUi[0];
#pragma unroll
          for (int a = 1; a < NU; ++a) s = s + Sm[a * NX + d] * dUi[a];
          q[d] = q[d] + s;
        }
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          float s = Sm[a * NX] * dXi[0];
#pragma unroll
          for (int d = 1; d < NX; ++d) s = s + Sm[a * NX + d] * dXi[d];
          r_u[a] = r_u[a] + s;
        }
      }
      const float* nxt = st(i + 1);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        float sa = s_[RC::A + d * NX] * dXi[0];
#pragma unroll
        for (int e = 1; e < NX; ++e) sa = sa + s_[RC::A + d * NX + e] * dXi[e];
        float sb = s_[RC::B + d * NU] * dUi[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) sb = sb + s_[RC::B + d * NU + a] * dUi[a];
        s_[RC::CR + d] = sa + sb + s_[RC::C + d] - nxt[RC::DX + d];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int b = 0; b < NU; ++b) s_[RC::RF + a * NU + b] = Ruu[a][b];
        s_[RC::RFV + a] = r_u[a];
      }
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int e = 0; e < NX; ++e) s_[RC::QF + r * NX + e] = Qxx[r][e];
      s_[RC::QFV + r] = q[r];
    }
  }

  // Phase B: the backward sweep from the terminal fold, across the warp.
  // Each product is computed whole by one lane, its terms in the order of
  // a serial sweep, and passed on with __shfl_sync. P lives spread (lane
  // r·NX + c holds P[r][c], lane r holds p[r]); step 1 spreads P·[A | B |
  // cr] (NX × MC), step 2 [Lraw | Lux | lu] (NU × W2), step 3 eliminates
  // in every lane and back-substitutes in each lane the column its step-4
  // element needs (the IEEE divisions would be most of a stage's issue
  // slots on one lane), step 4 spreads [Pn | pn] (NX × (NX + 1)).
  __device__ void backward(float reg) const {
    constexpr int MC = NX + NU + 1, E1 = NX * MC, H1 = E1 > 32 ? 2 : 1;
    constexpr int W2 = NU + NX + 1, E2 = NU * W2, H2 = E2 > 32 ? 2 : 1;
    constexpr int E4 = NX * (NX + 1);
    static_assert(E1 <= 64 && E2 <= 64 && E4 <= 32, "two lane rounds at most");
    // what this lane computes, fixed over the stages: record offsets and
    // source lanes (lanes past a step's last element repeat it)
    int r1[2], m1[2], ms1[2];  // step 1: row r1, column at record offset m1, stride ms1
    int b2[2], c2s[2], base2[2];  // step 2: B column, step-1 column, the added term
    bool ppc2[2], zero2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = min(lane + 32 * h, E1 - 1);
      r1[h] = e / MC;
      const int col = e - r1[h] * MC;
      m1[h] = col < NX ? RC::A + col : (col < NX + NU ? RC::B + (col - NX) : RC::CR);
      ms1[h] = col < NX ? NX : (col < NX + NU ? NU : 1);
      const int f = min(lane + 32 * h, E2 - 1);
      const int a = f / W2, c2 = f - a * W2;
      b2[h] = RC::B + a;
      c2s[h] = c2 < NU ? NX + c2 : c2 - NU;  // PB column, else PA column
      ppc2[h] = c2 >= NU + NX;
      zero2[h] = c2 >= NU && c2 < NU + NX && !has_S;
      base2[h] = c2 < NU ? RC::RF + a * NU + c2
                         : c2 < NU + NX ? s_off() + a * NX + (c2 - NU) : RC::RFV + a;
    }
    const int e4 = min(lane, E4 - 1);
    const int r4 = e4 / (NX + 1), cc4 = e4 - r4 * (NX + 1);
    const int base4 = cc4 < NX ? RC::QF + r4 * NX + cc4 : RC::QFV + r4;
    // the right-hand column this lane back-substitutes: the one its step-4
    // element needs (lanes 0..NX take columns 0..NX, and store them)
    const int ci = cc4;
    const int k_off = lane < NX ? RC::K + lane : RC::KV, k_stride = lane < NX ? NX : 1;
    const int pr = lane / NX, pc = lane - (lane / NX) * NX;

    const float* last = st(N);
    float Pv = last[RC::QF + min(lane, NX * NX - 1)];
    float pv = last[RC::QFV + min(lane, NX - 1)];
#pragma unroll 1
    for (int j = 0; j < N; ++j) {
      float* s_ = st(N - 1 - j);
      // step 1: element e = r·MC + col of P·[A | B | cr], lane e mod 32
      // (v1[0] for e < 32, v1[1] above)
      float v1[2];
#pragma unroll
      for (int h = 0; h < H1; ++h) {
        const float* m = s_ + m1[h];
        float s = __shfl_sync(kFull, Pv, r1[h] * NX) * m[0];
#pragma unroll
        for (int t = 1; t < NX; ++t)
          s = s + __shfl_sync(kFull, Pv, r1[h] * NX + t) * m[t * ms1[h]];
        v1[h] = s;
      }
      if (H1 == 1) v1[1] = v1[0];
      float ppc[NX];  // p + Pc, in every lane
#pragma unroll
      for (int t = 0; t < NX; ++t)
        ppc[t] = __shfl_sync(kFull, pv, t) + spread_get<E1>(v1, t * MC + NX + NU);

      // step 2: element e = a·W2 + c2 of [Lraw | Lux | lu] (Lraw unsymmetrised)
      float v2[2];
#pragma unroll
      for (int h = 0; h < H2; ++h) {
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < NX; ++t) {
          const float xv = spread_get<E1>(v1, t * MC + c2s[h]);
          const float x_t = ppc2[h] ? ppc[t] : xv;
          const float b_ta = s_[b2[h] + t * NU];
          s = t == 0 ? b_ta * x_t : s + b_ta * x_t;
        }
        const float base = zero2[h] ? 0.0f : s_[base2[h]];
        v2[h] = base + s;
      }
      if (H2 == 1) v2[1] = v2[0];
      float raw[NU][W2];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int c = 0; c < W2; ++c) raw[a][c] = spread_get<E2>(v2, a * W2 + c);
      float rows[NU][NU + NX + 1];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int b = 0; b < NU; ++b)
          rows[a][b] = 0.5f * (raw[a][b] + raw[b][a]) + (a == b ? reg : 0.0f);
#pragma unroll
        for (int c = NU; c < W2; ++c) rows[a][c] = raw[a][c];
      }
      // step 3: the elimination in every lane; each lane back-substitutes
      // column ci of [Lux | lu]; lane ci ≤ NX stores column ci of K (ci <
      // NX) or k
      lu_eliminate<NX, NU>(rows);
      float xc[NU];
      {
        float b[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          b[a] = rows[a][NU];
#pragma unroll
          for (int t = 1; t < NX + 1; ++t) b[a] = ci == t ? rows[a][NU + t] : b[a];
        }
        back_substitute<NX, NU>(rows, b, xc);
      }
      if (lane <= NX) {
#pragma unroll
        for (int a = 0; a < NU; ++a) s_[k_off + a * k_stride] = -xc[a];
      }

      // step 4: element e = r·(NX + 1) + cc of [Pn | pn], lane e
      float sa = 0.0f;
#pragma unroll
      for (int t = 0; t < NX; ++t) {
        const float pa = spread_get<E1>(v1, t * MC + cc4);
        const float y = cc4 < NX ? pa : ppc[t];
        const float a_tr = s_[RC::A + t * NX + r4];
        sa = t == 0 ? a_tr * y : sa + a_tr * y;
      }
      float sl = 0.0f;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float lux = raw[a][NU];
#pragma unroll
        for (int t = 1; t < NX; ++t) lux = r4 == t ? raw[a][NU + t] : lux;
        const float kc = -xc[a];  // K[a][cc], or k[a] at cc = NX
        sl = a == 0 ? lux * kc : sl + lux * kc;
      }
      const float v4 = s_[base4] + sa + sl;
      // P = ½(Pn + Pnᵀ) and p = pn, spread again
      const float a1 = __shfl_sync(kFull, v4, pr * (NX + 1) + pc);
      const float a2 = __shfl_sync(kFull, v4, pc * (NX + 1) + pr);
      Pv = 0.5f * (a1 + a2);
      pv = __shfl_sync(kFull, v4, lane * (NX + 1) + NX);
    }
  }

  // Phase C on one lane: the forward sweep on the residual problem (δ²x₀ = 0)
  __device__ void forward() const {
    float ddx[NX];
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      ddx[d] = 0.0f;
      rec[RC::DDX + d] = 0.0f;
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      float* s_ = st(i);
      float ddu[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = s_[RC::K + a * NX] * ddx[0];
#pragma unroll
        for (int cc = 1; cc < NX; ++cc) s = s + s_[RC::K + a * NX + cc] * ddx[cc];
        ddu[a] = s_[RC::KV + a] + s;
        s_[RC::DDU + a] = ddu[a];
      }
      float nxt[NX];
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        float sa = s_[RC::A + d * NX] * ddx[0];
#pragma unroll
        for (int e = 1; e < NX; ++e) sa = sa + s_[RC::A + d * NX + e] * ddx[e];
        float sb = s_[RC::B + d * NU] * ddu[0];
#pragma unroll
        for (int a = 1; a < NU; ++a) sb = sb + s_[RC::B + d * NU + a] * ddu[a];
        nxt[d] = sa + sb + s_[RC::CR + d];
      }
      float* s1 = st(i + 1);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        ddx[d] = nxt[d];
        s1[RC::DDX + d] = nxt[d];
      }
    }
  }

  // Phase D: α over this lane's stages, then the warp's; the update; the
  // warp's ∞-norm of the step (every lane gets it)
  __device__ float bound_and_update(const Consts& k_) const {
    float amin = kInf;
    for (int i = lane; i <= N; i += 32) {
      const float* s_ = st(i);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        const float dxv = s_[RC::DX + d], ddv = s_[RC::DDX + d];
        amin = ftb(s_[RC::LBX + d] + dxv, ddv, amin, k_.delta);
        amin = ftb(s_[RC::UBX + d] - dxv, -ddv, amin, k_.delta);
      }
      for (int r = 0; r < n_h; ++r) {
        float wh = s_[h0() + r];
        float dwh = 0.0f;
#pragma unroll
        for (int d = 0; d < NX; ++d) {
          wh = wh + s_[jh() + r * NX + d] * s_[RC::DX + d];
          dwh = dwh + s_[jh() + r * NX + d] * s_[RC::DDX + d];
        }
        amin = ftb(wh, dwh, amin, k_.delta);
      }
      if (i < N) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          const float duv = s_[RC::DU + a], ddv = s_[RC::DDU + a];
          amin = ftb(s_[RC::LBU + a] + duv, ddv, amin, k_.delta);
          amin = ftb(s_[RC::UBU + a] - duv, -ddv, amin, k_.delta);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amin = minp(amin, __shfl_xor_sync(kFull, amin, o));
    const float alpha = minp(1.0f, amin);

    float mx = 0.0f;
    for (int i = lane; i <= N; i += 32) {
      float* s_ = st(i);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        const float s = alpha * s_[RC::DDX + d];
        s_[RC::DX + d] = s_[RC::DX + d] + s;
        mx = maxp(mx, fabsf(s));
      }
      if (i < N) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          const float s = alpha * s_[RC::DDU + a];
          s_[RC::DU + a] = s_[RC::DU + a] + s;
          mx = maxp(mx, fabsf(s));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = maxp(mx, __shfl_xor_sync(kFull, mx, o));
    return mx;
  }
};

template <int NX, int NU>
__global__ void __launch_bounds__(32) barrier_qp_kernel(DmmQPArgs a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int N = a.N, SS = a.stage_floats;
  Problem<NX, NU> pr{smem, SS, N, a.n_h, lane, a.has_S != 0};
  using RC = Rec<NX, NU>;

  // stage the tables, coalesced: consecutive lanes read consecutive floats
#pragma unroll
  for (int t = 0; t < kTabDx0; ++t) {
    int off, per, cols, stages;
    table_spec<NX, NU>(t, N, a.n_h, a.has_S, off, per, cols, stages);
    if (per == 0 || stages == 0) continue;
    const float* g = a.tab[t] + b * a.b_stride[t];
    const long long ss = a.s_stride[t], rs = a.r_stride[t];
    for (int idx = lane; idx < per * stages; idx += 32) {
      const int i = idx / per, j = idx - i * per, row = j / cols;
      pr.rec[i * SS + off + j] = __ldg(g + i * ss + row * rs + (j - row * cols));
    }
  }
  // initial iterate: δX = 0 except δx₀ = dx0, δU = 0
  const float* dx0 = a.tab[kTabDx0] + b * a.b_stride[kTabDx0];
  for (int i = lane; i <= N; i += 32) {
    float* s_ = pr.st(i);
#pragma unroll
    for (int d = 0; d < NX; ++d) s_[RC::DX + d] = i == 0 ? __ldg(dx0 + d) : 0.0f;
#pragma unroll
    for (int u = 0; u < NU; ++u) s_[RC::DU + u] = 0.0f;
  }
  const Consts k_{a.misc[0], a.misc[1], a.misc[2], a.misc[3], a.misc[4]};
  __syncwarp();

  float kkt = 0.0f;
#pragma unroll 1
  for (int it = 0; it < a.num_iters; ++it) {
    const float mu = a.mus[it];
    for (int i = lane; i <= N; i += 32) pr.fold(i, mu, k_);
    __syncwarp();
    pr.backward(k_.reg);
    if (lane == 0) pr.forward();
    __syncwarp();
    kkt = pr.bound_and_update(k_);
    __syncwarp();
  }

  // condensing roll: exact linear-dynamics propagation of δU
  if (lane == 0) {
    float dx[NX];
#pragma unroll
    for (int d = 0; d < NX; ++d) {
      dx[d] = __ldg(dx0 + d);
      pr.rec[RC::DX + d] = dx[d];
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      const float* s_ = pr.st(i);
      float nxt[NX];
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        float sa = s_[RC::A + d * NX] * dx[0];
#pragma unroll
        for (int e = 1; e < NX; ++e) sa = sa + s_[RC::A + d * NX + e] * dx[e];
        float sb = s_[RC::B + d * NU] * s_[RC::DU];
#pragma unroll
        for (int u = 1; u < NU; ++u) sb = sb + s_[RC::B + d * NU + u] * s_[RC::DU + u];
        nxt[d] = sa + sb + s_[RC::C + d];
      }
      float* s1 = pr.st(i + 1);
#pragma unroll
      for (int d = 0; d < NX; ++d) {
        dx[d] = nxt[d];
        s1[RC::DX + d] = nxt[d];
      }
    }
    a.kkt[b] = kkt;
  }
  __syncwarp();

  // the outputs, coalesced
  float* oX = a.dX + static_cast<size_t>(b) * (N + 1) * NX;
  for (int idx = lane; idx < (N + 1) * NX; idx += 32) {
    const int i = idx / NX, d = idx - i * NX;
    oX[idx] = pr.rec[i * SS + RC::DX + d];
  }
  float* oU = a.dU + static_cast<size_t>(b) * N * NU;
  for (int idx = lane; idx < N * NU; idx += 32) {
    const int i = idx / NU, u = idx - i * NU;
    oU[idx] = pr.rec[i * SS + RC::DU + u];
  }
}

template <int NX, int NU>
cudaError_t launch_qp(const DmmQPArgs& a, cudaStream_t s) {
  if (a.stage_floats != stage_floats<NX, NU>(a.n_h, a.has_S)) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * static_cast<size_t>(a.stage_floats) * (a.N + 1);
  // the opt-in above 48 KB, once per instantiation and card
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024 && (dev >= 64 || bytes > opted[dev])) {
    err = cudaFuncSetAttribute(barrier_qp_kernel<NX, NU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) opted[dev] = bytes;
  }
  barrier_qp_kernel<NX, NU><<<a.Bn, 32, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(DmmQPArgs), checked against the ctypes mirror at load time.
int dmm_qp_args_size() { return static_cast<int>(sizeof(DmmQPArgs)); }

// The fused QP for Bn problems (Bn = 1: the per-problem solve). Shapes
// instantiated: 2 ≤ nx ≤ 5, 1 ≤ nu ≤ min(nx, 4); any other, or a stage
// record length other than the kernel's, returns cudaErrorInvalidValue
// without launching.
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
