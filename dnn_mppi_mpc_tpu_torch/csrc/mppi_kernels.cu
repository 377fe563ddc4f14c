// Diff-drive MPPI kernels for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces three Pallas TPU kernels:
//   dmm_rollout_costs  <- dnn_mppi_mpc_tpu/ops/pallas/rollout.py:146
//                         diffdrive_rollout_costs (split rollout, ε in, S out)
//   dmm_mppi_tick      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick.py:733
//                         diffdrive_mppi_tick (eps_mode 0 or 1, k_blk == K)
//                      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py:317
//                         diffdrive_mppi_tick_blocked (eps_mode 2, K-blocked
//                         noise stream, no epilogue)
//
// What bounds them on the card. The rollout does about T·(9·W + 40) float
// operations per sample (~0.1 GFLOP per tick at K = 10 240, T = 50, W = 20)
// and reads at most 8·T·K bytes of ε (4 MB, which stays in the 50 MB L2):
// neither the 67 TFLOP/s nor the 3.35 TB/s is near. One thread per sample
// gives only K threads (10 240 = ~2.4 warps per SM), so the rollout is bound
// by the latency of each thread's dependent T·W compare-and-select chain.
// Design: 64-thread blocks so that every one of the 132 SMs gets a block at
// the flagship K, per-tick constants staged in shared memory, no atomics.
// The reductions are small: a single-block pass for ρ = min S and
// η = Σ exp(−λ(S−ρ)) (which also writes w), one block per t for Σₖ wₖ·εₖ
// (both in mppi_reductions.cuh, shared with the bicycle tick), and a
// one-block epilogue; each is a fixed-order tree, so results repeat
// bit for bit from run to run. Not yet done (later work): splitting the W
// search across lanes, regenerating ε in the single-block tick instead of
// storing it, fusing the four launches.
//
// Built with -fmad=false (see _build.py): no implicit FMA contraction, so the
// kernel rounds like the plain PyTorch version op for op; the epilogue's
// filter product uses explicit fmaf.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "diffdrive_rollout.cuh"
#include "mppi_reductions.cuh"

namespace {

// The fields of DmmArgs that the reductions read and write.
DmmReduceArgs reduce_args(const DmmArgs& p) {
  return DmmReduceArgs{p.S, p.w, p.stats, p.eps, p.w_eps, p.chol, p.seed,
                       p.K, p.k_blk, p.inv_temp};
}

// Stage u, a, the window and the obstacles in shared memory.
__device__ __forceinline__ void stage_params(const DmmArgs& p, float* su, float* sa,
                                             float* swin, float* sobs) {
  for (int i = threadIdx.x; i < 2 * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < 3 * p.W; i += blockDim.x) swin[i] = p.window[i];
  for (int i = threadIdx.x; i < 5 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
}

template <bool ISO, bool LAST, bool GEN>
__global__ void rollout_kernel(DmmArgs p) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + 2 * p.T;
  float* swin = sa + 2 * p.T;
  float* sobs = swin + 3 * p.W;
  stage_params(p, su, sa, swin, sobs);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  p.S[k] = dmm_rollout_sample<ISO, LAST, GEN>(p, k, su, sa, swin, sobs);
}

// u_new = u + F·w_eps (fmaf, full f32), non-finite hold, horizon shift.
// One block of >= T threads; thread t owns row t.
__global__ void epilogue_kernel(DmmArgs p) {
  extern __shared__ float un_s[];  // (T, 2)
  const int t = threadIdx.x, T = p.T;
  const bool active = t < T;
  float un0 = 0.0f, un1 = 0.0f;
  bool ok = true;
  if (active) {
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int s = 0; s < T; ++s) {
      const float f = p.filter_t[s * T + t];
      acc0 = fmaf(p.w_eps[2 * s], f, acc0);
      acc1 = fmaf(p.w_eps[2 * s + 1], f, acc1);
    }
    un0 = p.u[2 * t] + acc0;
    un1 = p.u[2 * t + 1] + acc1;
    ok = isfinite(un0) && isfinite(un1);
  }
  const bool all_ok = __syncthreads_and(ok) != 0;
  if (active) {
    if (!all_ok) {
      un0 = p.u[2 * t];
      un1 = p.u[2 * t + 1];
    }
    p.u_new[2 * t] = un0;
    p.u_new[2 * t + 1] = un1;
    un_s[2 * t] = un0;
    un_s[2 * t + 1] = un1;
  }
  __syncthreads();
  if (active) {
    const int src = t + 1 < T ? t + 1 : T - 1;
    p.u_shift[2 * t] = un_s[2 * src];
    p.u_shift[2 * t + 1] = un_s[2 * src + 1];
  }
  if (t == 0) p.finite[0] = all_ok ? 1.0f : 0.0f;
}

template <bool ISO, bool LAST>
void launch_rollout_iso_last(const DmmArgs& p, int blocks, size_t smem, cudaStream_t s) {
  if (p.eps_mode == 0)
    rollout_kernel<ISO, LAST, false><<<blocks, kRolloutThreads, smem, s>>>(p);
  else
    rollout_kernel<ISO, LAST, true><<<blocks, kRolloutThreads, smem, s>>>(p);
}

cudaError_t launch_rollout(const DmmArgs& p, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(4 * p.T + 3 * p.W + 5 * p.n_obs) * sizeof(float);
  if (p.K <= 0 || p.T <= 0 || p.W <= 0 || smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (p.eps_mode != 0 && (p.k_blk <= 0 || p.K % p.k_blk != 0)) return cudaErrorInvalidValue;
  const int blocks = (p.K + kRolloutThreads - 1) / kRolloutThreads;
  if (p.iso_xy) {
    if (p.last_only) launch_rollout_iso_last<true, true>(p, blocks, smem, s);
    else launch_rollout_iso_last<true, false>(p, blocks, smem, s);
  } else {
    if (p.last_only) launch_rollout_iso_last<false, true>(p, blocks, smem, s);
    else launch_rollout_iso_last<false, false>(p, blocks, smem, s);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(DmmArgs), checked against the ctypes mirror at load time.
int dmm_args_size() { return static_cast<int>(sizeof(DmmArgs)); }

// Split rollout: S only (ε injected, eps_mode 0).
int dmm_rollout_costs(const DmmArgs* args, void* stream) {
  const DmmArgs p = *args;
  if (p.eps_mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rollout(p, static_cast<cudaStream_t>(stream)));
}

// Fused / K-blocked tick: rollout, softmax statistics and w, Σ w·ε, and the
// epilogue when fuse_epilogue is set. Four launches on one stream at most.
int dmm_mppi_tick(const DmmArgs* args, void* stream) {
  const DmmArgs p = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.T > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_rollout(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = p.eps_mode == 2 ? launch_reductions<true>(reduce_args(p), p.T, s)
                        : launch_reductions<false>(reduce_args(p), p.T, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.fuse_epilogue) {
    const int threads = ((p.T + 31) / 32) * 32;
    epilogue_kernel<<<1, threads, 2 * p.T * sizeof(float), s>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
