// Race-car (kinematic bicycle) MPPI kernels for Hopper (sm_90a), behind a
// plain C ABI.
//
// Replaces two Pallas TPU kernels:
//   dmm_bicycle_rollout_costs <- dnn_mppi_mpc_tpu/ops/pallas/rollout_bicycle.py:171
//                                bicycle_rollout_costs (split rollout, ε in, S out)
//   dmm_bicycle_tick          <- dnn_mppi_mpc_tpu/ops/pallas/bicycle_tick.py:267
//                                bicycle_mppi_tick (ε injected or drawn from the
//                                hash stream, rollout, softmax, Σ w·ε)
//
// What bounds them on the card. The race car's waypoint window is the whole
// path (W = 200), so a sample walks K·(T+1)·W = 10 240·21·200 ≈ 43 M window
// rows per tick (4× the diff-drive flagship's 10.4 M), each a dependent
// compare-and-select, plus 9 outline points × n_obs circle tests per (k, t).
// About 0.4 GFLOP and at most 3.3 MB of ε per tick: far from the card's
// 67 TFLOP/s and 3.35 TB/s. With one thread per sample (10 240 threads, ~2.4
// warps per SM) the rollout is bound by the latency of each thread's
// T·W-deep select chain. Design: the diff-drive layout (64-thread blocks,
// per-tick constants and the (W, 4) window in shared memory, read one float4
// row at a time); the softmax and Σ w·ε are the diff-drive tick's own
// reductions (mppi_reductions.cuh). Later work: split the W search across
// lanes (a warp-level min over W / 32 rows per lane) to shorten the chain.
//
// Built with -fmad=false (see _build.py), so the rollout rounds op for op
// like its plain PyTorch version (ops/cuda/rollout_bicycle.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bicycle_rollout.cuh"
#include "mppi_reductions.cuh"

namespace {

size_t bicycle_smem_bytes(const DmmBicycleArgs& p) {
  return static_cast<size_t>(4 * p.T + 4 * p.W + 3 * p.n_obs) * sizeof(float);
}

template <bool ISO, bool GEN>
__global__ void bicycle_rollout_kernel(DmmBicycleArgs p) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + 2 * p.T;
  float* swin = sa + 2 * p.T;  // 16-byte aligned: 4·T floats in
  float* sobs = swin + 4 * p.W;
  for (int i = threadIdx.x; i < 2 * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < 4 * p.W; i += blockDim.x) swin[i] = p.window[i];
  for (int i = threadIdx.x; i < 3 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  p.S[k] = dmm_bicycle_sample<ISO, GEN>(p, k, su, sa, reinterpret_cast<const float4*>(swin),
                                        sobs);
}

cudaError_t launch_bicycle_rollout(const DmmBicycleArgs& p, cudaStream_t s) {
  const size_t smem = bicycle_smem_bytes(p);
  if (p.K <= 0 || p.T <= 0 || p.W <= 0 || p.n_obs < 0 || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int blocks = (p.K + kRolloutThreads - 1) / kRolloutThreads;
  if (p.iso_xy) {
    if (p.eps_mode == 0) bicycle_rollout_kernel<true, false><<<blocks, kRolloutThreads, smem, s>>>(p);
    else bicycle_rollout_kernel<true, true><<<blocks, kRolloutThreads, smem, s>>>(p);
  } else {
    if (p.eps_mode == 0) bicycle_rollout_kernel<false, false><<<blocks, kRolloutThreads, smem, s>>>(p);
    else bicycle_rollout_kernel<false, true><<<blocks, kRolloutThreads, smem, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(DmmBicycleArgs), checked against the ctypes mirror at load time.
int dmm_bicycle_args_size() { return static_cast<int>(sizeof(DmmBicycleArgs)); }

// Split bicycle rollout: S only (ε injected, eps_mode 0).
int dmm_bicycle_rollout_costs(const DmmBicycleArgs* args, void* stream) {
  const DmmBicycleArgs p = *args;
  if (p.eps_mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bicycle_rollout(p, static_cast<cudaStream_t>(stream)));
}

// Fused bicycle tick: rollout (ε read, or generated and stored), then the
// softmax statistics and w, then Σ w·ε over the stored ε. Three launches on
// one stream.
int dmm_bicycle_tick(const DmmBicycleArgs* args, void* stream) {
  const DmmBicycleArgs p = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_bicycle_rollout(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DmmReduceArgs r{p.S, p.w, p.stats, p.eps, p.w_eps, p.chol, p.seed, p.K, p.K, p.inv_temp};
  return static_cast<int>(launch_reductions<false>(r, p.T, s));
}

}  // extern "C"
