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
// path (W = 200), so a sample walks (T+1)·W = 21·200 = 4 200 window rows per
// tick, each a compare-and-select, plus 9 outline points × n_obs circle
// tests per (k, t): about 0.4 GFLOP a tick at K = 10 240, and at most 3.3 MB
// of ε, far from the card's 67 TFLOP/s and 3.35 TB/s. One thread per sample
// gave 10 240 threads (~2.4 warps an SM) each walking that chain in order:
// bound by the chain's latency (111 µs, against 10-20 µs of instruction
// throughput).
// Design: G lanes share a sample (bicycle_rollout.cuh), so K·G threads
// (20-39 warps an SM at G = 8 or 16) each walk W/G rows and the group merges
// its partials in log2 G shuffle rounds; the outline points are dealt over
// the lanes, and with hash ε each lane draws every G-th step. The dynamics
// run in every lane of the group, so a sample's dynamics are issued G times:
// at G = 8 the rollout is bound by instruction issue (G = 16 costs 1.4×,
// and the dynamics on one lane shuffled out 2-4 % more; root PERF.md §6).
// 128-thread blocks stage u, a, the window as (x, y) and
// (yaw, v) rows, the outline and the obstacles in shared memory. The tick's softmax and Σ w·ε are the
// diff-drive tick's one-block reductions (mppi_reductions.cuh).
//
// Built with -fmad=false (see _build.py), so the rollout rounds op for op
// like its plain PyTorch version (ops/cuda/rollout_bicycle.py), and the
// group's search returns the sequential scan's row exactly: S bit-equal.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "bicycle_rollout.cuh"
#include "mppi_reductions.cuh"

namespace {

constexpr int kBicycleThreads = 128;
// Lanes a sample. chip_smoke.py builds this file a second time with
// -DDMM_BICYCLE_GROUP=16 to time G = 16 beside it.
#ifndef DMM_BICYCLE_GROUP
#define DMM_BICYCLE_GROUP 8
#endif
constexpr int kBicycleGroup = DMM_BICYCLE_GROUP;

size_t bicycle_smem_bytes(const DmmBicycleArgs& p) {
  return static_cast<size_t>(4 * p.T + 4 * p.W + 2 * kOutlinePoints + 3 * p.n_obs) *
         sizeof(float);
}

template <bool ISO, bool GEN>
__global__ void __launch_bounds__(kBicycleThreads) bicycle_rollout_kernel(DmmBicycleArgs p) {
  constexpr int G = kBicycleGroup;
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + 2 * p.T;
  float2* sxy = reinterpret_cast<float2*>(sa + 2 * p.T);  // 8-byte aligned: 4·T floats in
  float2* syv = sxy + p.W;
  float2* sout = syv + p.W;
  float* sobs = reinterpret_cast<float*>(sout + kOutlinePoints);
  for (int i = threadIdx.x; i < 2 * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < p.W; i += blockDim.x) {
    sxy[i] = make_float2(p.window[4 * i], p.window[4 * i + 1]);
    syv[i] = make_float2(p.window[4 * i + 2], p.window[4 * i + 3]);
  }
  for (int j = threadIdx.x; j < kOutlinePoints; j += blockDim.x)
    sout[j] = make_float2(p.outline_x[j] * p.half_l, p.outline_y[j] * p.half_w);
  for (int i = threadIdx.x; i < 3 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
  const int lane = threadIdx.x & (G - 1);
  const int k = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  const bool active = k < p.K;
  const float S = dmm_bicycle_sample<G, ISO, GEN>(p, active ? k : p.K - 1, lane, active, su, sa,
                                                  sxy, syv, sout, sobs);
  if (active && lane == 0) p.S[k] = S;
}

cudaError_t launch_bicycle_rollout(const DmmBicycleArgs& p, cudaStream_t s) {
  const size_t smem = bicycle_smem_bytes(p);
  if (p.K <= 0 || p.K > (1 << 26) || p.T <= 0 || p.W <= 0 || p.n_obs < 0 ||
      smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(p.K) * kBicycleGroup;
  const int blocks = static_cast<int>((threads + kBicycleThreads - 1) / kBicycleThreads);
  if (p.iso_xy) {
    if (p.eps_mode == 0) bicycle_rollout_kernel<true, false><<<blocks, kBicycleThreads, smem, s>>>(p);
    else bicycle_rollout_kernel<true, true><<<blocks, kBicycleThreads, smem, s>>>(p);
  } else {
    if (p.eps_mode == 0) bicycle_rollout_kernel<false, false><<<blocks, kBicycleThreads, smem, s>>>(p);
    else bicycle_rollout_kernel<false, true><<<blocks, kBicycleThreads, smem, s>>>(p);
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
  return static_cast<int>(launch_reductions<false>(r, p.T, 1, s));
}

}  // extern "C"
