// Generic MPPI kernels for Hopper (sm_90a), behind a plain C ABI: the MPPI
// tick for any of the four built-in tile-step families (unicycle, kinematic
// bicycle, four-wheel torque, dynamic bicycle).
//
// Replaces two Pallas TPU kernels:
//   dmm_generic_tick          <- dnn_mppi_mpc_tpu/ops/pallas/generic_tick.py:442
//                                generic_mppi_tick (ε injected or drawn from the
//                                hash stream, rollout, softmax, Σ w·ε, and the
//                                fused epilogue when fuse_epilogue is set)
//   dmm_generic_rollout_costs <- dnn_mppi_mpc_tpu/ops/pallas/generic_tick.py:665
//                                generic_rollout_costs (ε in, S out, with the
//                                shard's k_offset: the rollout_fn of the
//                                sample-sharded scan step)
//
// What bounds them on the card. A sample walks (T+1)·W window rows and T tile
// steps: at the four-wheel example's shape (K = 2 048, T = 25, W = 20, two
// obstacles) about 0.02 GFLOP and 0.8 MB of injected ε per tick, at K = 10 240,
// T = 50 about 0.15 GFLOP; far from the card's 67 TFLOP/s and 3.35 TB/s. One
// thread per sample gives K threads (2 048 = 0.5 warps per SM at the example's
// shape), so the rollout is bound by the latency of each thread's dependent
// T·W compare-and-select chain and its transcendental calls, as the
// diff-drive and bicycle rollouts are. Design: the diff-drive layout
// (64-thread blocks, u, a, the (W, n_track) window and the obstacles staged
// in shared memory under the static 48 KB), the tile step a functor the
// rollout is instantiated on (4 families × LAST × GEN), and the tick's
// softmax, Σ w·ε (regenerating the hash ε rather than storing it, with pair
// p of sample k at step t drawn at counter (p·T + t)·K + k) and epilogue the
// shared NU-templated ones of mppi_reductions.cuh. Later work: split the W
// search across lanes, and more samples per SM at small K.
//
// Built with -fmad=false (see _build.py), so the rollout rounds op for op
// like its plain PyTorch version (ops/cuda/generic_tick.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "generic_rollout.cuh"
#include "mppi_reductions.cuh"

namespace {

template <class F>
size_t generic_smem_bytes(const DmmGenericArgs& p) {
  return static_cast<size_t>(2 * F::NU * p.T + p.n_track * p.W + 5 * p.n_obs) * sizeof(float);
}

template <class F, bool LAST, bool GEN>
__global__ void generic_rollout_kernel(DmmGenericArgs p) {
  constexpr int NU = F::NU;
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + NU * p.T;
  float* swin = sa + NU * p.T;
  float* sobs = swin + p.n_track * p.W;
  for (int i = threadIdx.x; i < NU * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < p.n_track * p.W; i += blockDim.x) swin[i] = p.window[i];
  for (int i = threadIdx.x; i < 5 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.K) return;
  p.S[k] = dmm_generic_sample<F, LAST, GEN>(p, k, su, sa, swin, sobs);
}

template <class F, bool LAST>
void launch_rollout_last(const DmmGenericArgs& p, int blocks, size_t smem, cudaStream_t s) {
  if (p.eps_mode == 0)
    generic_rollout_kernel<F, LAST, false><<<blocks, kRolloutThreads, smem, s>>>(p);
  else
    generic_rollout_kernel<F, LAST, true><<<blocks, kRolloutThreads, smem, s>>>(p);
}

template <class F>
cudaError_t launch_generic_rollout(const DmmGenericArgs& p, cudaStream_t s) {
  const size_t smem = generic_smem_bytes<F>(p);
  if (p.K <= 0 || p.T <= 0 || p.W <= 0 || p.n_track < 2 || p.n_track > F::NX || p.n_obs < 0 ||
      p.eps_mode < 0 || p.eps_mode > 2 || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int blocks = (p.K + kRolloutThreads - 1) / kRolloutThreads;
  if (p.last_only) launch_rollout_last<F, true>(p, blocks, smem, s);
  else launch_rollout_last<F, false>(p, blocks, smem, s);
  return cudaGetLastError();
}

// The whole tick of family F: rollout, softmax statistics and w, Σ w·ε
// (ε read from the buffer, or drawn again from the stream in eps_mode 2),
// and the epilogue. Three or four launches on one stream.
template <class F>
cudaError_t launch_generic_tick(const DmmGenericArgs& p, cudaStream_t s) {
  if (p.T > 1024) return cudaErrorInvalidValue;
  cudaError_t err = launch_generic_rollout<F>(p, s);
  if (err != cudaSuccess) return err;
  const DmmReduceArgs r{p.S, p.w, p.stats, p.eps, p.w_eps, p.chol, p.seed,
                        p.K, p.K, p.inv_temp, 0};
  err = p.eps_mode == 2 ? launch_reductions<true, F::NU>(r, p.T, 1, s)
                        : launch_reductions<false, F::NU>(r, p.T, 1, s);
  if (err != cudaSuccess || !p.fuse_epilogue) return err;
  return launch_epilogue<F::NU>(
      DmmEpilogueArgs{p.filter_t, p.w_eps, p.u, p.u_new, p.u_shift, p.finite, p.T}, s);
}

// Dispatch on the family: `Launch<F>` for p.model.
template <template <class> class Launch>
cudaError_t by_model(const DmmGenericArgs& p, cudaStream_t s) {
  switch (p.model) {
    case 0: return Launch<DmmUnicycleTile>::run(p, s);
    case 1: return Launch<DmmKinematicBicycleTile>::run(p, s);
    case 2: return Launch<DmmFourWheelTile>::run(p, s);
    case 3: return Launch<DmmDynamicBicycleTile>::run(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
struct RolloutOnly {
  static cudaError_t run(const DmmGenericArgs& p, cudaStream_t s) {
    return launch_generic_rollout<F>(p, s);
  }
};

template <class F>
struct WholeTick {
  static cudaError_t run(const DmmGenericArgs& p, cudaStream_t s) {
    return launch_generic_tick<F>(p, s);
  }
};

}  // namespace

extern "C" {

// sizeof(DmmGenericArgs), checked against the ctypes mirror at load time.
int dmm_generic_args_size() { return static_cast<int>(sizeof(DmmGenericArgs)); }

// Split generic rollout: S only (ε injected, eps_mode 0), sample k of this
// shard at global index k + k_offset.
int dmm_generic_rollout_costs(const DmmGenericArgs* args, void* stream) {
  const DmmGenericArgs p = *args;
  if (p.eps_mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_model<RolloutOnly>(p, static_cast<cudaStream_t>(stream)));
}

// Fused generic tick (one block of K samples in the noise stream).
int dmm_generic_tick(const DmmGenericArgs* args, void* stream) {
  return static_cast<int>(by_model<WholeTick>(*args, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
