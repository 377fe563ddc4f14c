// Diff-drive MPPI kernels for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces five Pallas TPU kernels:
//   dmm_rollout_costs  <- dnn_mppi_mpc_tpu/ops/pallas/rollout.py:146
//                         diffdrive_rollout_costs (split rollout, ε in, S out)
//   dmm_mppi_tick      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick.py:733
//                         diffdrive_mppi_tick (eps_mode 0 or 1, k_blk == K)
//                      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py:317
//                         diffdrive_mppi_tick_blocked (eps_mode 2, K-blocked
//                         noise stream from block block_offset on, no
//                         epilogue; s_only: the rollout alone, phase 1 of the
//                         sample-sharded tick)
//   dmm_weighted_noise_reduce
//                      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py:475
//                         weighted_noise_reduce (phase 2 of the sharded tick)
//   dmm_fleet_mppi_tick <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick_blocked.py:618
//                         fleet_mppi_tick (B complete ticks in one call)
//
// What bounds them on the card. The rollout does about T·(9·W + 40) float
// operations per sample (~0.1 GFLOP per tick at K = 10 240, T = 50, W = 20)
// and reads at most 8·T·K bytes of ε (4 MB, which stays in the 50 MB L2):
// neither the 67 TFLOP/s nor the 3.35 TB/s is near. One thread per sample
// gives only K threads (10 240 = ~2.4 warps per SM), so the rollout is bound
// by the latency of each thread's dependent T·W compare-and-select chain.
// The fleet has the same bound: B·K = 16 384 samples at the suite shape
// (~0.18 GFLOP, ~3.9 warps per SM), so it runs the same three kernels with a
// member grid dimension: the rollout on (K/64, B) blocks, member b's
// constants staged per block; the softmax on one block per member; Σ w·ε on
// (T, B) blocks that draw ε again from member b's stream rather than storing
// B·T·K·2 floats. One controller is B = 1. The K-blocked tick at pod-scale
// K (102 400 samples) is bound by its reductions' operations: Σ w·ε draws
// its 2·T·K normals again (~0.3 G hash operations). On one block (the
// softmax) and T = 50 blocks (Σ w·ε) they took 80 and 212 µs, so it runs
// the chunked reductions (mppi_reductions.cuh): the softmax over C chunks
// of K and Σ w·ε on a (C, ⌈T/5⌉) grid, each chunk in one noise-stream
// block, the chunks' partials combined in chunk order. The weighted noise
// reduce of the sharded tick reads K weights and writes 2·T floats, and its
// cost is the 2·T·K hash draws it regenerates: bound by operations, on
// T = 50 blocks far from the card's width (moving it onto the chunked grid
// is later work).
// Design: 64-thread rollout blocks so that every one of the 132 SMs gets a
// block at the flagship K, per-tick constants staged in shared memory, no
// atomics. The reductions of the other ticks are small: a one-block pass
// (per member) for ρ = min S and η = Σ exp(−λ(S−ρ)) (which also writes w),
// one block per t for Σₖ wₖ·εₖ (both in mppi_reductions.cuh, shared with the
// bicycle tick), and a one-block epilogue (there too, shared with the
// generic tick); each is a fixed-order tree, so results repeat bit for bit
// from run to run. Not yet done (later work): splitting the W search across
// lanes (as the bicycle rollout does), regenerating ε in the single-block
// tick instead of storing it, fusing the four launches.
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
                       p.K, p.k_blk, p.inv_temp, p.block_offset, p.scratch,
                       p.scratch_floats};
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

// Block (x, b) rolls out samples of member b (dmm_member; one controller is
// member 0).
template <bool ISO, bool LAST, bool GEN>
__global__ void rollout_kernel(DmmArgs p0) {
  const DmmArgs p = dmm_member(p0, blockIdx.y);
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

template <bool ISO, bool LAST>
void launch_rollout_iso_last(const DmmArgs& p, dim3 grid, size_t smem, cudaStream_t s) {
  if (p.eps_mode == 0)
    rollout_kernel<ISO, LAST, false><<<grid, kRolloutThreads, smem, s>>>(p);
  else
    rollout_kernel<ISO, LAST, true><<<grid, kRolloutThreads, smem, s>>>(p);
}

// The rollout of B members (B = 1: one controller).
cudaError_t launch_rollout(const DmmArgs& p, int B, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(4 * p.T + 3 * p.W + 5 * p.n_obs) * sizeof(float);
  if (p.K <= 0 || p.T <= 0 || p.W <= 0 || smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (p.eps_mode != 0 && (p.k_blk <= 0 || p.K % p.k_blk != 0)) return cudaErrorInvalidValue;
  const dim3 grid((p.K + kRolloutThreads - 1) / kRolloutThreads, B);
  if (p.iso_xy) {
    if (p.last_only) launch_rollout_iso_last<true, true>(p, grid, smem, s);
    else launch_rollout_iso_last<true, false>(p, grid, smem, s);
  } else {
    if (p.last_only) launch_rollout_iso_last<false, true>(p, grid, smem, s);
    else launch_rollout_iso_last<false, false>(p, grid, smem, s);
  }
  return cudaGetLastError();
}

// The fused or K-blocked tick.
cudaError_t mppi_tick(const DmmArgs& p, cudaStream_t s) {
  if (p.T > 1024 || (p.s_only && p.eps_mode != 2)) return cudaErrorInvalidValue;
  cudaError_t err = launch_rollout(p, 1, s);
  if (err != cudaSuccess || p.s_only) return err;
  if (p.eps_mode == 2) return launch_chunked_reductions(reduce_args(p), p.T, s);
  err = launch_reductions<false>(reduce_args(p), p.T, 1, s);
  if (err != cudaSuccess) return err;
  if (p.fuse_epilogue)
    err = launch_epilogue<2>(
        DmmEpilogueArgs{p.filter_t, p.w_eps, p.u, p.u_new, p.u_shift, p.finite, p.T}, s);
  return err;
}

}  // namespace

extern "C" {

// sizeof(DmmArgs) and sizeof(DmmFleetArgs), checked against the ctypes
// mirrors at load time.
int dmm_args_size() { return static_cast<int>(sizeof(DmmArgs)); }
int dmm_fleet_args_size() { return static_cast<int>(sizeof(DmmFleetArgs)); }

// Split rollout: S only (ε injected, eps_mode 0).
int dmm_rollout_costs(const DmmArgs* args, void* stream) {
  const DmmArgs p = *args;
  if (p.eps_mode != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rollout(p, 1, static_cast<cudaStream_t>(stream)));
}

// Fused tick (eps_mode 0 or 1): rollout, softmax statistics and w, Σ w·ε,
// and the epilogue when fuse_epilogue is set; four launches at most. The
// K-blocked tick (eps_mode 2): the rollout, then the chunked softmax and
// Σ w·ε (three launches), no epilogue; with s_only the rollout alone.
int dmm_mppi_tick(const DmmArgs* args, void* stream) {
  return static_cast<int>(mppi_tick(*args, static_cast<cudaStream_t>(stream)));
}

// The floats of scratch (DmmArgs::scratch) the K-blocked tick needs at
// (K, k_blk, T): the wrapper allocates this many.
long long dmm_chunk_scratch_floats(int K, int k_blk, int T) {
  return K > 0 && k_blk > 0 && K % k_blk == 0 ? chunk_scratch_floats(K, k_blk, T, 2) : -1;
}

// Σₖ wₖ·εₖ with ε drawn again from (seed, block_offset + k / k_blk): reads
// w (K,), chol and the seed, writes w_eps (T, 2). One launch of T blocks.
int dmm_weighted_noise_reduce(const DmmArgs* args, void* stream) {
  const DmmArgs p = *args;
  if (p.K <= 0 || p.T <= 0 || p.k_blk <= 0 || p.K % p.k_blk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  weighted_eps_kernel<true><<<p.T, kWepsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reduce_args(p));
  return static_cast<int>(cudaGetLastError());
}

// B complete ticks (hash ε from seeds[b], one block of K per member): the
// rollout, the softmax and Σ w·ε of each member, each launch a grid with a
// member dimension. Three launches.
int dmm_fleet_mppi_tick(const DmmFleetArgs* args, void* stream) {
  const DmmArgs p = args->m;
  const int B = args->B;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || p.eps_mode != 2 || p.k_blk != p.K || p.block_offset != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch_rollout(p, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reductions<true>(reduce_args(p), p.T, B, s));
}

}  // extern "C"
