// The sample-space reductions of every fused MPPI tick: the softmax
// statistics and weights, and the weighted noise sum Σₖ wₖ·εₖ.
//
// Shared by the diff-drive ticks (mppi_kernels.cu) and the bicycle tick
// (bicycle_kernels.cu). Each is a fixed-order tree in one block, so results
// repeat bit for bit from run to run. They take the few fields they read in
// DmmReduceArgs, which each entry point fills from its own argument block.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hash_normal.cuh"

struct DmmReduceArgs {
  const float* S;         // (K,) sample costs
  float* w;               // (K,) softmax weights (out)
  float* stats;           // (2,) rho, eta (out)
  const float* eps;       // (T, K, 2) stored ε (read unless regenerated)
  float* w_eps;           // (T, 2) Σ w·ε (out)
  const float* chol;      // (2, 2) Cholesky factor of Σ (regenerated ε)
  const long long* seed;  // (1,) tick seed (regenerated ε)
  int K;
  int k_blk;              // samples per noise-stream block (regenerated ε)
  float inv_temp;
};

namespace {

// 64-thread rollout blocks, so that every one of the 132 SMs gets a block at
// K = 10 240; the rollouts stage their per-tick constants in at most 48 KB
// of shared memory (the static limit, no opt-in attribute needed).
constexpr int kRolloutThreads = 64;
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kReduceThreads = 1024;  // softmax statistics, one block
constexpr int kWepsThreads = 256;     // Σ w·ε, one block per t

__device__ __forceinline__ float min_nan(float a, float b) {
  // NaN-propagating min (jnp.min / torch.min semantics)
  return (a < b || a != a) ? a : b;
}

// ρ = min S, η = Σ exp(−λ(S−ρ)), w = exp(−λ(S−ρ))/η — one block.
__global__ void softmax_kernel(DmmReduceArgs p) {
  __shared__ float red[kReduceThreads];
  const int tid = threadIdx.x;
  float m = INFINITY;
  for (int k = tid; k < p.K; k += blockDim.x) m = min_nan(m, p.S[k]);
  red[tid] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = min_nan(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float rho = red[0];
  __syncthreads();
  const float neg_lam = -p.inv_temp;
  float acc = 0.0f;
  for (int k = tid; k < p.K; k += blockDim.x) acc += expf(neg_lam * (p.S[k] - rho));
  red[tid] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  const float eta = red[0];
  for (int k = tid; k < p.K; k += blockDim.x) p.w[k] = expf(neg_lam * (p.S[k] - rho)) / eta;
  if (tid == 0) {
    p.stats[0] = rho;
    p.stats[1] = eta;
  }
}

// w_eps[t] = Σₖ wₖ·ε[t, k] over the unclamped ε; block t. REGEN draws ε
// again from the hash stream instead of reading the stored buffer.
template <bool REGEN>
__global__ void weighted_eps_kernel(DmmReduceArgs p) {
  __shared__ float red0[kWepsThreads];
  __shared__ float red1[kWepsThreads];
  const int t = blockIdx.x, tid = threadIdx.x;
  float l00 = 0.0f, l10 = 0.0f, l11 = 0.0f;
  uint32_t seed = 0;
  if (REGEN) {
    l00 = p.chol[0];
    l10 = p.chol[2];
    l11 = p.chol[3];
    seed = static_cast<uint32_t>(p.seed[0]);
  }
  float a0 = 0.0f, a1 = 0.0f;
  for (int k = tid; k < p.K; k += blockDim.x) {
    float e0, e1;
    if (REGEN) {
      const uint32_t blk = static_cast<uint32_t>(k / p.k_blk);
      const uint32_t local = static_cast<uint32_t>(k - static_cast<int>(blk) * p.k_blk);
      float z0, z1;
      dmm_hash_normal_pair(dmm_stream_base(seed, blk),
                           static_cast<uint32_t>(t) * p.k_blk + local, &z0, &z1);
      e0 = l00 * z0;
      e1 = l10 * z0 + l11 * z1;
    } else {
      const float2 e = reinterpret_cast<const float2*>(p.eps)[static_cast<size_t>(t) * p.K + k];
      e0 = e.x;
      e1 = e.y;
    }
    const float wk = p.w[k];
    a0 = a0 + wk * e0;
    a1 = a1 + wk * e1;
  }
  red0[tid] = a0;
  red1[tid] = a1;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red0[tid] = red0[tid] + red0[tid + s];
      red1[tid] = red1[tid] + red1[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    p.w_eps[2 * t] = red0[0];
    p.w_eps[2 * t + 1] = red1[0];
  }
}

// Softmax, then Σ w·ε over T blocks, on stream s; the first launch error.
template <bool REGEN>
cudaError_t launch_reductions(const DmmReduceArgs& r, int T, cudaStream_t s) {
  softmax_kernel<<<1, kReduceThreads, 0, s>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  weighted_eps_kernel<REGEN><<<T, kWepsThreads, 0, s>>>(r);
  return cudaGetLastError();
}

}  // namespace
