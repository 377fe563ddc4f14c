// The sample-space reductions of every fused MPPI tick: the softmax
// statistics and weights, the weighted noise sum Σₖ wₖ·εₖ, and the fused
// epilogue.
//
// Shared by the diff-drive ticks (mppi_kernels.cu), the bicycle tick
// (bicycle_kernels.cu) and the generic tick (generic_kernels.cu); Σ w·ε and
// the epilogue are templates on the control width NU. Each reduction is a
// fixed-order tree in one block, so results repeat bit for bit from run to
// run. They take the few fields they read in DmmReduceArgs and
// DmmEpilogueArgs, which each entry point fills from its own argument block.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hash_normal.cuh"

// B members of a fleet lie one after another in S, w, stats, w_eps and seed;
// one controller is B = 1.
struct DmmReduceArgs {
  const float* S;         // (B, K) sample costs
  float* w;               // (B, K) softmax weights (out)
  float* stats;           // (B, 2) rho, eta (out)
  const float* eps;       // (T, K, NU) stored ε (read unless regenerated; B = 1)
  float* w_eps;           // (B, T, NU) Σ w·ε (out)
  const float* chol;      // (NU, NU) Cholesky factor of Σ (regenerated ε)
  const long long* seed;  // (B,) tick seeds (regenerated ε)
  int K;
  int k_blk;              // samples per noise-stream block (regenerated ε)
  float inv_temp;
  int block_offset;       // sample k draws from block block_offset + k / k_blk
};

namespace {

// 64-thread rollout blocks, so that every one of the 132 SMs gets a block at
// K = 10 240; the rollouts stage their per-tick constants in at most 48 KB
// of shared memory (the static limit, no opt-in attribute needed).
constexpr int kRolloutThreads = 64;
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kReduceThreads = 1024;  // softmax statistics, one block per member
constexpr int kWepsThreads = 256;     // Σ w·ε, one block per t and member

__device__ __forceinline__ float min_nan(float a, float b) {
  // NaN-propagating min (jnp.min / torch.min semantics)
  return (a < b || a != a) ? a : b;
}

// ρ = min S, η = Σ exp(−λ(S−ρ)), w = exp(−λ(S−ρ))/η. Block b does member b
// of a fleet ((B, K) S and w, (B, 2) stats); one controller is member 0.
__global__ void softmax_kernel(DmmReduceArgs p) {
  __shared__ float red[kReduceThreads];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* S = p.S + b * p.K;
  float* w = p.w + b * p.K;
  float m = INFINITY;
  for (int k = tid; k < p.K; k += blockDim.x) m = min_nan(m, S[k]);
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
  for (int k = tid; k < p.K; k += blockDim.x) acc += expf(neg_lam * (S[k] - rho));
  red[tid] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  const float eta = red[0];
  for (int k = tid; k < p.K; k += blockDim.x) w[k] = expf(neg_lam * (S[k] - rho)) / eta;
  if (tid == 0) {
    p.stats[2 * b] = rho;
    p.stats[2 * b + 1] = eta;
  }
}

// w_eps[t] = Σₖ wₖ·ε[t, k] over the unclamped ε of NU control dimensions.
// Block (t, b) does step t of member b ((B, K) w, (B, T, NU) w_eps, (B,)
// seeds; stored ε is (T, K, NU) of one member). REGEN draws ε again from the
// hash stream (dmm_hash_normals, colored by the (NU, NU) factor) instead of
// reading the buffer. NU = 2 is the diff-drive and bicycle ticks' pass,
// operation for operation as it was before the template.
template <bool REGEN, int NU = 2>
__global__ void weighted_eps_kernel(DmmReduceArgs p) {
  __shared__ float red[NU][kWepsThreads];
  const int t = blockIdx.x, tid = threadIdx.x, T = gridDim.x;
  const size_t b = blockIdx.y;
  const float* w = p.w + b * p.K;
  float* w_eps = p.w_eps + b * NU * T;
  float L[NU * NU];
  uint32_t seed = 0;
  if (REGEN) {
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) L[i] = p.chol[i];
    seed = static_cast<uint32_t>(p.seed[b]);
  }
  float acc[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) acc[j] = 0.0f;
  for (int k = tid; k < p.K; k += blockDim.x) {
    float e[NU];
    if (REGEN) {
      const uint32_t blk = static_cast<uint32_t>(k / p.k_blk);
      const uint32_t local = static_cast<uint32_t>(k - static_cast<int>(blk) * p.k_blk);
      float z[2 * ((NU + 1) / 2)];
      dmm_hash_normals<NU>(dmm_stream_base(seed, blk + static_cast<uint32_t>(p.block_offset)),
                           t, T, p.k_blk, local, z);
      dmm_color<NU>(L, z, e);
    } else {
      const float* src = p.eps + (static_cast<size_t>(t) * p.K + k) * NU;
      if constexpr (NU == 2) {
        const float2 v = *reinterpret_cast<const float2*>(src);
        e[0] = v.x;
        e[1] = v.y;
      } else if constexpr (NU == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        e[0] = v.x;
        e[1] = v.y;
        e[2] = v.z;
        e[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < NU; ++j) e[j] = src[j];
      }
    }
    const float wk = w[k];
#pragma unroll
    for (int j = 0; j < NU; ++j) acc[j] = acc[j] + wk * e[j];
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) red[j][tid] = acc[j];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int j = 0; j < NU; ++j) red[j][tid] = red[j][tid] + red[j][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < NU; ++j) w_eps[NU * t + j] = red[j][0];
  }
}

// What the fused epilogue reads and writes: NU-column rows, T of them.
struct DmmEpilogueArgs {
  const float* filter_t;  // (T, T) Fᵀ of the smoothing filter
  const float* w_eps;     // (T, NU)
  const float* u;         // (T, NU) nominal controls
  float* u_new;           // (T, NU) out
  float* u_shift;         // (T, NU) out
  float* finite;          // (1,) out: 1.0 when the update was applied
  int T;
};

// u_new = u + F·w_eps (fmaf, full f32), non-finite hold, horizon shift.
// One block of >= T threads; thread t owns row t. NU = 2 is the diff-drive
// tick's epilogue, operation for operation as it was before the template.
template <int NU>
__global__ void epilogue_kernel(DmmEpilogueArgs p) {
  extern __shared__ float un_s[];  // (T, NU)
  const int t = threadIdx.x, T = p.T;
  const bool active = t < T;
  float un[NU];
  bool ok = true;
  if (active) {
    float acc[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) acc[j] = 0.0f;
    for (int s = 0; s < T; ++s) {
      const float f = p.filter_t[s * T + t];
#pragma unroll
      for (int j = 0; j < NU; ++j) acc[j] = fmaf(p.w_eps[NU * s + j], f, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      un[j] = p.u[NU * t + j] + acc[j];
      ok = ok && isfinite(un[j]);
    }
  }
  const bool all_ok = __syncthreads_and(ok) != 0;
  if (active) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      if (!all_ok) un[j] = p.u[NU * t + j];
      p.u_new[NU * t + j] = un[j];
      un_s[NU * t + j] = un[j];
    }
  }
  __syncthreads();
  if (active) {
    const int src = t + 1 < T ? t + 1 : T - 1;
#pragma unroll
    for (int j = 0; j < NU; ++j) p.u_shift[NU * t + j] = un_s[NU * src + j];
  }
  if (t == 0) p.finite[0] = all_ok ? 1.0f : 0.0f;
}

// The epilogue on stream s (T <= 1024); the launch error.
template <int NU>
cudaError_t launch_epilogue(const DmmEpilogueArgs& e, cudaStream_t s) {
  const int threads = ((e.T + 31) / 32) * 32;
  epilogue_kernel<NU><<<1, threads, NU * e.T * sizeof(float), s>>>(e);
  return cudaGetLastError();
}

// Softmax, then Σ w·ε over (T, B) blocks, for B members on stream s; the
// first launch error.
template <bool REGEN, int NU = 2>
cudaError_t launch_reductions(const DmmReduceArgs& r, int T, int B, cudaStream_t s) {
  softmax_kernel<<<B, kReduceThreads, 0, s>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  weighted_eps_kernel<REGEN, NU><<<dim3(T, B), kWepsThreads, 0, s>>>(r);
  return cudaGetLastError();
}

}  // namespace
