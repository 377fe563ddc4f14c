// The sample-space reductions of every fused MPPI tick: the softmax
// statistics and weights, the weighted noise sum Σₖ wₖ·εₖ, and the fused
// epilogue.
//
// Shared by the diff-drive ticks (mppi_kernels.cu), the bicycle tick
// (bicycle_kernels.cu) and the generic tick (generic_kernels.cu); Σ w·ε and
// the epilogue are templates on the control width NU. The one-block forms
// (softmax_kernel, weighted_eps_kernel) serve those ticks; the K-blocked
// tick at pod-scale K runs the chunked forms (launch_chunked_reductions):
// grid-wide passes over C chunks of K, each chunk's partial written to
// scratch and combined in chunk order. No atomics anywhere: every sum is a
// fixed-order tree or loop, so results repeat bit for bit from run to run.
// They take the few fields they read in DmmReduceArgs and DmmEpilogueArgs,
// which each entry point fills from its own argument block.
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
  float* scratch;         // chunked reductions: (2·C + T·C·NU) floats (B = 1)
  int scratch_floats;
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

// --- the K-blocked tick's chunked reductions ---------------------------------
//
// What bounds them at pod-scale K (102 400 samples, T = 50): Σ w·ε draws
// 2·T·K normals again (~0.3 G hash operations), the softmax reads K costs
// twice. One block (the softmax) or T = 50 blocks (Σ w·ε) leave most of the
// 132 SMs idle, so both now run as grids over C chunks of K: a chunk lies in
// one noise-stream block of k_blk samples (its stream base computed once)
// and holds at most kChunkTarget samples, k_blk split into equal chunks.
// The softmax is online: one pass gives each chunk its min m_c and
// s_c = Σ exp(−λ(S−m_c)) (from registers), and η = Σ_c s_c·exp(−λ(m_c−ρ)),
// the merge of the JAX kernel's K blocks (ops/pallas/mppi_tick_blocked.py:252;
// the two-pass form, ρ first and then every exponent as the plain version's,
// took the same time: root PERF.md §6). Then Σ w·ε on a (C, ⌈T/5⌉) grid:
// block (c, s) combines the chunk statistics into ρ and η, forms its chunk's
// w = exp(−λ(S−ρ))/η once (the blocks of s = 0 store it), and for each of
// its five steps draws its chunk's ε, colours it by Σ's factor and writes
// its NU partial sums; one block then sums each (t, j) over the chunks in
// chunk order and stores ρ and η.

constexpr int kChunkTarget = 2048;  // samples a chunk at most
constexpr int kChunkThreads = 256;
constexpr int kChunkPerThread = kChunkTarget / kChunkThreads;
constexpr int kChunkSteps = 5;  // steps of Σ w·ε a block

// K (a multiple of k_blk) in chunks: `per_blk` equal chunks (the last one
// of a block shorter when per_blk does not divide k_blk) of `size` samples.
struct DmmChunks {
  int per_blk, size, count;
};

__host__ __device__ inline DmmChunks dmm_chunks(int K, int k_blk) {
  const int per_blk = (k_blk + kChunkTarget - 1) / kChunkTarget;
  return DmmChunks{per_blk, (k_blk + per_blk - 1) / per_blk, (K / k_blk) * per_blk};
}

// The floats of scratch the chunked reductions need: m_c (or each chunk's
// min), s_c, and the (T, C, NU) partials of Σ w·ε.
__host__ __device__ inline long long chunk_scratch_floats(int K, int k_blk, int T, int NU) {
  const long long C = dmm_chunks(K, k_blk).count;
  return 2 * C + static_cast<long long>(T) * C * NU;
}

// Chunk c: samples [*begin, *end) of noise-stream block *blk (before the offset).
__device__ __forceinline__ void dmm_chunk(const DmmReduceArgs& p, const DmmChunks& ch, int c,
                                          int* begin, int* end, int* blk) {
  *blk = c / ch.per_blk;
  *begin = *blk * p.k_blk + (c - *blk * ch.per_blk) * ch.size;
  *end = min(*begin + ch.size, (*blk + 1) * p.k_blk);
}

// The block's min (NaN-propagating) or sum of one value a thread: xor
// shuffles within each warp, then lane 0's result of each warp in warp
// order. `red` holds kChunkThreads / 32 floats. The same order in every
// kernel that calls it, so every block gets the same bits.
template <bool MIN>
__device__ __forceinline__ float block_tree(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MIN ? min_nan(v, u) : v + u;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kChunkThreads / 32; ++i) r = MIN ? min_nan(r, red[i]) : r + red[i];
  __syncthreads();  // red is free again
  return r;
}

// ρ and η from the chunk statistics m_c and s_c, alike in every block: each
// s_c rescaled to ρ (a chunk of +∞ costs contributes its count ×
// exp(−λ(∞−ρ)), as the plain version's terms, not s_c's NaN).
__device__ __forceinline__ void combine_chunks(const DmmReduceArgs& p, const DmmChunks& ch,
                                               float* red, float* rho, float* eta) {
  const int C = ch.count;
  const float* m = p.scratch;
  const float* sums = p.scratch + C;
  float v = INFINITY;
  for (int c = threadIdx.x; c < C; c += kChunkThreads) v = min_nan(v, m[c]);
  const float r = block_tree<true>(v, red);
  const float neg_lam = -p.inv_temp;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < C; c += kChunkThreads) {
    int begin, end, blk;
    dmm_chunk(p, ch, c, &begin, &end, &blk);
    const float f = expf(neg_lam * (m[c] - r));
    acc = acc + (m[c] == INFINITY ? static_cast<float>(end - begin) * f : sums[c] * f);
  }
  *rho = r;
  *eta = block_tree<false>(acc, red);
}

// Each chunk's min m_c and s_c = Σ exp(−λ(S−m_c)), its costs held
// in registers between the two. Grid C.
__global__ void __launch_bounds__(kChunkThreads) chunk_stats_kernel(DmmReduceArgs p,
                                                                    DmmChunks ch) {
  __shared__ float red[kChunkThreads / 32];
  int begin, end, blk;
  dmm_chunk(p, ch, blockIdx.x, &begin, &end, &blk);
  float v[kChunkPerThread];
  float m = INFINITY;
#pragma unroll
  for (int i = 0; i < kChunkPerThread; ++i) {
    const int k = begin + threadIdx.x + i * kChunkThreads;
    v[i] = k < end ? p.S[k] : INFINITY;
    if (k < end) m = min_nan(m, v[i]);
  }
  m = block_tree<true>(m, red);
  const float neg_lam = -p.inv_temp;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunkPerThread; ++i)
    if (begin + static_cast<int>(threadIdx.x) + i * kChunkThreads < end)
      acc = acc + expf(neg_lam * (v[i] - m));
  acc = block_tree<false>(acc, red);
  if (threadIdx.x == 0) {
    p.scratch[blockIdx.x] = m;
    p.scratch[ch.count + blockIdx.x] = acc;
  }
}

// Σ w·ε, block (c, s): chunk c's w (stored by the blocks of s = 0), formed
// once and kept in registers, and its NU partial sums of wₖ·εₖ at each of
// the steps [s·kChunkSteps, (s + 1)·kChunkSteps), ε drawn again from the
// stream.
template <int NU = 2>
__global__ void __launch_bounds__(kChunkThreads) chunk_weps_kernel(DmmReduceArgs p,
                                                                   DmmChunks ch, int T) {
  __shared__ float red[kChunkThreads / 32];
  const int c = blockIdx.x, t0 = blockIdx.y * kChunkSteps;
  const int t1 = min(t0 + kChunkSteps, T);
  float rho, eta;
  combine_chunks(p, ch, red, &rho, &eta);
  int begin, end, blk;
  dmm_chunk(p, ch, c, &begin, &end, &blk);
  float L[NU * NU];
#pragma unroll
  for (int i = 0; i < NU * NU; ++i) L[i] = p.chol[i];
  const uint32_t base = dmm_stream_base(static_cast<uint32_t>(p.seed[0]),
                                        static_cast<uint32_t>(blk + p.block_offset));
  const float neg_lam = -p.inv_temp;
  float w[kChunkPerThread];
#pragma unroll
  for (int i = 0; i < kChunkPerThread; ++i) {
    const int k = begin + threadIdx.x + i * kChunkThreads;
    w[i] = k < end ? expf(neg_lam * (p.S[k] - rho)) / eta : 0.0f;
    if (k < end && t0 == 0) p.w[k] = w[i];
  }
  for (int t = t0; t < t1; ++t) {
    float acc[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kChunkPerThread; ++i) {
      const int k = begin + threadIdx.x + i * kChunkThreads;
      if (k < end) {
        float z[2 * ((NU + 1) / 2)], e[NU];
        dmm_hash_normals<NU>(base, t, T, p.k_blk, static_cast<uint32_t>(k - blk * p.k_blk), z);
        dmm_color<NU>(L, z, e);
#pragma unroll
        for (int j = 0; j < NU; ++j) acc[j] = acc[j] + w[i] * e[j];
      }
    }
    float* out = p.scratch + 2 * ch.count + (static_cast<size_t>(t) * ch.count + c) * NU;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float r = block_tree<false>(acc[j], red);
      if (threadIdx.x == 0) out[j] = r;
    }
  }
}

// w_eps[t, j] = Σ_c partial[t, c, j] in chunk order, and ρ, η. One block.
template <int NU = 2>
__global__ void __launch_bounds__(kChunkThreads) chunk_weps_final_kernel(DmmReduceArgs p,
                                                                         DmmChunks ch, int T) {
  __shared__ float red[kChunkThreads / 32];
  float rho, eta;
  combine_chunks(p, ch, red, &rho, &eta);
  const float* part = p.scratch + 2 * ch.count;
  for (int i = threadIdx.x; i < T * NU; i += kChunkThreads) {
    const int t = i / NU, j = i - t * NU;
    float acc = 0.0f;
    for (int c = 0; c < ch.count; ++c) acc = acc + part[(static_cast<size_t>(t) * ch.count + c) * NU + j];
    p.w_eps[i] = acc;
  }
  if (threadIdx.x == 0) {
    p.stats[0] = rho;
    p.stats[1] = eta;
  }
}

// The K-blocked tick's softmax and Σ w·ε (B = 1, ε regenerated) as grid
// passes over K's chunks on stream s: 3 launches. The first launch error;
// the scratch too small is refused before any launch.
template <int NU = 2>
cudaError_t launch_chunked_reductions(const DmmReduceArgs& r, int T, cudaStream_t s) {
  if (r.k_blk <= 0 || r.K % r.k_blk != 0 || T <= 0 || T > 65535 ||
      r.scratch_floats < chunk_scratch_floats(r.K, r.k_blk, T, NU))
    return cudaErrorInvalidValue;
  const DmmChunks ch = dmm_chunks(r.K, r.k_blk);
  chunk_stats_kernel<<<ch.count, kChunkThreads, 0, s>>>(r, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int steps = (T + kChunkSteps - 1) / kChunkSteps;
  chunk_weps_kernel<NU><<<dim3(ch.count, steps), kChunkThreads, 0, s>>>(r, ch, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_weps_final_kernel<NU><<<1, kChunkThreads, 0, s>>>(r, ch, T);
  return cudaGetLastError();
}

}  // namespace
