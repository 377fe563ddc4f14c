// The sample-space reductions of every fused MPPI tick: the softmax
// statistics and weights, the weighted noise sum Σₖ wₖ·εₖ, and the fused
// epilogue.
//
// Shared by the diff-drive ticks (mppi_kernels.cu), the bicycle tick
// (bicycle_kernels.cu) and the generic tick (generic_kernels.cu). The
// one-block forms (softmax_kernel, weighted_eps_kernel, two control dims)
// serve the bicycle tick, the fleet and the sharded tick's weighted noise
// reduce; the diff-drive fused and K-blocked ticks and the generic tick run
// the chunked forms (launch_chunked_reductions, templates on the control
// width NU): grid-wide passes over chunks of K sized from the launch, each
// chunk's partial written to scratch and combined in chunk order by one
// block, which also runs the epilogue. No atomics anywhere:
// every sum is a fixed-order tree or loop, so results repeat bit for bit
// from run to run. They take the few fields they read in DmmReduceArgs and
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
  const float* eps;       // (T, K, NU) stored ε of one member (read unless regenerated)
  float* w_eps;           // (B, T, NU) Σ w·ε (out)
  const float* chol;      // (NU, NU) Cholesky factor of Σ (regenerated ε)
  const long long* seed;  // (B,) tick seeds (regenerated ε)
  int K;
  int k_blk;              // samples per noise-stream block (regenerated ε)
  float inv_temp;
  int block_offset;       // sample k draws from block block_offset + k / k_blk
  float* scratch;         // chunked reductions (B = 1): 2·C + T·C·NU floats
  int scratch_floats;
};

namespace {

// 64-thread rollout blocks (the diff-drive and generic rollouts), so that
// every one of the 132 SMs gets a block at K = 10 240; the rollouts stage
// their per-tick constants in at most 48 KB of shared memory (the static
// limit, no opt-in attribute needed).
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

// w_eps[t] = Σₖ wₖ·ε[t, k] over the unclamped ε of the two control
// dimensions. Block (t, b) does step t of member b ((B, K) w, (B, T, 2)
// w_eps, (B,) seeds; stored ε is (T, K, 2) of one member). REGEN draws ε
// again from the hash stream (dmm_hash_normal_pair, colored by the (2, 2)
// factor) instead of reading the buffer.
template <bool REGEN>
__global__ void weighted_eps_kernel(DmmReduceArgs p) {
  constexpr int NU = 2;
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
      float z[NU];
      dmm_hash_normals<NU>(dmm_stream_base(seed, blk + static_cast<uint32_t>(p.block_offset)),
                           t, T, p.k_blk, local, z);
      dmm_color<NU>(L, z, e);
    } else {
      const float2 v = reinterpret_cast<const float2*>(p.eps)[static_cast<size_t>(t) * p.K + k];
      e[0] = v.x;
      e[1] = v.y;
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

// u_new = u + F·w_eps (fmaf, full f32), non-finite hold, horizon shift,
// by the threads of one block, thread i owning rows i, i + blockDim.x, ….
// `weps` is the (T, NU) Σ w·ε and `filter_t` the (T, T) Fᵀ (device or
// shared memory), `un_s` NU·T floats of shared memory. Every thread of the
// block calls it (the chunk sum's block, chunk_final_kernel).
template <int NU>
__device__ __forceinline__ void dmm_epilogue_rows(const DmmEpilogueArgs& e, const float* weps,
                                                  float* un_s, const float* filter_t) {
  const int T = e.T;
  bool ok = true;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float acc[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) acc[j] = 0.0f;
#pragma unroll 8
    for (int s = 0; s < T; ++s) {
      const float f = filter_t[s * T + t];
#pragma unroll
      for (int j = 0; j < NU; ++j) acc[j] = fmaf(weps[NU * s + j], f, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float un = e.u[NU * t + j] + acc[j];
      ok = ok && isfinite(un);
      un_s[NU * t + j] = un;
    }
  }
  const bool all_ok = __syncthreads_and(ok) != 0;
  if (!all_ok)
    for (int i = threadIdx.x; i < NU * T; i += blockDim.x) un_s[i] = e.u[i];
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int src = t + 1 < T ? t + 1 : T - 1;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      e.u_new[NU * t + j] = un_s[NU * t + j];
      e.u_shift[NU * t + j] = un_s[NU * src + j];
    }
  }
  if (threadIdx.x == 0) e.finite[0] = all_ok ? 1.0f : 0.0f;
}

// Whether the chunk sum's epilogue stages Fᵀ in shared memory beside its
// (T, NU) w_eps and u_new: when all three fit under the static limit
// (T ≤ 104 at NU = 2).
__host__ __device__ inline bool epilogue_stages_filter(int T, int NU) {
  return static_cast<long long>(2 * NU * T + T * T) * sizeof(float) <= kMaxSmemBytes;
}

// Softmax, then Σ w·ε over (T, B) blocks, for B members on stream s; the
// first launch error.
template <bool REGEN>
cudaError_t launch_reductions(const DmmReduceArgs& r, int T, int B, cudaStream_t s) {
  softmax_kernel<<<B, kReduceThreads, 0, s>>>(r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  weighted_eps_kernel<REGEN><<<dim3(T, B), kWepsThreads, 0, s>>>(r);
  return cudaGetLastError();
}

// --- the chunked reductions of the diff-drive and generic ticks -------------
//
// What bounds them. Σ w·ε draws NU·T·K normals again (~0.3 G hash
// operations at pod-scale K = 102 400, T = 50, NU = 2; 0.03 G at the
// flagship's K = 10 240), or reads the stored ε, and the softmax reads K costs twice: a few µs of
// issue for the whole card, so each block's chain of dependent steps and
// barriers sets the time. One block (the softmax) or T = 50 blocks (Σ w·ε)
// leave most of the 132 SMs idle, so both run as grids over chunks of K: a
// chunk lies in one noise-stream block of k_blk samples (its stream base
// computed once), k_blk split into equal chunks. The layout is sized from
// the launch (dmm_chunks): the first (samples a thread, steps a block) whose
// Σ w·ε grid reaches kFillBlocks: (8, 5) at pod K (chunks of 2 048, five
// steps a block, 500 blocks), (4, 1) at the flagship's K (chunks of 1 024,
// one step, 500 blocks; the generic tick at K = 10 240 too), (1, 1) at the
// four-wheel example's K = 2 048, T = 25 (8 chunks of 256, 200 blocks). One
// controller only: the fleet keeps the one-block
// softmax a member and Σ w·ε on (T, B) blocks (launch_reductions), since a
// member dimension here was slower on the card (root PERF.md §6).
// The softmax is online: one pass gives each chunk its min m_c and
// s_c = Σ exp(−λ(S−m_c)) (from registers), and η = Σ_c s_c·exp(−λ(m_c−ρ)),
// the merge of the JAX kernel's K blocks
// (ops/pallas/mppi_tick_blocked.py:252). Then Σ w·ε on a (C, ⌈T/steps⌉)
// grid: block (c, s) combines the chunk statistics into ρ and η, forms its
// chunk's w = exp(−λ(S−ρ))/η once (the blocks of s = 0 store it), and for
// each of its steps reads or draws its chunk's ε (the same bits either
// way), colours a drawn one by Σ's factor and writes its NU partial sums;
// one block then sums each (t, j) over the chunks in chunk order, stores ρ
// and η, and runs the epilogue when the tick has one (Fᵀ staged in shared
// memory while the chunks are summed, where it fits).

constexpr int kChunkThreads = 256;
constexpr int kChunkPerThread = 8;  // samples a thread at most: chunks of ≤ 2 048
// Σ w·ε blocks a launch should reach: two for each SM of an H100 SXM (132)
#ifndef DMM_FILL_BLOCKS
#define DMM_FILL_BLOCKS (2 * 132)
#endif
constexpr int kFillBlocks = DMM_FILL_BLOCKS;

// K (a multiple of k_blk) in chunks: `per_blk` equal chunks a noise-stream
// block (the last one of a block shorter when per_blk does not divide
// k_blk) of `size` samples, `count` chunks in all; `steps` steps of Σ w·ε a
// block.
struct DmmChunks {
  int per_blk, size, count, steps;
};

// The chunk layout of a launch: the first of (samples a thread, steps a
// block) = (8, 5), (8, 2), (8, 1), (4, 1), (2, 1), (1, 1) whose Σ w·ε grid
// reaches kFillBlocks, else the last. A block's steps run one after
// another, its samples side by side, so fewer steps come first. At T = 50
// with k_blk = K the entries take K ≥ 53 249, 20 481-53 248, 10 241-20 480,
// 5 121-10 240 (the flagship's 10 240), 2 561-5 120 and ≤ 2 560 in turn;
// pod K's 102 400 in blocks of 10 240 takes the first. So Σ w·ε keeps near
// kFillBlocks blocks from a few thousand samples up.
inline DmmChunks dmm_chunks(int K, int k_blk, int T) {
  constexpr int kLayouts[][2] = {{8, 5}, {8, 2}, {8, 1}, {4, 1}, {2, 1}, {1, 1}};
  int per_blk = 1, steps = 1;
  for (const auto& l : kLayouts) {
    per_blk = (k_blk + kChunkThreads * l[0] - 1) / (kChunkThreads * l[0]);
    steps = l[1];
    const long long grid = static_cast<long long>(K / k_blk) * per_blk * ((T + steps - 1) / steps);
    if (grid >= kFillBlocks) break;
  }
  return DmmChunks{per_blk, (k_blk + per_blk - 1) / per_blk, (K / k_blk) * per_blk, steps};
}

// The floats of scratch the chunked reductions need: m_c (or each chunk's
// min), s_c, and the (T, C, NU) partials of Σ w·ε.
inline long long chunk_scratch_floats(int K, int k_blk, int T, int NU) {
  const DmmChunks ch = dmm_chunks(K, k_blk, T);
  return 2LL * ch.count + static_cast<long long>(T) * ch.count * NU;
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

// The block's sums of N values a thread, each in block_tree's order, with
// one pair of barriers for all N. `red` holds N · kChunkThreads / 32 floats.
template <int N>
__device__ __forceinline__ void block_sums(float* v, float* red) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] = v[j] + __shfl_xor_sync(0xffffffffu, v[j], o);
  }
  constexpr int kWarps = kChunkThreads / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[j * kWarps + threadIdx.x / 32] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float r = red[j * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) r = r + red[j * kWarps + i];
    v[j] = r;
  }
  __syncthreads();  // red is free again
}

// ρ and η from the chunk statistics m_c and s_c, alike in every block: each s_c rescaled to ρ (a chunk of +∞ costs
// contributes its count × exp(−λ(∞−ρ)), as the plain version's terms, not
// s_c's NaN).
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

// Each chunk's min m_c and s_c = Σ exp(−λ(S−m_c)), its costs held in
// registers between the two. Grid C (block c: chunk c).
__global__ void __launch_bounds__(kChunkThreads) chunk_stats_kernel(DmmReduceArgs p,
                                                                    DmmChunks ch) {
  __shared__ float red[kChunkThreads / 32];
  const int c = blockIdx.x;
  int begin, end, blk;
  dmm_chunk(p, ch, c, &begin, &end, &blk);
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
    p.scratch[c] = m;
    p.scratch[ch.count + c] = acc;
  }
}

// Σ w·ε, block (c, s): chunk c's w (stored by the blocks of s = 0), formed
// once and kept in registers, and its NU partial sums of wₖ·εₖ at each of
// the steps [s·ch.steps, (s + 1)·ch.steps), ε read from the (T, K, NU)
// buffer (READ) or drawn again from the stream.
template <int NU, bool READ>
__global__ void __launch_bounds__(kChunkThreads) chunk_weps_kernel(DmmReduceArgs p,
                                                                   DmmChunks ch, int T) {
  __shared__ float red[NU * kChunkThreads / 32];
  const int c = blockIdx.x;
  const int t0 = blockIdx.y * ch.steps, t1 = min(t0 + ch.steps, T);
  float rho, eta;
  combine_chunks(p, ch, red, &rho, &eta);
  int begin, end, blk;
  dmm_chunk(p, ch, c, &begin, &end, &blk);
  float L[NU * NU];
  uint32_t base = 0;
  if (!READ) {
#pragma unroll
    for (int i = 0; i < NU * NU; ++i) L[i] = p.chol[i];
    base = dmm_stream_base(static_cast<uint32_t>(p.seed[0]),
                           static_cast<uint32_t>(blk + p.block_offset));
  }
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
        float e[NU];
        if (READ) {
          const float* src = p.eps + (static_cast<size_t>(t) * p.K + k) * NU;
#pragma unroll
          for (int j = 0; j < NU; ++j) e[j] = src[j];
        } else {
          float z[2 * ((NU + 1) / 2)];
          dmm_hash_normals<NU>(base, t, T, p.k_blk, static_cast<uint32_t>(k - blk * p.k_blk), z);
          dmm_color<NU>(L, z, e);
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) acc[j] = acc[j] + w[i] * e[j];
      }
    }
    block_sums<NU>(acc, red);
    if (threadIdx.x == 0) {
      float* out = p.scratch + 2 * ch.count + (static_cast<size_t>(t) * ch.count + c) * NU;
#pragma unroll
      for (int j = 0; j < NU; ++j) out[j] = acc[j];
    }
  }
}

// One block: w_eps[t, j] = Σ_c partial[t, c, j] in chunk order, ρ and η;
// then, when e.filter_t is set, the epilogue on that w_eps.
template <int NU = 2>
__global__ void __launch_bounds__(kChunkThreads) chunk_final_kernel(DmmReduceArgs p,
                                                                    DmmChunks ch, int T,
                                                                    DmmEpilogueArgs e) {
  __shared__ float red[kChunkThreads / 32];
  extern __shared__ float ep_s[];  // the epilogue's (T, NU) w_eps and u_new, then Fᵀ
  const bool epilogue = e.filter_t != nullptr;
  const bool staged = epilogue && epilogue_stages_filter(T, NU);
  float* f_s = ep_s + 2 * NU * T;
  if (staged)  // Fᵀ's loads in flight while the chunks are summed
    for (int i = threadIdx.x; i < T * T; i += kChunkThreads) f_s[i] = e.filter_t[i];
  float rho, eta;
  combine_chunks(p, ch, red, &rho, &eta);
  const float* part = p.scratch + 2 * ch.count;
  for (int i = threadIdx.x; i < T * NU; i += kChunkThreads) {
    const int t = i / NU, j = i - t * NU;
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < ch.count; ++c)
      acc = acc + part[(static_cast<size_t>(t) * ch.count + c) * NU + j];
    p.w_eps[i] = acc;
    if (epilogue) ep_s[i] = acc;
  }
  if (threadIdx.x == 0) {
    p.stats[0] = rho;
    p.stats[1] = eta;
  }
  if (epilogue) {
    __syncthreads();
    dmm_epilogue_rows<NU>(e, ep_s, ep_s + NU * T, staged ? f_s : e.filter_t);
  }
}

// Whether launch_chunked_reductions takes these arguments: K a multiple of
// k_blk, the epilogue only up to T = 1024, and scratch enough for the
// layout.
template <int NU = 2>
bool chunked_reductions_take(const DmmReduceArgs& r, int T, const DmmEpilogueArgs& e) {
  return r.K > 0 && r.k_blk > 0 && r.K % r.k_blk == 0 && T > 0 && T <= 65535 &&
         !(e.filter_t != nullptr && T > 1024) &&
         r.scratch_floats >= chunk_scratch_floats(r.K, r.k_blk, T, NU);
}

// The softmax and Σ w·ε (ε read when r.eps is set, otherwise drawn again
// from the seed) as grid passes over chunks of K, then the in-order chunk
// sum with the epilogue when e.filter_t is set, on stream s: 3 launches.
// The first launch error; what chunked_reductions_take refuses is refused
// before any launch.
template <int NU = 2>
cudaError_t launch_chunked_reductions(const DmmReduceArgs& r, int T, const DmmEpilogueArgs& e,
                                      cudaStream_t s) {
  if (!chunked_reductions_take<NU>(r, T, e)) return cudaErrorInvalidValue;
  const bool read = r.eps != nullptr, epilogue = e.filter_t != nullptr;
  const DmmChunks ch = dmm_chunks(r.K, r.k_blk, T);
  chunk_stats_kernel<<<ch.count, kChunkThreads, 0, s>>>(r, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(ch.count, (T + ch.steps - 1) / ch.steps);
  if (read)
    chunk_weps_kernel<NU, true><<<grid, kChunkThreads, 0, s>>>(r, ch, T);
  else
    chunk_weps_kernel<NU, false><<<grid, kChunkThreads, 0, s>>>(r, ch, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      epilogue ? (2 * NU * T + (epilogue_stages_filter(T, NU) ? T * T : 0)) * sizeof(float) : 0;
  chunk_final_kernel<NU><<<1, kChunkThreads, smem, s>>>(r, ch, T, e);
  return cudaGetLastError();
}

}  // namespace
