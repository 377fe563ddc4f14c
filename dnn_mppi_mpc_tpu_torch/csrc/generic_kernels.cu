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
// T = 50 about 0.15 GFLOP; far from the card's 67 TFLOP/s and 3.35 TB/s. Each
// sample is a chain of T dependent steps (ε, the tile step's transcendental
// calls, the window search, the costs), and K = 2 048 samples are under one
// warp an SM: bound by that chain's latency, as the diff-drive and bicycle
// rollouts are. Splitting the W-row search over G lanes moved little (the
// split rollout's time is flat in G, root PERF.md §6): the search is a small
// part of a step; what G buys is the drawn ε (G lanes draw G steps at once)
// and more warps at small K.
//
// Design. The rollout (generic_rollout.cuh, one instantiation per tile
// family, LAST, ε route and lane group) runs the diff-drive rollout's
// layout: G lanes a sample, the W-row search split W/G rows a lane and
// merged in log2 G shuffle rounds (window_search.cuh), each lane drawing
// every G-th step's ε; every lane issues the tile step. The launcher picks G
// from the family, the ε route and the launch's sample count
// (generic_group). An injected ε row is loaded a step ahead, off the state's
// dependent chain. 64-thread blocks; u, a, the window's (x, y) rows, its
// other tracked columns and the obstacles staged in shared memory under the
// static 48 KB. The tick's softmax, Σ w·ε and epilogue are the diff-drive
// tick's chunked reductions (mppi_reductions.cuh) at NU = 2 or 4: each
// chunk's softmax statistics, Σ w·ε on a grid of chunks × step groups sized
// from the launch (its hash ε drawn again, pair p of sample k at step t at
// counter (p·T + t)·K + k, unless the rollout stored it), and one block for
// the in-order chunk sum and the epilogue: four launches, the rollout
// included. No atomics: results repeat bit for bit.
//
// Built with -fmad=false (see _build.py), so the rollout rounds op for op
// like its plain PyTorch version (ops/cuda/generic_tick.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "generic_rollout.cuh"
#include "mppi_reductions.cuh"

namespace {

// Lanes a sample, by family and ε route: drawn ε (the tick's hash stream)
// kGenFew when a launch rolls out at most kGenericFewSamples samples, else
// kGenMany; injected ε kInjFew, else kInjMany. Fixed from G ∈ {1, 2, 4, 8}
// measured on the card for every family at K = 2 048 and 10 240, the fused
// tick and the split rollout (root PERF.md §6: a drawn ε's G lanes draw G
// steps at once, so larger G pay where the draws cost most; an injected ε
// row is loaded a step ahead, and G > 2 rarely pays for the dynamics every
// lane issues). Only these are built into the library. A build with
// -DDMM_GENERIC_GROUP=g runs every launch at G = g (chip_smoke.py times G
// side by side with such builds).
template <int GEN_FEW, int GEN_MANY, int INJ_FEW, int INJ_MANY>
struct GenericGroups {
#ifdef DMM_GENERIC_GROUP
  static constexpr int kGenFew = DMM_GENERIC_GROUP, kGenMany = DMM_GENERIC_GROUP,
                       kInjFew = DMM_GENERIC_GROUP, kInjMany = DMM_GENERIC_GROUP;
#else
  static constexpr int kGenFew = GEN_FEW, kGenMany = GEN_MANY, kInjFew = INJ_FEW,
                       kInjMany = INJ_MANY;
#endif
};
template <class F>
struct GenericRule;
template <>
struct GenericRule<DmmUnicycleTile> : GenericGroups<8, 2, 2, 1> {};
template <>
struct GenericRule<DmmKinematicBicycleTile> : GenericGroups<2, 2, 1, 1> {};
template <>
struct GenericRule<DmmFourWheelTile> : GenericGroups<8, 2, 1, 1> {};
template <>
struct GenericRule<DmmDynamicBicycleTile> : GenericGroups<2, 1, 2, 1> {};
constexpr long long kGenericFewSamples = 4096;

template <class F>
int generic_group(long long samples, bool gen) {
  using R = GenericRule<F>;
  const bool few = samples <= kGenericFewSamples;
  return gen ? (few ? R::kGenFew : R::kGenMany) : (few ? R::kInjFew : R::kInjMany);
}

// Shared memory of the rollout: u and a (T, NU each), the window's (x, y)
// rows as float2 (8-byte aligned, since 2·NU·T floats lie before them) and
// its other n_track − 2 columns, the (n_obs, 5) obstacles. The same floats
// as the (W, n_track) window alone: ops/cuda/generic_tick.py check_staging.
template <class F>
size_t generic_smem_bytes(const DmmGenericArgs& p) {
  return static_cast<size_t>(2 * F::NU * p.T + p.n_track * p.W + 5 * p.n_obs) * sizeof(float);
}

template <int G, class F, bool LAST, bool GEN>
__global__ void __launch_bounds__(kRolloutThreads) generic_rollout_kernel(DmmGenericArgs p) {
  constexpr int NU = F::NU;
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + NU * p.T;
  float2* sxy = reinterpret_cast<float2*>(sa + NU * p.T);
  float* srest = reinterpret_cast<float*>(sxy + p.W);
  const int n_rest = p.n_track - 2;
  float* sobs = srest + n_rest * p.W;
  for (int i = threadIdx.x; i < NU * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < p.W; i += blockDim.x) {
    const float* row = p.window + i * p.n_track;
    sxy[i] = make_float2(row[0], row[1]);
    for (int c = 0; c < n_rest; ++c) srest[i * n_rest + c] = row[2 + c];
  }
  for (int i = threadIdx.x; i < 5 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
  const int lane = threadIdx.x & (G - 1);
  const int k = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  const bool active = k < p.K;
  const float S = dmm_generic_sample<G, F, LAST, GEN>(p, active ? k : p.K - 1, lane, active, su,
                                                      sa, sxy, srest, sobs);
  if (active && lane == 0) p.S[k] = S;
}

template <int G, class F, bool LAST, bool GEN>
void launch_rollout_g(const DmmGenericArgs& p, size_t smem, cudaStream_t s) {
  const long long threads = static_cast<long long>(p.K) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kRolloutThreads - 1) / kRolloutThreads);
  generic_rollout_kernel<G, F, LAST, GEN><<<blocks, kRolloutThreads, smem, s>>>(p);
}

// The rollout at the rule's G for the launch's samples and ε route.
template <class F, bool LAST>
void launch_rollout_last(const DmmGenericArgs& p, size_t smem, cudaStream_t s) {
  using R = GenericRule<F>;
  if (p.eps_mode != 0) {
    if (generic_group<F>(p.K, true) == R::kGenFew)
      launch_rollout_g<R::kGenFew, F, LAST, true>(p, smem, s);
    else
      launch_rollout_g<R::kGenMany, F, LAST, true>(p, smem, s);
  } else {
    if (generic_group<F>(p.K, false) == R::kInjFew)
      launch_rollout_g<R::kInjFew, F, LAST, false>(p, smem, s);
    else
      launch_rollout_g<R::kInjMany, F, LAST, false>(p, smem, s);
  }
}

template <class F>
cudaError_t launch_generic_rollout(const DmmGenericArgs& p, cudaStream_t s) {
  const size_t smem = generic_smem_bytes<F>(p);
  if (p.K <= 0 || p.K > (1 << 26) || p.T <= 0 || p.W <= 0 || p.n_track < 2 ||
      p.n_track > F::NX || p.n_obs < 0 || p.eps_mode < 0 || p.eps_mode > 2 ||
      smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  if (p.last_only) launch_rollout_last<F, true>(p, smem, s);
  else launch_rollout_last<F, false>(p, smem, s);
  return cudaGetLastError();
}

// The fields the chunked reductions read and write: one noise-stream block
// of K samples (k_blk = K, block offset 0); ε read when it was injected or
// stored, drawn again in eps_mode 2.
DmmReduceArgs reduce_args(const DmmGenericArgs& p) {
  return DmmReduceArgs{p.S, p.w, p.stats, p.eps_mode == 2 ? nullptr : p.eps, p.w_eps,
                       p.chol, p.seed, p.K, p.K, p.inv_temp, 0, p.scratch, p.scratch_floats};
}

// The epilogue's fields (filter_t null: no epilogue).
DmmEpilogueArgs epilogue_args(const DmmGenericArgs& p) {
  return DmmEpilogueArgs{p.fuse_epilogue ? p.filter_t : nullptr, p.w_eps, p.u, p.u_new,
                         p.u_shift, p.finite, p.T};
}

// The whole tick of family F: rollout, then the chunked softmax statistics,
// Σ w·ε and the chunk sum with the epilogue when fuse_epilogue is set: four
// launches on one stream. What the reductions refuse is refused before the
// rollout launches.
template <class F>
cudaError_t launch_generic_tick(const DmmGenericArgs& p, cudaStream_t s) {
  if (p.T > 1024 || (p.fuse_epilogue && p.filter_t == nullptr) ||
      !chunked_reductions_take<F::NU>(reduce_args(p), p.T, epilogue_args(p)))
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_generic_rollout<F>(p, s);
  if (err != cudaSuccess) return err;
  return launch_chunked_reductions<F::NU>(reduce_args(p), p.T, epilogue_args(p), s);
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

// Fused generic tick (one block of K samples in the noise stream): the
// rollout, the chunked softmax statistics, Σ w·ε, and the chunk sum with the
// epilogue when fuse_epilogue is set: four launches.
int dmm_generic_tick(const DmmGenericArgs* args, void* stream) {
  return static_cast<int>(by_model<WholeTick>(*args, static_cast<cudaStream_t>(stream)));
}

// The floats of scratch (DmmGenericArgs::scratch) a generic tick of K
// samples, T steps and nu control dims needs: the wrapper allocates this
// many.
long long dmm_generic_scratch_floats(int K, int T, int nu) {
  return K > 0 && T > 0 && nu > 0 ? chunk_scratch_floats(K, K, T, nu) : -1;
}

// The lanes a sample the rollout of family `model` (tile.FAMILIES order)
// runs with for a launch of `samples` samples, ε drawn from the hash stream
// (hash_eps != 0) or injected; -1 for an unknown family.
int dmm_generic_group(int model, long long samples, int hash_eps) {
  switch (model) {
    case 0: return generic_group<DmmUnicycleTile>(samples, hash_eps != 0);
    case 1: return generic_group<DmmKinematicBicycleTile>(samples, hash_eps != 0);
    case 2: return generic_group<DmmFourWheelTile>(samples, hash_eps != 0);
    case 3: return generic_group<DmmDynamicBicycleTile>(samples, hash_eps != 0);
    default: return -1;
  }
}

}  // extern "C"
