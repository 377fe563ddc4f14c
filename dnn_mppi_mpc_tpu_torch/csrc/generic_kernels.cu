// Generic MPPI kernels for Hopper (sm_90a), behind a plain C ABI: the MPPI
// tick for any of the four built-in tile-step families (unicycle, kinematic
// bicycle, four-wheel torque, dynamic bicycle) or, in a library built with
// -DDMM_USER_TILE, for the one tile step generated from a trace of the
// user's (dmm_user_tile.cuh, dnn_mppi_mpc_tpu_torch/ops/cuda/user_tile.py:
// a lift_dynamics or lift_dynamics_time_varying step), which that library
// runs alone (DmmGenericArgs::model kUserModel).
//
// Replaces two Pallas TPU kernels:
//   dmm_generic_tick          <- dnn_mppi_mpc_tpu/ops/pallas/generic_tick.py:442
//                                generic_mppi_tick (ε injected or drawn from the
//                                hash stream, rollout, softmax, Σ w·ε, and the
//                                fused epilogue when fuse_epilogue is set; with
//                                carry_span > 0 its rollout_carry mode, the
//                                furthest carried window row to wp_adv)
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
// and more warps at small K. A generated functor with matrix products (a
// learned residual: a 5→32→32→3 MLP is 1 280 multiply-adds and 64 tanh a
// step, ~2.2 GFLOP a flagship tick) is bound by those products' dependent
// sums at one lane a sample, 2.4 warps an SM at K = 10 240: its weights are
// one buffer staged once a block in shared memory (every lane of a warp
// reads the same weight, a broadcast), and splitting a product's
// outputs over a lane group is the open lever (root PERF.md §7).
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
// A generated functor's rule, from its widths: drawn ε 8 lanes up to
// kGenericFewSamples samples when NX + NU ≤ 9 (no wider than the four-wheel
// tile, the widest built-in family that takes 8) and 2 above, 2 past that
// count; injected ε 1 (the rule of the unicycle and four-wheel tiles, whose
// Euler steps are as cheap as most lifted ones). A functor that holds matrix
// products (MACS > 0 multiply-adds a step) runs at G = 1 on every route: each
// lane of a group repeats the whole step, and the products' multiply-adds
// are most of it, where G > 1 buys only the draws and the window search.
// Tuning G for generated steps is open (ROADMAP A7).
template <class F>
struct GenericRule
    : GenericGroups<(F::MACS > 0 ? 1 : F::NX + F::NU <= 9 ? 8 : 2), (F::MACS > 0 ? 1 : 2), 1,
                    1> {};
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
// its other n_track − 2 columns, the (n_obs, 5) obstacles: the same floats
// as the (W, n_track) window alone, under kMaxSmemBytes
// (ops/cuda/generic_tick.py check_staging); then a generated functor's
// weights (at most 16 384 floats, user_tile.py MAX_WEIGHTS: 64 KB), past
// 48 KB by the launch's opt-in (at most 112 KB of the H100's 227).
template <class F>
constexpr size_t generic_staged_weight_bytes() {
  return static_cast<size_t>(F::WEIGHTS) * sizeof(float);
}
template <class F>
size_t generic_smem_bytes(const DmmGenericArgs& p) {
  return static_cast<size_t>(2 * F::NU * p.T + p.n_track * p.W + 5 * p.n_obs) * sizeof(float) +
         generic_staged_weight_bytes<F>();
}

template <int G, class F, bool LAST, bool GEN, bool CARRY>
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
  float* swts = sobs + 5 * p.n_obs;
  if constexpr (F::WEIGHTS > 0)
    for (int i = threadIdx.x; i < F::WEIGHTS; i += blockDim.x) swts[i] = __ldg(p.weights + i);
  __syncthreads();
  const int lane = threadIdx.x & (G - 1);
  const int k = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  const bool active = k < p.K;
  int carried = 0;
  const float S = dmm_generic_sample<G, F, LAST, GEN, CARRY>(
      p, active ? k : p.K - 1, lane, active, su, sa, sxy, srest, sobs, swts, &carried);
  if (active && lane == 0) p.S[k] = S;
  if (CARRY) dmm_carry_max(carried, p.wp_adv);
}

// The instantiation's launch, past 48 KB of shared memory by its opt-in.
template <int G, class F, bool LAST, bool GEN, bool CARRY>
void launch_rollout_kernel(const DmmGenericArgs& p, unsigned blocks, size_t smem,
                           cudaStream_t s) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(generic_rollout_kernel<G, F, LAST, GEN, CARRY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return;  // the error stays for the launcher's cudaGetLastError
  generic_rollout_kernel<G, F, LAST, GEN, CARRY><<<blocks, kRolloutThreads, smem, s>>>(p);
}

template <int G, class F, bool LAST, bool GEN>
void launch_rollout_g(const DmmGenericArgs& p, size_t smem, cudaStream_t s) {
  const long long threads = static_cast<long long>(p.K) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kRolloutThreads - 1) / kRolloutThreads);
  if (p.carry_span > 0)
    launch_rollout_kernel<G, F, LAST, GEN, true>(p, blocks, smem, s);
  else
    launch_rollout_kernel<G, F, LAST, GEN, false>(p, blocks, smem, s);
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
      smem > kMaxSmemBytes + generic_staged_weight_bytes<F>() || p.carry_span < 0 ||
      p.carry_span > p.W || (p.carry_span > 0 && p.wp_adv == nullptr) ||
      (F::WEIGHTS > 0 && p.weights == nullptr))
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

// DmmGenericArgs::model of the generated functor (ops/cuda/generic_tick.py
// USER_MODEL): one past the built-in families.
constexpr int kUserModel = 4;

// Dispatch on the family: `Launch<F>` for p.model. A library built for a
// generated functor runs that functor alone.
template <template <class> class Launch>
cudaError_t by_model(const DmmGenericArgs& p, cudaStream_t s) {
#ifdef DMM_USER_TILE
  return p.model == kUserModel ? Launch<DmmUserTile>::run(p, s) : cudaErrorInvalidValue;
#else
  switch (p.model) {
    case 0: return Launch<DmmUnicycleTile>::run(p, s);
    case 1: return Launch<DmmKinematicBicycleTile>::run(p, s);
    case 2: return Launch<DmmFourWheelTile>::run(p, s);
    case 3: return Launch<DmmDynamicBicycleTile>::run(p, s);
    default: return cudaErrorInvalidValue;
  }
#endif
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
  if (p.eps_mode != 0 || p.carry_span != 0) return static_cast<int>(cudaErrorInvalidValue);
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

// The lanes a sample the rollout of family `model` (tile.FAMILIES order,
// or kUserModel in a library built for a generated functor) runs with for a
// launch of `samples` samples, ε drawn from the hash stream (hash_eps != 0)
// or injected; -1 for a family the library does not hold.
int dmm_generic_group(int model, long long samples, int hash_eps) {
#ifdef DMM_USER_TILE
  return model == kUserModel ? generic_group<DmmUserTile>(samples, hash_eps != 0) : -1;
#else
  switch (model) {
    case 0: return generic_group<DmmUnicycleTile>(samples, hash_eps != 0);
    case 1: return generic_group<DmmKinematicBicycleTile>(samples, hash_eps != 0);
    case 2: return generic_group<DmmFourWheelTile>(samples, hash_eps != 0);
    case 3: return generic_group<DmmDynamicBicycleTile>(samples, hash_eps != 0);
    default: return -1;
  }
#endif
}

}  // extern "C"
