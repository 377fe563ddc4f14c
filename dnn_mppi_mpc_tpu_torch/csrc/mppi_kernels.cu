// Diff-drive MPPI kernels for Hopper (sm_90a), behind a plain C ABI.
//
// Replaces five Pallas TPU kernels:
//   dmm_rollout_costs  <- dnn_mppi_mpc_tpu/ops/pallas/rollout.py:146
//                         diffdrive_rollout_costs (split rollout, ε in, S out)
//   dmm_mppi_tick      <- dnn_mppi_mpc_tpu/ops/pallas/mppi_tick.py:733
//                         diffdrive_mppi_tick (eps_mode 0, 1 or 2 with
//                         k_blk == K: ε injected, drawn and stored, or drawn
//                         and drawn again in Σ w·ε; with carry_span > 0 its
//                         rollout_carry mode, the furthest carried window
//                         row to wp_adv)
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
// neither the 67 TFLOP/s nor the 3.35 TB/s is near. With one thread a
// sample the flagship's K = 10 240 is ~2.4 warps an SM and the fleet's
// B·K = 16 384 ~3.9, each thread walking a dependent chain a step (a hash
// draw, a sincosf, the W-row compare-and-select search): bound by that
// chain's latency. At pod-scale K = 102 400 one thread a sample is already
// ~24 warps an SM, within ~2× of the issue floor.
//
// Design. The rollout (diffdrive_rollout.cuh) runs G lanes a sample: the
// search split W/G rows a lane (eight rows' loads in flight together) and
// merged in log2 G shuffle rounds, each lane drawing every G-th step's ε;
// every lane issues the dynamics, so a larger G shortens the chain and
// issues more. The launcher picks G from the launch's sample count B·K
// (rollout_group): G = 2 up to 16 384 samples (the flagship's 10 240 and
// the fleet's 16 384), G = 1 beyond (32 768, 65 536 and pod K's 102 400
// measured); G = 4 and 8 lost at every shape (root PERF.md §6). 64-thread blocks, so that the flagship's
// rollout spreads over all 132 SMs at every G; u, a, the window ((x, y) and
// yaw rows) and the obstacles staged in shared memory. A fleet is a member
// grid dimension (dmm_member), one controller B = 1. The fused and K-blocked
// ticks run the chunked reductions (mppi_reductions.cuh): each chunk's
// softmax statistics, Σ w·ε on a grid of chunks × step groups sized from the
// launch, and one block for the in-order chunk sum and the epilogue: four
// launches, the rollout included. Without emit_eps the fused tick's hash ε
// is drawn again in Σ w·ε (eps_mode 2) instead of stored: the same bits in
// the same order, so both routes give the same results. The fleet keeps the
// one-block softmax a member and Σ w·ε on (T, B) blocks: the chunked form
// with a member dimension was slower on the card. The sharded tick's
// weighted noise reduce runs the same Σ w·ε grid from the weights it is
// given, then the chunk sum: two launches, and given the K-blocked tick's
// own w it returns that tick's Σ w·ε bit for bit. No atomics: results
// repeat bit for bit from run to run.
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

// Lanes a sample. The rule: kGroupFew lanes when a launch rolls out at most
// kFewSamples samples (all members together), else kGroupMany (root PERF.md
// §6: G ∈ {1, 2, 4, 8} measured at the flagship, fleet and pod-K shapes;
// G = 2 won by 1.0-1.4 µs at 10 240 and 16 384 samples and lost by 7.6 µs
// at 32 768). Only these two are built into the library. A build with
// -DDMM_DIFFDRIVE_GROUP=g runs every launch at G = g (chip_smoke.py times G
// side by side with such builds).
#ifdef DMM_DIFFDRIVE_GROUP
constexpr int kGroupFew = DMM_DIFFDRIVE_GROUP, kGroupMany = DMM_DIFFDRIVE_GROUP;
#else
constexpr int kGroupFew = 2, kGroupMany = 1;
#endif
constexpr long long kFewSamples = 16384;

int rollout_group(long long samples) { return samples <= kFewSamples ? kGroupFew : kGroupMany; }

// The fields of DmmArgs that the reductions read and write.
DmmReduceArgs reduce_args(const DmmArgs& p) {
  return DmmReduceArgs{p.S, p.w, p.stats, p.eps_mode == 2 ? nullptr : p.eps, p.w_eps,
                       p.chol, p.seed, p.K, p.k_blk, p.inv_temp, p.block_offset,
                       p.scratch, p.scratch_floats};
}

// Block (x, b) rolls out the samples of member b (dmm_member; one controller
// is member 0), G lanes each. CARRY (one controller only): each sample
// carries its window start, and every warp raises wp_adv to its furthest.
template <int G, bool ISO, bool LAST, bool GEN, bool CARRY>
__global__ void __launch_bounds__(kRolloutThreads) rollout_kernel(DmmArgs p0) {
  const DmmArgs p = dmm_member(p0, blockIdx.y);
  extern __shared__ float smem[];
  float* su = smem;
  float* sa = su + 2 * p.T;
  float2* sxy = reinterpret_cast<float2*>(sa + 2 * p.T);  // 8-byte aligned: 4·T floats in
  float* syaw = reinterpret_cast<float*>(sxy + p.W);
  float* sobs = syaw + p.W;
  for (int i = threadIdx.x; i < 2 * p.T; i += blockDim.x) {
    su[i] = p.u[i];
    sa[i] = p.a[i];
  }
  for (int i = threadIdx.x; i < p.W; i += blockDim.x) {
    sxy[i] = make_float2(p.window[3 * i], p.window[3 * i + 1]);
    syaw[i] = p.window[3 * i + 2];
  }
  for (int i = threadIdx.x; i < 5 * p.n_obs; i += blockDim.x) sobs[i] = p.obstacles[i];
  __syncthreads();
  const int lane = threadIdx.x & (G - 1);
  const int k = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G);
  const bool active = k < p.K;
  int carried = 0;
  const float S = dmm_rollout_sample<G, ISO, LAST, GEN, CARRY>(
      p, active ? k : p.K - 1, lane, active, su, sa, sxy, syaw, sobs, &carried);
  if (active && lane == 0) p.S[k] = S;
  if (CARRY) dmm_carry_max(carried, p.wp_adv);
}

template <int G, bool ISO, bool LAST, bool CARRY>
void launch_rollout_carry(const DmmArgs& p, int B, size_t smem, cudaStream_t s) {
  const long long threads = static_cast<long long>(p.K) * G;
  const dim3 grid(static_cast<unsigned>((threads + kRolloutThreads - 1) / kRolloutThreads), B);
  if (p.eps_mode == 0)
    rollout_kernel<G, ISO, LAST, false, CARRY><<<grid, kRolloutThreads, smem, s>>>(p);
  else
    rollout_kernel<G, ISO, LAST, true, CARRY><<<grid, kRolloutThreads, smem, s>>>(p);
}

template <int G, bool ISO, bool LAST>
void launch_rollout_g(const DmmArgs& p, int B, size_t smem, cudaStream_t s) {
  if (p.carry_span > 0)
    launch_rollout_carry<G, ISO, LAST, true>(p, B, smem, s);
  else
    launch_rollout_carry<G, ISO, LAST, false>(p, B, smem, s);
}

template <bool ISO, bool LAST>
void launch_rollout_iso_last(const DmmArgs& p, int B, size_t smem, cudaStream_t s) {
  if (rollout_group(static_cast<long long>(B) * p.K) == kGroupFew)
    launch_rollout_g<kGroupFew, ISO, LAST>(p, B, smem, s);
  else
    launch_rollout_g<kGroupMany, ISO, LAST>(p, B, smem, s);
}

// The rollout of B members (B = 1: one controller).
cudaError_t launch_rollout(const DmmArgs& p, int B, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(4 * p.T + 3 * p.W + 5 * p.n_obs) * sizeof(float);
  if (p.K <= 0 || p.K > (1 << 26) || p.T <= 0 || p.W <= 0 || p.n_obs < 0 || B <= 0 ||
      B > 65535 || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  if (p.eps_mode != 0 && (p.k_blk <= 0 || p.K % p.k_blk != 0)) return cudaErrorInvalidValue;
  // the carry: one controller, one noise-stream block, a span within the rows
  if (p.carry_span < 0 || p.carry_span > p.W ||
      (p.carry_span > 0 && (B != 1 || p.wp_adv == nullptr || p.block_offset != 0 ||
                            (p.eps_mode != 0 && p.k_blk != p.K))))
    return cudaErrorInvalidValue;
  if (p.iso_xy) {
    if (p.last_only) launch_rollout_iso_last<true, true>(p, B, smem, s);
    else launch_rollout_iso_last<true, false>(p, B, smem, s);
  } else {
    if (p.last_only) launch_rollout_iso_last<false, true>(p, B, smem, s);
    else launch_rollout_iso_last<false, false>(p, B, smem, s);
  }
  return cudaGetLastError();
}

// The epilogue's fields (filter_t null: no epilogue).
DmmEpilogueArgs epilogue_args(const DmmArgs& p) {
  return DmmEpilogueArgs{p.fuse_epilogue ? p.filter_t : nullptr, p.w_eps, p.u, p.u_new,
                         p.u_shift, p.finite, p.T};
}

// The fused or K-blocked tick.
cudaError_t mppi_tick(const DmmArgs& p, cudaStream_t s) {
  if (p.T > 1024 || (p.s_only && p.eps_mode != 2) || p.eps_mode < 0 || p.eps_mode > 2 ||
      (p.s_only && p.carry_span != 0))
    return cudaErrorInvalidValue;
  if (!p.s_only && !chunked_reductions_take(reduce_args(p), p.T, epilogue_args(p)))
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_rollout(p, 1, s);
  if (err != cudaSuccess || p.s_only) return err;
  return launch_chunked_reductions(reduce_args(p), p.T, epilogue_args(p), s);
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
  if (p.eps_mode != 0 || p.carry_span != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_rollout(p, 1, static_cast<cudaStream_t>(stream)));
}

// Fused tick (eps_mode 0: ε injected; 1: drawn and stored; 2 with k_blk =
// K: drawn, and drawn again in Σ w·ε) and K-blocked tick (eps_mode 2): the
// rollout, the chunked softmax statistics, Σ w·ε, and the chunk sum with the
// epilogue when fuse_epilogue is set: four launches. With s_only the
// rollout alone.
int dmm_mppi_tick(const DmmArgs* args, void* stream) {
  return static_cast<int>(mppi_tick(*args, static_cast<cudaStream_t>(stream)));
}

// The floats of scratch (DmmArgs::scratch) a fused or K-blocked tick needs
// at (K, k_blk, T): the wrapper allocates this many.
long long dmm_chunk_scratch_floats(int K, int k_blk, int T) {
  return K > 0 && k_blk > 0 && K % k_blk == 0 && T > 0 ? chunk_scratch_floats(K, k_blk, T, 2)
                                                       : -1;
}

// The lanes a sample the rollout runs with for a launch of `samples`
// samples (all members together).
int dmm_rollout_group(long long samples) { return rollout_group(samples); }

// Σₖ wₖ·εₖ with ε drawn again from (seed, block_offset + k / k_blk): reads
// w (K,), chol and the seed, writes w_eps (T, 2) through the scratch
// (dmm_chunk_scratch_floats(K, k_blk, T) floats). Σ w·ε on the chunked grid,
// then the chunk sum: two launches; bad arguments are refused before either.
int dmm_weighted_noise_reduce(const DmmArgs* args, void* stream) {
  return static_cast<int>(launch_chunked_weighted_eps(reduce_args(*args), args->T,
                                                      static_cast<cudaStream_t>(stream)));
}

// B complete ticks (hash ε from seeds[b], one block of K per member): the
// rollout, the one-block softmax of each member and Σ w·ε on (T, B) blocks
// (ε drawn again), each launch one grid for all members: three launches.
int dmm_fleet_mppi_tick(const DmmFleetArgs* args, void* stream) {
  const DmmArgs p = args->m;
  const int B = args->B;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || p.eps_mode != 2 || p.k_blk != p.K || p.block_offset != 0 ||
      p.fuse_epilogue || p.carry_span != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch_rollout(p, B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reductions<true>(reduce_args(p), p.T, B, s));
}

}  // extern "C"
