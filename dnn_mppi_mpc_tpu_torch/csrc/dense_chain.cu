// ResNet dense-chain kernel for Hopper (sm_90a), behind a plain C ABI: a
// whole folded 1-D ResNet-18/50 at L = 1 (models/learned.py
// fold_resnet1d_l1_arrays) in one launch per net evaluation.
//
// Replaces the Pallas TPU kernel
//   dmm_resnet_chain <- dnn_mppi_mpc_tpu/ops/pallas/dense_chain.py:104
//                       make_resnet_chain_fn (its pallas_call at :232)
//
// What it computes, per row: h = bf16(x); the stem h = bf16(relu(h·W + b));
// for every residual block r = h·W_down + b_down (float32) or r = h, then
// y = bf16(relu(h·W_0 + b_0)) (and y = bf16(relu(y·W_1 + b_1)) in a
// bottleneck), the last conv's y·W + b in float32, h = bf16(relu(y + r)); the
// head tanhf(h·W + b). Weights are bfloat16, every product has bfloat16
// operands, sums and biases are float32: the TPU kernel's rounding points
// (dense_chain.py:201-220).
//
// What bounds it on the card. Operations: 2·B·Σ c_in·c_out bf16 products,
// 27.4 GFLOP for ResNet-50 at B = 1 024 (27.7 µs at the 989 TFLOP/s of the
// bf16 tensor cores) and 2.86 GFLOP (2.9 µs) for ResNet-18; the bf16 weights
// (26.8 and 2.8 MB) are 8.0 and 0.85 µs at 3.35 TB/s. Each layer depends on
// the one before, so the chain is ~50 dependent GEMMs (ResNet-50), each too
// small to fill the card alone (B × c_out = 1 024 × 64 … 2 048), and the
// floor is the phases' count times a grid-wide barrier plus each phase's
// tensor-core work.
//
// Design. One persistent cooperative launch (cudaLaunchCooperativeKernel,
// one block of 256 threads per SM) walks the layer program; every layer is a
// bf16 GEMM (B_pad × k_pad)·(k_pad × n_pad) with float32 accumulation on the
// tensor cores (mma.sync.m16n8k16 bf16, operands by ldmatrix; not wgmma),
// its output tiles spread over the grid, and a grid-wide barrier
// (cooperative_groups::this_grid().sync()) between dependent phases. A
// block's downsample and its first conv read the same h, so they share one
// phase: ResNet-50 is 50 phases, ResNet-18 18. The activations live in a
// global scratch that the wrapper allocates (h bf16, r float32, two inner
// buffers bf16: 4 + 8 + 2 × 1 MB at B = 1 024), small enough to stay in the
// 50 MB L2. Each layer's tile (128×128, 64×128, 64×64, 32×64 or 32×32; 8
// warps as 2 × 4) comes from the wrapper's plan (ops/cuda/dense_chain.py
// chain_plan), a cost model fitted to per-layer timings on the card: the
// narrow layers (c_out = 64) run 64 tiles of 32×32, not 8 of 128×128. The k
// loop streams 64-deep chunks of the A (activation) and B (weight) tiles
// into a shared-memory ring by cp.async (16 bytes a copy, L2 only), as deep
// as 110.6 KB holds (3 stages of 128×128 tiles, 8 of the small ones), with
// the 4 k steps of a chunk unrolled. The weights are packed once, at bind
// time, as (n_pad, k_pad) bf16 — the MMA's column-major B — with c_out
// padded to 32 and c_in to 32 (the stem's to 16), the padding zero, so the
// kernel needs no bounds but the stem's, which reads the float32 x directly
// and rounds it to bf16. Bias, ReLU, bf16 rounding, the residual add and the
// head's tanhf run on the accumulator tile in registers before its one store.
// What holds it back (PERF.md): each phase's copies from L2 into the SMs run
// far below the tensor cores' rate, and each barrier and phase start costs
// about 3 µs; splitting k over more blocks (with a fix-up of the partial
// tiles), two blocks an SM, and padded row strides all measured slower or
// no faster. TMA copies with wgmma, and weight tiles shared by a cluster,
// are the next steps.
//
// Rounding. The tensor core sums each output's products in its own order,
// not in input-channel order, so an output can differ from the plain
// version's (ops/cuda/dense_chain.py resnet_chain_plain) by a float32 ulp
// before its bf16 rounding, and one flipped bf16 rounding carries through
// the later layers: the compares in chip_smoke.py state their limits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#define DMM_CHAIN_MAX_LAYERS 64
#define DMM_CHAIN_MAX_BLOCKS 16

extern "C" {

// One launch's arguments (mirrored by DmmChainArgs in _build.py). Layer l's
// weights are (n_pad[l], k_pad[l]) bfloat16 row-major (W transposed, c_in
// contiguous), its bias (n_pad[l],) float32, the padding zero. Layer order:
// the stem, then per block its downsample (if down[j]) and its n_convs convs,
// then the head. The scratch holds B_pad rows: h (bf16, c_max columns), r
// (float32, c_max), y0 and y1 (bf16, y_max).
struct DmmChainArgs {
  const float* x;  // (B, c_in[0])
  float* out;      // (B, out_dim)
  const void* W[DMM_CHAIN_MAX_LAYERS];
  const float* b[DMM_CHAIN_MAX_LAYERS];
  int c_in[DMM_CHAIN_MAX_LAYERS];
  int k_pad[DMM_CHAIN_MAX_LAYERS];
  int n_pad[DMM_CHAIN_MAX_LAYERS];
  int down[DMM_CHAIN_MAX_BLOCKS];
  // the launch plan (ops/cuda/dense_chain.py chain_plan): each layer's
  // output tile, bm × bn
  int bm[DMM_CHAIN_MAX_LAYERS];
  int bn[DMM_CHAIN_MAX_LAYERS];
  void* h;
  void* r;
  void* y0;
  void* y1;
  int B;
  int B_pad;  // B rounded up to kRowAlign
  int grid;   // blocks of the cooperative launch
  int n_layers;
  int n_blocks;
  int n_convs;
  int out_dim;
  int c_max;  // columns of h and r: the widest padded block input/output
  int y_max;  // columns of y0 and y1: the widest padded inner conv output
};

}  // extern "C"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 8 warps: 2 along M × 4 along N
constexpr int kBK = 64;        // k depth of a staged chunk
constexpr int kLds = kBK + 8;  // smem row stride (bf16): 144 B, ldmatrix without bank conflicts
constexpr int kRowAlign = 128;  // B_pad: a multiple of every tile's BM
constexpr int kColAlign = 32;   // n_pad: a multiple of the smallest tile's BN
constexpr size_t kSmem = 110592;  // the ring: 3 stages of 128×128 tiles
constexpr int kMaxStages = 8;

// stages of the ring for a BM × BN tile: as many as kSmem holds, at most kMaxStages
template <int BM, int BN>
__host__ __device__ constexpr int ring_stages() {
  return kSmem / (sizeof(__nv_bfloat16) * (BM + BN) * kLds) < kMaxStages
             ? static_cast<int>(kSmem / (sizeof(__nv_bfloat16) * (BM + BN) * kLds))
             : kMaxStages;
}

enum Epilogue { kReluBf16, kF32, kResidual, kHead };

// One GEMM of a phase: dst = epilogue(A·W + b) over B_pad rows and n_pad
// columns, in bm × bn tiles.
struct Gemm {
  const __nv_bfloat16* A;  // (B_pad, lda) bf16, or nullptr: the stem reads x
  int lda;
  const __nv_bfloat16* W;  // (n_pad, k_pad)
  const float* bias;
  int k_pad, n_pad, c_in;
  int kind;
  void* dst;  // bf16 or float32 (kF32), ldd columns; kHead: out
  int ldd;
  const void* res;  // kResidual: r (float32) or h (bf16), ldd columns
  int res_f32;
  int bm, bn, tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a·b on one m16n8k16 bf16 tile, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage chunk [k0, k0 + kc) of the tile's A rows and W rows into one ring slot.
template <int BM, int BN>
__device__ __forceinline__ void load_chunk(const DmmChainArgs& a, const Gemm& g, int m0, int n0,
                                           int k0, int kc, __nv_bfloat16* sA,
                                           __nv_bfloat16* sB) {
  if (g.A != nullptr) {
    if (kc == kBK) {  // 8 16-byte pieces a row: shifts, no division
      for (int i = threadIdx.x; i < BM * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        cp_async16(sA + r * kLds + c * 8, g.A + static_cast<size_t>(m0 + r) * g.lda + k0 + c * 8);
      }
    } else {
      const int pieces = kc / 8;
      for (int i = threadIdx.x; i < BM * pieces; i += kThreads) {
        const int r = i / pieces, c = i - r * pieces;
        cp_async16(sA + r * kLds + c * 8, g.A + static_cast<size_t>(m0 + r) * g.lda + k0 + c * 8);
      }
    }
  } else {  // the stem: float32 x, rounded to bf16, zero past B and c_in
    for (int i = threadIdx.x; i < BM * kc; i += kThreads) {
      const int r = i / kc, c = i - r * kc;
      const int row = m0 + r, k = k0 + c;
      const float v = (row < a.B && k < g.c_in) ? a.x[static_cast<size_t>(row) * g.c_in + k] : 0.0f;
      sA[r * kLds + c] = __float2bfloat16_rn(v);
    }
  }
  if (kc == kBK) {
    for (int i = threadIdx.x; i < BN * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7;
      cp_async16(sB + r * kLds + c * 8, g.W + static_cast<size_t>(n0 + r) * g.k_pad + k0 + c * 8);
    }
  } else {
    const int pieces = kc / 8;
    for (int i = threadIdx.x; i < BN * pieces; i += kThreads) {
      const int r = i / pieces, c = i - r * pieces;
      cp_async16(sB + r * kLds + c * 8, g.W + static_cast<size_t>(n0 + r) * g.k_pad + k0 + c * 8);
    }
  }
}

// One k step (16 deep) of the warp's MI × NI sub-tiles.
template <int MI, int NI>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NI][4], const __nv_bfloat16* tA,
                                         const __nv_bfloat16* tB, int wm0, int wn0, int k,
                                         int lane) {
  uint32_t af[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
    ldmatrix_x4(af[i], tA + (wm0 + i * 16 + lane % 16) * kLds + k + (lane / 16) * 8);
  uint32_t bf[NI][2];
  if constexpr (NI == 1) {
    ldmatrix_x2(bf[0], tB + (wn0 + lane % 8) * kLds + k + ((lane / 8) % 2) * 8);
  } else {
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      uint32_t t[4];
      const int mat = lane / 8;
      ldmatrix_x4(t, tB + (wn0 + j * 8 + (mat / 2) * 8 + lane % 8) * kLds + k + (mat % 2) * 8);
      bf[j][0] = t[0];
      bf[j][1] = t[1];
      bf[j + 1][0] = t[2];
      bf[j + 1][1] = t[3];
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
}

// One BM × BN output tile of g: the k loop on the tensor cores through a
// ring of STAGES chunks, then the epilogue from the accumulators.
template <int BM, int BN>
__device__ void gemm_tile(const DmmChainArgs& a, const Gemm& g, int tile, __nv_bfloat16* smem) {
  constexpr int STAGES = ring_stages<BM, BN>();
  constexpr int WM = BM / 2, WN = BN / 4;  // a warp's sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int kStage = (BM + BN) * kLds;
  const int tiles_n = g.n_pad / BN;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / 4) * WM, wn0 = (warp % 4) * WN;
  const int nk = (g.k_pad + kBK - 1) / kBK;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      const int k0 = s * kBK;
      load_chunk<BM, BN>(a, g, m0, n0, k0, min(kBK, g.k_pad - k0), smem + s * kStage,
                         smem + s * kStage + BM * kLds);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kc + STAGES - 1;
    if (pre < nk) {
      const int k0 = pre * kBK;
      __nv_bfloat16* st = smem + (pre % STAGES) * kStage;
      load_chunk<BM, BN>(a, g, m0, n0, k0, min(kBK, g.k_pad - k0), st, st + BM * kLds);
    }
    cp_async_commit();
    const __nv_bfloat16* tA = smem + (kc % STAGES) * kStage;
    const __nv_bfloat16* tB = tA + BM * kLds;
    const int k0 = kc * kBK;
    if (g.k_pad - k0 >= kBK) {
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) mma_step<MI, NI>(acc, tA, tB, wm0, wn0, ks * 16, lane);
    } else {
      const int steps = (g.k_pad - k0) / 16;
#pragma unroll 1
      for (int ks = 0; ks < steps; ++ks) mma_step<MI, NI>(acc, tA, tB, wm0, wn0, ks * 16, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next tile

  // epilogue: c0, c1 at (lane/4, 2·(lane%4) + {0, 1}); c2, c3 eight rows down
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = n0 + wn0 + j * 8 + (lane % 4) * 2;
      const float b0 = __ldg(g.bias + col), b1 = __ldg(g.bias + col + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm0 + i * 16 + lane / 4 + half * 8;
        const float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        const size_t o = static_cast<size_t>(row) * g.ldd + col;
        if (g.kind == kReluBf16) {
          reinterpret_cast<__nv_bfloat162*>(g.dst)[o / 2] =
              __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        } else if (g.kind == kF32) {
          reinterpret_cast<float2*>(g.dst)[o / 2] = make_float2(v0, v1);
        } else if (g.kind == kResidual) {
          float r0, r1;
          if (g.res_f32) {
            const float2 rr = __ldcg(reinterpret_cast<const float2*>(g.res) + o / 2);
            r0 = rr.x;
            r1 = rr.y;
          } else {
            const unsigned int u = __ldcg(reinterpret_cast<const unsigned int*>(g.res) + o / 2);
            __nv_bfloat162 hb;
            *reinterpret_cast<unsigned int*>(&hb) = u;
            const float2 rr = __bfloat1622float2(hb);
            r0 = rr.x;
            r1 = rr.y;
          }
          reinterpret_cast<__nv_bfloat162*>(g.dst)[o / 2] =
              __floats2bfloat162_rn(fmaxf(v0 + r0, 0.0f), fmaxf(v1 + r1, 0.0f));
        } else if (row < a.B) {  // kHead
          if (col < a.out_dim) a.out[static_cast<size_t>(row) * a.out_dim + col] = tanhf(v0);
          if (col + 1 < a.out_dim) a.out[static_cast<size_t>(row) * a.out_dim + col + 1] = tanhf(v1);
        }
      }
    }
  }
}

__device__ void run_tile(const DmmChainArgs& a, const Gemm& g, int tile, __nv_bfloat16* smem) {
  switch (g.bm * 1000 + g.bn) {
    case 128128: gemm_tile<128, 128>(a, g, tile, smem); break;
    case 64128: gemm_tile<64, 128>(a, g, tile, smem); break;
    case 64064: gemm_tile<64, 64>(a, g, tile, smem); break;
    case 32064: gemm_tile<32, 64>(a, g, tile, smem); break;
    default: gemm_tile<32, 32>(a, g, tile, smem); break;
  }
}

__device__ Gemm layer(const DmmChainArgs& a, int l, const __nv_bfloat16* A, int lda, int kind,
                      void* dst, int ldd) {
  Gemm g;
  g.A = A;
  g.lda = lda;
  g.W = static_cast<const __nv_bfloat16*>(a.W[l]);
  g.bias = a.b[l];
  g.k_pad = a.k_pad[l];
  g.n_pad = a.n_pad[l];
  g.c_in = a.c_in[l];
  g.kind = kind;
  g.dst = dst;
  g.ldd = ldd;
  g.res = nullptr;
  g.res_f32 = 0;
  g.bm = a.bm[l];
  g.bn = a.bn[l];
  g.tiles = (a.B_pad / g.bm) * (g.n_pad / g.bn);
  return g;
}

// The tiles of one phase (one GEMM, or two that read the same input) over the
// grid, then the grid-wide barrier unless it is the last phase.
__device__ void phase(const DmmChainArgs& a, const Gemm& g0, const Gemm& g1, bool two,
                      __nv_bfloat16* smem, bool sync) {
  const int total = g0.tiles + (two ? g1.tiles : 0);
#pragma unroll 1
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    if (t < g0.tiles)
      run_tile(a, g0, t, smem);
    else
      run_tile(a, g1, t - g0.tiles, smem);
  }
  if (sync) cg::this_grid().sync();
}

__global__ void __launch_bounds__(kThreads, 1)
    resnet_chain_kernel(const __grid_constant__ DmmChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(a.h);
  float* r = static_cast<float*>(a.r);
  __nv_bfloat16* y[2] = {static_cast<__nv_bfloat16*>(a.y0), static_cast<__nv_bfloat16*>(a.y1)};

  const Gemm stem = layer(a, 0, nullptr, 0, kReluBf16, h, a.c_max);
  phase(a, stem, stem, false, smem, true);
  int l = 1;
#pragma unroll 1
  for (int blk = 0; blk < a.n_blocks; ++blk) {
    const bool has_down = a.down[blk] != 0;
    const Gemm down = has_down ? layer(a, l++, h, a.c_max, kF32, r, a.c_max) : stem;
    // the inner convs ping-pong through y0 and y1; the last writes h
    const __nv_bfloat16* in = h;
    int lda = a.c_max;
#pragma unroll 1
    for (int c = 0; c < a.n_convs; ++c) {
      const bool last = c == a.n_convs - 1;
      Gemm g = last ? layer(a, l++, in, lda, kResidual, h, a.c_max)
                    : layer(a, l++, in, lda, kReluBf16, y[c & 1], a.y_max);
      if (last) {
        g.res = has_down ? static_cast<const void*>(r) : static_cast<const void*>(h);
        g.res_f32 = has_down;
      }
      phase(a, g, down, c == 0 && has_down, smem, true);
      in = y[c & 1];
      lda = a.y_max;
    }
  }
  const Gemm head = layer(a, l, h, a.c_max, kHead, a.out, a.out_dim);
  phase(a, head, head, false, smem, false);
}

bool g_attr_set = false;

cudaError_t set_smem_attr() {
  if (g_attr_set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      resnet_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  g_attr_set = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// sizeof(DmmChainArgs), checked against the ctypes mirror at load time.
int dmm_chain_args_size() { return static_cast<int>(sizeof(DmmChainArgs)); }

// The cooperative grid the current device can hold: *blocks_per_sm blocks of
// the chain kernel co-resident on each of *num_sms SMs, and the kernel's
// dynamic shared memory in *smem_bytes.
int dmm_chain_occupancy(int* blocks_per_sm, int* num_sms, int* smem_bytes) {
  cudaError_t e = set_smem_attr();
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_bytes = static_cast<int>(kSmem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, resnet_chain_kernel, kThreads, kSmem));
}

// out = the folded net of x, one cooperative launch. Returns
// cudaErrorInvalidValue without launching on a program it does not take
// (layer count not 2 + blocks·convs + downs, an inner conv count below 2,
// widths not padded as pack_resnet_chain pads them, B_pad not B rounded up to
// 128, or a tile the kernel does not have or that does not divide n_pad); a
// grid over the co-resident limit fails in the launch itself
// (cudaErrorCooperativeLaunchTooLarge).
int dmm_resnet_chain(const DmmChainArgs* args, void* stream) {
  const DmmChainArgs& a = *args;
  if (a.B < 1 || a.n_blocks < 0 || a.n_blocks > DMM_CHAIN_MAX_BLOCKS || a.n_convs < 2 ||
      a.n_layers < 2 || a.n_layers > DMM_CHAIN_MAX_LAYERS || a.out_dim < 1 || a.grid < 1 ||
      a.B_pad != (a.B + kRowAlign - 1) / kRowAlign * kRowAlign)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 2 + a.n_blocks * a.n_convs;
  for (int j = 0; j < a.n_blocks; ++j) n += a.down[j] ? 1 : 0;
  if (n != a.n_layers || a.out_dim > a.n_pad[n - 1] || a.c_max % kColAlign ||
      a.y_max % kColAlign)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n; ++l) {
    const int tile = a.bm[l] * 1000 + a.bn[l];
    if (a.n_pad[l] < kColAlign || a.n_pad[l] % kColAlign || a.k_pad[l] < 16 ||
        a.k_pad[l] % 16 || a.c_in[l] < 1 || a.c_in[l] > a.k_pad[l] ||
        (tile != 128128 && tile != 64128 && tile != 64064 && tile != 32064 && tile != 32032) ||
        a.n_pad[l] % a.bn[l])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = set_smem_attr();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {const_cast<DmmChainArgs*>(args)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(resnet_chain_kernel),
                                  dim3(a.grid), dim3(kThreads), params, kSmem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
