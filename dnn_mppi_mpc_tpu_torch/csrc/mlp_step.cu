// Fused residual-MLP kernel for Hopper (sm_90a), behind a plain C ABI: the
// whole folded Dense chain (linear, tanh after layers 1 … L−2, linear) of a
// learned residual in one launch.
//
// Replaces the Pallas TPU kernel
//   dmm_fused_mlp <- dnn_mppi_mpc_tpu/ops/pallas/mlp_step.py:78 fused_mlp_apply
//                    (body :52 _mlp_kernel), reached through :194
//                    make_fused_residual_step, the MPPI rollout's dynamics step
//                    with a learned residual.
//
// What it computes: out (K, d_L) = chain(x (K, d_0)), h_{l+1} = h_l·W_l + b_l
// with W_l (d_l, d_{l+1}) row-major, float32, and tanhf after layers
// 1 … L−2. With bf16 != 0 each operand of the products is rounded to bfloat16
// first (products exact in float32, sums and bias in float32), the JAX
// kernel's compute_dtype=bfloat16.
//
// What bounds it on the card. Operations, at the shapes the MPPI rollout
// gives it: 2·K·Σ d_l·d_{l+1} (35.7 MFLOP for 5→128→128→3 at K = 1 024,
// 0.53 µs at 67 TFLOP/s; 1.08 GFLOP, 16 µs, for the 512-wide reference net);
// the weights (69 KiB, 2 MiB) and rows are far fewer bytes. The float32
// products stay off the tensor cores (no TF32: the port's rule of parity),
// and one thread sums each output from its first term in feature order, so
// the kernel rounds op for op like its plain PyTorch version
// (ops/cuda/mlp_step.py fused_mlp_apply_plain; the library is built with
// -fmad=false, see _build.py); tanhf is the one function whose last bit may
// differ from torch.tanh.
//
// Design. Rows are independent: a block of 256 threads owns R = 8 rows and
// walks every layer for them, the activations on chip in a ping-pong of two
// [feature][row] buffers in shared memory. The weights are staged in shared
// memory by cp.async (16-byte copies where the source is 16-byte aligned,
// 4-byte copies for the rest: the 5-wide input, the 3-wide head) in k-chunks
// of at most stage_floats floats (64 KB; a layer that fits is one chunk)
// through a ring of two stages: the next chunk's copy, of this layer or the
// next, runs under the current chunk's multiply-adds. Each thread owns a
// register tile of all 8 rows × RN adjacent columns (RN the smallest power
// of two with 256·RN ≥ the layer's width, at most 8), so each weight it reads
// from shared memory feeds 8 multiply-adds and each activation (a broadcast
// float4 of four rows) feeds RN. Every block streams all the weights from L2
// (2 MiB a block for the 512-wide net, 270 MB a call at K = 1 024): 16 rows
// a block would halve that, but at K = 1 024 leave 64 blocks for 132 SMs,
// each with twice the multiply-adds (two of them a term: -fmad=false), and
// measured slower on one H100; a cluster that multicasts each weight chunk
// to two blocks is the way to cut the L2 reads without losing blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#define DMM_MLP_MAX_LAYERS 16

extern "C" {

// One launch's arguments (mirrored by DmmMlpArgs in _build.py).
struct DmmMlpArgs {
  const float* x;                       // (K, dims[0])
  float* out;                           // (K, dims[n_layers])
  const float* W[DMM_MLP_MAX_LAYERS];   // (dims[l], dims[l+1]) row-major
  const float* b[DMM_MLP_MAX_LAYERS];   // (dims[l+1],)
  int dims[DMM_MLP_MAX_LAYERS + 1];
  int n_layers;
  int K;
  int bf16;
  int d_max;         // max over dims: the activation buffers' feature extent
  int stage_floats;  // floats in one weight stage (a multiple of 4, ≥ every layer's width)
};

}  // extern "C"

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 256;
constexpr int kMaxRN = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block on sm_90

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? round_bf16(v) : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The chunk rows of layer l: as many weight rows as one stage holds.
__device__ __forceinline__ int chunk_rows(const DmmMlpArgs& a, int l) {
  return min(a.dims[l], a.stage_floats / a.dims[l + 1]);
}

// The next weight chunk to copy: layer l, rows from k0.
struct Cursor {
  int l, k0;
};

// Copy chunk c into dst (one commit group, empty past the last layer) and
// move c to the chunk after it.
__device__ void issue(const DmmMlpArgs& a, Cursor& c, float* dst) {
  if (c.l < a.n_layers) {
    const int d_in = a.dims[c.l], d_out = a.dims[c.l + 1];
    const int kc = min(chunk_rows(a, c.l), d_in - c.k0);
    const float* src = a.W[c.l] + static_cast<size_t>(c.k0) * d_out;
    const int n = kc * d_out;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int n16 = n / 4;
      for (int i = threadIdx.x; i < n16; i += kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + 4 * i)),
                     "l"(src + 4 * i));
      done = 4 * n16;
    }
    for (int i = done + threadIdx.x; i < n; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + i)),
                   "l"(src + i));
    c.k0 += kc;
    if (c.k0 >= d_in) {
      ++c.l;
      c.k0 = 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// RN weights of row kk from column j0 (zero past d_out); vec: the RN floats
// are aligned for one vector load.
template <bool BF16, int RN>
__device__ __forceinline__ void load_w(const float* p, bool vec, int left, float (&w)[RN]) {
  bool done = false;
  if constexpr (RN >= 4) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < RN; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + c);
        w[c] = v.x;
        w[c + 1] = v.y;
        w[c + 2] = v.z;
        w[c + 3] = v.w;
      }
      done = true;
    }
  } else if constexpr (RN == 2) {
    if (vec) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      w[0] = v.x;
      w[1] = v.y;
      done = true;
    }
  }
  if (!done) {
#pragma unroll
    for (int c = 0; c < RN; ++c) w[c] = c < left ? p[c] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < RN; ++c) w[c] = operand<BF16>(w[c]);
}

// h[k][0..7] of the block's rows, rounded for the product.
template <bool BF16>
__device__ __forceinline__ void load_rows(const float* in, int k, float (&h)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(in + k * kRows)[q];
    h[4 * q] = operand<BF16>(v.x);
    h[4 * q + 1] = operand<BF16>(v.y);
    h[4 * q + 2] = operand<BF16>(v.z);
    h[4 * q + 3] = operand<BF16>(v.w);
  }
}

// Layer l on the block's rows: in [d_in][8] → nxt [d_out][8] (or out for
// the last layer), its weights arriving chunk by chunk in stage[s].
template <bool BF16, int RN>
__device__ void mlp_layer(const DmmMlpArgs& a, int l, const float* in, float* nxt,
                          float* const (&stage)[2], int& s, Cursor& cur, int row0, int nrows) {
  const int d_in = a.dims[l], d_out = a.dims[l + 1];
  const int ck = chunk_rows(a, l);
  const int j0 = threadIdx.x * RN;
  const bool active = j0 < d_out;
  const bool vec = d_out % RN == 0;
  const int left = d_out - j0;
  float acc[kRows][RN];
#pragma unroll 1
  for (int k0 = 0; k0 < d_in; k0 += ck) {
    issue(a, cur, stage[s ^ 1]);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* ws = stage[s] + j0;
    const int kc = min(ck, d_in - k0);
    if (active) {
      float h[kRows], w[RN];
      int kk = 0;
      if (k0 == 0) {  // each output starts from its first term
        load_w<BF16, RN>(ws, vec, left, w);
        load_rows<BF16>(in, 0, h);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[r][c] = h[r] * w[c];
        kk = 1;
      }
#pragma unroll 4
      for (; kk < kc; ++kk) {
        load_w<BF16, RN>(ws + kk * d_out, vec, left, w);
        load_rows<BF16>(in, k0 + kk, h);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) acc[r][c] = acc[r][c] + h[r] * w[c];
      }
    }
    __syncthreads();
    s ^= 1;
  }
  if (!active) return;
  const bool act = l >= 1 && l <= a.n_layers - 2;
  const bool last = l == a.n_layers - 1;
#pragma unroll
  for (int c = 0; c < RN; ++c) {
    const int j = j0 + c;
    if (j >= d_out) break;
    const float bj = __ldg(a.b[l] + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = acc[r][c] + bj;
      if (act) v = tanhf(v);
      if (!last) {
        nxt[j * kRows + r] = v;
      } else if (r < nrows) {
        a.out[static_cast<size_t>(row0 + r) * d_out + j] = v;
      }
    }
  }
}

__device__ __forceinline__ int layer_rn(int d_out) {
  int rn = 1;
  while (rn * kThreads < d_out) rn *= 2;
  return rn;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_kernel(const __grid_constant__ DmmMlpArgs a) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + kRows * a.d_max;
  float* const stage[2] = {buf1 + kRows * a.d_max, buf1 + kRows * a.d_max + a.stage_floats};
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.K - row0);

  Cursor cur{0, 0};
  issue(a, cur, stage[0]);

  // the block's rows, transposed to [feature][row]; rows past K are zero
  const int f0 = a.dims[0];
  for (int i = threadIdx.x; i < kRows * f0; i += kThreads) {
    const int r = i / f0, k = i - r * f0;
    buf0[k * kRows + r] = r < nrows ? a.x[static_cast<size_t>(row0 + r) * f0 + k] : 0.0f;
  }

  float* in = buf0;
  float* nxt = buf1;
  int s = 0;
#pragma unroll 1
  for (int l = 0; l < a.n_layers; ++l) {
    switch (layer_rn(a.dims[l + 1])) {
      case 1: mlp_layer<BF16, 1>(a, l, in, nxt, stage, s, cur, row0, nrows); break;
      case 2: mlp_layer<BF16, 2>(a, l, in, nxt, stage, s, cur, row0, nrows); break;
      case 4: mlp_layer<BF16, 4>(a, l, in, nxt, stage, s, cur, row0, nrows); break;
      default: mlp_layer<BF16, kMaxRN>(a, l, in, nxt, stage, s, cur, row0, nrows); break;
    }
    float* t = in;
    in = nxt;
    nxt = t;
  }
}

template <bool BF16>
cudaError_t launch_mlp(const DmmMlpArgs& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_mlp_kernel<BF16><<<(a.K + kRows - 1) / kRows, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(DmmMlpArgs), checked against the ctypes mirror at load time.
int dmm_mlp_args_size() { return static_cast<int>(sizeof(DmmMlpArgs)); }

// out = chain(x). Returns cudaErrorInvalidValue without launching on a shape
// it does not take: no layer or more than DMM_MLP_MAX_LAYERS, K < 1, a width
// < 1 or over d_max or over 256·kMaxRN, a stage that does not hold one weight
// row of every layer, or buffers over the shared-memory limit.
int dmm_fused_mlp(const DmmMlpArgs* args, void* stream) {
  const DmmMlpArgs a = *args;
  if (a.n_layers < 1 || a.n_layers > DMM_MLP_MAX_LAYERS || a.K < 1 || a.stage_floats < 4 ||
      a.stage_floats % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_width = kThreads * kMaxRN;
  for (int l = 0; l <= a.n_layers; ++l)
    if (a.dims[l] < 1 || a.dims[l] > a.d_max) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 1; l <= a.n_layers; ++l)
    if (a.dims[l] > max_width || a.dims[l] > a.stage_floats)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(kRows) * a.d_max +
                                       2 * static_cast<size_t>(a.stage_floats));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.bf16 ? launch_mlp<true>(a, smem, s) : launch_mlp<false>(a, smem, s));
}

}  // extern "C"
