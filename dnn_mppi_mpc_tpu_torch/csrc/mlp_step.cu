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
// the weights (69 KiB, 2 MiB) and rows are far fewer bytes. Design: rows are
// independent, so a block owns kRows = 8 of them (128 blocks at K = 1 024,
// about one per SM) and walks every layer for them, the activations kept on
// chip in a ping-pong of two [feature][row] buffers in dynamic shared memory
// (2·8·d_max floats, opted in past 48 KiB: up to d_max = 3 632), so no
// activation goes to device memory between layers. Each thread owns one output
// column at a time and all 8 rows of it: per input feature k it reads one
// weight (coalesced across the warp, from L2: the weights stream, they are
// not staged) and the 8 rows' h[k] (two broadcast float4 loads), and adds 8
// products. A tiled warpgroup-MMA version is later work; it would also need
// the plain version's summation order to change.
//
// Each output is summed from its first term in feature order, then the bias
// added, and the library is built with -fmad=false (see _build.py), so the
// kernel rounds op for op like its plain PyTorch version
// (ops/cuda/mlp_step.py fused_mlp_apply_plain); tanhf is the one function
// whose last bit may differ from torch.tanh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
  int d_max;  // max over dims: the activation buffers' feature extent
};

}  // extern "C"

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block on sm_90

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? round_bf16(v) : v;
}

// h[k][0..7] of the block's rows, rounded for the product.
template <bool BF16>
__device__ __forceinline__ void load_rows(const float* in, int k, float (&h)[kRows]) {
  const float4 a = reinterpret_cast<const float4*>(in + k * kRows)[0];
  const float4 c = reinterpret_cast<const float4*>(in + k * kRows)[1];
  h[0] = operand<BF16>(a.x);
  h[1] = operand<BF16>(a.y);
  h[2] = operand<BF16>(a.z);
  h[3] = operand<BF16>(a.w);
  h[4] = operand<BF16>(c.x);
  h[5] = operand<BF16>(c.y);
  h[6] = operand<BF16>(c.z);
  h[7] = operand<BF16>(c.w);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const __grid_constant__ DmmMlpArgs a) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + kRows * a.d_max;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.K - row0);

  // the block's rows, transposed to [feature][row]; rows past K are zero
  const int f0 = a.dims[0];
  for (int i = threadIdx.x; i < kRows * f0; i += kThreads) {
    const int r = i / f0, k = i - r * f0;
    buf0[k * kRows + r] = r < nrows ? a.x[static_cast<size_t>(row0 + r) * f0 + k] : 0.0f;
  }
  __syncthreads();

  float* in = buf0;
  float* nxt = buf1;
#pragma unroll 1
  for (int l = 0; l < a.n_layers; ++l) {
    const int d_in = a.dims[l], d_out = a.dims[l + 1];
    const float* __restrict__ W = a.W[l];
    const float* __restrict__ bias = a.b[l];
    const bool act = l >= 1 && l <= a.n_layers - 2;
    const bool last = l == a.n_layers - 1;
#pragma unroll 1
    for (int j = threadIdx.x; j < d_out; j += kThreads) {
      float h[kRows], acc[kRows];
      float w = operand<BF16>(__ldg(W + j));
      load_rows<BF16>(in, 0, h);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = h[r] * w;
#pragma unroll 4
      for (int k = 1; k < d_in; ++k) {
        w = operand<BF16>(__ldg(W + static_cast<size_t>(k) * d_out + j));
        load_rows<BF16>(in, k, h);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = acc[r] + h[r] * w;
      }
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = acc[r] + bj;
        if (act) v = tanhf(v);
        if (!last) {
          nxt[j * kRows + r] = v;
        } else if (r < nrows) {
          a.out[static_cast<size_t>(row0 + r) * d_out + j] = v;
        }
      }
    }
    __syncthreads();
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
// it does not take (no layer, more than DMM_MLP_MAX_LAYERS, K < 1, a width
// < 1 or activations over the shared-memory limit).
int dmm_fused_mlp(const DmmMlpArgs* args, void* stream) {
  const DmmMlpArgs a = *args;
  if (a.n_layers < 1 || a.n_layers > DMM_MLP_MAX_LAYERS || a.K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l <= a.n_layers; ++l)
    if (a.dims[l] < 1 || a.dims[l] > a.d_max) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * kRows * static_cast<size_t>(a.d_max);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.bf16 ? launch_mlp<true>(a, smem, s) : launch_mlp<false>(a, smem, s));
}

}  // extern "C"
