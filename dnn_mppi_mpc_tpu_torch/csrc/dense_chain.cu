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
// operands and so is exact in float32, sums and biases are float32: the TPU
// kernel's rounding points (dense_chain.py:201-220).
//
// What bounds it on the card. Operations: 2·B·Σ c_in·c_out bf16 products,
// 27.4 GFLOP for ResNet-50 at B = 1 024 (27.7 µs at the 989 TFLOP/s of the
// bf16 tensor cores) and 2.86 GFLOP (2.9 µs) for ResNet-18; the bf16 weights
// (26.8 and 2.8 MB) are 8.0 and 0.85 µs at 3.35 TB/s. This first kernel does
// not reach the tensor cores: it runs the products on the float32 SIMT units
// (a fused multiply-add per product: exact, since the product is), so its own
// ceiling is the 67 TFLOP/s float32 rate, and the weights stream from L2 once
// per 8-row block. Design: rows are independent, so a block owns kRows = 8
// rows (128 blocks at B = 1 024) and walks the whole chain for them, every
// activation on chip in dynamic shared memory as [channel][row] float32: h and
// r at the widest channel count (2 048 for ResNet-50) and two buffers for the
// bottleneck's inner widths, 160 KiB for ResNet-50 (opted in past 48 KiB).
// Each thread owns a pair of adjacent output channels and all 8 rows: per
// input channel it reads one bfloat16 pair of weights (coalesced across the
// warp) and the 8 rows' activations (two broadcast float4 loads) and does 16
// multiply-adds. A tensor-core version (wgmma on bf16 tiles, TMA weight
// streaming, more rows a block) is later work.
//
// Each output is summed from zero in input-channel order, then the bias
// added, so the kernel equals its plain PyTorch version
// (ops/cuda/dense_chain.py resnet_chain_plain) but for tanhf against
// torch.tanh in the head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#define DMM_CHAIN_MAX_LAYERS 64
#define DMM_CHAIN_MAX_BLOCKS 16

extern "C" {

// One launch's arguments (mirrored by DmmChainArgs in _build.py). Layer l's
// weights are (c_in[l], ld[l]) bfloat16 row-major, its bias (ld[l],) float32;
// ld is the output channel count rounded up to even (the head's 3 become 4,
// the padding column zero). Layer order: the stem, then per block its
// downsample (if down[j]) and its n_convs convs, then the head.
struct DmmChainArgs {
  const float* x;  // (B, c_in[0])
  float* out;      // (B, out_dim)
  const void* W[DMM_CHAIN_MAX_LAYERS];
  const float* b[DMM_CHAIN_MAX_LAYERS];
  int c_in[DMM_CHAIN_MAX_LAYERS];
  int ld[DMM_CHAIN_MAX_LAYERS];
  int down[DMM_CHAIN_MAX_BLOCKS];
  int B;
  int n_layers;
  int n_blocks;
  int n_convs;
  int out_dim;
  int c_max;  // extent of h and r: the widest block input/output
  int y_max;  // extent of the inner buffers: the input and the inner convs' widths
};

}  // extern "C"

namespace {

constexpr int kRows = 8;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block on sm_90

enum Epilogue { kReluBf16, kF32, kResidual, kHead };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One layer for the block's rows: in [c_in][kRows] → columns of ld.
//   kReluBf16: dst = bf16(relu(acc + b))
//   kF32:      dst = acc + b
//   kResidual: dst = bf16(relu((acc + b) + res))   (dst may be res: same element, same thread)
//   kHead:     out[row][j] = tanhf(acc + b) for j < out_dim, rows < nrows
template <Epilogue E>
__device__ void chain_layer(const DmmChainArgs& a, int l, const float* in, float* dst,
                            const float* res, int row0, int nrows) {
  const int c_in = a.c_in[l], ld = a.ld[l];
  const __nv_bfloat162* __restrict__ W = static_cast<const __nv_bfloat162*>(a.W[l]);
  const float* __restrict__ bias = a.b[l];
  const int ld2 = ld / 2;
#pragma unroll 1
  for (int jp = threadIdx.x; jp < ld2; jp += kThreads) {
    float acc0[kRows], acc1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc0[r] = acc1[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < c_in; ++k) {
      const float2 w = __bfloat1622float2(W[static_cast<size_t>(k) * ld2 + jp]);
      const float4 h0 = reinterpret_cast<const float4*>(in + k * kRows)[0];
      const float4 h1 = reinterpret_cast<const float4*>(in + k * kRows)[1];
      const float h[kRows] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc0[r] = __fmaf_rn(h[r], w.x, acc0[r]);
        acc1[r] = __fmaf_rn(h[r], w.y, acc1[r]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 2 * jp + c;
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = (c ? acc1[r] : acc0[r]) + bj;
        if constexpr (E == kReluBf16) {
          dst[j * kRows + r] = round_bf16(fmaxf(v, 0.0f));
        } else if constexpr (E == kF32) {
          dst[j * kRows + r] = v;
        } else if constexpr (E == kResidual) {
          dst[j * kRows + r] = round_bf16(fmaxf(v + res[j * kRows + r], 0.0f));
        } else {
          if (j < a.out_dim && r < nrows)
            a.out[static_cast<size_t>(row0 + r) * a.out_dim + j] = tanhf(v);
        }
      }
    }
  }
  __syncthreads();
}

// __grid_constant__: the device functions take the arguments by reference
// without a per-thread copy
__global__ void __launch_bounds__(kThreads)
    resnet_chain_kernel(const __grid_constant__ DmmChainArgs a) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);  // [c_max][kRows] block input/output
  float* r = h + kRows * a.c_max;              // [c_max][kRows] downsample output
  float* y0 = r + kRows * a.c_max;             // [y_max][kRows]
  float* y1 = y0 + kRows * a.y_max;            // [y_max][kRows]
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.B - row0);

  // the block's rows of x, rounded to bf16, as [feature][row]; rows past B are 0
  const int f0 = a.c_in[0];
  for (int i = threadIdx.x; i < kRows * f0; i += kThreads) {
    const int rr = i / f0, k = i - rr * f0;
    y0[k * kRows + rr] =
        rr < nrows ? round_bf16(a.x[static_cast<size_t>(row0 + rr) * f0 + k]) : 0.0f;
  }
  __syncthreads();

  chain_layer<kReluBf16>(a, 0, y0, h, nullptr, row0, nrows);
  int l = 1;
#pragma unroll 1
  for (int blk = 0; blk < a.n_blocks; ++blk) {
    const float* res = h;
    if (a.down[blk]) {
      chain_layer<kF32>(a, l++, h, r, nullptr, row0, nrows);
      res = r;
    }
    const float* in = h;
#pragma unroll 1
    for (int c = 0; c < a.n_convs - 1; ++c) {
      float* dst = (c & 1) ? y1 : y0;
      chain_layer<kReluBf16>(a, l++, in, dst, nullptr, row0, nrows);
      in = dst;
    }
    chain_layer<kResidual>(a, l++, in, h, res, row0, nrows);
  }
  chain_layer<kHead>(a, l, h, nullptr, nullptr, row0, nrows);
}

}  // namespace

extern "C" {

// sizeof(DmmChainArgs), checked against the ctypes mirror at load time.
int dmm_chain_args_size() { return static_cast<int>(sizeof(DmmChainArgs)); }

// out = the folded net of x. Returns cudaErrorInvalidValue without launching
// on a program it does not take (layer count not 2 + blocks·convs + downs, an
// odd ld, an inner conv count below 2, or activations over the shared-memory
// limit).
int dmm_resnet_chain(const DmmChainArgs* args, void* stream) {
  const DmmChainArgs a = *args;
  if (a.B < 1 || a.n_blocks < 0 || a.n_blocks > DMM_CHAIN_MAX_BLOCKS || a.n_convs < 2 ||
      a.n_layers < 2 || a.n_layers > DMM_CHAIN_MAX_LAYERS || a.out_dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 2 + a.n_blocks * a.n_convs;
  for (int j = 0; j < a.n_blocks; ++j) n += a.down[j] ? 1 : 0;
  if (n != a.n_layers || a.c_in[0] > a.y_max || a.out_dim > a.ld[n - 1])
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n; ++l)
    if (a.ld[l] < 2 || (a.ld[l] & 1) || a.c_in[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kRows * (2 * static_cast<size_t>(a.c_max) + 2 * a.y_max);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resnet_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  resnet_chain_kernel<<<(a.B + kRows - 1) / kRows, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
