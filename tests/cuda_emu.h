// Run a CUDA kernel source on the CPU, for the tests: the CUDA features the
// port's kernels use. Every thread of a block is a fiber (a ucontext with its
// own stack) on the calling thread; a fiber runs until it reaches a barrier,
// then the next one runs, so a block's threads take turns in a fixed order
// and a run repeats exactly. The blocks of a launch run one after another,
// so a kernel's static `__shared__` arrays (function statics here) and the
// dynamic shared memory (`emu_smem`) are the running block's. The 32 lanes
// of a warp meet at a barrier at every shuffle, vote and __syncwarp (so a
// shuffle sees every lane's value, as on the card); every thread of the
// block meets at __syncthreads. Built with g++ -ffp-contract=off, like nvcc
// -fmad=false: each float operation rounds on its own. tests/cuda_emu.py
// rewrites a source's launches into emu_run and builds it against this
// header.
//
// Nothing waits on a clock: a barrier ends when its last thread arrives. If
// no thread of the block can run (every live thread waits at a barrier that
// cannot fill: a lane returned early, or lanes wait at two different
// barriers), the process aborts at once, naming the barrier.
#pragma once
#include <algorithm>
#include <array>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <unordered_map>
#include <vector>

#include <ucontext.h>

using std::isfinite;
using std::isnan;
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim, gridDim;

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum cudaSharedCarveout {
  cudaSharedmemCarveoutDefault = -1,
  cudaSharedmemCarveoutMaxL1 = 0,
  cudaSharedmemCarveoutMaxShared = 100
};

constexpr size_t kEmuSmemBytes = 232448;  // what one block may opt into on sm_90
alignas(16) inline float emu_smem[kEmuSmemBytes / sizeof(float)];
inline cudaError_t emu_last_error = cudaSuccess;

// The running block: its threads as fibers, its barriers (one per warp,
// then the block's), the shuffle slots of each warp and the votes of
// __syncthreads_and.
struct EmuBlock {
  static constexpr size_t kStackBytes = 1 << 20;  // a thread's stack (touched pages only)
  struct Fiber {
    ucontext_t ctx;
    std::unique_ptr<char[]> stack;
    int bar = -1;  // the barrier it waits at, or -1
    bool done = false;
  };
  const int n;  // threads
  std::function<void()> body;
  std::vector<Fiber> fibers;
  ucontext_t sched;
  int current = 0;
  std::vector<int> waiting;  // per barrier: threads there now
  std::vector<std::array<uint32_t, 32>> slots;  // per warp
  std::vector<int> votes;  // per thread

  EmuBlock(int threads, std::function<void()> f)
      : n(threads), body(std::move(f)), fibers(threads), waiting(threads / 32 + 1),
        slots(threads / 32), votes(threads) {}

  [[noreturn]] void deadlock() {
    int bar = 0, exited = 0;
    for (const Fiber& f : fibers) exited += f.done;
    while (waiting[bar] == 0) ++bar;
    std::fprintf(stderr,
                 "cuda_emu: block (%u, %u): every live thread waits at a barrier that cannot "
                 "fill (barrier %d of %d: %s), %d of %d threads returned\n",
                 blockIdx.x, blockIdx.y, bar, static_cast<int>(waiting.size()),
                 bar + 1 == static_cast<int>(waiting.size()) ? "__syncthreads" : "a warp's",
                 exited, n);
    std::abort();
  }
  // barrier `bar` ends when `expected` threads have arrived: the last one
  // frees the others and goes on
  void arrive(int bar, int expected) {
    if (++waiting[bar] == expected) {
      waiting[bar] = 0;
      for (Fiber& f : fibers)
        if (f.bar == bar) f.bar = -1;
      return;
    }
    Fiber& me = fibers[current];
    me.bar = bar;
    swapcontext(&me.ctx, &sched);
  }
  static void entry();
  // every thread to its end, in turns
  void run() {
    for (int t = 0; t < n; ++t) {
      Fiber& f = fibers[t];
      f.stack.reset(new char[kStackBytes]);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStackBytes;
      f.ctx.uc_link = &sched;
      makecontext(&f.ctx, &EmuBlock::entry, 0);
    }
    for (int left = n; left > 0;) {
      bool ran = false;
      for (int t = 0; t < n; ++t) {
        Fiber& f = fibers[t];
        if (f.done || f.bar >= 0) continue;
        current = t;
        threadIdx = dim3(t, 0, 0);
        swapcontext(&sched, &f.ctx);
        ran = true;
        left -= f.done;
      }
      if (!ran) deadlock();
    }
  }
};
inline EmuBlock* emu_block = nullptr;
inline void EmuBlock::entry() {
  emu_block->body();
  emu_block->fibers[emu_block->current].done = true;
}

inline unsigned emu_tid() { return threadIdx.x; }
inline unsigned emu_lane() { return threadIdx.x & 31; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->arrive(emu_tid() / 32, 32); }
inline void __syncthreads() {
  emu_block->arrive(static_cast<int>(emu_block->waiting.size()) - 1, emu_block->n);
}
inline int __syncthreads_and(int pred) {
  EmuBlock& b = *emu_block;
  b.votes[emu_tid()] = pred != 0;
  __syncthreads();
  int all = 1;
  for (int v : b.votes) all &= v;
  __syncthreads();  // every thread has read the votes before the next vote
  return all;
}

// the 32-bit word `v` of every lane of the warp; the word of lane `src`
inline uint32_t emu_exchange(uint32_t v, int src) {
  auto& slots = emu_block->slots[emu_tid() / 32];
  slots[emu_lane()] = v;
  __syncwarp();
  const uint32_t r = slots[src & 31];
  __syncwarp();  // every lane has read before the slots are written again
  return r;
}
template <class T>
inline T emu_shfl(T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  bits = emu_exchange(bits, src);
  std::memcpy(&v, &bits, 4);
  return v;
}
// width: lanes [lane & ~(width-1), ... + width) form a segment, as on the card
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int base = static_cast<int>(emu_lane()) & ~(width - 1);
  return emu_shfl(v, base + (src & (width - 1)));
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask, int width = 32) {
  const int lane = static_cast<int>(emu_lane());
  int src = lane ^ lane_mask;
  if ((src & ~(width - 1)) != (lane & ~(width - 1))) src = lane;
  return emu_shfl(v, src);
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  auto& slots = emu_block->slots[emu_tid() / 32];
  slots[emu_lane()] = pred != 0;
  __syncwarp();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= slots[l] << l;
  __syncwarp();
  return bits & mask;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributePreferredSharedMemoryCarveout)  // a percentage, or -1
    return value >= -1 && value <= 100 ? cudaSuccess : cudaErrorInvalidValue;
  return value <= static_cast<int>(kEmuSmemBytes) ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline long long clock64() {  // a count, not a time: it only moves forward
  static long long ticks = 0;
  return ++ticks;
}
// the fibers of a launch run one at a time on one thread: a plain update
inline int atomicMax(int* p, int v) {
  const int old = *p;
  *p = std::max(old, v);
  return old;
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// The float transcendentals of the plain versions: a test points emu_math
// at PyTorch's (op 0 sin, 1 cos, 2 tan, 3 atan, 4 atan2(x, y), 5 exp, 6 log,
// 7 tanh, 8 pow(x, y), 9 sigmoid; y is 0 for a function of one argument) so that a
// kernel's source rounds like its plain version on the CPU; null, the C
// library's. Its results are kept by argument, since the lanes of a group
// ask for the same ones.
// (emitted even where the kernel calls none of them, as a linear step's)
extern "C" {
[[gnu::used]] inline float (*emu_math)(int, float, float) = nullptr;
}
inline float emu_math_of(int op, float x, float y = 0.0f) {
  static std::unordered_map<uint64_t, float> known[10];
  uint32_t bx, by;
  std::memcpy(&bx, &x, 4);
  std::memcpy(&by, &y, 4);
  const uint64_t key = (static_cast<uint64_t>(bx) << 32) | by;
  const auto it = known[op].find(key);
  return it != known[op].end() ? it->second
                               : known[op].emplace(key, emu_math(op, x, y)).first->second;
}
inline void emu_sincosf(float x, float* s, float* c) {
  if (emu_math) {
    *s = emu_math_of(0, x);
    *c = emu_math_of(1, x);
  } else {
    ::sincosf(x, s, c);
  }
}
inline float emu_tanf(float x) { return emu_math ? emu_math_of(2, x) : ::tanf(x); }
#define sincosf emu_sincosf
#define tanf emu_tanf

// The math a generated tile step calls by name (csrc/generic_rollout.cuh
// defines these on the card unless DMM_USER_MATH is set), routed the same way.
#define DMM_USER_MATH
inline float dmm_user_atan(float x) { return emu_math ? emu_math_of(3, x) : ::atanf(x); }
inline float dmm_user_atan2(float y, float x) {
  return emu_math ? emu_math_of(4, y, x) : ::atan2f(y, x);
}
inline float dmm_user_exp(float x) { return emu_math ? emu_math_of(5, x) : ::expf(x); }
inline float dmm_user_log(float x) { return emu_math ? emu_math_of(6, x) : ::logf(x); }
inline float dmm_user_tanh(float x) { return emu_math ? emu_math_of(7, x) : ::tanhf(x); }
inline float dmm_user_pow(float x, float e) {
  return emu_math ? emu_math_of(8, x, e) : ::powf(x, e);
}
inline float dmm_user_sigmoid(float x) {
  return emu_math ? emu_math_of(9, x) : 1.0f / (1.0f + ::expf(-x));
}

inline dim3 emu_dim(dim3 d) { return d; }
inline dim3 emu_dim(int x) { return dim3(static_cast<unsigned>(x)); }

// kernel<<<grid, block, bytes, stream>>>(args) as emu_run([&] { kernel(args); },
// grid, block, bytes, stream): the blocks in order, each block's threads in
// turns. A launch the card would refuse (more than 1 024 threads, a block not
// of whole warps, too much shared memory) does not run and leaves its error
// for cudaGetLastError.
template <class F, class G, class B>
inline void emu_run(F body, G grid, B block, size_t bytes = 0, cudaStream_t = nullptr) {
  const dim3 gd = emu_dim(grid), bd = emu_dim(block);
  const int n = static_cast<int>(bd.x);
  if (bytes > kEmuSmemBytes || bd.y != 1 || bd.z != 1 || n <= 0 || n > 1024 || n % 32) {
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = bd;
  gridDim = gd;
  for (unsigned gy = 0; gy < gd.y; ++gy) {
    for (unsigned gx = 0; gx < gd.x; ++gx) {
      blockIdx = dim3(gx, gy, 0);
      EmuBlock blk(n, body);
      emu_block = &blk;
      blk.run();
      emu_block = nullptr;
    }
  }
}
