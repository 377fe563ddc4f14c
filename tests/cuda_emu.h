// Run a CUDA kernel source on the CPU, for the tests: the few CUDA features
// csrc/riccati_qp.cu uses, with one warp at a time as 32 std::threads that
// meet at a barrier at every __shfl_sync and __syncwarp (so a shuffle sees
// every lane's value, as on the card). Blocks and the warps of a block run
// one after another; shared memory is one static array. Built with g++
// -ffp-contract=off, like nvcc -fmad=false: each float operation rounds on
// its own. tests/test_torch_qp_kernel_emu.py compiles the kernel against it.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

// the 32 lanes of the running warp meet here; a lane left waiting 20 s (a
// barrier that not every lane reaches) aborts the process instead of hanging
struct EmuWarp {
  std::mutex m;
  std::condition_variable cv;
  int waiting = 0;
  long generation = 0;
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(m);
    const long g = generation;
    if (++waiting == 32) {
      waiting = 0;
      ++generation;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(lock, std::chrono::seconds(20), [&] { return generation != g; })) {
      std::fprintf(stderr, "cuda_emu: a warp barrier was not reached by every lane\n");
      std::abort();
    }
  }
};

constexpr size_t kEmuSmemBytes = 232448;  // what one block may opt into on sm_90
inline float smem[kEmuSmemBytes / sizeof(float)];
inline EmuWarp* emu_warp = nullptr;
inline float emu_lanes[32];

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= static_cast<int>(kEmuSmemBytes) ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline long long clock64() {  // a count, not a time: it only moves forward
  static std::atomic<long long> ticks{0};
  return ++ticks;
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline void __syncwarp() { emu_warp->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  emu_lanes[threadIdx.x & 31] = v;
  emu_warp->arrive_and_wait();
  const float r = emu_lanes[src & 31];
  emu_warp->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned mask, float v, int o) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ o);
}

// kernel<<<grid, block, bytes>>>(a), one warp at a time
template <class K, class A>
inline void emu_launch(K kernel, int grid, int block, size_t bytes, const A& a) {
  if (bytes > kEmuSmemBytes) return;
  for (int g = 0; g < grid; ++g) {
    for (int w = 0; w < block / 32; ++w) {
      EmuWarp warp;
      emu_warp = &warp;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, l] {
          threadIdx.x = w * 32 + l;
          blockIdx.x = g;
          kernel(a);
        });
      for (auto& t : lanes) t.join();
    }
  }
}
