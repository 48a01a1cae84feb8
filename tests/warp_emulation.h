// The CUDA features that control_step_warp (csrc/control_step.cu) uses,
// emulated on the host for tests/test_torch_warp_emulation.py: a lane is a
// std::thread, a warp's __syncwarp and shuffles meet at a barrier of its 32
// lanes, shared memory is one host array (blocks run one after another).
// Only what the kernel's part of the source needs is here.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
using std::max;
using std::min;

// one warp's meeting point
struct Warp {
  std::barrier<> bar{32};
  float f[32];
  int i[32];
};
inline thread_local Warp* this_warp = nullptr;

inline void __syncwarp(unsigned = 0xffffffffu) { this_warp->bar.arrive_and_wait(); }

template <class T>
inline T shfl(T* slot, T v, int src) {
  const int lane = threadIdx.x & 31;
  this_warp->bar.arrive_and_wait();
  slot[lane] = v;
  this_warp->bar.arrive_and_wait();
  const T r = slot[src & 31];
  this_warp->bar.arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) { return shfl(this_warp->f, v, src); }
inline int __shfl_sync(unsigned, int v, int src) { return shfl(this_warp->i, v, src); }
inline float __shfl_xor_sync(unsigned m, float v, int off) {
  return __shfl_sync(m, v, (int)(threadIdx.x & 31) ^ off);
}
inline int __shfl_xor_sync(unsigned m, int v, int off) {
  return __shfl_sync(m, v, (int)(threadIdx.x & 31) ^ off);
}
