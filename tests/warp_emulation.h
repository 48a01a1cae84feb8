// The CUDA features that control_step_warp, foot_positions and adam_step
// (csrc/control_step.cu) use, emulated on the host for
// tests/test_torch_warp_emulation.py: a lane is a
// fiber (ucontext) on the calling thread, and a warp's 32 lanes run in turn,
// each until it reaches the warp's next meeting point (__syncwarp, or one of
// the three inside a shuffle), in ascending or descending lane order; shared
// memory is one host array (warps and blocks run one after another). Only
// what the kernel's part of the source needs is here.
#pragma once
#include <math.h>
#include <stdint.h>
#include <ucontext.h>

#include <algorithm>
#include <cstring>
#include <functional>
#include <vector>

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
// set before each lane resumes
inline dim3 threadIdx, blockIdx, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
// IEEE single operations rounded once (the host's float arithmetic, no FMA)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
using std::max;
using std::min;

// one warp: its lanes' fibers and the shuffles' slots
struct Warp {
  float f[32];
  int i[32];
  ucontext_t scheduler;
  ucontext_t lane[32];
  bool done[32];
};
inline Warp* this_warp = nullptr;

// the running lane's meeting point: back to the warp's scheduler
inline void __syncwarp(unsigned = 0xffffffffu) {
  swapcontext(&this_warp->lane[threadIdx.x & 31], &this_warp->scheduler);
}

template <class T>
inline T shfl(T* slot, T v, int src) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  slot[lane] = v;
  __syncwarp();
  const T r = slot[src & 31];
  __syncwarp();
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

namespace warp_emulation {

inline const std::function<void()>* lane_body = nullptr;

inline void lane_entry() {
  (*lane_body)();
  this_warp->done[threadIdx.x & 31] = true;
}  // returns to uc_link, the warp's scheduler

// Runs `body` as the 32 lanes of warp `warp` of block `block`, in rounds:
// each lane in turn (ascending lane order, or descending) from its last
// meeting point to its next one or to its end. Returns false if the lanes
// diverge: some end while others wait at a meeting point (on the card a
// __syncwarp of the full mask would then hang).
inline bool run_warp(const std::function<void()>& body, unsigned block, unsigned warp,
                     unsigned block_dim, bool descending) {
  static constexpr size_t kStack = 256 << 10;  // a lane's stack
  static std::vector<char> stacks(32 * kStack);
  Warp w;
  lane_body = &body;
  this_warp = &w;
  for (int l = 0; l < 32; ++l) {
    w.done[l] = false;
    getcontext(&w.lane[l]);
    w.lane[l].uc_stack.ss_sp = stacks.data() + l * kStack;
    w.lane[l].uc_stack.ss_size = kStack;
    w.lane[l].uc_link = &w.scheduler;
    makecontext(&w.lane[l], lane_entry, 0);
  }
  blockIdx.x = block;
  blockDim.x = block_dim;
  for (;;) {
    int ended = 0;
    for (int k = 0; k < 32; ++k) {
      const int l = descending ? 31 - k : k;
      threadIdx.x = 32 * warp + l;
      swapcontext(&w.scheduler, &w.lane[l]);
      ended += w.done[l];
    }
    if (ended == 32) return true;
    if (ended != 0) return false;
  }
}

}  // namespace warp_emulation
