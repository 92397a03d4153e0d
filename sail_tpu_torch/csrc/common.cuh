// Shared device helpers for the sail_tpu_torch kernels.
#pragma once

// NVRTC (the chain kernels, csrc/chain_jit.cu) has no host headers and
// needs neither
#ifndef __CUDACC_RTC__
#include <cuda_runtime.h>
#include <stdint.h>
#endif

#define SAIL_FULL_MASK 0xffffffffu

namespace sail {

// Row-loop bounds for a "warp-uniform" grid-stride loop: every lane of a
// warp runs the same number of iterations (lanes past the end still take
// part), so warp collectives with the full mask are legal inside it.
struct WarpLoop {
  long long first;   // first row of this warp's first tile
  long long stride;  // rows advanced per iteration by the whole grid
  int lane;

  __device__ __forceinline__ WarpLoop() {
    long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    lane = threadIdx.x & 31;
    first = (tid >> 5) << 5;
    stride = ((long long)gridDim.x * blockDim.x);
  }
};

// Combine x over the lanes in `peers` (lanes holding the same key). The
// lowest lane of `peers` ends with the combined value; other lanes end with
// partial values. Every lane of the warp must call it (each with its own
// peer set). Tree over peers as in NVIDIA's "Voting and Shuffling to
// Optimize Atomic Operations".
template <typename T, typename Op>
__device__ __forceinline__ T reduce_peers(unsigned peers, T x, int lane,
                                          Op op) {
  int rel_pos = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(SAIL_FULL_MASK, rest != 0)) {
    int next = __ffs(rest);
    T t = __shfl_sync(SAIL_FULL_MASK, x, (next - 1) & 31);
    if (next) x = op(x, t);
    int done = rel_pos & 1;
    rest &= __ballot_sync(SAIL_FULL_MASK, !done);
    rel_pos >>= 1;
  }
  return x;
}

}  // namespace sail
