// K5: match ranges of probe keys in the sorted build keys.
//
// Replaces sail_tpu/ops/join.py `probe_ranges` (its two searchsorted
// calls). For each probe row: lo = lower bound and hi = upper bound of its
// key in sorted_keys[0:nb], hi clipped at num_valid (positions past it
// hold the sentinel, int64 max); lo and cnt = usable ? max(hi - lo, 0) : 0
// are written as int32. The keys are K4's (reference key XOR 1 << 63), so
// a signed comparison is the reference's unsigned one. The hashed path's
// check of the first candidate against the true key columns runs after
// this kernel as torch ops (ops/join.py probe_ranges).
//
// Bound: bytes of the probe keys and usable flags read, 8 bytes per probe
// written, plus the build keys read once. In practice the two binary
// searches are latency-bound: ~2 log2(nb) dependent loads per probe, and a
// build larger than L2 (50 MB) makes most of them trips to HBM.

#include "common.cuh"

namespace {

__device__ __forceinline__ long long lower_bound(const long long* a,
                                                 long long n, long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long upper_bound(const long long* a,
                                                 long long lo, long long n,
                                                 long long x) {
  long long hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void probe_kernel(const long long* __restrict__ sorted_keys,
                             long long nb,
                             const long long* __restrict__ num_valid,
                             const long long* __restrict__ keys,
                             const unsigned char* __restrict__ usable,
                             long long n, int* __restrict__ lo_out,
                             int* __restrict__ cnt_out) {
  long long nv = *num_valid;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long x = keys[i];
    long long lo = lower_bound(sorted_keys, nb, x);
    long long hi = upper_bound(sorted_keys, lo, nb, x);
    if (hi > nv) hi = nv;
    lo_out[i] = (int)lo;
    cnt_out[i] = (usable[i] && hi > lo) ? (int)(hi - lo) : 0;
  }
}

}  // namespace

extern "C" int sail_join_probe(const void* sorted_keys, long long nb,
                               const void* num_valid, const void* keys,
                               const void* usable, long long n, void* lo,
                               void* cnt, int grid, void* stream) {
  probe_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sorted_keys), nb,
      static_cast<const long long*>(num_valid),
      static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(usable), n, static_cast<int*>(lo),
      static_cast<int*>(cnt));
  return (int)cudaGetLastError();
}
