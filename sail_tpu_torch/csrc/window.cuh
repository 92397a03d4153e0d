// Shared pieces of the window kernels (K8-K11): value types, the
// NaN-propagating extremes, the three-phase tile scan, and the sorted-order
// record {value, ok} that K10's frame evaluation and K11 write and
// window_perm.cu's unpermute reads.
//
// A tile scan runs over tiles of kTile = 1024 positions, one block of
// kThreads = 256 threads a tile, each thread holding kItems = 4
// consecutive positions:
//   1. each block reduces its tile to one aggregate;
//   2. one block of kCarryThreads scans the aggregates in place into each
//      tile's carry (the aggregate of all tiles before it, or after it);
//   3. each block scans its tile again, starting from its carry.
// Carries cross any number of tiles: a segment may span all of them.
// Segmented scans use Seg pairs: (a segment starts in the span, the value
// since that start), combined by SegOp.
#pragma once

#include <math.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace sail {
namespace win {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr int kMaxKeys = 16;

// value types of the scan and extreme kernels (window.py _VALUE_TYPES)
enum DType { kNone = 0, kI32 = 1, kI64 = 2, kF32 = 3, kF64 = 4 };

// A result and its validity side by side, at sorted position i of an
// array of records: one 8 B (4-byte values) or 16 B (8-byte values) word
// pair, so the unpermute moves both in one access. ok is a whole word (0 or
// 1) so the record's bytes are all written.
template <typename T>
using WordOf = std::conditional_t<sizeof(T) == 8, unsigned long long,
                                  unsigned int>;
template <typename T>
struct alignas(2 * sizeof(T)) Rec {
  T v;
  WordOf<T> ok;
};

template <typename T>
struct Seg {
  int f;  // a segment starts in the span
  T v;    // the value since the span's last segment start
};

template <typename T>
__device__ __forceinline__ T shfl_up(T x, int d) {
  return __shfl_up_sync(SAIL_FULL_MASK, x, d);
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(Seg<T> x, int d) {
  return {__shfl_up_sync(SAIL_FULL_MASK, x.f, d),
          __shfl_up_sync(SAIL_FULL_MASK, x.v, d)};
}

// Extremes as torch.minimum / torch.maximum: NaN propagates.
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) { return b > a ? b : a; }
__device__ __forceinline__ double vmin(double a, double b) {
  return (isnan(a) || isnan(b)) ? (double)NAN : fmin(a, b);
}
__device__ __forceinline__ double vmax(double a, double b) {
  return (isnan(a) || isnan(b)) ? (double)NAN : fmax(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float vmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

struct Max {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return vmax(a, b); }
};
struct Min {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return vmin(a, b); }
};
struct Add {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// Segmented combine: b's value restarts where a segment starts in b.
template <typename Op>
struct SegOp {
  Op op;
  template <typename T>
  __device__ __forceinline__ Seg<T> operator()(Seg<T> a, Seg<T> b) const {
    return {a.f | b.f, b.f ? b.v : op(a.v, b.v)};
  }
};

// Exclusive scan of one value per thread, in thread order, over a block
// of kBlock threads; *total (if given) gets the block's whole aggregate.
// Every thread of the block must call it.
template <int kBlock, typename T, typename Op>
__device__ T block_exclusive_scan(T x, T identity, Op op, T* total) {
  __shared__ T tot[kBlock / 32 + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = shfl_up(inc, d);
    if (lane >= d) inc = op(y, inc);
  }
  T exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity;
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = identity;
    for (int w = 0; w < kBlock / 32; ++w) {
      T t = tot[w];
      tot[w] = acc;
      acc = op(acc, t);
    }
    tot[kBlock / 32] = acc;
  }
  __syncthreads();
  exc = op(tot[warp], exc);
  if (total != nullptr) *total = tot[kBlock / 32];
  __syncthreads();
  return exc;
}

// Inclusive scan of a tile held kItems to a thread (v[0..kItems) in
// order), starting from `carry`; *total (if given) gets the tile's own
// aggregate, without the carry.
template <typename T, typename Op>
__device__ __forceinline__ void tile_scan(T (&v)[kItems], T carry,
                                          T identity, Op op, T* total) {
#pragma unroll
  for (int j = 1; j < kItems; ++j) v[j] = op(v[j - 1], v[j]);
  T pre = op(carry, block_exclusive_scan<kThreads>(v[kItems - 1], identity,
                                                   op, total));
#pragma unroll
  for (int j = 0; j < kItems; ++j) v[j] = op(pre, v[j]);
}

// Phase 2, one block of kCarryThreads: agg[t] (t < count) becomes the
// aggregate of the tiles before t (after t when `reverse`), in place.
template <typename T, typename Op>
__device__ void scan_carries(T* agg, long long count, T identity, Op op,
                             bool reverse) {
  const long long per = (count + kCarryThreads - 1) / kCarryThreads;
  const long long begin = threadIdx.x * per;
  const long long end = begin + per < count ? begin + per : count;
  T acc = identity;
  for (long long k = begin; k < end; ++k)
    acc = op(acc, agg[reverse ? count - 1 - k : k]);
  T pre = block_exclusive_scan<kCarryThreads>(acc, identity, op,
                                              (T*)nullptr);
  for (long long k = begin; k < end; ++k) {
    long long t = reverse ? count - 1 - k : k;
    T a = agg[t];
    agg[t] = pre;
    pre = op(pre, a);
  }
}

// x[j] = src[p0 + j], 16 B (8 B for 8 bools) at a time where the whole
// run lies below n (src + p0 is then aligned: the callers take p0 a
// multiple of N and hand 16 B-aligned arrays), else one at a time, fill
// past n.
template <int N, typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ src,
                                         long long p0, long long n,
                                         T (&x)[N], T fill) {
  constexpr int kBytes = sizeof(T) * N;
  if (p0 + N <= n) {
    if constexpr (kBytes % 16 == 0) {
      int4 tmp[kBytes / 16];
      const int4* q = reinterpret_cast<const int4*>(src + p0);
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k) tmp[k] = __ldg(q + k);
      memcpy(x, tmp, kBytes);
    } else {
      static_assert(kBytes == 8, "a run is 8 B or a multiple of 16 B");
      const uint2 tmp = __ldg(reinterpret_cast<const uint2*>(src + p0));
      memcpy(x, &tmp, kBytes);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = p0 + j < n ? src[p0 + j] : fill;
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_run(T* __restrict__ dst, long long p0,
                                          long long n, const T (&x)[N]) {
  constexpr int kBytes = sizeof(T) * N;
  static_assert(kBytes % 16 == 0, "a run of outputs is a multiple of 16 B");
  if (p0 + N <= n) {
    int4 tmp[kBytes / 16];
    memcpy(tmp, x, kBytes);
    int4* q = reinterpret_cast<int4*>(dst + p0);
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) q[k] = tmp[k];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (p0 + j < n) dst[p0 + j] = x[j];
  }
}

}  // namespace win
}  // namespace sail
