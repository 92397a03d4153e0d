// K11: MIN, MAX, and float SUM and AVG over ROWS frames with two finite
// offsets.
//
// Replaces sail_tpu/ops/window.py `_range_extreme` (:293), which builds a
// sparse table of ceil(log2 n) + 1 levels of n values (at 59,996,845 rows
// of 8 bytes, 27 x 480 MB = 12.96 GB) and answers each row with two
// gathers from it; and, for float64 sums, `framed_agg`'s (:207)
// difference of two prefixes of one global cumsum, which a NaN or an
// infinity anywhere before the frame turns into NaN.
//
// Everything is in sorted order: the values and their validity were
// gathered once a column (window_perm.cu), and the result goes back to row
// order in one unpermute pass (window_perm.cu). For sorted position i <
// n_live (a device scalar): the frame is [i + lower, i + upper] clipped
// to i's segment [seg_start[i], seg_end[i]]; out[i] = {MIN/MAX/SUM of the
// frame's values (vals[p] where valid[p], else the identity; NaN
// propagates, as torch.minimum), or that sum over the frame's count (AVG);
// ok where the frame holds a counted row}, a window.cuh record. The count
// comes from K10's count scan C as C[hi] - C[lo - 1] (no C: every live
// row counts). Dead rows and invalid results get 0. SUM and AVG take
// float64 values only: an integer frame's sum is exact as a prefix
// difference (K10).
//
// Bound: bytes, n * (value + 1 B validity + 8 B seg bounds + 8 B count
// reads + record), each read and written once, in order.
// Design, by the frame's width W = upper - lower + 1:
//   * W <= kNarrowMax (1025): one launch. A block takes a tile of 1024
//     positions and stages the values of [tile + lower, tile end + upper]
//     (at most 2048) in shared memory; each row combines its clipped
//     frame there in order from lo to hi, W reads of shared memory a row.
//   * wider: two launches and 2n + n/1024 values of scratch. A first
//     pass over 1024-row chunks writes each position's extreme (or sum)
//     from its chunk's (or segment's) start and to its chunk's (or
//     segment's) end, and each chunk's whole; a row then combines the
//     suffix at lo, the prefix at hi and the whole chunks between: O(W /
//     1024) reads, none outside the frame. A frame inside one chunk is
//     clipped on at least one side (W > 1024), so its prefix or its
//     suffix is exactly the frame.

#include "window.cuh"

namespace {

using namespace sail::win;

constexpr long long kNarrowMax = 1025;

// the frame's function (window.py _EXTREME_FNS); AVG combines as SUM
enum Fn { kMax = 0, kMin = 1, kSum = 2, kAvg = 3 };

template <typename T>
__device__ __forceinline__ T fill(int op);
template <>
__device__ __forceinline__ int fill<int>(int op) {
  return op == kMin ? 2147483647 : (-2147483647 - 1);
}
template <>
__device__ __forceinline__ long long fill<long long>(int op) {
  return op == kMin ? 9223372036854775807LL : (-9223372036854775807LL - 1);
}
template <>
__device__ __forceinline__ float fill<float>(int op) {
  return op == kMin ? INFINITY : -INFINITY;
}
template <>
__device__ __forceinline__ double fill<double>(int op) {
  return op == kSum ? 0.0 : (op == kMin ? INFINITY : -INFINITY);
}

struct ExOp {
  int op;  // kMax, kMin or kSum
  template <typename T>
  __device__ __forceinline__ T operator()(T x, T y) const {
    return op == kSum ? x + y : (op == kMin ? vmin(x, y) : vmax(x, y));
  }
};

template <typename T>
struct Args {
  long long n, n_live;
  const T* vals;       // sorted order
  const bool* valid;   // sorted order; null: every row is valid
  const int* seg_start;
  const int* seg_end;
  const long long* counts;
  int op;    // kMax, kMin or kSum
  bool avg;  // the result is the sum over the frame's count
  long long lower, upper;

  // the masked value at sorted position p (the identity past the live
  // rows or where the row is not valid)
  __device__ __forceinline__ T value(long long p) const {
    if (p < 0 || p >= n_live || (valid != nullptr && !valid[p]))
      return fill<T>(op);
    return vals[p];
  }
  __device__ __forceinline__ T ex(T a, T b) const { return ExOp{op}(a, b); }
  // the clipped frame of live row i and its count of counted rows
  __device__ __forceinline__ long long frame(long long i, long long& lo,
                                             long long& hi) const {
    const long long ss = seg_start[i], se = seg_end[i];
    lo = i + lower > ss ? i + lower : ss;
    hi = i + upper < se ? i + upper : se;
    if (hi < lo) return 0;
    return counts == nullptr ? hi - lo + 1
                             : counts[hi] - (lo > ss ? counts[lo - 1] : 0);
  }
  // the result of a frame holding cnt > 0 counted rows whose values
  // combine to r
  __device__ __forceinline__ T finish(T r, long long cnt) const {
    return avg ? (T)((double)r / (double)cnt) : r;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
extreme_narrow_kernel(Args<T> a, const long long* n_live_p,
                      Rec<T>* __restrict__ out) {
  __shared__ T staged[kTile + kNarrowMax - 1];
  a.n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  const long long first = base + a.lower;
  const long long count = kTile + a.upper - a.lower;  // W - 1 + kTile
  for (long long k = threadIdx.x; k < count; k += kThreads)
    staged[k] = a.value(first + k);
  __syncthreads();
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i >= a.n) continue;
    long long lo, hi;
    const long long cnt = i < a.n_live ? a.frame(i, lo, hi) : 0;
    const bool ok = cnt > 0;
    T r = (T)0;
    if (ok) {
      r = staged[lo - first];
      for (long long p = lo + 1; p <= hi; ++p) r = a.ex(r, staged[p - first]);
      r = a.finish(r, cnt);
    }
    out[i] = Rec<T>{r, ok};
  }
}

// per 1024-row chunk: pre[p] = the extreme (or sum) over [max(chunk
// start, segment start), p], suf[p] over [p, min(chunk end, segment
// end)], cx[c] over the chunk (segment-agnostic)
template <typename T>
__global__ void __launch_bounds__(kThreads)
extreme_chunks_kernel(Args<T> a, const long long* n_live_p,
                      T* __restrict__ pre, T* __restrict__ suf,
                      T* __restrict__ cx) {
  a.n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  if (base >= a.n_live) return;  // no row reads a dead chunk
  const T id = fill<T>(a.op);
  const Seg<T> ident{0, id};
  const SegOp<ExOp> op{ExOp{a.op}};
  Seg<T> v[kItems];
  T plain = id;
  for (int j = 0; j < kItems; ++j) {
    const long long p = base + threadIdx.x * kItems + j;
    const T x = a.value(p);
    v[j] = Seg<T>{p < a.n_live && a.seg_start[p] == p, x};
    plain = a.ex(plain, x);
  }
  tile_scan(v, ident, ident, op, (Seg<T>*)nullptr);
  for (int j = 0; j < kItems; ++j) {
    const long long p = base + threadIdx.x * kItems + j;
    if (p < a.n_live) pre[p] = v[j].v;
  }
  for (int j = 0; j < kItems; ++j) {
    const long long p = base + kTile - 1 - (threadIdx.x * kItems + j);
    v[j] = Seg<T>{p < a.n_live && a.seg_end[p] == p, a.value(p)};
  }
  tile_scan(v, ident, ident, op, (Seg<T>*)nullptr);
  for (int j = 0; j < kItems; ++j) {
    const long long p = base + kTile - 1 - (threadIdx.x * kItems + j);
    if (p < a.n_live) suf[p] = v[j].v;
  }
  T total;
  block_exclusive_scan<kThreads>(plain, id, ExOp{a.op}, &total);
  if (threadIdx.x == 0) cx[blockIdx.x] = total;
}

template <typename T>
__global__ void extreme_wide_kernel(Args<T> a, const long long* n_live_p,
                                    const T* __restrict__ pre,
                                    const T* __restrict__ suf,
                                    const T* __restrict__ cx,
                                    Rec<T>* __restrict__ out) {
  a.n_live = *n_live_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    long long lo, hi;
    const long long cnt = i < a.n_live ? a.frame(i, lo, hi) : 0;
    const bool ok = cnt > 0;
    T r = (T)0;
    if (ok) {
      const long long ca = lo / kTile, cb = hi / kTile;
      if (ca == cb) {
        const long long start = ca * kTile > a.seg_start[i]
                                    ? ca * kTile : (long long)a.seg_start[i];
        r = lo == start ? pre[hi] : suf[lo];
      } else {
        r = a.ex(suf[lo], pre[hi]);
        for (long long c = ca + 1; c < cb; ++c) r = a.ex(r, cx[c]);
      }
      r = a.finish(r, cnt);
    }
    out[i] = Rec<T>{r, ok};
  }
}

template <typename T>
cudaError_t extreme(Args<T> a, const long long* n_live, Rec<T>* out,
                    void* scratch, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  if (a.upper - a.lower + 1 <= kNarrowMax) {
    if (a.upper < a.lower) a.upper = a.lower - 1;  // every frame is empty
    extreme_narrow_kernel<T><<<(unsigned)tiles, kThreads, 0, s>>>(
        a, n_live, out);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  T* pre = static_cast<T*>(scratch);
  T* suf = pre + a.n;
  T* cx = suf + a.n;
  extreme_chunks_kernel<T><<<(unsigned)tiles, kThreads, 0, s>>>(
      a, n_live, pre, suf, cx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long want = (a.n + 255) / 256;
  const int grid = (int)(want < 132 * 16 ? want : 132 * 16);
  extreme_wide_kernel<T><<<grid, 256, 0, s>>>(a, n_live, pre, suf, cx, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 1 int32, 2 int64, 3 float32, 4 float64; fn: 0 max, 1 min, 2 sum,
// 3 avg (sum and avg: float64 only). vals, valid: sorted order (valid
// null: every row is valid). counts: K10's count scan of valid, or null.
// out: n records {value, ok} in sorted order. scratch: 2n + ceil(n /
// 1024) values when upper - lower + 1 > 1025, else unused.
extern "C" int sail_window_extreme(const void* n_live, long long n,
                                   const void* vals, const void* valid,
                                   const void* seg_start,
                                   const void* seg_end, const void* counts,
                                   int dtype, int fn, long long lower,
                                   long long upper, void* out,
                                   void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (fn < kMax || fn > kAvg || (fn >= kSum && dtype != kF64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* nl = static_cast<const long long*>(n_live);
  const int op = fn == kAvg ? kSum : fn;
#define SAIL_EXTREME(T)                                                       \
  extreme<T>(Args<T>{n, 0, static_cast<const T*>(vals),                     \
                     static_cast<const bool*>(valid),                        \
                     static_cast<const int*>(seg_start),                     \
                     static_cast<const int*>(seg_end),                       \
                     static_cast<const long long*>(counts), op,              \
                     fn == kAvg, lower, upper},                              \
             nl, static_cast<Rec<T>*>(out), scratch, s)
  switch (dtype) {
    case kI32: return (int)SAIL_EXTREME(int);
    case kI64: return (int)SAIL_EXTREME(long long);
    case kF32: return (int)SAIL_EXTREME(float);
    case kF64: return (int)SAIL_EXTREME(double);
  }
#undef SAIL_EXTREME
  return (int)cudaErrorInvalidValue;
}
