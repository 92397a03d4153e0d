// K10: segmented scans of a window's sorted rows, and the frame evaluation.
//
// Replaces, in sail_tpu/ops/window.py `framed_agg` (:207), the global
// float64/int64 `cumsum` of the values and of the valid flags whose
// differences give each frame's sum and count, `_segment_count` (:321),
// and `_segmented_scan` (:328), a Hillis–Steele running MIN/MAX of
// log2(n) full passes. Both entry points read and write in sorted order
// only: the values and their validity were gathered into sorted order
// once a column (window_perm.cu), and each output goes back to row order
// in one unpermute pass (window_perm.cu). Two entry points:
//
// sail_window_scan: a segmented inclusive scan in sorted order. Position
//   i < n_live (a device scalar) holds vals[i] where valid[i] (no
//   validity: always), else the identity; a segment restarts where
//   seg_start[i] == i (forward: out[i] = op over [seg_start[i], i]) or
//   seg_end[i] == i (backward: over [i, seg_end[i]]). ops: sum (int64
//   over int32/int64, exact in two's complement; float64 over
//   float32/float64), count (int64, no values), min and max (the value
//   type; NaN propagates, as torch.minimum). Dead rows (i >= n_live) hold
//   the identity.
// Bound: bytes, n * (value + 1 B validity + 4 B bound + output width),
//   each read and written once, in order.
// Design: one launch, a single-pass scan with decoupled look-back
//   (Merrill and Garland, 2016). A block takes the next tile of 2048
//   positions in scan order from a counter (backward: from the end), 8
//   consecutive positions a thread, read 16 B at a time; it scans its
//   tile, publishes the tile's aggregate and then its inclusive prefix,
//   and takes its carry from the tiles before it: one warp reads 32 of
//   their statuses at a time and stops at the nearest prefix. A tile that
//   holds a segment start publishes its prefix at once, so a tile waits
//   only back to its segment's start. Scratch: 3 words a tile.
//
// sail_window_frame: each row's frame [lo, hi] from the ROWS offsets
//   (clipped to the segment), the segment's bounds, or peer_end (the
//   default RANGE frame), evaluated from the scans and written at the
//   row's sorted position as a window.cuh record {value, ok} (count: a
//   plain int64):
//     count: C[hi] - C[lo - 1] (C: the count scan; none: hi - lo + 1),
//     sum, avg: P[hi] - (lo > seg_start ? P[lo - 1] : 0) from a forward
//       scan, S[lo] - (hi < seg_end ? S[hi + 1] : 0) from a backward one,
//       over count. The difference is exact for integer sums; a float
//       frame must not take it when the scan would reach outside the
//       frame (a NaN or infinity there would make it NaN), so framed_agg
//       gives a float frame with a finite lower offset the backward scan
//       (upper unbounded, nothing is subtracted) or K11 (both finite),
//     min, max: the running extreme at hi (forward scan, the frame starts
//       at the segment start) or at lo (backward scan, it ends at the
//       segment end),
//   ok where the frame holds a counted row. Dead rows and invalid results
//   get 0.
// Bound: bytes, n * (8-12 B bounds + 2 scan reads + 2 count reads +
//   record), all in sorted order; the reads at lo - 1 and hi are mostly
//   cached neighbours.

#include <limits.h>

#include <cfloat>

#include "window.cuh"

namespace {

using namespace sail::win;

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr long long kScanTile = kScanThreads * kScanItems;

enum Op { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };
enum Fn { kFnSum = 0, kFnCount = 1, kFnAvg = 2, kFnExtreme = 3 };

template <typename T>
__device__ __forceinline__ T lowest() {
  return sizeof(T) == 4 ? (T)INT_MIN : (T)LLONG_MIN;
}
template <typename T>
__device__ __forceinline__ T highest() {
  return sizeof(T) == 4 ? (T)INT_MAX : (T)LLONG_MAX;
}
template <>
__device__ __forceinline__ float lowest<float>() { return -INFINITY; }
template <>
__device__ __forceinline__ float highest<float>() { return INFINITY; }
template <>
__device__ __forceinline__ double lowest<double>() { return -INFINITY; }
template <>
__device__ __forceinline__ double highest<double>() { return INFINITY; }

// Acc: the scan's type; In: the values' type (unused for count).
template <int OP, typename Acc>
struct ScanOp {
  __device__ static Acc identity() {
    return OP == kMin ? highest<Acc>() : (OP == kMax ? lowest<Acc>() : (Acc)0);
  }
  __device__ Acc operator()(Acc a, Acc b) const {
    return OP == kMin ? vmin(a, b) : (OP == kMax ? vmax(a, b) : a + b);
  }
};

template <int OP, typename In, typename Acc>
struct ScanArgs {
  long long n;
  const In* vals;     // sorted order; null for count
  const bool* valid;  // sorted order; null: every live row counts
  const int* bound;   // seg_start (forward) or seg_end (backward)
};

// A tile's status, in scan order: 0 until its block publishes its own
// aggregate (kAgg) or its inclusive prefix (kPre). A tile that holds a
// segment start publishes its prefix at once: nothing before it reaches
// the tiles after it.
enum Status : unsigned long long { kAgg = 1, kPre = 2 };

template <typename Acc>
struct Lookback {
  unsigned long long* status;
  unsigned long long* counter;  // the next tile, in scan order, to take
  Acc* agg;
  Acc* pre;
};

template <typename Acc>
__device__ __forceinline__ void publish(const Lookback<Acc>& lb, long long d,
                                        unsigned long long status, Acc v) {
  (status == kPre ? lb.pre : lb.agg)[d] = v;
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(lb.status + d) = status;
}

// Warp 0 of tile d (in scan order), whose own aggregate is `total`: the
// value the tiles before it carry into it (its exclusive prefix from the
// nearest segment start). Reads the statuses of 32 tiles at a time,
// nearest first, and stops at the first that holds a prefix; the
// aggregates in between combine in scan order.
template <int OP, typename Acc>
__device__ Acc look_back(const Lookback<Acc>& lb, long long d,
                         Seg<Acc> total) {
  const ScanOp<OP, Acc> op{};
  const Acc id = ScanOp<OP, Acc>::identity();
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    publish(lb, d, d == 0 || total.f ? kPre : kAgg, total.v);
  if (d == 0) return id;
  Acc run = id;
  for (long long k = d - 1;; k -= 32) {
    const long long q = k - lane;
    unsigned long long s = kPre;  // before the first tile: nothing
    Acc x = id;
    if (q >= 0) {
      do {
        s = *reinterpret_cast<volatile unsigned long long*>(lb.status + q);
      } while (s == 0);
      __threadfence();
      x = *reinterpret_cast<volatile Acc*>((s == kPre ? lb.pre : lb.agg) + q);
    }
    const unsigned stop = __ballot_sync(SAIL_FULL_MASK, s == kPre);
    const int last = stop ? __ffs(stop) - 1 : 31;
    if (lane > last) x = id;
    // lane 0 gets x[last] + ... + x[0]: the farther tile on the left
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Acc y = __shfl_down_sync(SAIL_FULL_MASK, x, o);
      if (lane + o < 32) x = op(y, x);
    }
    run = op(x, run);
    if (stop) break;
  }
  if (lane == 0 && !total.f) publish(lb, d, kPre, op(run, total.v));
  return run;
}

// One block a tile of kScanTile positions, taken in scan order from
// lb.counter; thread c holds positions [c * kScanItems, + kScanItems) of
// its tile (backward: the tile and the threads run from the end).
template <int OP, typename In, typename Acc, bool kBack>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(ScanArgs<OP, In, Acc> a, const long long* n_live_p,
            Lookback<Acc> lb, long long tiles, Acc* __restrict__ out) {
  __shared__ long long tile_sh;
  __shared__ Acc carry_sh;
  const SegOp<ScanOp<OP, Acc>> op{};
  const Acc id = ScanOp<OP, Acc>::identity();
  if (threadIdx.x == 0)
    tile_sh = (long long)atomicAdd(lb.counter, 1ULL);
  __syncthreads();
  const long long d = tile_sh;
  const long long t = kBack ? tiles - 1 - d : d;
  const long long n_live = *n_live_p;
  const int c = kBack ? kScanThreads - 1 - threadIdx.x : threadIdx.x;
  const long long p0 = t * kScanTile + (long long)c * kScanItems;
  if (t * kScanTile >= n_live) {  // a dead tile: the identity throughout,
    if (threadIdx.x == 0) publish(lb, d, kPre, id);  // and carries nothing
    Acc o[kScanItems];
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) o[j] = id;
    store_run(out, p0, a.n, o);
    return;
  }

  Seg<Acc> v[kScanItems];  // in position order
  {
    int b[kScanItems];
    bool ok[kScanItems];
    In x[kScanItems];
    load_run(a.bound, p0, a.n, b, -1);
    if (a.valid != nullptr) {
      load_run(a.valid, p0, a.n, ok, false);
    } else {
#pragma unroll
      for (int j = 0; j < kScanItems; ++j) ok[j] = true;
    }
    if constexpr (OP != kCount) load_run(a.vals, p0, a.n, x, In(0));
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const long long p = p0 + j;
      const bool live = p < n_live;
      Acc val = id;
      if (live && ok[j]) {
        if constexpr (OP == kCount) val = (Acc)1;
        else val = (Acc)x[j];
      }
      v[j] = Seg<Acc>{live && b[j] == p, val};
    }
  }
  // the thread's positions in scan order
  if (kBack) {
#pragma unroll
    for (int j = kScanItems - 2; j >= 0; --j) v[j] = op(v[j + 1], v[j]);
  } else {
#pragma unroll
    for (int j = 1; j < kScanItems; ++j) v[j] = op(v[j - 1], v[j]);
  }
  Seg<Acc> total;
  const Seg<Acc> before = block_exclusive_scan<kScanThreads>(
      v[kBack ? 0 : kScanItems - 1], Seg<Acc>{0, id}, op, &total);
  if (threadIdx.x < 32) {
    const Acc carry = look_back<OP>(lb, d, total);
    if (threadIdx.x == 0) carry_sh = carry;
  }
  __syncthreads();
  const Seg<Acc> pre = op(Seg<Acc>{0, carry_sh}, before);
  Acc o[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j)
    o[j] = p0 + j < n_live ? op(pre, v[j]).v : id;  // dead rows: identity
  store_run(out, p0, a.n, o);
}

template <int OP, typename In, typename Acc>
cudaError_t scan(const long long* n_live, long long n, const void* vals,
                 const bool* valid, const int* bound, bool backward,
                 void* out, void* scratch, cudaStream_t s) {
  ScanArgs<OP, In, Acc> a{n, static_cast<const In*>(vals), valid, bound};
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  Lookback<Acc> lb{words, words + tiles,
                   reinterpret_cast<Acc*>(words + tiles + 1), nullptr};
  lb.pre = lb.agg + tiles;
  cudaError_t err = cudaMemsetAsync(words, 0, (tiles + 1) * 8, s);
  if (err != cudaSuccess) return err;
  Acc* o = static_cast<Acc*>(out);
  if (backward)
    scan_kernel<OP, In, Acc, true><<<(unsigned)tiles, kScanThreads, 0, s>>>(
        a, n_live, lb, tiles, o);
  else
    scan_kernel<OP, In, Acc, false><<<(unsigned)tiles, kScanThreads, 0, s>>>(
        a, n_live, lb, tiles, o);
  return cudaGetLastError();
}

template <int OP>
cudaError_t scan_typed(int dtype, const long long* nl, long long n,
                       const void* v, const bool* valid, const int* b,
                       bool bw, void* out, void* sc, cudaStream_t s) {
  switch (dtype) {
    case kI32: return scan<OP, int, int>(nl, n, v, valid, b, bw, out, sc, s);
    case kI64:
      return scan<OP, long long, long long>(nl, n, v, valid, b, bw, out, sc,
                                            s);
    case kF32:
      return scan<OP, float, float>(nl, n, v, valid, b, bw, out, sc, s);
    case kF64:
      return scan<OP, double, double>(nl, n, v, valid, b, bw, out, sc, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the frame evaluation
// ---------------------------------------------------------------------------

template <typename T>
__global__ void frame_kernel(const long long* __restrict__ n_live_p,
                             long long n, const int* __restrict__ seg_start,
                             const int* __restrict__ seg_end,
                             const int* __restrict__ peer_end,
                             const T* __restrict__ scan,
                             const long long* __restrict__ counts, int fn,
                             bool backward, long long lower, long long upper,
                             bool has_lower, bool has_upper, void* out_p) {
  const long long n_live = *n_live_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long cnt = 0;
    const long long ss = seg_start[i], se = seg_end[i];
    long long lo = ss, hi = se;
    if (i < n_live) {
      if (has_lower && i + lower > ss) lo = i + lower;
      if (peer_end != nullptr)
        hi = peer_end[i] < se ? peer_end[i] : se;
      else if (has_upper && i + upper < se)
        hi = i + upper;
      if (hi >= lo)
        cnt = counts == nullptr
                  ? hi - lo + 1
                  : counts[hi] - (lo > ss ? counts[lo - 1] : 0);
    }
    const bool ok = cnt > 0;
    if (fn == kFnCount) {
      static_cast<long long*>(out_p)[i] = cnt;
      continue;
    }
    if (fn == kFnExtreme) {
      static_cast<Rec<T>*>(out_p)[i] =
          Rec<T>{ok ? scan[backward ? lo : hi] : (T)0, ok};
      continue;
    }
    T s = (T)0;
    if (ok && backward)
      s = scan[lo] - (hi < se ? scan[hi + 1] : (T)0);
    else if (ok)
      s = scan[hi] - (lo > ss ? scan[lo - 1] : (T)0);
    if (fn == kFnAvg)
      static_cast<Rec<double>*>(out_p)[i] =
          Rec<double>{ok ? (double)s / (double)cnt : 0.0, ok};
    else
      static_cast<Rec<T>*>(out_p)[i] = Rec<T>{s, ok};
  }
}

}  // namespace

// dtype: 0 none (count), 1 int32, 2 int64, 3 float32, 4 float64; op: 0
// sum, 1 count, 2 min, 3 max. vals, valid: sorted order (valid null: every
// live row counts). scratch: 3 * ceil(n / 2048) + 1 words of 8 bytes.
extern "C" int sail_window_scan(const void* n_live, long long n,
                                const void* vals, const void* valid,
                                const void* bound, int dtype, int op,
                                int backward, void* out, void* scratch,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* nl = static_cast<const long long*>(n_live);
  const bool* vd = static_cast<const bool*>(valid);
  const int* b = static_cast<const int*>(bound);
  const bool bw = backward != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (op == kCount && dtype == kNone) {
    err = scan<kCount, long long, long long>(nl, n, nullptr, vd, b, bw, out,
                                             scratch, s);
  } else if (op == kSum) {
    switch (dtype) {
      case kI32: err = scan<kSum, int, long long>(nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kI64: err = scan<kSum, long long, long long>(nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kF32: err = scan<kSum, float, double>(nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kF64: err = scan<kSum, double, double>(nl, n, vals, vd, b, bw, out, scratch, s); break;
    }
  } else if (op == kMin) {
    err = scan_typed<kMin>(dtype, nl, n, vals, vd, b, bw, out, scratch, s);
  } else if (op == kMax) {
    err = scan_typed<kMax>(dtype, nl, n, vals, vd, b, bw, out, scratch, s);
  }
  return (int)err;
}

// dtype: the scan's type (as above; 0 for count, which has no scan); fn:
// 0 sum, 1 count, 2 avg (a float64 record), 3 min/max (the extreme at hi,
// or at lo when backward); backward: the scan runs to the segment end.
// peer_end, counts: null when not used. out: n records {value, ok} of the
// scan's type in sorted order (count: n int64).
extern "C" int sail_window_frame(const void* n_live, long long n,
                                 const void* seg_start, const void* seg_end,
                                 const void* peer_end, const void* scan,
                                 const void* counts, int dtype, int fn,
                                 int backward, long long lower,
                                 long long upper, int has_lower,
                                 int has_upper, void* out, int grid,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SAIL_FRAME(T)                                                        \
  frame_kernel<T><<<grid, 256, 0, s>>>(                                      \
      static_cast<const long long*>(n_live), n,                              \
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),  \
      static_cast<const int*>(peer_end), static_cast<const T*>(scan),        \
      static_cast<const long long*>(counts), fn, backward != 0, lower, upper, \
      has_lower != 0, has_upper != 0, out)
  switch (dtype) {
    case kNone:
      if (fn != kFnCount) return (int)cudaErrorInvalidValue;
      SAIL_FRAME(long long);
      break;
    case kI32: SAIL_FRAME(int); break;
    case kI64: SAIL_FRAME(long long); break;
    case kF32: SAIL_FRAME(float); break;
    case kF64: SAIL_FRAME(double); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SAIL_FRAME
  return (int)cudaGetLastError();
}
