// K10: segmented scans of a window's sorted rows, and the frame evaluation.
//
// Replaces, in sail_tpu/ops/window.py `framed_agg` (:207), the global
// float64/int64 `cumsum` of the values and of the valid flags whose
// differences give each frame's sum and count, `_segment_count` (:321),
// and `_segmented_scan` (:328), a Hillis–Steele running MIN/MAX of
// log2(n) full passes. Two entry points:
//
// sail_window_scan: a segmented inclusive scan in sorted order. Scan
//   position k < n_live (a device scalar) is sorted row i = k (forward)
//   or n_live - 1 - k (backward); a segment restarts where seg_start[i]
//   == i (forward) or seg_end[i] == i (backward), so out[i] = op over
//   [seg_start[i], i] or [i, seg_end[i]]. The value of row i is
//   vals[perm[i]] where valid[perm[i]] (no validity: always), else the
//   identity. ops: sum (int64 over int32/int64, exact in two's
//   complement; float64 over float32/float64), count (int64, no values),
//   min and max (the value type; NaN propagates, as torch.minimum).
//   Dead rows (i >= n_live) hold the identity.
// Bound: bytes, n * (8 B perm + 4 B bound + value + 1 B validity, the
//   last two gathered through perm) + n * output width.
// Design: window.cuh's three-phase tile scan over scan positions (tile
//   aggregates, one block scanning the carries, the tiles again from
//   their carries): three launches, every row read twice, in tiles of
//   1024 with 4 consecutive positions a thread.
//
// sail_window_frame: each row's frame [lo, hi] from the ROWS offsets
//   (clipped to the segment), the segment's bounds, or peer_end (the
//   default RANGE frame), evaluated from the scans and written to
//   out[perm[i]]:
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
//   valid where the frame holds a counted row (count has no validity).
//   Dead rows and invalid results get 0.
// Bound: bytes, n * (8 B perm + 8-12 B bounds + 2 scan reads + output),
//   the scan reads at lo - 1 and hi mostly cached neighbours.

#include <limits.h>

#include <cfloat>

#include "window.cuh"

namespace {

using namespace sail::win;

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
  const long long* perm;
  long long n, n_live;
  const In* vals;
  const bool* valid;
  const int* bound;  // seg_start (forward) or seg_end (backward)
  bool backward;

  // the leaf of scan position k: (segment restarts, value)
  __device__ __forceinline__ Seg<Acc> leaf(long long k) const {
    if (k >= n_live) return Seg<Acc>{0, ScanOp<OP, Acc>::identity()};
    const long long i = backward ? n_live - 1 - k : k;
    const int f = bound[i] == i;
    const long long row = perm[i];
    if (valid != nullptr && !valid[row])
      return Seg<Acc>{f, ScanOp<OP, Acc>::identity()};
    if (OP == kCount) return Seg<Acc>{f, (Acc)1};
    return Seg<Acc>{f, (Acc)vals[row]};
  }
};

template <int OP, typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(ScanArgs<OP, In, Acc> a, const long long* n_live_p,
                  Seg<Acc>* agg) {
  a.n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  const SegOp<ScanOp<OP, Acc>> op{};
  const Seg<Acc> ident{0, ScanOp<OP, Acc>::identity()};
  Seg<Acc> acc = ident;
  for (int j = 0; j < kItems; ++j)
    acc = op(acc, a.leaf(base + threadIdx.x * kItems + j));
  Seg<Acc> total;
  block_exclusive_scan<kThreads>(acc, ident, op, &total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

template <int OP, typename Acc>
__global__ void __launch_bounds__(kCarryThreads)
scan_carry_kernel(Seg<Acc>* agg, long long tiles) {
  scan_carries(agg, tiles, Seg<Acc>{0, ScanOp<OP, Acc>::identity()},
               SegOp<ScanOp<OP, Acc>>{}, false);
}

template <int OP, typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
scan_finish_kernel(ScanArgs<OP, In, Acc> a, const long long* n_live_p,
                   const Seg<Acc>* agg, Acc* __restrict__ out) {
  a.n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  const SegOp<ScanOp<OP, Acc>> op{};
  const Seg<Acc> ident{0, ScanOp<OP, Acc>::identity()};
  Seg<Acc> v[kItems];
  for (int j = 0; j < kItems; ++j) v[j] = a.leaf(base + threadIdx.x * kItems + j);
  tile_scan(v, agg[blockIdx.x], ident, op, (Seg<Acc>*)nullptr);
  for (int j = 0; j < kItems; ++j) {
    const long long k = base + threadIdx.x * kItems + j;
    if (k < a.n_live)
      out[a.backward ? a.n_live - 1 - k : k] = v[j].v;
    else if (k < a.n)
      out[k] = ScanOp<OP, Acc>::identity();  // row k is dead
  }
}

template <int OP, typename In, typename Acc>
cudaError_t scan(const long long* perm, const long long* n_live, long long n,
                 const void* vals, const bool* valid, const int* bound,
                 bool backward, void* out, void* scratch, cudaStream_t s) {
  ScanArgs<OP, In, Acc> a{perm, n, 0, static_cast<const In*>(vals), valid,
                          bound, backward};
  const long long tiles = (n + kTile - 1) / kTile;
  Seg<Acc>* agg = static_cast<Seg<Acc>*>(scratch);
  scan_tiles_kernel<OP, In, Acc><<<(unsigned)tiles, kThreads, 0, s>>>(
      a, n_live, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_carry_kernel<OP, Acc><<<1, kCarryThreads, 0, s>>>(agg, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_finish_kernel<OP, In, Acc><<<(unsigned)tiles, kThreads, 0, s>>>(
      a, n_live, agg, static_cast<Acc*>(out));
  return cudaGetLastError();
}

template <int OP, typename In>
cudaError_t scan_minmax(const long long* p, const long long* nl, long long n,
                        const void* v, const bool* valid, const int* b,
                        bool bw, void* out, void* sc, cudaStream_t s) {
  return scan<OP, In, In>(p, nl, n, v, valid, b, bw, out, sc, s);
}

template <int OP>
cudaError_t scan_typed(int dtype, const long long* p, const long long* nl,
                       long long n, const void* v, const bool* valid,
                       const int* b, bool bw, void* out, void* sc,
                       cudaStream_t s) {
  switch (dtype) {
    case kI32: return scan_minmax<OP, int>(p, nl, n, v, valid, b, bw, out, sc, s);
    case kI64: return scan_minmax<OP, long long>(p, nl, n, v, valid, b, bw, out, sc, s);
    case kF32: return scan_minmax<OP, float>(p, nl, n, v, valid, b, bw, out, sc, s);
    case kF64: return scan_minmax<OP, double>(p, nl, n, v, valid, b, bw, out, sc, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the frame evaluation
// ---------------------------------------------------------------------------

template <typename T>
__global__ void frame_kernel(const long long* __restrict__ perm,
                             const long long* __restrict__ n_live_p,
                             long long n, const int* __restrict__ seg_start,
                             const int* __restrict__ seg_end,
                             const int* __restrict__ peer_end,
                             const T* __restrict__ scan,
                             const long long* __restrict__ counts, int fn,
                             bool backward, long long lower, long long upper,
                             bool has_lower, bool has_upper, void* out_p,
                             bool* __restrict__ ok_out) {
  const long long n_live = *n_live_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = perm[i];
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
      static_cast<long long*>(out_p)[row] = cnt;
      continue;
    }
    ok_out[row] = ok;
    if (fn == kFnExtreme) {
      static_cast<T*>(out_p)[row] = ok ? scan[backward ? lo : hi] : (T)0;
      continue;
    }
    T s = (T)0;
    if (ok && backward)
      s = scan[lo] - (hi < se ? scan[hi + 1] : (T)0);
    else if (ok)
      s = scan[hi] - (lo > ss ? scan[lo - 1] : (T)0);
    if (fn == kFnAvg)
      static_cast<double*>(out_p)[row] = ok ? (double)s / (double)cnt : 0.0;
    else
      static_cast<T*>(out_p)[row] = s;
  }
}

}  // namespace

// dtype: 0 none (count), 1 int32, 2 int64, 3 float32, 4 float64; op: 0
// sum, 1 count, 2 min, 3 max. scratch: 16 bytes a tile of 1024 rows.
extern "C" int sail_window_scan(const void* perm, const void* n_live,
                                long long n, const void* vals,
                                const void* valid, const void* bound,
                                int dtype, int op, int backward, void* out,
                                void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(perm);
  const long long* nl = static_cast<const long long*>(n_live);
  const bool* vd = static_cast<const bool*>(valid);
  const int* b = static_cast<const int*>(bound);
  const bool bw = backward != 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (op == kCount && dtype == kNone) {
    err = scan<kCount, long long, long long>(p, nl, n, nullptr, vd, b, bw,
                                             out, scratch, s);
  } else if (op == kSum) {
    switch (dtype) {
      case kI32: err = scan<kSum, int, long long>(p, nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kI64: err = scan<kSum, long long, long long>(p, nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kF32: err = scan<kSum, float, double>(p, nl, n, vals, vd, b, bw, out, scratch, s); break;
      case kF64: err = scan<kSum, double, double>(p, nl, n, vals, vd, b, bw, out, scratch, s); break;
    }
  } else if (op == kMin) {
    err = scan_typed<kMin>(dtype, p, nl, n, vals, vd, b, bw, out, scratch, s);
  } else if (op == kMax) {
    err = scan_typed<kMax>(dtype, p, nl, n, vals, vd, b, bw, out, scratch, s);
  }
  return (int)err;
}

// dtype: the scan's type (as above; 0 for count, which has no scan); fn:
// 0 sum, 1 count, 2 avg (out float64), 3 min/max (the extreme at hi, or at
// lo when backward); backward: the scan runs to the segment end. peer_end, counts: null when not used; ok: null for
// count.
extern "C" int sail_window_frame(const void* perm, const void* n_live,
                                 long long n, const void* seg_start,
                                 const void* seg_end, const void* peer_end,
                                 const void* scan, const void* counts,
                                 int dtype, int fn, int backward,
                                 long long lower, long long upper,
                                 int has_lower, int has_upper, void* out,
                                 void* ok, int grid, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SAIL_FRAME(T)                                                        \
  frame_kernel<T><<<grid, 256, 0, s>>>(                                      \
      static_cast<const long long*>(perm),                                   \
      static_cast<const long long*>(n_live), n,                              \
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),  \
      static_cast<const int*>(peer_end), static_cast<const T*>(scan),        \
      static_cast<const long long*>(counts), fn, backward != 0, lower, upper, \
      has_lower != 0, has_upper != 0, out, static_cast<bool*>(ok))
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
