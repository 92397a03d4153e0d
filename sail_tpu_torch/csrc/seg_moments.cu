// K19: segment moments, the two passes of the statistical aggregates.
//
// Replaces the per-group Python of sail_tpu/functions/host_aggregates.py
// `_corr`, `_covar`, `_skew_kurt` and `_regr` (corr, covar_samp,
// covar_pop, skewness, kurtosis and the nine regr_*), which the reference
// runs over each group's rows downloaded to lists
// (sail_tpu/exec/local.py `_host_aggregate`, `_host_agg_one`).
//
// A row is a position i < n of the grouping: its group ids[i] (positions
// whose id is outside [0, S) are dead and skipped before anything else is
// read) and its row rows[i] (the sort's permutation; i itself where rows
// is null, in row order). Its operands a and b load as float64 at that
// row: an int32 or int64 value (a decimal's unscaled value) divided by
// its scale's power of ten, or a float64. A row counts only where both
// operands are valid (the pair-null mask of the statistical pairs).
//
// Pass 1, per group: the rows (count), sum of a and of b, and the
//   minimum and maximum of a and of b as order words (K3's: -0.0 is 0.0,
//   every NaN the largest), combined by 64-bit atomicMin/Max.
// Pass 2, per group, given each group's means: the centred sums
//   sum (a - ma)^2, (b - mb)^2, (a - ma)(b - mb), (a - ma)^3, (a - ma)^4,
//   only those the mask asks for.
//
// Bound: bytes. A live row reads its 4 B id, its 8 B row index where
// rows is given, and its operands (8 B each, 1 B a validity) in each pass;
// S groups write 7 (pass 1) or 5 (pass 2) words. float64 sums are taken
// with atomicAdd, in an order that varies between runs.
// Design, against the hazard of few groups over many rows (TPC-H Q1's
// grouping: 4 groups over 60M rows would put every row's atomic on one of
// a few addresses):
//   * a warp first combines the lanes of one group (__match_any_sync and a
//     shuffle tree a value), so one lane a group and warp issues atomics;
//   * where S <= kSharedMax, each block keeps its partials in shared
//     memory and adds them to the global sums once, when it finishes
//     (K17's direct tail does the same); more groups (a sorted grouping,
//     whose consecutive positions share a group) go to global atomics
//     straight from the warp.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMax = 512;  // groups a block keeps in shared memory
constexpr long long kMax64 = 0x7fffffffffffffffLL;
constexpr long long kMin64 = (long long)0x8000000000000000ULL;

struct Operand {
  const void* data;
  const bool* valid;  // nullptr: no NULLs
  int type;           // 0 int32, 1 int64, 2 float64
  double scale;       // 10^scale of a decimal, 1 otherwise

  __device__ __forceinline__ double load(long long r) const {
    if (type == 0) return (double)static_cast<const int*>(data)[r] / scale;
    if (type == 1)
      return (double)static_cast<const long long*>(data)[r] / scale;
    return static_cast<const double*>(data)[r];
  }
  __device__ __forceinline__ bool ok(long long r) const {
    return valid == nullptr || valid[r];
  }
};

// K3's order word of a float64: -0.0 as 0.0, every NaN one value, the
// largest; a signed comparison of words orders the values
__device__ __forceinline__ long long order_word(double v) {
  long long b = isnan(v) ? 0x7ff8000000000000LL : __double_as_longlong(v + 0.0);
  return b < 0 ? b ^ kMax64 : b;
}

struct Add {
  __device__ __forceinline__ double operator()(double a, double b) const {
    return a + b;
  }
};
struct Min {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return a < b ? a : b;
  }
};
struct Max {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return a > b ? a : b;
  }
};

struct Args {
  const int* ids;
  const long long* rows;  // nullptr: position i is row i
  long long n;
  int num_segments;
  Operand a, b;
  bool has_b;
  int mask;              // pass 2: which of the five centred sums
  const double* means;   // pass 2: [S][2], each group's (ma, mb)
  unsigned long long* count;  // pass 1: [S]
  double* sums;               // pass 1: [S][2]; pass 2: [S][5]
  long long* ext;             // pass 1: [S][4] min a, max a, min b, max b
};

// words a group keeps: pass 1 count, 2 sums, 4 extremes; pass 2 5 sums
template <int PASS>
constexpr int kWords = PASS == 1 ? 7 : 5;

template <int PASS>
__device__ __forceinline__ long long identity_word(int slot) {
  if (PASS == 1 && (slot == 3 || slot == 5)) return kMax64;  // minima
  if (PASS == 1 && (slot == 4 || slot == 6)) return kMin64;  // maxima
  return 0;  // counts, and float64 0.0
}

// one group's pass-1 partials from the lane that leads its peers, into
// the block's shared words of the group, in slot order
__device__ __forceinline__ void combine(long long* acc, unsigned cnt,
                                        const double* s,
                                        const long long* e) {
  atomicAdd(reinterpret_cast<unsigned long long*>(acc),
            (unsigned long long)cnt);
  atomicAdd(reinterpret_cast<double*>(acc + 1), s[0]);
  atomicAdd(reinterpret_cast<double*>(acc + 2), s[1]);
  atomicMin(acc + 3, e[0]);
  atomicMax(acc + 4, e[1]);
  atomicMin(acc + 5, e[2]);
  atomicMax(acc + 6, e[3]);
}

template <int PASS, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(Args args) {
  constexpr int W = kWords<PASS>;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  long long* sh = reinterpret_cast<long long*>(smem_raw);
  const int S = args.num_segments;
  if constexpr (SHARED) {
    for (int k = threadIdx.x; k < S * W; k += blockDim.x)
      sh[k] = identity_word<PASS>(k % W);
    __syncthreads();
  }
  sail::WarpLoop loop;
  for (long long base = loop.first; base < args.n; base += loop.stride) {
    const long long i = base + loop.lane;
    int g = -1;
    double x = 0.0, y = 0.0;
    if (i < args.n) {
      const int id = args.ids[i];
      if (id >= 0 && id < S) {
        const long long r = args.rows == nullptr ? i : args.rows[i];
        if (args.a.ok(r) && (!args.has_b || args.b.ok(r))) {
          g = id;
          x = args.a.load(r);
          if (args.has_b) y = args.b.load(r);
        }
      }
    }
    const unsigned peers = __match_any_sync(SAIL_FULL_MASK, g);
    const bool leader = g >= 0 && loop.lane == __ffs(peers) - 1;
    if constexpr (PASS == 1) {
      double s[2] = {sail::reduce_peers(peers, x, loop.lane, Add()),
                     sail::reduce_peers(peers, y, loop.lane, Add())};
      const long long wx = order_word(x), wy = order_word(y);
      long long e[4] = {sail::reduce_peers(peers, wx, loop.lane, Min()),
                        sail::reduce_peers(peers, wx, loop.lane, Max()),
                        sail::reduce_peers(peers, wy, loop.lane, Min()),
                        sail::reduce_peers(peers, wy, loop.lane, Max())};
      if (leader) {
        if constexpr (SHARED) {
          combine(sh + (long long)g * W, __popc(peers), s, e);
        } else {
          atomicAdd(args.count + g, (unsigned long long)__popc(peers));
          atomicAdd(args.sums + 2LL * g, s[0]);
          atomicAdd(args.sums + 2LL * g + 1, s[1]);
          atomicMin(args.ext + 4LL * g, e[0]);
          atomicMax(args.ext + 4LL * g + 1, e[1]);
          atomicMin(args.ext + 4LL * g + 2, e[2]);
          atomicMax(args.ext + 4LL * g + 3, e[3]);
        }
      }
    } else {
      double dx = 0.0, dy = 0.0;
      if (g >= 0) {
        dx = x - args.means[2LL * g];
        dy = y - args.means[2LL * g + 1];
      }
      const double dx2 = dx * dx;
      const double t[5] = {dx2, dy * dy, dx * dy, dx2 * dx, dx2 * dx2};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (!(args.mask >> k & 1)) continue;  // uniform: a kernel argument
        const double v = sail::reduce_peers(peers, t[k], loop.lane, Add());
        if (leader) {
          double* dst = SHARED ? reinterpret_cast<double*>(sh + (long long)g * W)
                               : args.sums + 5LL * g;
          atomicAdd(dst + k, v);
        }
      }
    }
  }
  if constexpr (SHARED) {
    __syncthreads();
    for (int k = threadIdx.x; k < S * W; k += blockDim.x) {
      const int g = k / W, slot = k % W;
      const long long v = sh[k];
      if (v == identity_word<PASS>(slot)) continue;
      if constexpr (PASS == 2) {
        atomicAdd(args.sums + 5LL * g + slot, __longlong_as_double(v));
      } else if (slot == 0) {
        atomicAdd(args.count + g, (unsigned long long)v);
      } else if (slot < 3) {
        atomicAdd(args.sums + 2LL * g + slot - 1, __longlong_as_double(v));
      } else if (slot == 3 || slot == 5) {
        atomicMin(args.ext + 4LL * g + slot - 3, v);
      } else {
        atomicMax(args.ext + 4LL * g + slot - 3, v);
      }
    }
  }
}

template <int PASS>
cudaError_t launch(const Args& args, int grid, cudaStream_t stream) {
  if (args.num_segments <= kSharedMax) {
    const size_t smem =
        (size_t)args.num_segments * kWords<PASS> * sizeof(long long);
    moments_kernel<PASS, true><<<grid, kThreads, smem, stream>>>(args);
  } else {
    moments_kernel<PASS, false><<<grid, kThreads, 0, stream>>>(args);
  }
  return cudaGetLastError();
}

}  // namespace

// pass 1 or 2 over positions [0, n). ids: int32[n]; rows: int64[n] or
// null. a, b: each a column (type 0 int32, 1 int64, 2 float64), its
// validity (bool, or null) and the power of ten its values divide by; b
// null: one operand. Pass 1 adds into count (uint64[S]), sums
// (float64[S][2]) and ext (int64 order words [S][4], min/max of a, then
// of b), which the caller fills with 0, 0.0 and the extremes' identities
// (INT64_MAX for minima, INT64_MIN for maxima). Pass 2 reads means
// (float64[S][2]) and adds the centred sums `mask` names (bit k: sum k of
// (a-ma)^2, (b-mb)^2, (a-ma)(b-mb), (a-ma)^3, (a-ma)^4) into sums
// (float64[S][5], zeroed). Returns the launch's cudaError_t.
extern "C" int sail_seg_moments(int pass, const void* ids, const void* rows,
                                long long n, int num_segments,
                                const void* a, const void* a_valid,
                                int a_type, double a_scale, const void* b,
                                const void* b_valid, int b_type,
                                double b_scale, int mask, const void* means,
                                void* count, void* sums, void* ext, int grid,
                                void* stream) {
  if (n <= 0 || num_segments <= 0) return 0;
  if (a == nullptr || a_type < 0 || a_type > 2 || (b != nullptr &&
      (b_type < 0 || b_type > 2)) || (pass != 1 && pass != 2))
    return (int)cudaErrorInvalidValue;
  Args args{static_cast<const int*>(ids),
            static_cast<const long long*>(rows),
            n,
            num_segments,
            {a, static_cast<const bool*>(a_valid), a_type, a_scale},
            {b, static_cast<const bool*>(b_valid), b_type, b_scale},
            b != nullptr,
            mask,
            static_cast<const double*>(means),
            static_cast<unsigned long long*>(count),
            static_cast<double*>(sums),
            static_cast<long long*>(ext)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pass == 1 ? launch<1>(args, grid, s) : launch<2>(args, grid, s));
}
