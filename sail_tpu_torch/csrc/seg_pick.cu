// K20: segment arg-extreme. For each group, the row holding the largest
// (or smallest) key, ties to the least index.
//
// Replaces the per-group Python of sail_tpu/functions/host_aggregates.py
// for max_by and min_by (Python's max/min over the group's rows keep the
// first row of a tie) and for mode (`_mode`, `_mode_ordered`: over the
// runs of a (group, value) sort, the key is a run's length and the index
// its position, so a tie goes to the first value in the sort's order).
// The reference runs them over each group's rows downloaded to lists
// (sail_tpu/exec/local.py `_host_aggregate`, `_host_agg_one`).
//
// A position i < n belongs to group ids[i] (outside [0, S): dead, skipped
// before anything else is read) and reads row r = rows[i] (i where rows is
// null); it takes part where valid[r] (or always, valid null) with the key
// keys[r] (an int64 order word) and the index r.
// Pass 1: best[g] = max (or min) of the keys, by 64-bit atomicMax/Min.
// Pass 2: index[g] = the least index among the rows whose key is best[g],
//   by 64-bit atomicMin. A group without a row keeps the identities the
//   caller filled in (INT64_MIN or INT64_MAX, and INT64_MAX).
//
// Bound: bytes. Each pass reads a live position's 4 B id, 8 B row index
// (where rows is given), 1 B validity and 8 B key; pass 2 also reads its
// group's best word; S groups write 8 B each pass. As in K1's binned
// entry point, a warp first combines its lanes of one group
// (__match_any_sync and a shuffle tree) so one lane a group issues an
// atomic, and where S <= kSharedMax each block keeps its groups in shared
// memory and adds them to the global words once; more groups go to
// global atomics straight from the warp.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMax = 2048;  // groups a block keeps in shared memory
constexpr long long kMax64 = 0x7fffffffffffffffLL;
constexpr long long kMin64 = (long long)0x8000000000000000ULL;

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
  const long long* keys;  // by row
  const bool* valid;      // by row; nullptr: every row
  long long* best;        // [S]
  long long* index;       // [S]
};

// pass 1 (IS_MAX: the largest key) or pass 2 (the least index at it)
template <int PASS, bool IS_MAX, bool SHARED>
__global__ void __launch_bounds__(kThreads) pick_kernel(Args args) {
  __shared__ long long sh[SHARED ? kSharedMax : 1];
  const int S = args.num_segments;
  // pass 1 combines keys by max (min); pass 2 indices by min
  constexpr bool kMaxOp = PASS == 1 && IS_MAX;
  const long long identity = kMaxOp ? kMin64 : kMax64;
  if constexpr (SHARED) {
    for (int k = threadIdx.x; k < S; k += blockDim.x) sh[k] = identity;
    __syncthreads();
  }
  sail::WarpLoop loop;
  for (long long base = loop.first; base < args.n; base += loop.stride) {
    const long long i = base + loop.lane;
    int g = -1;
    long long v = identity;
    if (i < args.n) {
      const int id = args.ids[i];
      if (id >= 0 && id < S) {
        const long long r = args.rows == nullptr ? i : args.rows[i];
        if (args.valid == nullptr || args.valid[r]) {
          const long long key = args.keys[r];
          if (PASS == 1) {
            g = id;
            v = key;
          } else if (key == args.best[id]) {
            g = id;
            v = r;
          }
        }
      }
    }
    const unsigned peers = __match_any_sync(SAIL_FULL_MASK, g);
    if constexpr (kMaxOp)
      v = sail::reduce_peers(peers, v, loop.lane, Max());
    else
      v = sail::reduce_peers(peers, v, loop.lane, Min());
    if (g >= 0 && loop.lane == __ffs(peers) - 1) {
      long long* dst = SHARED ? sh + g : (PASS == 1 ? args.best : args.index) + g;
      if constexpr (kMaxOp)
        atomicMax(dst, v);
      else
        atomicMin(dst, v);
    }
  }
  if constexpr (SHARED) {
    __syncthreads();
    long long* out = PASS == 1 ? args.best : args.index;
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      if (sh[k] == identity) continue;
      if constexpr (kMaxOp)
        atomicMax(out + k, sh[k]);
      else
        atomicMin(out + k, sh[k]);
    }
  }
}

template <int PASS, bool IS_MAX>
void launch(const Args& args, int grid, cudaStream_t stream) {
  if (args.num_segments <= kSharedMax)
    pick_kernel<PASS, IS_MAX, true><<<grid, kThreads, 0, stream>>>(args);
  else
    pick_kernel<PASS, IS_MAX, false><<<grid, kThreads, 0, stream>>>(args);
}

}  // namespace

// Both passes over positions [0, n): ids int32[n], rows int64[n] or null,
// keys int64 and valid bool (or null) by row; best and index int64[S],
// filled by the caller with INT64_MIN (is_max) or INT64_MAX, and
// INT64_MAX. Two launches on `stream`. Returns the last cudaError_t.
extern "C" int sail_seg_pick(const void* ids, const void* rows, long long n,
                             int num_segments, const void* keys,
                             const void* valid, int is_max, void* best,
                             void* index, int grid, void* stream) {
  if (n <= 0 || num_segments <= 0) return 0;
  Args args{static_cast<const int*>(ids),
            static_cast<const long long*>(rows),
            n,
            num_segments,
            static_cast<const long long*>(keys),
            static_cast<const bool*>(valid),
            static_cast<long long*>(best),
            static_cast<long long*>(index)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_max) {
    launch<1, true>(args, grid, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch<2, true>(args, grid, s);
  } else {
    launch<1, false>(args, grid, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    launch<2, false>(args, grid, s);
  }
  return (int)cudaGetLastError();
}
