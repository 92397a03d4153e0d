// K9: the rank family of window functions, computed in sorted order.
//
// Replaces sail_tpu/ops/window.py `row_number` (:108), `rank` (:112),
// `dense_rank` (:117), `percent_rank` (:137), `cume_dist` (:144) and
// `ntile` (:156), each of which recomputed the peer groups (a cumsum and
// segment reductions) and gathered its result back through the inverse
// permutation (:82). Here K8's bounds are read once per sorted position i,
// in order, and the k requested outputs (k <= 6, each an 8 B word: int64,
// or float64 for percent_rank and cume_dist) are computed there.
// Formulas are the reference's: with len = seg_end - seg_start + 1 and
// pos = i - seg_start,
//   row_number = pos + 1, rank = peer_start - seg_start + 1,
//   dense_rank = dense, percent_rank = len > 1 ? (rank - 1) / (len - 1)
//   : 0, cume_dist = (peer_end - seg_start + 1) / len,
//   ntile(t): the first len % t tiles hold len / t + 1 rows.
// The outputs go to row order as records: sail_window_ranks writes one
// record of k words a live position i < n_live (a device scalar),
// rec[i * k + j], and sail_window_ranks_unpermute takes the records to row
// order through the context's int32 inv_perm, out_j[r] = rec[inv[r] * k +
// j], 0 where inv[r] < 0 (a dead row): one random record (one or two
// sectors) read a row, k writes in order; out is [k, n] words. (A form
// that wrote one output through perm, a random 8 B write a row, lost to
// the records with the inverse built at every context once the inverse
// became a partitioned scatter: PERF.md, section 6.)
// Bound: bytes, n * (4 B inv_perm + the bounds read, 4 B each + 8 B an
//   output), each read and written once.

#include "window.cuh"

namespace {

constexpr int kMaxRanks = 6;
enum Rank { kRowNumber = 0, kRank, kDenseRank, kPercentRank, kCumeDist,
            kNtile };

struct Wanted {
  int code[kMaxRanks];  // the k outputs, in order
  int k;
};

__global__ void ranks_kernel(const long long* __restrict__ n_live_p,
                             long long n, const int* __restrict__ seg_start,
                             const int* __restrict__ seg_end,
                             const int* __restrict__ peer_start,
                             const int* __restrict__ peer_end,
                             const int* __restrict__ dense, long long n_tiles,
                             Wanted w,
                             unsigned long long* __restrict__ out) {
  const long long n_live = *n_live_p;
  const long long end = n_live < n ? n_live : n;  // the live positions
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < end; i += stride) {
    unsigned long long word[kMaxRanks] = {};
    if (i < n_live) {
      const long long ss = seg_start[i];
      const long long pos = i - ss;
#pragma unroll
      for (int j = 0; j < kMaxRanks; ++j) {
        if (j >= w.k) break;
        long long len = 1;
        if (w.code[j] >= kPercentRank) len = (long long)seg_end[i] - ss + 1;
        switch (w.code[j]) {
          case kRowNumber: word[j] = pos + 1; break;
          case kRank: word[j] = (long long)peer_start[i] - ss + 1; break;
          case kDenseRank: word[j] = dense[i]; break;
          case kPercentRank:
            word[j] = __double_as_longlong(
                len > 1 ? (double)((long long)peer_start[i] - ss) /
                              (double)(len - 1)
                        : 0.0);
            break;
          case kCumeDist:
            word[j] = __double_as_longlong(
                (double)((long long)peer_end[i] - ss + 1) /
                (double)(len > 1 ? len : 1));
            break;
          default: {  // kNtile
            const long long sl = len > 1 ? len : 1;
            const long long base = sl / n_tiles, rem = sl % n_tiles;
            const long long big = rem * (base + 1);
            long long tile = pos < big
                                 ? pos / (base + 1)
                                 : rem + (pos - big) / (base > 0 ? base : 1);
            tile = tile < 0 ? 0 : (tile > n_tiles - 1 ? n_tiles - 1 : tile);
            word[j] = tile + 1;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRanks; ++j)
      if (j < w.k) out[i * w.k + j] = word[j];
  }
}

constexpr int kUThreads = 256;
constexpr int kPer = 4;  // rows a thread, kUThreads apart
constexpr int kSpan = kUThreads * kPer;

template <int K>
__global__ void __launch_bounds__(kUThreads)
ranks_unpermute_kernel(const int* __restrict__ inv, long long n,
                       const unsigned long long* __restrict__ rec,
                       unsigned long long* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kSpan + threadIdx.x;
  long long from[kPer];  // -1: a dead row, or past the end
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long r = base + j * kUThreads;
    from[j] = r < n ? inv[r] : -1;
  }
  unsigned long long v[kPer][K];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int o = 0; o < K; ++o)
      v[j][o] = from[j] >= 0 ? rec[from[j] * K + o] : 0ull;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long r = base + j * kUThreads;
    if (r < n) {
#pragma unroll
      for (int o = 0; o < K; ++o) out[o * n + r] = v[j][o];
    }
  }
}

}  // namespace

// codes: k rank codes on the host (0 row_number, 1 rank, 2 dense_rank, 3
// percent_rank, 4 cume_dist, 5 ntile); records into out (n x k words,
// live positions only).
extern "C" int sail_window_ranks(const void* n_live, long long n,
                                 const void* seg_start, const void* seg_end,
                                 const void* peer_start, const void* peer_end,
                                 const void* dense, long long n_tiles,
                                 const int* codes, int k, void* out,
                                 int grid, void* stream) {
  if (n <= 0) return 0;
  if (n_tiles < 1 || k < 1 || k > kMaxRanks) return (int)cudaErrorInvalidValue;
  Wanted w;
  for (int j = 0; j < kMaxRanks; ++j) {
    w.code[j] = j < k ? codes[j] : 0;
    if (w.code[j] < kRowNumber || w.code[j] > kNtile)
      return (int)cudaErrorInvalidValue;
  }
  w.k = k;
  ranks_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(n_live), n,
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),
      static_cast<const int*>(peer_start), static_cast<const int*>(peer_end),
      static_cast<const int*>(dense), n_tiles, w,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// inv: n int32 (-1 at a dead row); rec: records of k words at the sorted
// positions; out: [k, n] words.
extern "C" int sail_window_ranks_unpermute(const void* inv, long long n,
                                           const void* rec, int k, void* out,
                                           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((n + kSpan - 1) / kSpan);
  const int* i = static_cast<const int*>(inv);
  const unsigned long long* r = static_cast<const unsigned long long*>(rec);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  switch (k) {
    case 1: ranks_unpermute_kernel<1><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    case 2: ranks_unpermute_kernel<2><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    case 3: ranks_unpermute_kernel<3><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    case 4: ranks_unpermute_kernel<4><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    case 5: ranks_unpermute_kernel<5><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    case 6: ranks_unpermute_kernel<6><<<grid, kUThreads, 0, s>>>(i, n, r, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
