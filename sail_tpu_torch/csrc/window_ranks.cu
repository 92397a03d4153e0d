// K9: the rank family of window functions, in one elementwise pass.
//
// Replaces sail_tpu/ops/window.py `row_number` (:108), `rank` (:112),
// `dense_rank` (:117), `percent_rank` (:137), `cume_dist` (:144) and
// `ntile` (:156), each of which recomputed the peer groups (a cumsum and
// segment reductions) and gathered its result back through the inverse
// permutation. Here K8's bounds are read once per sorted position i and
// each requested output (a null pointer: not requested) is written to
// out[perm[i]]; dead rows (i >= n_live, a device scalar) get 0.
// Formulas are the reference's: with len = seg_end - seg_start + 1 and
// pos = i - seg_start,
//   row_number = pos + 1, rank = peer_start - seg_start + 1,
//   dense_rank = dense, percent_rank = len > 1 ? (rank - 1) / (len - 1)
//   : 0, cume_dist = (peer_end - seg_start + 1) / len,
//   ntile(k): the first len % k tiles hold len / k + 1 rows.
// Bound: bytes, n * (8 B perm + 5 * 4 B bounds + 8 B per output); the
// output stores scatter through perm.

#include "window.cuh"

namespace {

__global__ void ranks_kernel(const long long* __restrict__ perm,
                             const long long* __restrict__ n_live_p,
                             long long n, const int* __restrict__ seg_start,
                             const int* __restrict__ seg_end,
                             const int* __restrict__ peer_start,
                             const int* __restrict__ peer_end,
                             const int* __restrict__ dense, long long n_tiles,
                             long long* row_number, long long* rank,
                             long long* dense_rank, double* percent_rank,
                             double* cume_dist, long long* ntile) {
  const long long n_live = *n_live_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = perm[i];
    if (i >= n_live) {
      if (row_number) row_number[row] = 0;
      if (rank) rank[row] = 0;
      if (dense_rank) dense_rank[row] = 0;
      if (percent_rank) percent_rank[row] = 0.0;
      if (cume_dist) cume_dist[row] = 0.0;
      if (ntile) ntile[row] = 0;
      continue;
    }
    const long long ss = seg_start[i];
    const long long len = (long long)seg_end[i] - ss + 1;
    const long long pos = i - ss;
    const long long before = (long long)peer_start[i] - ss;
    if (row_number) row_number[row] = pos + 1;
    if (rank) rank[row] = before + 1;
    if (dense_rank) dense_rank[row] = dense[i];
    if (percent_rank)
      percent_rank[row] = len > 1 ? (double)before / (double)(len - 1) : 0.0;
    if (cume_dist)
      cume_dist[row] = (double)((long long)peer_end[i] - ss + 1) /
                       (double)(len > 1 ? len : 1);
    if (ntile) {
      const long long sl = len > 1 ? len : 1;
      const long long base = sl / n_tiles, rem = sl % n_tiles;
      const long long big = rem * (base + 1);
      long long tile = pos < big ? pos / (base + 1)
                                 : rem + (pos - big) / (base > 0 ? base : 1);
      tile = tile < 0 ? 0 : (tile > n_tiles - 1 ? n_tiles - 1 : tile);
      ntile[row] = tile + 1;
    }
  }
}

}  // namespace

extern "C" int sail_window_ranks(const void* perm, const void* n_live,
                                 long long n, const void* seg_start,
                                 const void* seg_end, const void* peer_start,
                                 const void* peer_end, const void* dense,
                                 long long n_tiles, void* row_number,
                                 void* rank, void* dense_rank,
                                 void* percent_rank, void* cume_dist,
                                 void* ntile, int grid, void* stream) {
  if (n <= 0) return 0;
  if (n_tiles < 1) return (int)cudaErrorInvalidValue;
  ranks_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(perm),
      static_cast<const long long*>(n_live), n,
      static_cast<const int*>(seg_start), static_cast<const int*>(seg_end),
      static_cast<const int*>(peer_start), static_cast<const int*>(peer_end),
      static_cast<const int*>(dense), n_tiles,
      static_cast<long long*>(row_number), static_cast<long long*>(rank),
      static_cast<long long*>(dense_rank), static_cast<double*>(percent_rank),
      static_cast<double*>(cume_dist), static_cast<long long*>(ntile));
  return (int)cudaGetLastError();
}
