// K6: the index triples of an expanding (many-to-many) join.
//
// Replaces the index arithmetic of sail_tpu/ops/join.py `join_expand`.
// Given per-probe output counts `eff` (cnt, or max(cnt, 1) for a left
// join; 0 for dead rows) and their exclusive prefix sum `offsets`, output
// row j = offsets[i] + k (0 <= k < eff[i]) gets
//   probe_index = i, is_match = k < cnt[i],
//   build_index = perm[clip(lo[i] + (is_match ? k : 0), 0, nb - 1)].
// The reference finds i for each j by a searchsorted over the offsets;
// here each probe row writes its own contiguous slots, which is the same
// work without the search. Indices are int64: Q21's lineitem self-join
// expands to ~1e8-3e8 rows at SF10, near int32's limit.
//
// Bound: bytes: per probe row eff, offsets, cnt, lo read (24 B) and per
// output row 17 bytes written plus one 8-byte gather from perm. One
// thread per probe row: a row's slots are contiguous, but neighbouring
// threads write runs of different lengths, so stores coalesce only when
// most runs are short.

#include "common.cuh"

namespace {

__global__ void expand_kernel(const long long* __restrict__ eff,
                              const long long* __restrict__ offsets,
                              const int* __restrict__ cnt,
                              const int* __restrict__ lo, long long n,
                              const long long* __restrict__ perm,
                              long long nb, long long* __restrict__ probe_idx,
                              long long* __restrict__ build_idx,
                              unsigned char* __restrict__ is_match) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long e = eff[i];
    long long base = offsets[i];
    long long c = cnt[i];
    long long l = lo[i];
    for (long long k = 0; k < e; ++k) {
      bool m = k < c;
      long long pos = l + (m ? k : 0);
      pos = pos < 0 ? 0 : (pos > nb - 1 ? nb - 1 : pos);
      probe_idx[base + k] = i;
      build_idx[base + k] = nb > 0 ? perm[pos] : 0;
      is_match[base + k] = m;
    }
  }
}

}  // namespace

extern "C" int sail_join_expand(const void* eff, const void* offsets,
                                const void* cnt, const void* lo, long long n,
                                const void* perm, long long nb,
                                void* probe_idx, void* build_idx,
                                void* is_match, int grid, void* stream) {
  expand_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(eff),
      static_cast<const long long*>(offsets), static_cast<const int*>(cnt),
      static_cast<const int*>(lo), n, static_cast<const long long*>(perm), nb,
      static_cast<long long*>(probe_idx), static_cast<long long*>(build_idx),
      static_cast<unsigned char*>(is_match));
  return (int)cudaGetLastError();
}
