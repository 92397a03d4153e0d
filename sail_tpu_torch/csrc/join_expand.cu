// K6: the index triples of an expanding (many-to-many) join.
//
// Replaces the index arithmetic of sail_tpu/ops/join.py `join_expand`.
// Given per-probe output counts eff (cnt, or max(cnt, 1) for a left
// join; 0 for dead rows) and their exclusive prefix sum `offsets`, output
// row j = offsets[i] + k (0 <= k < eff[i]) gets
//   probe_index = i, is_match = k < cnt[i],
//   build_index = perm[clip(lo[i] + (is_match ? k : 0), 0, nb - 1)]
// (0 when the build is empty). Indices are int64: Q21's lineitem
// self-join expands to ~1e8-3e8 rows at SF10, and a join's output may
// pass 2^31 rows.
//
// Bound: bytes. The outputs, 17 bytes a row written, are most of them;
// the inputs each row's offset, the cnt and lo of the rows with output,
// and the perm entries the matches read. With a thread per probe row,
// neighbouring lanes would store runs of different lengths at scattered
// addresses, and the stores would not coalesce.
//
// The design drives the work from the output, which is contiguous:
// - Work is cut into pieces of kPiece items, an item being a probe row or
//   an output slot, along the merge path of the rows' offsets and the
//   slots: row r precedes slot j when offsets[r] <= j, so row r sits at
//   position r + offsets[r] of the merged order. A piece is thus a run of
//   consecutive probe rows and the one contiguous span of output slots
//   they own, and holds at most kPiece of both together: a row with a
//   long run of matches (a hot key) is spread over as many pieces as its
//   run needs, and a stretch of rows with no output is a piece of reads.
//   A pre-pass finds every piece's first row by a binary search of the
//   merge path in global memory and writes it to a scratch tensor.
// - A block of the persistent grid takes a piece, stages its rows'
//   offsets, and the cnt and lo of those with output, in shared memory
//   with coalesced loads, then writes the span in order, two slots a
//   thread: one 16-byte store per index array and one 2-byte store of
//   the flags where both slots lie in the span. A slot finds its row by a
//   binary search over the staged offsets (the last row whose offset is
//   <= the slot; rows with eff 0 share their offset with the next row and
//   are passed over); the second slot of a pair by a check of the first
//   slot's row end.
// - The slots of one row read perm[lo + k] in a run, so those loads
//   coalesce too. eff is not read: a row's end is the next row's offset.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 2048;  // probe rows + output slots per piece

// split[p] = the rows among the first p * kPiece items of the merge path:
// the number of rows r with r + offsets[r] < d (r + offsets[r] grows
// strictly with r)
__global__ void partition_kernel(const long long* __restrict__ offsets,
                                 long long n, long long total,
                                 long long pieces,
                                 long long* __restrict__ split) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p <= pieces; p += (long long)gridDim.x * blockDim.x) {
    long long d = p * kPiece < n + total ? p * kPiece : n + total;
    long long lo = d - total > 0 ? d - total : 0, hi = d < n ? d : n;
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (mid + offsets[mid] < d) lo = mid + 1; else hi = mid;
    }
    split[p] = lo;
  }
}

// the last staged row r >= from with off[r] <= j (off[from] <= j)
__device__ __forceinline__ int row_of(const long long* off, int rows,
                                      long long j, int from) {
  int r = from;
#pragma unroll
  for (int step = kPiece; step; step >>= 1)
    if (r + step < rows && off[r + step] <= j) r += step;
  return r;
}

struct Slot {
  long long probe, build;
  unsigned char match;
};

__device__ __forceinline__ Slot slot(long long j, int r, long long first,
                                     const long long* off, const int2* cl,
                                     const long long* __restrict__ perm,
                                     long long nb) {
  long long k = j - off[r];
  int2 c = cl[r];  // (cnt, lo)
  bool m = k < c.x;
  long long pos = (long long)c.y + (m ? k : 0);
  pos = pos < 0 ? 0 : (pos > nb - 1 ? nb - 1 : pos);
  return {first + r, nb > 0 ? __ldg(perm + pos) : 0, (unsigned char)m};
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const long long* __restrict__ offsets,
              const int* __restrict__ cnt, const int* __restrict__ lo,
              long long n, long long total,
              const long long* __restrict__ perm, long long nb,
              const long long* __restrict__ split, long long pieces,
              long long* __restrict__ probe_idx,
              long long* __restrict__ build_idx,
              unsigned char* __restrict__ is_match) {
  __shared__ long long off[kPiece + 1];
  __shared__ int2 cl[kPiece + 1];
  for (long long p = blockIdx.x; p < pieces; p += gridDim.x) {
    const long long d0 = p * kPiece;
    const long long d1 = d0 + kPiece < n + total ? d0 + kPiece : n + total;
    const long long r0 = split[p], r1 = split[p + 1];
    const long long j0 = d0 - r0, j1 = d1 - r1;
    // the row that owns slot j0 may start in an earlier piece
    const long long first = r0 > 0 ? r0 - 1 : 0;
    const int rows = (int)(r1 - first);
    for (int r = threadIdx.x; r < rows; r += kThreads)
      off[r] = offsets[first + r];
    __syncthreads();
    if (j0 < j1) {
      // cnt and lo of the staged rows that own a slot of the span
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        long long end = r + 1 < rows ? off[r + 1] : j1;
        if (end > off[r] && end > j0)
          cl[r] = make_int2(__ldg(cnt + first + r), __ldg(lo + first + r));
      }
      __syncthreads();
      // pairs of slots from an even index, so a whole pair is 16-byte
      // aligned in the int64 outputs
      for (long long j = (j0 & ~1LL) + 2 * threadIdx.x; j < j1;
           j += 2 * kThreads) {
        const bool in0 = j >= j0, in1 = j + 1 < j1;
        const int r0j = row_of(off, rows, in0 ? j : j + 1, 0);
        Slot a = slot(in0 ? j : j + 1, r0j, first, off, cl, perm, nb);
        if (in0 && in1) {
          int r1j = r0j;
          if (r0j + 1 < rows && j + 1 >= off[r0j + 1])
            r1j = row_of(off, rows, j + 1, r0j + 1);
          Slot b = slot(j + 1, r1j, first, off, cl, perm, nb);
          *reinterpret_cast<longlong2*>(probe_idx + j) =
              make_longlong2(a.probe, b.probe);
          *reinterpret_cast<longlong2*>(build_idx + j) =
              make_longlong2(a.build, b.build);
          *reinterpret_cast<uchar2*>(is_match + j) =
              make_uchar2(a.match, b.match);
        } else {
          const long long q = in0 ? j : j + 1;
          probe_idx[q] = a.probe;
          build_idx[q] = a.build;
          is_match[q] = a.match;
        }
      }
    }
    __syncthreads();  // the next piece overwrites the staged rows
  }
}

}  // namespace

// split: int64 scratch of split_len >= ceil((n + total) / kPiece) + 1
// entries. probe_idx, build_idx and is_match must be 16-byte aligned
// (fresh allocations are). Returns a CUDA error code.
extern "C" int sail_join_expand(const void* offsets, const void* cnt,
                                const void* lo, long long n, long long total,
                                const void* perm, long long nb, void* split,
                                long long split_len, void* probe_idx,
                                void* build_idx, void* is_match,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long pieces = (n + total + kPiece - 1) / kPiece;
  if (split_len < pieces + 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long part_blocks = (pieces + 1 + 255) / 256;
  partition_kernel<<<(int)(part_blocks < 65535 ? part_blocks : 65535), 256, 0,
                     st>>>(static_cast<const long long*>(offsets), n, total,
                           pieces, static_cast<long long*>(split));
  long long grid = (long long)per_sm * sms;
  expand_kernel<<<(int)(pieces < grid ? pieces : grid), kThreads, 0, st>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(cnt),
      static_cast<const int*>(lo), n, total,
      static_cast<const long long*>(perm), nb,
      static_cast<const long long*>(split), pieces,
      static_cast<long long*>(probe_idx), static_cast<long long*>(build_idx),
      static_cast<unsigned char*>(is_match));
  return (int)cudaGetLastError();
}
