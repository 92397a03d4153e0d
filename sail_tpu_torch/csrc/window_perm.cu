// Moving a window's columns between row order and its sorted order, once
// each: the context's inverse permutation, the gather of a value column
// (and its validity) into sorted order that the window functions then read,
// and the unpermute of each output back to row order. Only the live rows
// move: a window over a filtered input (a join's output, most rows dead)
// pays for its live rows.
//
// The inverse and the gather are one engine, a two-pass partitioned
// scatter, out[dest] = payload, templated on the payload:
//   sail_window_inverse replaces the reference's `inv_perm`
//     (sail_tpu/ops/window.py:78): inv[perm[i]] = i for the live sorted
//     positions i < n_live (a device scalar), -1 at the dead rows;
//   sail_window_gather replaces `framed_agg`'s value gathers (:219-220,
//     `value.data[ctx.perm]`) and those of `shift`, `nth` and first/last
//     (:169-204, :280-288): vals_s[inv[r]] = vals[r] and valid_s[inv[r]] =
//     valid[r] for the live rows r (inv[r] >= 0), 0 and false at the dead
//     positions: the gather vals_s[i] = vals[perm[i]] written as a scatter
//     from row order through the context's inv_perm. Values of 1, 2, 4 or
//     8 bytes, moved as bits; either column may be absent.
// A direct write of one 4-8 B word to a random place of a 240-480 MB array
// fills a part of a 32 B sector no other write in flight shares, so the
// memory reads and writes a whole sector a row. Instead, destinations are
// binned into buckets of consecutive positions, and each bucket is placed
// on chip:
//   1. bin_kernel reads 8,192 sources a block, in order. It counts them by
//      bucket, reserves its slots in each bucket with one atomic on the
//      bucket's cursor, sorts its (offset in the bucket | validity bit,
//      payload) records by bucket in shared memory and stores them in that
//      order: a warp writes runs of consecutive slots. Since perm is a
//      bijection a bucket of B positions receives at most B records, so
//      bucket b's run is slots [b * B, b * B + B) of one staging buffer:
//      no histogram pass.
//   2. place_kernel, a cluster of kCluster = 8 blocks a bucket, each block
//      holding one tile of it in shared memory (the wrapper sizes a tile,
//      ops/window.py MOVE_TILE_BYTES: 2^15 int32 in 128 KB), fills the
//      tiles with the fill value (-1 bits, or 0 and false), writes each of
//      the bucket's records into the tile that holds its position
//      (distributed shared memory: random, but on chip) and stores the
//      tiles in order. Every output is written once; no memset.
//   A bucket of eight tiles (2^18 positions for the inverse) keeps the
//   buckets few (229 at 60M rows), so a binning block's run in a bucket is
//   dozens of records and its sectors are written whole: with one tile a
//   bucket (eight times as many buckets) most runs were a part of one
//   sector, which L2 held part-written until it was evicted and merged.
//   Where the buckets outnumber kMaxGroup, pass 1 sweeps the sources once
//   a group of them.
// Bound: bytes. Inverse: n_live * 8 B perm read + n * 4 B written. Gather:
//   n * (4 B inv + value + 1 B validity) read + n * (value + 1 B) written.
//   The engine moves each record twice more (written, read: 8 B, or 16 B
//   for 8-byte values).
//
// sail_window_unpermute replaces `_unsort` (:82, `sorted[ctx.inv_perm]`):
//   a sorted-order result, plain words or window.cuh records {value, ok}
//   (8 B or 16 B), goes back to row order in one pass, value and validity
//   together: out[r] = src[inv[r]], and 0 and invalid where inv[r] < 0
//   (a dead row). A scatter of the record through perm writes two random
//   partial sectors a row: at 60M rows in a random order on an NVIDIA
//   H100 80GB HBM3 it took 8.730 ms against this gather's 2.178
//   (PERF.md, section 6).
// Bound: bytes, n * (4 B inv + value + 1 B validity) + n_live * record.
//   One random record (one sector) is read a live row; both outputs are
//   written in order.

#include <cooperative_groups.h>

#include "window.cuh"

namespace {

using namespace sail::win;
namespace cg = cooperative_groups;

constexpr int kPer = 4;  // positions a thread, kThreads (256) apart
constexpr int kSpan = kThreads * kPer;

// ---------------------------------------------------------------------------
// the partitioned scatter: the inverse and the gather
// ---------------------------------------------------------------------------

constexpr int kBinThreads = 1024;
constexpr int kBinItems = 8;  // a thread's sources
constexpr int kBinSpan = kBinThreads * kBinItems;  // a binning block's
constexpr int kMaxGroup = 2048;  // buckets a binning sweep counts
constexpr int kCluster = 8;  // placing blocks a bucket, one tile each
constexpr int kPlaceThreads = 1024;
constexpr int kPlaceUnroll = 4;  // records in flight a thread
constexpr int kMaxBits = 24;
// a block's tile: its values and validity (ops/window.py MOVE_TILE_MAX)
constexpr long long kMaxTileBytes = 200 * 1024;
constexpr unsigned kValidBit = 1u << 31;

// A staging record: the destination's offset in its bucket (below 2^27)
// with the validity in kValidBit, and the payload, in one 8 B or 16 B
// store.
template <typename P>
struct alignas(sizeof(P) >= 8 ? 16 : 8) Entry {
  unsigned key;
  P pay;
};

// bin_kernel's dynamic shared memory: the block's records in bucket order
// and each one's staging slot, then three words a bucket of the sweep.
template <typename P>
constexpr size_t bin_shared(int groups) {
  return (size_t)kBinSpan * (sizeof(Entry<P>) + sizeof(unsigned)) +
         3 * sizeof(unsigned) * groups;
}

// off[k] = cnt[0] + ... + cnt[k - 1] for k < groups (at most
// kMaxGroup / kBinThreads a thread); every thread calls it.
__device__ __forceinline__ void exclusive_scan(const unsigned* cnt,
                                               unsigned* off, int groups,
                                               unsigned* warp_sums) {
  constexpr int kPerThread = kMaxGroup / kBinThreads;
  const int k0 = threadIdx.x * kPerThread;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned own = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q)
    if (k0 + q < groups) own += cnt[k0 + q];
  unsigned x = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(SAIL_FULL_MASK, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = warp_sums[lane];
    unsigned z = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(SAIL_FULL_MASK, z, d);
      if (lane >= d) z += y;
    }
    warp_sums[lane] = z - w;
  }
  __syncthreads();
  unsigned run = warp_sums[warp] + x - own;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q)
    if (k0 + q < groups) {
      off[k0 + q] = run;
      run += cnt[k0 + q];
    }
}

// Pass 1, over buckets of 2^bits positions. kInverse: the sources are the
// sorted positions i < n_live, dest perm[i], payload i. Else the rows r <
// n with dest inv[r] >= 0, payload vals[r] and validity valid[r] (either
// may be null). Only the buckets [b0, b0 + groups) are binned in this
// sweep. A block takes kBinSpan sources: it counts them by bucket,
// reserves its slots in each bucket with one atomic on the bucket's
// cursor, sorts its records by bucket in shared memory and stores them in
// that order, so a warp writes runs of consecutive slots.
template <typename P, bool kInverse>
__global__ void __launch_bounds__(kBinThreads, 1)
bin_kernel(const long long* __restrict__ perm,
           const long long* __restrict__ n_live_p,
           const int* __restrict__ inv, long long n,
           const P* __restrict__ vals, const bool* __restrict__ valid,
           int bits, int b0, int groups, unsigned* __restrict__ cursor,
           Entry<P>* __restrict__ stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned warp_sums[32];
  Entry<P>* buf = reinterpret_cast<Entry<P>*>(smem);
  unsigned* slot_of = reinterpret_cast<unsigned*>(buf + kBinSpan);
  unsigned* cnt = slot_of + kBinSpan;  // the block's records a bucket
  unsigned* off = cnt + groups;        // their first place in buf
  unsigned* at = off + groups;         // their first slot in the bucket
  const long long count = kInverse ? *n_live_p : n;
  const long long first = (long long)blockIdx.x * kBinSpan;
  if (first >= count) return;
  for (int k = threadIdx.x; k < groups; k += kBinThreads) cnt[k] = 0;
  int d[kBinItems];
  P pay[kBinItems];
  unsigned vbits = 0;  // bit j: item j's validity
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    const long long i = first + threadIdx.x + j * kBinThreads;
    d[j] = -1;
    if (i < count) d[j] = kInverse ? (int)perm[i] : inv[i];
    if (d[j] >= 0 && (unsigned)((d[j] >> bits) - b0) >= (unsigned)groups)
      d[j] = -1;
    if constexpr (kInverse) {
      pay[j] = (P)i;
    } else {
      pay[j] = d[j] >= 0 && vals != nullptr ? vals[i] : P(0);
      if (d[j] >= 0 && valid != nullptr && valid[i]) vbits |= 1u << j;
    }
  }
  __syncthreads();
  unsigned rank[kBinItems];
#pragma unroll
  for (int j = 0; j < kBinItems; ++j)
    rank[j] = d[j] >= 0 ? atomicAdd(&cnt[(d[j] >> bits) - b0], 1u) : 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < groups; k += kBinThreads) {
    const unsigned c = cnt[k];
    if (c != 0) at[k] = atomicAdd(&cursor[b0 + k], c);
  }
  exclusive_scan(cnt, off, groups, warp_sums);
  __syncthreads();
  const unsigned mask = (1u << bits) - 1u;
#pragma unroll
  for (int j = 0; j < kBinItems; ++j) {
    if (d[j] < 0) continue;
    const int b = d[j] >> bits;
    const unsigned q = off[b - b0] + rank[j];
    Entry<P> e;
    e.key = ((unsigned)d[j] & mask) | ((vbits >> j & 1u) ? kValidBit : 0u);
    e.pay = pay[j];
    buf[q] = e;
    slot_of[q] = ((unsigned)b << bits) + at[b - b0] + rank[j];
  }
  __syncthreads();
  const unsigned m = off[groups - 1] + cnt[groups - 1];
  for (unsigned q = threadIdx.x; q < m; q += kBinThreads)
    stage[slot_of[q]] = buf[q];
}

// dst[0, bytes) = src[0, bytes): 16 B a thread, then the tail's bytes.
// dst is 16 B-aligned.
__device__ __forceinline__ void store_tile(unsigned char* __restrict__ dst,
                                           const unsigned char* src,
                                           int bytes) {
  const int whole = bytes / 16;
  for (int k = threadIdx.x; k < whole; k += kPlaceThreads)
    reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
  for (int k = whole * 16 + threadIdx.x; k < bytes; k += kPlaceThreads)
    dst[k] = src[k];
}

// Pass 2, a cluster of kCluster blocks a bucket: block r of the cluster
// holds the tile of the bucket's positions [r * 2^bits, (r + 1) * 2^bits),
// values (out given) then validity (valid_out given), in dynamic shared
// memory. Each block reads a share of the bucket's records and writes each
// into the tile of the block that holds its position (distributed shared
// memory); then each stores its tile in order.
template <typename P>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kPlaceThreads)
place_kernel(long long n, int bits, const unsigned* __restrict__ cursor,
             const Entry<P>* __restrict__ stage, unsigned fill,
             P* __restrict__ out, bool* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char tile[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  const long long bucket = blockIdx.x / kCluster;
  const int size = 1 << bits;
  const long long lo = (bucket * kCluster + me) << bits;
  const int vbytes = out != nullptr ? size * (int)sizeof(P) : 0;
  const int total = vbytes + (valid_out != nullptr ? size : 0);
  for (int k = threadIdx.x; k < total / 16; k += kPlaceThreads) {
    const unsigned w = k * 16 < vbytes ? fill : 0u;
    reinterpret_cast<uint4*>(tile)[k] = make_uint4(w, w, w, w);
  }
  cluster.sync();
  const int cnt = (int)cursor[bucket];
  const Entry<P>* run = stage + (bucket << (bits + 3));
  const unsigned mask = (unsigned)size - 1u;
  for (int s = me * kPlaceThreads + threadIdx.x; s < cnt;
       s += kCluster * kPlaceThreads * kPlaceUnroll) {
    Entry<P> e[kPlaceUnroll];
#pragma unroll
    for (int u = 0; u < kPlaceUnroll; ++u) {
      const int t = s + u * kCluster * kPlaceThreads;
      if (t < cnt) e[u] = run[t];
    }
#pragma unroll
    for (int u = 0; u < kPlaceUnroll; ++u) {
      if (s + u * kCluster * kPlaceThreads >= cnt) continue;
      const unsigned key = e[u].key & ~kValidBit;
      unsigned char* owner = cluster.map_shared_rank(tile, key >> bits);
      const unsigned k = key & mask;
      if (out != nullptr) reinterpret_cast<P*>(owner)[k] = e[u].pay;
      if (valid_out != nullptr)
        reinterpret_cast<bool*>(owner + vbytes)[k] =
            (e[u].key & kValidBit) != 0;
    }
  }
  cluster.sync();
  if (lo >= n) return;
  const int len = (int)(n - lo < size ? n - lo : size);
  if (out != nullptr)
    store_tile(reinterpret_cast<unsigned char*>(out + lo), tile,
               len * (int)sizeof(P));
  if (valid_out != nullptr)
    store_tile(reinterpret_cast<unsigned char*>(valid_out + lo),
               tile + vbytes, len);
}

// Both passes. bits: log2 of a placing block's tile; a bucket holds
// kCluster tiles. scratch (scratch_bytes): the cursors (one word a bucket,
// padded to 256 B), then each bucket's run of 2^(bits + 3) records.
template <typename P, bool kInverse>
cudaError_t scatter(const long long* perm, const long long* n_live,
                    const int* inv, long long n, const void* vals,
                    const bool* valid, void* out, bool* valid_out, int bits,
                    void* scratch, long long scratch_bytes, unsigned fill,
                    cudaStream_t s) {
  if (bits < 4 || bits > kMaxBits) return cudaErrorInvalidValue;
  const long long size = 1LL << bits;
  const long long tile = (out != nullptr ? size * (long long)sizeof(P) : 0) +
                         (valid_out != nullptr ? size : 0);
  if (tile > kMaxTileBytes) return cudaErrorInvalidValue;
  const int bucket_bits = bits + 3;  // kCluster tiles
  const long long buckets = (n + (1LL << bucket_bits) - 1) >> bucket_bits;
  const long long head = (buckets * 4 + 255) / 256 * 256;
  if (scratch_bytes <
      head + (buckets << bucket_bits) * (long long)sizeof(Entry<P>))
    return cudaErrorInvalidValue;
  unsigned* cursor = static_cast<unsigned*>(scratch);
  Entry<P>* stage =
      reinterpret_cast<Entry<P>*>(static_cast<char*>(scratch) + head);
  cudaError_t err = cudaMemsetAsync(cursor, 0, buckets * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  auto bin = bin_kernel<P, kInverse>;
  err = cudaFuncSetAttribute(bin, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bin_shared<P>(kMaxGroup));
  if (err != cudaSuccess) return err;
  const unsigned bin_blocks = (unsigned)((n + kBinSpan - 1) / kBinSpan);
  for (long long b0 = 0; b0 < buckets; b0 += kMaxGroup) {
    const int groups = (int)(buckets - b0 < kMaxGroup ? buckets - b0
                                                      : kMaxGroup);
    bin<<<bin_blocks, kBinThreads, bin_shared<P>(groups), s>>>(
        perm, n_live, inv, n, static_cast<const P*>(vals), valid,
        bucket_bits, (int)b0, groups, cursor, stage);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto place = place_kernel<P>;
  err = cudaFuncSetAttribute(
      place, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile);
  if (err != cudaSuccess) return err;
  place<<<(unsigned)(buckets * kCluster), kPlaceThreads, (size_t)tile, s>>>(
      n, bits, cursor, stage, fill, static_cast<P*>(out), valid_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the unpermute
// ---------------------------------------------------------------------------

// src: records {value, ok} when ok_out is set, else plain words
template <typename W>
__global__ void __launch_bounds__(kThreads)
unpermute_kernel(const int* __restrict__ inv, long long n,
                 const void* __restrict__ src, W* __restrict__ out,
                 bool* __restrict__ ok_out) {
  const long long base = (long long)blockIdx.x * kSpan + threadIdx.x;
  long long from[kPer];  // -1: a dead row, or past the end
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long r = base + j * kThreads;
    from[j] = r < n ? inv[r] : -1;
  }
  if (ok_out != nullptr) {
    const Rec<W>* rec = static_cast<const Rec<W>*>(src);
    Rec<W> v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = from[j] >= 0 ? rec[from[j]] : Rec<W>{0, 0};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long r = base + j * kThreads;
      if (r < n) {
        out[r] = v[j].v;
        ok_out[r] = v[j].ok != 0;
      }
    }
  } else {
    const W* words = static_cast<const W*>(src);
    W v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = from[j] >= 0 ? words[from[j]] : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long r = base + j * kThreads;
      if (r < n) out[r] = v[j];
    }
  }
}

unsigned blocks(long long n) { return (unsigned)((n + kSpan - 1) / kSpan); }

template <typename W>
cudaError_t unpermute(const int* inv, long long n, const void* src, void* out,
                      void* ok, cudaStream_t s) {
  unpermute_kernel<W><<<blocks(n), kThreads, 0, s>>>(
      inv, n, src, static_cast<W*>(out), static_cast<bool*>(ok));
  return cudaGetLastError();
}

}  // namespace

// inv: n int32 (n < 2^31); bits: log2 of a bucket's positions; scratch:
// 256 B-aligned, scratch_bytes of it, for the cursors and the staging
// runs of 8 B records (window.py _move_scratch).
extern "C" int sail_window_inverse(const void* perm, const void* n_live,
                                   long long n, void* inv, int bits,
                                   void* scratch, long long scratch_bytes,
                                   void* stream) {
  if (n <= 0) return 0;
  return (int)scatter<unsigned int, true>(
      static_cast<const long long*>(perm),
      static_cast<const long long*>(n_live), nullptr, n, nullptr, nullptr,
      inv, nullptr, bits, scratch, scratch_bytes, 0xffffffffu,
      static_cast<cudaStream_t>(stream));
}

// inv: n int32, -1 at a dead row; width: the value's bytes (1, 2, 4 or
// 8); vals or valid may be null (then its output is not written); scratch
// as for sail_window_inverse, with records of 16 B for 8-byte values.
extern "C" int sail_window_gather(const void* inv, long long n,
                                  const void* vals, int width,
                                  const void* valid, void* vals_s,
                                  void* valid_s, int bits, void* scratch,
                                  long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(inv);
  const bool* vd = static_cast<const bool*>(valid);
  bool* vs = static_cast<bool*>(valid_s);
#define SAIL_SCATTER(P)                                                  \
  scatter<P, false>(nullptr, nullptr, i, n, vals, vd, vals_s, vs, bits, \
                    scratch, scratch_bytes, 0u, s)
  switch (vals == nullptr ? 1 : width) {
    case 1: return (int)SAIL_SCATTER(unsigned char);
    case 2: return (int)SAIL_SCATTER(unsigned short);
    case 4: return (int)SAIL_SCATTER(unsigned int);
    case 8: return (int)SAIL_SCATTER(unsigned long long);
  }
#undef SAIL_SCATTER
  return (int)cudaErrorInvalidValue;
}

// inv: n int32 (-1 at a dead row); src: n records of 2 x width bytes
// when ok is set, else n words of width (4 or 8) bytes.
extern "C" int sail_window_unpermute(const void* inv, long long n,
                                     const void* src, int width, void* out,
                                     void* ok, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(inv);
  switch (width) {
    case 4: return (int)unpermute<unsigned int>(i, n, src, out, ok, s);
    case 8: return (int)unpermute<unsigned long long>(i, n, src, out, ok, s);
  }
  return (int)cudaErrorInvalidValue;
}
