// Moving a window's columns between row order and its sorted order, once
// each: the context's inverse permutation, the gather of a value column
// (and its validity) into sorted order that the window functions then read,
// and the unpermute of each output back to row order. Only the live rows
// move: a window over a filtered input (a join's output, most rows dead)
// pays for its live rows.
//
// All three are one engine, a two-pass partitioned scatter, out[dest] =
// payload, templated on its source: a functor that says whether the
// sources are the rows (each going to inv[r]) or the live sorted positions
// (each going to perm[i]) and what source i carries (a payload of 1, 2, 4
// or 8 bytes, moved as bits, and a validity bit):
//   sail_window_inverse replaces the reference's `inv_perm`
//     (sail_tpu/ops/window.py:78): inv[perm[i]] = i for the live sorted
//     positions i < n_live (a device scalar), -1 at the dead rows;
//   sail_window_gather replaces `framed_agg`'s value gathers (:219-220,
//     `value.data[ctx.perm]`) and those of `shift`, `nth` and first/last
//     (:169-204, :280-288): vals_s[inv[r]] = vals[r] and valid_s[inv[r]] =
//     valid[r] for the live rows r (inv[r] >= 0), 0 and false at the dead
//     positions: the gather vals_s[i] = vals[perm[i]] written as a scatter
//     from row order through the context's inv_perm. Either column may be
//     absent;
//   sail_window_unpermute replaces `_unsort` (:82, `sorted[ctx.inv_perm]`)
//     and, for lag/lead, `shift`'s shifted reads (:169): out[perm[i]] =
//     value i and ok_out[perm[i]] = its validity for the live sorted
//     positions i < n_live, 0 and invalid at the dead rows, from one of
//     three sources read in sorted order: window.cuh records {value, ok}
//     (K10's frame evaluation, K11); a value column and a bool column (or
//     none: plain words); or lag/lead's shift, value i - offset where that
//     position is in the row's segment (seg_start[i - offset] ==
//     seg_start[i]), else the default (valid) or 0 and invalid.
// A direct write of one 4-8 B word to a random place of a 240-480 MB array
// fills a part of a 32 B sector no other write in flight shares, so the
// memory reads and writes a whole sector a row; a gather of one reads a
// whole sector a row. Instead, destinations are binned into buckets of
// consecutive positions, and each bucket is placed on chip:
//   1. bin_kernel reads 8,192 sources a block, in order. It counts them by
//      bucket, reserves its slots in each bucket with one atomic on the
//      bucket's cursor, sorts its (offset in the bucket | validity bit,
//      payload) records by bucket in shared memory and stores them in that
//      order: a warp writes runs of consecutive slots. Since the
//      destinations are distinct, a bucket of B positions receives at most
//      B records, so bucket b's run is slots [b * B, b * B + B) of one
//      staging buffer: no histogram pass.
//   2. place_kernel, a cluster of kCluster = 8 blocks a bucket, each block
//      holding one tile of it in shared memory (the wrapper sizes a tile,
//      ops/window.py MOVE_TILE_BYTES: 2^15 int32 in 128 KB), fills the
//      tiles with the fill value (-1 bits, or 0 and false), writes each of
//      the bucket's records into the tile that holds its position
//      (distributed shared memory: random, but on chip; a value and its
//      validity side by side, one store) and stores the tiles in order.
//      Every output is written once; no memset. The distributed stores
//      bound the pass, so a record is one of them, not two (PERF.md,
//      section 6).
//   A bucket of eight tiles (2^18 positions for the inverse) keeps the
//   buckets few (229 at 60M rows), so a binning block's run in a bucket is
//   dozens of records and its sectors are written whole: with one tile a
//   bucket (eight times as many buckets) most runs were a part of one
//   sector, which L2 held part-written until it was evicted and merged.
//   Where the buckets outnumber kMaxGroup, pass 1 sweeps the sources once
//   a group of them.
// Bound: bytes. Inverse: n_live * 8 B perm read + n * 4 B written. Gather:
//   n * (4 B inv + value + 1 B validity) read + n * (value + 1 B) written.
//   Unpermute: n * (value + 1 B) written + n_live * the source (a record;
//   a value and its validity; a shift's value, validity and segment start)
//   read, and the destinations, which PERF.md counts as n * 4 B of inv.
//   The engine reads 8 B of perm a live row (4 B of inv a row for the
//   gather) and moves each record twice more (written, read: 8 B, or 16 B
//   for 8-byte values).

#include <cooperative_groups.h>

#include "window.cuh"

namespace {

using namespace sail::win;
namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// the partitioned scatter: the inverse, the gather and the unpermute
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

// The sources of pass 1. kLive: the sources are the sorted positions i <
// n_live (a device scalar), source i goes to perm[i]; else they are the
// rows r < n, row r goes to inv[r] (-1: a dead row, nowhere). load: the
// source's payload and validity bit, from what pass 1 reads (vals,
// valid, seg_start: bin_kernel's parameters, restrict-qualified there;
// held in a functor, the pointers lose that), given whether it is a
// source (in) and whether its destination is in the sweep (dest_ok). Its
// reads are selects on those flags, not branches around the call: so
// the pass issues every item's reads before it waits for any (a branch
// a read serialised them, and the pass ran slower).

// the inverse: sorted position i carries i
struct InverseSrc {
  static constexpr bool kLive = true;
  template <typename P>
  __device__ __forceinline__ bool load(const void*, const bool*, const int*,
                                       long long i, bool, bool,
                                       P& pay) const {
    pay = (P)i;
    return false;
  }
};

// the gather: row r carries vals[r] and valid[r] (either may be null); a
// dead row's are not read
struct GatherSrc {
  static constexpr bool kLive = false;
  template <typename P>
  __device__ __forceinline__ bool load(const void* vals, const bool* valid,
                                       const int*, long long r, bool,
                                       bool dest_ok, P& pay) const {
    pay = dest_ok && vals != nullptr ? static_cast<const P*>(vals)[r] : P(0);
    return dest_ok && valid != nullptr && valid[r];
  }
};

// The unpermute's sources, each read at position i (or i - offset)
// whatever the sweep: the reads are in order, and issuing them beside
// perm's keeps both in flight.

// window.cuh records {value, ok} of 4- or 8-byte values, one load each
struct RecordSrc {
  static constexpr bool kLive = true;
  template <typename P>
  __device__ __forceinline__ bool load(const void* vals, const bool*,
                                       const int*, long long i, bool in,
                                       bool, P& pay) const {
    const Rec<P> r = in ? static_cast<const Rec<P>*>(vals)[i] : Rec<P>{0, 0};
    pay = r.v;
    return r.ok != 0;
  }
};

// a value column and its validity (null: every value valid, or no
// validity written)
struct ArraySrc {
  static constexpr bool kLive = true;
  template <typename P>
  __device__ __forceinline__ bool load(const void* vals, const bool* valid,
                                       const int*, long long i, bool in,
                                       bool, P& pay) const {
    pay = in ? static_cast<const P*>(vals)[i] : P(0);
    return in && (valid == nullptr || valid[i]);
  }
};

// lag (offset > 0) and lead (offset < 0): the value and validity at i -
// offset where that position holds a row of i's segment (a dead row's
// segment starts at itself, so no live row reaches one), else the default
// (fill bits, valid) where there is one, or 0 and invalid
struct ShiftSrc {
  static constexpr bool kLive = true;
  long long n, offset;
  unsigned long long fill;
  bool has_default;
  template <typename P>
  __device__ __forceinline__ bool load(const void* vals, const bool* valid,
                                       const int* seg_start, long long i,
                                       bool in, bool, P& pay) const {
    const long long j = i - offset;
    const bool inside = in && j >= 0 && j < n;
    const P v = inside ? static_cast<const P*>(vals)[j] : P(0);
    const bool ok = inside && (valid == nullptr || valid[j]);
    const bool same = inside && seg_start[j] == seg_start[i];
    pay = same ? v : has_default ? (P)fill : P(0);
    return same ? ok : has_default;
  }
};

// Pass 1, over buckets of 2^bits positions: the sources with a
// destination in the buckets [b0, b0 + groups) of this sweep. A block
// takes kBinSpan sources: it counts them by bucket, reserves its slots in
// each bucket with one atomic on the bucket's cursor, sorts its records by
// bucket in shared memory and stores them in that order, so a warp writes
// runs of consecutive slots.
template <typename P, typename Src>
__global__ void __launch_bounds__(kBinThreads, 1)
bin_kernel(const Src src, const long long* __restrict__ perm,
           const long long* __restrict__ n_live_p,
           const int* __restrict__ inv, const void* __restrict__ vals,
           const bool* __restrict__ valid,
           const int* __restrict__ seg_start, long long n, int bits, int b0,
           int groups, unsigned* __restrict__ cursor,
           Entry<P>* __restrict__ stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned warp_sums[32];
  Entry<P>* buf = reinterpret_cast<Entry<P>*>(smem);
  unsigned* slot_of = reinterpret_cast<unsigned*>(buf + kBinSpan);
  unsigned* cnt = slot_of + kBinSpan;  // the block's records a bucket
  unsigned* off = cnt + groups;        // their first place in buf
  unsigned* at = off + groups;         // their first slot in the bucket
  const long long count = Src::kLive ? *n_live_p : n;
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
    if (i < count) d[j] = Src::kLive ? (int)perm[i] : inv[i];
    if (d[j] >= 0 && (unsigned)((d[j] >> bits) - b0) >= (unsigned)groups)
      d[j] = -1;
    if (src.load(vals, valid, seg_start, i, i < count, d[j] >= 0, pay[j]))
      vbits |= 1u << j;
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

// A tile's position where both a value and its validity are written:
// the two side by side, so one shared-memory store (distributed: most go
// to another block of the cluster) places a record.
template <typename P>
struct alignas(2 * sizeof(P)) Slot {
  P v;
  P ok;
};

// A tile's bytes a position: a value, a validity, or both (a Slot).
template <typename P>
__host__ __device__ constexpr int slot_bytes(bool values, bool valid) {
  return values && valid ? (int)sizeof(Slot<P>) : values ? (int)sizeof(P) : 1;
}

// Pass 2, a cluster of kCluster blocks a bucket: block r of the cluster
// holds the tile of the bucket's positions [r * 2^bits, (r + 1) * 2^bits)
// in dynamic shared memory: values (out given), validity (valid_out
// given), or Slots of both (then fill is 0). Each block reads a share of
// the bucket's records and writes each into the tile of the block that
// holds its position (distributed shared memory); then each stores its
// tile in order, a Slot's value and validity to their two columns.
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
  const bool both = out != nullptr && valid_out != nullptr;
  const int total = size * slot_bytes<P>(out != nullptr, valid_out != nullptr);
  const unsigned w = out != nullptr && !both ? fill : 0u;
  for (int k = threadIdx.x; k < total / 16; k += kPlaceThreads)
    reinterpret_cast<uint4*>(tile)[k] = make_uint4(w, w, w, w);
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
      const bool ok = (e[u].key & kValidBit) != 0;
      if (both)
        reinterpret_cast<Slot<P>*>(owner)[k] = Slot<P>{e[u].pay, P(ok)};
      else if (out != nullptr)
        reinterpret_cast<P*>(owner)[k] = e[u].pay;
      else
        reinterpret_cast<bool*>(owner)[k] = ok;
    }
  }
  cluster.sync();
  if (lo >= n) return;
  const int len = (int)(n - lo < size ? n - lo : size);
  if (both) {
    const Slot<P>* slots = reinterpret_cast<const Slot<P>*>(tile);
    for (int k = threadIdx.x; k < len; k += kPlaceThreads) {
      const Slot<P> r = slots[k];
      out[lo + k] = r.v;
      valid_out[lo + k] = r.ok != 0;
    }
  } else if (out != nullptr) {
    store_tile(reinterpret_cast<unsigned char*>(out + lo), tile,
               len * (int)sizeof(P));
  } else {
    store_tile(reinterpret_cast<unsigned char*>(valid_out + lo), tile, len);
  }
}

// Both passes. bits: log2 of a placing block's tile; a bucket holds
// kCluster tiles. scratch (scratch_bytes): the cursors (one word a bucket,
// padded to 256 B), then each bucket's run of 2^(bits + 3) records.
template <typename P, typename Src>
cudaError_t scatter(const Src& src, const long long* perm,
                    const long long* n_live, const int* inv,
                    const void* vals, const bool* valid,
                    const int* seg_start, long long n, void* out,
                    bool* valid_out, int bits, void* scratch,
                    long long scratch_bytes, unsigned fill, cudaStream_t s) {
  if (bits < 4 || bits > kMaxBits) return cudaErrorInvalidValue;
  const long long size = 1LL << bits;
  const long long tile =
      size * slot_bytes<P>(out != nullptr, valid_out != nullptr);
  if (tile > kMaxTileBytes || (out != nullptr && valid_out != nullptr &&
                               fill != 0u))
    return cudaErrorInvalidValue;
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
  auto bin = bin_kernel<P, Src>;
  err = cudaFuncSetAttribute(bin, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bin_shared<P>(kMaxGroup));
  if (err != cudaSuccess) return err;
  const unsigned bin_blocks = (unsigned)((n + kBinSpan - 1) / kBinSpan);
  for (long long b0 = 0; b0 < buckets; b0 += kMaxGroup) {
    const int groups = (int)(buckets - b0 < kMaxGroup ? buckets - b0
                                                      : kMaxGroup);
    bin<<<bin_blocks, kBinThreads, bin_shared<P>(groups), s>>>(
        src, perm, n_live, inv, vals, valid, seg_start, n, bucket_bits,
        (int)b0, groups, cursor, stage);
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

// the unpermute's sources (ops/window.py _UNPERMUTE_KINDS)
enum Kind { kRecords = 0, kArrays = 1, kShift = 2 };

template <typename P>
cudaError_t unpermute(const long long* perm, const long long* n_live,
                      long long n, int kind, const void* src, const bool* ok,
                      const int* seg_start, long long offset,
                      int has_default, unsigned long long default_bits,
                      void* out, bool* ok_out, int bits, void* scratch,
                      long long scratch_bytes, cudaStream_t s) {
#define SAIL_TO_ROWS(SRC, SEG)                                              \
  scatter<P>(SRC, perm, n_live, nullptr, src, ok, SEG, n, out, ok_out, bits, \
             scratch, scratch_bytes, 0u, s)
  switch (kind) {
    case kRecords:
      if constexpr (sizeof(P) >= 4) return SAIL_TO_ROWS(RecordSrc{}, nullptr);
      return cudaErrorInvalidValue;  // records of 4- or 8-byte values only
    case kArrays: return SAIL_TO_ROWS(ArraySrc{}, nullptr);
    case kShift:
      if (seg_start == nullptr) return cudaErrorInvalidValue;
      return SAIL_TO_ROWS(
          (ShiftSrc{n, offset, default_bits, has_default != 0}), seg_start);
  }
#undef SAIL_TO_ROWS
  return cudaErrorInvalidValue;
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
  return (int)scatter<unsigned int>(
      InverseSrc{}, static_cast<const long long*>(perm),
      static_cast<const long long*>(n_live), nullptr, nullptr, nullptr,
      nullptr, n, inv, nullptr, bits, scratch, scratch_bytes, 0xffffffffu,
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
  scatter<P>(GatherSrc{}, nullptr, nullptr, i, vals, vd, nullptr, n, vals_s, \
             vs, bits, scratch, scratch_bytes, 0u, s)
  switch (vals == nullptr ? 1 : width) {
    case 1: return (int)SAIL_SCATTER(unsigned char);
    case 2: return (int)SAIL_SCATTER(unsigned short);
    case 4: return (int)SAIL_SCATTER(unsigned int);
    case 8: return (int)SAIL_SCATTER(unsigned long long);
  }
#undef SAIL_SCATTER
  return (int)cudaErrorInvalidValue;
}

// perm: n int64, the live rows' first (n_live, a device int64); kind:
// kRecords (src: n window.cuh records of 2 x width bytes, width 4 or 8;
// ok unused), kArrays (src: n values of width 1, 2, 4 or 8 bytes; ok: n
// bools or null) or kShift (as kArrays, with seg_start: n int32, offset,
// and the default's bits where has_default); ok_out may be null (plain
// words: no validity written); scratch as for sail_window_gather.
extern "C" int sail_window_unpermute(
    const void* perm, const void* n_live, long long n, int kind,
    const void* src, int width, const void* ok, const void* seg_start,
    long long offset, int has_default, unsigned long long default_bits,
    void* out, void* ok_out, int bits, void* scratch,
    long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(perm);
  const long long* nl = static_cast<const long long*>(n_live);
  bool* oo = static_cast<bool*>(ok_out);
  const bool* o = static_cast<const bool*>(ok);
  const int* ss = static_cast<const int*>(seg_start);
#define SAIL_UNPERMUTE(P)                                                  \
  unpermute<P>(p, nl, n, kind, src, o, ss, offset, has_default,           \
               default_bits, out, oo, bits, scratch, scratch_bytes, s)
  switch (width) {
    case 1: return (int)SAIL_UNPERMUTE(unsigned char);
    case 2: return (int)SAIL_UNPERMUTE(unsigned short);
    case 4: return (int)SAIL_UNPERMUTE(unsigned int);
    case 8: return (int)SAIL_UNPERMUTE(unsigned long long);
  }
#undef SAIL_UNPERMUTE
  return (int)cudaErrorInvalidValue;
}
