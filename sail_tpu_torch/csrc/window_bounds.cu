// K8: segment and peer-group bounds of a window's sorted rows, and the pack
// pass that makes the window's sort key.
//
// Replaces the arithmetic after the sort in sail_tpu/ops/window.py
// `build_window_context` (:52-78: segment flags, jax.ops.segment_min/max
// over n segments, the clip to the live rows) and `_peer_group_start`
// (:86) / `peer_group_end` (:127) (the same again for peer groups, a
// cumsum and two more segment reductions), and dense_rank's per-segment
// count of peer starts (:117). Both entry points read and write in sorted
// order or in row order only: nothing goes through the permutation.
//
// sail_window_pack: the sort key of keys that fit in 63 bits (a window's,
//   a sort's or a sorted grouping's, ops/sort.py), one non-negative int64
//   word a row: the dead bit (sel false) on top; below it, per key, most
//   significant first, the key's null rank (valid where nulls sort first,
//   !valid where they sort last; keys with a validity) above its K3 bits
//   minus their least value (`lo`, read by the wrapper: a window's over all
//   rows, a sort's over its live rows; a null row's bits as they are, or 0
//   where the key's flags ask for a canonical NULL, as a grouping's do).
//   With `dead_only` a dead row is the dead bit alone (its keys may lie
//   outside the live extremes). One stable sort of the word orders the
//   rows as the stable passes over (dead, null rank, bits, ...) do, and
//   its sorted values are K8's input.
// Bound: bytes, n * (8 B a key + 1 B a validity + 1 B sel + 8 B word),
//   each read and written once, in row order.
//
// sail_window_bounds: over m words in sorted order, each with a 64-bit
// partition mask and an optional validity in sorted order: the packed
// word with the mask of its dead bit and partition fields, or one K3 key
// a word (gathered into sorted order once), mask all ones for a partition
// key and 0 for an order key. For sorted position i < n_live (the live
// rows sort first; n_live is a device scalar, read on the card): a
// segment starts at i where (w[i] ^ w[i-1]) & mask != 0 for some word, or
// the validity of a word with a mask differs; a peer group where a
// segment starts or any word or validity differs. Equality of K3 keys is
// the reference's `d != prev & ~(isnan & isnan)` (NaNs folded into one,
// -0.0 into 0.0). Outputs, int32[n] over sorted positions:
//   seg_start, peer_start: the last start at or before i;
//   seg_end, peer_end: the first end at or after i, where i ends a
//     segment if i = n_live - 1 or a segment starts at i + 1;
//   dense: the peer starts of i's segment up to i.
// A dead row i gets seg_start = peer_start = peer_end = i, seg_end =
// n_live - 1 (an empty segment), dense 0: every row is written.
// Bound: bytes, n_live * 8 B a word (+ 1 B a validity) + n * 20 B of
//   outputs. The words are read in order.
// Design: two launches, each a single-pass scan with decoupled look-back
//   (as window_scan.cu's): a block takes the next tile of 2048 positions
//   in scan order from a counter, 8 consecutive positions a thread.
//   1. forward: the block stages each word of its tile and one halo
//      element before it in shared memory (coalesced), flags each
//      position (bit 0 segment start, bit 1 peer start), writes the flag
//      byte, and scans (last segment start, last peer start, peer starts
//      since the segment start) into seg_start, peer_start and dense;
//   2. backward, tiles from the end: from the flag bytes, a min-scan of
//      the ends into seg_end and peer_end.
//   A tile that holds a segment start (forward) or end (backward) is its
//   own inclusive prefix and publishes it at once, so a tile's look-back
//   stops at its segment's start; a tile of dead rows publishes nothing
//   to carry and writes the dead rows' bounds without reading a word.
//   Scratch: 2 + 12 ints a tile (counters and statuses, zeroed by a
//   memset, then the carries' fields).

#include <limits.h>

#include "window.cuh"

namespace {

using namespace sail::win;

constexpr int kBThreads = 256;
constexpr int kBItems = 8;
constexpr long long kBTile = kBThreads * kBItems;
constexpr unsigned char kSeg = 1, kPeer = 2;

// ---------------------------------------------------------------------------
// the pack pass
// ---------------------------------------------------------------------------

struct PackKeys {
  const long long* key[kMaxKeys];
  const bool* valid[kMaxKeys];  // null: the key has no validity
  long long lo[kMaxKeys];       // the key's least K3 bits over all rows
  int shift[kMaxKeys];          // where its bits - lo start
  int vshift[kMaxKeys];         // where its null rank goes
  int flags[kMaxKeys];           // bit 0: nulls first; bit 1: a null's
                                 // bits are packed as 0
  int m, dead_shift, dead_only;
};

__global__ void pack_kernel(PackKeys k, const bool* __restrict__ sel,
                            long long n, unsigned long long* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const bool live = sel[r];
    unsigned long long w = live ? 0ull : 1ull << k.dead_shift;
    if (live || !k.dead_only) {
      for (int j = 0; j < k.m; ++j) {
        const bool v = k.valid[j] == nullptr || k.valid[j][r];
        if (v || !(k.flags[j] & 2))
          w |= ((unsigned long long)k.key[j][r] -
                (unsigned long long)k.lo[j])
               << k.shift[j];
        if (k.valid[j] != nullptr)
          w |= (unsigned long long)((k.flags[j] & 1) ? v : !v)
               << k.vshift[j];
      }
    }
    out[r] = w;
  }
}

// ---------------------------------------------------------------------------
// the look-back of K8's two scans
// ---------------------------------------------------------------------------

// The carries: a few ints each, moved and stored a field at a time.
struct Fwd {  // forward: the starts and the dense count
  int s;      // the last segment start (-1: none)
  int p;      // the last peer-group start (-1: none)
  int v;      // peer starts since the last segment start
};
struct Bwd {  // backward: the ends
  int se;     // the first segment end (INT_MAX: none)
  int pe;     // the first peer-group end (INT_MAX: none)
};

struct FwdOp {  // a, then b: a segment start in b restarts the count
  __device__ __forceinline__ Fwd operator()(Fwd a, Fwd b) const {
    return {a.s > b.s ? a.s : b.s, a.p > b.p ? a.p : b.p,
            b.s >= 0 ? b.v : a.v + b.v};
  }
  __device__ static Fwd identity() { return {-1, -1, 0}; }
};
struct BwdOp {
  __device__ __forceinline__ Bwd operator()(Bwd a, Bwd b) const {
    return {a.se < b.se ? a.se : b.se, a.pe < b.pe ? a.pe : b.pe};
  }
  __device__ static Bwd identity() { return {INT_MAX, INT_MAX}; }
};

template <typename A>
__device__ __forceinline__ A shfl_fields(A x, int d, bool up) {
  constexpr int kN = sizeof(A) / sizeof(int);
  int f[kN];
  memcpy(f, &x, sizeof(A));
#pragma unroll
  for (int i = 0; i < kN; ++i)
    f[i] = up ? __shfl_up_sync(SAIL_FULL_MASK, f[i], d)
              : __shfl_down_sync(SAIL_FULL_MASK, f[i], d);
  memcpy(&x, f, sizeof(A));
  return x;
}

// window.cuh's block_exclusive_scan moves a carry between lanes by these
__device__ __forceinline__ Fwd shfl_up(Fwd x, int d) {
  return shfl_fields(x, d, true);
}
__device__ __forceinline__ Bwd shfl_up(Bwd x, int d) {
  return shfl_fields(x, d, true);
}

// A tile's status, in scan order: 0 until its block publishes its own
// aggregate (kAgg) or its inclusive prefix (kPre).
enum : unsigned { kAgg = 1, kPre = 2 };

template <typename A>
struct Look {
  unsigned* status;   // a word a tile
  unsigned* counter;  // the next tile, in scan order, to take
  int* agg;           // A's fields a tile: its own aggregate
  int* pre;           // and its inclusive prefix
};

template <typename A>
__device__ __forceinline__ void publish(const Look<A>& lb, long long d,
                                        unsigned status, A a) {
  constexpr int kN = sizeof(A) / sizeof(int);
  volatile int* q = (status == kPre ? lb.pre : lb.agg) + d * kN;
  int f[kN];
  memcpy(f, &a, sizeof(A));
#pragma unroll
  for (int i = 0; i < kN; ++i) q[i] = f[i];
  __threadfence();
  *reinterpret_cast<volatile unsigned*>(lb.status + d) = status;
}

template <typename A>
__device__ __forceinline__ A fetch(const int* arr, long long d) {
  constexpr int kN = sizeof(A) / sizeof(int);
  const volatile int* q = arr + d * kN;
  int f[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) f[i] = q[i];
  A a;
  memcpy(&a, f, sizeof(A));
  return a;
}

// Warp 0 of tile d (in scan order), whose own aggregate is `total`: the
// carry of the tiles before it. `whole`: the tile's inclusive prefix is
// its own aggregate, published at once. Reads the statuses of 32 tiles at
// a time, nearest first, and stops at the first that holds a prefix; the
// aggregates in between combine in scan order.
template <typename A, typename Op>
__device__ A look_back(const Look<A>& lb, long long d, A total, bool whole) {
  const Op op{};
  const int lane = threadIdx.x & 31;
  if (lane == 0) publish(lb, d, d == 0 || whole ? kPre : kAgg, total);
  if (d == 0) return Op::identity();
  A run = Op::identity();
  for (long long k = d - 1;; k -= 32) {
    const long long q = k - lane;
    unsigned s = kPre;  // before the first tile: nothing
    A x = Op::identity();
    if (q >= 0) {
      do {
        s = *reinterpret_cast<volatile unsigned*>(lb.status + q);
      } while (s == 0);
      __threadfence();
      x = fetch<A>(s == kPre ? lb.pre : lb.agg, q);
    }
    const unsigned stop = __ballot_sync(SAIL_FULL_MASK, s == kPre);
    const int last = stop ? __ffs(stop) - 1 : 31;
    if (lane > last) x = Op::identity();
    // lane 0 gets x[last] + ... + x[0]: the farther tile first
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const A y = shfl_fields(x, o, false);
      if (lane + o < 32) x = op(y, x);
    }
    run = op(x, run);
    if (stop) break;
  }
  if (lane == 0 && !whole) publish(lb, d, kPre, op(run, total));
  return run;
}

// ---------------------------------------------------------------------------
// the two scans
// ---------------------------------------------------------------------------

struct Words {
  const long long* w[kMaxKeys];   // sorted order
  unsigned long long mask[kMaxKeys];
  const bool* valid[kMaxKeys];    // sorted order; null: none
  int m;
};

__global__ void __launch_bounds__(kBThreads)
bounds_forward_kernel(Words k, const long long* __restrict__ n_live_p,
                      long long n, Look<Fwd> lb,
                      unsigned char* __restrict__ flags,
                      int* __restrict__ seg_start,
                      int* __restrict__ peer_start, int* __restrict__ dense) {
  __shared__ long long wsh[kBTile + 1];  // positions base - 1 .. base + 2047
  __shared__ bool vsh[kBTile + 1];
  __shared__ __align__(16) unsigned char fsh[kBTile];
  __shared__ long long tile_sh;
  __shared__ Fwd carry_sh;
  const FwdOp op{};
  if (threadIdx.x == 0) tile_sh = (long long)atomicAdd(lb.counter, 1u);
  __syncthreads();
  const long long d = tile_sh;
  const long long base = d * kBTile;
  const long long n_live = *n_live_p;
  if (base >= n_live) {  // dead rows only: nothing to read or carry
    if (threadIdx.x == 0) publish(lb, d, kPre, FwdOp::identity());
#pragma unroll
    for (int j = 0; j < kBItems; ++j) {
      const long long p = base + j * kBThreads + threadIdx.x;
      if (p < n) {
        seg_start[p] = (int)p;
        peer_start[p] = (int)p;
        dense[p] = 0;
        flags[p] = 0;
      }
    }
    return;
  }

  // flags of positions base + j * kBThreads + threadIdx.x, word by word
  unsigned char fl[kBItems] = {};
  for (int w = 0; w < k.m; ++w) {
    const long long* src = k.w[w];
    const bool* vs = k.valid[w];
    __syncthreads();  // the previous word's reads are done
    for (int q = threadIdx.x; q <= kBTile; q += kBThreads) {
      const long long p = base - 1 + q;
      const bool in = p >= 0 && p < n_live;
      wsh[q] = in ? src[p] : 0;
      if (vs != nullptr) vsh[q] = in && vs[p];
    }
    __syncthreads();
    const unsigned long long mask = k.mask[w];
#pragma unroll
    for (int j = 0; j < kBItems; ++j) {
      const int q = j * kBThreads + threadIdx.x;
      const unsigned long long x = (unsigned long long)(wsh[q + 1] ^ wsh[q]);
      const bool vd = vs != nullptr && vsh[q + 1] != vsh[q];
      if ((x & mask) != 0 || (vd && mask != 0))
        fl[j] |= kSeg | kPeer;
      else if (x != 0 || vd)
        fl[j] |= kPeer;
    }
  }
#pragma unroll
  for (int j = 0; j < kBItems; ++j) {
    const int q = j * kBThreads + threadIdx.x;
    const long long p = base + q;
    const unsigned char f = p < n_live ? (p == 0 ? kSeg | kPeer : fl[j]) : 0;
    fsh[q] = f;
    if (p < n) flags[p] = f;
  }
  __syncthreads();

  // the scan: thread c holds positions base + c * kBItems + [0, kBItems)
  const long long p0 = base + (long long)threadIdx.x * kBItems;
  unsigned char f8[kBItems];
  memcpy(f8, fsh + threadIdx.x * kBItems, kBItems);
  Fwd v[kBItems];
#pragma unroll
  for (int j = 0; j < kBItems; ++j) {
    const int p = (int)(p0 + j);
    v[j] = Fwd{(f8[j] & kSeg) ? p : -1, (f8[j] & kPeer) ? p : -1,
               (f8[j] & kPeer) ? 1 : 0};
  }
#pragma unroll
  for (int j = 1; j < kBItems; ++j) v[j] = op(v[j - 1], v[j]);
  Fwd total;
  const Fwd before = block_exclusive_scan<kBThreads>(
      v[kBItems - 1], FwdOp::identity(), op, &total);
  if (threadIdx.x < 32) {
    const Fwd carry = look_back<Fwd, FwdOp>(lb, d, total, total.s >= 0);
    if (threadIdx.x == 0) carry_sh = carry;
  }
  __syncthreads();
  const Fwd pre = op(carry_sh, before);
  int ss[kBItems], ps[kBItems], dn[kBItems];
#pragma unroll
  for (int j = 0; j < kBItems; ++j) {
    const long long p = p0 + j;
    const Fwd x = op(pre, v[j]);
    const bool live = p < n_live;
    ss[j] = live ? x.s : (int)p;
    ps[j] = live ? x.p : (int)p;
    dn[j] = live ? x.v : 0;
  }
  store_run(seg_start, p0, n, ss);
  store_run(peer_start, p0, n, ps);
  store_run(dense, p0, n, dn);
}

__global__ void __launch_bounds__(kBThreads)
bounds_backward_kernel(const long long* __restrict__ n_live_p, long long n,
                       const unsigned char* __restrict__ flags, Look<Bwd> lb,
                       long long tiles, int* __restrict__ seg_end,
                       int* __restrict__ peer_end) {
  __shared__ long long tile_sh;
  __shared__ Bwd carry_sh;
  const BwdOp op{};
  if (threadIdx.x == 0) tile_sh = (long long)atomicAdd(lb.counter, 1u);
  __syncthreads();
  const long long d = tile_sh;
  const long long base = (tiles - 1 - d) * kBTile;
  const long long n_live = *n_live_p;
  if (base >= n_live) {  // dead rows only
    if (threadIdx.x == 0) publish(lb, d, kPre, BwdOp::identity());
#pragma unroll
    for (int j = 0; j < kBItems; ++j) {
      const long long p = base + j * kBThreads + threadIdx.x;
      if (p < n) {
        seg_end[p] = (int)(n_live - 1);
        peer_end[p] = (int)p;
      }
    }
    return;
  }

  // thread c = 255 - threadIdx.x holds positions base + c * kBItems + [0,
  // kBItems): the threads run from the tile's end
  const int c = kBThreads - 1 - threadIdx.x;
  const long long p0 = base + (long long)c * kBItems;
  unsigned char f[kBItems];
  load_run(flags, p0, n, f, (unsigned char)0);
  const unsigned char after = p0 + kBItems < n ? flags[p0 + kBItems] : 0;
  Bwd v[kBItems];
#pragma unroll
  for (int j = 0; j < kBItems; ++j) {
    const long long r = p0 + j;
    const unsigned char next = j + 1 < kBItems ? f[j + 1] : after;
    const bool live = r < n_live, last = r == n_live - 1;
    v[j] = Bwd{live && (last || (next & kSeg)) ? (int)r : INT_MAX,
               live && (last || (next & kPeer)) ? (int)r : INT_MAX};
  }
#pragma unroll
  for (int j = kBItems - 2; j >= 0; --j) v[j] = op(v[j + 1], v[j]);
  Bwd total;
  const Bwd before = block_exclusive_scan<kBThreads>(
      v[0], BwdOp::identity(), op, &total);
  if (threadIdx.x < 32) {
    const Bwd carry = look_back<Bwd, BwdOp>(lb, d, total,
                                            total.se != INT_MAX);
    if (threadIdx.x == 0) carry_sh = carry;
  }
  __syncthreads();
  const Bwd pre = op(carry_sh, before);
  int se[kBItems], pe[kBItems];
#pragma unroll
  for (int j = 0; j < kBItems; ++j) {
    const long long r = p0 + j;
    const Bwd x = op(pre, v[j]);
    const bool live = r < n_live;
    se[j] = live ? x.se : (int)(n_live - 1);
    pe[j] = live ? x.pe : (int)r;
  }
  store_run(seg_end, p0, n, se);
  store_run(peer_end, p0, n, pe);
}

}  // namespace

// keys, valids: host arrays of m device pointers (valids' entries null for
// keys without a validity); lo, shift, vshift, flags: m each, on the host.
// out: n int64 words.
extern "C" int sail_window_pack(const void* const* keys,
                                const void* const* valids,
                                const long long* lo, const int* shift,
                                const int* vshift, const int* flags, int m,
                                int dead_shift, int dead_only,
                                const void* sel, long long n, void* out,
                                int grid, void* stream) {
  if (n <= 0) return 0;
  if (m < 0 || m > kMaxKeys || dead_shift < 0 || dead_shift > 62)
    return (int)cudaErrorInvalidValue;
  PackKeys k;
  for (int j = 0; j < kMaxKeys; ++j) {
    const bool used = j < m;
    k.key[j] = used ? static_cast<const long long*>(keys[j]) : nullptr;
    k.valid[j] = used ? static_cast<const bool*>(valids[j]) : nullptr;
    k.lo[j] = used ? lo[j] : 0;
    k.shift[j] = used ? shift[j] : 0;
    k.vshift[j] = used ? vshift[j] : 0;
    k.flags[j] = used ? flags[j] : 0;
  }
  k.m = m;
  k.dead_shift = dead_shift;
  k.dead_only = dead_only;
  pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const bool*>(sel), n,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

// words, valids: host arrays of m device pointers, sorted order (valids'
// entries null where a word has none); masks: m partition masks, on the
// host. flags: n bytes; scratch: 2 + 12 * ceil(n / 2048) ints.
extern "C" int sail_window_bounds(const void* n_live, long long n,
                                  const void* const* words,
                                  const unsigned long long* masks,
                                  const void* const* valids, int m,
                                  void* seg_start, void* seg_end,
                                  void* peer_start, void* peer_end,
                                  void* dense, void* flags, void* scratch,
                                  void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || m > kMaxKeys || n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Words k;
  for (int j = 0; j < kMaxKeys; ++j) {
    const bool used = j < m;
    k.w[j] = used ? static_cast<const long long*>(words[j]) : nullptr;
    k.mask[j] = used ? masks[j] : 0;
    k.valid[j] = used ? static_cast<const bool*>(valids[j]) : nullptr;
  }
  k.m = m;
  const long long tiles = (n + kBTile - 1) / kBTile;
  // [forward counter, backward counter, forward statuses, backward
  // statuses] (zeroed), then the forward carries (3 ints a tile, own and
  // prefix) and the backward ones (2)
  unsigned* u = static_cast<unsigned*>(scratch);
  int* fields = reinterpret_cast<int*>(u + 2 + 2 * tiles);
  Look<Fwd> fw{u + 2, u, fields, fields + 3 * tiles};
  Look<Bwd> bw{u + 2 + tiles, u + 1, fields + 6 * tiles,
               fields + 8 * tiles};
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 + 2 * tiles) * 4, s);
  if (err != cudaSuccess) return (int)err;
  const long long* nl = static_cast<const long long*>(n_live);
  unsigned char* f = static_cast<unsigned char*>(flags);
  bounds_forward_kernel<<<(unsigned)tiles, kBThreads, 0, s>>>(
      k, nl, n, fw, f, static_cast<int*>(seg_start),
      static_cast<int*>(peer_start), static_cast<int*>(dense));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bounds_backward_kernel<<<(unsigned)tiles, kBThreads, 0, s>>>(
      nl, n, f, bw, tiles, static_cast<int*>(seg_end),
      static_cast<int*>(peer_end));
  return (int)cudaGetLastError();
}
