// K8: segment and peer-group bounds of a window's sorted rows.
//
// Replaces the arithmetic after the sort in sail_tpu/ops/window.py
// `build_window_context` (:52-78: segment flags, jax.ops.segment_min/max
// over n segments, the clip to the live rows) and `_peer_group_start`
// (:86) / `peer_group_end` (:127) (the same again for peer groups, a
// cumsum and two more segment reductions), and dense_rank's per-segment
// count of peer starts (:117). No inverse permutation is built: later
// kernels write their outputs through perm.
//
// For sorted position i < n_live (the live rows sort first; n_live is a
// device scalar, read on the card): a segment starts at i where a
// partition key or its validity differs from position i - 1's, a peer
// group where a segment starts or an order key or its validity differs.
// Keys are K3 order keys (NaNs folded into one, -0.0 into 0.0), so
// equality of keys is the reference's `d != prev & ~(isnan & isnan)`.
// Outputs, int32[n] over sorted positions:
//   seg_start, peer_start: the last start at or before i (a max-scan);
//   seg_end, peer_end: the first end at or after i (a backward min-scan),
//     where i ends a segment if i = n_live - 1 or a segment starts at i+1;
//   dense: the peer starts of i's segment up to i (a segmented count).
// A dead row i gets seg_start = peer_start = peer_end = i, seg_end =
// n_live - 1 (an empty segment), dense 0: every row is written.
//
// Bound: bytes, n * (8 B perm + per key 8 B key + 1 B validity, gathered
// twice: row and neighbour) + 20 B of outputs. The gathers through perm
// are random where perm is; the rest streams.
// Design: four launches.
//   1. flags: one byte a row (bit 0 segment start, bit 1 peer start),
//      from the keys of perm[i] and perm[i - 1];
//   2. per tile of 1024 positions: the last segment and peer start, the
//      first segment and peer end, and the segmented count's aggregate;
//   3. one block scans those into each tile's carries (forward for the
//      starts and the count, backward for the ends);
//   4. per tile: the five scans from the carries, written once.
// Steps 2-4 are window.cuh's three-phase tile scan; the carries cross any
// number of tiles.

#include <limits.h>

#include "window.cuh"

namespace {

using namespace sail::win;

constexpr unsigned char kSegStart = 1, kPeerStart = 2;

struct Keys {
  const long long* key[kMaxKeys];
  const bool* valid[kMaxKeys];
  int n_part, n_order;
};

__device__ __forceinline__ bool differs(const Keys& k, int from, int to,
                                        long long a, long long b) {
  for (int j = from; j < to; ++j) {
    if (k.key[j][a] != k.key[j][b]) return true;
    if (k.valid[j] != nullptr && k.valid[j][a] != k.valid[j][b]) return true;
  }
  return false;
}

__global__ void bounds_flags_kernel(const long long* __restrict__ perm,
                                    const long long* __restrict__ n_live_p,
                                    long long n, Keys keys,
                                    unsigned char* __restrict__ flags) {
  const long long n_live = *n_live_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned char f = 0;
    if (i == 0 && n_live > 0) {
      f = kSegStart | kPeerStart;
    } else if (i < n_live) {
      long long a = perm[i], b = perm[i - 1];
      if (differs(keys, 0, keys.n_part, a, b))
        f = kSegStart | kPeerStart;
      else if (differs(keys, keys.n_part, keys.n_part + keys.n_order, a, b))
        f = kPeerStart;
    }
    flags[i] = f;
  }
}

// Row r's flags, 0 past the rows.
__device__ __forceinline__ unsigned char flag_at(
    const unsigned char* flags, long long r, long long n) {
  return r < n ? flags[r] : 0;
}

// r ends a segment (bit kSegStart) / a peer group (kPeerStart).
__device__ __forceinline__ bool ends(const unsigned char* flags, long long r,
                                     long long n, long long n_live,
                                     unsigned char bit) {
  return r < n_live && (r == n_live - 1 || (flag_at(flags, r + 1, n) & bit));
}

struct Tiles {  // views of the per-tile scratch (6 ints a tile)
  int *seg_last, *peer_last, *seg_end_first, *peer_end_first;
  Seg<int>* dense;
  __device__ Tiles(int* s, long long t)
      : seg_last(s), peer_last(s + t), seg_end_first(s + 2 * t),
        peer_end_first(s + 3 * t),
        dense(reinterpret_cast<Seg<int>*>(s + 4 * t)) {}
};

__global__ void __launch_bounds__(kThreads)
bounds_tiles_kernel(const long long* __restrict__ n_live_p, long long n,
                    const unsigned char* __restrict__ flags, int* scratch,
                    long long tiles) {
  const long long n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  int seg_last = -1, peer_last = -1, seg_end = INT_MAX, peer_end = INT_MAX;
  Seg<int> dense = {0, 0};
  for (int j = 0; j < kItems; ++j) {
    long long r = base + threadIdx.x * kItems + j;
    unsigned char f = r < n_live ? flags[r] : 0;
    if (f & kSegStart) seg_last = (int)r;
    if (f & kPeerStart) peer_last = (int)r;
    if (seg_end == INT_MAX && ends(flags, r, n, n_live, kSegStart))
      seg_end = (int)r;
    if (peer_end == INT_MAX && ends(flags, r, n, n_live, kPeerStart))
      peer_end = (int)r;
    dense = SegOp<Add>()(dense, Seg<int>{f & kSegStart, (f & kPeerStart) ? 1 : 0});
  }
  Tiles t(scratch, tiles);
  int total;
  block_exclusive_scan<kThreads>(seg_last, -1, Max(), &total);
  if (threadIdx.x == 0) t.seg_last[blockIdx.x] = total;
  block_exclusive_scan<kThreads>(peer_last, -1, Max(), &total);
  if (threadIdx.x == 0) t.peer_last[blockIdx.x] = total;
  block_exclusive_scan<kThreads>(seg_end, INT_MAX, Min(), &total);
  if (threadIdx.x == 0) t.seg_end_first[blockIdx.x] = total;
  block_exclusive_scan<kThreads>(peer_end, INT_MAX, Min(), &total);
  if (threadIdx.x == 0) t.peer_end_first[blockIdx.x] = total;
  Seg<int> dtotal;
  block_exclusive_scan<kThreads>(dense, Seg<int>{0, 0}, SegOp<Add>(),
                                 &dtotal);
  if (threadIdx.x == 0) t.dense[blockIdx.x] = dtotal;
}

__global__ void __launch_bounds__(kCarryThreads)
bounds_carry_kernel(int* scratch, long long tiles) {
  Tiles t(scratch, tiles);
  scan_carries(t.seg_last, tiles, -1, Max(), false);
  scan_carries(t.peer_last, tiles, -1, Max(), false);
  scan_carries(t.seg_end_first, tiles, INT_MAX, Min(), true);
  scan_carries(t.peer_end_first, tiles, INT_MAX, Min(), true);
  scan_carries(t.dense, tiles, Seg<int>{0, 0}, SegOp<Add>(), false);
}

__global__ void __launch_bounds__(kThreads)
bounds_finish_kernel(const long long* __restrict__ n_live_p, long long n,
                     const unsigned char* __restrict__ flags,
                     const int* scratch, long long tiles,
                     int* __restrict__ seg_start, int* __restrict__ seg_end,
                     int* __restrict__ peer_start,
                     int* __restrict__ peer_end, int* __restrict__ dense) {
  const long long n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kTile;
  Tiles t(const_cast<int*>(scratch), tiles);
  // forward: the starts and the dense count, positions in order
  int ss[kItems], ps[kItems];
  Seg<int> dn[kItems];
  for (int j = 0; j < kItems; ++j) {
    long long r = base + threadIdx.x * kItems + j;
    unsigned char f = r < n_live ? flags[r] : 0;
    ss[j] = (f & kSegStart) ? (int)r : -1;
    ps[j] = (f & kPeerStart) ? (int)r : -1;
    dn[j] = Seg<int>{f & kSegStart, (f & kPeerStart) ? 1 : 0};
  }
  tile_scan(ss, t.seg_last[blockIdx.x], -1, Max(), (int*)nullptr);
  tile_scan(ps, t.peer_last[blockIdx.x], -1, Max(), (int*)nullptr);
  tile_scan(dn, t.dense[blockIdx.x], Seg<int>{0, 0}, SegOp<Add>(),
            (Seg<int>*)nullptr);
  for (int j = 0; j < kItems; ++j) {
    long long r = base + threadIdx.x * kItems + j;
    if (r >= n) continue;
    bool live = r < n_live;
    seg_start[r] = live ? ss[j] : (int)r;
    peer_start[r] = live ? ps[j] : (int)r;
    dense[r] = live ? dn[j].v : 0;
  }
  // backward: the ends, positions from the tile's end
  int se[kItems], pe[kItems];
  for (int j = 0; j < kItems; ++j) {
    long long r = base + kTile - 1 - (threadIdx.x * kItems + j);
    se[j] = ends(flags, r, n, n_live, kSegStart) ? (int)r : INT_MAX;
    pe[j] = ends(flags, r, n, n_live, kPeerStart) ? (int)r : INT_MAX;
  }
  tile_scan(se, t.seg_end_first[blockIdx.x], INT_MAX, Min(), (int*)nullptr);
  tile_scan(pe, t.peer_end_first[blockIdx.x], INT_MAX, Min(),
            (int*)nullptr);
  for (int j = 0; j < kItems; ++j) {
    long long r = base + kTile - 1 - (threadIdx.x * kItems + j);
    if (r >= n) continue;
    bool live = r < n_live;
    seg_end[r] = live ? se[j] : (int)(n_live - 1);
    peer_end[r] = live ? pe[j] : (int)r;
  }
}

}  // namespace

// keys, valids: host arrays of kMaxKeys device pointers (valids' entries
// null where a key has no validity): the n_part partition keys, then the
// n_order order keys. scratch: 6 ints a tile of 1024 rows.
extern "C" int sail_window_bounds(const void* perm, const void* n_live,
                                  long long n, const void* const* keys,
                                  const void* const* valids, int n_part,
                                  int n_order, void* seg_start, void* seg_end,
                                  void* peer_start, void* peer_end,
                                  void* dense, void* flags, void* scratch,
                                  void* stream) {
  if (n <= 0) return 0;
  if (n_part < 0 || n_order < 0 || n_part + n_order > kMaxKeys ||
      n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Keys k;
  for (int j = 0; j < kMaxKeys; ++j) {
    bool used = j < n_part + n_order;
    k.key[j] = used ? static_cast<const long long*>(keys[j]) : nullptr;
    k.valid[j] = used ? static_cast<const bool*>(valids[j]) : nullptr;
  }
  k.n_part = n_part;
  k.n_order = n_order;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long* p = static_cast<const long long*>(perm);
  const long long* nl = static_cast<const long long*>(n_live);
  unsigned char* f = static_cast<unsigned char*>(flags);
  int* sc = static_cast<int*>(scratch);
  int grid = (int)(tiles < 132 * 16 ? tiles : 132 * 16);
  bounds_flags_kernel<<<grid, 256, 0, s>>>(p, nl, n, k, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bounds_tiles_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(nl, n, f, sc,
                                                          tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bounds_carry_kernel<<<1, kCarryThreads, 0, s>>>(sc, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bounds_finish_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      nl, n, f, sc, tiles, static_cast<int*>(seg_start),
      static_cast<int*>(seg_end), static_cast<int*>(peer_start),
      static_cast<int*>(peer_end), static_cast<int*>(dense));
  return (int)cudaGetLastError();
}
