// K1: segmented reduction, out[s] = op over the rows of segment s.
//
// Replaces sail_tpu/ops/aggregate.py `_seg_reduce` (jax.ops.segment_sum /
// segment_min / segment_max, which XLA lowers to a scatter) as the
// aggregates use it. Two entry points, one for each way the port groups
// rows; the grouping mode picks one, nothing else does.
//
// int sums wrap in two's complement (exact in any order); float64 min/max
// propagate NaN, as XLA's min/max do. An empty segment holds the identity
// (0, or the type's extreme).
//
// sail_seg_reduce: the binned entry point, for direct (K2) and keyless
// grouping, where a row's id is its bin and rows come in input order.
//   out[s] = op over { vals[i] : seg[i] == s, valid[i] }, ids outside
//   [0, S) dropped (as XLA drops them) before the value is loaded; the
//   caller fills `out` with the identity. S is at most 4097 (direct
//   grouping makes at most 4096 bins, keyless one); a larger S is refused
//   with cudaErrorInvalidValue: sort-based grouping, where S is the row
//   count, reduces through the runs entry point.
// Bound: bytes, n * 4 (ids) + live rows * value width + S * width. Q1
// sends 60M rows into 12 bins, so atomics on a dozen addresses are the
// hazard, not the arithmetic:
//   * a warp first combines the lanes that share an id (__match_any_sync
//     + a shuffle tree), so one lane per distinct id issues an atomic;
//   * each block keeps private accumulators in shared memory (4097 x 8 B
//     = 32 KB) and merges them into `out` with one global atomic per
//     touched bin when it finishes.
// float64 sums use atomicAdd(double), whose order varies between runs;
// float64 min/max are a CAS loop.
//
// sail_seg_reduce_runs: the runs entry point, for sort-based grouping.
//   For i < n_live: out[ids[i]] = op over value(perm[i]) and
//   count[ids[i]] = the number of rows that contributed, where value(p)
//   is vals[p] (or p itself when there are no vals: first/last and the
//   group keys' first row), skipped where valid[p] is false. ids is the
//   grouping's sorted id column: non-decreasing and dense in
//   [0, num_groups) over the live prefix, dead rows after it. n_live is a
//   device scalar, read on the card (no host sync). Slots from num_groups
//   (ids[n_live - 1] + 1) to S get the identity and a count of 0, so every
//   slot is written once and the caller allocates without filling; groups
//   at or past S are dropped, as the binned entry point drops its ids.
// Bound: bytes, live rows * (4 B id + 8 B perm + value width, + 1 B
// validity) + S * (width + 8 B count). Dead rows are never read, and no
// atomic is issued: binned atomics would put every dead row on one hot
// address and every live row of a sorted grouping on a random one. Where
// perm is random (every row live, grouped on a key unrelated to the row
// order), each value read is a random 8-byte load that costs a whole
// memory sector: the gather, not the bytes above, then holds the kernel
// (chip_smoke.py times the gather alone beside it).
// Design:
//   * A persistent grid; each block takes a contiguous range of 1024-row
//     tiles of the live prefix (the range split is computed on the card
//     from n_live). A thread takes 4 consecutive rows: one 16-byte load of
//     ids and two of perm, streamed past the caches; only vals and valid
//     are gathered, and only for live rows.
//   * A thread reduces its 4 rows to its runs. A run that begins and ends
//     inside the thread is stored at once. The first and last runs enter a
//     block-wide segmented scan: shuffles within a warp, the 8 warps'
//     totals through shared memory. The thread where a run ends stores it
//     with a plain store: ids are dense and sorted, so a tile's runs are
//     consecutive slots. The block's last run carries into its next tile.
//   * Only the block's first and last runs may continue in another block.
//     They go to two records a block; a second launch, one block, runs the
//     same segmented reduction over the records in order and stores those
//     runs. No atomics: float64 sums come out the same in every run on a
//     card (the order depends only on the grid, which depends on n and the
//     card's SM count).

#include <type_traits>

#include "common.cuh"

namespace {

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ double canonical_nan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <int K>
struct Combine {
  __device__ __forceinline__ int operator()(int a, int b) const {
    if (K == kSum) return (int)((unsigned)a + (unsigned)b);
    if (K == kMin) return a < b ? a : b;
    return a > b ? a : b;
  }
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    if (K == kSum)
      return (long long)((unsigned long long)a + (unsigned long long)b);
    if (K == kMin) return a < b ? a : b;
    return a > b ? a : b;
  }
  __device__ __forceinline__ double operator()(double a, double b) const {
    if (K == kSum) return a + b;
    if (isnan(a) || isnan(b)) return canonical_nan();
    if (K == kMin) return a < b ? a : b;
    return a > b ? a : b;
  }
};

// ---------------------------------------------------------------------------
// binned
// ---------------------------------------------------------------------------

template <int K>
__device__ __forceinline__ void atomic_combine(int* addr, int v) {
  if (K == kSum) atomicAdd(addr, v);
  else if (K == kMin) atomicMin(addr, v);
  else atomicMax(addr, v);
}

template <int K>
__device__ __forceinline__ void atomic_combine(long long* addr, long long v) {
  if (K == kSum)
    atomicAdd(reinterpret_cast<unsigned long long*>(addr),
              (unsigned long long)v);
  else if (K == kMin) atomicMin(addr, v);
  else atomicMax(addr, v);
}

template <int K>
__device__ __forceinline__ void atomic_combine(double* addr, double v) {
  if (K == kSum) {
    atomicAdd(addr, v);
    return;
  }
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a, assumed;
  do {
    assumed = old;
    double next = Combine<K>()(__longlong_as_double((long long)assumed), v);
    unsigned long long bits = (unsigned long long)__double_as_longlong(next);
    if (bits == assumed) return;
    old = atomicCAS(a, assumed, bits);
  } while (old != assumed);
}

template <typename T, int K>
__global__ void seg_reduce_kernel(const T* __restrict__ vals,
                                  const int* __restrict__ seg,
                                  const bool* __restrict__ valid, long long n,
                                  int num_segments, T identity,
                                  T* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x)
    acc[s] = identity;
  __syncthreads();
  sail::WarpLoop loop;
  Combine<K> op;
  for (long long base = loop.first; base < n; base += loop.stride) {
    long long i = base + loop.lane;
    int key = -1;
    T v = identity;
    if (i < n) {
      int s = seg[i];
      if (s >= 0 && s < num_segments && (valid == nullptr || valid[i])) {
        key = s;
        v = vals[i];
      }
    }
    unsigned peers = __match_any_sync(SAIL_FULL_MASK, key);
    v = sail::reduce_peers(peers, v, loop.lane, op);
    if (key >= 0 && loop.lane == __ffs(peers) - 1)
      atomic_combine<K>(&acc[key], v);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) {
    T a = acc[s];
    if (!(a == identity)) atomic_combine<K>(&out[s], a);
  }
}

constexpr int kBinnedMax = 4097;  // bins in shared memory: 4097 x 8 B

template <typename T, int K>
cudaError_t launch_binned(const void* vals, const int* seg, const bool* valid,
                          long long n, int num_segments, T identity,
                          void* out, int grid, cudaStream_t stream) {
  if (num_segments > kBinnedMax) return cudaErrorInvalidValue;
  const int block = 256;
  size_t smem = (size_t)num_segments * sizeof(T);
  seg_reduce_kernel<T, K><<<grid, block, smem, stream>>>(
      static_cast<const T*>(vals), seg, valid, n, num_segments, identity,
      static_cast<T*>(out));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// runs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                  // consecutive rows a thread
constexpr int kTile = kThreads * kRows;   // rows a block takes at a time
static_assert(kRows % 4 == 0, "rows come in 16-byte vectors of 4 ids");

// a partial aggregate: the combined value and the rows that contributed
template <typename T>
struct Part {
  T acc;
  long long cnt;
};

template <typename T, int K>
__device__ __forceinline__ Part<T> merge(const Part<T>& a, const Part<T>& b) {
  return {Combine<K>()(a.acc, b.acc), a.cnt + b.cnt};
}

template <typename T>
__device__ __forceinline__ Part<T> shfl_up(const Part<T>& p, int delta) {
  return {__shfl_up_sync(SAIL_FULL_MASK, p.acc, delta),
          __shfl_up_sync(SAIL_FULL_MASK, p.cnt, delta)};
}

template <typename T>
struct TileShared {
  int head_key[kThreads];  // key of each thread's first row (-1: no rows)
  int tail_key[kThreads];  // key of each thread's last row
  Part<T> warp_part[kWarps];
  int warp_flag[kWarps];
  int carry_key;           // the run that continues into the next tile
  Part<T> carry;
};

// Where a finished run goes. In the first pass the block's first run
// (key first_key), which may have begun in an earlier block, goes to the
// block's head record; every other run that ends in the range is complete
// and is stored. The second pass stores every run. A key at or past
// num_segments is dropped.
template <typename T>
struct Sink {
  T* out;
  long long* count;
  int num_segments;
  int first_key;  // -1 in the second pass
  int* rec_key;
  T* rec_acc;
  long long* rec_cnt;
  int slot;

  __device__ __forceinline__ void emit(int key, const Part<T>& p) const {
    if (key == first_key) {
      rec_key[slot] = key;
      rec_acc[slot] = p.acc;
      rec_cnt[slot] = p.cnt;
      return;
    }
    if (key >= num_segments) return;
    if (out != nullptr) out[key] = p.acc;
    if (count != nullptr) count[key] = p.cnt;
  }
};

// The first pass's rows: the key from ids, the value gathered through perm.
template <typename T>
struct RowSource {
  const int* ids;
  const long long* perm;
  const T* vals;
  const bool* valid;
  bool need_perm;  // false: a count of rows, no value or validity

  __device__ __forceinline__ void load(long long row0, int nrows,
                                       int (&key)[kRows],
                                       Part<T> (&part)[kRows],
                                       T identity) const {
    long long p[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) p[j] = 0;
    if (nrows == kRows) {
#pragma unroll
      for (int j = 0; j < kRows; j += 4) {
        int4 k = __ldcs(reinterpret_cast<const int4*>(ids + row0 + j));
        key[j] = k.x;
        key[j + 1] = k.y;
        key[j + 2] = k.z;
        key[j + 3] = k.w;
      }
      if (need_perm) {
#pragma unroll
        for (int j = 0; j < kRows; j += 2) {
          longlong2 a =
              __ldcs(reinterpret_cast<const longlong2*>(perm + row0 + j));
          p[j] = a.x;
          p[j + 1] = a.y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < nrows) {
          key[j] = ids[row0 + j];
          if (need_perm) p[j] = perm[row0 + j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      part[j] = {identity, 0};
      if (j >= nrows) continue;
      if (!need_perm) {
        part[j].cnt = 1;
        continue;
      }
      bool ok = valid == nullptr || valid[p[j]];
      T v;
      if constexpr (std::is_same<T, long long>::value)
        v = vals == nullptr ? p[j] : vals[p[j]];
      else
        v = vals[p[j]];
      if (ok) part[j] = {v, 1};
    }
  }
};

// The second pass's rows: the first pass's records.
template <typename T>
struct RecordSource {
  const int* key;
  const T* acc;
  const long long* cnt;

  __device__ __forceinline__ void load(long long row0, int nrows,
                                       int (&k)[kRows],
                                       Part<T> (&part)[kRows],
                                       T identity) const {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      part[j] = {identity, 0};
      if (j < nrows) {
        k[j] = key[row0 + j];
        part[j] = {acc[row0 + j], cnt[row0 + j]};
      }
    }
  }
};

// Reduce rows [begin, end) of `src`, whose keys are sorted, emitting every
// run that ends before `end`; the last run is left in sh.carry_key /
// sh.carry. first_key must be the key of row `begin`.
template <typename T, int K, typename Source>
__device__ void reduce_range(const Source& src, long long begin,
                             long long end, int first_key, T identity,
                             const Sink<T>& sink, TileShared<T>& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    sh.carry_key = first_key;
    sh.carry = {identity, 0};
  }
  for (long long base = begin; base < end; base += kTile) {
    const long long row0 = base + (long long)t * kRows;
    const int nrows = (int)max(0LL, min((long long)kRows, end - row0));
    int key[kRows];
    Part<T> part[kRows];
    src.load(row0, nrows, key, part, identity);

    // this thread's runs: the first (head), the last (x), and any between,
    // which begin and end here and are stored now
    int head_key = -1, tail_key = -1;
    bool multi = false;
    Part<T> head = {identity, 0}, x = {identity, 0};
    if (nrows > 0) {
      head_key = tail_key = key[0];
      x = part[0];
#pragma unroll
      for (int j = 1; j < kRows; ++j) {
        if (j >= nrows) break;
        if (key[j] == tail_key) {
          x = merge<T, K>(x, part[j]);
          continue;
        }
        if (multi) sink.emit(tail_key, x);
        else head = x;
        multi = true;
        tail_key = key[j];
        x = part[j];
      }
      if (!multi) head = x;
    }
    sh.head_key[t] = head_key;
    sh.tail_key[t] = tail_key;
    __syncthreads();
    const int carry_key = sh.carry_key;
    const Part<T> carry = sh.carry;
    const bool has = nrows > 0;
    // does this thread's first run continue the previous thread's last?
    const bool cont = has && (t == 0 ? carry_key : sh.tail_key[t - 1]) ==
                                 head_key;

    // segmented inclusive scan over the threads' last runs: a flag starts
    // a new run; thread 0's continues the carry
    int flag = !has || multi || !cont;
    if (t == 0 && !flag) x = merge<T, K>(carry, x);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int up_flag = __shfl_up_sync(SAIL_FULL_MASK, flag, d);
      Part<T> up = shfl_up(x, d);
      if (lane >= d) {
        if (!flag) x = merge<T, K>(up, x);
        flag |= up_flag;
      }
    }
    if (lane == 31) {
      sh.warp_flag[warp] = flag;
      sh.warp_part[warp] = x;
    }
    __syncthreads();
    Part<T> prefix = {identity, 0};  // the earlier warps' last run
    for (int w = 0; w < warp; ++w)
      prefix = sh.warp_flag[w] ? sh.warp_part[w]
                               : merge<T, K>(prefix, sh.warp_part[w]);
    if (warp > 0 && !flag) x = merge<T, K>(prefix, x);
    // the run this thread's first row continues, up to the previous thread
    Part<T> incoming = shfl_up(x, 1);
    if (lane == 0) incoming = warp > 0 ? prefix : carry;

    const int last = (int)min((long long)kThreads - 1,
                              (end - base - 1) / kRows);
    if (t == 0 && !cont) sink.emit(carry_key, carry);  // ended at the edge
    if (has && multi)
      sink.emit(head_key, cont ? merge<T, K>(incoming, head) : head);
    if (has && t < last && sh.head_key[t + 1] != tail_key)
      sink.emit(tail_key, x);
    __syncthreads();
    if (t == last) {
      sh.carry_key = tail_key;
      sh.carry = x;
    }
  }
  __syncthreads();
}

// The block split of the live prefix, the same in both passes: block b
// takes tiles [b * per, (b + 1) * per) of the ceil(n_live / kTile).
__device__ __forceinline__ long long tiles_per_block(long long n_live,
                                                     long long grid) {
  long long tiles = (n_live + kTile - 1) / kTile;
  return (tiles + grid - 1) / grid;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    seg_runs_kernel(const int* __restrict__ ids,
                    const long long* __restrict__ perm,
                    const long long* __restrict__ n_live_ptr,
                    const T* __restrict__ vals,
                    const bool* __restrict__ valid, int num_segments,
                    T identity, T* __restrict__ out,
                    long long* __restrict__ count, int* __restrict__ rec_key,
                    T* __restrict__ rec_acc, long long* __restrict__ rec_cnt) {
  __shared__ TileShared<T> sh;
  const long long n_live = *n_live_ptr;
  const long long span = tiles_per_block(n_live, gridDim.x) * kTile;
  const long long begin = min(n_live, (long long)blockIdx.x * span);
  const long long end = min(n_live, begin + span);
  if (begin < end) {
    const int first_key = ids[begin];
    const int slot = 2 * blockIdx.x;
    Sink<T> sink{out, count, num_segments, first_key,
                 rec_key, rec_acc, rec_cnt, slot};
    RowSource<T> src{ids, perm, vals, valid,
                     vals != nullptr || valid != nullptr || out != nullptr};
    reduce_range<T, K>(src, begin, end, first_key, identity, sink, sh);
    if (threadIdx.x == 0) {
      if (sh.carry_key == first_key) {  // one run: the head record is empty
        rec_key[slot] = first_key;
        rec_acc[slot] = identity;
        rec_cnt[slot] = 0;
      }
      rec_key[slot + 1] = sh.carry_key;
      rec_acc[slot + 1] = sh.carry.acc;
      rec_cnt[slot + 1] = sh.carry.cnt;
    }
  }
  // the slots past the last group
  const long long groups = n_live > 0 ? (long long)ids[n_live - 1] + 1 : 0;
  for (long long s = groups + (long long)blockIdx.x * kThreads + threadIdx.x;
       s < num_segments; s += (long long)gridDim.x * kThreads) {
    if (out != nullptr) out[s] = identity;
    if (count != nullptr) count[s] = 0;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    seg_runs_merge_kernel(const long long* __restrict__ n_live_ptr, int grid,
                          int num_segments, T identity, T* __restrict__ out,
                          long long* __restrict__ count,
                          const int* __restrict__ rec_key,
                          const T* __restrict__ rec_acc,
                          const long long* __restrict__ rec_cnt) {
  __shared__ TileShared<T> sh;
  const long long n_live = *n_live_ptr;
  const long long per = tiles_per_block(n_live, grid);
  if (per == 0) return;
  const long long tiles = (n_live + kTile - 1) / kTile;
  const long long records = 2 * ((tiles + per - 1) / per);
  Sink<T> sink{out, count, num_segments, -1, nullptr, nullptr, nullptr, 0};
  RecordSource<T> src{rec_key, rec_acc, rec_cnt};
  reduce_range<T, K>(src, 0, records, rec_key[0], identity, sink, sh);
  if (threadIdx.x == 0) sink.emit(sh.carry_key, sh.carry);
}

template <typename T, int K>
cudaError_t launch_runs(const int* ids, const long long* perm,
                        const long long* n_live, const void* vals,
                        const bool* valid, int num_segments, T identity,
                        void* out, long long* count, void* scratch, int grid,
                        cudaStream_t stream) {
  // scratch: 2 * grid records of (int key, T acc, long long cnt)
  long long* rec_cnt = static_cast<long long*>(scratch);
  T* rec_acc = reinterpret_cast<T*>(rec_cnt + 2 * (long long)grid);
  int* rec_key = reinterpret_cast<int*>(rec_acc + 2 * (long long)grid);
  seg_runs_kernel<T, K><<<grid, kThreads, 0, stream>>>(
      ids, perm, n_live, static_cast<const T*>(vals), valid, num_segments,
      identity, static_cast<T*>(out), count, rec_key, rec_acc, rec_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_runs_merge_kernel<T, K><<<1, kThreads, 0, stream>>>(
      n_live, grid, num_segments, identity, static_cast<T*>(out), count,
      rec_key, rec_acc, rec_cnt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

struct BinnedArgs {
  const void* vals;
  const int* seg;
  const bool* valid;
  long long n;
  int num_segments;
  void* out;
  int grid;
  cudaStream_t stream;

  template <typename T, int K>
  cudaError_t run(T identity) const {
    return launch_binned<T, K>(vals, seg, valid, n, num_segments, identity,
                               out, grid, stream);
  }
};

struct RunsArgs {
  const int* ids;
  const long long* perm;
  const long long* n_live;
  const void* vals;
  const bool* valid;
  int num_segments;
  void* out;
  long long* count;
  void* scratch;
  int grid;
  cudaStream_t stream;

  template <typename T, int K>
  cudaError_t run(T identity) const {
    return launch_runs<T, K>(ids, perm, n_live, vals, valid, num_segments,
                             identity, out, count, scratch, grid, stream);
  }
};

template <typename T, typename Args>
cudaError_t dispatch_kind(int kind, const Args& args, T identity) {
  switch (kind) {
    case kSum:
      return args.template run<T, kSum>(identity);
    case kMin:
      return args.template run<T, kMin>(identity);
    case kMax:
      return args.template run<T, kMax>(identity);
  }
  return cudaErrorInvalidValue;
}

template <typename Args>
cudaError_t dispatch(int dtype, int kind, const Args& args,
                     const void* identity) {
  switch (dtype) {
    case 0:
      return dispatch_kind<int>(kind, args,
                                *static_cast<const int*>(identity));
    case 1:
      return dispatch_kind<long long>(
          kind, args, *static_cast<const long long*>(identity));
    case 2:
      return dispatch_kind<double>(kind, args,
                                   *static_cast<const double*>(identity));
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = int32, 1 = int64, 2 = float64. kind: 0 sum, 1 min, 2 max.
// `identity` points to one host value of the dtype; `valid` may be null.
// Returns the launch's cudaError_t.
extern "C" int sail_seg_reduce(const void* vals, const void* seg,
                               const void* valid, long long n,
                               int num_segments, int dtype, int kind,
                               const void* identity, void* out, int grid,
                               void* stream) {
  BinnedArgs args{vals,         static_cast<const int*>(seg),
                  static_cast<const bool*>(valid), n,
                  num_segments, out, grid, static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, kind, args, identity);
}

// ids: int32 sorted ids, perm: int64 permutation, n_live: one int64 on the
// card, all three 16-byte aligned. vals (null: the value is the perm entry,
// dtype must be int64), valid, out and count may be null. scratch holds
// 2 * grid * (4 + 8 + 8) bytes. Two launches: the grid, then one block.
extern "C" int sail_seg_reduce_runs(const void* ids, const void* perm,
                                    const void* n_live, const void* vals,
                                    const void* valid, int num_segments,
                                    int dtype, int kind, const void* identity,
                                    void* out, void* count, void* scratch,
                                    int grid, void* stream) {
  if (vals == nullptr && out != nullptr && dtype != 1)
    return (int)cudaErrorInvalidValue;
  RunsArgs args{static_cast<const int*>(ids),
                static_cast<const long long*>(perm),
                static_cast<const long long*>(n_live),
                vals,
                static_cast<const bool*>(valid),
                num_segments,
                out,
                static_cast<long long*>(count),
                scratch,
                grid,
                static_cast<cudaStream_t>(stream)};
  return (int)dispatch(dtype, kind, args, identity);
}
