// K5: match ranges of probe keys in the sorted build keys.
//
// Replaces sail_tpu/ops/join.py `probe_ranges` (its two searchsorted
// calls). For each usable probe row: lo = the lower bound of its key in
// sorted_keys[0:num_valid) and cnt = the number of keys there equal to it,
// both int32. A row that is not usable (dead, or a NULL key part) loads no
// key and gets lo = 0, cnt = 0. The keys are K4's (reference key XOR
// 1 << 63), so a signed comparison is the reference's unsigned one. The
// hashed path's check of the first candidate against the true key columns
// runs after this kernel as torch ops (ops/join.py probe_ranges).
//
// Bound: bytes, n * (1 + 8) + live * 8 + num_valid * 8: the usable flags
// read, lo and cnt written, the live rows' keys read and the usable build
// prefix read once (n * (8 + 1 + 8) + nb * 8 if every key and the whole
// build were read). A search is a chain of dependent loads, so the
// time goes to latency unless each SM keeps many chains in flight and
// most of their loads stay on the chip.
//
// The design, in order of what it saves:
// 1. Only the usable prefix [0, num_valid) is searched. Every position
//    past it holds KEY_MAX (int64 max), which is >= any key, so the lower
//    bound over [0, nb) equals the one over the prefix, and the upper
//    bound clipped at num_valid equals the upper bound over the prefix:
//    bit-exact with the reference on usable rows, a real all-ones key
//    included. A filtered build searches its few usable rows, not its
//    capacity.
// 2. Rows that are not usable are not searched. A warp takes 128
//    consecutive rows, 4 a lane, so its flag loads (4-byte words) and its
//    zero stores (16-byte vectors) coalesce; it lists its usable rows in
//    row order in shared memory (a shuffle prefix sum of the lanes'
//    counts) and writes zeros for the others. Listed rows join the warp's
//    pending probes, which carry over from tile to tile, and the warp
//    searches only once it holds 8 a lane: a probe that is 1% live costs
//    about as many rounds of searches per usable row as a dense one.
// 3. The top of the search is in shared memory. A pre-pass writes every
//    s-th key of the prefix contiguously into a scratch tensor (the whole
//    prefix, s = 1, when it holds at most kTableMax = 16,384 keys, 128 KB);
//    each block of a persistent grid copies it into dynamic shared memory
//    once and searches it there, then finishes in a window of s - 1 keys
//    in global memory: about log2(s) dependent loads in place of
//    2 log2(nb). With s = 1 the whole search, the count included, runs in
//    shared memory. The table is stored swizzled (swz) so that the probes
//    of one search level spread over the banks, and it is kept to 128 KB:
//    a larger one leaves L1 less room for the windows' lines.
// 4. One search, not two: the upper bound gallops from lo (steps of 1, 2,
//    4, ...). On a PK-FK build, where cnt is 0 or 1, that is the load of
//    the key after lo, in the same line; a longer run gallops, the four
//    probes of a lane in lockstep.
// 5. Each lane searches four pending probes at a time in lockstep, so it
//    keeps four independent loads in flight, while the keys of its next
//    four are on their way.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 128;             // rows per warp tile, 4 a lane
constexpr int kRound = 4;                  // probes a lane searches at once
constexpr int kSlots = 2 * kRound;         // probes a lane holds pending
constexpr int kTableMax = 16384;           // int64 splitters: 128 KB
constexpr int kListBytes = kWarps * kTileRows;  // uint8 row lists

struct Splitters {
  int s;  // stride: the table holds sorted_keys[0], [s], [2s], ...
  int m;  // entries: ceil(num_valid / s)
};

__device__ __forceinline__ Splitters splitters_of(int nv, int cap) {
  int s = nv <= cap ? 1 : (int)(((long long)nv + cap - 1) / cap);
  return {s, (int)(((long long)nv + s - 1) / s)};
}

// shared table entries for `cap` splitters: whole runs of 16 (swz)
__host__ __device__ __forceinline__ int table_entries(int cap) {
  return (cap + 15) & ~15;
}

// the highest power of two <= x; 0 for x <= 0
__device__ __forceinline__ int top_pow2(int x) {
  return x > 0 ? 1 << (31 - __clz(x)) : 0;
}

// The place of sorted entry i in the shared table. The probes of one level
// of a binary search share their low index bits, so in sorted order they
// would all fall in one bank (8-byte entries, 16 bank pairs); XOR-ing the
// low 4 bits with a fold of the higher ones spreads them over the banks.
// A bijection on each aligned run of 16 entries.
__device__ __forceinline__ int swz(int i) {
  const int v = i >> 4;
  return i ^ ((v ^ (v >> 4) ^ (v >> 8)) & 15);
}

__global__ void splitter_kernel(const long long* __restrict__ sorted_keys,
                                const long long* __restrict__ num_valid,
                                int cap, long long* __restrict__ table) {
  Splitters sp = splitters_of((int)*num_valid, cap);
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < sp.m;
       t += gridDim.x * blockDim.x)
    table[t] = sorted_keys[(long long)t * sp.s];
}

struct Search {
  const long long* table;  // the splitters, in shared memory
  const long long* __restrict__ sorted_keys;
  Splitters sp;
  int nv, top1, top2;
};

// sorted_keys[k], k < nv: from the table when it holds the whole prefix
__device__ __forceinline__ long long key_at(const Search& s, int k) {
  return s.sp.s == 1 ? s.table[swz(k)] : __ldg(s.sorted_keys + k);
}

// For each probe with more[p]: from k[p], a position whose key is x[p],
// to the last such position. A gallop (steps of 1, 2, 4, ...), then a
// binary search of its last step, the four probes in lockstep so that
// their loads overlap. Every key in [k, nv) is >= x, so `<= x` means
// `== x`.
__device__ __forceinline__ void run_ends(const Search& s,
                                         const bool (&more)[kRound],
                                         const long long (&x)[kRound],
                                         long long (&k)[kRound]) {
  long long step[kRound], end[kRound];
  bool gallop[kRound];
#pragma unroll
  for (int p = 0; p < kRound; ++p) {
    step[p] = 1;
    gallop[p] = more[p];
  }
  while (gallop[0] || gallop[1] || gallop[2] || gallop[3]) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      if (!gallop[p]) continue;
      const long long t = k[p] + step[p];
      if (t < s.nv && key_at(s, (int)t) <= x[p]) {
        k[p] = t;
        step[p] <<= 1;
      } else {
        gallop[p] = false;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kRound; ++p) {
    end[p] = k[p] + step[p] < s.nv ? k[p] + step[p] : s.nv;
    step[p] = more[p] ? step[p] >> 1 : 0;
  }
  while (step[0] || step[1] || step[2] || step[3]) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      if (!step[p]) continue;
      const long long t = k[p] + step[p];
      if (t < end[p] && key_at(s, (int)t) <= x[p]) k[p] = t;
      step[p] >>= 1;
    }
  }
}

// lo (the lower bound in sorted_keys[0:nv)) and cnt of each active key
__device__ __forceinline__ void search(const Search& s,
                                       const bool (&act)[kRound],
                                       const long long (&x)[kRound],
                                       int (&pos)[kRound],
                                       int (&cnt)[kRound]) {
#pragma unroll
  for (int p = 0; p < kRound; ++p) pos[p] = cnt[p] = 0;
  // the number of splitters < x
  for (int step = s.top1; step; step >>= 1) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      int t = pos[p] + step;
      if (act[p] && t <= s.sp.m && s.table[swz(t - 1)] < x[p]) pos[p] = t;
    }
  }
  if (s.sp.s > 1) {
    // c splitters < x: the lower bound lies in [(c - 1) s + 1,
    // min(c s, nv)], or is 0 when c is 0
    int first[kRound], len[kRound];
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      long long c = pos[p];
      long long end = c * s.sp.s < s.nv ? c * s.sp.s : s.nv;
      first[p] = c ? (int)((c - 1) * s.sp.s + 1) : 0;
      len[p] = c ? (int)(end - first[p]) : 0;
      pos[p] = 0;
    }
    for (int step = s.top2; step; step >>= 1) {
#pragma unroll
      for (int p = 0; p < kRound; ++p) {
        int t = pos[p] + step;
        if (act[p] && t <= len[p] &&
            __ldg(s.sorted_keys + first[p] + t - 1) < x[p])
          pos[p] = t;
      }
    }
#pragma unroll
    for (int p = 0; p < kRound; ++p) pos[p] += first[p];
  }
  // the count: the keys at lo and lo + 1 of all four at once, then the
  // run's end where it is longer than one
  bool eq0[kRound], eq1[kRound];
  long long last[kRound];
#pragma unroll
  for (int p = 0; p < kRound; ++p) {
    eq0[p] = act[p] && pos[p] < s.nv && key_at(s, pos[p]) == x[p];
    eq1[p] = act[p] && pos[p] + 1 < s.nv && key_at(s, pos[p] + 1) == x[p];
    eq1[p] = eq0[p] && eq1[p];
    last[p] = pos[p] + 1;
  }
  run_ends(s, eq1, x, last);
#pragma unroll
  for (int p = 0; p < kRound; ++p)
    cnt[p] = eq1[p] ? (int)(last[p] + 1 - pos[p]) : (eq0[p] ? 1 : 0);
}

// Search the first kRound pending probes of each lane (pending probe
// 32 p + lane sits in slot p; `pending` of them are filled), write their
// lo and cnt, and move the rest down.
__device__ __forceinline__ void search_round(
    const Search& s, int lane, int pending,
    long long (&row)[kSlots], long long (&x)[kSlots],
    int* __restrict__ lo_out, int* __restrict__ cnt_out) {
  bool act[kRound];
  long long key[kRound];
  int pos[kRound], cnt[kRound];
#pragma unroll
  for (int p = 0; p < kRound; ++p) {
    act[p] = 32 * p + lane < pending;
    key[p] = x[p];
  }
  search(s, act, key, pos, cnt);
#pragma unroll
  for (int p = 0; p < kRound; ++p) {
    if (act[p]) {
      lo_out[row[p]] = pos[p];
      cnt_out[row[p]] = cnt[p];
    }
  }
#pragma unroll
  for (int p = 0; p < kSlots - kRound; ++p) {
    row[p] = row[p + kRound];
    x[p] = x[p + kRound];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const long long* __restrict__ sorted_keys,
             const long long* __restrict__ num_valid, int cap,
             const long long* __restrict__ splitters,
             const long long* __restrict__ keys,
             const unsigned char* __restrict__ usable, long long n,
             int* __restrict__ lo_out, int* __restrict__ cnt_out) {
  extern __shared__ __align__(16) long long table[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* list =
      reinterpret_cast<unsigned char*>(table + table_entries(cap)) +
      warp * kTileRows;
  Search s;
  s.nv = (int)*num_valid;
  s.sp = splitters_of(s.nv, cap);
  // the table in 16-byte pairs, several loads in flight a thread; swz
  // keeps a pair (2i, 2i + 1) together, in one order or the other
  const longlong2* pairs = reinterpret_cast<const longlong2*>(splitters);
#pragma unroll 4
  for (int t = threadIdx.x; t < (s.sp.m + 1) / 2; t += kThreads) {
    longlong2 v = pairs[t];
    const int at = swz(2 * t);
    if (at & 1) v = make_longlong2(v.y, v.x);
    *reinterpret_cast<longlong2*>(table + (at & ~1)) = v;
  }
  __syncthreads();
  s.table = table;
  s.sorted_keys = sorted_keys;
  s.top1 = top_pow2(s.sp.m);
  s.top2 = top_pow2(s.sp.s - 1);
  const bool vec_in = ((uintptr_t)usable & 3) == 0;
  const bool vec_out = (((uintptr_t)lo_out | (uintptr_t)cnt_out) & 15) == 0;
  const long long stride = (long long)gridDim.x * kWarps * kTileRows;

  // pending probe 32 p + lane (its row and key) sits in slot p of `lane`
  long long row[kSlots], x[kSlots];
  int pending = 0;  // the same in every lane
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kTileRows;
       base < n; base += stride) {
    // the lane's rows r + [0, 4): its flag load (a 4-byte word) and its
    // zero stores (16-byte vectors) coalesce with its neighbours'
    const long long r = base + 4 * lane;
    unsigned live = 0;  // bit q: row r + q is usable
    if (vec_in && r + 4 <= n) {
      const uchar4 u = *reinterpret_cast<const uchar4*>(usable + r);
      live = (u.x != 0) | (u.y != 0) << 1 | (u.z != 0) << 2 | (u.w != 0) << 3;
    } else {
      for (int q = 0; q < 4; ++q)
        if (r + q < n && usable[r + q]) live |= 1u << q;
    }
    // list the usable rows in row order: a prefix sum of the lanes' counts
    const int c = __popc(live);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(SAIL_FULL_MASK, incl, d);
      if (lane >= d) incl += t;
    }
    const int count = __shfl_sync(SAIL_FULL_MASK, incl, 31);
    int at = incl - c;
    for (int q = 0; q < 4; ++q)
      if ((live >> q) & 1u) list[at++] = (unsigned char)(4 * lane + q);
    // zeros for the rows that are not usable
    if (vec_out && r + 4 <= n && live == 0) {
      *reinterpret_cast<int4*>(lo_out + r) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(cnt_out + r) = make_int4(0, 0, 0, 0);
    } else if (live != 0xFu) {
      for (int q = 0; q < 4; ++q)
        if (r + q < n && !((live >> q) & 1u)) {
          lo_out[r + q] = 0;
          cnt_out[r + q] = 0;
        }
    }
    __syncwarp();
    // append the list to the pending probes, loading their keys; search
    // kRound a lane once kSlots a lane are pending, so the keys of the
    // second half are in flight while the first half is searched
    for (int e = 0; e < count;) {
      const int take = min(count - e, 32 * kSlots - pending);
#pragma unroll
      for (int p = 0; p < kSlots; ++p) {
        const int g = 32 * p + lane;
        if (g >= pending && g < pending + take) {
          row[p] = base + list[e + g - pending];
          x[p] = __ldg(keys + row[p]);
        }
      }
      pending += take;
      e += take;
      if (pending == 32 * kSlots) {
        search_round(s, lane, pending, row, x, lo_out, cnt_out);
        pending -= 32 * kRound;
      }
    }
    __syncwarp();  // the next tile rewrites the list
  }
  while (pending > 0) {
    search_round(s, lane, pending, row, x, lo_out, cnt_out);
    pending = pending > 32 * kRound ? pending - 32 * kRound : 0;
  }
}

}  // namespace

// splitters: int64 scratch of splitters_len >= min(nb, kTableMax) + 1
// entries, 16-byte aligned. Returns a CUDA error code: a refused shared-memory size or
// launch included.
extern "C" int sail_join_probe(const void* sorted_keys, long long nb,
                               const void* num_valid, const void* keys,
                               const void* usable, long long n,
                               void* splitters, long long splitters_len,
                               void* lo, void* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int cap = (int)(nb < kTableMax ? nb : kTableMax);
  if (splitters_len < cap + 1 || ((uintptr_t)splitters & 15))
    return (int)cudaErrorInvalidValue;
  int smem = table_entries(cap) * (int)sizeof(long long) + kListBytes;
  if (cap > 0)
    splitter_kernel<<<(cap + 255) / 256, 256, 0, st>>>(
        static_cast<const long long*>(sorted_keys),
        static_cast<const long long*>(num_valid), cap,
        static_cast<long long*>(splitters));
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long tiles = (n + kWarps * kTileRows - 1) / (kWarps * kTileRows);
  long long grid = (long long)per_sm * sms;
  probe_kernel<<<(int)(tiles < grid ? tiles : grid), kThreads, smem, st>>>(
      static_cast<const long long*>(sorted_keys),
      static_cast<const long long*>(num_valid), cap,
      static_cast<const long long*>(splitters),
      static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(usable), n, static_cast<int*>(lo),
      static_cast<int*>(cnt));
  return (int)cudaGetLastError();
}
