// K7: the runtime join filter, build and apply, each one fused pass over
// the key columns.
//
// Replaces sail_tpu/ops/runtime_filter.py `build` (the key derivation
// `_join_keys`, the bit-array scatter and the kmin / kmax / n_build
// reductions; its ndv count stays a sort outside the kernel) and `apply`
// (`_join_keys`, the three probes and the [kmin, kmax] check). A row's key
// is K4's (join_keys.cuh): the reference key XOR 1 << 63 as int64. Its
// three bit positions follow the reference's `_positions`: the splitmix64
// finaliser m of the reference key, then m % num_bits, (m >> 17) % num_bits
// and (m >> 34) % num_bits, unsigned 64-bit. The bits live in uint32 words
// (bit p is word p >> 5, bit p & 31) where the reference keeps a bool per
// bit; membership is the same.
//   build: keys and usable flags of every row (the ndv sort reads them),
//          the three bits of every usable key, and stats = [kmin, kmax,
//          n_build] over the usable rows (int64 max, int64 min and 0 when
//          there are none).
//   apply: out = sel & usable & member & kmin <= key <= kmax, the key
//          columns read directly: no key is written.
//
// Bound: bytes. build reads its key columns, validities and sel and writes
// 9 bytes a row (key, usable) and the words; apply reads the same inputs
// and the words and writes 1 byte a row. At the main path's shape, one
// int64 key column and no validity: build 15M rows x 18 B plus the words,
// 0.081 ms; apply 60M rows x 10 B plus the words, 0.179 ms, over
// 3.35 TB/s. What holds apply is issue, not bytes: each live row costs
// ~50 integer instructions (the mix, three reductions, three probes)
// behind a chain of dependent latencies, so the design keeps those cheap
// and keeps enough of them in flight:
// 1. No 64-bit division. A power-of-two num_bits reduces by a mask;
//    otherwise by a Barrett step with mu = floor(2^64 / num_bits), computed
//    once on the host: q = umulhi(m, mu) is floor(m / num_bits) or one
//    less, so m - q * num_bits needs at most one subtraction. Exact for
//    every 64-bit m and 0 < num_bits < 2^31 (ops/runtime_filter.py
//    `divisor` and `reduce_plain` hold the host side).
// 2. The filter in shared memory while it fits (num_bits <=
//    kSharedBitsMax: 192 KB of words, 1,572,864 bits, which leaves L1 a
//    fifth of the SM's 228 KB). apply copies the words into each
//    persistent block once and probes there; build sets bits in a private
//    copy with shared atomicOr and ORs its non-zero words into the global
//    array once at the end, in place of three global atomics a key. A
//    larger filter is built and probed in global memory by the same
//    kernels (the kShared = false instances).
// 3. Coalesced rows, every load of a lane issued before any is used. A
//    lane holds pairs of consecutive rows, 64 rows apart (join_keys.cuh
//    Tile): each load instruction of an 8-byte key column moves 512
//    contiguous bytes, 16 a lane, and the flags (sel, validities, usable,
//    out) move 2 bytes a lane, 64 contiguous bytes a warp. The keys set
//    this layout: 16-byte vectors of flags would give a lane 16
//    consecutive rows, whose 128 bytes of keys a warp would then read as
//    32 separate lines per load instruction. A tile whose rows are all
//    in range takes a path without a branch between its loads.
// 4. Latency hidden by warps and rows in flight: build keeps 16 rows a
//    lane in blocks of 512 threads; apply 8 rows a lane in blocks of 1024
//    (64 registers a thread), and mixes and probes two rows at a time,
//    branch-free: a dead or out-of-range row issues no probe.
// 5. Dead and out-of-range rows skip the mix. A warp whose densest lane
//    has at most half its rows live mixes only live rows, each lane
//    taking its next one in turn, so the warp runs as many turns as that
//    lane has live rows; a denser warp takes the branch-free path of 4.
//    A lane whose rows are all dead loads no key in apply.
// 6. The stats are a warp and a block reduction, then one device atomic
//    per block for each (min, max, count: order does not matter).

#include <climits>

#include "join_keys.cuh"

namespace {

using sail::kSign;

// Block sizes and rows a lane holds (measured on the card at the main
// path's shape): build keeps 16 rows a lane in 512 threads, apply 8 rows a
// lane in 1024, which halves its registers and doubles the warps that hide
// each other's mix and probe latencies. Both keep one block an SM: it holds
// the filter in shared memory.
constexpr int kBuildThreads = 512;
constexpr int kApplyThreads = 1024;
using BuildTile = sail::Tile<8>;
using ApplyTile = sail::Tile<4>;
constexpr int kGroup = 2;  // rows whose probes apply overlaps
constexpr long long kBuildRows = kBuildThreads / 32 * BuildTile::kRows;
constexpr long long kApplyRows = kApplyThreads / 32 * ApplyTile::kRows;
// filters of up to this many bits are kept in shared memory (192 KB)
constexpr long long kSharedBitsMax = 192ll * 1024 * 8;

// m % d for 64-bit m; kPow2: d is a power of two, else mu = floor(2^64 / d)
template <bool kPow2>
__device__ __forceinline__ unsigned reduce(unsigned long long m,
                                           unsigned long long d,
                                           unsigned long long mu) {
  if (kPow2) return (unsigned)(m & (d - 1));
  const unsigned long long r = m - __umul64hi(m, mu) * d;
  return (unsigned)(r >= d ? r - d : r);
}

// The key of the lane's lowest row in `rest` (not empty), which is taken
// out of it; q is that row. acc is indexed by a chain of selects: a
// register array admits no run-time index.
template <int kLaneRows>
__device__ __forceinline__ unsigned long long next_live(
    unsigned& rest, const unsigned long long (&acc)[kLaneRows], int& q) {
  q = __ffs(rest) - 1;
  rest &= rest - 1;
  unsigned long long a = acc[0];
#pragma unroll
  for (int j = 1; j < kLaneRows; ++j) a = q == j ? acc[j] : a;
  return a;
}

struct Filter {
  unsigned long long num_bits, mu;
  int num_words;
};

__global__ void init_stats_kernel(long long* stats) {
  stats[0] = LLONG_MAX;
  stats[1] = LLONG_MIN;
  stats[2] = 0;
}

template <bool kShared, bool kPow2>
__global__ void __launch_bounds__(kBuildThreads, 1)
bloom_build_kernel(KeyCols cols, const unsigned char* __restrict__ sel,
                   long long n, int hashed, unsigned long long seed,
                   Filter f, int vec, long long* __restrict__ keys,
                   unsigned char* __restrict__ usable,
                   unsigned* __restrict__ words,
                   long long* __restrict__ stats) {
  constexpr int kWarps = kBuildThreads / 32;
  constexpr int kLaneRows = BuildTile::kLaneRows;
  extern __shared__ __align__(16) unsigned local_words[];
  __shared__ long long part[3][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* bits = words;
  if (kShared) {
    for (int w = threadIdx.x; w < (f.num_words + 3) / 4; w += kBuildThreads)
      reinterpret_cast<uint4*>(local_words)[w] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    bits = local_words;
  }
  long long kmin = LLONG_MAX, kmax = LLONG_MIN, count = 0;
  const long long step = (long long)gridDim.x * kWarps * BuildTile::kRows;
  for (long long tile =
           ((long long)blockIdx.x * kWarps + warp) * BuildTile::kRows;
       tile < n; tile += step) {
    const BuildTile t{tile, n, lane, vec && tile + BuildTile::kRows <= n};
    // the keys' loads first: none of them waits for the flags
    unsigned long long acc[kLaneRows];
    sail::tile_keys(cols, t, hashed, seed, acc);
    const unsigned live = sail::tile_usable(cols, sel, t);
    sail::store_tile_keys(keys, t, acc);
    sail::store_tile_flags(usable, t, live);
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      const bool ok = (live >> q) & 1u;
      const long long k = (long long)(acc[q] ^ kSign);
      kmin = ok && k < kmin ? k : kmin;
      kmax = ok && k > kmax ? k : kmax;
      count += ok;
    }
    // the warp's densest lane picks every row in turn or its live rows
    const unsigned most =
        __reduce_max_sync(SAIL_FULL_MASK, (unsigned)__popc(live));
    if (2 * most > (unsigned)kLaneRows) {
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) {
        const bool ok = (live >> q) & 1u;
        const unsigned long long m = sail::mix(acc[q]);
        const unsigned p[3] = {reduce<kPow2>(m, f.num_bits, f.mu),
                               reduce<kPow2>(m >> 17, f.num_bits, f.mu),
                               reduce<kPow2>(m >> 34, f.num_bits, f.mu)};
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (ok) atomicOr(&bits[p[i] >> 5], 1u << (p[i] & 31));
      }
    } else {
      for (unsigned rest = live; rest;) {
        int q;
        const unsigned long long m = sail::mix(next_live(rest, acc, q));
        const unsigned p[3] = {reduce<kPow2>(m, f.num_bits, f.mu),
                               reduce<kPow2>(m >> 17, f.num_bits, f.mu),
                               reduce<kPow2>(m >> 34, f.num_bits, f.mu)};
#pragma unroll
        for (int i = 0; i < 3; ++i)
          atomicOr(&bits[p[i] >> 5], 1u << (p[i] & 31));
      }
    }
  }
  // stats: the warp's, then the block's, then one atomic each
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const long long lo = __shfl_xor_sync(SAIL_FULL_MASK, kmin, d);
    const long long hi = __shfl_xor_sync(SAIL_FULL_MASK, kmax, d);
    count += __shfl_xor_sync(SAIL_FULL_MASK, count, d);
    kmin = lo < kmin ? lo : kmin;
    kmax = hi > kmax ? hi : kmax;
  }
  if (lane == 0) {
    part[0][warp] = kmin;
    part[1][warp] = kmax;
    part[2][warp] = count;
  }
  __syncthreads();
  if (warp == 0) {
    kmin = lane < kWarps ? part[0][lane] : LLONG_MAX;
    kmax = lane < kWarps ? part[1][lane] : LLONG_MIN;
    count = lane < kWarps ? part[2][lane] : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const long long lo = __shfl_xor_sync(SAIL_FULL_MASK, kmin, d);
      const long long hi = __shfl_xor_sync(SAIL_FULL_MASK, kmax, d);
      count += __shfl_xor_sync(SAIL_FULL_MASK, count, d);
      kmin = lo < kmin ? lo : kmin;
      kmax = hi > kmax ? hi : kmax;
    }
    if (lane == 0 && count) {
      atomicMin(&stats[0], kmin);
      atomicMax(&stats[1], kmax);
      atomicAdd(reinterpret_cast<unsigned long long*>(&stats[2]),
                (unsigned long long)count);
    }
  }
  if (kShared) {
    for (int w = threadIdx.x; w < f.num_words; w += kBuildThreads) {
      const unsigned v = local_words[w];
      if (v) atomicOr(&words[w], v);
    }
  }
}

template <bool kShared, bool kPow2>
__global__ void __launch_bounds__(kApplyThreads, 1)
bloom_apply_kernel(KeyCols cols, const unsigned char* __restrict__ sel,
                   long long n, int hashed, unsigned long long seed,
                   const unsigned* __restrict__ words, Filter f,
                   const long long* __restrict__ kmin,
                   const long long* __restrict__ kmax, int vec,
                   unsigned char* __restrict__ out) {
  constexpr int kWarps = kApplyThreads / 32;
  constexpr int kLaneRows = ApplyTile::kLaneRows;
  extern __shared__ __align__(16) unsigned local_words[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned* bits = words;
  if (kShared) {
    const int quads = sail::aligned16(words) ? f.num_words / 4 : 0;
    for (int w = threadIdx.x; w < quads; w += kApplyThreads)
      reinterpret_cast<uint4*>(local_words)[w] =
          __ldg(reinterpret_cast<const uint4*>(words) + w);
    for (int w = 4 * quads + threadIdx.x; w < f.num_words;
         w += kApplyThreads)
      local_words[w] = __ldg(words + w);
    __syncthreads();
    bits = local_words;
  }
  const long long lo = *kmin, hi = *kmax;
  const long long step = (long long)gridDim.x * kWarps * ApplyTile::kRows;
  for (long long tile =
           ((long long)blockIdx.x * kWarps + warp) * ApplyTile::kRows;
       tile < n; tile += step) {
    const ApplyTile t{tile, n, lane, vec && tile + ApplyTile::kRows <= n};
    const unsigned live = sail::tile_usable(cols, sel, t);
    // the warp's densest lane picks, while the keys load: every row in
    // turn, kGroup at a time, or each lane's live rows one at a time
    const unsigned most =
        __reduce_max_sync(SAIL_FULL_MASK, (unsigned)__popc(live));
    unsigned keep = 0;
    if (live) {
      unsigned long long acc[kLaneRows];
      sail::tile_keys(cols, t, hashed, seed, acc);
      if (2 * most > (unsigned)kLaneRows) {
        // kGroup rows at a time: their mixes and probes overlap; a row
        // that is dead or out of range probes nothing
#pragma unroll
        for (int q0 = 0; q0 < kLaneRows; q0 += kGroup) {
          bool ok[kGroup];
          unsigned w[kGroup][3], p[kGroup][3];
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            const long long k = (long long)(acc[q0 + r] ^ kSign);
            ok[r] = ((live >> (q0 + r)) & 1u) && k >= lo && k <= hi;
            const unsigned long long m = sail::mix(acc[q0 + r]);
            p[r][0] = reduce<kPow2>(m, f.num_bits, f.mu);
            p[r][1] = reduce<kPow2>(m >> 17, f.num_bits, f.mu);
            p[r][2] = reduce<kPow2>(m >> 34, f.num_bits, f.mu);
          }
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
#pragma unroll
            for (int i = 0; i < 3; ++i)
              w[r][i] = ok[r] ? bits[p[r][i] >> 5] : 0u;
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            bool in = ok[r];
#pragma unroll
            for (int i = 0; i < 3; ++i)
              in = in && ((w[r][i] >> (p[r][i] & 31)) & 1u);
            keep |= (unsigned)in << (q0 + r);
          }
        }
      } else {
        for (unsigned rest = live; rest;) {
          int q;
          const unsigned long long key = next_live(rest, acc, q);
          const long long k = (long long)(key ^ kSign);
          if (k < lo || k > hi) continue;
          const unsigned long long m = sail::mix(key);
          const unsigned p[3] = {reduce<kPow2>(m, f.num_bits, f.mu),
                                 reduce<kPow2>(m >> 17, f.num_bits, f.mu),
                                 reduce<kPow2>(m >> 34, f.num_bits, f.mu)};
          bool in = true;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            in = in && ((bits[p[i] >> 5] >> (p[i] & 31)) & 1u);
          keep |= (unsigned)in << q;
        }
      }
    }
    sail::store_tile_flags(out, t, keep);
  }
}

// Launch `kernel` over n rows, blocks of `threads` taking `rows_per_block`
// rows a step, with `smem` bytes of dynamic shared memory: a persistent
// grid, as many blocks as fit on the card or the rows need.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, long long rows_per_block,
                   long long n, int smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  const long long fit = (long long)per_sm * sms;
  kernel<<<(int)(need < fit ? need : fit), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

bool valid_filter(const KeyCols* cols, long long num_bits,
                  unsigned long long mu) {
  const bool pow2 = (num_bits & (num_bits - 1)) == 0;
  return cols->ncols >= 1 && cols->ncols <= sail::kMaxKeyCols &&
         num_bits > 0 && num_bits < (1ll << 31) && (mu == 0) == pow2;
}

Filter filter_of(long long num_bits, unsigned long long mu) {
  return {(unsigned long long)num_bits, mu, (int)((num_bits + 31) / 32)};
}

// dynamic shared memory of a filter kept there: whole 16-byte quads
int shared_bytes(const Filter& f) { return (f.num_words + 3) / 4 * 16; }

}  // namespace

// mu: floor(2^64 / num_bits), or 0 when num_bits is a power of two. The
// filter is built in shared memory when num_bits <= kSharedBitsMax.
// `words` (ceil(num_bits / 32) uint32) must be zero; stats is int64[3].
// Returns a CUDA error code: a refused shared-memory size or launch
// included.
extern "C" int sail_bloom_build(const KeyCols* cols, const void* sel,
                                long long n, int hashed,
                                unsigned long long seed, long long num_bits,
                                unsigned long long mu, void* keys,
                                void* usable, void* words, void* stats,
                                void* stream) {
  if (!valid_filter(cols, num_bits, mu)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* s = static_cast<long long*>(stats);
  init_stats_kernel<<<1, 1, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return (int)err;
  const Filter f = filter_of(num_bits, mu);
  const bool shared = num_bits <= kSharedBitsMax, pow2 = mu == 0;
  const int smem = shared ? shared_bytes(f) : 0;
  const int vec = sail::key_cols_aligned(*cols, sel) &&
                  sail::aligned16(keys) && sail::aligned16(usable);
  auto* kernel = shared ? (pow2 ? &bloom_build_kernel<true, true>
                                : &bloom_build_kernel<true, false>)
                       : (pow2 ? &bloom_build_kernel<false, true>
                               : &bloom_build_kernel<false, false>);
  return (int)launch(kernel, kBuildThreads, kBuildRows, n, smem, st, *cols,
                     static_cast<const unsigned char*>(sel), n, hashed, seed,
                     f, vec, static_cast<long long*>(keys),
                     static_cast<unsigned char*>(usable),
                     static_cast<unsigned*>(words), s);
}

// kmin, kmax: int64 device scalars in the keys' signed space. The filter
// is probed in shared memory when num_bits <= kSharedBitsMax.
extern "C" int sail_bloom_apply(const KeyCols* cols, const void* sel,
                                long long n, int hashed,
                                unsigned long long seed, const void* words,
                                long long num_bits, unsigned long long mu,
                                const void* kmin,
                                const void* kmax, void* out, void* stream) {
  if (!valid_filter(cols, num_bits, mu)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Filter f = filter_of(num_bits, mu);
  const bool shared = num_bits <= kSharedBitsMax, pow2 = mu == 0;
  const int smem = shared ? shared_bytes(f) : 0;
  const int vec = sail::key_cols_aligned(*cols, sel) && sail::aligned16(out);
  auto* kernel = shared ? (pow2 ? &bloom_apply_kernel<true, true>
                                : &bloom_apply_kernel<true, false>)
                       : (pow2 ? &bloom_apply_kernel<false, true>
                               : &bloom_apply_kernel<false, false>);
  return (int)launch(kernel, kApplyThreads, kApplyRows, n, smem, st, *cols,
                     static_cast<const unsigned char*>(sel), n, hashed, seed,
                     static_cast<const unsigned*>(words), f,
                     static_cast<const long long*>(kmin),
                     static_cast<const long long*>(kmax), vec,
                     static_cast<unsigned char*>(out));
}

