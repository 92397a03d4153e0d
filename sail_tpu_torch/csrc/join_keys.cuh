// K4's key derivation, shared by join_keys.cu (K4) and bloom.cu (K7).
//
// The device form of sail_tpu/ops/hash.py `_to_bits`, `pack_keys` and
// `hash64` as sail_tpu/ops/join.py `_join_keys` calls them. For up to four
// key columns (bool, int8-64, float32/64) a row's key is the reference's
// uint64 key: the columns' bits packed when they fit in 64 bits, else the
// splitmix64-style hash folded over the columns from `seed`; floats first
// fold -0.0 into 0.0 and every NaN into one NaN. Kernels store it XOR
// (1 << 63) as int64 (the K3 convention), so signed order equals the
// reference's unsigned order. A row is usable when it is selected and every
// key column is valid there.
#pragma once

#include "common.cuh"

namespace sail {

constexpr int kMaxKeyCols = 4;
enum KeyType { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;

}  // namespace sail

// Mirrors ops/hash.py _KeyCols. A null validity pointer means all valid.
struct KeyCols {
  const void* data[sail::kMaxKeyCols];
  const unsigned char* valid[sail::kMaxKeyCols];
  int dtype[sail::kMaxKeyCols];
  int ncols;
};

namespace sail {

__device__ __forceinline__ int key_bits(int dtype) {
  switch (dtype) {
    case kBool: return 1;
    case kI8: return 8;
    case kI16: return 16;
    case kI32: case kF32: return 32;
  }
  return 64;
}

__device__ __forceinline__ int key_bytes(int dtype) {
  switch (dtype) {
    case kBool: case kI8: return 1;
    case kI16: return 2;
    case kI32: case kF32: return 4;
  }
  return 8;
}

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// ops/hash.py _to_bits of one value, from its raw bytes zero-extended
__device__ __forceinline__ unsigned long long to_bits(unsigned long long raw,
                                                      int dtype) {
  switch (dtype) {
    case kBool:
      return raw & 1ull;
    case kF32: {
      float x = __uint_as_float((unsigned)raw);
      if (x == 0.0f) return 0ull;  // -0.0 keys equal 0.0
      return isnan(x) ? 0x7fc00000ull : raw;
    }
    case kF64: {
      double x = __longlong_as_double((long long)raw);
      if (x == 0.0) return 0ull;
      return isnan(x) ? 0x7ff8000000000000ull : raw;
    }
  }
  return raw;  // integers: their bits, zero-extended from their width
}

// One column's step of the hashed key.
__device__ __forceinline__ unsigned long long hash_step(unsigned long long acc,
                                                        unsigned long long b) {
  acc = (acc ^ mix(b)) * kGolden;
  return acc ^ (acc >> 29);
}

// Fold one column's bits into the key: packed or hashed.
__device__ __forceinline__ unsigned long long fold(unsigned long long acc,
                                                   unsigned long long b,
                                                   int dtype, bool hashed) {
  if (hashed) return hash_step(acc, b);
  const int bits = key_bits(dtype);
  return bits == 64 ? b : ((acc << bits) | b);
}

__device__ __forceinline__ unsigned long long fold_start(
    bool hashed, unsigned long long seed) {
  return hashed ? (kGolden ^ seed) : 0ull;
}

// The raw bytes of element i of a column of S-byte elements, zero-extended.
template <int S>
__device__ __forceinline__ unsigned long long load_raw(const void* col,
                                                       long long i) {
  if (S == 8) return __ldg(static_cast<const unsigned long long*>(col) + i);
  if (S == 4) return __ldg(static_cast<const unsigned*>(col) + i);
  if (S == 2) return __ldg(static_cast<const unsigned short*>(col) + i);
  return __ldg(static_cast<const unsigned char*>(col) + i);
}

// The raw bytes of element i of a key column of type `dtype`.
__device__ __forceinline__ unsigned long long load_one(const void* col,
                                                       int dtype,
                                                       long long i) {
  switch (key_bytes(dtype)) {
    case 1: return load_raw<1>(col, i);
    case 2: return load_raw<2>(col, i);
    case 4: return load_raw<4>(col, i);
  }
  return load_raw<8>(col, i);
}

// A warp's tile of 64 P rows: lane l holds rows base + 64 j + 2 l + b for
// j < P and b in {0, 1}, as bit 2 j + b of its row masks. Each load
// instruction of the warp then covers 64 consecutive rows: 512 contiguous
// bytes of an 8-byte key column (16 bytes a lane), 64 of a flag array (2
// bytes a lane).
template <int P>
struct Tile {
  static constexpr int kLaneRows = 2 * P;   // rows a lane holds
  static constexpr int kRows = 64 * P;      // rows the warp holds

  long long base, n;
  int lane;
  // every row of the tile is < n and every array it reads or writes is
  // 16-byte aligned: each pair of rows moves as one load or store, and a
  // lane's loads are all issued before any of them is used
  bool full;

  __device__ __forceinline__ long long row(int q) const {
    return base + 64 * (q >> 1) + 2 * lane + (q & 1);
  }
};

// One load of a pair of S-byte elements, and its two halves zero-extended.
template <int S> struct Pair;
template <> struct Pair<8> {
  using T = ulonglong2;
  __device__ static void split(T v, unsigned long long& a,
                               unsigned long long& b) {
    a = v.x;
    b = v.y;
  }
};
template <> struct Pair<4> {
  using T = uint2;
  __device__ static void split(T v, unsigned long long& a,
                               unsigned long long& b) {
    a = v.x;
    b = v.y;
  }
};
template <> struct Pair<2> {
  using T = unsigned;
  __device__ static void split(T v, unsigned long long& a,
                               unsigned long long& b) {
    a = v & 0xffffu;
    b = v >> 16;
  }
};
template <> struct Pair<1> {
  using T = unsigned short;
  __device__ static void split(T v, unsigned long long& a,
                               unsigned long long& b) {
    a = v & 0xffu;
    b = v >> 8;
  }
};

// The raw bytes of the lane's rows of a column of S-byte elements,
// zero-extended; rows at or past n read as 0.
template <int S, int P>
__device__ __forceinline__ void load_tile(const void* col, const Tile<P>& t,
                                          unsigned long long (&raw)[2 * P]) {
  if (t.full) {
    using T = typename Pair<S>::T;
    T v[P];
#pragma unroll
    for (int j = 0; j < P; ++j)
      v[j] = __ldg(static_cast<const T*>(col) + t.row(2 * j) / 2);
#pragma unroll
    for (int j = 0; j < P; ++j)
      Pair<S>::split(v[j], raw[2 * j], raw[2 * j + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < 2 * P; ++q)
      raw[q] = t.row(q) < t.n ? load_raw<S>(col, t.row(q)) : 0ull;
  }
}

// The reference keys (not yet XOR 1 << 63) of the lane's rows of a tile.
// The type's and the fold's branches are taken once a column, so the rows
// run as straight-line code.
template <int P>
__device__ __forceinline__ void tile_keys(const KeyCols& cols,
                                          const Tile<P>& t, bool hashed,
                                          unsigned long long seed,
                                          unsigned long long (&acc)[2 * P]) {
  constexpr int kLaneRows = 2 * P;
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) acc[q] = fold_start(hashed, seed);
  for (int c = 0; c < cols.ncols; ++c) {
    const int dtype = cols.dtype[c];
    unsigned long long b[kLaneRows];
    switch (key_bytes(dtype)) {
      case 1: load_tile<1>(cols.data[c], t, b); break;
      case 2: load_tile<2>(cols.data[c], t, b); break;
      case 4: load_tile<4>(cols.data[c], t, b); break;
      default: load_tile<8>(cols.data[c], t, b); break;
    }
    if (dtype == kBool || dtype == kF32 || dtype == kF64) {
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) b[q] = to_bits(b[q], dtype);
    }
    if (hashed) {
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) acc[q] = hash_step(acc[q], b[q]);
    } else if (key_bits(dtype) == 64) {
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) acc[q] = b[q];
    } else {
      const int bits = key_bits(dtype);
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) acc[q] = (acc[q] << bits) | b[q];
    }
  }
}

// The lane's rows of a tile that are non-zero in a byte array (rows past
// n are 0), as a row mask.
template <int P>
__device__ __forceinline__ unsigned tile_flags(const unsigned char* p,
                                               const Tile<P>& t) {
  unsigned long long raw[2 * P];
  load_tile<1>(p, t, raw);
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 2 * P; ++q) bits |= (raw[q] != 0) << q;
  return bits;
}

// The lane's usable rows of a tile: selected, every key column valid.
template <int P>
__device__ __forceinline__ unsigned tile_usable(const KeyCols& cols,
                                                const unsigned char* sel,
                                                const Tile<P>& t) {
  unsigned live = tile_flags(sel, t);
  for (int c = 0; c < cols.ncols && live; ++c)
    if (cols.valid[c] != nullptr) live &= tile_flags(cols.valid[c], t);
  return live;
}

// Write a row mask of the lane's rows as bytes 0 or 1 (rows < n only).
template <int P>
__device__ __forceinline__ void store_tile_flags(unsigned char* p,
                                                 const Tile<P>& t,
                                                 unsigned bits) {
  if (t.full) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      reinterpret_cast<unsigned short*>(p)[t.row(2 * j) / 2] =
          (unsigned short)(((bits >> (2 * j)) & 1u) |
                           ((bits >> (2 * j + 1)) & 1u) << 8);
  } else {
#pragma unroll
    for (int q = 0; q < 2 * P; ++q)
      if (t.row(q) < t.n) p[t.row(q)] = (bits >> q) & 1u;
  }
}

// Write the lane's keys of a tile XOR (1 << 63) as int64 (rows < n only).
template <int P>
__device__ __forceinline__ void store_tile_keys(
    long long* keys, const Tile<P>& t,
    const unsigned long long (&acc)[2 * P]) {
  if (t.full) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      reinterpret_cast<longlong2*>(keys)[t.row(2 * j) / 2] = make_longlong2(
          (long long)(acc[2 * j] ^ kSign), (long long)(acc[2 * j + 1] ^ kSign));
  } else {
#pragma unroll
    for (int q = 0; q < 2 * P; ++q)
      if (t.row(q) < t.n) keys[t.row(q)] = (long long)(acc[q] ^ kSign);
  }
}

// True when p is 16-byte aligned (null counts as aligned).
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Every column, validity and `sel` of a key set 16-byte aligned.
__host__ __forceinline__ bool key_cols_aligned(const KeyCols& cols,
                                               const void* sel) {
  bool ok = aligned16(sel);
  for (int c = 0; c < cols.ncols; ++c)
    ok = ok && aligned16(cols.data[c]) && aligned16(cols.valid[c]);
  return ok;
}

}  // namespace sail
