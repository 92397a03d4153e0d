// K4: one 64-bit join key and a usable flag per row.
//
// Replaces sail_tpu/ops/hash.py `_to_bits`, `pack_keys` and `hash64` as
// sail_tpu/ops/join.py `_join_keys` calls them. For up to four key
// columns (bool, int8-64, float32/64) each row gets:
//   - the reference's uint64 key: the columns' bits packed when they fit
//     in 64 bits, else the splitmix64-style hash folded over the columns
//     from `seed`; floats first fold -0.0 into 0.0 and every NaN into one
//     NaN. The kernel writes it XOR (1 << 63) as int64 (the K3 convention),
//     so signed order equals the reference's unsigned order;
//   - usable = sel and every key column valid.
//
// Bound: bytes. Each key column, sel and the validities are read once and
// 9 bytes are written per row; the hash is ~10 integer operations per
// column, far below the byte rate. A grid-stride loop with one row per
// thread per iteration keeps every load and store coalesced.

#include "common.cuh"

namespace {

constexpr int kMaxCols = 4;
enum DType { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;

}  // namespace

// Mirrors ops/hash.py _KeyCols. A null validity pointer means all valid.
struct KeyCols {
  const void* data[kMaxCols];
  const unsigned char* valid[kMaxCols];
  int dtype[kMaxCols];
  int ncols;
};

namespace {

__device__ __forceinline__ int key_bits(int dtype) {
  switch (dtype) {
    case kBool: return 1;
    case kI8: return 8;
    case kI16: return 16;
    case kI32: case kF32: return 32;
  }
  return 64;
}

// ops/hash.py _to_bits: equality-preserving bits of one value.
__device__ __forceinline__ unsigned long long to_bits(const void* col,
                                                      int dtype,
                                                      long long i) {
  switch (dtype) {
    case kBool:
      return static_cast<const unsigned char*>(col)[i] & 1ull;
    case kI8:
      return (unsigned long long)(static_cast<const signed char*>(col)[i]) &
             0xffull;
    case kI16:
      return (unsigned long long)(static_cast<const short*>(col)[i]) &
             0xffffull;
    case kI32:
      return (unsigned long long)(static_cast<const int*>(col)[i]) &
             0xffffffffull;
    case kI64:
      return (unsigned long long)(static_cast<const long long*>(col)[i]);
    case kF32: {
      float x = static_cast<const float*>(col)[i];
      if (x == 0.0f) x = 0.0f;  // -0.0 keys equal 0.0
      return isnan(x) ? 0x7fc00000ull : (unsigned long long)__float_as_uint(x);
    }
    default: {
      double x = static_cast<const double*>(col)[i];
      if (x == 0.0) x = 0.0;
      return isnan(x) ? 0x7ff8000000000000ull
                      : (unsigned long long)__double_as_longlong(x);
    }
  }
}

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void join_keys_kernel(KeyCols cols, const unsigned char* sel,
                                 long long n, int hashed,
                                 unsigned long long seed,
                                 long long* __restrict__ keys,
                                 unsigned char* __restrict__ usable) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool ok = sel[i] != 0;
    unsigned long long acc = hashed ? (kGolden ^ seed) : 0ull;
    for (int c = 0; c < cols.ncols; ++c) {
      if (cols.valid[c] != nullptr) ok = ok && cols.valid[c][i] != 0;
      unsigned long long b = to_bits(cols.data[c], cols.dtype[c], i);
      if (hashed) {
        acc = (acc ^ mix(b)) * kGolden;
        acc ^= acc >> 29;
      } else {
        int bits = key_bits(cols.dtype[c]);
        acc = bits == 64 ? b : ((acc << bits) | b);
      }
    }
    keys[i] = (long long)(acc ^ kSign);
    usable[i] = ok;
  }
}

}  // namespace

extern "C" int sail_join_keys(const KeyCols* cols, const void* sel,
                              long long n, int hashed,
                              unsigned long long seed, void* keys,
                              void* usable, int grid, void* stream) {
  if (cols->ncols < 1 || cols->ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  join_keys_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *cols, static_cast<const unsigned char*>(sel), n, hashed, seed,
      static_cast<long long*>(keys), static_cast<unsigned char*>(usable));
  return (int)cudaGetLastError();
}
