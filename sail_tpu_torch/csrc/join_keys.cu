// K4: one 64-bit join key and a usable flag per row.
//
// Replaces sail_tpu/ops/hash.py `_to_bits`, `pack_keys` and `hash64` as
// sail_tpu/ops/join.py `_join_keys` calls them. For up to four key
// columns (bool, int8-64, float32/64) each row gets the reference's key
// XOR (1 << 63) as int64 and usable = sel and every key column valid; the
// derivation itself (join_keys.cuh) is shared with K7's fused passes.
//
// Bound: bytes. Each key column, sel and the validities are read once and
// 9 bytes are written per row; the hash is ~10 integer operations per
// column, far below the byte rate. A grid-stride loop with one row per
// thread per iteration keeps every load and store coalesced.

#include "join_keys.cuh"

namespace {

__global__ void join_keys_kernel(KeyCols cols, const unsigned char* sel,
                                 long long n, int hashed,
                                 unsigned long long seed,
                                 long long* __restrict__ keys,
                                 unsigned char* __restrict__ usable) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool ok = sel[i] != 0;
    unsigned long long acc = sail::fold_start(hashed, seed);
    for (int c = 0; c < cols.ncols; ++c) {
      if (cols.valid[c] != nullptr) ok = ok && cols.valid[c][i] != 0;
      const int dtype = cols.dtype[c];
      acc = sail::fold(acc,
                       sail::to_bits(sail::load_one(cols.data[c], dtype, i),
                                     dtype),
                       dtype, hashed);
    }
    keys[i] = (long long)(acc ^ sail::kSign);
    usable[i] = ok;
  }
}

}  // namespace

extern "C" int sail_join_keys(const KeyCols* cols, const void* sel,
                              long long n, int hashed,
                              unsigned long long seed, void* keys,
                              void* usable, int grid, void* stream) {
  if (cols->ncols < 1 || cols->ncols > sail::kMaxKeyCols)
    return (int)cudaErrorInvalidValue;
  join_keys_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *cols, static_cast<const unsigned char*>(sel), n, hashed, seed,
      static_cast<long long*>(keys), static_cast<unsigned char*>(usable));
  return (int)cudaGetLastError();
}
