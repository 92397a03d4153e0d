// K7: the runtime join filter's blocked bloom, build and apply.
//
// Replaces sail_tpu/ops/runtime_filter.py `build` (its bit-array scatter)
// and `apply`. Keys are K4's (reference key XOR 1 << 63). Each key's
// three bit positions come from the reference's `_positions`: the
// splitmix64 finaliser of the reference key, then m % num_bits,
// (m >> 17) % num_bits and (m >> 34) % num_bits, all unsigned 64-bit.
// The bits live in uint32 words (bit p is word p >> 5, bit p & 31) where
// the reference keeps a bool per bit; membership is the same.
//   build: for each usable key, atomicOr its three bits into `words`.
//   apply: out = sel & usable & member & kmin <= key <= kmax, with kmin and
//          kmax device scalars in the same signed key space.
//
// Bound: bytes: build reads 9 bytes per key; apply reads 10 bytes per row
// and writes 1. At the default 1 << 20 bits the word array is 128 KB and
// stays in L2, so the three random probes per row cost L2 latency, not
// HBM bytes.

#include "common.cuh"

namespace {

constexpr unsigned long long kSign = 1ull << 63;

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void bloom_build_kernel(const long long* __restrict__ keys,
                                   const unsigned char* __restrict__ usable,
                                   long long n, unsigned long long num_bits,
                                   unsigned int* __restrict__ words) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!usable[i]) continue;
    unsigned long long m = mix((unsigned long long)keys[i] ^ kSign);
    unsigned long long p[3] = {m % num_bits, (m >> 17) % num_bits,
                               (m >> 34) % num_bits};
    for (int j = 0; j < 3; ++j)
      atomicOr(&words[p[j] >> 5], 1u << (p[j] & 31));
  }
}

__global__ void bloom_apply_kernel(const unsigned int* __restrict__ words,
                                   unsigned long long num_bits,
                                   const long long* __restrict__ kmin,
                                   const long long* __restrict__ kmax,
                                   const long long* __restrict__ keys,
                                   const unsigned char* __restrict__ usable,
                                   const unsigned char* __restrict__ sel,
                                   long long n,
                                   unsigned char* __restrict__ out) {
  long long lo = *kmin, hi = *kmax;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long k = keys[i];
    bool keep = sel[i] && usable[i] && k >= lo && k <= hi;
    if (keep) {
      unsigned long long m = mix((unsigned long long)k ^ kSign);
      unsigned long long p1 = m % num_bits, p2 = (m >> 17) % num_bits,
                         p3 = (m >> 34) % num_bits;
      keep = ((words[p1 >> 5] >> (p1 & 31)) & 1u) &&
             ((words[p2 >> 5] >> (p2 & 31)) & 1u) &&
             ((words[p3 >> 5] >> (p3 & 31)) & 1u);
    }
    out[i] = keep;
  }
}

}  // namespace

extern "C" int sail_bloom_build(const void* keys, const void* usable,
                                long long n, long long num_bits, void* words,
                                int grid, void* stream) {
  bloom_build_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(usable), n,
      (unsigned long long)num_bits, static_cast<unsigned int*>(words));
  return (int)cudaGetLastError();
}

extern "C" int sail_bloom_apply(const void* words, long long num_bits,
                                const void* kmin, const void* kmax,
                                const void* keys, const void* usable,
                                const void* sel, long long n, void* out,
                                int grid, void* stream) {
  bloom_apply_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned int*>(words), (unsigned long long)num_bits,
      static_cast<const long long*>(kmin), static_cast<const long long*>(kmax),
      static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(usable),
      static_cast<const unsigned char*>(sel), n,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}
