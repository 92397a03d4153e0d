// K3: order-preserving 64-bit sort keys.
//
// Replaces sail_tpu/ops/sort.py `_order_bits` / `order_bits`. The per-value
// bits and the word made of them are order_keys.cuh's, which K18
// (csrc/chain.cuh) computes too: the reference's uint64 order bits XOR
// (1 << 63) as int64, so that signed order equals the reference's unsigned
// order (integers come out as themselves), and descending is the bitwise
// NOT.
//
// Bound: bytes: read the value once, write 8 bytes. A grid-stride loop with
// one element per thread per iteration keeps the loads coalesced.

#include "common.cuh"
#include "order_keys.cuh"

namespace {

enum DType { kBool = 0, kI8, kI16, kI32, kI64, kF32, kF64 };

template <int DT, typename T>
__global__ void order_keys_kernel(const T* __restrict__ data, long long n,
                                  bool descending,
                                  long long* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = order_word(order_bits(data[i]), descending);
}

template <int DT, typename T>
cudaError_t launch(const void* data, long long n, bool descending, void* out,
                   int grid, cudaStream_t stream) {
  order_keys_kernel<DT, T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(data), n, descending,
      static_cast<long long*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bool, 1 int8, 2 int16, 3 int32, 4 int64, 5 float32, 6 float64.
extern "C" int sail_order_keys(const void* data, int dtype, long long n,
                               int descending, void* out, int grid,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool desc = descending != 0;
  switch (dtype) {
    case kBool: return (int)launch<kBool, unsigned char>(data, n, desc, out, grid, s);
    case kI8: return (int)launch<kI8, signed char>(data, n, desc, out, grid, s);
    case kI16: return (int)launch<kI16, short>(data, n, desc, out, grid, s);
    case kI32: return (int)launch<kI32, int>(data, n, desc, out, grid, s);
    case kI64: return (int)launch<kI64, long long>(data, n, desc, out, grid, s);
    case kF32: return (int)launch<kF32, float>(data, n, desc, out, grid, s);
    case kF64: return (int)launch<kF64, double>(data, n, desc, out, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}
