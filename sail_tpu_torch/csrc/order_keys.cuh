// K3's per-value order bits, shared by csrc/order_keys.cu (K3) and
// csrc/chain.cuh (K18, the chain's kernel that writes each row's sort
// words), so the two compute the same bits.
//
// Replaces sail_tpu/ops/sort.py `_order_bits` / `order_bits`: each value
// maps to uint64 bits whose unsigned order is the value order (sign bias
// for integers; the IEEE trick for floats, after folding -0.0 into 0.0 and
// every NaN into one NaN that sorts last). `order_word` turns the bits
// into the int64 word the port sorts: the bits XOR (1 << 63), so signed
// order equals the reference's unsigned order (integers come out as
// themselves), and the bitwise NOT of that for a descending key.
//
// Builds under nvcc, under NVRTC (no host headers) and on the host with
// g++ (the chain tests' shim defines the bit casts).
#pragma once

namespace {

constexpr unsigned long long kOrderSign = 1ull << 63;

__device__ __forceinline__ unsigned long long order_bits_bool(bool v) {
  return (unsigned long long)v;
}

__device__ __forceinline__ unsigned long long order_bits_int(long long v) {
  return (unsigned long long)v ^ kOrderSign;
}

__device__ __forceinline__ unsigned long long order_bits_f32(float x) {
  if (x == 0.0f) x = 0.0f;  // -0.0 sorts as 0.0
  const unsigned long long b =
      isnan(x) ? 0x7fc00000ull : (unsigned long long)__float_as_uint(x);
  return (b >> 31) ? (~b & 0xffffffffull) : (b | 0x80000000ull);
}

__device__ __forceinline__ unsigned long long order_bits_f64(double x) {
  if (x == 0.0) x = 0.0;
  const unsigned long long b =
      isnan(x) ? 0x7ff8000000000000ull
               : (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | kOrderSign);
}

// The order bits of a value of its C type (unsigned char holds a bool).
__device__ __forceinline__ unsigned long long order_bits(unsigned char v) {
  return order_bits_bool(v != 0);
}
__device__ __forceinline__ unsigned long long order_bits(signed char v) {
  return order_bits_int(v);
}
__device__ __forceinline__ unsigned long long order_bits(short v) {
  return order_bits_int(v);
}
__device__ __forceinline__ unsigned long long order_bits(int v) {
  return order_bits_int(v);
}
__device__ __forceinline__ unsigned long long order_bits(long long v) {
  return order_bits_int(v);
}
__device__ __forceinline__ unsigned long long order_bits(float v) {
  return order_bits_f32(v);
}
__device__ __forceinline__ unsigned long long order_bits(double v) {
  return order_bits_f64(v);
}

// The K3 word of order bits: signed order is the value order (descending:
// its reverse).
__device__ __forceinline__ long long order_word(unsigned long long bits,
                                                bool descending) {
  const unsigned long long key = bits ^ kOrderSign;
  return (long long)(descending ? ~key : key);
}

}  // namespace
