// Moving a window's columns between row order and its sorted order, once
// each: the gather of a value column (and its validity) that K10 and K11
// then read in sorted order, the context's inverse permutation, and the
// unpermute of each K10/K11 output. Only the live prefix (sorted positions
// below n_live, a device scalar) is moved through the permutation: a
// window over a filtered input (a join's output, most rows dead) pays for
// its live rows.
//
// sail_window_gather replaces the value gathers of sail_tpu/ops/window.py
// `framed_agg` (:219-220, `value.data[ctx.perm]`, `value.validity[...]`):
//   vals_s[i] = vals[perm[i]], valid_s[i] = valid[perm[i]] for i < n_live,
//   0 and false at the dead positions, in one pass that reads perm once
//   for both. Values of 1, 2, 4 or 8 bytes, moved as bits; either column
//   may be absent.
// Bound: bytes, n_live * (8 B perm + value + 1 B validity, the last two at
//   random rows) + n * (value + 1 B) written in order. The random reads
//   cost a 32 B sector each; the design keeps four independent ones in
//   flight a thread (1024 positions a block, striped so every perm read
//   and every write is coalesced).
//
// sail_window_inverse replaces the reference's `inv_perm` (:78):
//   inv[perm[i]] = i for i < n_live, -1 for the dead rows (a memset, then
//   one random 4 B write a live row).
// Bound: bytes, n * 4 B + n_live * 8 B perm.
//
// sail_window_unpermute replaces `_unsort` (:82, `sorted[ctx.inv_perm]`):
//   a sorted-order result, plain words or window.cuh records {value, ok}
//   (8 B or 16 B), goes back to row order in one pass, value and validity
//   together: out[r] = src[inv[r]], and 0 and invalid where inv[r] < 0
//   (a dead row). A scatter of the record through perm writes two random
//   partial sectors a row: at 60M rows in a random order on an NVIDIA
//   H100 80GB HBM3 it took 8.730 ms against this gather's 2.178
//   (PERF.md, section 6).
// Bound: bytes, n * (4 B inv + value + 1 B validity) + n_live * record.
//   One random record (one sector) is read a live row; both outputs are
//   written in order.

#include "window.cuh"

namespace {

using namespace sail::win;

constexpr int kPer = 4;  // positions a thread, kThreads (256) apart
constexpr int kSpan = kThreads * kPer;

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const long long* __restrict__ perm,
              const long long* __restrict__ n_live_p, long long n,
              const W* __restrict__ vals, const bool* __restrict__ valid,
              W* __restrict__ vals_s, bool* __restrict__ valid_s) {
  const long long n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kSpan + threadIdx.x;
  long long row[kPer];  // -1: a dead position
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = base + j * kThreads;
    row[j] = i < n_live ? perm[i] : -1;
  }
  if (vals != nullptr) {
    W v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = row[j] >= 0 ? vals[row[j]] : W(0);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (base + j * kThreads < n) vals_s[base + j * kThreads] = v[j];
  }
  if (valid != nullptr) {
    bool v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = row[j] >= 0 && valid[row[j]];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (base + j * kThreads < n) valid_s[base + j * kThreads] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const long long* __restrict__ perm,
               const long long* __restrict__ n_live_p, int* __restrict__ inv) {
  const long long n_live = *n_live_p;
  const long long base = (long long)blockIdx.x * kSpan + threadIdx.x;
  long long row[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = base + j * kThreads;
    row[j] = i < n_live ? perm[i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (row[j] >= 0) inv[row[j]] = (int)(base + j * kThreads);
}

// src: records {value, ok} when ok_out is set, else plain words
template <typename W>
__global__ void __launch_bounds__(kThreads)
unpermute_kernel(const int* __restrict__ inv, long long n,
                 const void* __restrict__ src, W* __restrict__ out,
                 bool* __restrict__ ok_out) {
  const long long base = (long long)blockIdx.x * kSpan + threadIdx.x;
  long long from[kPer];  // -1: a dead row, or past the end
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long r = base + j * kThreads;
    from[j] = r < n ? inv[r] : -1;
  }
  if (ok_out != nullptr) {
    const Rec<W>* rec = static_cast<const Rec<W>*>(src);
    Rec<W> v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = from[j] >= 0 ? rec[from[j]] : Rec<W>{0, 0};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long r = base + j * kThreads;
      if (r < n) {
        out[r] = v[j].v;
        ok_out[r] = v[j].ok != 0;
      }
    }
  } else {
    const W* words = static_cast<const W*>(src);
    W v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = from[j] >= 0 ? words[from[j]] : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long r = base + j * kThreads;
      if (r < n) out[r] = v[j];
    }
  }
}

unsigned blocks(long long n) { return (unsigned)((n + kSpan - 1) / kSpan); }

template <typename W>
cudaError_t unpermute(const int* inv, long long n, const void* src, void* out,
                      void* ok, cudaStream_t s) {
  unpermute_kernel<W><<<blocks(n), kThreads, 0, s>>>(
      inv, n, src, static_cast<W*>(out), static_cast<bool*>(ok));
  return cudaGetLastError();
}

}  // namespace

// width: the value's bytes (1, 2, 4 or 8); vals or valid may be null (then
// its output is not written).
extern "C" int sail_window_gather(const void* perm, const void* n_live,
                                  long long n, const void* vals, int width,
                                  const void* valid, void* vals_s,
                                  void* valid_s, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* p = static_cast<const long long*>(perm);
  const long long* nl = static_cast<const long long*>(n_live);
  const bool* vd = static_cast<const bool*>(valid);
  bool* vs = static_cast<bool*>(valid_s);
#define SAIL_GATHER(W)                                                        \
  gather_kernel<W><<<blocks(n), kThreads, 0, s>>>(                            \
      p, nl, n, static_cast<const W*>(vals), vd, static_cast<W*>(vals_s), vs)
  switch (vals == nullptr ? 1 : width) {
    case 1: SAIL_GATHER(unsigned char); break;
    case 2: SAIL_GATHER(unsigned short); break;
    case 4: SAIL_GATHER(unsigned int); break;
    case 8: SAIL_GATHER(unsigned long long); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SAIL_GATHER
  return (int)cudaGetLastError();
}

// inv: n int32 (n < 2^31).
extern "C" int sail_window_inverse(const void* perm, const void* n_live,
                                   long long n, void* inv, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(inv, 0xff, n * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  inverse_kernel<<<blocks(n), kThreads, 0, s>>>(
      static_cast<const long long*>(perm),
      static_cast<const long long*>(n_live), static_cast<int*>(inv));
  return (int)cudaGetLastError();
}

// inv: n int32 (-1 at a dead row); src: n records of 2 x width bytes
// when ok is set, else n words of width (4 or 8) bytes.
extern "C" int sail_window_unpermute(const void* inv, long long n,
                                     const void* src, int width, void* out,
                                     void* ok, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(inv);
  switch (width) {
    case 4: return (int)unpermute<unsigned int>(i, n, src, out, ok, s);
    case 8: return (int)unpermute<unsigned long long>(i, n, src, out, ok, s);
  }
  return (int)cudaErrorInvalidValue;
}
