// K12-K15: the compiler's elementwise math, rounding, bitwise and calendar
// builders.
//
// Replaces the device programs XLA compiled for sail_tpu/plan/compiler.py's
// `_unary_math` (:937: sqrt, exp, ln, the trig and hyperbolic functions,
// cbrt, log1p, expm1, rint, degrees, radians, sign, floor, ceil, abs,
// negative; with `_isnan_builder` :1378 and the `~` of `_strict_builder`),
// `_round_builder` (:1313) and `_bround_builder` (:1339) with
// sail_tpu/functions/kernels.py `round_half_up` (:176), the two-operand
// `_strict_builder` (:954: atan2, power, hypot, log(base, x), &, |, ^,
// shiftleft, shiftright) with `_nanvl_builder`, and `_add_months_builder`,
// `_months_between_builder`, `_last_day_builder` and `_weekofyear_builder`
// (:1177-1230).
//
// Each kernel is one pass over a column of int32, int64 (integers and
// unscaled decimals, whose scale is an argument) or float64, with an
// optional bool validity. Where the reference is wrong the kernels give
// Spark's answer (sail_tpu_torch/functions/numeric.py lists the cases): a
// decimal becomes a double as unscaled / 10^s (an exact power of ten) for
// every operand, abs and negative of a decimal stay exact on the unscaled
// integer, rounding to negative digits drops whole digits, a logarithm of
// x <= 0 is NULL, and a shift count is masked to 6 bits (5 for an int).
//
// Bound: bytes. Each reads its operands once and writes its result (and a
// validity where the operation makes one) once: 8-24 bytes a row against a
// few to a few dozen float64 or int32 operations.
// K12, K14 and K15 are instantiated an operation and operand types
// (unary_kernel<OP, In>, binary_kernel<OP, X, Y, YS>, calendar_kernel<OP,
// XK, YK, YS>; one host switch each, SAIL_UNARY_TABLE,
// SAIL_BINARY_TABLE, SAIL_CALENDAR_TABLE): a kernel that took the
// operation and types as arguments held every libm function of its switch
// in one body and its registers, and switched on each element's type; it
// ran 5-46% behind one PyTorch call on the same column. Each instantiation
// moves 16 B vectors where its columns are aligned, several of them in
// flight a thread, a block a span, and its op has its own launch bounds.
// A scalar second operand (K14, K15) is read once a thread: its value from
// the host (a literal's), passed by value, or from its address on the
// card; power by a scalar 2 on the host takes an instantiation of its own,
// x * x (E2's power(l_tax, 2)). K15's month tables are built once on the
// host. The three share one loop (span_rows) and differ in their rows.
// K13 runs a grid-stride loop, one row per thread an iteration, loading
// four rows a thread before it computes any.
// Integer division by
// a power of ten goes through one float64 division where the dividend is
// below 2^52 (exact there), and the calendar works in 32-bit integers
// (days fit in an int32): 64-bit integer division is many instructions on
// the card.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "expr_math.cuh"

namespace {

// ---------------------------------------------------------------------------
// K12: one-operand math, one instantiation an operation and input type
// ---------------------------------------------------------------------------

// The result's type: a double (the float ops and sign), an int64 (floor
// and ceil), a bool (isnan) or the input's (~, abs, negative).
template <int OP, typename In>
using UnaryOut = std::conditional_t<
    OP <= kSign, double,
    std::conditional_t<OP == kFloor || OP == kCeil, long long,
                       std::conditional_t<OP == kIsnan, bool, In>>>;

__host__ __device__ constexpr bool is_log(int op) {
  return op == kLn || op == kLog10 || op == kLog2 || op == kLog1p;
}

// One row of OP over an input of type In (int, long long or double);
// scale: a decimal's scale (ints and unscaled decimals), applied as one
// division by 10^scale, as math_unary_plain divides; v: the row's
// validity, read by the logarithms (which write their own, ok) and isnan
// only.
template <int OP, typename In>
struct UnaryOp {
  using Out = UnaryOut<OP, In>;
  static constexpr bool kFloat = std::is_same<In, double>::value;
  static constexpr bool kReadsValid = is_log(OP) || OP == kIsnan;
  double p;     // 10^scale
  long long f;  // 10^scale, for floor and ceil of a decimal
  bool scaled;  // scale > 0

  __device__ __forceinline__ Out operator()(In x, bool v, bool& ok) const {
    if constexpr (OP <= kSign) {
      double d = (double)x;
      if constexpr (!kFloat) {
        d = (double)(long long)x;
        if (scaled) d = d / p;
      }
      if constexpr (is_log(OP))  // NULL at x <= 0 (log1p: x <= -1)
        ok = (OP == kLog1p ? !(d <= -1.0) : !(d <= 0.0)) && v;
      return float_op(OP, d);
    } else if constexpr (OP == kFloor || OP == kCeil) {
      if constexpr (kFloat) {
        return sat_i64(OP == kFloor ? floor(x) : ceil(x));
      } else {
        const long long w = (long long)x;
        return OP == kFloor ? floor_div_pow10(w, f)
                            : -floor_div_pow10(-w, f);
      }
    } else if constexpr (OP == kIsnan) {
      if constexpr (kFloat)
        return isnan(x) && v;
      else
        return false;
    } else if constexpr (kFloat) {  // abs, negative
      return OP == kAbs ? fabs(x) : -x;
    } else {  // ~, abs, negative: exact, two's complement (abs(MIN) = MIN)
      const unsigned long long w = (unsigned long long)(long long)x;
      const unsigned long long neg = 0ull - w;
      const unsigned long long r = OP == kNot        ? ~w
                                   : OP == kNegative ? neg
                                   : ((long long)w < 0 ? neg : w);
      return (In)(long long)r;
    }
  }
};

// E values of T side by side: one vector access of E * sizeof(T) bytes
// (at most 16 B an access; 32 B go as two)
template <typename T, int E>
struct alignas(E * sizeof(T) < 16 ? E * sizeof(T) : 16) Pack {
  T v[E];
};

// The loop of K12, K14 and K15 in a block: vectors [0, n_vec / E) of E
// rows, a thread loading V of them, T apart, before it computes any, a
// block one span of T * V vectors (the grid covers the rows once, as
// PyTorch's elementwise kernels do: a grid-stride loop over the resident
// blocks alone ran slower, PERF.md section 6); then rows [n_vec, n) one at
// a time. load(k, in) reads vector k's operands into in, vec(k, in)
// computes and writes it, row(i) does row i of the tail.
template <int T, int V, int E, typename In, typename Load, typename Vec,
          typename Row>
__device__ __forceinline__ void span_rows(long long n, long long n_vec,
                                          Load load, Vec vec, Row row) {
  const long long nv = n_vec / E;
  const long long span = (long long)T * V;
  for (long long k0 = (long long)blockIdx.x * span + threadIdx.x; k0 < nv;
       k0 += (long long)gridDim.x * span) {
    In in[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long k = k0 + u * T;
      if (k < nv) load(k, in[u]);
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long k = k0 + u * T;
      if (k < nv) vec(k, in[u]);
    }
  }
  for (long long i = n_vec + (long long)blockIdx.x * T + threadIdx.x; i < n;
       i += (long long)gridDim.x * T)
    row(i);
}

__host__ __forceinline__ bool aligned_to(const void* ptr, size_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// A span_rows launch over n rows: with its columns aligned for vectors of
// rows_per_vec rows, rows [0, n_vec) in vectors and a block threads * vecs
// of them; else every row one at a time, a block threads rows.
struct Spans {
  long long n_vec;
  unsigned grid;
};

__host__ inline Spans spans(long long n, bool aligned, int threads, int vecs,
                            int rows_per_vec) {
  const long long n_vec = aligned ? n / rows_per_vec * rows_per_vec : 0;
  const long long per_block =
      aligned ? (long long)threads * vecs * rows_per_vec : threads;
  long long grid = (n + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  return {n_vec, (unsigned)grid};
}

constexpr int kUnaryThreads = 256;

constexpr int kUnaryVecs = 4;  // 16 B input vectors a thread holds in flight

// Each op's resident blocks an SM, in its instantiations' launch bounds:
// as many as the registers of the most demanding of them leave room for,
// so none spills (ptxas's report of each instantiation, printed by
// chip_smoke.py phase 11; PERF.md, section 6).
__host__ __device__ constexpr int unary_blocks(int op) {
  return is_log(op)                                   ? 2
         : op == kExp || op == kAsin || op == kAtan   ? 3
         : op == kIsnan || op == kNot                 ? 5
                                                      : 4;
}

// span_rows over vectors of E = 16 / sizeof(In) rows (x and a validity
// read at 16 B and E B alignment).
template <int OP, typename In>
__global__ void __launch_bounds__(kUnaryThreads, unary_blocks(OP))
    unary_kernel(const In* __restrict__ x, int scale,
                 const bool* __restrict__ valid, long long n, long long n_vec,
                 UnaryOut<OP, In>* __restrict__ out,
                 bool* __restrict__ out_valid) {
  using Op = UnaryOp<OP, In>;
  using Out = typename Op::Out;
  constexpr int E = 16 / sizeof(In);
  const bool reads = Op::kReadsValid && valid != nullptr;
  const Op op{kPow10[scale], ipow10(scale), scale > 0};
  struct Vec {
    Pack<In, E> x;
    Pack<bool, E> v;
  };
  span_rows<kUnaryThreads, kUnaryVecs, E, Vec>(
      n, n_vec,
      [&](long long k, Vec& in) {
        in.x = reinterpret_cast<const Pack<In, E>*>(x)[k];
        if (reads) in.v = reinterpret_cast<const Pack<bool, E>*>(valid)[k];
      },
      [&](long long k, const Vec& in) {
        Pack<Out, E> r;
        Pack<bool, E> ok;
#pragma unroll
        for (int e = 0; e < E; ++e)
          r.v[e] = op(in.x.v[e], reads ? in.v.v[e] : true, ok.v[e]);
        reinterpret_cast<Pack<Out, E>*>(out)[k] = r;
        if constexpr (is_log(OP))
          reinterpret_cast<Pack<bool, E>*>(out_valid)[k] = ok;
      },
      [&](long long i) {
        bool ok = false;
        out[i] = op(x[i], reads ? valid[i] : true, ok);
        if constexpr (is_log(OP)) out_valid[i] = ok;
      });
}

// One launch of unary_kernel<OP, In>: the rows in vectors where x (and a
// validity it reads) are aligned for them.
template <int OP, typename In>
cudaError_t unary_launch(const void* x, int scale, const bool* valid,
                         long long n, void* out, bool* out_valid,
                         cudaStream_t s) {
  constexpr int E = 16 / sizeof(In);
  const Spans g = spans(
      n,
      aligned_to(x, 16) &&
          (!UnaryOp<OP, In>::kReadsValid || aligned_to(valid, E)),
      kUnaryThreads, kUnaryVecs, E);
  unary_kernel<OP, In><<<g.grid, kUnaryThreads, 0, s>>>(
      static_cast<const In*>(x), scale, valid, n, g.n_vec,
      static_cast<UnaryOut<OP, In>*>(out), out_valid);
  return cudaGetLastError();
}

// OP over an input of the given type (~ of a double: none)
template <int OP>
cudaError_t unary_typed(const void* x, int type, int scale,
                        const bool* valid, long long n, void* out,
                        bool* out_valid, cudaStream_t s) {
  switch (type) {
    case kI32:
      return unary_launch<OP, int>(x, scale, valid, n, out, out_valid, s);
    case kI64:
      return unary_launch<OP, long long>(x, scale, valid, n, out, out_valid,
                                         s);
  }
  if constexpr (OP == kNot) {
    return cudaErrorInvalidValue;
  } else {
    return unary_launch<OP, double>(x, scale, valid, n, out, out_valid, s);
  }
}

// K12's dispatch table: every op of enum Unary (functions/numeric.py
// UNARY_OPS, in its order) has its instantiations
#define SAIL_UNARY_TABLE(X)                                                 \
  X(kSqrt) X(kExp) X(kExpm1) X(kLn) X(kLog10) X(kLog2) X(kLog1p) X(kSin)    \
  X(kCos) X(kTan) X(kAsin) X(kAcos) X(kAtan) X(kSinh) X(kCosh) X(kTanh)     \
  X(kCbrt) X(kRint) X(kDegrees) X(kRadians) X(kSign) X(kFloor) X(kCeil)     \
  X(kIsnan) X(kNot) X(kAbs) X(kNegative)

// ---------------------------------------------------------------------------
// K13: round (half up) and bround (half even)
// ---------------------------------------------------------------------------

constexpr int kUnroll = 4;  // rows a thread loads before it computes any

__global__ void round_kernel(const void* __restrict__ x, int t, long long n,
                 int half_even, int digits, int in_scale, int out_scale,
                 double fscale, void* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  int drop = in_scale - digits;
  long long f = drop > 0 && drop <= 18 ? ipow10(drop) : 1, half = f / 2;
  long long up_scale = drop <= 0 ? ipow10(out_scale - in_scale)
                                 : ipow10(out_scale - digits);
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < n; i0 += stride * kUnroll) {
    double d[kUnroll];
    long long v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long i = i0 + u * stride;
      if (i < n) {
        if (t == kF64)
          d[u] = static_cast<const double*>(x)[i];
        else
          v[u] = load_i(x, t, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long i = i0 + u * stride;
      if (i >= n) break;
      if (t == kF64) {
        double y = d[u] * fscale, r;
        if (half_even) {
          r = rint(y);
        } else {
          double s = y > 0.0 ? 1.0 : (y < 0.0 ? -1.0 : y);
          r = s * floor(fabs(y) + 0.5);
        }
        static_cast<double*>(out)[i] = r / fscale;
        continue;
      }
      long long r;
      if (drop <= 0) {
        r = v[u] * up_scale;
      } else if (drop > 18) {
        r = 0;  // |v| < 10^18 <= half of 10^drop
      } else {
        // v = q f + rem, 0 <= rem < f; a half goes to the even q (bround)
        // or away from zero (round): up from q for v >= 0, down for v < 0
        long long q = floor_div_pow10(v[u], f);
        long long rem = (long long)((unsigned long long)v[u] -
                                    (unsigned long long)q *
                                        (unsigned long long)f);
        if (half_even)
          q += (rem > half || (rem == half && (q & 1))) ? 1 : 0;
        else
          q += (v[u] < 0 ? rem > half : rem >= half) ? 1 : 0;
        r = (long long)((unsigned long long)q * (unsigned long long)up_scale);
      }
      if (t == kI32)
        static_cast<int*>(out)[i] = (int)r;
      else
        static_cast<long long*>(out)[i] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// K14: two-operand math and bitwise, one instantiation an operation and
// operand types
// ---------------------------------------------------------------------------

// power(x, 2) with the 2 a scalar, picked on the host: x * x, the correctly
// rounded square, where pow is within an ulp or two of it at several times
// the cost (E2's power(l_tax, 2))
constexpr int kSquare = kNanvl + 1;

__host__ __device__ constexpr bool is_bitwise(int op) {
  return op >= kAnd && op <= kShiftRight;
}

// The result's type: the first operand's for the bitwise ops, else a
// double.
template <int OP, typename X>
using BinaryOut = std::conditional_t<is_bitwise(OP), X, double>;

// The second operand as a scalar, in the type its instantiations read
// (BinaryArgs, scalar_of): the float ops' and nanvl's value as a double
// (unscaled / 10^scale), the bitwise ops' as an int64.
template <int OP>
using ScalarOf = std::conditional_t<is_bitwise(OP), long long, double>;

// A launch's constants: each operand's 10^scale (a decimal's), and a
// scalar second operand: its value read on the host (yd, yi), or its
// address on the card (ydev, of type ytype and y's scale, read once a
// thread), and its validity (one bool on the card, read once a thread, or
// none).
struct BinaryArgs {
  double px, py;
  bool sx, sy;  // scale > 0
  double yd;
  long long yi;
  const void* ydev;
  int ytype;
  const bool* yok;
};

// 10^k, k <= 18, on the host: the constants of kPow10.
constexpr double kHostPow10[19] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5, 1e6,
                                   1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
                                   1e14, 1e15, 1e16, 1e17, 1e18};

// A value of an operand as a double: a decimal as one division by
// 10^scale, as math_binary_plain divides (not a multiply by the
// reciprocal: bit-equal results).
template <typename T>
__device__ __forceinline__ double as_dbl(T v, bool scaled, double p) {
  if constexpr (std::is_same<T, double>::value) {
    return v;
  } else {
    const double d = (double)(long long)v;
    return scaled ? d / p : d;
  }
}

// A scalar second operand's value, in the type its instantiation reads.
template <typename Y>
__device__ __forceinline__ Y scalar_of(const BinaryArgs& p) {
  if constexpr (std::is_same<Y, double>::value) {
    if (p.ydev == nullptr) return p.yd;
    return p.ytype == kF64
               ? *static_cast<const double*>(p.ydev)
               : as_dbl<long long>(load_i(p.ydev, p.ytype, 0), p.sy, p.py);
  } else {
    return p.ydev == nullptr ? (Y)p.yi : (Y)load_i(p.ydev, p.ytype, 0);
  }
}

template <int OP>
__device__ __forceinline__ double float2(double x, double y) {
  if constexpr (OP == kAtan2) return atan2(x, y);
  if constexpr (OP == kHypot) return hypot(x, y);
  if constexpr (OP == kPower) return pow(x, y);
  if constexpr (OP == kSquare) return x * x;
  return log(y) / log(x);  // kLogBase: log(base x, value y)
}

// The bitwise ops in X's width: a shift count masked to 6 bits (5 for an
// int), shiftright arithmetic.
template <int OP, typename X>
__device__ __forceinline__ X bits2(long long x, long long y) {
  constexpr bool wide = sizeof(X) == 8;
  long long r;
  if constexpr (OP == kAnd) {
    r = x & y;
  } else if constexpr (OP == kOr) {
    r = x | y;
  } else if constexpr (OP == kXor) {
    r = x ^ y;
  } else if constexpr (OP == kShiftLeft) {
    r = wide ? (long long)((unsigned long long)x << (y & 63))
             : (long long)(int)((unsigned)x << (y & 31));
  } else {
    r = wide ? x >> (y & 63) : (long long)((int)x >> (y & 31));
  }
  return (X)r;
}

// One row: a the first operand, va its validity (true where it has none),
// get_y and get_yv the second's (read only where used: nanvl reads them
// where x is a NaN); ok the result's validity (functions/numeric.py
// math_binary_plain: both operands', and for log(b, x) NULL where either
// is <= 0; nanvl's y's where x is a non-NULL NaN, else x's).
template <int OP, typename X, typename Y, typename FY, typename FV>
__device__ __forceinline__ BinaryOut<OP, X> binary_row(
    const BinaryArgs& p, X a, bool va, FY get_y, FV get_yv, bool& ok) {
  if constexpr (OP == kNanvl) {
    const bool is_nan = isnan(a) && va;
    ok = is_nan ? get_yv() : va;
    return is_nan ? as_dbl<Y>(get_y(), p.sy, p.py) : a;
  } else if constexpr (is_bitwise(OP)) {
    ok = va && get_yv();
    return bits2<OP, X>((long long)a, (long long)get_y());
  } else {
    const double x = as_dbl<X>(a, p.sx, p.px);
    const double y = OP == kSquare ? 0.0 : as_dbl<Y>(get_y(), p.sy, p.py);
    ok = va && get_yv();
    if constexpr (OP == kLogBase) ok = ok && !(x <= 0.0) && !(y <= 0.0);
    return float2<OP>(x, y);
  }
}

constexpr int kBinaryThreads = 256;

__host__ __device__ constexpr bool is_libm2(int op) {
  return op == kAtan2 || op == kHypot || op == kPower || op == kLogBase;
}

// 16 B vectors of each operand a thread holds in flight: fewer for the
// libm ops, whose registers then leave room for more resident threads
__host__ __device__ constexpr int binary_vecs(int op) {
  return is_libm2(op) ? 2 : 4;
}

// Rows a vector: the widest of the columns read and written (their
// element sizes) takes 16 B.
__host__ __device__ constexpr int vec_rows(int a, int b, int c) {
  return 16 / (a > b ? (a > c ? a : c) : (b > c ? b : c));
}

// Each instantiation's resident blocks an SM, in its launch bounds (op,
// rows a vector): as many as its registers leave room for, none spilling
// (chip_smoke.py phase 11 prints each instantiation's registers and fails
// on a spill).
__host__ __device__ constexpr int binary_blocks(int op, int rows) {
  return is_libm2(op) || rows == 4 ? 3 : 4;
}

// The vector loop's reads: y as vectors beside x (not a scalar, not
// nanvl's y, read where x is a NaN)
template <int OP, bool YS>
__host__ __device__ constexpr bool vec_y() {
  return !YS && OP != kNanvl;
}

template <int OP, typename X, typename Y, bool YS>
__host__ __device__ constexpr int binary_rows() {
  return vec_rows(sizeof(X), vec_y<OP, YS>() ? sizeof(Y) : 1,
                  sizeof(BinaryOut<OP, X>));
}

// span_rows over vectors of E rows (every column and validity aligned for
// them), binary_vecs of each operand in flight. YS: the second operand is
// the scalar of p (y unused). nanvl reads y and its validity at the rows
// where x is a NaN only, one at a time. Validities are read where the
// launch writes one (out_valid), and nanvl's x's always.
template <int OP, typename X, typename Y, bool YS>
__global__ void __launch_bounds__(kBinaryThreads,
                                  binary_blocks(OP,
                                                binary_rows<OP, X, Y, YS>()))
    binary_kernel(const X* __restrict__ x, const bool* __restrict__ xv,
                  const Y* __restrict__ y, const bool* __restrict__ yv,
                  const BinaryArgs p, long long n, long long n_vec,
                  BinaryOut<OP, X>* __restrict__ out,
                  bool* __restrict__ out_valid) {
  using Out = BinaryOut<OP, X>;
  constexpr bool kVecY = vec_y<OP, YS>();
  constexpr int E = binary_rows<OP, X, Y, YS>();
  Y ys{};
  bool yok = true;
  if constexpr (YS) {
    ys = scalar_of<Y>(p);
    yok = p.yok == nullptr || *p.yok;
  }
  // the second operand of row i, where it is not in a vector: the scalar,
  // or read from its column
  auto y_at = [&](long long i) -> Y {
    if constexpr (YS)
      return ys;
    else
      return y[i];
  };
  auto yv_at = [&](long long i) -> bool {
    if constexpr (YS)
      return yok;
    else
      return yv == nullptr || yv[i];
  };
  struct Vec {
    Pack<X, E> x;
    Pack<Y, E> y;
    Pack<bool, E> xv, yv;
  };
  span_rows<kBinaryThreads, binary_vecs(OP), E, Vec>(
      n, n_vec,
      [&](long long k, Vec& in) {
        in.x = reinterpret_cast<const Pack<X, E>*>(x)[k];
        if constexpr (kVecY) in.y = reinterpret_cast<const Pack<Y, E>*>(y)[k];
        if (xv != nullptr)
          in.xv = reinterpret_cast<const Pack<bool, E>*>(xv)[k];
        if (kVecY && yv != nullptr)
          in.yv = reinterpret_cast<const Pack<bool, E>*>(yv)[k];
      },
      [&](long long k, const Vec& in) {
        Pack<Out, E> r;
        Pack<bool, E> ok;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const long long i = k * E + e;
          r.v[e] = binary_row<OP, X, Y>(
              p, in.x.v[e], xv == nullptr || in.xv.v[e],
              [&]() -> Y {
                if constexpr (kVecY)
                  return in.y.v[e];
                else
                  return y_at(i);
              },
              [&]() -> bool {
                if constexpr (kVecY)
                  return yv == nullptr || in.yv.v[e];
                else
                  return yv_at(i);
              },
              ok.v[e]);
        }
        reinterpret_cast<Pack<Out, E>*>(out)[k] = r;
        if (out_valid != nullptr)
          reinterpret_cast<Pack<bool, E>*>(out_valid)[k] = ok;
      },
      [&](long long i) {
        bool ok = false;
        out[i] = binary_row<OP, X, Y>(
            p, x[i], xv == nullptr || xv[i], [&]() { return y_at(i); },
            [&]() { return yv_at(i); }, ok);
        if (out_valid != nullptr) out_valid[i] = ok;
      });
}

// One K14 call's operands, as sail_math_binary takes them.
struct BinaryCall {
  const void *x, *xv, *y, *yv;
  int x_type, y_type;
  bool y_scalar;
  BinaryArgs p;
  long long n;
  void *out, *out_valid;
  cudaStream_t s;
};

// One launch of binary_kernel<OP, X, Y, YS>: the rows in vectors where
// every column and validity it reads is aligned for them.
template <int OP, typename X, typename Y, bool YS>
cudaError_t binary_launch(const BinaryCall& c) {
  using Out = BinaryOut<OP, X>;
  constexpr bool kVecY = vec_y<OP, YS>();
  constexpr int E = binary_rows<OP, X, Y, YS>();
  const Spans g = spans(
      c.n,
      aligned_to(c.x, sizeof(Pack<X, E>)) && aligned_to(c.xv, E) &&
          aligned_to(c.out, sizeof(Pack<Out, E>)) &&
          aligned_to(c.out_valid, E) &&
          (!kVecY ||
           (aligned_to(c.y, sizeof(Pack<Y, E>)) && aligned_to(c.yv, E))),
      kBinaryThreads, binary_vecs(OP), E);
  binary_kernel<OP, X, Y, YS><<<g.grid, kBinaryThreads, 0, c.s>>>(
      static_cast<const X*>(c.x), static_cast<const bool*>(c.xv),
      static_cast<const Y*>(c.y), static_cast<const bool*>(c.yv), c.p, c.n,
      g.n_vec, static_cast<Out*>(c.out), static_cast<bool*>(c.out_valid));
  return cudaGetLastError();
}

// OP over a first operand of type X: the second a scalar, or a column of
// its type (a bitwise op of a double: none; kSquare: a scalar only)
template <int OP, typename X>
cudaError_t binary_second(const BinaryCall& c) {
  if (c.y_scalar) return binary_launch<OP, X, ScalarOf<OP>, true>(c);
  if constexpr (OP == kSquare) {
    return cudaErrorInvalidValue;
  } else {
    switch (c.y_type) {
      case kI32:
        return binary_launch<OP, X, int, false>(c);
      case kI64:
        return binary_launch<OP, X, long long, false>(c);
    }
    if constexpr (is_bitwise(OP))
      return cudaErrorInvalidValue;
    else
      return binary_launch<OP, X, double, false>(c);
  }
}

// OP over a first operand of the given type (the bitwise ops: integers;
// nanvl: a double)
template <int OP>
cudaError_t binary_typed(const BinaryCall& c) {
  if constexpr (OP != kNanvl) {
    switch (c.x_type) {
      case kI32:
        return binary_second<OP, int>(c);
      case kI64:
        return binary_second<OP, long long>(c);
    }
  }
  if constexpr (is_bitwise(OP))
    return cudaErrorInvalidValue;
  else
    return c.x_type == kF64 ? binary_second<OP, double>(c)
                            : cudaErrorInvalidValue;
}

// K14's dispatch table: every op of enum Binary (functions/numeric.py
// BINARY_OPS, in its order) has its instantiations (power by a scalar 2
// also kSquare's)
#define SAIL_BINARY_TABLE(X)                                          \
  X(kAtan2) X(kHypot) X(kPower) X(kLogBase) X(kAnd) X(kOr) X(kXor)    \
  X(kShiftLeft) X(kShiftRight) X(kNanvl)

// ---------------------------------------------------------------------------
// K15: the calendar, one instantiation an operation and operand types
// ---------------------------------------------------------------------------

// The first day of each month of 1900-2100 (and of 2101-01), and the
// month of each day of those years, built once on the host
// (functions/numeric.py calendar_tables) into buffers the module keeps
// and read through the read-only data cache: a date in those years finds
// its month with one load, where the arithmetic takes a dozen divisions
// (the dates the queries read span a few years: a few KB of the tables).
constexpr int kYear0 = 1900;
constexpr int kMonths = 201 * 12;
constexpr int kDay0 = -25567;  // 1900-01-01
constexpr int kDays = 73414;   // to 2101-01-01

// An operand's kind: int32 days (or months), int64 days (or months), or
// int64 local microseconds (kMicros), and the type it is read as.
template <int K>
using CalIn = std::conditional_t<K == kI32, int, long long>;

template <int OP>
using CalOut = std::conditional_t<OP == kMonthsBetween, double, int>;

struct MonthTable {
  const int* starts;  // month j's first day
  const short* of;    // the month of day kDay0 + i

  __device__ __forceinline__ int operator[](int j) const {
    return __ldg(starts + j);
  }
  // the month index of ``days``, -1 outside the tables
  __device__ __forceinline__ int month_of(int days) const {
    const unsigned at = (unsigned)(days - kDay0);
    return at < (unsigned)kDays ? (int)__ldg(of + at) : -1;
  }
};

// A date (days) or a timestamp (local µs): its days and the fraction of
// its day.
template <int K>
__device__ __forceinline__ int day_of(long long v, double* frac) {
  if constexpr (K != kMicros) {
    *frac = 0.0;
    return (int)v;
  } else {
    const long long days = floor_div(v, kDayUs);
    *frac = ((double)(v - days * kDayUs) / 1e6) / 86400.0;
    return (int)days;
  }
}

// A date's month, as a number (months since 1900-01, for any date), its
// day of the month and the month's length: from the tables within them,
// else by the arithmetic.
struct MonthDay {
  int n, d, len;
};

__device__ __forceinline__ MonthDay month_day(const MonthTable& ms,
                                              int days) {
  const int j = ms.month_of(days);
  if (j >= 0) {
    const int first = ms[j];
    return {j, days - first + 1, ms[j + 1] - first};
  }
  int y, m, d;
  civil_from_days(days, y, m, d);
  return {(y - kYear0) * 12 + m - 1, d, month_len(y, m)};
}

#define SAIL_OVER31(n) ((n) / 31.0)
// n / 31.0 for n in -30..30, the day difference of two dates (their
// fraction of a month in months_between: a division a row otherwise)
__device__ const double kOver31[61] = {
    SAIL_OVER31(-30), SAIL_OVER31(-29), SAIL_OVER31(-28), SAIL_OVER31(-27),
    SAIL_OVER31(-26), SAIL_OVER31(-25), SAIL_OVER31(-24), SAIL_OVER31(-23),
    SAIL_OVER31(-22), SAIL_OVER31(-21), SAIL_OVER31(-20), SAIL_OVER31(-19),
    SAIL_OVER31(-18), SAIL_OVER31(-17), SAIL_OVER31(-16), SAIL_OVER31(-15),
    SAIL_OVER31(-14), SAIL_OVER31(-13), SAIL_OVER31(-12), SAIL_OVER31(-11),
    SAIL_OVER31(-10), SAIL_OVER31(-9),  SAIL_OVER31(-8),  SAIL_OVER31(-7),
    SAIL_OVER31(-6),  SAIL_OVER31(-5),  SAIL_OVER31(-4),  SAIL_OVER31(-3),
    SAIL_OVER31(-2),  SAIL_OVER31(-1),  SAIL_OVER31(0),   SAIL_OVER31(1),
    SAIL_OVER31(2),   SAIL_OVER31(3),   SAIL_OVER31(4),   SAIL_OVER31(5),
    SAIL_OVER31(6),   SAIL_OVER31(7),   SAIL_OVER31(8),   SAIL_OVER31(9),
    SAIL_OVER31(10),  SAIL_OVER31(11),  SAIL_OVER31(12),  SAIL_OVER31(13),
    SAIL_OVER31(14),  SAIL_OVER31(15),  SAIL_OVER31(16),  SAIL_OVER31(17),
    SAIL_OVER31(18),  SAIL_OVER31(19),  SAIL_OVER31(20),  SAIL_OVER31(21),
    SAIL_OVER31(22),  SAIL_OVER31(23),  SAIL_OVER31(24),  SAIL_OVER31(25),
    SAIL_OVER31(26),  SAIL_OVER31(27),  SAIL_OVER31(28),  SAIL_OVER31(29),
    SAIL_OVER31(30)};
#undef SAIL_OVER31

// One row of OP (functions/numeric.py calendar_plain) of a (kind XK) and
// b (kind YK: months for add_months; a date or timestamp for
// months_between); cs/fs: months_between's scalar second operand (YS),
// taken apart once a thread.
template <int OP, int XK, int YK, bool YS>
__device__ __forceinline__ CalOut<OP> calendar_row(const MonthTable& ms,
                                                   long long a,
                                                   long long b,
                                                   const MonthDay& cs,
                                                   double fs) {
  if constexpr (OP == kMonthsBetween) {
    double f1, f2 = fs;
    const MonthDay c = month_day(ms, day_of<XK>(a, &f1));
    const MonthDay c2 = YS ? cs : month_day(ms, day_of<YK>(b, &f2));
    // whole months on the same day of the month, or on the last day of
    // both months (time of day ignored); else 31 days a month
    const bool whole = c.d == c2.d || (c.d == c.len && c2.d == c2.len);
    double frac;
    if constexpr (XK != kMicros && YK != kMicros)  // dates: f1 = f2 = 0
      frac = __ldg(kOver31 + (c.d - c2.d + 30));
    else
      frac = ((double)(c.d - c2.d) + f1 - f2) / 31.0;
    const double r = (double)(c.n - c2.n) + (whole ? 0.0 : frac);
    return rint(r * 1e8) / 1e8;
  } else {
    double f1;
    const int days = day_of<XK>(a, &f1);
    if constexpr (OP == kWeekOfYear) {  // ISO week: its Thursday's week
      const int dow = days + 3 - floor_div32(days + 3, 7) * 7;  // Monday 0
      const int thursday = days - dow + 3;
      const int j = ms.month_of(thursday);
      if (j >= 0) return (thursday - ms[j - j % 12]) / 7 + 1;
      int y, m, d;
      civil_from_days(thursday, y, m, d);
      return (thursday - days_from_civil(y, 1, 1)) / 7 + 1;
    } else {
      const int k = OP == kAddMonths ? (int)b : 0;
      const int j = ms.month_of(days);
      if (OP == kAddMonths && j >= 0 && j + k >= 0 && j + k < kMonths) {
        // within the table: the day of the month, then the target
        // month's start and length
        const int start = ms[j + k];
        const int len = ms[j + k + 1] - start;
        return start + min(days - ms[j] + 1, len) - 1;
      }
      if (OP == kLastDay && j >= 0) return ms[j + 1] - 1;
      int y, m, d;
      civil_from_days(days, y, m, d);
      if constexpr (OP == kAddMonths) {
        const int months = y * 12 + (m - 1) + k;
        const int ny = floor_div32(months, 12);
        const int nm = months - ny * 12 + 1;
        return days_from_civil(ny, nm, min(d, month_len(ny, nm)));
      } else {
        return days - d + month_len(y, m);
      }
    }
  }
}

constexpr int kCalThreads = 256;

// 16 B vectors a thread holds in flight, and resident blocks an SM in the
// launch bounds: as many as each op's registers leave room for, none
// spilling
__host__ __device__ constexpr int calendar_vecs(int op) {
  return op == kAddMonths || op == kMonthsBetween ? 2 : 4;
}

__host__ __device__ constexpr int calendar_blocks(int op) {
  return op == kMonthsBetween ? 3 : 4;
}

__host__ __device__ constexpr bool two_operands(int op) {
  return op == kAddMonths || op == kMonthsBetween;
}

// A scalar second operand: its word (an int64 of its kind) read on the
// host, or its address on the card (an int64, read once a thread), and
// its validity (one bool on the card, read once a thread, or none).
struct CalScalar {
  long long word;
  const long long* dev;
  const bool* valid;
};

// span_rows over vectors of E rows, calendar_vecs a thread in flight. x
// (and its validity xv) is the first operand, y (and yv) the second's
// column, or with YS the scalar s. Validities are read where the launch
// writes one (out_valid: both operands have one).
template <int OP, int XK, int YK, bool YS>
__global__ void __launch_bounds__(kCalThreads, calendar_blocks(OP))
    calendar_kernel(const CalIn<XK>* __restrict__ x,
                    const bool* __restrict__ xv,
                    const CalIn<YK>* __restrict__ y,
                    const bool* __restrict__ yv, const CalScalar s,
                    const MonthTable ms, long long n, long long n_vec,
                    CalOut<OP>* __restrict__ out,
                    bool* __restrict__ out_valid) {
  using X = CalIn<XK>;
  using Y = CalIn<YK>;
  using Out = CalOut<OP>;
  constexpr bool kVecY = two_operands(OP) && !YS;
  constexpr int E =
      vec_rows(sizeof(X), kVecY ? sizeof(Y) : 1, sizeof(Out));
  const bool valid = out_valid != nullptr;
  long long word = 0;
  bool sok = true;
  MonthDay cs{};
  double fs = 0.0;
  if constexpr (YS) {
    word = s.dev != nullptr ? *s.dev : s.word;
    sok = s.valid == nullptr || *s.valid;
    if constexpr (OP == kMonthsBetween)
      cs = month_day(ms, day_of<YK>(word, &fs));
  }
  struct Vec {
    Pack<X, E> x;
    Pack<Y, E> y;
    Pack<bool, E> xv, yv;
  };
  span_rows<kCalThreads, calendar_vecs(OP), E, Vec>(
      n, n_vec,
      [&](long long k, Vec& in) {
        in.x = reinterpret_cast<const Pack<X, E>*>(x)[k];
        if constexpr (kVecY) in.y = reinterpret_cast<const Pack<Y, E>*>(y)[k];
        if (valid) {
          in.xv = reinterpret_cast<const Pack<bool, E>*>(xv)[k];
          if constexpr (kVecY)
            in.yv = reinterpret_cast<const Pack<bool, E>*>(yv)[k];
        }
      },
      [&](long long k, const Vec& in) {
        Pack<Out, E> r;
        Pack<bool, E> ok;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          long long w = word;
          bool wv = sok;
          if constexpr (kVecY) {
            w = (long long)in.y.v[e];
            wv = !valid || in.yv.v[e];
          }
          r.v[e] = calendar_row<OP, XK, YK, YS>(ms, (long long)in.x.v[e], w,
                                                cs, fs);
          if (valid) ok.v[e] = in.xv.v[e] && wv;
        }
        reinterpret_cast<Pack<Out, E>*>(out)[k] = r;
        if (valid) reinterpret_cast<Pack<bool, E>*>(out_valid)[k] = ok;
      },
      [&](long long i) {
        long long w = word;
        bool wv = sok;
        if constexpr (kVecY) {
          w = (long long)y[i];
          wv = !valid || yv[i];
        }
        out[i] = calendar_row<OP, XK, YK, YS>(ms, (long long)x[i], w, cs, fs);
        if (valid) out_valid[i] = xv[i] && wv;
      });
}

// One K15 call's operands, as sail_calendar takes them.
struct CalendarCall {
  const void *x, *xv, *y, *yv;
  int x_kind, y_kind;
  bool y_scalar;
  CalScalar scalar;
  MonthTable tables;
  long long n;
  void *out, *out_valid;
  cudaStream_t s;
};

template <int OP, int XK, int YK, bool YS>
cudaError_t calendar_launch(const CalendarCall& c) {
  using X = CalIn<XK>;
  using Y = CalIn<YK>;
  using Out = CalOut<OP>;
  constexpr bool kVecY = two_operands(OP) && !YS;
  constexpr int E =
      vec_rows(sizeof(X), kVecY ? sizeof(Y) : 1, sizeof(Out));
  const Spans g = spans(
      c.n,
      aligned_to(c.x, sizeof(Pack<X, E>)) && aligned_to(c.xv, E) &&
          aligned_to(c.out, sizeof(Pack<Out, E>)) &&
          aligned_to(c.out_valid, E) &&
          (!kVecY ||
           (aligned_to(c.y, sizeof(Pack<Y, E>)) && aligned_to(c.yv, E))),
      kCalThreads, calendar_vecs(OP), E);
  calendar_kernel<OP, XK, YK, YS><<<g.grid, kCalThreads, 0, c.s>>>(
      static_cast<const X*>(c.x), static_cast<const bool*>(c.xv),
      static_cast<const Y*>(c.y), static_cast<const bool*>(c.yv), c.scalar,
      c.tables, c.n, g.n_vec, static_cast<Out*>(c.out),
      static_cast<bool*>(c.out_valid));
  return cudaGetLastError();
}

// OP over a first operand of kind XK: one operand; or the second a scalar
// (its word an int64 of its kind); or the second a column of its kind (a
// count of months for add_months)
template <int OP, int XK>
cudaError_t calendar_operands(const CalendarCall& c) {
  if constexpr (!two_operands(OP)) {
    return calendar_launch<OP, XK, kI32, false>(c);
  } else {
    if (c.y_scalar) {
      if constexpr (OP == kMonthsBetween) {
        if (c.y_kind == kMicros)
          return calendar_launch<OP, XK, kMicros, true>(c);
      }
      return calendar_launch<OP, XK, kI64, true>(c);
    }
    switch (c.y_kind) {
      case kI32:
        return calendar_launch<OP, XK, kI32, false>(c);
      case kI64:
        return calendar_launch<OP, XK, kI64, false>(c);
    }
    if constexpr (OP == kMonthsBetween)
      return calendar_launch<OP, XK, kMicros, false>(c);
    else
      return cudaErrorInvalidValue;
  }
}

template <int OP>
cudaError_t calendar_typed(const CalendarCall& c) {
  switch (c.x_kind) {
    case kI32:
      return calendar_operands<OP, kI32>(c);
    case kI64:
      return calendar_operands<OP, kI64>(c);
  }
  return calendar_operands<OP, kMicros>(c);
}

// K15's dispatch table: every op of enum Calendar (functions/numeric.py
// CALENDAR_OPS, in its order) has its instantiations
#define SAIL_CALENDAR_TABLE(X) \
  X(kAddMonths) X(kMonthsBetween) X(kLastDay) X(kWeekOfYear)

bool bad_type(int t) { return t < kI32 || t > kF64; }

}  // namespace

// K12. type: 0 int32, 1 int64, 2 float64; scale: the decimal scale of an
// int64 of unscaled decimals (0 otherwise); out_valid: written by the
// logarithms only (else null). One host switch picks the op's
// instantiation.
extern "C" int sail_math_unary(const void* x, int type, int scale,
                               const void* valid, long long n, int op,
                               void* out, void* out_valid, void* stream) {
  if (bad_type(type) || scale < 0 || scale > 18)
    return (int)cudaErrorInvalidValue;
  if (is_log(op) && out_valid == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* v = static_cast<const bool*>(valid);
  bool* ov = static_cast<bool*>(out_valid);
  switch (op) {
#define SAIL_UNARY_CASE(OP) \
  case OP:                  \
    return (int)unary_typed<OP>(x, type, scale, v, n, out, ov, s);
    SAIL_UNARY_TABLE(SAIL_UNARY_CASE)
#undef SAIL_UNARY_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K13. half_even: 0 round, 1 bround; fscale = 10.0 ** digits (doubles).
extern "C" int sail_round(const void* x, int type, long long n, int half_even,
                          int digits, int in_scale, int out_scale,
                          double fscale, void* out, int grid, void* stream) {
  if (bad_type(type) || in_scale < 0 || in_scale > 18 || out_scale < 0 ||
      out_scale > 18 || out_scale - digits > 18 || out_scale < in_scale - 18)
    return (int)cudaErrorInvalidValue;
  round_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, type, n, half_even, digits, in_scale, out_scale, fscale, out);
  return (int)cudaGetLastError();
}

// K14. x: a column of type x_type (0 int32, 1 int64, 2 float64; an
// unscaled decimal of x_scale) with its validity or null; y: a column of
// y_type likewise, or (y_scalar) a scalar: null, and its value y_double
// (the float ops and nanvl: unscaled / 10^scale) or y_word (the bitwise
// ops) read on the host; or its address on the card (of y_type and
// y_scale); its validity one bool on the card or null. square: power by a
// scalar 2 read on the host (x * x). out_valid: written where not null,
// and then the validities given are read. One host switch picks the
// instantiation.
extern "C" int sail_math_binary(const void* x, int x_type, int x_scale,
                                const void* x_valid, const void* y,
                                int y_type, int y_scale, const void* y_valid,
                                int y_scalar, double y_double,
                                long long y_word, long long n, int op,
                                int square, void* out, void* out_valid,
                                void* stream) {
  if (bad_type(x_type) || bad_type(y_type) || x_scale < 0 || x_scale > 18 ||
      y_scale < 0 || y_scale > 18 ||
      (square && !(op == kPower && y_scalar && y == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool* yok = y_scalar ? static_cast<const bool*>(y_valid) : nullptr;
  BinaryCall c{x,        x_valid,
               y,        y_valid,
               x_type,   y_type,
               y_scalar != 0,
               BinaryArgs{kHostPow10[x_scale], kHostPow10[y_scale],
                          x_scale > 0, y_scale > 0, y_double, y_word,
                          y_scalar ? y : nullptr, y_type, yok},
               n,        out,
               out_valid, static_cast<cudaStream_t>(stream)};
  if (square) return (int)binary_typed<kSquare>(c);
  switch (op) {
#define SAIL_BINARY_CASE(OP) \
  case OP:                   \
    return (int)binary_typed<OP>(c);
    SAIL_BINARY_TABLE(SAIL_BINARY_CASE)
#undef SAIL_BINARY_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K15. x_kind, y_kind: 0 int32 days (or months), 1 int64 days (or months),
// 2 int64 local microseconds. y: a column, or (y_scalar) a scalar: null
// and its value word (an int64 of its kind) read on the host, or its
// int64 on the card; y_valid: y's validity, a scalar's one bool on the
// card, or null. month_starts (int32, kMonths + 1) and month_of_day
// (int16, kDays): the tables of functions/numeric.py calendar_tables on
// the card. out_valid: written where not null (both operands have a
// validity). One host switch picks the instantiation.
extern "C" int sail_calendar(const void* x, int x_kind, const void* x_valid,
                             const void* y, int y_kind, const void* y_valid,
                             int y_scalar, long long word, long long n,
                             int op, const void* month_starts,
                             const void* month_of_day, void* out,
                             void* out_valid, void* stream) {
  if (x_kind < kI32 || x_kind > kMicros || y_kind < kI32 ||
      y_kind > kMicros || month_starts == nullptr ||
      month_of_day == nullptr)
    return (int)cudaErrorInvalidValue;
  CalendarCall c{x,
                 x_valid,
                 y,
                 y_valid,
                 x_kind,
                 y_kind,
                 y_scalar != 0,
                 CalScalar{word,
                           y_scalar ? static_cast<const long long*>(y)
                                    : nullptr,
                           y_scalar ? static_cast<const bool*>(y_valid)
                                    : nullptr},
                 MonthTable{static_cast<const int*>(month_starts),
                            static_cast<const short*>(month_of_day)},
                 n,
                 out,
                 out_valid,
                 static_cast<cudaStream_t>(stream)};
  switch (op) {
#define SAIL_CALENDAR_CASE(OP) \
  case OP:                     \
    return (int)calendar_typed<OP>(c);
    SAIL_CALENDAR_TABLE(SAIL_CALENDAR_CASE)
#undef SAIL_CALENDAR_CASE
  }
  return (int)cudaErrorInvalidValue;
}
