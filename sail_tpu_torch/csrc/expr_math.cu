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
// K12 is instantiated an operation and input type (unary_kernel<OP, In>,
// SAIL_UNARY_TABLE): a kernel that took the operation as an argument held
// every libm function of the switch in one body and its registers, and ran
// 5-46% behind one PyTorch call on the same column. Each instantiation
// moves 16 B vectors where the column is aligned, kUnaryVecs of them in
// flight a thread, and its op has its own launch bounds (unary_blocks).
// K13-K15 run a grid-stride loop, one row per thread an iteration, so
// neighbouring threads read neighbouring addresses; their operation is an
// argument uniform across the grid (K15: an instantiation an op), so no
// warp diverges on it. K13 loads four rows a thread before it computes
// any, which ran faster there; in K14 and K15 it took more registers and
// ran slower. K14 and K15 are held to 32 registers a thread
// (__launch_bounds__(256, 8)), so that a full SM's worth of threads keeps
// loads in flight; K13 ran slower so, spilling.
// Integer division by
// a power of ten goes through one float64 division where the dividend is
// below 2^52 (exact there), and the calendar works in 32-bit integers
// (days fit in an int32): 64-bit integer division is many instructions on
// the card. pow by a constant 2 (E2's power(l_tax, 2)) is x * x.

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
// division by 10^scale, as load_d does; v: the row's validity, read by
// the logarithms (which write their own, ok) and isnan only.
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

// Rows [0, n_vec) in vectors of E = 16 / sizeof(In) rows (n_vec a
// multiple of E; x and a validity read at 16 B and E B alignment), a thread
// loading kUnaryVecs of them, kUnaryThreads apart, before it computes
// any; rows [n_vec, n) one at a time. A block takes one span of vectors:
// the grid covers the rows once, as PyTorch's elementwise kernels do (a
// grid-stride loop over the resident blocks alone ran slower: PERF.md,
// section 6).
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
  const long long nv = n_vec / E;
  constexpr int V = kUnaryVecs;
  const long long span = (long long)kUnaryThreads * V;
  for (long long k0 = (long long)blockIdx.x * span + threadIdx.x; k0 < nv;
       k0 += (long long)gridDim.x * span) {
    Pack<In, E> xs[V];
    Pack<bool, E> vs[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long k = k0 + u * kUnaryThreads;
      if (k >= nv) continue;
      xs[u] = reinterpret_cast<const Pack<In, E>*>(x)[k];
      if (reads) vs[u] = reinterpret_cast<const Pack<bool, E>*>(valid)[k];
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const long long k = k0 + u * kUnaryThreads;
      if (k >= nv) continue;
      Pack<Out, E> r;
      Pack<bool, E> ok;
#pragma unroll
      for (int e = 0; e < E; ++e)
        r.v[e] = op(xs[u].v[e], reads ? vs[u].v[e] : true, ok.v[e]);
      reinterpret_cast<Pack<Out, E>*>(out)[k] = r;
      if constexpr (is_log(OP))
        reinterpret_cast<Pack<bool, E>*>(out_valid)[k] = ok;
    }
  }
  const long long stride = (long long)gridDim.x * kUnaryThreads;
  for (long long i = n_vec + (long long)blockIdx.x * kUnaryThreads +
                     threadIdx.x;
       i < n; i += stride) {
    bool ok = false;
    out[i] = op(x[i], reads ? valid[i] : true, ok);
    if constexpr (is_log(OP)) out_valid[i] = ok;
  }
}

// One launch of unary_kernel<OP, In>: the rows in vectors where x (and a
// validity it reads) are aligned for them, a block a span of them.
template <int OP, typename In>
cudaError_t unary_launch(const void* x, int scale, const bool* valid,
                         long long n, void* out, bool* out_valid,
                         cudaStream_t s) {
  constexpr int E = 16 / sizeof(In);
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      (!UnaryOp<OP, In>::kReadsValid || valid == nullptr ||
       reinterpret_cast<uintptr_t>(valid) % E == 0);
  const long long n_vec = aligned ? n / E * E : 0;
  const long long rows_per_block =
      aligned ? (long long)kUnaryThreads * kUnaryVecs * E : kUnaryThreads;
  long long grid = (n + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  unary_kernel<OP, In><<<(unsigned)grid, kUnaryThreads, 0, s>>>(
      static_cast<const In*>(x), scale, valid, n, n_vec,
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
// K14: two-operand math and bitwise
// ---------------------------------------------------------------------------

struct Operand {
  const void* data;
  int type, scale;
  long long step;  // 1 for a column, 0 for a scalar
  const bool* valid;

  __device__ __forceinline__ long long i64(long long i) const {
    return load_i(data, type, i * step);
  }
  __device__ __forceinline__ double f64(long long i) const {
    return load_d(data, type, scale, i * step);
  }
  __device__ __forceinline__ bool ok(long long i) const {
    return valid == nullptr || valid[i * step];
  }
};

__global__ void __launch_bounds__(256, 8)
    binary_kernel(Operand a, Operand b, long long n, int op, int out_type,
                  void* __restrict__ out, bool* __restrict__ out_valid) {
  long long stride = (long long)gridDim.x * blockDim.x;
  bool wide = out_type == kI64;
  // pow(x, 2) as x * x: the correctly rounded square, where pow is within
  // an ulp or two of it at several times the cost
  bool square = op == kPower && b.step == 0 && b.f64(0) == 2.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool ok = a.ok(i) && b.ok(i);
    if (op == kNanvl) {
      double x = a.f64(i);
      bool is_nan = isnan(x) && a.ok(i);
      static_cast<double*>(out)[i] = is_nan ? b.f64(i) : x;
      ok = is_nan ? b.ok(i) : a.ok(i);
    } else if (op <= kLogBase) {
      double x = a.f64(i), y = b.f64(i), r;
      if (op == kAtan2) {
        r = atan2(x, y);
      } else if (op == kHypot) {
        r = hypot(x, y);
      } else if (op == kPower) {
        r = square ? x * x : pow(x, y);
      } else {  // log(base x, value y): NULL where either is <= 0
        r = log(y) / log(x);
        ok = ok && !(x <= 0.0) && !(y <= 0.0);
      }
      static_cast<double*>(out)[i] = r;
    } else {
      long long x = a.i64(i), y = b.i64(i), r;
      if (op == kAnd) {
        r = x & y;
      } else if (op == kOr) {
        r = x | y;
      } else if (op == kXor) {
        r = x ^ y;
      } else if (op == kShiftLeft) {
        r = wide ? (long long)((unsigned long long)x << (y & 63))
                 : (long long)(int)((unsigned)x << (y & 31));
      } else {  // arithmetic shift right
        r = wide ? x >> (y & 63) : (long long)((int)x >> (y & 31));
      }
      if (wide)
        static_cast<long long*>(out)[i] = r;
      else
        static_cast<int*>(out)[i] = (int)r;
    }
    if (out_valid != nullptr) out_valid[i] = ok;
  }
}

// ---------------------------------------------------------------------------
// K15: the calendar
// ---------------------------------------------------------------------------

// A date (days, int32 or int64) or a timestamp (local µs): its days and the
// fraction of its day.
__device__ __forceinline__ int day_of(const Operand& o, long long i,
                                      double* frac) {
  if (o.type != kMicros) {
    *frac = 0.0;
    return (int)o.i64(i);
  }
  long long v = static_cast<const long long*>(o.data)[i * o.step];
  long long days = floor_div(v, kDayUs);
  *frac = ((double)(v - days * kDayUs) / 1e6) / 86400.0;
  return (int)days;
}

// The first day of each month of 1900-2100 (and of 2101-01), in shared
// memory: a date in that range finds its month from an estimate and one
// or two comparisons, where the arithmetic takes a dozen divisions.
constexpr int kYear0 = 1900;
constexpr int kMonths = 201 * 12;

struct Civil {
  int y, m, d;
  int j;  // month index from 1900-01 in the table, -1 outside it
};

// The table's index of the month holding ``days``, -1 outside the table:
// an estimate at 30.436875 days a month, then a step or two.
__device__ __forceinline__ int month_index(const int* ms, int days) {
  if (days < ms[0] || days >= ms[kMonths]) return -1;
  int j = (int)((float)(days - ms[0]) * (1.0f / 30.436875f));
  j = min(max(j, 0), kMonths - 1);
  while (ms[j] > days) --j;
  while (ms[j + 1] <= days) ++j;
  return j;
}

__device__ __forceinline__ Civil civil(const int* ms, int days) {
  Civil c;
  c.j = month_index(ms, days);
  if (c.j < 0) {
    civil_from_days(days, c.y, c.m, c.d);
    return c;
  }
  c.y = kYear0 + c.j / 12;
  c.m = c.j - (c.y - kYear0) * 12 + 1;
  c.d = days - ms[c.j] + 1;
  return c;
}

__device__ __forceinline__ int length_of(const int* ms, const Civil& c) {
  return c.j >= 0 ? ms[c.j + 1] - ms[c.j] : month_len(c.y, c.m);
}

__device__ __forceinline__ int month_start(const int* ms, int y, int m) {
  int j = (y - kYear0) * 12 + (m - 1);
  return j >= 0 && j < kMonths ? ms[j] : days_from_civil(y, m, 1);
}

// One instantiation an operation (OP), so each holds only its own code.
template <int OP>
__global__ void __launch_bounds__(256, 8)
    calendar_kernel(Operand a, Operand b, long long n,
                    void* __restrict__ out, bool* __restrict__ out_valid) {
  constexpr int op = OP;
  __shared__ int ms[kMonths + 1];
  for (int j = threadIdx.x; j <= kMonths; j += blockDim.x)
    ms[j] = days_from_civil(kYear0 + j / 12, j % 12 + 1, 1);
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  bool two = op == kAddMonths || op == kMonthsBetween;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    double f1, f2 = 0.0;
    int days = day_of(a, i, &f1);
    if (op == kWeekOfYear) {  // ISO week: the week of its Thursday
      int dow = days + 3 - floor_div32(days + 3, 7) * 7;  // Monday 0
      int thursday = days - dow + 3;
      Civil t = civil(ms, thursday);
      static_cast<int*>(out)[i] =
          (thursday - month_start(ms, t.y, 1)) / 7 + 1;
    } else {
      int k = op == kAddMonths ? (int)b.i64(i) : 0;
      int j = op == kMonthsBetween ? -1 : month_index(ms, days);
      if (op == kAddMonths && j >= 0 && j + k >= 0 && j + k < kMonths) {
        // within the table: the day of the month, then the target month's
        // start and length
        int start = ms[j + k];
        int len = ms[j + k + 1] - start;
        static_cast<int*>(out)[i] = start + min(days - ms[j] + 1, len) - 1;
      } else if (op == kLastDay && j >= 0) {
        static_cast<int*>(out)[i] = ms[j + 1] - 1;
      } else if (op != kMonthsBetween) {
        int y, m, d;
        civil_from_days(days, y, m, d);
        if (op == kAddMonths) {
          int months = y * 12 + (m - 1) + k;
          int ny = floor_div32(months, 12);
          int nm = months - ny * 12 + 1;
          static_cast<int*>(out)[i] =
              days_from_civil(ny, nm, min(d, month_len(ny, nm)));
        } else {
          static_cast<int*>(out)[i] = days - d + month_len(y, m);
        }
      } else {
        Civil c = civil(ms, days);
        Civil c2 = civil(ms, day_of(b, i, &f2));
        // whole months on the same day of the month, or on the last day
        // of both months (time of day ignored); else 31 days a month
        bool whole = c.d == c2.d || (c.d == length_of(ms, c) &&
                                     c2.d == length_of(ms, c2));
        double months = (double)((c.y - c2.y) * 12 + (c.m - c2.m));
        double r = months +
                   (whole ? 0.0 : ((double)(c.d - c2.d) + f1 - f2) / 31.0);
        static_cast<double*>(out)[i] = rint(r * 1e8) / 1e8;
      }
    }
    if (out_valid != nullptr) out_valid[i] = a.ok(i) && (!two || b.ok(i));
  }
}

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

// K14. Each operand: data, type, decimal scale, scalar flag (read row 0 for
// every row), validity or null. out_type: 0 int32, 1 int64, 2 float64.
extern "C" int sail_math_binary(const void* x, int x_type, int x_scale,
                                int x_scalar, const void* x_valid,
                                const void* y, int y_type, int y_scale,
                                int y_scalar, const void* y_valid,
                                long long n, int op, int out_type, void* out,
                                void* out_valid, int grid, void* stream) {
  if (bad_type(x_type) || bad_type(y_type) || bad_type(out_type) ||
      x_scale < 0 || x_scale > 18 || y_scale < 0 || y_scale > 18 ||
      op < kAtan2 || op > kNanvl)
    return (int)cudaErrorInvalidValue;
  Operand a{x, x_type, x_scale, x_scalar ? 0ll : 1ll,
            static_cast<const bool*>(x_valid)};
  Operand b{y, y_type, y_scale, y_scalar ? 0ll : 1ll,
            static_cast<const bool*>(y_valid)};
  binary_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, op, out_type, out, static_cast<bool*>(out_valid));
  return (int)cudaGetLastError();
}

// K15. x_type, y_type: 0 int32 days (or months), 1 int64 days (or months),
// 2 int64 local microseconds.
extern "C" int sail_calendar(const void* x, int x_type, int x_scalar,
                             const void* x_valid, const void* y, int y_type,
                             int y_scalar, const void* y_valid, long long n,
                             int op, void* out, void* out_valid, int grid,
                             void* stream) {
  if (bad_type(x_type) || bad_type(y_type) || op < kAddMonths ||
      op > kWeekOfYear)
    return (int)cudaErrorInvalidValue;
  Operand a{x, x_type, 0, x_scalar ? 0ll : 1ll,
            static_cast<const bool*>(x_valid)};
  Operand b{y, y_type, 0, y_scalar ? 0ll : 1ll,
            static_cast<const bool*>(y_valid)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool* ov = static_cast<bool*>(out_valid);
  switch (op) {
    case kAddMonths:
      calendar_kernel<kAddMonths><<<grid, 256, 0, s>>>(a, b, n, out, ov);
      break;
    case kMonthsBetween:
      calendar_kernel<kMonthsBetween><<<grid, 256, 0, s>>>(a, b, n, out, ov);
      break;
    case kLastDay:
      calendar_kernel<kLastDay><<<grid, 256, 0, s>>>(a, b, n, out, ov);
      break;
    default:
      calendar_kernel<kWeekOfYear><<<grid, 256, 0, s>>>(a, b, n, out, ov);
  }
  return (int)cudaGetLastError();
}
