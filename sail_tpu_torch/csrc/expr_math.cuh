// K12-K15's per-element functions, shared by csrc/expr_math.cu (the
// kernels K12-K15) and csrc/chain.cuh (K16 and K17, which run the same
// functions inside a chain's program).
#pragma once

// NVRTC, which compiles K16 and K17 (csrc/chain_jit.cu), has no host
// headers: the two limits of <climits> used here
#ifdef __CUDACC_RTC__
#ifndef LLONG_MAX
#define LLONG_MAX 9223372036854775807LL
#define LLONG_MIN (-LLONG_MAX - 1LL)
#endif
#else
#include <climits>
#endif

// the host build of the chain tests (tests/test_torch_chain_codegen.py)
// defines CUDART_PI itself
#ifndef CUDART_PI
#include <math_constants.h>
#endif

namespace {

enum Type { kI32 = 0, kI64 = 1, kF64 = 2 };

__constant__ double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

__device__ __forceinline__ long long ipow10(int k) {
  long long p = 1;
  for (int i = 0; i < k; ++i) p *= 10;
  return p;
}

// Row i of a column of type t, as int64 (K13).
__device__ __forceinline__ long long load_i(const void* p, int t, long long i) {
  if (t == kI32) return (long long)static_cast<const int*>(p)[i];
  if (t == kI64) return static_cast<const long long*>(p)[i];
  return (long long)static_cast<const double*>(p)[i];
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// floor(v / f) for f = 10^k: one float64 division where |v| < 2^52 and
// f < 2^52 (the quotient then rounds to no integer but its own floor's),
// else the integer division.
__device__ __forceinline__ long long floor_div_pow10(long long v, long long f) {
  if (v > -(1ll << 52) && v < (1ll << 52) && f < (1ll << 52))
    return (long long)floor((double)v / (double)f);
  return floor_div(v, f);
}

// Spark's non-ANSI cast of a double to a long: toward zero, NaN is 0, out
// of range saturates (the chain's F2I).
__device__ __forceinline__ long long sat_i64(double v) {
  if (isnan(v)) return 0;
  if (v >= 9.2233720368547758e18) return LLONG_MAX;
  if (v <= -9.2233720368547758e18) return LLONG_MIN;
  return (long long)v;
}

// ... and to an int, as an int64 word (F2I32; SMALLINT and TINYINT keep
// its low bits).
__device__ __forceinline__ long long sat_i32(double v) {
  if (isnan(v)) return 0;
  if (v >= 2147483647.0) return 2147483647ll;
  if (v <= -2147483648.0) return -2147483648ll;
  return (long long)(int)v;
}

enum Unary {
  kSqrt = 0, kExp, kExpm1, kLn, kLog10, kLog2, kLog1p, kSin, kCos, kTan,
  kAsin, kAcos, kAtan, kSinh, kCosh, kTanh, kCbrt, kRint, kDegrees,
  kRadians, kSign, kFloor, kCeil, kIsnan, kNot, kAbs, kNegative
};

__device__ __forceinline__ double float_op(int op, double x) {
  switch (op) {
    case kSqrt: return sqrt(x);
    case kExp: return exp(x);
    case kExpm1: return expm1(x);
    case kLn: return log(x);
    case kLog10: return log10(x);
    case kLog2: return log2(x);
    case kLog1p: return log1p(x);
    case kSin: return sin(x);
    case kCos: return cos(x);
    case kTan: return tan(x);
    case kAsin: return asin(x);
    case kAcos: return acos(x);
    case kAtan: return atan(x);
    case kSinh: return sinh(x);
    case kCosh: return cosh(x);
    case kTanh: return tanh(x);
    case kCbrt: return cbrt(x);
    case kRint: return rint(x);
    case kDegrees: return x * (180.0 / CUDART_PI);
    case kRadians: return x * (CUDART_PI / 180.0);
  }
  // kSign
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);
}

enum Binary {
  kAtan2 = 0, kHypot, kPower, kLogBase, kAnd, kOr, kXor, kShiftLeft,
  kShiftRight, kNanvl
};

enum Calendar { kAddMonths = 0, kMonthsBetween, kLastDay, kWeekOfYear };

constexpr int kMicros = 2;  // an operand of local microseconds (int64)
constexpr long long kDayUs = 86400000000ll;

__device__ __forceinline__ int floor_div32(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// days since 1970-01-01 -> (year, month, day), proleptic Gregorian, in
// 32-bit integers (Hinnant's algorithm, written for truncating division).
__device__ __forceinline__ void civil_from_days(int days, int& y, int& m,
                                                int& d) {
  int z = days + 719468;
  int era = (z >= 0 ? z : z - 146096) / 146097;
  int doe = z - era * 146097;
  int yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  int doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  int mp = (5 * doy + 2) / 153;
  d = doy - (153 * mp + 2) / 5 + 1;
  m = mp < 10 ? mp + 3 : mp - 9;
  y = yoe + era * 400 + (m <= 2);
}

__device__ __forceinline__ int days_from_civil(int y, int m, int d) {
  y -= m <= 2;
  int era = (y >= 0 ? y : y - 399) / 400;
  int yoe = y - era * 400;
  int mp = m > 2 ? m - 3 : m + 9;
  int doy = (153 * mp + 2) / 5 + d - 1;
  int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ int month_len(int y, int m) {
  bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
  return m == 2 ? 28 + leap : 30 + ((m + (m >> 3)) & 1);
}

}  // namespace
