// K16, K17 and K18: the device functions and the skeleton of the kernels
// that sail_tpu_torch/ops/chain_codegen.py generates, one for each chain
// program, and csrc/chain_jit.cu compiles with NVRTC when a chain is
// bound.
//
// Replaces the device programs XLA compiled for sail_tpu/exec/local.py's
// fused Filter/Project chain (`_pipeline_chain`, `_try_fused_chain`,
// `_run_chain`, `_apply_chain`, `_compile_chain`, :1585-1760) and, where the
// aggregate above it is keyless or directly binned, the aggregate's fused
// builder (:1765-1930).
//
// A generated kernel is the chain's program written out as straight-line
// C++: one statement an instruction over locals that hold a 64-bit word (an
// int64, or a double's bits) and a validity each, every input loaded at its
// physical type, every output stored at its type, the SQL's constants as
// literals. Its row body runs inside `for_rows`: a warp takes kRows x 32
// consecutive rows at a time, lane-interleaved, so each load and store is
// coalesced across the warp, and the grid is one wave of resident blocks.
// K16 writes the selection and each stored column once; dead rows are
// computed too, as the torch closures compute them. K17 ends each row in
// its bin's accumulators: keyless, each thread keeps one partial a slot in
// registers for the whole loop and the block combines them once at the
// end; directly binned (at most 4096 bins, numbered as K2,
// csrc/direct_group.cu, numbers them), the warp combines the lanes of one
// bin (__match_any_sync and common.cuh reduce_peers' shuffle tree, its
// steps shared by all the row's accumulators) and one lane adds into the
// block's accumulators in shared memory, which the block adds into the
// global ones once. A warp whose rows a filter has all killed skips the
// rest of its program. COUNT, SUM (int64 wrapping; float64 by atomics, in
// an order that varies between runs, as K1's binned sums), MIN and MAX
// have K1's identities and NaN order (csrc/seg_reduce.cu).
//
// K18 replaces sail_tpu/exec/local.py `_fused_sort` (:1403-1450) up to its
// lexsort: K16's row body, then each sort key's K3 word
// (order_keys.cuh's bits, as K3 writes them; a dictionary code already
// mapped through its rank table by the program's LUT) and validity
// stored, and the key's least and greatest word over the live rows (a
// grouping's key: its live non-null rows) kept in registers across the
// thread's rows; the block combines them once (reduce_warp_word, then
// block_slot: one 64-bit atomicMin and atomicMax a key and block). The
// host reads the extremes once and packs the words (ops/sort.py).
// Bound: bytes: K16's, plus 8 B a key word and 1 B a key validity
// written.
//
// Bound: bytes for a short program (each input read once, K16's outputs
// written once); a long one (ClickBench Q30: 90 int64 sums of one column)
// by its own arithmetic.
//
// Compiled with --fmad=false: a*b+c would otherwise contract into an FMA,
// one rounding where the torch ops it mirrors round twice; without the
// contraction every float64 instruction is the IEEE operation torch does.
// int64 arithmetic wraps through unsigned operations, as torch's tensors
// wrap. Conversions a literal could fold use the intrinsics (no undefined
// behaviour for the optimiser to assume).
//
// The tests build the scalar part on the host with g++ (SAIL_CHAIN_HOST:
// the warp skeleton left out).

#pragma once

#ifndef SAIL_CHAIN_HOST
#include "common.cuh"
#endif
#include "expr_math.cuh"
#include "order_keys.cuh"

namespace {

// physical types: ops/chain.py TYPE_CODE
enum Phys { kBool = 0, kI8, kI16, kPI32, kPI64, kF32, kF64p };

// accumulators: ops/chain.py ACC_KINDS
enum Acc { kCount = 0, kSumI, kSumF, kMinI, kMaxI, kMinF, kMaxF };

constexpr int kBlock = 128;

__device__ __forceinline__ double dbl(long long w) {
  return __longlong_as_double(w);
}

__device__ __forceinline__ long long wrd(double x) {
  return __double_as_longlong(x);
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

__device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  return a - floor_div(a, b) * b;
}

// The type functions/numeric.py reads a physical type in (expr_math.cuh's
// Type): the narrow integers as int32, float32 as float64.
__host__ __device__ constexpr int kernel_type(int t) {
  return t == kPI64 ? kI64 : (t == kF32 || t == kF64p) ? kF64 : kI32;
}

__device__ __forceinline__ double as_double(long long w, int kt, int scale) {
  if (kt == kF64) return dbl(w);
  double v = (double)w;
  return scale ? v / kPow10[scale] : v;
}

// functions/numeric.py civil_from_days and days_from_civil in int64, with
// floor division, as the torch versions compute them.
__device__ __forceinline__ void civil64(long long days, long long& y,
                                        long long& m, long long& d) {
  long long z = days + 719468;
  long long era = floor_div(z >= 0 ? z : z - 146096, 146097);
  long long doe = z - era * 146097;
  long long yoe = floor_div(doe - floor_div(doe, 1460) +
                                floor_div(doe, 36524) -
                                floor_div(doe, 146096),
                            365);
  y = yoe + era * 400;
  long long doy = doe - (365 * yoe + floor_div(yoe, 4) - floor_div(yoe, 100));
  long long mp = floor_div(5 * doy + 2, 153);
  d = doy - floor_div(153 * mp + 2, 5) + 1;
  m = mp < 10 ? mp + 3 : mp - 9;
  if (m <= 2) y += 1;
}

__device__ __forceinline__ long long days_from_civil64(long long y,
                                                       long long m,
                                                       long long d) {
  y -= m <= 2;
  long long era = floor_div(y >= 0 ? y : y - 399, 400);
  long long yoe = y - era * 400;
  long long mp = m > 2 ? m - 3 : m + 9;
  long long doy = floor_div(153 * mp + 2, 5) + d - 1;
  long long doe = yoe * 365 + floor_div(yoe, 4) - floor_div(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ long long month_len64(long long y, long long m) {
  bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
  if (m < 1 || m > 12) m = 1;
  return m == 2 ? 28 + leap : 30 + ((m + (m >> 3)) & 1);
}

// K12 (csrc/expr_math.cu unary_kernel) on one word: op OP of a value of
// kernel type KT.
template <int OP, int KT>
__device__ __forceinline__ long long num1(int scale, long long w, bool va,
                                          bool* ok) {
  *ok = va;
  if (OP <= kSign) {
    double v = as_double(w, KT, scale);
    if (OP == kLn || OP == kLog10 || OP == kLog2 || OP == kLog1p)
      *ok = (OP == kLog1p ? !(v <= -1.0) : !(v <= 0.0)) && va;
    return wrd(float_op(OP, v));
  }
  if (OP == kFloor || OP == kCeil) {
    if (KT == kF64) {
      double v = dbl(w);
      return sat_i64(OP == kFloor ? floor(v) : ceil(v));
    }
    long long f = ipow10(scale);
    return OP == kFloor ? floor_div_pow10(w, f) : -floor_div_pow10(-w, f);
  }
  if (OP == kIsnan) {
    *ok = true;
    return KT == kF64 && isnan(dbl(w)) && va;
  }
  if (KT == kF64) {  // abs, negative
    double v = dbl(w);
    return wrd(OP == kAbs ? fabs(v) : -v);
  }
  unsigned long long u = (unsigned long long)w;
  unsigned long long neg = 0ull - u;
  unsigned long long r = OP == kNot ? ~u
                         : OP == kNegative ? neg
                         : ((long long)u < 0 ? neg : u);
  return KT == kI32 ? (long long)(int)(unsigned)r : (long long)r;
}

// K14 (csrc/expr_math.cu binary_kernel) on one pair of words; B_CONST: y is
// a constant of the program (pow by 2 is x * x, as K14 computes it).
template <int OP, int KX, int KY, bool B_CONST>
__device__ __forceinline__ long long num2(int sx, int sy, long long a,
                                          long long b, bool va, bool vb,
                                          bool* ok) {
  *ok = va && vb;
  if (OP == kNanvl) {
    double x = as_double(a, KX, sx);
    bool is_nan = isnan(x) && va;
    *ok = is_nan ? vb : va;
    return wrd(is_nan ? as_double(b, KY, sy) : x);
  }
  if (OP <= kLogBase) {
    double x = as_double(a, KX, sx), y = as_double(b, KY, sy), r;
    if (OP == kAtan2) {
      r = atan2(x, y);
    } else if (OP == kHypot) {
      r = hypot(x, y);
    } else if (OP == kPower) {
      r = B_CONST && y == 2.0 ? x * x : pow(x, y);
    } else {
      r = log(y) / log(x);
      *ok = *ok && !(x <= 0.0) && !(y <= 0.0);
    }
    return wrd(r);
  }
  const bool wide = KX == kI64;
  long long r;
  if (OP == kAnd) {
    r = a & b;
  } else if (OP == kOr) {
    r = a | b;
  } else if (OP == kXor) {
    r = a ^ b;
  } else if (OP == kShiftLeft) {
    r = wide ? (long long)((unsigned long long)a << (b & 63))
             : (long long)(int)((unsigned)a << (b & 31));
  } else {
    r = wide ? a >> (b & 63) : (long long)((int)a >> (b & 31));
  }
  return wide ? r : (long long)(int)r;
}

// K13 (csrc/expr_math.cu round_kernel) on one word of kernel type KT.
template <int KT, bool HALF_EVEN>
__device__ __forceinline__ long long round_word(long long w, int digits,
                                                int in_scale, int out_scale,
                                                double fscale) {
  if (KT == kF64) {
    double y = dbl(w) * fscale, r;
    if (HALF_EVEN) {
      r = rint(y);
    } else {
      double s = y > 0.0 ? 1.0 : (y < 0.0 ? -1.0 : y);
      r = s * floor(fabs(y) + 0.5);
    }
    return wrd(r / fscale);
  }
  int drop = in_scale - digits;
  long long r;
  if (drop <= 0) {
    r = (long long)((unsigned long long)w *
                    (unsigned long long)ipow10(out_scale - in_scale));
  } else if (drop > 18) {
    r = 0;
  } else {
    long long f = ipow10(drop), half = f / 2;
    long long q = floor_div_pow10(w, f);
    long long rem = (long long)((unsigned long long)w -
                                (unsigned long long)q * (unsigned long long)f);
    if (HALF_EVEN)
      q += (rem > half || (rem == half && (q & 1))) ? 1 : 0;
    else
      q += (w < 0 ? rem > half : rem >= half) ? 1 : 0;
    r = (long long)((unsigned long long)q *
                    (unsigned long long)ipow10(out_scale - digits));
  }
  return KT == kI32 ? (long long)(int)r : r;
}

// A K15 operand: a date's days, or local microseconds' days and the
// fraction of the day.
__device__ __forceinline__ int cal_day(long long w, bool micros,
                                       double* frac) {
  if (!micros) {
    *frac = 0.0;
    return (int)w;
  }
  long long days = floor_div(w, kDayUs);
  *frac = ((double)(w - days * kDayUs) / 1e6) / 86400.0;
  return (int)days;
}

// K15 (csrc/expr_math.cu calendar_kernel, its arithmetic path) on one word
// or pair; XM, YM: the operand is local microseconds.
template <int OP, bool XM, bool YM>
__device__ __forceinline__ long long cal_word(long long a, long long b) {
  double f1, f2 = 0.0;
  int days = cal_day(a, XM, &f1);
  int y, m, d;
  if (OP == kWeekOfYear) {
    int dow = days + 3 - floor_div32(days + 3, 7) * 7;
    int thursday = days - dow + 3;
    civil_from_days(thursday, y, m, d);
    return (thursday - days_from_civil(y, 1, 1)) / 7 + 1;
  }
  civil_from_days(days, y, m, d);
  if (OP == kAddMonths) {
    int months = y * 12 + (m - 1) + (int)b;
    int ny = floor_div32(months, 12);
    int nm = months - ny * 12 + 1;
    return days_from_civil(ny, nm, min(d, month_len(ny, nm)));
  }
  if (OP == kLastDay) return days - d + month_len(y, m);
  int y2, m2, d2;
  civil_from_days(cal_day(b, YM, &f2), y2, m2, d2);
  bool whole = d == d2 || (d == month_len(y, m) && d2 == month_len(y2, m2));
  double months = (double)((y - y2) * 12 + (m - m2));
  double r = months + (whole ? 0.0 : ((double)(d - d2) + f1 - f2) / 31.0);
  return wrd(rint(r * 1e8) / 1e8);
}

// DATEFIELD (chain.py DATE_FIELDS[FIELD]) of days a, as plan/compiler.py's
// torch ops compute it.
template <int FIELD>
__device__ __forceinline__ long long date_field(long long a) {
  long long y, m, dd;
  civil64(a, y, m, dd);
  switch (FIELD) {
    case 0: return y;
    case 1: return m;
    case 2: return dd;
    case 3: return floor_div(m - 1, 3) + 1;
    case 4: return floor_mod(a + 4, 7) + 1;
    case 5: return floor_mod(a + 3, 7);
  }
  return a - days_from_civil64(y, 1, 1) + 1;
}

// TRUNCDAYS (chain.py TRUNC_FMTS[UNIT]) of days a.
template <int UNIT>
__device__ __forceinline__ long long trunc_days(long long a) {
  long long y, m, dd;
  civil64(a, y, m, dd);
  return UNIT == 0   ? days_from_civil64(y, 1, 1)
         : UNIT == 1 ? days_from_civil64(y, floor_div(m - 1, 3) * 3 + 1, 1)
         : UNIT == 2 ? days_from_civil64(y, m, 1)
                     : a - floor_mod(a + 3, 7);
}

// YMADD: days a plus SIGN x b months, the day clamped into the month.
template <int SIGN>
__device__ __forceinline__ long long ym_add(long long a, long long b) {
  long long y, m, dd;
  civil64(a, y, m, dd);
  long long months = y * 12 + (m - 1) + (long long)SIGN * b;
  long long ny = floor_div(months, 12), nm = floor_mod(months, 12) + 1;
  return days_from_civil64(ny, nm, min(dd, month_len64(ny, nm)));
}

template <int K>
struct Combine {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    if (K == kMinI) return a < b ? a : b;
    if (K == kMaxI) return a > b ? a : b;
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  __device__ __forceinline__ double operator()(double a, double b) const {
    if (K == kSumF) return a + b;
    if (isnan(a) || isnan(b)) return __longlong_as_double(0x7ff8000000000000LL);
    if (K == kMinF) return a < b ? a : b;
    return a > b ? a : b;
  }
};

// Accumulator word q combined with the row's value word v.
template <int K>
__device__ __forceinline__ long long combine_word(long long q, long long v) {
  if (K == kSumF || K == kMinF || K == kMaxF)
    return wrd(Combine<K>()(dbl(q), dbl(v)));
  return Combine<K == kCount ? kSumI : K>()(q, v);
}

#ifndef SAIL_CHAIN_HOST

// Combine v into *addr (shared or global memory) atomically.
template <int K>
__device__ __forceinline__ void atomic_word(unsigned long long* addr,
                                           long long v) {
  if (K == kCount || K == kSumI) {
    atomicAdd(addr, (unsigned long long)v);
  } else if (K == kMinI) {
    atomicMin(reinterpret_cast<long long*>(addr), v);
  } else if (K == kMaxI) {
    atomicMax(reinterpret_cast<long long*>(addr), v);
  } else if (K == kSumF) {
    atomicAdd(reinterpret_cast<double*>(addr), dbl(v));
  } else {
    unsigned long long old = *addr, assumed;
    do {
      assumed = old;
      double next = Combine<K>()(dbl((long long)assumed), dbl(v));
      unsigned long long bits = (unsigned long long)wrd(next);
      if (bits == assumed) return;
      old = atomicCAS(addr, assumed, bits);
    } while (old != assumed);
  }
}

// v combined over the whole warp (every lane calls it; every lane ends
// with the total).
template <int K>
__device__ __forceinline__ long long reduce_warp_word(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine_word<K>(v, __shfl_xor_sync(SAIL_FULL_MASK, v, off));
  return v;
}

// Whether any lane of the warp has a live row (every lane calls it).
__device__ __forceinline__ bool warp_any(bool live) {
  return __any_sync(SAIL_FULL_MASK, live);
}

// The keyless tail of one slot: the block's warps' partials (red: one a
// warp) combined and added to the global accumulator once, where they
// moved it from its identity.
template <int K>
__device__ __forceinline__ void block_slot(const long long* red, int warps,
                                           long long ident,
                                           unsigned long long* acc) {
  long long v = red[0];
  for (int w = 1; w < warps; ++w) v = combine_word<K>(v, red[w]);
  if (v != ident) atomic_word<K>(acc, v);
}

// The grid-stride row loop: f(at, in) for each of this thread's rows, at
// clamped into the table (in: the row exists). Every lane of a warp runs
// the same iterations, so warp collectives with the full mask are legal in
// f.
template <int kRows, typename F>
__device__ __forceinline__ void for_rows(long long n, F&& f) {
  const int lane = threadIdx.x & 31;
  const long long span = 32LL * kRows;
  const long long warp = ((long long)blockIdx.x * kBlock + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kBlock) >> 5;
  for (long long chunk = warp * span; chunk < n; chunk += warps * span) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long row = chunk + k * 32 + lane;
      f(row < n ? row : n - 1, row < n);
    }
  }
}

#endif  // SAIL_CHAIN_HOST

}  // namespace
