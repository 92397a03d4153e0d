// K16 and K17: a Filter/Project chain's program, run over every row.
//
// Replaces the device programs XLA compiled for sail_tpu/exec/local.py's
// fused Filter/Project chain (`_pipeline_chain`, `_try_fused_chain`,
// `_run_chain`, `_apply_chain`, `_compile_chain`, :1585-1760) and, where the
// aggregate above it is keyless or directly binned, the aggregate's fused
// builder (:1765-1930).
//
// sail_chain (K16): an interpreter of the program that
// sail_tpu_torch/ops/chain.py builds from the chain's expression fragments:
// a flat list of instructions over numbered registers, each a 64-bit word
// (an int64, or a double's bits) with a validity bit; an operand may also
// name a constant of the program's table. The instruction stream is the
// same for every thread (copied into shared memory once a block), so the
// switch on the opcode never diverges within a warp; the registers are a
// block-wide array in shared memory, [register][row][thread], allocated by
// liveness in Python. It writes the selection once and each stored column
// once, at its type. Dead rows (outside the selection) are computed too,
// as the torch closures compute them, so a consumer that reads a dead row
// (a dictionary code through a lookup table) finds a value in range.
//
// Design, as measured on the card (PERF.md): the interpreter is
// latency-bound, each instruction a chain of shared-memory round trips and
// a jump, so it is built to overlap that chain: a warp takes 4 x 32
// consecutive rows at a time and a thread carries its 4 rows through each
// instruction (one decode for 4 rows; at 8 rows the registers spilled and
// it ran slower); the grid is one wave of resident blocks (a second,
// partial wave idled most SMs); 64 registers a thread (__launch_bounds__
// (128, 8)) for 8 resident blocks an SM; the heavy, rarer operations
// (K12-K15's functions, the calendar) are out of line. One row a thread,
// the first form, took 1.741 ms for a 4-instruction program over 60M rows
// whose bytes take 0.107 ms.
//
// sail_chain_reduce (K17): the same interpreter, ending in a reduction
// instead of the stores: BIN instructions number the row's bin as K2
// (csrc/direct_group.cu) numbers it (1 bin when keyless, at most 4096),
// PEERS counts the bin's live rows, and each ACC adds a value to its
// (bin, slot) accumulator: COUNT, SUM (int64 wrapping; float64 by atomics,
// whose order varies between runs, as K1's binned sums), MIN and MAX with
// K1's identities and NaN order (csrc/seg_reduce.cu). A warp first
// combines the lanes of one bin (__match_any_sync and a shuffle tree; when
// keyless, each thread its own rows, then a butterfly over the warp), one
// lane adds to the block's accumulators in shared memory, and each block
// adds its accumulators into the global ones once. A warp whose rows a
// filter has all killed skips the rest of the program.
//
// Bound: bytes. A chain reads each input column once and writes the
// selection and each stored column once; K17 writes nothing per row. The
// interpreter spends a few dozen instructions on each instruction of the
// program and row, so a long program over narrow columns (ClickBench Q30:
// 90 sums of one int32 column) is bound by that instead. Specializing the
// program at build time, and tensor-core and TMA staging, are later work.
//
// Built with --fmad=false (csrc/__init__.py): nvcc would fuse a*b+c into an
// FMA, one rounding where the torch ops it mirrors round twice; without the
// contraction every float64 instruction is the IEEE operation torch does.

#include <climits>

#include "common.cuh"
#include "expr_math.cuh"

namespace {

// opcodes: sail_tpu_torch/ops/chain.py OPCODES, in the same order
enum Op {
  kCol = 0, kConst, kAddI, kSubI, kMulI, kAddF, kSubF, kMulF, kDivF, kWrap,
  kI2F, kI2F32, kF2F32, kF2I, kNe0I, kNe0F, kTruncF, kRhaF, kCmpI, kCmpF,
  kAnd3, kOr3, kNotB, kIsNull, kIsNotNull, kSelect, kSelV, kPassV, kSetV,
  kAndV, kBandNv, kBor, kNullifI, kNullifF, kEqnsI, kEqnsF, kExtI, kExtF,
  kSdivI, kSdivF, kSmodI, kSmodF, kPmodfixI, kPmodfixF, kRescale,
  kFloorDiv, kFloorMod, kDateField, kTruncDays, kYmAdd, kNum1, kNum2,
  kRound, kCal, kLut, kFilter, kStore, kBin, kPeers, kAcc, kNumOps
};

// physical types: chain.py TYPE_CODE
enum Phys { kBool = 0, kI8, kI16, kPI32, kPI64, kF32, kF64p };

// accumulators: chain.py ACC_KINDS
enum Acc { kCount = 0, kSumI, kSumF, kMinI, kMaxI, kMinF, kMaxF };

constexpr int kBlock = 128;
constexpr int kRows = 4;  // rows a thread carries through each instruction
constexpr int kMaxIn = 64;
constexpr int kMaxOut = 128;
constexpr size_t kMaxSmem = 227 * 1024;

struct Instr {
  int op, dst, a, b, c, i0, i1, i2;
};

struct TableDesc {
  long long ptr, len, type;
};

struct Io {
  const void* in[kMaxIn];
  const unsigned char* in_valid[kMaxIn];
  void* out[kMaxOut];
  unsigned char* out_valid[kMaxOut];
};

struct Prog {
  const Instr* instrs;
  int ninstr;
  const long long* consts;
  const unsigned char* const_valid;
  const TableDesc* tables;
  const int* types;  // the inputs' physical types, then the outputs'
  int ninputs, nreg;
  const unsigned char* sel;
  long long n;
  unsigned char* sel_out;
  int nbins, nslots;
  const int* slot_kinds;
  const long long* slot_ident;
  unsigned long long* acc;
};

__device__ __forceinline__ double dbl(long long w) {
  return __longlong_as_double(w);
}

__device__ __forceinline__ long long wrd(double x) {
  return __double_as_longlong(x);
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  return a - floor_div(a, b) * b;
}

// A value of physical type t at p[i], as a register word.
__device__ __forceinline__ long long load_word(const void* p, int t,
                                               long long i) {
  switch (t) {
    case kBool: return static_cast<const unsigned char*>(p)[i] != 0;
    case kI8: return static_cast<const signed char*>(p)[i];
    case kI16: return static_cast<const short*>(p)[i];
    case kPI32: return static_cast<const int*>(p)[i];
    case kPI64: return static_cast<const long long*>(p)[i];
    case kF32: return wrd((double)static_cast<const float*>(p)[i]);
  }
  return static_cast<const long long*>(p)[i];  // float64's bits
}

__device__ __forceinline__ void store_word(void* p, int t, long long i,
                                           long long w) {
  switch (t) {
    case kBool: static_cast<unsigned char*>(p)[i] = w != 0; return;
    case kI8: static_cast<signed char*>(p)[i] = (signed char)w; return;
    case kI16: static_cast<short*>(p)[i] = (short)w; return;
    case kPI32: static_cast<int*>(p)[i] = (int)w; return;
    case kF32: static_cast<float*>(p)[i] = (float)dbl(w); return;
  }
  static_cast<long long*>(p)[i] = w;  // int64, float64's bits
}

// The type functions/numeric.py reads a physical type in (expr_math.cuh's
// Type): the narrow integers as int32, float32 as float64.
__device__ __forceinline__ int kernel_type(int t) {
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

// The heavy, rarer operations (K12-K15's functions, the calendar) are out
// of line: inlined into the interpreter's switch they made its hot cases
// far apart in a large binary (instruction-cache misses at every jump)
// and held registers the common cases do not need.

// K12 (csrc/expr_math.cu unary_kernel) on one word.
__device__ __noinline__ long long num1(int op, int kt, int scale,
                                          long long w, bool va, bool* ok) {
  *ok = va;
  if (op <= kSign) {
    double v = as_double(w, kt, scale);
    if (op == kLn || op == kLog10 || op == kLog2 || op == kLog1p)
      *ok = (op == kLog1p ? !(v <= -1.0) : !(v <= 0.0)) && va;
    return wrd(float_op(op, v));
  }
  if (op == kFloor || op == kCeil) {
    if (kt == kF64) {
      double v = dbl(w);
      return sat_i64(op == kFloor ? floor(v) : ceil(v));
    }
    long long f = ipow10(scale);
    return op == kFloor ? floor_div_pow10(w, f) : -floor_div_pow10(-w, f);
  }
  if (op == kIsnan) {
    *ok = true;
    return kt == kF64 && isnan(dbl(w)) && va;
  }
  if (kt == kF64) {  // abs, negative
    double v = dbl(w);
    return wrd(op == kAbs ? fabs(v) : -v);
  }
  unsigned long long u = (unsigned long long)w;
  unsigned long long neg = 0ull - u;
  unsigned long long r = op == kNot ? ~u
                         : op == kNegative ? neg
                         : ((long long)u < 0 ? neg : u);
  return kt == kI32 ? (long long)(int)(unsigned)r : (long long)r;
}

// K14 (csrc/expr_math.cu binary_kernel) on one pair of words; b_const: y is
// a constant (pow by a constant 2 is x * x, as K14 computes it).
__device__ __noinline__ long long num2(int op, int kx, int ky, int sx,
                                          int sy, bool b_const, long long a,
                                          long long b, bool va, bool vb,
                                          bool* ok) {
  *ok = va && vb;
  if (op == kNanvl) {
    double x = as_double(a, kx, sx);
    bool is_nan = isnan(x) && va;
    *ok = is_nan ? vb : va;
    return wrd(is_nan ? as_double(b, ky, sy) : x);
  }
  if (op <= kLogBase) {
    double x = as_double(a, kx, sx), y = as_double(b, ky, sy), r;
    if (op == kAtan2) {
      r = atan2(x, y);
    } else if (op == kHypot) {
      r = hypot(x, y);
    } else if (op == kPower) {
      r = b_const && y == 2.0 ? x * x : pow(x, y);
    } else {
      r = log(y) / log(x);
      *ok = *ok && !(x <= 0.0) && !(y <= 0.0);
    }
    return wrd(r);
  }
  bool wide = kx == kI64;
  long long r;
  if (op == kAnd) {
    r = a & b;
  } else if (op == kOr) {
    r = a | b;
  } else if (op == kXor) {
    r = a ^ b;
  } else if (op == kShiftLeft) {
    r = wide ? (long long)((unsigned long long)a << (b & 63))
             : (long long)(int)((unsigned)a << (b & 31));
  } else {
    r = wide ? a >> (b & 63) : (long long)((int)a >> (b & 31));
  }
  return wide ? r : (long long)(int)r;
}

// K13 (csrc/expr_math.cu round_kernel) on one word.
__device__ __noinline__ long long round_word(long long w, int kt,
                                                int half_even, int digits,
                                                int in_scale, int out_scale,
                                                double fscale) {
  if (kt == kF64) {
    double y = dbl(w) * fscale, r;
    if (half_even) {
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
    if (half_even)
      q += (rem > half || (rem == half && (q & 1))) ? 1 : 0;
    else
      q += (w < 0 ? rem > half : rem >= half) ? 1 : 0;
    r = (long long)((unsigned long long)q *
                    (unsigned long long)ipow10(out_scale - digits));
  }
  return kt == kI32 ? (long long)(int)r : r;
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
// or pair.
__device__ __noinline__ long long cal_word(int op, bool xm, bool ym,
                                              long long a, long long b) {
  double f1, f2 = 0.0;
  int days = cal_day(a, xm, &f1);
  int y, m, d;
  if (op == kWeekOfYear) {
    int dow = days + 3 - floor_div32(days + 3, 7) * 7;
    int thursday = days - dow + 3;
    civil_from_days(thursday, y, m, d);
    return (thursday - days_from_civil(y, 1, 1)) / 7 + 1;
  }
  civil_from_days(days, y, m, d);
  if (op == kAddMonths) {
    int months = y * 12 + (m - 1) + (int)b;
    int ny = floor_div32(months, 12);
    int nm = months - ny * 12 + 1;
    return days_from_civil(ny, nm, min(d, month_len(ny, nm)));
  }
  if (op == kLastDay) return days - d + month_len(y, m);
  int y2, m2, d2;
  civil_from_days(cal_day(b, ym, &f2), y2, m2, d2);
  bool whole = d == d2 || (d == month_len(y, m) && d2 == month_len(y2, m2));
  double months = (double)((y - y2) * 12 + (m - m2));
  double r = months + (whole ? 0.0 : ((double)(d - d2) + f1 - f2) / 31.0);
  return wrd(rint(r * 1e8) / 1e8);
}

// DATEFIELD (i0: the field), TRUNCDAYS (i0: the unit) and YMADD (i0: the
// sign, b the months) over days a, as plan/compiler.py's torch ops compute
// them.
__device__ __noinline__ long long date_word(int op, int i0, long long a,
                                           long long b) {
  long long y, m, dd;
  civil64(a, y, m, dd);
  if (op == kDateField) {
    switch (i0) {
      case 0: return y;
      case 1: return m;
      case 2: return dd;
      case 3: return floor_div(m - 1, 3) + 1;
      case 4: return floor_mod(a + 4, 7) + 1;
      case 5: return floor_mod(a + 3, 7);
    }
    return a - days_from_civil64(y, 1, 1) + 1;
  }
  if (op == kTruncDays)
    return i0 == 0 ? days_from_civil64(y, 1, 1)
           : i0 == 1 ? days_from_civil64(y, floor_div(m - 1, 3) * 3 + 1, 1)
           : i0 == 2 ? days_from_civil64(y, m, 1)
                     : a - floor_mod(a + 3, 7);
  long long months = y * 12 + (m - 1) + (long long)i0 * b;
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

__device__ __forceinline__ void atomic_kind(int kind,
                                            unsigned long long* addr,
                                            long long v) {
  switch (kind) {
    case kCount: atomic_word<kCount>(addr, v); break;
    case kSumI: atomic_word<kSumI>(addr, v); break;
    case kSumF: atomic_word<kSumF>(addr, v); break;
    case kMinI: atomic_word<kMinI>(addr, v); break;
    case kMaxI: atomic_word<kMaxI>(addr, v); break;
    case kMinF: atomic_word<kMinF>(addr, v); break;
    default: atomic_word<kMaxF>(addr, v);
  }
}

// The lanes of `peers` combined (every lane of the warp calls it): the
// lowest lane of each peer set ends with its set's total.
__device__ __forceinline__ long long reduce_kind(int kind, unsigned peers,
                                                 long long v, int lane) {
  switch (kind) {
    case kCount:
    case kSumI:
      return sail::reduce_peers(peers, v, lane, Combine<kSumI>());
    case kMinI: return sail::reduce_peers(peers, v, lane, Combine<kMinI>());
    case kMaxI: return sail::reduce_peers(peers, v, lane, Combine<kMaxI>());
    case kSumF:
      return wrd(sail::reduce_peers(peers, dbl(v), lane, Combine<kSumF>()));
    case kMinF:
      return wrd(sail::reduce_peers(peers, dbl(v), lane, Combine<kMinF>()));
  }
  return wrd(sail::reduce_peers(peers, dbl(v), lane, Combine<kMaxF>()));
}

// v combined over the whole warp (every lane calls it; lane 0 ends with
// the total): the keyless reduction, after each thread has combined its
// own rows.
__device__ __forceinline__ long long reduce_all(int kind, long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(SAIL_FULL_MASK, v, off);
    switch (kind) {
      case kCount:
      case kSumI: v = Combine<kSumI>()(v, o); break;
      case kMinI: v = Combine<kMinI>()(v, o); break;
      case kMaxI: v = Combine<kMaxI>()(v, o); break;
      case kSumF: v = wrd(Combine<kSumF>()(dbl(v), dbl(o))); break;
      case kMinF: v = wrd(Combine<kMinF>()(dbl(v), dbl(o))); break;
      default: v = wrd(Combine<kMaxF>()(dbl(v), dbl(o)));
    }
  }
  return v;
}

__device__ __forceinline__ long long combine_kind(int kind, long long v,
                                                  long long o) {
  switch (kind) {
    case kCount:
    case kSumI: return Combine<kSumI>()(v, o);
    case kMinI: return Combine<kMinI>()(v, o);
    case kMaxI: return Combine<kMaxI>()(v, o);
    case kSumF: return wrd(Combine<kSumF>()(dbl(v), dbl(o)));
    case kMinF: return wrd(Combine<kMinF>()(dbl(v), dbl(o)));
  }
  return wrd(Combine<kMaxF>()(dbl(v), dbl(o)));
}

// An elementwise operand that is not a register: a constant (-2 - its
// index in the table) or none (-1: 0, valid).
__device__ __forceinline__ long long operand_const(const Prog& p, int i) {
  return i <= -2 ? p.consts[-2 - i] : 0;
}

__device__ __forceinline__ bool operand_const_valid(const Prog& p, int i) {
  return i <= -2 ? p.const_valid[-2 - i] != 0 : true;
}

// One instruction over a thread's kRows rows: the operands' words and
// validities in (a, b, c, va, vb, vc; each a register or a constant of
// the table), the result out (d, vd). The instruction is decoded once for
// the rows.
#define EACH_ROW(...)                                                   \
  {                                                                      \
    const long long ca_ = operand_const(p, ins.a);                       \
    const long long cb_ = operand_const(p, ins.b);                       \
    const long long cc_ = operand_const(p, ins.c);                       \
    const bool cva_ = operand_const_valid(p, ins.a);                     \
    const bool cvb_ = operand_const_valid(p, ins.b);                     \
    const bool cvc_ = operand_const_valid(p, ins.c);                     \
    _Pragma("unroll") for (int k = 0; k < kRows; ++k) {                  \
      const long long a = ins.a >= 0 ? R[slot(ins.a, k)] : ca_;          \
      const bool va = ins.a >= 0 ? (bool)V[slot(ins.a, k)] : cva_;       \
      const long long b = ins.b >= 0 ? R[slot(ins.b, k)] : cb_;          \
      const bool vb = ins.b >= 0 ? (bool)V[slot(ins.b, k)] : cvb_;       \
      const long long c = ins.c >= 0 ? R[slot(ins.c, k)] : cc_;          \
      const bool vc = ins.c >= 0 ? (bool)V[slot(ins.c, k)] : cvc_;       \
      long long d = 0;                                                   \
      bool vd = va && vb;                                                \
      (void)c;                                                           \
      (void)vc;                                                          \
      __VA_ARGS__                                                        \
      R[slot(ins.dst, k)] = d;                                           \
      V[slot(ins.dst, k)] = vd;                                          \
    }                                                                    \
  }

template <bool REDUCE>
__global__ void __launch_bounds__(kBlock, 8)
    chain_kernel(Prog p, Io io) {
  extern __shared__ __align__(16) unsigned char smem[];
  Instr* prog = reinterpret_cast<Instr*>(smem);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(
      smem + (size_t)p.ninstr * sizeof(Instr));
  long long* R = reinterpret_cast<long long*>(
      acc + (REDUCE ? (size_t)p.nbins * p.nslots : 0));
  unsigned char* V = reinterpret_cast<unsigned char*>(
      R + (size_t)p.nreg * kRows * kBlock);
  for (int k = threadIdx.x; k < p.ninstr; k += kBlock) prog[k] = p.instrs[k];
  if (REDUCE)
    for (int k = threadIdx.x; k < p.nbins * p.nslots; k += kBlock)
      acc[k] = (unsigned long long)p.slot_ident[k % p.nslots];
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31;
  // register r of the thread's k-th row: [register][row][thread]
  auto slot = [t](int r, int k) {
    return ((size_t)r * kRows + k) * kBlock + t;
  };
  // a warp takes kRows x 32 consecutive rows at a time, lane-interleaved,
  // so each row's loads and stores are coalesced across the warp
  const long long span = 32LL * kRows;
  const long long warp = ((long long)blockIdx.x * kBlock + t) >> 5;
  const long long warps = ((long long)gridDim.x * kBlock) >> 5;
  for (long long chunk = warp * span; chunk < p.n; chunk += warps * span) {
    long long at[kRows];  // the row, clamped into the table
    bool in[kRows], live[kRows];
    int bin[kRows], key[kRows];
    unsigned peers[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      long long row = chunk + k * 32 + lane;
      in[k] = row < p.n;
      at[k] = in[k] ? row : p.n - 1;
      live[k] = in[k] && p.sel[at[k]];
      bin[k] = 0;
      key[k] = -1;
      peers[k] = 0;
    }
    for (int pc = 0; pc < p.ninstr; ++pc) {
      const Instr ins = prog[pc];
      switch (ins.op) {
        case kCol: {
          const void* src = io.in[ins.i0];
          const unsigned char* v = io.in_valid[ins.i0];
          const int ty = p.types[ins.i0];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            R[slot(ins.dst, k)] = load_word(src, ty, at[k]);
            V[slot(ins.dst, k)] = v == nullptr || v[at[k]];
          }
          break;
        }
        case kConst: {
          const long long w = p.consts[ins.i0];
          const bool ok = p.const_valid[ins.i0];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            R[slot(ins.dst, k)] = w;
            V[slot(ins.dst, k)] = ok;
          }
          break;
        }
        case kAddI: EACH_ROW(d = wrap_add(a, b);) break;
        case kSubI:
          EACH_ROW(d = (long long)((unsigned long long)a -
                                   (unsigned long long)b);)
          break;
        case kMulI:
          EACH_ROW(d = (long long)((unsigned long long)a *
                                   (unsigned long long)b);)
          break;
        case kAddF: EACH_ROW(d = wrd(dbl(a) + dbl(b));) break;
        case kSubF: EACH_ROW(d = wrd(dbl(a) - dbl(b));) break;
        case kMulF: EACH_ROW(d = wrd(dbl(a) * dbl(b));) break;
        case kDivF: EACH_ROW(d = wrd(dbl(a) / dbl(b));) break;
        case kWrap:
          EACH_ROW(d = ins.i0 == 8 ? (long long)(signed char)a
                       : ins.i0 == 16 ? (long long)(short)a
                                      : (long long)(int)a;
                   vd = va;)
          break;
        case kI2F: EACH_ROW(d = wrd((double)a); vd = va;) break;
        case kI2F32: EACH_ROW(d = wrd((double)(float)a); vd = va;) break;
        case kF2F32: EACH_ROW(d = wrd((double)(float)dbl(a)); vd = va;) break;
        case kF2I: EACH_ROW(d = (long long)dbl(a); vd = va;) break;
        case kNe0I: EACH_ROW(d = a != 0; vd = va;) break;
        case kNe0F: EACH_ROW(d = dbl(a) != 0.0; vd = va;) break;
        case kTruncF: EACH_ROW(d = wrd(trunc(dbl(a))); vd = va;) break;
        case kRhaF:
          EACH_ROW({
            double y = dbl(a);
            double s = (double)((y > 0.0) - (y < 0.0));
            d = wrd(s * floor(fabs(y) + 0.5));
            vd = va;
          })
          break;
        case kCmpI:
          EACH_ROW(d = ins.i0 == 0 ? a == b : ins.i0 == 1 ? a != b
                     : ins.i0 == 2 ? a < b : ins.i0 == 3 ? a <= b
                     : ins.i0 == 4 ? a > b : a >= b;)
          break;
        case kCmpF:
          EACH_ROW({
            double x = dbl(a), y = dbl(b);
            d = ins.i0 == 0 ? x == y : ins.i0 == 1 ? x != y
                : ins.i0 == 2 ? x < y : ins.i0 == 3 ? x <= y
                : ins.i0 == 4 ? x > y : x >= y;
          })
          break;
        case kAnd3:
          EACH_ROW({
            bool ab = a != 0, bb = b != 0;
            bool af = va && !ab, bf = vb && !bb;
            vd = af || bf || (va && vb);
            d = ab && bb && !af && !bf;
          })
          break;
        case kOr3:
          EACH_ROW({
            bool at_ = va && a != 0, bt = vb && b != 0;
            vd = at_ || bt || (va && vb);
            d = at_ || bt;
          })
          break;
        case kNotB: EACH_ROW(d = a == 0; vd = va;) break;
        case kIsNull: EACH_ROW(d = !va; vd = true;) break;
        case kIsNotNull: EACH_ROW(d = va; vd = true;) break;
        case kSelect:
          EACH_ROW({
            bool cond = a != 0 && va;
            d = cond ? b : c;
            vd = cond ? vb : vc;
          })
          break;
        case kSelV: EACH_ROW(d = va ? a : b; vd = va || vb;) break;
        case kPassV: EACH_ROW(d = a;) break;
        case kSetV: EACH_ROW(d = a; vd = vb;) break;
        case kAndV: EACH_ROW(d = a; vd = va && b != 0;) break;
        case kBandNv: EACH_ROW(d = a != 0 && b != 0; vd = true;) break;
        case kBor: EACH_ROW(d = a != 0 || b != 0;) break;
        case kNullifI:
          EACH_ROW(d = a; vd = va && !(a == b && va && vb);)
          break;
        case kNullifF:
          EACH_ROW(d = a; vd = va && !(dbl(a) == dbl(b) && va && vb);)
          break;
        case kEqnsI:
          EACH_ROW(d = (va && vb && a == b) || (!va && !vb); vd = true;)
          break;
        case kEqnsF:
          EACH_ROW({
            double x = dbl(a), y = dbl(b);
            bool eq = x == y || (isnan(x) && isnan(y));
            d = (va && vb && eq) || (!va && !vb);
            vd = true;
          })
          break;
        case kExtI:
          EACH_ROW({
            bool use = vb && (!va || (ins.i0 ? b > a : b < a));
            d = use ? b : a;
            vd = va || vb;
          })
          break;
        case kExtF:
          EACH_ROW({
            bool pick = ins.i0 ? dbl(b) > dbl(a) : dbl(b) < dbl(a);
            bool use = vb && (!va || pick);
            d = use ? b : a;
            vd = va || vb;
          })
          break;
        case kSdivI:
        case kSmodI:
          EACH_ROW({
            bool zero = b == 0;
            long long safe = zero ? 1 : b;
            if (a == LLONG_MIN && safe == -1)
              d = ins.op == kSdivI ? LLONG_MIN : 0;
            else
              d = ins.op == kSdivI ? a / safe : a % safe;
            vd = va && vb && !zero;
          })
          break;
        case kSdivF:
        case kSmodF:
          EACH_ROW({
            double y = dbl(b);
            bool zero = y == 0.0;
            double safe = zero ? 1.0 : y;
            d = wrd(ins.op == kSdivF ? dbl(a) / safe : fmod(dbl(a), safe));
            vd = va && vb && !zero;
          })
          break;
        case kPmodfixI:
          EACH_ROW(d = (a != 0 && ((a < 0) != (b < 0))) ? wrap_add(a, b) : a;
                   vd = va;)
          break;
        case kPmodfixF:
          EACH_ROW({
            double x = dbl(a), y = dbl(b);
            d = wrd((x != 0.0 && ((x < 0.0) != (y < 0.0))) ? x + y : x);
            vd = va;
          })
          break;
        case kRescale:  // sign(x) * ((|x| + f / 2) // f), f = b = 10^k
          EACH_ROW({
            long long ax = a < 0 ? (long long)(0ull - (unsigned long long)a)
                                 : a;
            long long q = floor_div(wrap_add(ax, b / 2), b);
            d = (long long)((unsigned long long)((a > 0) - (a < 0)) *
                            (unsigned long long)q);
            vd = va;
          })
          break;
        case kFloorDiv: EACH_ROW(d = b == 0 ? 0 : floor_div(a, b);) break;
        case kFloorMod: EACH_ROW(d = b == 0 ? 0 : floor_mod(a, b);) break;
        case kDateField:
        case kTruncDays:
          EACH_ROW(d = date_word(ins.op, ins.i0, a, b); vd = va;)
          break;
        case kYmAdd: EACH_ROW(d = date_word(kYmAdd, ins.i0, a, b);) break;
        case kNum1:
          EACH_ROW(d = num1(ins.i0, kernel_type(ins.i2), ins.i1, a, va, &vd);)
          break;
        case kNum2:
          EACH_ROW(d = num2(ins.i0, kernel_type(ins.i2 & 0xff),
                            kernel_type((ins.i2 >> 8) & 0xff), ins.i1 & 0xff,
                            ins.i1 >> 8, (ins.i2 >> 16) & 1, a, b, va, vb,
                            &vd);)
          break;
        case kRound:
          EACH_ROW(d = round_word(a, kernel_type(ins.i2 >> 16), ins.i0,
                                  ins.i1, ins.i2 & 0xff, (ins.i2 >> 8) & 0xff,
                                  dbl(b));
                   vd = va;)
          break;
        case kCal:
          EACH_ROW({
            d = cal_word(ins.i0, ins.i1 & 1, ins.i1 & 2, a, b);
            if (ins.i0 != kMonthsBetween) d = (long long)(int)d;
            vd = va && (!(ins.i1 & 4) || vb);
          })
          break;
        case kLut: {
          const TableDesc tab = p.tables[ins.i0];
          const void* base = reinterpret_cast<const void*>(tab.ptr);
          const int ty = (int)tab.type;
          EACH_ROW({
            long long at_ = a < 0 ? 0 : (a >= tab.len ? tab.len - 1 : a);
            d = load_word(base, ty, at_);
            vd = va;
          })
          break;
        }
        case kFilter: {
          bool any = false;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            live[k] = live[k] && R[slot(ins.a, k)] != 0 &&
                      V[slot(ins.a, k)];
            any = any || live[k];
          }
          // a warp whose rows are all dead has nothing left to reduce
          if (REDUCE && !__any_sync(SAIL_FULL_MASK, any)) pc = p.ninstr;
          break;
        }
        case kStore: {
          void* dst = io.out[ins.i0];
          unsigned char* dv = io.out_valid[ins.i0];
          const int ty = p.types[p.ninputs + ins.i0];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            if (!in[k]) continue;
            store_word(dst, ty, at[k], R[slot(ins.a, k)]);
            if (dv != nullptr) dv[at[k]] = V[slot(ins.a, k)];
          }
          break;
        }
        case kBin: {
          const int dom = ins.i0;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            long long a = R[slot(ins.a, k)];
            long long code = a < 0 ? 0 : (a > dom - 1 ? dom - 1 : a);
            bin[k] = bin[k] * (dom + 1) +
                     (V[slot(ins.a, k)] ? (int)code : dom);
          }
          break;
        }
        case kPeers:
          if (REDUCE && p.nbins == 1) {  // keyless: one bin, no match
            int live_rows = 0;
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              key[k] = live[k] ? 0 : -1;
              live_rows += __popc(__ballot_sync(SAIL_FULL_MASK, live[k]));
            }
            if (lane == 0 && live_rows)
              atomicAdd(&acc[0], (unsigned long long)live_rows);
          } else if (REDUCE) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              key[k] = live[k] ? bin[k] : -1;
              peers[k] = __match_any_sync(SAIL_FULL_MASK, key[k]);
              if (key[k] >= 0 && lane == __ffs(peers[k]) - 1)
                atomicAdd(&acc[(size_t)key[k] * p.nslots],
                          (unsigned long long)__popc(peers[k]));
            }
          }
          break;
        case kAcc:
          if (REDUCE && p.nbins == 1) {
            // keyless: a thread combines its rows, then the warp, then one
            // lane adds to the block's accumulator
            const int kind = ins.i1;
            long long v = p.slot_ident[ins.i0];
#pragma unroll
            for (int k = 0; k < kRows; ++k)
              if (key[k] >= 0 && V[slot(ins.a, k)])
                v = combine_kind(kind, v, kind == kCount
                                              ? 1
                                              : R[slot(ins.a, k)]);
            v = reduce_all(kind, v);
            if (lane == 0 && v != p.slot_ident[ins.i0])
              atomic_kind(kind, &acc[ins.i0], v);
          } else if (REDUCE) {
            const int kind = ins.i1;
            const long long ident = p.slot_ident[ins.i0];
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
              bool take = key[k] >= 0 && V[slot(ins.a, k)];
              long long v = kind == kCount ? (long long)take
                            : take ? R[slot(ins.a, k)]
                                   : ident;
              v = reduce_kind(kind, peers[k], v, lane);
              if (key[k] >= 0 && lane == __ffs(peers[k]) - 1)
                atomic_kind(kind, &acc[(size_t)key[k] * p.nslots + ins.i0],
                            v);
            }
          }
          break;
      }
    }
    if (!REDUCE) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (in[k]) p.sel_out[at[k]] = live[k];
    }
  }
  if (REDUCE) {
    __syncthreads();
    for (int k = threadIdx.x; k < p.nbins * p.nslots; k += kBlock) {
      int s = k % p.nslots;
      long long w = (long long)acc[k];
      if (w != p.slot_ident[s]) atomic_kind(p.slot_kinds[s], &p.acc[k], w);
    }
  }
}

#undef EACH_ROW

template <bool REDUCE>
int launch(const void* instrs, int ninstr, const void* consts,
           const void* const_valid, const void* tables, const void* types,
           int ninputs, int nreg, const void* const* in_data,
           const void* const* in_valid, void* const* out_data,
           void* const* out_valid, const void* sel, long long n,
           void* sel_out, int nbins, int nslots, const void* slot_kinds,
           const void* slot_ident, void* acc, int grid, void* stream) {
  if (ninstr < 0 || ninputs < 0 || ninputs > kMaxIn || nreg < 0 ||
      (REDUCE && (nbins < 1 || nslots < 1 || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  Prog p;
  p.instrs = static_cast<const Instr*>(instrs);
  p.ninstr = ninstr;
  p.consts = static_cast<const long long*>(consts);
  p.const_valid = static_cast<const unsigned char*>(const_valid);
  p.tables = static_cast<const TableDesc*>(tables);
  p.types = static_cast<const int*>(types);
  p.ninputs = ninputs;
  p.nreg = nreg;
  p.sel = static_cast<const unsigned char*>(sel);
  p.n = n;
  p.sel_out = static_cast<unsigned char*>(sel_out);
  p.nbins = REDUCE ? nbins : 0;
  p.nslots = REDUCE ? nslots : 0;
  p.slot_kinds = static_cast<const int*>(slot_kinds);
  p.slot_ident = static_cast<const long long*>(slot_ident);
  p.acc = static_cast<unsigned long long*>(acc);
  Io io;
  for (int k = 0; k < kMaxIn; ++k) {
    io.in[k] = in_data[k];
    io.in_valid[k] = static_cast<const unsigned char*>(in_valid[k]);
  }
  for (int k = 0; k < kMaxOut; ++k) {
    io.out[k] = out_data[k];
    io.out_valid[k] = static_cast<unsigned char*>(out_valid[k]);
  }
  size_t smem = (size_t)ninstr * sizeof(Instr) +
                (REDUCE ? (size_t)nbins * nslots * 8 : 0) +
                (size_t)nreg * kRows * kBlock * 9;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<REDUCE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one wave: every block of the grid-stride loop resident at once (a
  // second, partial wave would leave most SMs idle while it runs)
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, chain_kernel<REDUCE>, kBlock, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  grid = grid < sms * per_sm ? grid : sms * per_sm;
  chain_kernel<REDUCE><<<grid, kBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(p, io);
  return (int)cudaGetLastError();
}

}  // namespace

// K16. instrs: int32[ninstr][8]; consts: int64 words and a uint8 validity
// each; tables: int64 [ptr, len, type] each; types: int32, the inputs' then
// the outputs'; in_data/in_valid: 64 pointers (a null validity: no NULLs);
// out_data/out_valid: 128; sel_out: bool[n].
extern "C" int sail_chain(const void* instrs, int ninstr, const void* consts,
                          const void* const_valid, const void* tables,
                          const void* types, int ninputs, int nreg,
                          const void* const* in_data,
                          const void* const* in_valid, void* const* out_data,
                          void* const* out_valid, const void* sel,
                          long long n, void* sel_out, int nbins, int nslots,
                          const void* slot_kinds, const void* slot_ident,
                          void* acc, int grid, void* stream) {
  if (sel_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false>(instrs, ninstr, consts, const_valid, tables, types,
                       ninputs, nreg, in_data, in_valid, out_data, out_valid,
                       sel, n, sel_out, nbins, nslots, slot_kinds,
                       slot_ident, acc, grid, stream);
}

// K17: as K16, with nbins x nslots accumulators: slot_kinds (int32, chain.py
// ACC_KINDS), slot_ident (int64 words, the identities), acc (int64 words
// [nbins][nslots], filled with the identities by the caller).
extern "C" int sail_chain_reduce(
    const void* instrs, int ninstr, const void* consts,
    const void* const_valid, const void* tables, const void* types,
    int ninputs, int nreg, const void* const* in_data,
    const void* const* in_valid, void* const* out_data,
    void* const* out_valid, const void* sel, long long n, void* sel_out,
    int nbins, int nslots, const void* slot_kinds, const void* slot_ident,
    void* acc, int grid, void* stream) {
  return launch<true>(instrs, ninstr, consts, const_valid, tables, types,
                      ninputs, nreg, in_data, in_valid, out_data, out_valid,
                      sel, n, sel_out, nbins, nslots, slot_kinds, slot_ident,
                      acc, grid, stream);
}
