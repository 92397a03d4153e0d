"""K12-K15: the compiler's math, rounding, bitwise and calendar builders as
kernels, each with its plain PyTorch version.

The builders of ``plan/compiler.py`` call these wrappers: ``math_unary``
(K12), ``round_number`` (K13), ``math_binary`` (K14) and ``calendar``
(K15), all in ``csrc/expr_math.cu``. A CPU tensor takes the plain version
(``*_plain``); a CUDA tensor launches the kernel or raises. Each entry
point counts its launches in ``.launches`` (K12, K14 and K15 also by
operation, in ``.by_op``); a column of zero rows launches nothing.

Columns are int32, int64 (integers, and decimals as unscaled int64 with
their scale passed beside them) or float64; int8, int16 and bool widen to
int32 and float32 to float64 on the way in. A 0-d tensor (a literal) is a
scalar operand. Validity is a bool tensor or None (all valid); an
operation that makes no NULL of its own passes its input's validity
through, the same tensor.

Where the reference (``sail_tpu/plan/compiler.py``) differs from Spark,
these give Spark's answer:

- ``abs`` and ``negative`` of a decimal: the reference divides by the
  scale and reads the result as unscaled (``abs(-1.50)`` = 0.01); here
  they stay exact on the unscaled integer.
- two-operand math over decimals (``power``, ``hypot``, ``atan2``,
  ``log(base, x)``): the reference takes the unscaled integer
  (``power(-1.50, 2)`` = 22500.0); here every operand is unscaled / 10^s.
- ``round`` and ``bround`` to negative digits on decimals and integers:
  the reference keeps every integer digit (``round(48198.25, -1)`` =
  48198); here whole digits are dropped (48200).
- the logarithms of x <= 0 (``log1p`` of x <= -1) are NULL, where the
  reference gives NaN or -inf.
- a shift count is masked to its low 6 bits (5 for an int):
  ``shiftleft(3, 65)`` = 6, where the reference gives 0.
- ``floor`` and ``ceil`` of a double: NaN is 0 and out-of-range values
  saturate, as Spark's non-ANSI cast to a long.
"""

from __future__ import annotations

import math
import types
from typing import Optional, Tuple

import torch

from .. import csrc

CV = Tuple[torch.Tensor, Optional[torch.Tensor]]

UNARY_OPS = ("sqrt", "exp", "expm1", "ln", "log10", "log2", "log1p", "sin",
             "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
             "cbrt", "rint", "degrees", "radians", "sign", "floor", "ceil",
             "isnan", "~", "abs", "negative")
_UNARY_CODE = {op: i for i, op in enumerate(UNARY_OPS)}
# ops whose result is a double (sign too)
FLOAT_OPS = frozenset(UNARY_OPS[:UNARY_OPS.index("sign") + 1])
# ops that make a NULL of their own: x <= 0 (log1p: x <= -1)
LOG_OPS = frozenset(("ln", "log10", "log2", "log1p"))
BINARY_OPS = ("atan2", "hypot", "power", "log", "&", "|", "^", "shiftleft",
              "shiftright", "nanvl")
_BINARY_CODE = {op: i for i, op in enumerate(BINARY_OPS)}
BITWISE_OPS = frozenset(("&", "|", "^", "shiftleft", "shiftright"))
CALENDAR_OPS = ("add_months", "months_between", "last_day", "weekofyear")
_CALENDAR_CODE = {op: i for i, op in enumerate(CALENDAR_OPS)}

_TYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_MICROS = 2  # K15's code of an operand of local microseconds
_DAY_US = 86_400_000_000
_TWO63 = 2.0 ** 63
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def _kernel_type(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a type the kernels read."""
    if x.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return x.to(torch.int32)
    if x.dtype in (torch.float16, torch.bfloat16, torch.float32):
        return x.to(torch.float64)
    if x.dtype not in _TYPE_CODE:
        raise TypeError(f"no kernel reads {x.dtype}")
    return x


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true division as the kernels divide (on the card torch
    multiplies by the reciprocal of a Python number instead, an ulp off
    at times)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _as_double(x: torch.Tensor, scale: int) -> torch.Tensor:
    """A column as doubles: unscaled / 10^scale for a decimal."""
    x = x.to(torch.float64)
    return _div(x, 10.0 ** scale) if scale else x


def _merge(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _rows(*tensors) -> int:
    """The rows of the columns among ``tensors`` (1 if all are scalars)."""
    ns = {t.shape[0] for t in tensors if t is not None and t.dim() > 0}
    if len(ns) > 1:
        raise ValueError(f"columns of {sorted(ns)} rows")
    return ns.pop() if ns else 1


def _check_cuda(name: str, *tensors) -> torch.device:
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or (dev is not None and t.device != dev):
            raise ValueError(f"{name}: every operand on one CUDA device")
        if t.dim() > 1:
            raise ValueError(f"{name}: a column or a scalar, not "
                             f"{tuple(t.shape)}")
        dev = t.device
    return dev


def _flat(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape(-1).contiguous()


def _row_validity(valid: Optional[torch.Tensor], data: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """A validity with a row for each of ``data``'s (a scalar's stays one
    value): a literal's 0-d validity merged into a column's broadcasts."""
    if valid is None:
        return None
    if valid.dtype != torch.bool:
        raise TypeError(f"a bool validity, not {valid.dtype}")
    if data.dim() == 0 or valid.dim() > 0:
        if valid.numel() != data.numel():
            raise ValueError(f"a validity of {valid.numel()} rows for "
                             f"{data.numel()}")
        return valid.reshape(-1).contiguous()
    return valid.reshape(1).expand(data.shape[0]).contiguous()


def _shape_back(t: Optional[torch.Tensor], scalar: bool):
    return t.reshape(()) if t is not None and scalar else t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# calendar helpers (proleptic Gregorian; days since 1970-01-01)
# ---------------------------------------------------------------------------

def civil_from_days(z: torch.Tensor):
    """days → (year, month, day) — vectorized Hinnant algorithm."""
    z = z.to(torch.int64) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def month_len(y, m):
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return torch.where((m == 2) & leap, 29, lengths[m - 1])


# ---------------------------------------------------------------------------
# K12: one-operand math
# ---------------------------------------------------------------------------

def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root: pow of |x|, then one Newton step (pow alone is
    an ulp off on exact cubes: 27 gives 3.0000000000000004). The step
    cubes r, so |x| is first scaled by an exact cube into the normal range
    where r * r * r neither underflows (subnormal x: the step would move r
    by tens of ulp) nor overflows (x near the largest double), and the
    root scaled back by its cube root."""
    a = x.abs()
    tiny, huge = a < _CBRT_TINY, a > _CBRT_HUGE
    y = torch.where(tiny, a * 2.0 ** 54, torch.where(huge, a * 2.0 ** -54, a))
    r = y.pow(1.0 / 3.0)
    step = r - (r * r * r - y) / (3.0 * r * r)
    r = torch.where(torch.isfinite(step) & (r != 0), step, r)
    r = torch.where(tiny, r * 2.0 ** -18, torch.where(huge, r * 2.0 ** 18, r))
    return torch.copysign(r, x)


# below the smallest normal double, and above 2^1020: _cbrt's scaled range
_CBRT_TINY = 2.2250738585072014e-308
_CBRT_HUGE = 2.0 ** 1020


def _hyperbolic(fn):
    """sinh or cosh, finite up to their overflow near |x| = 710.5, where
    torch's CPU forms overflow through exp(|x|) first: e^(|x|/2) / 2 *
    e^(|x|/2) (the other exponential is below an ulp there)."""
    def run(x: torch.Tensor) -> torch.Tensor:
        h = torch.exp(x.abs() * 0.5)
        big = h * 0.5 * h
        if fn is torch.sinh:
            big = torch.sign(x) * big
        return torch.where(x.abs() < 700.0, fn(x), big)
    return run


_FLOAT_FNS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "expm1": torch.expm1,
    "ln": torch.log, "log10": torch.log10, "log2": torch.log2,
    "log1p": torch.log1p, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
    "atan": torch.atan, "sinh": _hyperbolic(torch.sinh),
    "cosh": _hyperbolic(torch.cosh),
    "tanh": torch.tanh, "cbrt": _cbrt, "rint": torch.round,
    # the rounded constant, as the reference multiplies by it
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)),
}


def saturating_long(v: torch.Tensor) -> torch.Tensor:
    """A double to a long as Spark's non-ANSI cast: toward zero, NaN 0,
    out of range saturated (``expr_math.cuh`` ``sat_i64``)."""
    inside = v.nan_to_num(0.0).clamp(-_TWO63, 9223372036854774784.0)
    out = inside.to(torch.int64)
    out = torch.where(v >= _TWO63, _INT64_MAX, out)
    return torch.where(v <= -_TWO63, _INT64_MIN, out)


def saturating_int(v: torch.Tensor) -> torch.Tensor:
    """A double to an int as Spark's non-ANSI cast: toward zero, NaN 0,
    out of range saturated at the int's limits (``sat_i32``)."""
    return v.nan_to_num(0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(
        torch.int32)


def math_unary_plain(x: torch.Tensor, valid: Optional[torch.Tensor],
                     op: str, scale: int = 0) -> CV:
    """``op`` (one of ``UNARY_OPS``) of a column of int32, int64 (unscaled
    decimals of ``scale``) or float64. The ``FLOAT_OPS`` give a double;
    floor and ceil an int64 (a decimal: its whole part, exactly); isnan a
    bool that is never NULL; ``~``, abs and negative the input's type,
    exact on integers (two's complement: abs of the minimum is the
    minimum). The logarithms are NULL at x <= 0 (log1p: x <= -1)."""
    if op in FLOAT_OPS:
        v = _as_double(x, scale)
        out = _FLOAT_FNS[op](v)
        if op in LOG_OPS:
            ok = ~(v <= (-1.0 if op == "log1p" else 0.0))
            return out, ok if valid is None else ok & valid
        return out, valid
    if op in ("floor", "ceil"):
        if x.is_floating_point():
            fn = torch.floor if op == "floor" else torch.ceil
            return saturating_long(fn(x)), valid
        f = 10 ** scale
        v = x.to(torch.int64)
        if op == "floor":
            return torch.div(v, f, rounding_mode="floor"), valid
        return -torch.div(-v, f, rounding_mode="floor"), valid
    if op == "isnan":
        out = torch.isnan(x) if x.is_floating_point() else \
            torch.zeros_like(x, dtype=torch.bool)
        return (out if valid is None else out & valid), None
    if op == "~":
        return torch.bitwise_not(x), valid
    if op == "abs":
        return torch.abs(x), valid
    if op == "negative":
        return torch.neg(x), valid
    raise ValueError(f"math_unary: {op!r}")


def math_unary(x: torch.Tensor, valid: Optional[torch.Tensor], op: str,
               scale: int = 0) -> CV:
    """K12: ``math_unary_plain`` as a kernel on the card
    (``csrc/expr_math.cu`` ``sail_math_unary``: one instantiation an
    operation and input type, picked on the host). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if op not in _UNARY_CODE or not 0 <= scale <= 18:
        raise ValueError(f"math_unary: {op!r} at scale {scale}")
    x = _kernel_type(x)
    if x.device.type == "cpu":
        return math_unary_plain(x, valid, op, scale)
    if op == "~" and x.is_floating_point():
        raise TypeError("math_unary: ~ of a double")
    dev = _check_cuda("math_unary", x, valid)
    scalar = x.dim() == 0
    xf, vf = _flat(x), _row_validity(valid, x)
    n = xf.shape[0]
    if op in FLOAT_OPS:
        out_dtype = torch.float64
    elif op in ("floor", "ceil"):
        out_dtype = torch.int64
    elif op == "isnan":
        out_dtype = torch.bool
    else:
        out_dtype = x.dtype
    out = torch.empty(n, dtype=out_dtype, device=dev)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev) \
        if op in LOG_OPS else None
    if n:
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("expr_math.cu", "sail_math_unary")(
                xf.data_ptr(), _TYPE_CODE[x.dtype], scale, _ptr(vf), n,
                _UNARY_CODE[op], out.data_ptr(), _ptr(out_valid),
                csrc.stream_ptr(dev)), "math_unary")
        math_unary.launches += 1
        math_unary.by_op[op].launches += 1
    if op in LOG_OPS:
        validity = out_valid
    elif op == "isnan":
        validity = None
    else:
        validity = valid
    return _shape_back(out, scalar), _shape_back(validity, scalar) \
        if validity is not valid else valid


math_unary.launches = 0
# the launches of each operation's instantiations
math_unary.by_op = {op: types.SimpleNamespace(launches=0)
                    for op in UNARY_OPS}


# ---------------------------------------------------------------------------
# K13: round and bround
# ---------------------------------------------------------------------------

def round_number_plain(x: torch.Tensor, half_even: bool, digits: int,
                       in_scale: int = 0, out_scale: int = 0
                       ) -> torch.Tensor:
    """round (half up, away from zero) or bround (half even) to ``digits``
    places. An int32 or int64 column (unscaled decimals of ``in_scale``,
    written at ``out_scale``, as the resolver types the result: scale
    min(in_scale, max(digits, 0))) rounds exactly in integer space,
    negative digits included, and keeps its type. A double follows the
    reference's formula: round sign(y) * floor(|y| + 0.5) / 10^digits,
    bround rint(y) / 10^digits, y = x * 10^digits."""
    if x.is_floating_point():
        fscale = 10.0 ** digits
        y = x * fscale
        if half_even:
            return _div(torch.round(y), fscale)
        return _div(torch.sign(y) * torch.floor(torch.abs(y) + 0.5), fscale)
    drop = in_scale - digits
    v = x.to(torch.int64)
    if drop <= 0:
        return (v * 10 ** (out_scale - in_scale)).to(x.dtype)
    if drop > 18:
        return torch.zeros_like(x)
    # v = q f + rem, 0 <= rem < f; a half goes to the even q (bround) or
    # away from zero (round): up from q for v >= 0, down for v < 0
    f = 10 ** drop
    q = torch.div(v, f, rounding_mode="floor")
    rem = v - q * f
    if half_even:
        up = (rem > f // 2) | ((rem == f // 2) & (q % 2 != 0))
    else:
        up = torch.where(v < 0, rem > f // 2, rem >= f // 2)
    q = q + up.to(torch.int64)
    return (q * 10 ** (out_scale - digits)).to(x.dtype)


def round_number(x: torch.Tensor, half_even: bool, digits: int,
                 in_scale: int = 0, out_scale: int = 0) -> torch.Tensor:
    """K13: ``round_number_plain`` as a kernel on the card
    (``csrc/expr_math.cu`` ``sail_round``). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if not (0 <= in_scale <= 18 and 0 <= out_scale <= 18 and
            out_scale - digits <= 18 and out_scale >= in_scale - 18):
        raise ValueError(f"round_number: {digits} digits from scale "
                         f"{in_scale} to {out_scale}")
    x = _kernel_type(x)
    if x.device.type == "cpu":
        return round_number_plain(x, half_even, digits, in_scale, out_scale)
    dev = _check_cuda("round_number", x)
    scalar = x.dim() == 0
    xf = _flat(x)
    n = xf.shape[0]
    out = torch.empty(n, dtype=x.dtype, device=dev)
    if n:
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("expr_math.cu", "sail_round")(
                xf.data_ptr(), _TYPE_CODE[x.dtype], n, int(half_even), digits,
                in_scale, out_scale, 10.0 ** digits, out.data_ptr(),
                csrc.grid_for(n, dev), csrc.stream_ptr(dev)), "round_number")
        round_number.launches += 1
    return _shape_back(out, scalar)


round_number.launches = 0


# ---------------------------------------------------------------------------
# K14: two-operand math and bitwise
# ---------------------------------------------------------------------------

def math_binary_plain(x: torch.Tensor, xv: Optional[torch.Tensor],
                      y: torch.Tensor, yv: Optional[torch.Tensor], op: str,
                      x_scale: int = 0, y_scale: int = 0) -> CV:
    """``op`` (one of ``BINARY_OPS``) of two columns or scalars. atan2,
    hypot, power and log(base x, value y) give doubles of operands taken
    as unscaled / 10^scale; log is NULL where either is <= 0. The bitwise
    ops and the shifts take integers and give ``x``'s type (the count of
    a shift masked to 6 bits, 5 for an int; shiftright is arithmetic).
    nanvl(x, y): y (as a double) where x is a non-NULL NaN, with y's
    validity there. Elsewhere the result is NULL where either operand
    is."""
    if op in ("atan2", "hypot", "power", "log"):
        a, b = _as_double(x, x_scale), _as_double(y, y_scale)
        if op == "atan2":
            return torch.atan2(a, b), _merge(xv, yv)
        if op == "hypot":
            return torch.hypot(a, b), _merge(xv, yv)
        if op == "power":
            return torch.pow(a, b), _merge(xv, yv)
        ok = ~(a <= 0.0) & ~(b <= 0.0)
        valid = _merge(xv, yv)
        return torch.log(b) / torch.log(a), ok if valid is None else ok & valid
    if op == "nanvl":
        is_nan = torch.isnan(x)
        if xv is not None:
            is_nan = is_nan & xv
        data = torch.where(is_nan, _as_double(y, y_scale), x)
        if xv is None and yv is None:
            return data, None
        ones = torch.ones_like(is_nan)
        return data, torch.where(is_nan, ones if yv is None else yv,
                                 ones if xv is None else xv)
    a = x.to(torch.int64)
    b = y.to(torch.int64)
    if op == "&":
        out = a & b
    elif op == "|":
        out = a | b
    elif op == "^":
        out = a ^ b
    elif x.dtype == torch.int64:
        b = b & 63
        out = a << b if op == "shiftleft" else a >> b
    else:
        b = (b & 31).to(torch.int32)
        a = x.to(torch.int32)
        out = a << b if op == "shiftleft" else a >> b
    return out.to(x.dtype), _merge(xv, yv)


def _host_scalar(t: Optional[torch.Tensor]) -> bool:
    """A 0-d tensor on the host: a literal's value, read without waiting
    for the card."""
    return t is not None and t.dim() == 0 and t.device.type == "cpu"


def _column_on(x: torch.Tensor, xv: Optional[torch.Tensor], n: int, dev):
    """A first operand as a column of ``n`` rows on ``dev`` (a scalar
    repeated: a literal's filled in from the host, without a wait for the
    card), with its validity."""
    if _host_scalar(x):
        x = torch.full((n,), x.item(), dtype=x.dtype, device=dev)
    elif x.dim() == 0:
        x = x.reshape(1).expand(n).contiguous()
    if xv is not None:
        xv = _row_validity(xv.to(dev), x)
    return x, xv


def math_binary(x: torch.Tensor, xv: Optional[torch.Tensor],
                y: torch.Tensor, yv: Optional[torch.Tensor], op: str,
                x_scale: int = 0, y_scale: int = 0) -> CV:
    """K14: ``math_binary_plain`` as a kernel on the card
    (``csrc/expr_math.cu`` ``sail_math_binary``: one instantiation an
    operation and operand types, picked on the host). Each operand is a
    column or a 0-d scalar; a scalar second operand is read once a
    thread, from the host where it lies there (a literal's value: power
    by a 2 there takes the square's instantiation) or on the card; a
    scalar first operand beside a column is repeated into one. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if op not in _BINARY_CODE or not (0 <= x_scale <= 18 and
                                      0 <= y_scale <= 18):
        raise ValueError(f"math_binary: {op!r} at scales {x_scale}, "
                         f"{y_scale}")
    x, y = _kernel_type(x), _kernel_type(y)
    if op in BITWISE_OPS and (x.is_floating_point() or
                              y.is_floating_point()):
        raise TypeError(f"math_binary: {op} of {x.dtype} and {y.dtype}")
    if op == "nanvl" and not x.is_floating_point():
        raise TypeError("math_binary: nanvl of a non-double first operand")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return math_binary_plain(x, xv, y, yv, op, x_scale, y_scale)
    dev = _check_cuda("math_binary", *(t for t in (x, xv, y, yv)
                                       if not _host_scalar(t)))
    n = _rows(x, xv, y, yv)
    scalar = x.dim() == 0 and y.dim() == 0
    out_dtype = x.dtype if op in BITWISE_OPS else torch.float64
    out = torch.empty(n, dtype=out_dtype, device=dev)
    # a fresh validity where the op makes NULLs or merges two; else the one
    # given passes through
    fresh = op in ("log", "nanvl") or (xv is not None and yv is not None)
    out_valid = torch.empty(n, dtype=torch.bool, device=dev) \
        if fresh and (op == "log" or xv is not None or yv is not None) \
        else None
    xf, vxf = _column_on(x, xv, n, dev)
    yv = None if yv is None else yv.to(dev)
    y_scalar = y.dim() == 0
    yf, vyf = _flat(y), _row_validity(yv, y)
    y_word, y_double = 0, 0.0
    if y_scalar and _host_scalar(y):  # a literal's value, read here
        yf, value = None, y.item()
        if op in BITWISE_OPS:
            y_word = int(value)
        elif y.is_floating_point() or not y_scale:
            y_double = float(value)
        else:  # one division, as the kernel divides a column's
            y_double = float(value) / float(10 ** y_scale)
    # else a scalar on the card is read there, once a thread
    square = op == "power" and y_scalar and yf is None and y_double == 2.0
    if out_valid is None:  # the kernel reads no validity
        vxf = vyf = None
    if n:
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("expr_math.cu", "sail_math_binary")(
                xf.data_ptr(), _TYPE_CODE[x.dtype], x_scale, _ptr(vxf),
                _ptr(yf), _TYPE_CODE[y.dtype], y_scale, _ptr(vyf),
                int(y_scalar), y_double, y_word, n, _BINARY_CODE[op],
                int(square), out.data_ptr(), _ptr(out_valid),
                csrc.stream_ptr(dev)), "math_binary")
        math_binary.launches += 1
        math_binary.by_op[op].launches += 1
    validity = out_valid if fresh else (xv if yv is None else yv)
    return _shape_back(out, scalar), _shape_back(validity, scalar) \
        if fresh else validity


math_binary.launches = 0
# the launches of each operation's instantiations
math_binary.by_op = {op: types.SimpleNamespace(launches=0)
                     for op in BINARY_OPS}


# ---------------------------------------------------------------------------
# K15: the calendar
# ---------------------------------------------------------------------------

def _days_and_fraction(x: torch.Tensor, micros: bool):
    if not micros:
        return x.to(torch.int64), torch.zeros(x.shape, dtype=torch.float64,
                                               device=x.device)
    us = x.to(torch.int64)
    days = torch.div(us, _DAY_US, rounding_mode="floor")
    secs = _div((us - days * _DAY_US).to(torch.float64), 1e6)
    return days, _div(secs, 86_400.0)


def calendar_plain(x: torch.Tensor, xv: Optional[torch.Tensor], op: str,
                   y: Optional[torch.Tensor] = None,
                   yv: Optional[torch.Tensor] = None, x_micros: bool = False,
                   y_micros: bool = False) -> CV:
    """``op`` (one of ``CALENDAR_OPS``) of dates (days, int32 or int64) or
    timestamps (``*_micros``: local microseconds, int64). add_months(x,
    months y) and last_day(x) give a date (int32), the day clamped to the
    month's end; weekofyear(x) the ISO week (int32); months_between(x, y)
    a double: whole months where both fall on the same day of the month
    or on their months' last days, else 31 days a month with the time of
    day, rounded to 8 places (half even on x * 1e8, as the reference)."""
    days, f1 = _days_and_fraction(x, x_micros)
    yy, m, d = civil_from_days(days)
    if op == "add_months":
        months = yy * 12 + (m - 1) + y.to(torch.int64)
        ny, nm = months // 12, months % 12 + 1
        nd = torch.minimum(d, month_len(ny, nm))
        return days_from_civil(ny, nm, nd).to(torch.int32), _merge(xv, yv)
    if op == "last_day":
        return days_from_civil(yy, m, month_len(yy, m)).to(torch.int32), xv
    if op == "weekofyear":
        thursday = days - (days + 3) % 7 + 3
        ty, tm, _ = civil_from_days(thursday)
        jan1 = days_from_civil(ty, torch.ones_like(tm), torch.ones_like(tm))
        return ((thursday - jan1) // 7 + 1).to(torch.int32), xv
    if op != "months_between":
        raise ValueError(f"calendar: {op!r}")
    days2, f2 = _days_and_fraction(y, y_micros)
    y2, m2, d2 = civil_from_days(days2)
    whole = (d == d2) | ((d == month_len(yy, m)) & (d2 == month_len(y2, m2)))
    months = ((yy - y2) * 12 + (m - m2)).to(torch.float64)
    frac = _div((d - d2).to(torch.float64) + f1 - f2, 31.0)
    out = months + torch.where(whole, 0.0, frac)
    return _div(torch.round(out * 1e8), 1e8), _merge(xv, yv)


_CALENDAR_TABLES = {}


def calendar_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15's tables, built once a device and kept: the first day (days
    since 1970-01-01) of each month of 1900-2100 and of 2101-01 (int32),
    and the month (its index in the first) of each day from 1900-01-01 to
    2100-12-31 (int16)."""
    device = torch.device(device)
    tables = _CALENDAR_TABLES.get(device)
    if tables is None:
        j = torch.arange(201 * 12 + 1, dtype=torch.int64)
        starts = days_from_civil(1900 + j // 12, j % 12 + 1,
                                 torch.ones_like(j))
        lengths = starts[1:] - starts[:-1]
        of_day = torch.repeat_interleave(j[:-1], lengths)
        tables = _CALENDAR_TABLES[device] = (
            starts.to(torch.int32).to(device),
            of_day.to(torch.int16).to(device))
    return tables


def calendar(x: torch.Tensor, xv: Optional[torch.Tensor], op: str,
             y: Optional[torch.Tensor] = None,
             yv: Optional[torch.Tensor] = None, x_micros: bool = False,
             y_micros: bool = False) -> CV:
    """K15: ``calendar_plain`` as a kernel on the card
    (``csrc/expr_math.cu`` ``sail_calendar``: one instantiation an
    operation and operand kinds, over the tables of
    ``calendar_tables``). A scalar second operand is read once a thread,
    from the host where it lies there (a literal's value) or on the card; a
    scalar first operand beside a column is repeated into one. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if op not in _CALENDAR_CODE:
        raise ValueError(f"calendar: {op!r}")
    two = op in ("add_months", "months_between")
    if two != (y is not None):
        raise ValueError(f"calendar: {op} takes {2 if two else 1} operands")
    x = _kernel_type(x)
    y = None if y is None else _kernel_type(y)
    if (x.is_floating_point() or (y is not None and y.is_floating_point())
            or ((x_micros and x.dtype != torch.int64) or
                (y_micros and y.dtype != torch.int64))):
        raise TypeError("calendar: int32 or int64 days (or months), int64 "
                        "microseconds")
    if x.device.type == "cpu" and (y is None or y.device.type == "cpu"):
        return calendar_plain(x, xv, op, y, yv, x_micros, y_micros)
    dev = _check_cuda("calendar", *(t for t in (x, xv, y, yv)
                                    if not _host_scalar(t)))
    n = _rows(x, xv, y, yv)
    scalar = x.dim() == 0 and (y is None or y.dim() == 0)
    out = torch.empty(n, dtype=torch.float64 if op == "months_between"
                      else torch.int32, device=dev)
    fresh = xv is not None and yv is not None
    out_valid = torch.empty(n, dtype=torch.bool, device=dev) if fresh \
        else None
    xv = None if xv is None else xv.to(dev)
    yv = None if yv is None else yv.to(dev)
    xf, vxf = _column_on(x, xv, n, dev)
    yf = _flat(y)
    vyf = None if y is None else _row_validity(yv, y)
    word = 0
    if y is not None and y.dim() == 0:
        if _host_scalar(y):  # a literal's value, read here
            yf, word = None, int(y.item())
        else:  # read on the card, once a thread, as an int64
            yf = yf.to(torch.int64)
    if not fresh:  # the kernel reads no validity
        vxf = vyf = None
    if n:
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("expr_math.cu", "sail_calendar")(
                xf.data_ptr(), _MICROS if x_micros else _TYPE_CODE[x.dtype],
                _ptr(vxf), _ptr(yf),
                0 if y is None else
                _MICROS if y_micros else _TYPE_CODE[y.dtype],
                _ptr(vyf), int(y is not None and y.dim() == 0), word, n,
                _CALENDAR_CODE[op], *(t.data_ptr()
                                      for t in calendar_tables(dev)),
                out.data_ptr(), _ptr(out_valid), csrc.stream_ptr(dev)),
                "calendar")
        calendar.launches += 1
        calendar.by_op[op].launches += 1
    validity = out_valid if fresh else (xv if yv is None else yv)
    return _shape_back(out, scalar), _shape_back(validity, scalar) \
        if fresh else validity


calendar.launches = 0
# the launches of each operation's instantiations
calendar.by_op = {op: types.SimpleNamespace(launches=0)
                  for op in CALENDAR_OPS}


# ---------------------------------------------------------------------------
# sample_mask (TABLESAMPLE): torch ops
# ---------------------------------------------------------------------------

def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def sample_mask(n: int, fraction: float, seed: int, device) -> torch.Tensor:
    """Row i is kept where splitmix64(i + seed) >> 11, as a double in
    [0, 1), is below ``fraction``: bit-exact with the reference's
    ``_sample_mask_builder`` (uint64 arithmetic in wrapping int64)."""
    x = torch.arange(n, dtype=torch.int64, device=device) + \
        _wrap64(int(seed))
    x = (x ^ _shr(x, 30)) * _wrap64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _wrap64(0x94D049BB133111EB)
    x = x ^ _shr(x, 31)
    return _shr(x, 11).to(torch.float64) / float(1 << 53) < fraction


def _wrap64(v: int) -> int:
    """An unsigned 64-bit constant as the int64 of the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v
