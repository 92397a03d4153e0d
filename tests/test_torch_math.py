"""The port's math, rounding, bitwise and calendar builders (K12-K15,
``sail_tpu_torch/functions/numeric.py``) against the reference's compiler
and against Spark.

Every ported builder runs through SQL over one table (int, long, double
with NaN, infinities and zeros, decimal(15,2), dates; NULLs in each) in
both packages, and the answers must agree: integers, decimals, dates and
bools exactly, NULLs in the same places, float64 within a relative 1e-12
(the harness's tolerance; NaN equals NaN). Where the reference is wrong
(ROADMAP Queue C) the port is held to Spark's answer, computed here with
Python's ``math`` and ``decimal``, and the reference's answer is asserted
to differ. The ``gpu`` tests hold each kernel against its plain version
on the card.
"""

import datetime
import hashlib
import math
from decimal import ROUND_HALF_EVEN, ROUND_HALF_UP, Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu.plan import compiler as jcomp
from sail_tpu_torch.functions import numeric as num
from sail_tpu_torch.plan import compiler as tcomp
from torch_tpch_common import port_session, reference_session

FLOAT_RTOL = 1e-12
N = 96


def _table() -> pa.Table:
    rng = np.random.default_rng(11)
    dbl = rng.normal(0, 100, N)
    dbl[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 1.0, 710.0]
    dec = [Decimal(int(v)).scaleb(-2) for v in
           rng.integers(-10_000_000, 10_000_000, N)]
    dec[:6] = [Decimal("-1.50"), Decimal("0.00"), Decimal("48198.25"),
               Decimal("-0.05"), Decimal("2.50"), Decimal("-2.50")]
    ints = rng.integers(-1000, 1000, N).astype(np.int32)
    ints[:5] = [5, 15, 25, -5, -15]
    longs = rng.integers(-10**12, 10**12, N)
    longs[:3] = [0, 1, -(1 << 40)]

    def masked(values, typ=None):
        return pa.array(values, typ, mask=rng.random(N) < 0.1)

    return pa.table({
        "i": masked(ints), "l": masked(longs), "d": masked(dbl),
        "m": masked(dec, pa.decimal128(15, 2)),
        "s": pa.array(rng.integers(0, 130, N).astype(np.int32)),
        "dt": masked(rng.integers(-3000, 20000, N).astype(np.int32)
                     ).cast(pa.date32()),
        "dt2": pa.array(rng.integers(8000, 11000, N).astype(np.int32)
                        ).cast(pa.date32()),
        "w": pa.array(["Robert", "Rupert", "Tymczak", "Pfister", "", "Ashcraft",
                       "Honeyman", "abc"] * (N // 8)),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def sessions(table):
    return port_session({"t": table}), reference_session({"t": table})


def _same(got: pa.Array, want: pa.Array) -> bool:
    """Same values and NULLs; floats within FLOAT_RTOL, NaN equal."""
    if got.type != want.type or len(got) != len(want):
        return False
    if got.is_null().to_pylist() != want.is_null().to_pylist():
        return False
    if pa.types.is_floating(want.type):
        g = got.to_numpy(zero_copy_only=False)
        w = want.to_numpy(zero_copy_only=False)
        return bool(np.all(np.isclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                      equal_nan=True) | (g == w)))
    return got.to_pylist() == want.to_pylist()


def _column(spark, expr: str) -> pa.Array:
    return spark.sql(f"SELECT {expr} AS x FROM t").toArrow() \
        .column(0).combine_chunks()


# ---------------------------------------------------------------------------
# the port against the reference, where the reference gives Spark's answer
# ---------------------------------------------------------------------------

_UNARY = ("sqrt", "expm1", "sinh", "cosh", "tanh", "asin", "acos",
          "atan", "cbrt", "rint", "degrees", "radians", "sign", "signum",
          "floor", "ceil", "ceiling", "isnan", "sin", "cos", "tan")
_AGREE = [f"{f}({c})" for f in _UNARY for c in "ildm"
          # XLA's CPU sin, cos and tan of arguments up to 1e5 are ~3e-12
          # off libm (and Java's StrictMath): held to Spark below
          if not (f in ("sin", "cos", "tan") and c == "m")]
_AGREE += [f"{f}({c})" for f in ("abs", "negative") for c in "ild"]
_AGREE += ["~i", "~l"] + [f"exp({c})" for c in "ldm"]
_AGREE += [f"{f}(d, l)" for f in ("atan2", "power", "hypot")]
_AGREE += [f"{f}(l, d)" for f in ("atan2", "power", "hypot")]
_AGREE += [f"shiftleft({c}, 3)" for c in "il"] + \
    [f"shiftright({c}, 5)" for c in "il"]
_AGREE += [f"i {op} l" for op in "&|^"] + [f"l {op} 7" for op in "&|^"] + \
    [f"i {op} i" for op in "&|^"]
_AGREE += [f"{f}({c}{dg})" for f in ("round", "bround") for c in "ildm"
           for dg in ("", ", 0", ", 1", ", 2", ", 3")]
_AGREE += [f"{f}(d, -1)" for f in ("round", "bround")]
_AGREE += [f"bround({c}, {dg})" for c in "il" for dg in (-1, -2, -3)]
_AGREE += ["bround(25, -1)", "power(-1.50, 2)", "log(2.0, 2.0)"]
_AGREE += ["nanvl(d, 1.5)", "nanvl(d, i)", "nanvl(i, d)", "nvl2(i, l, 0)",
           "nvl2(d, 1, 2)", "nvl2(m, d, i)", "isnan(i)",
           "datediff(dt, dt2)", "datediff(dt2, dt)", "date_add(dt, i)",
           "date_add(dt2, 30)", "date_sub(dt, 30)", "date_sub(dt2, i)",
           "add_months(dt, i)", "add_months(dt2, -13)",
           "add_months(dt, 1)", "months_between(dt, dt2)",
           "months_between(dt2, date '1999-01-01')",
           "months_between(date '2000-02-29', dt)", "last_day(dt)",
           "last_day(dt2)", "weekofyear(dt)", "weekofyear(dt2)", "week(dt)",
           "sqrt(-4)", "cbrt(27.0)", "exp(1)", "round(2.675, 2)",
           "round(CAST(2.675 AS DOUBLE), 2)", "bround(2.5, 0)",
           "floor(-1.50)", "ceil(-1.50)", "i & 1"]


@pytest.mark.parametrize("expr", _AGREE)
def test_builder_matches_reference(sessions, expr):
    port, ref = sessions
    got, want = _column(port, expr), _column(ref, expr)
    assert _same(got, want), (got.to_pylist()[:8], want.to_pylist()[:8])


# ---------------------------------------------------------------------------
# the port against Spark, where the reference is wrong
# ---------------------------------------------------------------------------

def _f(x):
    return None if x is None else float(x)


def _log(x, fn, low=0.0):
    if x is None or (x == x and float(x) <= low):
        return None
    return fn(float(x)) if x == x else math.nan


def _np(fn, *xs):
    if any(x is None for x in xs):
        return None
    with np.errstate(all="ignore"):
        return float(fn(*(np.float64(x) for x in xs)))


def _log_base(b, x):
    if b is None or x is None:
        return None
    if (b == b and b <= 0) or (x == x and x <= 0):
        return None
    with np.errstate(all="ignore"):
        return float(np.log(np.float64(x)) / np.log(np.float64(b)))


def _wrap(v, bits):
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _shift(x, c, bits, left):
    if x is None or c is None:
        return None
    c &= bits - 1
    return _wrap(x << c, bits) if left else x >> c


def _round(x, digits, mode, integral):
    if x is None:
        return None
    q = Decimal(x).quantize(Decimal(1).scaleb(-digits), rounding=mode)
    return int(q) if integral else q


_SPARK = {
    "abs(m)": lambda r: None if r["m"] is None else abs(r["m"]),
    # XLA flushes subnormal results to zero; Java's exp does not
    "exp(i)": lambda r: _np(np.exp, r["i"]),
    "negative(m)": lambda r: None if r["m"] is None else -r["m"],
    "ln(d)": lambda r: _log(r["d"], math.log),
    "ln(i)": lambda r: _log(r["i"], math.log),
    "ln(m)": lambda r: _log(r["m"], math.log),
    "log10(d)": lambda r: _log(r["d"], math.log10),
    "log10(m)": lambda r: _log(r["m"], math.log10),
    "log2(l)": lambda r: _log(r["l"], math.log2),
    "log2(m)": lambda r: _log(r["m"], math.log2),
    "log1p(d)": lambda r: _log(r["d"], math.log1p, -1.0),
    "log1p(m)": lambda r: _log(r["m"], math.log1p, -1.0),
    "log(d)": lambda r: _log(r["d"], math.log),
    "log(d, l)": lambda r: _log_base(r["d"], r["l"]),
    "log(m, i)": lambda r: _log_base(_f(r["m"]), r["i"]),
    "log(2.0, d)": lambda r: _log_base(2.0, r["d"]),
    "atan2(m, i)": lambda r: _np(np.arctan2, _f(r["m"]), r["i"]),
    "atan2(2.0, d)": lambda r: _np(np.arctan2, 2.0, r["d"]),
    "power(m, i)": lambda r: _np(np.power, _f(r["m"]), r["i"]),
    "power(m, m)": lambda r: _np(np.power, _f(r["m"]), _f(r["m"])),
    "hypot(m, i)": lambda r: _np(np.hypot, _f(r["m"]), r["i"]),
    "hypot(m, m)": lambda r: _np(np.hypot, _f(r["m"]), _f(r["m"])),
    "hypot(2.0, d)": lambda r: _np(np.hypot, 2.0, r["d"]),
    "sin(m)": lambda r: _np(np.sin, _f(r["m"])),
    "cos(m)": lambda r: _np(np.cos, _f(r["m"])),
    "tan(m)": lambda r: _np(np.tan, _f(r["m"])),
    "shiftleft(i, s)": lambda r: _shift(r["i"], r["s"], 32, True),
    "shiftleft(l, s)": lambda r: _shift(r["l"], r["s"], 64, True),
    "shiftright(i, s)": lambda r: _shift(r["i"], r["s"], 32, False),
    "shiftright(l, s)": lambda r: _shift(r["l"], r["s"], 64, False),
}
for _fn, _mode in (("round", ROUND_HALF_UP), ("bround", ROUND_HALF_EVEN)):
    # bround of an integer goes through the reference's double formula,
    # which is right; its round keeps every digit
    for _c in "ilm" if _fn == "round" else "m":
        for _dg in (-1, -2, -3):
            _SPARK[f"{_fn}({_c}, {_dg})"] = (
                lambda r, c=_c, dg=_dg, mode=_mode:
                _round(r[c], dg, mode, c != "m"))
# known wrong answers of the reference, as literals (one value a row)
_SPARK_LITERALS = {
    "abs(CAST(-1.50 AS DECIMAL(12,2)))": Decimal("1.50"),
    "abs(48198.25)": Decimal("48198.25"),
    "hypot(-1.50, 0)": 1.5,
    "round(48198.25, -1)": Decimal("48200"),
    "round(3, -1)": 0,
    "shiftleft(3, 65)": 6,
    "shiftleft(CAST(1 AS INT), 33)": 2,
    "ln(0)": None,
    "log10(-1)": None,
}


def _want_values(table, fn):
    return [fn(r) for r in table.to_pylist()]


def _values_equal(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if g is None or w is None:
            if g is not w:
                return False
        elif isinstance(w, float):
            if not (g == w or (math.isnan(g) and math.isnan(w)) or
                    abs(g - w) <= FLOAT_RTOL * abs(w)):
                return False
        elif g != w:
            return False
    return True


@pytest.mark.parametrize("expr", list(_SPARK))
def test_builder_matches_spark_where_the_reference_does_not(sessions, table,
                                                            expr):
    port, ref = sessions
    want = _want_values(table, _SPARK[expr])
    got = _column(port, expr).to_pylist()
    assert _values_equal(got, want), [
        (g, w) for g, w in zip(got, want) if not _values_equal([g], [w])][:4]
    if expr.split("(")[0] in ("sin", "cos", "tan"):
        # the reference is ~3e-12 off: within a looser bound, not 1e-12
        ref_vals = _column(ref, expr).to_numpy(zero_copy_only=False)
        w = np.array([np.nan if v is None else v for v in want])
        assert np.allclose(ref_vals, w, rtol=1e-9, equal_nan=True)
        assert not _values_equal(_column(ref, expr).to_pylist(), want)
        return
    assert not _values_equal(_column(ref, expr).to_pylist(), want)


@pytest.mark.parametrize("expr", list(_SPARK_LITERALS))
def test_reference_probe_answers_as_spark(sessions, expr):
    port, ref = sessions
    want = [_SPARK_LITERALS[expr]] * N
    assert _values_equal(_column(port, expr).to_pylist(), want)
    assert not _values_equal(_column(ref, expr).to_pylist(), want)


# ---------------------------------------------------------------------------
# queries that raised in the port before these builders
# ---------------------------------------------------------------------------

_PROBES = {
    "sqrt": "SELECT sum(sqrt(abs(d))) FROM t WHERE d = d",
    "stddev": "SELECT stddev(l), stddev_samp(i), stddev_pop(m) FROM t",
    "abs": "SELECT max(abs(i)), min(abs(l)), max(abs(d)) FROM t",
    "round": "SELECT round(sum(m), 1), round(avg(i), 2) FROM t",
    "bround": "SELECT bround(sum(m), 1), bround(avg(l), 0) FROM t",
    "ceil_floor": "SELECT sum(ceil(m)), sum(floor(m)), max(floor(d / 3)) "
                  "FROM t WHERE d = d AND abs(d) < 1e300",
    "exp_ln": "SELECT sum(exp(i / 1000.0)), sum(ln(abs(l) + 1)) FROM t",
    "bitand": "SELECT sum(i & 1), sum(l & 255) FROM t",
    "date_add": "SELECT min(date_add(dt, 10)), max(date_add(dt2, i)) FROM t",
    "nvl2": "SELECT sum(nvl2(i, 1, 0)), sum(nvl2(m, l, 0)) FROM t",
    "isnan": "SELECT sum(CASE WHEN isnan(d) THEN 1 ELSE 0 END) FROM t",
}


@pytest.mark.parametrize("probe", list(_PROBES))
def test_probe_query_answers_and_matches_reference(sessions, probe):
    port, ref = sessions
    got = port.sql(_PROBES[probe]).toArrow()
    want = ref.sql(_PROBES[probe]).toArrow()
    assert got.num_rows == want.num_rows == 1
    for g, w in zip(got.columns, want.columns):
        assert _same(g.combine_chunks(), w.combine_chunks()), (g, w)


def test_stddev_matches_numpy(sessions, table):
    port, _ = sessions
    got = port.sql("SELECT stddev(l), stddev_pop(d) FROM t "
                   "WHERE d = d AND abs(d) < 1e300").toArrow().to_pylist()[0]
    rows = [r for r in table.to_pylist() if r["d"] is not None and
            r["d"] == r["d"] and abs(r["d"]) < 1e300]
    ls = np.array([r["l"] for r in rows if r["l"] is not None],
                  dtype=np.float64)
    ds = np.array([r["d"] for r in rows])
    assert math.isclose(list(got.values())[0], ls.std(ddof=1), rel_tol=1e-12)
    assert math.isclose(list(got.values())[1], ds.std(ddof=0), rel_tol=1e-12)


# ---------------------------------------------------------------------------
# compiler-level: sample_mask, the string transforms, months_between's
# rounding
# ---------------------------------------------------------------------------

class _Lit:
    """A compiled literal argument in both compilers' shape."""

    def __init__(self, value, dtype, as_torch):
        self.dtype = dtype
        self.dictionary = None
        self.fn = (lambda cols: (torch.tensor(value), None)) if as_torch \
            else (lambda cols: (np.asarray(value), None))


@pytest.mark.parametrize("fraction,seed", [(0.1, 0), (0.5, 42), (0.9, 7),
                                           (0.3, -5)])
def test_sample_mask_bit_exact_with_reference(fraction, seed):
    from sail_tpu.spec import data_type as jdt
    from sail_tpu_torch.spec import data_type as tdt
    n = 5000
    t_args = [_Lit(fraction, tdt.DoubleType(), True),
              _Lit(seed, tdt.LongType(), True)]
    j_args = [_Lit(fraction, jdt.DoubleType(), False),
              _Lit(seed, jdt.LongType(), False)]
    t_fn = tcomp._BUILDERS["sample_mask"](t_args, None)
    j_fn = jcomp._NUMERIC_BUILDERS["sample_mask"](j_args, None, {})
    cols_t = [(torch.zeros(n, dtype=torch.int64), None)]
    cols_j = [(np.zeros(n, dtype=np.int64), None)]
    got, gv = t_fn(cols_t)
    want, wv = j_fn(cols_j)
    assert gv is None and wv is None
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert abs(got.float().mean().item() - fraction) < 0.05


_WORDS = ["Robert", "Rupert", "Tymczak", "Pfister", "", "Ashcraft",
          "Honeyman", "abc"]


@pytest.mark.parametrize("fn,want", [
    ("md5", lambda v: hashlib.md5(v.encode()).hexdigest()),
    ("sha1", lambda v: hashlib.sha1(v.encode()).hexdigest()),
    ("sha", lambda v: hashlib.sha1(v.encode()).hexdigest()),
    ("sha2(w, 256)", lambda v: hashlib.sha256(v.encode()).hexdigest()),
    ("sha2(w, 512)", lambda v: hashlib.sha512(v.encode()).hexdigest()),
    ("sha2(w, 224)", lambda v: hashlib.sha224(v.encode()).hexdigest()),
    ("soundex", tcomp._soundex),
])
def test_string_hash_and_soundex_transforms(sessions, fn, want):
    port, ref = sessions
    expr = fn if "(" in fn else f"{fn}(w)"
    got = _column(port, expr).to_pylist()
    assert got == [want(v) for v in _WORDS] * (N // 8)
    assert got == _column(ref, expr).to_pylist()


def test_soundex_copy_matches_reference_and_spark_codes():
    from sail_tpu.functions.host_strings import _soundex as ref_soundex
    words = _WORDS + ["Lee", "Gutierrez", "Jackson", "Washington", "A"]
    assert [tcomp._soundex(w) for w in words] == \
        [ref_soundex(w) for w in words]
    # Spark's (Apache Commons') American Soundex codes
    assert [tcomp._soundex(w) for w in ("Robert", "Rupert", "Tymczak",
                                         "Pfister", "Ashcraft")] == \
        ["R163", "R163", "T522", "P236", "A261"]


def test_months_between_rounds_as_spark():
    """Spark rounds months_between to 8 places half up on the double's
    decimal value; the port rounds half even on x * 1e8, as the
    reference. For dates the two agree: a fraction k/31 never lies within
    an ulp of a tie."""
    d1 = torch.arange(7000, 13000, 7, dtype=torch.int32)
    d2 = torch.full_like(d1, 10_000) - torch.arange(d1.shape[0],
                                                    dtype=torch.int32) % 400
    got, _ = num.calendar(d1, None, "months_between", d2, None)
    for a, b, g in zip(d1.tolist(), d2.tolist(), got.tolist()):
        x = datetime.date.fromordinal(719163 + a)
        y = datetime.date.fromordinal(719163 + b)
        last = (x + datetime.timedelta(days=1)).month != x.month and \
            (y + datetime.timedelta(days=1)).month != y.month
        months = (x.year - y.year) * 12 + (x.month - y.month)
        raw = float(months) if x.day == y.day or last else \
            months + (x.day - y.day) / 31.0
        want = float(Decimal(raw).quantize(Decimal("1e-8"), ROUND_HALF_UP))
        assert g == want, (x, y, g, want)


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_empty_columns():
    e64 = torch.empty(0, dtype=torch.int64)
    ef = torch.empty(0, dtype=torch.float64)
    for op in num.UNARY_OPS:
        x = e64 if op == "~" else ef
        out, _ = num.math_unary(x, None, op)
        assert out.shape == (0,)
    assert num.round_number(e64, False, -1).shape == (0,)
    assert num.math_binary(ef, None, ef, None, "atan2")[0].shape == (0,)
    assert num.calendar(torch.empty(0, dtype=torch.int32), None,
                        "last_day")[0].shape == (0,)


def test_wrappers_refuse_unknown_operations():
    x = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        num.math_unary(x, None, "cot")
    with pytest.raises(ValueError):
        num.math_binary(x, None, x, None, "mod")
    with pytest.raises(ValueError):
        num.calendar(torch.zeros(3, dtype=torch.int32), None, "next_day")
    with pytest.raises(TypeError):
        num.math_binary(x, None, x, None, "&")


def _dispatch(enum_name: str, macro: str):
    """The op names of ``enum <enum_name>`` (expr_math.cuh), in order, and
    those of the dispatch table ``<macro>`` (expr_math.cu) from which an
    entry point picks an instantiation a call."""
    import pathlib
    import re
    csrc = pathlib.Path(num.__file__).parents[1] / "csrc"
    header = (csrc / "expr_math.cuh").read_text()
    body = re.search(rf"enum {enum_name} {{(.*?)}};", header, re.S).group(1)
    enum = [x.split("=")[0].strip() for x in body.split(",") if x.strip()]
    source = (csrc / "expr_math.cu").read_text()
    table = re.search(rf"#define {macro}\(X\)(.*?)\n\n", source,
                      re.S).group(1)
    return enum, re.findall(r"X\((k\w+)\)", table)


def test_every_unary_op_has_an_instantiation():
    """Every op that the compiler's builders send to ``math_unary``
    (``functions/numeric.py`` UNARY_OPS, each code its position) is the
    enum member of that code in expr_math.cuh, and is in the dispatch
    table of expr_math.cu once: it has its own instantiations."""
    enum, table = _dispatch("Unary", "SAIL_UNARY_TABLE")
    assert len(enum) == len(num.UNARY_OPS)
    assert set(num.UNARY_OPS) <= set(tcomp._BUILDERS)
    for op, member in zip(num.UNARY_OPS, enum):
        assert member.lower() == "k" + {"~": "not"}.get(op, op), (op,
                                                                   member)
        assert table.count(member) == 1, member
    assert len(table) == len(enum)


_BINARY_MEMBERS = {"atan2": "kAtan2", "hypot": "kHypot", "power": "kPower",
                   "log": "kLogBase", "&": "kAnd", "|": "kOr", "^": "kXor",
                   "shiftleft": "kShiftLeft", "shiftright": "kShiftRight",
                   "nanvl": "kNanvl"}
_CALENDAR_MEMBERS = {"add_months": "kAddMonths",
                     "months_between": "kMonthsBetween",
                     "last_day": "kLastDay", "weekofyear": "kWeekOfYear"}


@pytest.mark.parametrize("ops,members,enum_name,macro", [
    (num.BINARY_OPS, _BINARY_MEMBERS, "Binary", "SAIL_BINARY_TABLE"),
    (num.CALENDAR_OPS, _CALENDAR_MEMBERS, "Calendar", "SAIL_CALENDAR_TABLE"),
], ids=["K14", "K15"])
def test_every_binary_and_calendar_op_has_an_instantiation(ops, members,
                                                            enum_name, macro):
    """Every op the compiler sends to ``math_binary`` (K14) and
    ``calendar`` (K15), each code its position in BINARY_OPS or
    CALENDAR_OPS, is the enum member of that code in expr_math.cuh and is
    in its dispatch table in expr_math.cu once: it has its own
    instantiations."""
    enum, table = _dispatch(enum_name, macro)
    assert [members[op] for op in ops] == enum
    for member in enum:
        assert table.count(member) == 1, member
    assert len(table) == len(enum)


def test_calendar_tables_are_the_months_of_1900_to_2100():
    """K15's tables, built once on the host: the days of the first of each
    month of 1900-2100 and of 2101-01, and each day's month from
    1900-01-01 to 2100-12-31 (expr_math.cu kDay0, kDays)."""
    import pathlib
    import re
    starts, of_day = num.calendar_tables("cpu")
    first = datetime.date(1970, 1, 1)
    want = [(datetime.date(1900 + j // 12, j % 12 + 1, 1) - first).days
            for j in range(201 * 12 + 1)]
    assert starts.dtype == torch.int32 and starts.tolist() == want
    assert of_day.dtype == torch.int16
    assert of_day.shape[0] == want[-1] - want[0]
    for day in (0, 59, 365 * 70 + 17, of_day.shape[0] - 1):
        d = datetime.date(1900, 1, 1) + datetime.timedelta(days=day)
        assert int(of_day[day]) == (d.year - 1900) * 12 + d.month - 1
    source = (pathlib.Path(num.__file__).parents[1] / "csrc" /
              "expr_math.cu").read_text()
    assert int(re.search(r"kDay0 = (-?\d+)", source).group(1)) == want[0]
    assert int(re.search(r"kDays = (\d+)", source).group(1)) == \
        of_day.shape[0]
    assert num.calendar_tables("cpu")[0] is starts


# cbrt's edge cases: zeros, subnormals (the smallest, and an exact cube
# of 2^-350), exact cubes, values near the overflow limit, infinities, NaN
CBRT_CASES = [0.0, -0.0, 5e-324, -5e-324, 1e-310, 2.0 ** -1050, -3e-320,
              27.0, -8.0, 1e-100 ** 3, 1e308, 1.7976931348623157e308,
              -1e308, math.inf, -math.inf, math.nan]


def _within_an_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """NaN where NaN, the same sign, infinities equal, else within one
    ulp of want."""
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        return False
    got, want = got[~nan], want[~nan]
    if not np.array_equal(np.signbit(got), np.signbit(want)):
        return False
    inf = np.isinf(want)
    return bool(np.array_equal(got[inf], want[inf]) and
                (np.abs(got[~inf] - want[~inf]) <=
                 np.spacing(np.abs(want[~inf]))).all())


@pytest.mark.parametrize("x", CBRT_CASES, ids=repr)
def test_cbrt_within_an_ulp_of_numpy(x):
    """The plain cube root within one ulp of numpy.cbrt: a subnormal x
    once cubed its root into underflow, and the Newton step moved it by
    tens of ulp."""
    got = num._cbrt(torch.tensor([x], dtype=torch.float64)).numpy()
    assert _within_an_ulp(got, np.cbrt(np.array([x]))), (got, np.cbrt(x))


def test_floor_ceil_of_doubles_saturate_as_spark():
    x = torch.tensor([math.nan, math.inf, -math.inf, 1e300, -1e300, -2.5,
                      2.5, 9.3e18, -9.3e18], dtype=torch.float64)
    fl, _ = num.math_unary(x, None, "floor")
    ce, _ = num.math_unary(x, None, "ceil")
    top, bottom = (1 << 63) - 1, -(1 << 63)
    assert fl.tolist() == [0, top, bottom, top, bottom, -3, 2, top, bottom]
    assert ce.tolist() == [0, top, bottom, top, bottom, -2, 3, top, bottom]


def test_abs_and_negative_of_the_minimum_wrap():
    x = torch.tensor([-(1 << 63), 5, -7], dtype=torch.int64)
    assert num.math_unary(x, None, "abs")[0].tolist() == [-(1 << 63), 5, 7]
    assert num.math_unary(x, None, "negative")[0].tolist() == \
        [-(1 << 63), -5, 7]
    y = torch.tensor([-(1 << 31), 3], dtype=torch.int32)
    assert num.math_unary(y, None, "abs")[0].tolist() == [-(1 << 31), 3]


# ---------------------------------------------------------------------------
# card: K12-K15 against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edge_columns(dev, n=100_003):
    rng = np.random.default_rng(4)
    d = rng.normal(0, 1e3, n)
    d[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 1.0, 710.0, -710.0,
              2.5, -2.5, 1e-310]
    m = rng.integers(-10**9, 10**9, n)
    m[:4] = [-150, 0, 4819825, -5]
    i64 = rng.integers(-10**12, 10**12, n)
    i64[:2] = [-(1 << 63), (1 << 63) - 1]
    i32 = rng.integers(-10**6, 10**6, n).astype(np.int32)
    i32[:1] = [-(1 << 31)]
    valid = rng.random(n) < 0.9
    counts = rng.integers(0, 200, n)
    days = rng.integers(-50_000, 60_000, n).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(dev)
    return dict(d=t(d), m=t(m), l=t(i64), i=t(i32), v=t(valid),
                c=t(counts), days=t(days))


def _close_ulps(got, want, ulps=8):
    if not got.is_floating_point():
        return torch.equal(got, want)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    tol = ulps * 2.0 ** -52 * want.abs()
    return bool((same | ((got - want).abs() <= tol)).all())


def _cv_equal(got, want):
    (g, gv), (w, wv) = got, want
    if (gv is None) != (wv is None):
        return False
    if gv is not None and not torch.equal(gv, wv):
        return False
    if gv is not None:
        g, w = g[gv], w[gv]
    return _close_ulps(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.UNARY_OPS)
def test_k12_matches_plain_on_card(cuda, op):
    c = _edge_columns(cuda)
    inputs = [(c["l"], 0), (c["i"], 0)] if op == "~" else \
        [(c["d"], 0), (c["m"], 2), (c["l"], 0), (c["i"], 0)]
    for x, scale in inputs:
        before = num.math_unary.launches
        got = num.math_unary(x, c["v"], op, scale)
        assert num.math_unary.launches == before + 1
        want = num.math_unary_plain(x, c["v"], op, scale)
        assert _cv_equal(got, want), (op, x.dtype, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.UNARY_OPS)
def test_k12_instantiations_match_plain_on_card(cuda, op):
    """Each instantiation (op, input type) at 100,000 rows with the edge
    values, held to ``math_unary_plain`` within 8 ulp: the columns
    aligned (the 16 B vectors), a row off alignment (one row at a time),
    with a validity and without."""
    c = _edge_columns(cuda, 100_001)
    inputs = [(c["l"], 0), (c["i"], 0)] if op == "~" else \
        [(c["d"], 0), (c["m"], 2), (c["l"], 0), (c["i"], 0)]
    for x, scale in inputs:
        for lo in (0, 1):
            xs, vs = x[lo:lo + 100_000], c["v"][lo:lo + 100_000]
            for v in (vs, None):
                got = num.math_unary(xs, v, op, scale)
                want = num.math_unary_plain(xs, v, op, scale)
                assert _cv_equal(got, want), (op, x.dtype, scale, lo)


@pytest.mark.gpu
def test_k12_cbrt_matches_numpy_on_card(cuda):
    """K12's cbrt and its plain version on the card, both within one ulp
    of numpy.cbrt on the edge columns' doubles and CBRT_CASES."""
    d = torch.cat([_edge_columns(cuda)["d"],
                   torch.tensor(CBRT_CASES, dtype=torch.float64,
                                device=cuda)])
    want = np.cbrt(d.cpu().numpy())
    kernel, _ = num.math_unary(d, None, "cbrt")
    plain, _ = num.math_unary_plain(d, None, "cbrt")
    assert _within_an_ulp(kernel.cpu().numpy(), want)
    assert _within_an_ulp(plain.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("half_even", [False, True])
@pytest.mark.parametrize("digits", [-3, -1, 0, 1, 2, 4])
def test_k13_matches_plain_on_card(cuda, half_even, digits):
    c = _edge_columns(cuda)
    for x, s in ((c["m"], 2), (c["l"], 0), (c["i"], 0), (c["d"], 0)):
        so = min(s, max(digits, 0)) if s else 0
        got = num.round_number(x, half_even, digits, s, so)
        want = num.round_number_plain(x, half_even, digits, s, so)
        assert _close_ulps(got, want), (x.dtype, s)


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.BINARY_OPS)
def test_k14_matches_plain_on_card(cuda, op):
    c = _edge_columns(cuda)
    if op in num.BITWISE_OPS:
        pairs = [(c["l"], 0, c["c"], 0), (c["i"], 0, c["c"], 0),
                 (c["l"], 0, torch.tensor(7, device=cuda), 0)]
    elif op == "nanvl":
        pairs = [(c["d"], 0, c["m"], 2),
                 (c["d"], 0, torch.tensor(1.5, device=cuda,
                                          dtype=torch.float64), 0)]
    else:
        pairs = [(c["d"], 0, c["m"], 2), (c["m"], 2, c["i"], 0),
                 (torch.tensor(250, device=cuda), 2, c["d"], 0)]
    for x, sx, y, sy in pairs:
        for xv, yv in ((c["v"], None), (None, c["v"]), (c["v"], c["v"]),
                       (None, None)):
            if y.dim() == 0 and yv is not None:
                continue
            got = num.math_binary(x, xv if x.dim() else None, y, yv, op,
                                  sx, sy)
            want = num.math_binary_plain(x, xv if x.dim() else None, y, yv,
                                         op, sx, sy)
            assert _cv_equal(got, want), (op, x.dtype, y.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.CALENDAR_OPS)
def test_k15_matches_plain_on_card(cuda, op):
    c = _edge_columns(cuda)
    days, v = c["days"], c["v"]
    us = days.to(torch.int64) * 86_400_000_000 + \
        (c["c"] * 431_234_567) % 86_400_000_000
    if op == "add_months":
        cases = [(days, v, c["i"] % 3000, None, False, False),
                 (days, None, torch.tensor(-13, device=cuda), None, False,
                  False)]
    elif op == "months_between":
        cases = [(days, v, days.flip(0), v, False, False),
                 (us, None, us.flip(0), v, True, True),
                 (days, None, torch.tensor(10592, device=cuda,
                                           dtype=torch.int32), None, False,
                  False)]
    else:
        cases = [(days, v, None, None, False, False),
                 (us, v, None, None, True, False)]
    for x, xv, y, yv, xm, ym in cases:
        got = num.calendar(x, xv, op, y, yv, xm, ym)
        want = num.calendar_plain(x, xv, op, y, yv, xm, ym)
        assert _cv_equal(got, want), (op, x.dtype)


def _validity_pairs(v):
    return ((v, None), (None, v), (v, v), (None, None))


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.BINARY_OPS)
def test_k14_instantiations_match_plain_on_card(cuda, op):
    """Each K14 instantiation (op, first operand's type, second's type or
    a scalar, power's square) at 100,000 rows with the edge values (NaN,
    infinities, INT64_MIN, shift counts past 63), held to
    ``math_binary_plain`` within 8 ulp: columns aligned (16 B vectors) and
    a row off (one row at a time), each validity given or not, a scalar
    on the host and on the card."""
    c = _edge_columns(cuda, 100_001)
    counts = c["c"]
    on_host = torch.tensor  # a literal's value, as the compiler passes it
    if op in num.BITWISE_OPS:
        xs = [(c["l"], 0), (c["i"], 0)]
        ys = [(counts, 0), (counts.to(torch.int32), 0),
              (on_host(65), 0), (on_host(-3, dtype=torch.int32), 0),
              (torch.tensor(70, device=cuda), 0)]
    elif op == "nanvl":
        xs = [(c["d"], 0)]
        ys = [(c["m"], 2), (c["i"], 0), (c["d"].flip(0), 0),
              (on_host(1.5, dtype=torch.float64), 0)]
    else:
        xs = [(c["d"], 0), (c["m"], 2), (c["i"], 0), (c["l"], 0)]
        ys = [(c["d"].flip(0), 0), (c["m"], 2), (c["i"], 0), (c["l"], 0),
              (on_host(2, dtype=torch.int32), 0),
              (on_host(2.0, dtype=torch.float64), 0),
              (on_host(250), 2), (torch.tensor(-1.5, device=cuda,
                                               dtype=torch.float64), 0),
              (torch.tensor(250, device=cuda), 2)]
    rows = 100_000
    for x, sx in xs:
        for y, sy in ys:
            for lo in (0, 1):
                xc = x[lo:lo + rows]
                yc = y if y.dim() == 0 else y[lo:lo + rows]
                for xv, yv in _validity_pairs(c["v"][lo:lo + rows]):
                    if y.dim() == 0 and yv is not None:
                        yv = c["v"][lo]  # a scalar's validity: one bool
                    got = num.math_binary(xc, xv, yc, yv, op, sx, sy)
                    want = num.math_binary_plain(xc, xv, yc, yv, op, sx,
                                                 sy)
                    assert _cv_equal(got, want), (op, x.dtype, sx, y.dtype,
                                                  y.dim(), lo)


@pytest.mark.gpu
@pytest.mark.parametrize("op", num.CALENDAR_OPS)
def test_k15_instantiations_match_plain_on_card(cuda, op):
    """Each K15 instantiation (op, the operands' kinds: int32 or int64
    days, microseconds, months, a scalar) at 100,000 rows of days from
    1833 to 2134 (outside the month tables too), held to
    ``calendar_plain`` exactly: aligned and a row off, with validities and
    without, a scalar on the host and on the card."""
    c = _edge_columns(cuda, 100_001)
    days, v = c["days"], c["v"]
    us = days.to(torch.int64) * 86_400_000_000 + \
        (c["c"] * 431_234_567) % 86_400_000_000
    xs = [(days, False), (days.to(torch.int64), False), (us, True)]
    if op == "add_months":
        ys = [(c["i"] % 3000, False), ((c["i"] % 300).to(torch.int64), False),
              (torch.tensor(-13, dtype=torch.int32), False),
              (torch.tensor(1, device=cuda), False)]
    elif op == "months_between":
        ys = [(days.flip(0), False), (days.flip(0).to(torch.int64), False),
              (us.flip(0), True),
              (torch.tensor(10592, dtype=torch.int32), False),
              (torch.tensor(10592, dtype=torch.int32, device=cuda), False),
              (torch.tensor(915_148_800_000_123, dtype=torch.int64), True),
              (torch.tensor(915_148_800_000_123, device=cuda), True)]
    else:
        ys = [(None, False)]
    rows = 100_000
    for x, xm in xs:
        for y, ym in ys:
            for lo in (0, 1):
                xc = x[lo:lo + rows]
                yc = y if y is None or y.dim() == 0 else y[lo:lo + rows]
                for xv, yv in _validity_pairs(v[lo:lo + rows]):
                    if y is None:
                        yv = None
                    elif y.dim() == 0 and yv is not None:
                        yv = v[lo]
                    got = num.calendar(xc, xv, op, yc, yv, xm, ym)
                    want = num.calendar_plain(xc, xv, op, yc, yv, xm, ym)
                    assert _cv_equal(got, want), (op, x.dtype, xm, lo)
    if op not in ("add_months", "months_between"):
        return
    # a scalar first operand beside a column, on the host and on the card
    y, ym = ys[0]
    for x in (torch.tensor(10592, dtype=torch.int32),
              torch.tensor(-40_000, device=cuda)):
        for lo in (0, 1):
            yc, yvc = y[lo:lo + rows], v[lo:lo + rows]
            got = num.calendar(x, v[lo], op, yc, yvc, False, ym)
            want = num.calendar_plain(x.to(cuda), v[lo], op, yc, yvc, False,
                                      ym)
            assert _cv_equal(got, want), (op, x.device, lo)


@pytest.mark.gpu
def test_a_literal_validity_broadcasts_on_card(cuda):
    """A 0-d validity (a literal's, merged into a column's) beside a
    column: each kernel reads it as every row's."""
    c = _edge_columns(cuda)
    no = torch.tensor(False, device=cuda)
    got = num.math_unary(c["d"], no, "ln")
    assert got[1].shape == c["d"].shape and not bool(got[1].any())
    got = num.math_binary(c["d"], None, c["m"], no, "hypot", 0, 2)
    assert got[1] is no
    got = num.math_binary(c["d"], c["v"], c["m"], no, "hypot", 0, 2)
    assert not bool(got[1].any())
    got = num.calendar(c["days"], no, "add_months", c["i"] % 50, c["v"])
    assert got[1].shape == c["days"].shape and not bool(got[1].any())


# literal operands of K14 and K15 in either place, a timestamp's too
_LITERAL_OPERANDS = [
    ("power(d, 2)", "math_binary", (False, True)),
    ("power(2, m)", "math_binary", (True, False)),
    ("shiftleft(1, i)", "math_binary", (True, False)),
    ("l & 7", "math_binary", (False, True)),
    ("add_months(dt, 3)", "calendar", (False, True)),
    ("add_months(DATE '2000-01-31', s)", "calendar", (True, False)),
    ("months_between(DATE '1999-01-01', dt)", "calendar", (True, False)),
    ("months_between(dt, TIMESTAMP '1999-01-01 10:30:00')", "calendar",
     (False, True)),
]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("expr,kernel,literal", _LITERAL_OPERANDS,
                         ids=[e for e, _, _ in _LITERAL_OPERANDS])
def test_literal_operands_reach_k14_and_k15_from_the_host(table, device,
                                                          expr, kernel,
                                                          literal,
                                                          monkeypatch):
    """On the closures' route the compiler hands K14 and K15 each literal
    operand as a 0-d tensor on the host (a timestamp's as local µs made
    there), and on the card a call then waits for nothing: no read-back
    of a scalar, no copy of one from the host (CUDA's sync debug mode
    raises on either)."""
    from sail_tpu_torch import SparkSession
    from torch_chain_common import PerOp
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spark = SparkSession({"spark.sail.device": device})
    spark.createDataFrame(table).createOrReplaceTempView("t")
    wrapped, calls = getattr(num, kernel), []

    def spy(*args, **kwargs):
        x, y = args[0], args[2] if kernel == "math_binary" else \
            (args[3] if len(args) > 3 else kwargs.get("y"))
        calls.append(tuple(t.dim() == 0 and t.device.type == "cpu"
                           for t in (x, y)))
        if device != "cuda":
            return wrapped(*args, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return wrapped(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    class Spied:  # the compiler's view of functions/numeric.py
        def __getattr__(self, name):
            return spy if name == kernel else getattr(num, name)

    monkeypatch.setattr(tcomp, "NUM", Spied())
    with PerOp():
        got = _column(spark, expr)
    assert calls and all(c == literal for c in calls), calls
    want = _column(port_session({"t": table}), expr)
    assert _same(got, want), expr


@pytest.mark.parametrize("name", sorted(
    __import__("sail_tpu_torch.benchmarks.expr_variants",
               fromlist=["VARIANTS"]).VARIANTS))
def test_expr_variants_apply_to_the_source(name):
    """Each design variant that benchmarks/expr_variants.py times still
    replaces lines that occur once in csrc/expr_math.cu."""
    from sail_tpu_torch.benchmarks import expr_variants
    text = expr_variants.variant_source(name)
    assert text != expr_variants._SOURCE.read_text()
