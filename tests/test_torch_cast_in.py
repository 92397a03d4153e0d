"""Casts of floats to integers and decimals, and IN over a list that holds
a NULL, in the port (``sail_tpu_torch/plan/compiler.py`` ``_compile_cast``,
``_f_cast``, ``_in_builder``, ``_f_in`` and the dictionary path of IN over
strings; ``ops/chain.py``'s F2I and F2I32) against Spark.

Each query runs through ``SparkSession.sql`` on the CPU twice: on the
chain route (its Filter/Project chain one program, run by
``run_chain_plain``: ``last_chain_routes`` says K16, K17 or K18) and on
the closures (``torch_chain_common.PerOp``). Both must give Spark's
answer, computed here in Python as Spark's non-ANSI rules give it:

- a double to BIGINT or INT truncates toward zero, NaN is 0, and a value
  out of range saturates at the type's limits; SMALLINT and TINYINT take
  the INT's low 16 or 8 bits (Spark's ``toInt(b).toShort``);
- a cast to DECIMAL(p, s) is NULL at NaN, the infinities, and any value
  whose rounded result (half up) needs more than p digits;
- ``x IN (items)`` is TRUE where an item equals x, NULL where x is NULL or
  where no item does and an item is NULL, else FALSE; so ``NOT IN (...,
  NULL)`` keeps no row.

Where the reference (``sail_tpu``) gives Spark's answer, the port is also
held to the reference. Where it does not, the case says why: it
saturates SMALLINT and TINYINT at their own limits, gives 0 or a
saturated value for a decimal, keeps a decimal past its precision, and
reads a NULL item of IN as no match (``sail_tpu/plan/compiler.py:1074``).
The ``gpu`` tests run the same queries on the card (this file imports
the reference only in the ``reference`` fixture, which they do not use).
"""

import math
from collections import Counter
from decimal import ROUND_HALF_UP, Context, Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch import SparkSession
from torch_chain_common import PerOp

F = [math.nan, math.inf, -math.inf, 1e30, -1e30, 3e9, -3e9, 2.7, -2.7, 0.5,
     -0.5, 2147483647.5, -2147483648.9, 9.3e18, -9.3e18, 9.2e18, 123456.75,
     40000.0, -40000.0, 300.0, 0.0, 1.0, 65535.0, 128.0]
N = len(F)
F_NULL = (2 * N // 3, N - 1)  # rows where f is NULL
M = ["99999999.99", "9999.94", "9999.95", "-9999.95", "12.34", "0.00",
     "1.50", "-0.05"] * (N // 8)
M_NULL = (5,)
S = ["a", "b", None, "a", "c", "d", "b", "x"] * (N // 8)
# n: an IN item column, NULL in some rows
ITEM = [1, None, 3, 4, None, 6, 0, None] * (N // 8)


def _table() -> pa.Table:
    rng = np.random.default_rng(16)
    f_mask = np.zeros(N, dtype=bool)
    f_mask[list(F_NULL)] = True
    m_mask = np.zeros(N, dtype=bool)
    m_mask[list(M_NULL)] = True
    return pa.table({
        "k": pa.array(np.arange(1, N + 1, dtype=np.int32)),
        "f": pa.array(np.asarray(F), mask=f_mask),
        "fl": pa.array(np.asarray(F, dtype=np.float32), mask=f_mask),
        "m": pa.array([Decimal(v) for v in M], pa.decimal128(15, 2),
                      mask=m_mask),
        "s": pa.array(S).dictionary_encode(),
        "n": pa.array(ITEM, pa.int32()),
        "r": pa.array(rng.integers(0, 3, N).astype(np.int32)),
    })


TABLE = _table()


# ---------------------------------------------------------------------------
# Spark's answers
# ---------------------------------------------------------------------------

def _column(name: str) -> list:
    return TABLE.column(name).to_pylist()


def _java_long(d):
    if d is None:
        return None
    if math.isnan(d):
        return 0
    if d >= 2.0 ** 63:
        return (1 << 63) - 1
    if d <= -2.0 ** 63:
        return -(1 << 63)
    return int(d)


def _java_int(d):
    if d is None:
        return None
    if math.isnan(d):
        return 0
    if d >= (1 << 31) - 1:
        return (1 << 31) - 1
    if d <= -(1 << 31):
        return -(1 << 31)
    return int(d)


def _low_bits(v, bits):
    if v is None:
        return None
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


def _to_decimal(v, p: int, s: int):
    """Spark's cast of a double (by its shortest repr) or a Decimal to
    DECIMAL(p, s): rounded half up, NULL past p digits, NaN and the
    infinities NULL."""
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return None
    q = Decimal(repr(v) if isinstance(v, float) else v).quantize(
        Decimal(1).scaleb(-s), rounding=ROUND_HALF_UP,
        context=Context(prec=100))
    return None if abs(q.scaleb(s)) >= 10 ** p else q


def _in(x, items):
    if x is None:
        return None
    if any(i is not None and x == i for i in items):
        return True
    return None if any(i is None for i in items) else False


def _not(v):
    return None if v is None else not v


_WIDTHS = {"BIGINT": _java_long, "INT": _java_int,
           "SMALLINT": lambda d: _low_bits(_java_int(d), 16),
           "TINYINT": lambda d: _low_bits(_java_int(d), 8)}


def _fl_values() -> list:
    return [None if v is None else float(np.float32(v))
            for v in _column("f")]


# ---------------------------------------------------------------------------
# the two routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    spark = SparkSession({"spark.sail.device": "cpu"})
    spark.createDataFrame(TABLE).createOrReplaceTempView("t")
    return spark


@pytest.fixture(scope="module")
def reference():
    # imported here: the card's tests below run without the reference
    from torch_tpch_common import reference_session
    return reference_session({"t": TABLE})


def _run(spark, sql: str, route: str) -> pa.Table:
    """``sql`` on the chain route or on the closures, checked to have
    taken it."""
    if route == "closures":
        with PerOp():
            got = spark.sql(sql).toArrow()
        want = {"per-op"}
    else:
        got = spark.sql(sql).toArrow()
        want = {"K16", "K17", "K18", "refs"}
    routes = [r["route"] for r in spark.last_chain_routes]
    assert routes and set(routes) <= want, routes
    return got


def _values(t: pa.Table) -> list:
    return t.column(0).to_pylist()


ROUTES = ["chain", "closures"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("width", sorted(_WIDTHS))
@pytest.mark.parametrize("source", ["f", "fl"])
def test_float_to_integer_as_spark(port, reference, source, width, route):
    """NaN 0, out of range saturated (BIGINT, INT); SMALLINT and TINYINT
    the INT's low bits. The reference gives Spark's BIGINT and INT, but
    saturates SMALLINT and TINYINT at their own limits (CAST(3e9 AS
    SMALLINT): 32767, Spark -1)."""
    sql = f"SELECT CAST({source} AS {width}) FROM t"
    values = _column("f") if source == "f" else _fl_values()
    got = _values(_run(port, sql, route))
    assert got == [_WIDTHS[width](v) for v in values]
    if width in ("BIGINT", "INT"):
        assert got == _values(reference.sql(sql).toArrow())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("p,s", [(12, 2), (10, 0), (18, 6), (5, 1)])
def test_float_to_decimal_as_spark(port, p, s, route):
    """NULL at NaN, +-inf and past p digits (1e30, 3e9 in DECIMAL(5,1)).
    Not held to the reference: it gives 0 for NaN and saturated unscaled
    values for the rest."""
    sql = f"SELECT CAST(f AS DECIMAL({p},{s})) FROM t"
    got = _values(_run(port, sql, route))
    assert got == [_to_decimal(v, p, s) for v in _column("f")]


# (expression, Spark's answer from the table, whether the reference gives
# it: a widening cast keeps every value)
DECIMAL_CASES = {
    "decimal_rounded_past_precision": (
        "CAST(m AS DECIMAL(5,1))",
        lambda: [_to_decimal(v, 5, 1) for v in _column("m")], False),
    "decimal_raised_past_precision": (
        "CAST(m AS DECIMAL(9,3))",
        lambda: [_to_decimal(v, 9, 3) for v in _column("m")], False),
    "int_past_precision": (
        "CAST(k * 10 AS DECIMAL(3,1))",
        lambda: [_to_decimal(Decimal(k * 10), 3, 1) for k in _column("k")],
        False),
    "literal_past_precision": (
        "CAST(99999999.99 AS DECIMAL(5,1))", lambda: [None] * N, False),
    "widening": (
        "CAST(m AS DECIMAL(20,4))",
        lambda: [_to_decimal(v, 20, 4) for v in _column("m")], True),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(DECIMAL_CASES))
def test_decimal_overflow_is_null(port, reference, case, route):
    """A decimal or an integer cast to a DECIMAL too narrow for it is
    NULL, as in Spark; the reference keeps the value (CAST(99999999.99 AS
    DECIMAL(5,1)) = 100000000.0 there). A widening cast checks nothing
    and equals the reference."""
    expr, spark_answer, reference_right = DECIMAL_CASES[case]
    sql = f"SELECT {expr} FROM t"
    got = _values(_run(port, sql, route))
    assert got == spark_answer()
    if reference_right:
        assert got == _values(reference.sql(sql).toArrow())


# IN over numbers with a NULL item: (expression, Spark's answer). The
# reference reads a NULL item as no match (FALSE where Spark gives NULL).
IN_LITERAL_CASES = {
    "int": ("k IN (1, NULL)", lambda: [_in(k, [1, None])
                                       for k in _column("k")]),
    "int_many": ("k IN (NULL, 3, 5, 7)", lambda: [
        _in(k, [None, 3, 5, 7]) for k in _column("k")]),
    "decimal": ("m IN (1.50, NULL)", lambda: [
        _in(v, [Decimal("1.50"), None]) for v in _column("m")]),
    "double": ("f IN (2.7, NULL, 300.0)", lambda: [
        _in(v, [2.7, None, 300.0]) for v in _column("f")]),
    # a decimal literal against a double column, and a double against a
    # decimal, compare as doubles: both packages compared the double with
    # the unscaled decimal (f IN (2.7) FALSE at 2.7)
    "double_decimal_items": ("f IN (2.7, 300.0)", lambda: [
        _in(v, [2.7, 300.0]) for v in _column("f")]),
    "decimal_double_item": ("m IN (1.5E0, 12.34)", lambda: [
        _in(v, [Decimal("1.5"), Decimal("12.34")]) for v in _column("m")]),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(IN_LITERAL_CASES))
def test_in_over_literals_as_spark(port, case, route):
    expr, spark_answer = IN_LITERAL_CASES[case]
    got = _values(_run(port, f"SELECT {expr} FROM t", route))
    assert got == spark_answer()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("expr,items", [
    ("k IN (1, n)", lambda k, n: [1, n]),
    ("k IN (n, 3, 5)", lambda k, n: [n, 3, 5]),
    ("k IN (r, n)", lambda k, n: None),
])
def test_in_with_a_null_column_item(port, expr, items, route):
    """An item's validity is read per row: NULL where it is NULL and no
    item matches. The reference gives FALSE there."""
    got = _values(_run(port, f"SELECT {expr} FROM t", route))
    ks, ns, rs = _column("k"), _column("n"), _column("r")
    want = []
    for k, n, r in zip(ks, ns, rs):
        its = items(k, n)
        want.append(_in(k, [r, n] if its is None else its))
    assert got == want


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("expr,items", [
    ("s IN ('a', NULL)", ["a", None]),
    ("s IN (NULL, 'b', 'd')", [None, "b", "d"]),
    ("s IN ('a', 'c')", ["a", "c"]),
])
def test_string_in_with_a_null(port, reference, expr, items, route):
    """Over a dictionary column: the membership table of the non-NULL
    items, NULL where the code is not a member and an item is NULL (the
    port raised on a NULL item). The reference gives Spark's answer."""
    sql = f"SELECT {expr} FROM t"
    got = _values(_run(port, sql, route))
    assert got == [_in(v, items) for v in _column("s")]
    assert got == _values(reference.sql(sql).toArrow())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("where,items", [
    ("k NOT IN (1, NULL)", [1, None]),
    ("s NOT IN ('a', NULL)", ["a", None]),
    ("k NOT IN (1, 2)", [1, 2]),
    ("NOT (k IN (1, n))", None),
])
def test_not_in_with_a_null_keeps_no_row(port, where, items, route):
    """WHERE x NOT IN (..., NULL) keeps no row (each is FALSE or NULL);
    the reference keeps the rows that match no item."""
    got = _values(_run(port, f"SELECT k FROM t WHERE {where}", route))
    col = "s" if where.startswith("s") else "k"
    want = [k for k, x, n in zip(_column("k"), _column(col), _column("n"))
            if _not(_in(x, [1, n] if items is None else items))]
    assert got == want
    if items is not None and None in items:
        assert got == []


@pytest.mark.parametrize("route", ROUTES)
def test_group_by_float_cast_keeps_spark_groups(port, route):
    """GROUP BY CAST(f AS BIGINT): NaN in group 0, +inf, 1e30 and 9.3e18
    in 2^63-1, -inf, -1e30 and -9.3e18 in -2^63. The reference merges
    them into one group (its grouping casts as the port's closure did),
    so this is held to Spark."""
    got = _run(port, "SELECT CAST(f AS BIGINT) AS g, count(*) AS c FROM t "
               "GROUP BY CAST(f AS BIGINT)", route)
    want = Counter(_java_long(v) for v in _column("f"))
    assert dict(zip(got.column(0).to_pylist(),
                    got.column(1).to_pylist())) == dict(want)


# ---------------------------------------------------------------------------
# card: the same queries on a CUDA session against Spark's answers
# ---------------------------------------------------------------------------

def _card_cases():
    cases = []
    for source in ("f", "fl"):
        values = _column("f") if source == "f" else _fl_values()
        for width, fn in sorted(_WIDTHS.items()):
            cases.append((f"CAST({source} AS {width})",
                          [fn(v) for v in values]))
    cases.append(("CAST(f AS DECIMAL(12,2))",
                  [_to_decimal(v, 12, 2) for v in _column("f")]))
    for expr, spark_answer, _ in DECIMAL_CASES.values():
        cases.append((expr, spark_answer()))
    for expr, spark_answer in IN_LITERAL_CASES.values():
        cases.append((expr, spark_answer()))
    cases.append(("k IN (1, n)", [_in(k, [1, n]) for k, n in
                                  zip(_column("k"), _column("n"))]))
    cases.append(("s IN ('a', NULL)", [_in(v, ["a", None])
                                       for v in _column("s")]))
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("expr,want", _card_cases(),
                         ids=[c[0] for c in _card_cases()])
def test_repairs_on_card(expr, want, route):
    """On the card the chain route is a generated kernel (F2I, F2I32,
    the decimal bound and IN's NULL in its source) and the closures are
    torch's CUDA ops: both give Spark's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spark = SparkSession({"spark.sail.device": "cuda"})
    spark.createDataFrame(TABLE).createOrReplaceTempView("t")
    assert _values(_run(spark, f"SELECT {expr} FROM t", route)) == want
