"""What the chain tests share: a table whose columns hold every physical
type a chain program reads (NULLs, NaN, -0.0, infinities, zero divisors
and decimal edge values planted), queries by expression kind, and helpers
that capture a query's bound chains. Imports no JAX: the card's tests use
it too."""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import pyarrow as pa
import torch

from sail_tpu_torch import SparkSession
from sail_tpu_torch.exec import local as xl
from sail_tpu_torch.ops import chain as ch

WORDS = ["AIR", "MAIL", "SHIP", "TRUCK", "REG AIR", "", "rail", "FOB"]
NUMBERS = ["12", "-7", "3.5", "x", " 42 ", "1e3", "0", "-0"]


def chain_table(n: int = 3000, seed: int = 7) -> pa.Table:
    """``n`` rows from ``seed`` (numpy): integers of each width, float32 and
    float64, decimal(15,2), date, timestamp, bool, and dictionary strings,
    each with NULLs."""
    rng = np.random.default_rng(seed)

    def mask(p=0.1):
        return rng.random(n) < p

    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    i32[::17] = 0  # zero divisors
    i64 = rng.integers(-10**12, 10**12, n)
    i64[1::19] = 0
    f64 = rng.normal(0, 100, n)
    f64[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.5]
    f64[8::23] = np.nan
    f64[9::29] = -0.0
    dec = rng.integers(-10**9, 10**9, n)
    dec[:6] = [0, 1, -1, 5, -5, 999_999_999_995]
    days = rng.integers(7300, 11000, n)  # 1989-2000
    days[:3] = [0, -1, 18262]
    us = days * 86_400_000_000 + rng.integers(0, 86_400_000_000, n)
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n).astype(np.int32)),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                       mask=mask()),
        "i16": pa.array(rng.integers(-30000, 30000, n).astype(np.int16)),
        "i32": pa.array(i32, mask=mask(0.05)),
        "i64": pa.array(i64, mask=mask()),
        "f32": pa.array(rng.normal(0, 10, n).astype(np.float32)),
        "f64": pa.array(f64, mask=mask()),
        "dec": pa.array([Decimal(int(v)).scaleb(-2) for v in dec],
                        type=pa.decimal128(15, 2), mask=mask()),
        "d": pa.array(days.astype(np.int32), type=pa.date32(),
                      mask=mask(0.05)),
        "ts": pa.array(us, type=pa.timestamp("us", tz="UTC")),
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "s": pa.array([WORDS[x] for x in rng.integers(0, len(WORDS), n)],
                      mask=mask()).dictionary_encode(),
        "num": pa.array([NUMBERS[x] for x in
                         rng.integers(0, len(NUMBERS), n)]).dictionary_encode(),
        "s2": pa.array([f"name#{x:03d}" for x in rng.integers(0, 300, n)]
                       ).dictionary_encode(),
    })


# one query an expression kind: each a Filter/Project chain of the kind's
# expressions over ``t`` (chain_table)
CHAIN_QUERIES = {
    "int_arith": "SELECT i32 + i32, i32 - 5, i32 * 3, i8 + i16, i64 * i64, "
                 "i16 * 1000, i64 - i32 FROM t WHERE i32 > -500",
    "float_arith": "SELECT f64 + 1.5, f64 * f64 - 2.0, f64 / 3.0, f32 + f32, "
                   "f32 * f64, f64 - i32 FROM t",
    "decimal": "SELECT dec + dec, dec - 1.25, dec * dec, dec * 3, dec + i32, "
               "dec * f64, CAST(dec AS DOUBLE), CAST(dec AS DECIMAL(15,4)), "
               "CAST(dec AS DECIMAL(10,0)), CAST(dec AS INT), dec > 1.005 "
               "FROM t",
    "division": "SELECT f64 / i32, dec / dec, i64 / i32, i64 % i64, "
                "pmod(i32, i32), f64 % 7.0, i64 div i64 FROM t",
    "compare": "SELECT i32 < i64, f64 >= 0, dec = 12.50, d > DATE "
               "'1995-01-01', f64 <> f64, i8 <=> i8, f32 < f64, b = true "
               "FROM t",
    "strings": "SELECT s = 'AIR', s < 'MAIL', s LIKE '%A%', upper(s), "
               "length(s), substring(s, 1, 2), concat(s, '-x'), s2 LIKE "
               "'%1%', s IN ('AIR', 'SHIP'), s = s2, CAST(num AS INT), "
               "s <=> 'FOB' FROM t WHERE s2 < 'name#200'",
    "logic": "SELECT b AND i32 > 0, b OR f64 < 0, NOT b, b IS NULL, "
             "i32 IS NOT NULL, b AND NULL, b OR NULL FROM t WHERE b OR "
             "i8 > 0",
    "case": "SELECT CASE WHEN i32 > 0 THEN 'pos' WHEN i32 < 0 THEN 'neg' "
            "END, CASE WHEN b THEN f64 ELSE i32 END, CASE i8 WHEN 1 THEN 10 "
            "WHEN 2 THEN 20 ELSE 0 END, coalesce(i8, i16, 0), if(b, i32, "
            "i64), nvl2(f64, 1, 0), nullif(i32, 0), greatest(i32, i32 * 2), "
            "least(f64, 1.0), coalesce(f64, 0.0) FROM t",
    "in": "SELECT i32 IN (1, 2, 3, 0), dec IN (1.25, 0.05, 0.0), f64 IN "
          "(1.0, 2.5), i8 IN (1, NULL) FROM t",
    "cast": "SELECT CAST(i32 AS BIGINT), CAST(i64 AS INT), CAST(f64 AS "
            "BIGINT), CAST(i32 AS DOUBLE), CAST(i8 AS BOOLEAN), CAST(b AS "
            "INT), CAST(f64 AS DECIMAL(15,3)), CAST(i16 AS DECIMAL(10,2)), "
            "CAST(f32 AS DOUBLE), CAST(i64 AS FLOAT) FROM t",
    "dates": "SELECT year(d), month(d), day(d), quarter(d), dayofweek(d), "
             "dayofyear(d), d + INTERVAL 3 MONTH, d - INTERVAL 10 DAY, "
             "date_add(d, 5), date_sub(d, 2), datediff(d, DATE "
             "'1995-06-01'), trunc(d, 'MM'), trunc(d, 'YEAR'), "
             "date_trunc('year', ts), hour(ts), minute(ts), second(ts), "
             "date_trunc('hour', ts), weekday(d) FROM t WHERE d >= DATE "
             "'1990-01-01'",
    "math": "SELECT sqrt(f64), ln(dec), exp(f64 / 100), power(f64, 2), "
            "round(dec, 1), bround(f64, 2), floor(f64), ceil(dec), abs(i32), "
            "i64 & 7, shiftright(i64, 3), atan2(f64, i32), hypot(f64, "
            "f64), log10(i32), sign(f64), isnan(f64), nanvl(f64, 0.0), "
            "cbrt(f64), round(i64, -2) FROM t",
    "calendar": "SELECT add_months(d, 2), last_day(d), weekofyear(d), "
                "months_between(d, DATE '1999-01-01'), add_months(d, i8) "
                "FROM t",
    "nested": "SELECT a + 1, s2 FROM (SELECT i32 * 2 AS a, s2, s FROM t "
              "WHERE f64 > 0) WHERE s LIKE '%A%' AND a < 1000",
    "literals": "SELECT 1, 'x', NULL, CAST(NULL AS INT) + i32, 2.5 FROM t "
                "WHERE true",
}


def session(device: str, table: pa.Table) -> SparkSession:
    spark = SparkSession({"spark.sail.device": device})
    spark.createDataFrame(table).createOrReplaceTempView("t")
    return spark


class Capture:
    """Records each K16 stage ``_apply_stage`` runs, each K17 stage
    ``_reduce_chain`` runs and each K18 stage ``_apply_sort_stage`` runs,
    with the batch below it, while active."""

    def __init__(self):
        self.k16 = []  # (stage, child)
        self.k17 = []  # (executor, aggregate, stage, child)
        self.k18 = []  # (stage, child, consumer)

    def __enter__(self):
        self._apply = xl.LocalExecutor._apply_stage
        self._reduce = xl.LocalExecutor._reduce_chain
        self._sort = xl.LocalExecutor._apply_sort_stage
        cap = self

        def apply(ex, stage, child, consumer):
            if stage.route == "K16":
                cap.k16.append((stage, child))
            return cap._apply(ex, stage, child, consumer)

        def reduce(ex, p, stage, child):
            cap.k17.append((ex, p, stage, child))
            return cap._reduce(ex, p, stage, child)

        def sort(ex, stage, child, consumer):
            cap.k18.append((stage, child, consumer))
            return cap._sort(ex, stage, child, consumer)

        xl.LocalExecutor._apply_stage = apply
        xl.LocalExecutor._reduce_chain = reduce
        xl.LocalExecutor._apply_sort_stage = sort
        return self

    def __exit__(self, *exc):
        xl.LocalExecutor._apply_stage = self._apply
        xl.LocalExecutor._reduce_chain = self._reduce
        xl.LocalExecutor._apply_sort_stage = self._sort


class PerOp:
    """While active, every chain binds to its closures (the route a chain
    takes where an expression has no fragment), bypassing the session's
    bound programs (and leaving no per-op binding in them)."""

    def __enter__(self):
        self._build = ch.build_program
        self._key = xl.LocalExecutor._stage_key

        def refuse(*args, **kwargs):
            raise ValueError("the per-op route, forced")

        ch.build_program = refuse
        xl.LocalExecutor._stage_key = lambda *args: None
        return self

    def __exit__(self, *exc):
        ch.build_program = self._build
        xl.LocalExecutor._stage_key = self._key


def same_cv(got, want, rows=None, exact=True, rtol=0.0) -> None:
    """(data, validity) pairs equal: the validity exactly, the data where
    valid (and in ``rows`` when given); floats NaN-aware, exactly or
    within ``rtol``."""
    (g, gv), (w, wv) = got, want
    n = g.shape[0] if g.dim() else w.shape[0]
    g, w = g.expand(n) if g.dim() == 0 else g, \
        w.expand(n) if w.dim() == 0 else w
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    assert (gv is None) == (wv is None), "validity present on one side"
    keep = torch.ones(n, dtype=torch.bool, device=g.device)
    if gv is not None:
        gv = gv.expand(n) if gv.dim() == 0 else gv
        wv = wv.expand(n) if wv.dim() == 0 else wv
        assert torch.equal(gv, wv), "validities differ"
        keep = keep & wv
    if rows is not None:
        keep = keep & rows
    g, w = g[keep], w[keep]
    if g.is_floating_point():
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), "NaN in other rows"
        g, w = g[~nan], w[~nan]
        if exact:
            assert torch.equal(g, w), \
                f"max diff {float((g - w).abs().max()) if g.numel() else 0}"
        else:
            assert bool(((g - w).abs() <= rtol * w.abs().clamp_min(1.0))
                        .all()), "beyond tolerance"
    else:
        assert torch.equal(g, w)


def ulps_close(g, w):
    """(data, validity) within 8 ulp where valid (NaN-aware)."""
    (gd, gv), (wd, wv) = g, w
    assert (gv is None) == (wv is None)
    keep = torch.ones_like(wd, dtype=torch.bool) if wv is None else wv
    if gv is not None:
        assert torch.equal(gv, wv)
    gd, wd = gd[keep], wd[keep]
    if not gd.is_floating_point():
        assert torch.equal(gd, wd)
        return
    assert torch.equal(torch.isnan(gd), torch.isnan(wd))
    fin = ~torch.isnan(wd)
    gd, wd = gd[fin], wd[fin]
    inf = torch.isinf(wd)
    assert torch.equal(gd[inf], wd[inf])
    ulp = torch.nextafter(wd.abs(), torch.full_like(wd, float("inf"))) - \
        wd.abs()
    assert bool(((gd - wd).abs()[~inf] <= 8 * ulp[~inf]).all())


# aggregates K17 takes (keyless or direct keys: dictionary codes and
# booleans), over chains of each kind
REDUCE_QUERIES = {
    "keyless": "SELECT count(*), count(i8), sum(i32), sum(i64), sum(f64), "
               "min(f64), max(f64), min(i16), max(dec), sum(dec), "
               "avg(f32), min(b), max(d) FROM t WHERE i32 > -800",
    "keyless_expr": "SELECT sum(i32 * 2 + 1), sum(f64 * (1 - f64)), "
                    "max(abs(i64)), min(sqrt(f64)), count(nullif(i32, 0)), "
                    "sum(CASE WHEN b THEN 1 ELSE 0 END) FROM t",
    "one_key": "SELECT s, count(*), sum(dec * 2), min(i8), max(i8), "
               "avg(f64), max(ts) FROM t GROUP BY s",
    "bool_key": "SELECT b, count(*), sum(i16), min(f32), max(f32) FROM t "
                "WHERE f64 > -50 GROUP BY b",
    "two_keys": "SELECT s, b, count(*), sum(i64), min(d), max(f64), "
                "sum(f64 / i32) FROM t GROUP BY s, b",
    "computed_key": "SELECT upper(s) AS u, i32 > 0 AS pos, count(*), "
                    "sum(i32) FROM t WHERE d > DATE '1992-01-01' GROUP BY "
                    "upper(s), i32 > 0",
    "all_dead": "SELECT s, count(*), sum(i32), min(f64) FROM t WHERE i32 > "
                "100000 GROUP BY s",
    "all_dead_keyless": "SELECT count(*), sum(i32), max(f64), min(dec) "
                        "FROM t WHERE i32 > 100000",
    "nan_extremes": "SELECT s, min(f64), max(f64), min(f64 * 0.0), "
                    "max(-f64) FROM t GROUP BY s",
}


# sorts and sorted groupings whose chain and keys K18 takes in, over ``t``
# (chain_table): keys of every physical type, both directions and NULL
# orders, computed keys, dictionary codes (a sort's through its rank
# table), a grouping's keys canonical
SORT_QUERIES = {
    "sort_columns": "SELECT i8, i16, i32, i64, f32, f64, dec, d, b, s, ts "
                    "FROM t WHERE i32 > -900 ORDER BY s DESC, f64, dec "
                    "NULLS LAST, i8, b DESC, f32 DESC NULLS FIRST, d, ts, "
                    "i16, i64",
    "sort_exprs": "SELECT i32, f64, d FROM t WHERE b OR i8 > 0 ORDER BY "
                  "round(sqrt(f64), 1) DESC, atan2(f64, i32), "
                  "add_months(d, 1), i32 * 2 + 1 NULLS LAST",
    "group_exprs": "SELECT i32 % 7, d, count(*), sum(i64), max(f64) FROM t "
                   "WHERE f64 > -100 GROUP BY i32 % 7, d",
    "group_codes": "SELECT s2, i8, b, min(dec), count(f32) FROM t WHERE "
                   "i32 > 0 GROUP BY s2, i8, b",
}
