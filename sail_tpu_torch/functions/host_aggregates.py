"""Host aggregates: the statistical and collection tail of the aggregates.

A copy of ``sail_tpu/functions/host_aggregates.py`` (regr_*, percentile,
mode, max_by/min_by, collect_*, listagg, bit aggregates, try_sum...):
``HOST_AGGS`` gives each aggregate's result type (``type_fn``). The port
groups and reduces these on the device by family (``exec/local.py``
``_host_agg``, ``ops/aggregate.py``); the per-group Python functions
here are the plain versions the tests hold those families to, and
``histogram_numeric`` alone runs its function per group over the
downloaded lists. Wire UDAFs (``register_wire_udaf`` and its cache) wait
for the slice that ports the UDF host callbacks.

Each impl receives the list of per-row argument values for ONE group
(multi-argument aggregates receive tuples) and returns a python value.
Nulls are pre-filtered per Spark semantics (any-null rows dropped for
multi-arg aggregates like corr/regr_*).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

from ..spec import data_type as dt


@dataclass(frozen=True)
class HostAgg:
    type_fn: Callable[[Sequence[dt.DataType]], dt.DataType]
    impl: Callable[[List], object]
    nargs: int = 1
    keep_nulls: bool = False


HOST_AGGS: Dict[str, HostAgg] = {}


def _reg(names, type_fn, impl, nargs=1, keep_nulls=False):
    if isinstance(names, str):
        names = [names]
    for n in names:
        HOST_AGGS[n] = HostAgg(type_fn, impl, nargs, keep_nulls)


def _t(out):
    return lambda ts: out


_D = dt.DoubleType()
_L = dt.LongType()
_S = dt.StringType()


# -- statistics ----------------------------------------------------------

def _corr(rows):
    if len(rows) < 2:
        return None
    ys = [float(a) for a, b in rows]
    xs = [float(b) for a, b in rows]
    n = len(rows)
    my, mx = sum(ys) / n, sum(xs) / n
    cov = sum((y - my) * (x - mx) for y, x in zip(ys, xs))
    vy = sum((y - my) ** 2 for y in ys)
    vx = sum((x - mx) ** 2 for x in xs)
    if vy == 0 or vx == 0:
        return None
    return cov / math.sqrt(vy * vx)


def _covar(rows, pop):
    n = len(rows)
    if n == 0 or (not pop and n < 2):
        return None
    ys = [float(a) for a, b in rows]
    xs = [float(b) for a, b in rows]
    my, mx = sum(ys) / n, sum(xs) / n
    cov = sum((y - my) * (x - mx) for y, x in zip(ys, xs))
    return cov / (n if pop else n - 1)


def _skew_kurt(vals, kurt):
    n = len(vals)
    if n == 0:
        return None
    xs = [float(v) for v in vals]
    m = sum(xs) / n
    m2 = sum((x - m) ** 2 for x in xs) / n
    if m2 == 0:
        return None
    if kurt:
        m4 = sum((x - m) ** 4 for x in xs) / n
        return m4 / (m2 ** 2) - 3.0
    m3 = sum((x - m) ** 3 for x in xs) / n
    return m3 / (m2 ** 1.5)


def _percentile(vals, p):
    xs = sorted(float(v) for v in vals)
    if not xs:
        return None
    if isinstance(p, (list, tuple)):
        return [_percentile(vals, q) for q in p]
    pos = (len(xs) - 1) * float(p)
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    if lo == hi:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _median(vals):
    return _percentile(vals, 0.5)


def _mode(vals):
    from collections import Counter
    vals = [v[0] if isinstance(v, tuple) else v for v in vals]
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    counts = Counter(vals)
    best = max(counts.values())
    return min(v for v, c in counts.items() if c == best)


def _regr(rows, what):
    """rows = [(y, x)] with nulls pre-filtered."""
    n = len(rows)
    if n == 0:
        return None if what != "count" else 0
    ys = [float(a) for a, b in rows]
    xs = [float(b) for a, b in rows]
    if what == "count":
        return n
    if what == "avgy":
        return sum(ys) / n
    if what == "avgx":
        return sum(xs) / n
    my, mx = sum(ys) / n, sum(xs) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    syy = sum((y - my) ** 2 for y in ys)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    if what == "sxx":
        return sxx
    if what == "syy":
        return syy
    if what == "sxy":
        return sxy
    if what == "slope":
        return None if sxx == 0 else sxy / sxx
    if what == "intercept":
        return None if sxx == 0 else my - (sxy / sxx) * mx
    if what == "r2":
        if sxx == 0:
            return None
        if syy == 0:
            return 1.0
        return (sxy * sxy) / (sxx * syy)
    return None


_reg("corr", _t(_D), _corr, nargs=2)
_reg("covar_samp", _t(_D), lambda r: _covar(r, False), nargs=2)
_reg("covar_pop", _t(_D), lambda r: _covar(r, True), nargs=2)
_reg("skewness", _t(_D), lambda v: _skew_kurt(v, False))
_reg("kurtosis", _t(_D), lambda v: _skew_kurt(v, True))
_INTERVALS = (dt.YearMonthIntervalType, dt.DayTimeIntervalType)


def _ptile_type(ts, exact_type=False):
    """percentile result type: double for numerics, the input type for
    intervals (and for the approx family, which returns observed values)."""
    base = ts[0] if (isinstance(ts[0], _INTERVALS) or exact_type) else _D
    if len(ts) > 1 and isinstance(ts[1], dt.ArrayType):
        return dt.ArrayType(base)
    return base


def _rank_percentile(vals, p):
    """approx_percentile: an observed value at the rank, no interpolation."""
    xs = sorted(vals)
    if not xs:
        return None
    if isinstance(p, (list, tuple)):
        return [_rank_percentile(vals, q) for q in p]
    return xs[int(math.floor(float(p) * (len(xs) - 1)))]


_reg("median", lambda ts: ts[0] if isinstance(ts[0], _INTERVALS) else _D,
     _median)
_reg(["percentile", "percentile_cont"],
     lambda ts: _ptile_type(ts),
     lambda rows: _percentile([r[0] for r in rows],
                              rows[0][1] if rows else 0.5),
     nargs=-1)
_reg(["percentile_approx", "approx_percentile"],
     lambda ts: _ptile_type(ts, exact_type=True),
     lambda rows: _rank_percentile([r[0] for r in rows],
                                   rows[0][1] if rows else 0.5),
     nargs=-1)
def _percentile_disc(rows):
    """Discrete percentile: first value whose cume_dist >= p in the
    requested order (the 1-p trick is NOT valid for the discrete form)."""
    if not rows:
        return None
    p = float(rows[0][1]) if rows[0][1] is not None else 0.5
    desc = bool(rows[0][2]) if len(rows[0]) > 2 else False
    xs = sorted(float(r[0]) for r in rows)
    n = len(xs)
    if desc:
        i = max(0, n - max(1, int(math.ceil(p * n))))
    else:
        i = min(max(1, int(math.ceil(p * n))) - 1, n - 1)
    return xs[i]


_reg("percentile_disc", lambda ts: _ptile_type(ts), _percentile_disc,
     nargs=-1)
_reg("mode", lambda ts: ts[0], _mode, nargs=-1)
_reg("max_by", lambda ts: ts[0],
     lambda rows: max(rows, key=lambda r: r[1])[0] if rows else None,
     nargs=2)
_reg("min_by", lambda ts: ts[0],
     lambda rows: min(rows, key=lambda r: r[1])[0] if rows else None,
     nargs=2)
_reg("product", _t(_D),
     lambda vals: math.prod(float(v) for v in vals) if vals else None)
for _w in ("count", "avgy", "avgx", "sxx", "syy", "sxy", "slope",
           "intercept", "r2"):
    _reg(f"regr_{_w}", _t(_L if _w == "count" else _D),
         (lambda w: lambda rows: _regr(rows, w))(_w), nargs=2)

# -- collections & strings ----------------------------------------------

_reg("collect_list", lambda ts: dt.ArrayType(ts[0]), lambda v: list(v))
_reg("collect_set", lambda ts: dt.ArrayType(ts[0]),
     lambda v: _stable_dedup(v))
_reg("array_agg", lambda ts: dt.ArrayType(ts[0]), lambda v: list(v))
_reg(["listagg", "string_agg"], _t(_S),
     lambda rows: (rows[0][1] if rows and len(rows[0]) > 1 and
                   rows[0][1] is not None else "").join(
         _to_str(r[0] if isinstance(r, tuple) else r) for r in rows)
     if rows else None, nargs=-1)
_reg("bit_and", lambda ts: ts[0],
     lambda vals: _bit_fold(vals, lambda a, b: a & b))
_reg("bit_or", lambda ts: ts[0],
     lambda vals: _bit_fold(vals, lambda a, b: a | b))
_reg("bit_xor", lambda ts: ts[0],
     lambda vals: _bit_fold(vals, lambda a, b: a ^ b))
_reg("histogram_numeric", lambda ts: dt.ArrayType(dt.StructType((
    dt.StructField("x", ts[0]), dt.StructField("y", _D)))),
    lambda rows: _histogram([r[0] for r in rows],
                            rows[0][1] if rows else 5), nargs=-1)
_reg("any_value", lambda ts: ts[0],
     lambda vals: vals[0] if vals else None)
_reg("__mode_ordered", lambda ts: ts[0], lambda rows: _mode_ordered(rows),
     nargs=-1)
_reg("__listagg_ordered", _t(_S), lambda rows: _listagg_ordered(rows),
     nargs=-1)


def _mode_ordered(rows):
    """mode() WITHIN GROUP (ORDER BY col [DESC]): rows = [(val, desc)]."""
    from collections import Counter
    vals = [r[0] for r in rows if r[0] is not None]
    if not vals:
        return None
    desc = bool(rows[0][1])
    counts = Counter(vals)
    best = max(counts.values())
    tied = [v for v, c in counts.items() if c == best]
    return max(tied) if desc else min(tied)


def _listagg_ordered(rows):
    """listagg(col[, delim]) WITHIN GROUP (ORDER BY o [DESC]):
    rows = [(val, delim, order_key, desc)]."""
    keep = [r for r in rows if r[0] is not None]
    if not keep:
        return None
    desc = bool(keep[0][3])
    # Spark null ordering: nulls first ascending, last descending
    keep.sort(key=lambda r: (r[2] is not None,
                             r[2] if r[2] is not None else 0),
              reverse=desc)
    delim = keep[0][1] or ""
    return delim.join(_to_str(r[0]) for r in keep)
# count_min_sketch lives in sketches.py (Spark-exact serialization)


def _try_sum(vals):
    """Exact python sum; NULL when the result overflows int64 (the device
    sum wraps, which plain sum() keeps for speed — try_sum must not)."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    total = sum(vals)
    if isinstance(total, int) and not (-(2**63) <= total < 2**63):
        return None
    return total


def _try_avg(vals):
    # Year-month intervals route through _try_avg_ym, which owns the
    # int32 overflow rule; plain numeric averages never overflow to NULL.
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return sum(vals) / len(vals)


_reg("try_sum", lambda ts: ts[0], _try_sum)
_reg("try_avg", _t(_D), _try_avg)


def _try_avg_ym(vals):
    """Year-month interval average: the month SUM must fit int32 (Spark's
    interval arithmetic overflows there first)."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    total = sum(vals)
    if not (-(2**31) <= total < 2**31):
        return None
    return total / len(vals)


_reg("try_avg_ym", lambda ts: ts[0], _try_avg_ym)


def _stable_dedup(vals):
    out = []
    for v in vals:
        if v not in out:
            out.append(v)
    return out


def _to_str(v):
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    return str(v)


def _bit_fold(vals, op):
    out = None
    for v in vals:
        out = int(v) if out is None else op(out, int(v))
    return out


def _histogram(vals, nbins):
    from collections import Counter
    if not vals:
        return None
    ints = all(isinstance(v, int) for v in vals)
    xs = sorted(float(v) for v in vals)
    nb = int(nbins)
    counts = Counter(xs)
    pts = [[x, float(c)] for x, c in sorted(counts.items())]
    while len(pts) > nb:
        # merge the two closest centroids
        gaps = [(pts[i + 1][0] - pts[i][0], i) for i in range(len(pts) - 1)]
        _, i = min(gaps)
        a, b = pts[i], pts[i + 1]
        total = a[1] + b[1]
        pts[i] = [(a[0] * a[1] + b[0] * b[1]) / total, total]
        del pts[i + 1]
    # Spark keeps x in the INPUT type: int inputs show integral centroids
    return [{"x": int(x) if ints else x, "y": y} for x, y in pts]
