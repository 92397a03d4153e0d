"""Host aggregates over the TPC-H tables: statistics, percentiles,
max_by/min_by, bit folds, exact sums and collections, grouped three ways.

What a report over TPC-H asks of the aggregates past SUM and COUNT:
correlations and regressions of price against quantity per line status
(H1, over K2's four bins, and keyless), each supplier's median price,
percentiles, extreme lines and checksums (H2, a sorted grouping of
100,000 suppliers at SF10), and each customer's orders as lists and
strings (H3, about a million customers). ``chip_smoke.py`` runs them on
the card at TPC-H SF10 (phase 16) and holds them at ``--check-sf`` to
``oracle``; ``tests/test_torch_host_aggs.py`` runs them on the CPU
against the reference.

``KERNELS`` names the kernels each query launches: K19 ``seg_moments``
(the statistics), K20 ``seg_pick`` (max_by, min_by, mode), K1's bit
kinds (``seg_reduce:<kind>``) and its sums (try_sum, try_avg: the runs
entry point in a sorted grouping), the pack pass of a sort of each
group's values (``window_pack``: the percentiles, mode, the ordered
listagg), and K2 for H1's bins.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import pyarrow as pa

QUERIES = {
    # the statistics over four bins (K2), and the bit folds there
    "h1": """
SELECT l_returnflag, l_linestatus, corr(l_quantity, l_extendedprice),
  covar_samp(l_quantity, l_discount), regr_slope(l_extendedprice, l_quantity),
  regr_r2(l_extendedprice, l_quantity), skewness(l_discount),
  kurtosis(l_tax), bit_and(l_partkey), bit_or(l_suppkey)
FROM lineitem GROUP BY 1, 2
""",
    # the same statistics keyless
    "h1k": """
SELECT corr(l_quantity, l_extendedprice),
  covar_samp(l_quantity, l_discount), regr_slope(l_extendedprice, l_quantity),
  regr_r2(l_extendedprice, l_quantity), skewness(l_discount),
  kurtosis(l_tax)
FROM lineitem
""",
    # a sorted grouping of 100,000 suppliers (SF10)
    "h2": """
SELECT l_suppkey, median(l_extendedprice), percentile_approx(l_quantity, 0.9),
  percentile_disc(0.25) WITHIN GROUP (ORDER BY l_discount),
  max_by(l_orderkey, l_extendedprice), min_by(l_partkey, l_discount),
  bit_xor(l_orderkey), try_sum(l_orderkey)
FROM lineitem GROUP BY l_suppkey
""",
    # collections at about a million customers (SF10)
    "h3": """
SELECT o_custkey, collect_list(o_orderkey), collect_set(o_orderstatus),
  string_agg(o_orderpriority, ','), mode(o_orderstatus),
  try_avg(o_totalprice),
  listagg(o_clerk, ',') WITHIN GROUP (ORDER BY o_orderdate)
FROM orders GROUP BY o_custkey
""",
}

_RANK = ("window_pack",)
KERNELS = {
    "h1": ("direct_group_ids", "seg_moments", "seg_reduce:and",
           "seg_reduce:or"),
    "h1k": ("seg_moments",),
    "h2": ("seg_pick", "seg_reduce_runs", "seg_reduce:xor") + _RANK,
    "h3": ("seg_pick", "seg_reduce_runs") + _RANK,
}

# each query's group keys and aggregates for the oracle: (HOST_AGGS name,
# argument columns, literal arguments after them)
SPECS = {
    "h1": (("l_returnflag", "l_linestatus"), (
        ("corr", ("l_quantity", "l_extendedprice"), ()),
        ("covar_samp", ("l_quantity", "l_discount"), ()),
        ("regr_slope", ("l_extendedprice", "l_quantity"), ()),
        ("regr_r2", ("l_extendedprice", "l_quantity"), ()),
        ("skewness", ("l_discount",), ()),
        ("kurtosis", ("l_tax",), ()),
        ("bit_and", ("l_partkey",), ()),
        ("bit_or", ("l_suppkey",), ()))),
    "h1k": ((), (
        ("corr", ("l_quantity", "l_extendedprice"), ()),
        ("covar_samp", ("l_quantity", "l_discount"), ()),
        ("regr_slope", ("l_extendedprice", "l_quantity"), ()),
        ("regr_r2", ("l_extendedprice", "l_quantity"), ()),
        ("skewness", ("l_discount",), ()),
        ("kurtosis", ("l_tax",), ()))),
    "h2": (("l_suppkey",), (
        ("median", ("l_extendedprice",), ()),
        ("percentile_approx", ("l_quantity",), (0.9,)),
        ("percentile_disc", ("l_discount",), (0.25, False)),
        ("max_by", ("l_orderkey", "l_extendedprice"), ()),
        ("min_by", ("l_partkey", "l_discount"), ()),
        ("bit_xor", ("l_orderkey",), ()),
        ("try_sum", ("l_orderkey",), ()))),
    "h3": (("o_custkey",), (
        ("collect_list", ("o_orderkey",), ()),
        ("collect_set", ("o_orderstatus",), ()),
        ("string_agg", ("o_orderpriority",), (",",)),
        ("mode", ("o_orderstatus",), ()),
        ("try_avg", ("o_totalprice",), ()),
        ("__listagg_ordered", ("o_clerk",), (",", "o_orderdate", False)))),
}
# the aggregates whose answer is a set, compared as one
SETS = ("collect_set",)
TABLE = {"h1": "lineitem", "h1k": "lineitem", "h2": "lineitem",
         "h3": "orders"}


def _values(col) -> np.ndarray:
    """A column's values as the reference's host aggregates see them, as a
    numpy array whose ``tolist`` gives them: a decimal as its float
    (unscaled / 10^s, which is float(Decimal) below 2^53), a date as its
    day number, a string as a Python ``str``. The TPC-H columns hold no
    NULL; a column of another type that holds one reads it as None."""
    arr = col.combine_chunks()
    if pa.types.is_decimal(arr.type):
        words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        unscaled = words[2 * arr.offset::2][: len(arr)]
        return unscaled / float(10 ** arr.type.scale)
    if pa.types.is_date(arr.type):
        return np.asarray(arr.view(pa.int32()))
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    if arr.null_count:
        return np.array(arr.to_pylist(), dtype=object)
    return arr.to_numpy(zero_copy_only=False)


# the forked workers' view of one oracle: (columns, aggregate specs, each
# group's row indices); set before the pool forks, read by ``_answers``
_WORK: tuple = ()


def _answers(task) -> list:
    """One aggregate's answers over a span of groups: the copied per-group
    function over each group's rows, in table order."""
    from ..functions.host_aggregates import HOST_AGGS

    cols, aggs, groups = _WORK
    a, lo, hi = task
    fn, args, lits = aggs[a]
    out = []
    for idx in groups[lo:hi]:
        fields = [cols[c][idx].tolist() for c in args]
        for lit in lits:
            fields.append(cols[lit][idx].tolist()
                          if isinstance(lit, str) and lit in cols
                          else [lit] * len(idx))
        rows = fields[0] if len(fields) == 1 else list(zip(*fields))
        out.append(HOST_AGGS[fn].impl(rows))
    return out


def _spans(groups: list, parts: int) -> list:
    """[lo, hi) spans of ``groups`` holding about equal rows, at most
    ``parts`` of them."""
    ends = np.cumsum([len(g) for g in groups])
    cuts = np.searchsorted(ends, ends[-1] * np.arange(1, parts) / parts,
                           side="right") if len(groups) else []
    bounds = sorted({0, len(groups), *(int(c) for c in cuts)})
    return list(zip(bounds[:-1], bounds[1:]))


def oracle(tables: Dict[str, pa.Table], name: str,
           processes: int = 1) -> dict:
    """{group key tuple: [each aggregate's answer]}: the copied module's
    per-group functions (``functions/host_aggregates.py`` ``HOST_AGGS``)
    over pandas groups of the query's table, rows in table order.
    ``processes`` > 1 spreads (aggregate, span of groups) tasks over that
    many forked workers, which touch no device; the answers are the same."""
    import pandas as pd

    global _WORK
    keys, aggs = SPECS[name]
    table = tables[TABLE[name]]
    cols = {c: _values(table.column(c))
            for c in set(keys) | {a for _, args, lits in aggs
                                  for a in args + lits
                                  if isinstance(a, str) and
                                  a in table.column_names}}
    if keys:
        frame = pd.DataFrame({k: cols[k] for k in keys})
        groups = frame.groupby(list(keys), sort=False).indices
    else:
        groups = {(): np.arange(table.num_rows)}
    names = [k if isinstance(k, tuple) else (k,) for k in groups]
    rows = [np.sort(idx) for idx in groups.values()]
    spans = _spans(rows, max(processes, 1))
    tasks = [(a, lo, hi) for a in range(len(aggs)) for lo, hi in spans]
    _WORK = (cols, aggs, rows)
    try:
        if processes > 1:
            import multiprocessing

            with multiprocessing.get_context("fork").Pool(processes) as pool:
                done = pool.map(_answers, tasks, chunksize=1)
        else:
            done = [_answers(t) for t in tasks]
    finally:
        _WORK = ()
    out = {key: [None] * len(aggs) for key in names}
    for (a, lo, _), answers in zip(tasks, done):
        for key, answer in zip(names[lo:], answers):
            out[key][a] = answer
    return out


def same_answer(fn: str, got, want, rtol: float) -> bool:
    """One aggregate's answer against the oracle's: a float within
    ``rtol`` of max(|want|, 1), a set as a set, anything else exactly."""
    if got is None or want is None:
        return got is None and want is None
    if fn in SETS:
        return sorted(got) == sorted(want)
    if isinstance(want, float):
        if math.isnan(want):
            return isinstance(got, float) and math.isnan(got)
        return abs(float(got) - want) <= rtol * max(abs(want), 1.0)
    if isinstance(got, float) or hasattr(got, "as_tuple"):  # a decimal
        return float(got) == float(want)
    return got == want


def check(result: pa.Table, want: dict, name: str, rtol: float) -> int:
    """Hold a query's answer to ``oracle``'s, group by group; returns the
    groups checked, raises on the first that differs."""
    keys, aggs = SPECS[name]
    nk = len(keys)
    rows = result.to_pylist()
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} groups, the oracle "
                             f"{len(want)}")
    for r in rows:
        vals = list(r.values())
        key = tuple(vals[:nk])
        if key not in want:
            raise AssertionError(f"{name}: group {key} not in the oracle")
        for (fn, _, _), g, w in zip(aggs, vals[nk:], want[key]):
            if not same_answer(fn, g, w, rtol):
                raise AssertionError(f"{name} group {key} {fn}: {g!r} != "
                                     f"{w!r}")
    return len(rows)
