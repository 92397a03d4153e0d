"""Analytical SQL over the TPC-H tables that leans on the compiler's math,
rounding, bitwise and calendar functions.

The kinds of expressions a Spark engine's users send to it in reports:
standard deviations and rounded money, per-row math summed over every
row, bucketing by floor and ceil with bitwise keys, fiscal calendars,
date arithmetic, and NaN and NULL handling after an outer join.
``chip_smoke.py`` runs them on the card at TPC-H SF10 (phases 12 and 13)
and ``tests/test_torch_expr_queries.py`` on the CPU against a pandas
oracle in Spark's semantics and the reference.

``KERNELS`` names the kernels each query's expressions launch. A
Filter/Project chain runs as one program (K16 ``chain``; with a keyless
or direct aggregate above it, K17 ``chain_reduce``; with the sort or
sorted grouping above it, K18 ``chain_sort``, which also writes the sort
keys' words, packed into one word a row where they fit in 63 bits,
``window_pack``), which computes the math inside it, so no query launches
K12-K15 (``functions/numeric.py``): E7's sort keys, its rounded roots,
angles and next month's dates, run in its K18 program too.
"""

QUERIES = {
    # stddev (the resolver's sqrt of the variance), round and bround
    "e1": """
SELECT l_returnflag, l_linestatus,
  round(stddev_samp(l_extendedprice), 2) AS sd_price,
  round(stddev(l_quantity), 4) AS sd_qty,
  bround(avg(l_discount), 3) AS avg_disc,
  round(sum(l_extendedprice * (1 - l_discount)), -2) AS rev_100,
  round(sum(l_tax), 1) AS tax
FROM lineitem
WHERE l_shipdate <= date '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
""",
    # per-row math over every row, then keyless sums
    "e2": """
SELECT sum(sqrt(l_extendedprice)), sum(ln(l_quantity)),
  sum(exp(-l_discount)), sum(power(l_tax, 2)),
  max(abs(l_extendedprice - 50000)), sum(log10(l_extendedprice)),
  sum(sin(l_orderkey)), sum(tanh(l_discount)), sum(rint(l_quantity / 7))
FROM lineitem
WHERE l_quantity > 1
""",
    # bucketing
    "e3": """
SELECT floor(l_extendedprice / 1000) AS bucket, ceil(l_discount * 10) AS d10,
  count(*), sum(l_orderkey & 7), max(shiftright(l_orderkey, 4)),
  sum(l_linenumber | 8), sum(l_suppkey ^ l_partkey)
FROM lineitem
GROUP BY floor(l_extendedprice / 1000), ceil(l_discount * 10)
ORDER BY bucket, d10
LIMIT 100
""",
    # the calendar over orders
    "e4": """
SELECT year(add_months(o_orderdate, 3)) AS fy, weekofyear(o_orderdate) AS wk,
  count(*),
  round(avg(months_between(date '1999-01-01', o_orderdate)), 2),
  max(last_day(o_orderdate))
FROM orders
GROUP BY year(add_months(o_orderdate, 3)), weekofyear(o_orderdate)
ORDER BY fy, wk
""",
    # date arithmetic over lineitem
    "e5": """
SELECT l_shipmode, avg(datediff(l_receiptdate, l_shipdate)),
  sum(CASE WHEN datediff(l_receiptdate, l_commitdate) > 0 THEN 1 ELSE 0 END),
  min(date_add(l_shipdate, 30)), max(date_sub(l_commitdate, 7)),
  max(add_months(l_shipdate, 1))
FROM lineitem
GROUP BY l_shipmode
ORDER BY l_shipmode
""",
    # NULLs from an outer join, NaN from negative balances
    "e6": """
SELECT c_mktsegment, sum(nvl2(o_orderkey, 1, 0)),
  avg(nanvl(sqrt(c_acctbal), 0.0)), sum(signum(c_acctbal)),
  max(atan2(c_acctbal, c_custkey)), avg(hypot(c_acctbal, c_nationkey)),
  avg(cbrt(c_acctbal)),
  sum(CASE WHEN isnan(sqrt(c_acctbal)) THEN 1 ELSE 0 END)
FROM customer LEFT JOIN orders
  ON c_custkey = o_custkey AND o_orderdate >= date '1998-01-01'
GROUP BY c_mktsegment
ORDER BY c_mktsegment
""",
    # report ordering: rounded roots, angles and next month's dates as sort
    # keys, compiled over the sort's input
    "e7": """
SELECT o_orderkey, o_totalprice, o_orderdate
FROM orders
WHERE o_orderstatus = 'F'
ORDER BY round(sqrt(o_totalprice), 1) DESC, atan2(o_totalprice, o_orderkey),
  add_months(o_orderdate, 1), o_orderkey
LIMIT 20
""",
}

KERNELS = {
    "e1": ("chain_reduce", "chain_sort", "window_pack"),
    "e2": ("chain_reduce",),
    "e3": ("chain_sort", "window_pack", "seg_reduce_runs"),
    "e4": ("chain_sort", "window_pack", "seg_reduce_runs"),
    "e5": ("chain_reduce", "chain_sort", "window_pack"),
    "e6": ("chain_reduce", "chain_sort", "window_pack"),
    # its four keys in the chain's kernel (K18, no K12-K15 launch); two
    # float64 keys take more than 63 bits, so it sorts by the passes
    "e7": ("chain_sort",),
}
