"""Parity of the port's window functions with the JAX reference, and the
window kernels on the card.

- SQL: the cases of tests/test_window.py, and more frame, string and
  rank shapes, through ``sql(q).toArrow()`` of both sessions on the same
  tables (the UDF case without its UDF: the port's session has no
  ``udf.register``), compared as in torch_window_common;
- card (``gpu``): K8-K11, and the gather of a column into sorted order
  that K10 and K11 read, against their plain versions at the kernels'
  edges (segments of one row, segments across many tiles, one segment;
  live counts 0, 1, n and one off a tile; K10's frames from forward and
  backward scans; K11 at widths 1, the halo and one past it, its float
  sums and averages among NaNs; every value type, with and without a
  validity), and the SQL cases on the card against the CPU session;
- SQL where the reference is wrong, held to Spark's answers: a decimal
  lag/lead default, and bounded float frames after a NaN or an infinity.

tests/test_torch_window_ops.py holds each function of ``ops/window.py``
against the reference's.
"""

from decimal import Decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.ops import window as twin
from sail_tpu_torch.spec import data_type as tdt
from torch_tpch_common import port_session, reference_session
from torch_window_common import (bounds_through_perm, close, identical,
                                 run_both)

# ---------------------------------------------------------------------------
# SQL: tests/test_window.py's cases through both packages
# ---------------------------------------------------------------------------


def _window_tables():
    rng = np.random.default_rng(5)
    n = 400
    t = pd.DataFrame({
        "g": rng.choice(["a", "b", "c"], n),
        "o": rng.permutation(n),
        "v": rng.integers(0, 100, n).astype(np.int64),
        "f": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n)),
    })
    rng9 = np.random.default_rng(9)
    bf = pd.DataFrame({"g": rng9.integers(0, 3, 150), "o": np.arange(150),
                       "v": rng9.normal(size=150).round(3)})
    frames = {
        "t": t, "bf": bf,
        "ties": pd.DataFrame({"g": ["x"] * 4, "o": [1, 1, 2, 2],
                              "v": [10, 20, 30, 40]}),
        "lv": pd.DataFrame({"g": ["a", "a", "b"], "v": [1, 2, 9]}),
        "sm": pd.DataFrame({"g": [1, 1, 2], "n": ["zebra", "apple", "kiwi"]}),
        "nz": pd.DataFrame({"x": [None, 0, 0, 5]}).astype({"x": "Int64"}),
        "ls": pd.DataFrame({"i": [1, 2], "s": ["a", "b"]}),
    }
    tables = {k: pa.Table.from_pandas(v, preserve_index=False)
              for k, v in frames.items()}
    tables["dq"] = pa.table({
        "i": [1, 2, 3, 4],
        "q": pa.array([Decimal("2.50"), Decimal("1.25"), None,
                       Decimal("7.00")], pa.decimal128(15, 2))})
    tables["nv"] = pa.table({"o": [1, 1, 2, 3, 4],
                             "v": [10, 20, 30, 40, 50]})
    tables["fl"] = pa.table({"i": [1, 2, 3, 4, 5],
                             "v": pa.array([None, 20, None, 40, 50],
                                           pa.int64())})
    tables["nf"] = pa.table({
        "g": [0, 0, 0, 0, 1, 1, 1, 1], "i": [1, 2, 3, 4, 1, 2, 3, 4],
        "f": [np.nan, 1.0, 2.0, 3.0, np.inf, 1.0, 2.0, -np.inf]})
    return tables


@pytest.fixture(scope="module")
def sessions():
    tables = _window_tables()
    return port_session(tables), reference_session(tables)


_SQL_CASES = {
    "test_row_number_rank": """
        SELECT g, o, row_number() OVER (PARTITION BY g ORDER BY o) AS rn,
               rank() OVER (PARTITION BY g ORDER BY v) AS rk,
               dense_rank() OVER (PARTITION BY g ORDER BY v) AS dr
        FROM t ORDER BY g, o""",
    "test_running_and_partition_aggregates": """
        SELECT g, o, sum(v) OVER (PARTITION BY g ORDER BY o) AS rsum,
               sum(v) OVER (PARTITION BY g) AS psum,
               count(*) OVER (PARTITION BY g ORDER BY o) AS rcnt,
               avg(v) OVER (PARTITION BY g ORDER BY o) AS ravg,
               min(v) OVER (PARTITION BY g ORDER BY o) AS rmin,
               max(v) OVER (PARTITION BY g ORDER BY o) AS rmax
        FROM t ORDER BY g, o""",
    "test_lag_lead": """
        SELECT g, o, lag(v) OVER (PARTITION BY g ORDER BY o) AS lg,
               lead(v, 2) OVER (PARTITION BY g ORDER BY o) AS ld,
               lag(v, 1, -1) OVER (PARTITION BY g ORDER BY o) AS lgd
        FROM t ORDER BY g, o""",
    "test_rows_between_frame": """
        SELECT g, o, sum(v) OVER (PARTITION BY g ORDER BY o
                                  ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING) ws
        FROM t ORDER BY g, o""",
    "test_ntile_percent_rank": """
        SELECT g, o, ntile(4) OVER (PARTITION BY g ORDER BY o) AS nt,
               percent_rank() OVER (PARTITION BY g ORDER BY o) AS pr,
               cume_dist() OVER (PARTITION BY g ORDER BY o) AS cd
        FROM t ORDER BY g, o""",
    "test_window_expression_arithmetic": """
        SELECT g, v, v - avg(v) OVER (PARTITION BY g) AS dev
        FROM t ORDER BY g, o""",
    "test_range_default_frame_with_ties": """
        SELECT o, sum(v) OVER (PARTITION BY g ORDER BY o) rs
        FROM ties ORDER BY o, rs""",
    "test_last_value_whole_partition": """
        SELECT g, last(v) OVER (PARTITION BY g) lv FROM lv ORDER BY g, v""",
    "test_string_min_max_window": """
        SELECT g, min(n) OVER (PARTITION BY g) mn,
               max(n) OVER (PARTITION BY g) mx FROM sm ORDER BY g, n""",
    "test_window_in_case_and_with_udf": """
        SELECT v, CASE WHEN row_number() OVER (ORDER BY o, g) = 1
                       THEN 'first' ELSE 'rest' END tag
        FROM t ORDER BY o, g LIMIT 2""",
    "test_null_order_keys_not_peers_of_zero": """
        SELECT x, rank() OVER (ORDER BY x) r, sum(x) OVER (ORDER BY x) rs
        FROM nz ORDER BY r, x""",
    "test_lag_string_default": """
        SELECT lag(s, 1, 'zz') OVER (ORDER BY i) p FROM ls ORDER BY i""",
    "test_window_inside_between": """
        SELECT o, row_number() OVER (ORDER BY o, g) BETWEEN 1 AND 2 AS top2
        FROM t ORDER BY o, g LIMIT 3""",
    "test_bounded_min_max_frames": """
        SELECT g, o,
               min(v) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) mn,
               max(v) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) mx
        FROM bf ORDER BY g, o""",
}


@pytest.mark.parametrize("case", list(_SQL_CASES))
def test_window_sql_matches_reference(sessions, case):
    got = run_both(*sessions, _SQL_CASES[case])
    assert got.num_rows > 0


_MORE_SQL = {
    # every frame shape of framed_agg over a float column, dead rows from
    # a filter, and a string order key (ranked through the dictionary)
    "frames": """
        SELECT g, o,
               min(f) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) mn,
               max(f) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 2 PRECEDING AND UNBOUNDED FOLLOWING) mx,
               min(v) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING) mv,
               avg(v) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 1 FOLLOWING AND 4 FOLLOWING) af,
               count(f) OVER (PARTITION BY g ORDER BY o
                              ROWS BETWEEN 5 PRECEDING AND 1 PRECEDING) cf,
               first(v) OVER (PARTITION BY g ORDER BY o) fv,
               last(v) OVER (PARTITION BY g ORDER BY o
                             ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) lv,
               nth_value(v, 3) OVER (PARTITION BY g ORDER BY o) nv,
               rank() OVER (ORDER BY g DESC) rg
        FROM t WHERE o % 7 <> 3 ORDER BY g, o""",
    # string MIN/MAX by value, lag string defaults inside and outside the
    # dictionary
    "strings": """
        SELECT o, min(g) OVER (PARTITION BY v % 5) smin,
               max(g) OVER (PARTITION BY v % 5 ORDER BY o) smax,
               lag(g, 1, 'zz') OVER (ORDER BY o) lz,
               lag(g, 2, 'a') OVER (PARTITION BY v % 3 ORDER BY o) la
        FROM t ORDER BY o""",
    # two ntile bucket counts beside the rest of the rank family on one
    # context, and a window with no keys at all
    "ranks": """
        SELECT g, o, ntile(3) OVER (PARTITION BY g ORDER BY v) n3,
               ntile(50) OVER (PARTITION BY g ORDER BY v) n50,
               dense_rank() OVER (PARTITION BY g ORDER BY v) dr,
               cume_dist() OVER (PARTITION BY g ORDER BY v) cd,
               count(*) OVER () total
        FROM t ORDER BY g, o""",
}


@pytest.mark.parametrize("case", list(_MORE_SQL))
def test_window_sql_more_shapes_match_reference(sessions, case):
    got = run_both(*sessions, _MORE_SQL[case])
    assert got.num_rows > 0


# Cases where the reference is wrong (ROADMAP Queue C), held to Spark's
# answers instead.
_SPARK_CASES = {
    # a numeric lag/lead default on a decimal column is a decimal value
    "decimal_default": ("""
        SELECT i, lag(q, 1, -1) OVER (ORDER BY i) lg,
               lead(q, 1, 2) OVER (ORDER BY i) ld
        FROM dq ORDER BY i""",
        [(1, Decimal("-1.00"), Decimal("1.25")),
         (2, Decimal("2.50"), None),
         (3, Decimal("1.25"), Decimal("7.00")),
         (4, None, Decimal("2.00"))]),
    # a bounded float frame sums its own rows: a NaN or an infinity
    # before it does not reach it
    "float_frames": ("""
        SELECT g, i,
               sum(f) OVER (PARTITION BY g ORDER BY i
                            ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) s1,
               avg(f) OVER (PARTITION BY g ORDER BY i
                            ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) a1,
               sum(f) OVER (PARTITION BY g ORDER BY i
                            ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING) s2,
               sum(f) OVER (PARTITION BY g ORDER BY i
                            ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) s3
        FROM nf ORDER BY g, i""",
        [(0, 1, np.nan, np.nan, 3.0, np.nan),
         (0, 2, np.nan, np.nan, 5.0, 6.0),
         (0, 3, 3.0, 1.5, 3.0, 5.0),
         (0, 4, 5.0, 2.5, None, 3.0),
         (1, 1, np.inf, np.inf, 3.0, np.nan),
         (1, 2, np.inf, np.inf, -np.inf, -np.inf),
         (1, 3, 3.0, 1.5, -np.inf, -np.inf),
         (1, 4, -np.inf, -np.inf, None, -np.inf)]),
    # nth_value counts from its frame's first row and ends at its last
    "nth_value_whole_frame": ("""
        SELECT o, v, nth_value(v, 2) OVER (ORDER BY o, v ROWS BETWEEN
            UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) nv
        FROM nv ORDER BY o, v""",
        [(1, 10, 20), (1, 20, 20), (2, 30, 20), (3, 40, 20), (4, 50, 20)]),
    "nth_value_sliding_frame": ("""
        SELECT o, v, nth_value(v, 2) OVER (ORDER BY o, v ROWS BETWEEN
            1 PRECEDING AND 1 FOLLOWING) nv
        FROM nv ORDER BY o, v""",
        [(1, 10, 20), (1, 20, 20), (2, 30, 30), (3, 40, 40), (4, 50, 50)]),
    "nth_value_frame_from_current_row": ("""
        SELECT o, v, nth_value(v, 2) OVER (ORDER BY o, v ROWS BETWEEN
            CURRENT ROW AND UNBOUNDED FOLLOWING) nv
        FROM nv ORDER BY o, v""",
        [(1, 10, 20), (1, 20, 30), (2, 30, 40), (3, 40, 50), (4, 50, None)]),
    # a ROWS frame ends at the current row, not at its last peer: of the
    # two rows tied on o = 1 the first sees one row (which of the two it
    # is, the sort decides)
    "nth_value_rows_frame_with_ties": ("""
        SELECT o, nth_value(v, 2) OVER (ORDER BY o ROWS BETWEEN
            UNBOUNDED PRECEDING AND CURRENT ROW) IS NULL missing
        FROM nv ORDER BY o, missing""",
        [(1, False), (1, True), (2, False), (3, False), (4, False)]),
    # first/last with ignoreNulls take the frame's first or last non-null
    "first_last_ignore_nulls": ("""
        SELECT i, first(v, true) OVER (ORDER BY i ROWS BETWEEN
                   UNBOUNDED PRECEDING AND CURRENT ROW) f,
               last(v, true) OVER (ORDER BY i ROWS BETWEEN
                   UNBOUNDED PRECEDING AND CURRENT ROW) l
        FROM fl ORDER BY i""",
        [(1, None, None), (2, 20, 20), (3, 20, 20), (4, 20, 40),
         (5, 20, 50)]),
}


def _same_rows(got, want) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(w) and all(
            (isinstance(x, float) and isinstance(y, float) and
             np.isnan(x) and np.isnan(y)) or x == y for x, y in zip(g, w))
        for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(_SPARK_CASES))
def test_window_sql_matches_spark_where_the_reference_does_not(sessions,
                                                               case):
    sql, want = _SPARK_CASES[case]
    port, ref = sessions
    rows = [tuple(r.values()) for r in port.sql(sql).toArrow().to_pylist()]
    assert _same_rows(rows, want), rows
    ref_rows = [tuple(r.values())
                for r in ref.sql(sql).toArrow().to_pylist()]
    assert not _same_rows(ref_rows, want)


def test_range_frame_with_value_offsets_raises(sessions):
    port, _ = sessions
    with pytest.raises(NotImplementedError, match="RANGE"):
        port.sql("SELECT sum(v) OVER (ORDER BY o RANGE BETWEEN 2 PRECEDING "
                 "AND CURRENT ROW) FROM t").toArrow()


# ---------------------------------------------------------------------------
# card: K8-K11 against their plain versions at the kernels' edges
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


_TILE = twin.TILE


def _card_context(cuda, n: int, n_live: int, segments: str, seed: int = 0):
    """A context on the card with exactly ``n_live`` live rows and
    segments of one row ("single"), a few spanning many tiles ("wide"),
    random sizes ("mixed") or none ("one"), and the same inputs on the
    card for the plain K8."""
    rng = np.random.default_rng(seed)
    sel = np.zeros(n, bool)
    sel[rng.choice(n, n_live, replace=False)] = True
    if segments == "single":
        part = [np.arange(n, dtype=np.int64)]
    elif segments == "wide":
        part = [rng.integers(0, 3, n).astype(np.int64)]
    elif segments == "mixed":
        part = [rng.integers(0, max(n // 50, 1), n).astype(np.int64),
                rng.choice([0.0, -0.0, np.nan, 2.0], n)]
    else:
        part = []
    pvalid = rng.random(n) < 0.9
    okey = rng.integers(0, 20, n).astype(np.int64)
    ovalid = rng.random(n) < 0.9
    parts = [TColumn(torch.from_numpy(p).to(cuda),
                     torch.from_numpy(pvalid).to(cuda) if j == 0 else None,
                     tdt.LongType() if p.dtype == np.int64
                     else tdt.DoubleType())
             for j, p in enumerate(part)]
    order = [(torch.from_numpy(okey).to(cuda),
              torch.from_numpy(ovalid).to(cuda), tdt.LongType(), True, None)]
    before = twin.window_bounds.launches
    ctx = twin.build_window_context(parts, order, torch.from_numpy(sel).to(cuda))
    assert twin.window_bounds.launches == before + 1
    return ctx, parts, order, rng


_EDGES = [  # (rows, live rows, segments)
    (5000, 5000, "single"), (200_000, 199_999, "wide"), (100_000, 100_000, "one"),
    (300_000, 150_000, "mixed"), (4096, 0, "mixed"), (4096, 1, "one"),
    (5000, _TILE - 1, "wide"), (5000, _TILE + 1, "one"),
    (3 * _TILE + 7, 2 * _TILE, "mixed"),
]


# K8's tile edges too (window_bounds.cu: 2048 positions a tile)
_BOUNDS_EDGES = _EDGES + [
    (5000, twin.BOUNDS_TILE - 1, "one"), (5000, twin.BOUNDS_TILE + 1, "wide"),
    (2 * twin.BOUNDS_TILE, 2 * twin.BOUNDS_TILE, "single"),
    (3 * twin.BOUNDS_TILE + 5, 3 * twin.BOUNDS_TILE + 5, "mixed"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_live,segments", _BOUNDS_EDGES)
def test_bounds_and_ranks_kernels_match_plain(cuda, n, n_live, segments):
    """K8 from both key sources (the packed word, where the keys fit; each
    key gathered into sorted order) against its plain version and the
    through-perm oracle, the pack pass against its plain version, and K9
    (records through inv_perm) at one and six outputs against its plain
    version."""
    ctx, parts, order, _ = _card_context(cuda, n, n_live, segments)
    from sail_tpu_torch.ops.sort import order_keys
    keys = [(order_keys(c.data), c.validity, True) for c in parts] + \
        [(order_keys(d, a), v, a if nf is None else nf)
         for d, v, _, a, nf in order]
    n_part = len(parts)
    oracle = bounds_through_perm(
        ctx.perm, ctx.n_live, [(k, v) for k, v, _ in keys[:n_part]],
        [(k, v) for k, v, _ in keys[n_part:]])
    sel = twin.window_inverse_plain(ctx.perm, ctx.n_live) >= 0
    layout = twin.pack_layout(keys, n_part)
    assert ctx.packed == (layout is not None)
    if layout is not None:
        assert torch.equal(twin.window_pack(keys, sel, layout),
                           twin.window_pack_plain(keys, sel, layout))
    for packed in [False] + ([True] if layout is not None else []):
        perm, words, was_packed, inv = twin.sort_window_keys(
            keys, n_part, sel, ctx.n_live, packed)
        assert was_packed == packed and torch.equal(perm, ctx.perm)
        assert packed or torch.equal(inv, twin.window_inverse_plain(
            perm, ctx.n_live))
        before = twin.window_bounds.launches
        got = twin.window_bounds(ctx.n_live, words)
        assert twin.window_bounds.launches == before + 1
        want = twin.window_bounds_plain(ctx.n_live, words)
        for g, w, o in zip(got, want, oracle):
            assert torch.equal(g, w) and torch.equal(g, o), packed
    for g, o in zip((ctx.seg_start, ctx.seg_end, ctx.peer_start,
                     ctx.peer_end, ctx.dense), oracle):
        assert torch.equal(g, o)
    for wanted in (twin._RANKS, ("ntile",)):
        before = twin.window_ranks.launches
        ranks = twin.window_ranks(ctx, wanted, 7)
        assert twin.window_ranks.launches == before + 1
        plain = twin.window_ranks_plain(ctx, wanted, 7)
        for name in wanted:
            assert torch.equal(ranks[name], plain[name]), name


def _card_values(cuda, rng, n, dtype, with_validity):
    if dtype in ("float32", "float64"):
        v = rng.normal(0, 1e3, n).astype(dtype)
        v[rng.random(n) < 0.01] = np.nan
    else:
        v = rng.integers(-1000, 1000, n).astype(dtype)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(cuda) \
        if with_validity else None
    return torch.from_numpy(v).to(cuda), valid




@pytest.mark.gpu
@pytest.mark.parametrize("n,n_live,segments", _EDGES)
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_scan_and_frame_kernels_match_plain(cuda, n, n_live, segments, dtype,
                                            with_validity):
    ctx, _, _, rng = _card_context(cuda, n, n_live, segments)
    vals, valid = _card_values(cuda, rng, n, dtype, with_validity)
    finite = torch.nan_to_num(vals, nan=0.0) if vals.is_floating_point() \
        else vals
    # the scans read sorted order: the values gathered once (window_gather)
    vals_s, valid_s = ctx.sorted_values(vals, valid)
    finite_s, _ = ctx.sorted_values(finite, None)
    for got, want in zip((vals_s, valid_s, finite_s),
                         twin.window_gather_plain(ctx.inv_perm, vals, valid)
                         + twin.window_gather_plain(ctx.inv_perm, finite,
                                                    None)[:1]):
        assert (got is None) == (want is None)
        assert got is None or identical(got, want)
    counts = twin.window_scan(ctx, None, valid_s, "count") \
        if valid is not None else None
    if counts is not None:
        assert torch.equal(counts, twin.window_scan_plain(ctx, None, valid_s,
                                                          "count"))
    for op, v in (("sum", finite_s), ("min", vals_s), ("max", vals_s)):
        for backward in (False, True):
            before = twin.window_scan.launches
            scan = twin.window_scan(ctx, v, valid_s, op, backward)
            assert twin.window_scan.launches == before + 1
            close(scan, twin.window_scan_plain(ctx, v, valid_s, op,
                                                backward),
                   finite if op == "sum" else None)
    sums = twin.window_scan(ctx, finite_s, valid_s, "sum")
    bsums = twin.window_scan(ctx, vals_s, valid_s, "sum", True)
    fwd = twin.window_scan(ctx, vals_s, valid_s, "min")
    bwd = twin.window_scan(ctx, vals_s, valid_s, "max", True)
    for lower, upper, peer in ((None, 0, ctx.peer_end), (None, 0, None),
                               (-6, 0, None), (None, None, None),
                               (2, 9, None), (-3, -5, None), (-4, None, None),
                               (3, None, None)):
        for fn, scan, backward in (("sum", sums, False), ("avg", sums, False),
                                   ("count", None, False),
                                   ("min", fwd, False), ("max", bwd, True),
                                   ("sum", bsums, True), ("avg", bsums, True)):
            if fn == "min" and lower is not None:
                continue  # a forward extreme needs the segment start
            if backward and upper is not None:
                continue  # a backward scan is read to the segment end
            got = twin.window_frame(ctx, scan, counts, fn, lower, upper,
                                    peer, backward)
            want = twin.window_frame_plain(ctx, scan, counts, fn, lower,
                                           upper, peer, backward)
            for g, w in zip(got, want):
                if w is not None:
                    assert identical(g, w), (fn, lower, upper)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_live,segments", _EDGES)
@pytest.mark.parametrize("width", [1, twin.NARROW_MAX, twin.NARROW_MAX + 1,
                                   5, 3000])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_extreme_kernel_matches_plain(cuda, n, n_live, segments, width,
                                      dtype, with_validity):
    ctx, _, _, rng = _card_context(cuda, n, n_live, segments)
    vals, valid = _card_values(cuda, rng, n, dtype, with_validity)
    counts = ctx.count_scan(valid)
    vals, valid = ctx.sorted_values(vals, valid)
    lower = -(width // 2)
    v64 = vals.double()
    for j, (lo, hi) in enumerate(((lower, lower + width - 1), (1, width),
                                  (-width - 2, -3))):
        fns = ["min", "max"]
        if vals.is_floating_point():  # float sums, NaN in 1% of the rows
            fns += ["sum", "avg"] if j == 0 else ["sum"]
        for fn in fns:
            v = v64 if fn in ("sum", "avg") else vals
            before = twin.window_extreme.launches
            got = twin.window_extreme(ctx, v, valid, counts, lo, hi, fn)
            assert twin.window_extreme.launches == before + 1
            want = twin.window_extreme_plain(ctx, v, valid, counts, lo, hi,
                                             fn)
            assert torch.equal(got[1], want[1]), (lo, hi)
            if fn in ("sum", "avg"):
                close(got[0], want[0], v)
            else:
                assert identical(got[0], want[0]), (lo, hi, fn)


@pytest.mark.gpu
def test_window_sql_on_the_card_matches_cpu(cuda, sessions):
    """The SQL cases on the card against the port's CPU session."""
    from sail_tpu_torch import SparkSession
    from torch_window_common import assert_window_result
    tables = _window_tables()
    card = SparkSession({"spark.sail.device": "cuda"})
    for name, table in tables.items():
        card.createDataFrame(table).createOrReplaceTempView(name)
    port, _ = sessions
    for sql in list(_SQL_CASES.values()) + list(_MORE_SQL.values()) + \
            [sql for sql, _ in _SPARK_CASES.values()]:
        assert_window_result(card.sql(sql).toArrow(), port.sql(sql).toArrow())
