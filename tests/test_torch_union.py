"""Parity of the port's UNION, OneRow, Values and Range with the JAX
reference, and the port's CAST(timestamp AS DATE) against Python's
datetime.

The same Arrow tables go to both sessions; answers compare as in
torch_window_common (exact but for float64; row order only under ORDER
BY). The timestamp cast is held against ``datetime``/``zoneinfo``, not
the reference, whose cast reads the microseconds as days (ROADMAP Queue
C).
"""

import datetime
import zoneinfo
from decimal import Decimal

import pyarrow as pa
import pytest

from sail_tpu_torch import SparkSession
from torch_tpch_common import has_order_by, port_session, reference_session
from torch_window_common import run_both


@pytest.fixture(scope="module")
def sessions():
    tables = {
        "ti": pa.table({"a": pa.array([1, 2], pa.int32())}),
        "tb": pa.table({"b": pa.array([2 ** 40, 7], pa.int64())}),
        "td": pa.table({"d": pa.array([Decimal("1.00"), Decimal("2.00")],
                                      pa.decimal128(10, 2))}),
        "tf": pa.table({"x": [0.5]}),
        "s1": pa.table({"s": ["a", "b", None, "c"], "k": [1, 2, 3, None],
                        "f": [1.5, None, -0.0, 2.0]}),
        "s2": pa.table({"s": ["c", "d", "a"], "k": [7, 8, 9],
                        "f": [0.25, 0.5, None]}),
    }
    return port_session(tables), reference_session(tables)


_CASES = {
    # tests/test_semantics_fixes.py's widening cases
    "int32_union_all_int64": "SELECT a FROM ti UNION ALL SELECT b FROM tb",
    "decimal_union_all_double": "SELECT d FROM td UNION ALL SELECT x FROM tf",
    "null_union_all_int": "SELECT NULL AS a UNION ALL SELECT 1 AS a",
    "int32_union_int64": "SELECT a FROM ti UNION SELECT b FROM tb",
    # string branches with different dictionaries, mixed validity
    "strings_union_all": "SELECT s, k, f FROM s1 UNION ALL "
                         "SELECT s, k, f FROM s2",
    "strings_union": "SELECT s FROM s1 UNION SELECT s FROM s2",
    "three_branches": "SELECT s, k FROM s1 UNION ALL SELECT s, k FROM s2 "
                      "UNION ALL SELECT 'e', 10",
    "intersect": "SELECT s FROM s1 INTERSECT SELECT s FROM s2",
    "except": "SELECT s FROM s1 EXCEPT SELECT s FROM s2",
    "union_under_aggregate": """
        SELECT s, count(*) AS c, sum(k) AS sk, max(f) AS mf
        FROM (SELECT s, k, f FROM s1 UNION ALL SELECT s, k, f FROM s2) u
        GROUP BY s ORDER BY s""",
    "union_under_join": """
        SELECT u.s, u.k, s2.k AS k2
        FROM (SELECT s, k FROM s1 UNION ALL SELECT s, k FROM s2) u
        JOIN s2 ON u.s = s2.s ORDER BY u.k""",
    "union_over_range": "SELECT id * 2 AS v FROM range(3) UNION ALL SELECT 1",
    # the leaves: VALUES with expressions, OneRow, Range
    "values_with_expressions": "SELECT * FROM VALUES (1 + 1), (2) AS x(a)",
    "values_with_nulls": "SELECT * FROM VALUES (1 + 1, 'a'), (2, NULL), "
                         "(NULL, 'c') AS x(a, b)",
    "values_decimals": "SELECT * FROM VALUES (1, 2.5), (3, 4.0) AS v(a, b)",
    "select_1": "SELECT 1",
    "select_expressions": "SELECT 1 + 1, 'x'",
    "select_interval": "SELECT INTERVAL '1' YEAR",
    "range_empty": "SELECT * FROM range(0)",
    "range_10": "SELECT * FROM range(10)",
    "range_descending": "SELECT * FROM range(5, 1, -2)",
    "scalar_subquery_over_range": "SELECT (SELECT max(id) FROM range(7)) AS m",
}


@pytest.mark.parametrize("case", list(_CASES))
def test_union_and_leaves_match_reference(sessions, case):
    sql = _CASES[case]
    single = not any(w in sql.upper() for w in ("UNION", "INTERSECT",
                                                "EXCEPT", "RANGE(",
                                                "VALUES"))
    run_both(*sessions, sql, ordered=has_order_by(sql) or single)


def test_union_of_string_and_int_needs_the_unported_cast(sessions):
    """'x' UNION ALL 1 widens to string: the port's compiler has no cast
    of a number to a string yet (ROADMAP Queue B item 2)."""
    port, _ = sessions
    with pytest.raises(NotImplementedError, match="cast to a string"):
        port.sql("SELECT 'x' AS a UNION ALL SELECT 1 AS a").toArrow()


# ---------------------------------------------------------------------------
# CAST(timestamp AS DATE): days = floor((µs + the zone's offset) / 86.4e9)
# ---------------------------------------------------------------------------

_INSTANTS = [
    "1969-12-31 23:59:59", "1970-01-01 00:00:00", "1900-03-01 12:00:00",
    "1965-06-30 00:00:01", "2020-01-02 03:04:05", "2020-01-02 00:00:00",
    "2020-01-01 23:59:59",
    # the 2013 DST changes in America/New_York (10 March, 3 November)
    "2013-03-10 01:59:59", "2013-03-10 03:00:00", "2013-03-10 04:30:00",
    "2013-11-03 00:59:59", "2013-11-03 01:30:00", "2013-11-03 04:59:59",
    "2013-11-03 05:00:00", "2013-11-04 04:59:59",
]


@pytest.mark.parametrize("zone", ["UTC", "America/New_York"])
def test_cast_timestamp_to_date(zone):
    """UTC instants as a timestamp column, cast in the session's zone,
    against the local calendar date that zoneinfo gives."""
    utc = [datetime.datetime.fromisoformat(s).replace(
        tzinfo=datetime.timezone.utc) for s in _INSTANTS]
    table = pa.table({"ts": pa.array(utc, pa.timestamp("us", tz="UTC"))})
    spark = SparkSession({"spark.sail.device": "cpu",
                          "spark.sql.session.timeZone": zone})
    spark.createDataFrame(table).createOrReplaceTempView("t")
    got = spark.sql("SELECT CAST(ts AS DATE) AS d FROM t").toArrow()
    want = [u.astimezone(zoneinfo.ZoneInfo(zone)).date() for u in utc]
    assert got.column("d").to_pylist() == want


def test_cast_timestamp_literal_to_date():
    spark = SparkSession({"spark.sail.device": "cpu"})
    got = spark.sql("SELECT CAST(TIMESTAMP '2020-01-02 03:04:05' AS DATE) "
                    "AS d, CAST(TIMESTAMP '1969-12-31 23:59:59' AS DATE) "
                    "AS e").toArrow()
    assert got.to_pylist() == [{"d": datetime.date(2020, 1, 2),
                                "e": datetime.date(1969, 12, 31)}]
