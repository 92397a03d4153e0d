"""The aggregate tail of ClickBench through the PyTorch port against the
JAX reference: string MIN/MAX, DISTINCT aggregates beside others, the
time fields and truncation, bool_and/bool_or.

The suite's own queries that use these return no rows at any test size
(test_torch_clickbench*.py), so here they run in queries that do: over
generate_hits(200_000, 3) (``clickbench.MECHANISM_QUERIES``), over a small
hand-made table with null values, null keys, an all-null group and
string ties, and over timestamps that cross the 2013 daylight-saving
changes, in UTC and in America/New_York (there held to Python's
``zoneinfo``: the reference places each zone change hours off, ROADMAP
Queue C). The tests marked ``gpu`` hold
the port on the card to its CPU session over the hand-made table (the
mechanism queries run on the card in chip_smoke.py's ClickBench check).

Comparison rule: torch_clickbench_common.py.
"""

import datetime
import zoneinfo

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import pyarrow as pa
import pytest
import torch

from sail_tpu.exec import local as jlocal
from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks import clickbench
from torch_clickbench_common import check_query, hits_sessions, sessions

_TZS = ("UTC", "America/New_York")


@pytest.fixture(scope="module")
def both():
    return hits_sessions()


@pytest.mark.parametrize("name", sorted(clickbench.MECHANISM_QUERIES))
def test_mechanism_query_matches_reference(both, name):
    sql = clickbench.MECHANISM_QUERIES[name]
    port, ref = both
    assert ref.sql(sql).toArrow().num_rows > 0  # it shows the mechanism
    check_query(port, ref, sql)


@pytest.fixture(scope="module")
def hits_new_york():
    # the reference keeps its compiled operators process-wide, keyed
    # without the session time zone: start and leave them empty
    jlocal.clear_caches()
    yield sessions(clickbench.generate_hits(20_000, 3), "America/New_York")
    jlocal.clear_caches()


@pytest.mark.parametrize("name", ["time_of_day", "q43_all_counters"])
def test_time_mechanism_in_new_york(hits_new_york, name):
    check_query(*hits_new_york, clickbench.MECHANISM_QUERIES[name])


# a small table: null keys (g, k), null values, an all-null group (g = 2),
# string ties and the empty string, -0.0 beside 0.0
_NULLS = pa.table({
    "g": pa.array([1, 1, 1, 1, 2, 2, 2, None, None, 3, 3, 4, 4, 4],
                  type=pa.int64()),
    "k": pa.array(["a", "a", "b", "b", None, None, "c", "c", None, "a", "b",
                   "c", "c", "a"]),
    "v": pa.array([5, 5, None, 7, None, None, None, 1, 1, 2, 3, -4, -4, 9],
                  type=pa.int64()),
    "s": pa.array(["pear", "apple", None, "apple", None, None, None, "",
                   "b", "zz", "zz", "apple", "Apple", None]),
    "f": pa.array([0.0, -0.0, 1.5, None, None, None, None, 2.5, 2.5, -0.0,
                   0.0, 1.5, 3.25, None]),
    "b": pa.array([True, False, None, True, None, None, None, True, True,
                   False, False, True, None, True]),
})

_AGGS = ("COUNT(DISTINCT v), SUM(DISTINCT v), AVG(DISTINCT v), COUNT(v), "
         "COUNT(*), MIN(s), MAX(s), COUNT(DISTINCT s), COUNT(DISTINCT f), "
         "SUM(DISTINCT f), bool_and(b), bool_or(b)")


@pytest.fixture(scope="module")
def nulls():
    return sessions(_NULLS)


@pytest.mark.parametrize("sql", [
    # sort-based grouping (an integer key, with nulls)
    f"SELECT g, {_AGGS} FROM hits GROUP BY g ORDER BY g",
    # direct grouping (a string key, with nulls)
    f"SELECT k, {_AGGS} FROM hits GROUP BY k ORDER BY k",
    # both keys
    f"SELECT g, k, {_AGGS} FROM hits GROUP BY g, k ORDER BY g, k",
    # keyless
    f"SELECT {_AGGS} FROM hits",
    f"SELECT {_AGGS} FROM hits WHERE g = 2",
    # DISTINCT of a string and MIN/MAX of strings under a filter
    "SELECT g, MIN(s), MAX(s), COUNT(DISTINCT s), COUNT(*) FROM hits "
    "WHERE s <> 'pear' GROUP BY g ORDER BY g",
    "SELECT k, MAX(s), MIN(s), COUNT(DISTINCT k) FROM hits WHERE s >= 'apple' "
    "GROUP BY k ORDER BY k",
])
def test_aggregates_with_nulls_match_reference(nulls, sql):
    check_query(*nulls, sql)


def _us(*args) -> int:
    t = datetime.datetime(*args, tzinfo=datetime.timezone.utc)
    return int(t.timestamp() * 1_000_000)


# UTC instants around New York's 2013 changes (03-10 07:00 UTC, clocks
# forward; 11-03 06:00 UTC, clocks back), a year end, a leap day and a
# Monday, with a null; and dates
_INSTANTS = [_us(2013, 3, 10, 6, 59, 59), _us(2013, 3, 10, 7, 0, 1),
             _us(2013, 3, 10, 7, 30, 0), _us(2013, 11, 3, 5, 30, 15),
             _us(2013, 11, 3, 6, 30, 45), _us(2013, 11, 3, 7, 1, 2),
             _us(2013, 12, 31, 23, 59, 59) + 999_999,
             _us(2012, 2, 29, 12, 0, 0) + 123_456, _us(2013, 7, 15, 0, 0, 0),
             _us(1969, 12, 31, 23, 59, 59), None]
_TIMES = pa.table({
    "ts": pa.array(_INSTANTS, type=pa.timestamp("us", tz="UTC")),
    "d": pa.array([None if t is None else t // 86_400_000_000
                   for t in _INSTANTS], type=pa.int32()).cast(pa.date32()),
})
_TIME_EXPRS = (
    ["hour(ts)", "minute(ts)", "second(ts)",
     "minute(CAST(CAST(ts AS TIMESTAMP_NTZ) AS TIMESTAMP))"]
    + [f"date_trunc('{u}', ts)" for u in
       ("year", "yyyy", "yy", "quarter", "month", "mon", "mm", "week", "day",
        "dd", "hour", "minute", "second", "millisecond", "microsecond")]
    + [f"trunc(d, '{u}')" for u in
       ("year", "yyyy", "yy", "quarter", "month", "mon", "mm", "week")])


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_MIDNIGHT = dict(hour=0, minute=0, second=0, microsecond=0)


def _zone_value(expr: str, local: datetime.datetime):
    """``expr`` of the instant whose local time is ``local`` (a datetime
    in the zone, from ``astimezone``): a field, or date_trunc's local
    truncation as UTC microseconds. ``replace`` keeps ``fold``, so a
    truncation in the repeated hour keeps the instant's own offset."""
    if expr.startswith(("minute(", "hour(", "second(")):
        return getattr(local, expr.split("(")[0])
    unit = expr.split("'")[1]
    if unit in ("year", "yyyy", "yy"):
        t = local.replace(month=1, day=1, **_MIDNIGHT)
    elif unit == "quarter":
        t = local.replace(month=(local.month - 1) // 3 * 3 + 1, day=1,
                          **_MIDNIGHT)
    elif unit in ("month", "mon", "mm"):
        t = local.replace(day=1, **_MIDNIGHT)
    elif unit == "week":
        t = (local - datetime.timedelta(days=local.weekday())).replace(
            **_MIDNIGHT)
    elif unit in ("day", "dd"):
        t = local.replace(**_MIDNIGHT)
    elif unit == "hour":
        t = local.replace(minute=0, second=0, microsecond=0)
    elif unit == "minute":
        t = local.replace(second=0, microsecond=0)
    elif unit == "second":
        t = local.replace(microsecond=0)
    elif unit == "millisecond":
        t = local.replace(microsecond=local.microsecond // 1000 * 1000)
    else:
        t = local
    return (t - _EPOCH) // datetime.timedelta(microseconds=1)


def _zone_answers(want: pa.Table, zone: str) -> pa.Table:
    """``want`` with the column of every expression of ``ts`` replaced by
    Python's answer in ``zone``; trunc(d, ...) reads no zone."""
    z = zoneinfo.ZoneInfo(zone)
    local = [None if u is None else
             (_EPOCH + datetime.timedelta(microseconds=u)).astimezone(z)
             for u in _INSTANTS]
    for i, expr in enumerate(_TIME_EXPRS):
        if expr.startswith("trunc("):
            continue
        field = want.field(i + 1)
        want = want.set_column(i + 1, field, pa.array(
            [None if t is None else _zone_value(expr, t) for t in local],
            type=field.type))
    return want


@pytest.fixture(scope="module", params=_TZS)
def time_answers(request):
    """The port's answers to one query of every time expression, in one
    zone (one compile each), and what they are held to: the reference's
    in UTC, Python's in America/New_York."""
    jlocal.clear_caches()  # as in hits_new_york
    port, ref = sessions(_TIMES, request.param)
    sql = "SELECT ts, " + ", ".join(
        f"{e} AS e{i}" for i, e in enumerate(_TIME_EXPRS)) + " FROM hits"
    got, want = port.sql(sql).toArrow(), ref.sql(sql).toArrow()
    jlocal.clear_caches()
    if request.param != "UTC":
        want = _zone_answers(want, request.param)
    return got, want


@pytest.mark.parametrize("i", range(len(_TIME_EXPRS)), ids=_TIME_EXPRS)
def test_time_functions_match_reference(time_answers, i):
    got, want = (t.select([0, i + 1]) for t in time_answers)
    clickbench.answers_agree(got, want, "SELECT ts, e FROM hits")


# ---------------------------------------------------------------------------
# the port on the card against its CPU session
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_and_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pair = []
    for device in ("cuda", "cpu"):
        spark = SparkSession({"spark.sail.device": device})
        spark.createDataFrame(_NULLS).createOrReplaceTempView("hits")
        pair.append(spark)
    return pair


@pytest.mark.gpu
@pytest.mark.parametrize("grouping", ["g", "k", "g, k", None])
def test_aggregates_with_nulls_on_the_card_match_cpu(card_and_cpu, grouping):
    sql = f"SELECT {_AGGS} FROM hits" if grouping is None else \
        f"SELECT {grouping}, {_AGGS} FROM hits GROUP BY {grouping} " \
        f"ORDER BY {grouping}"
    card, cpu = card_and_cpu
    clickbench.check_answer(card.sql(sql).toArrow(), cpu, sql)
