"""ClickBench through the PyTorch port: the generator against the
reference's, Q1-Q22 against the JAX reference at generate_hits(200_000, 3)
(Q23-Q43 in test_torch_clickbench_q23_q43.py, so the reference's compile
time spreads over test workers), the answer comparison itself, and the
dictionary tables a steady query reuses.

Comparison rule: torch_clickbench_common.py.
"""

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import pyarrow as pa
import pytest

from sail_tpu.benchmarks import clickbench as jclickbench
from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks import clickbench
from torch_clickbench_common import check_query, hits_sessions

QUERIES = clickbench.load_queries()


@pytest.fixture(scope="module")
def both():
    return hits_sessions()


@pytest.mark.parametrize("n,seed", [(20_000, 3), (200_000, 3)])
def test_generator_matches_reference(n, seed):
    assert clickbench.generate_hits(n, seed).equals(
        jclickbench.generate_hits(n, seed))


def test_dictionary_table_decodes_to_the_plain_table():
    plain = clickbench.generate_hits(20_000, 5)
    encoded = clickbench.generate_hits(20_000, 5, dictionary=True)
    assert encoded.schema.names == plain.schema.names
    for name in plain.column_names:
        col = encoded.column(name)
        if pa.types.is_dictionary(col.type):
            dictionary = col.chunk(0).dictionary
            # one entry per value, so codes compare as the strings do
            assert len(dictionary) == len(dictionary.unique())
            col = col.cast(pa.string())
        assert col.equals(plain.column(name)), name


def test_queries_are_the_references():
    assert QUERIES == jclickbench.load_queries()
    assert len(QUERIES) == 43


@pytest.mark.parametrize("q", range(1, 23))
def test_query_matches_reference(both, q):
    check_query(*both, QUERIES[q - 1])


def test_steady_run_builds_no_dictionary_table():
    """Q21 (LIKE over URL), Q28 (length of URL) and Q26 (ORDER BY a
    string): the second run of each builds no table."""
    spark = SparkSession({"spark.sail.device": "cpu"})
    spark.createDataFrame(clickbench.generate_hits(20_000, 1)) \
        .createOrReplaceTempView("hits")
    for q in (21, 28, 26):
        first = spark.sql(QUERIES[q - 1]).toArrow()
        built = spark.dict_tables.builds
        assert built > 0
        assert spark.sql(QUERIES[q - 1]).toArrow().equals(first)
        assert spark.dict_tables.builds == built, q


@pytest.mark.parametrize("sql,want", [
    ("SELECT COUNT(*) FROM t WHERE b IN ('x', 'zzz')", 3),
    ("SELECT COUNT(*) FROM t WHERE b = 'x'", 2),
    ("SELECT COUNT(*) FROM t WHERE b > 'x'", 2),
    ("SELECT SUM(length(b)) FROM t", 7),
    ("SELECT COUNT(*) FROM t WHERE b LIKE 'z%'", 1),
])
def test_steady_run_over_binary_builds_no_dictionary_table(sql, want):
    """A binary column's tables are kept under its own dictionary, not
    under the text each compile decodes it to."""
    spark = SparkSession({"spark.sail.device": "cpu"})
    spark.createDataFrame(pa.table({"b": pa.array(
        [b"x", b"yy", None, b"x", b"zzz"], pa.binary())})) \
        .createOrReplaceTempView("t")
    assert spark.sql(sql).toArrow().column(0).to_pylist() == [want]
    built = spark.dict_tables.builds
    assert spark.sql(sql).toArrow().column(0).to_pylist() == [want]
    assert spark.dict_tables.builds == built


def _table(**cols):
    return pa.table({k: pa.array(v) for k, v in cols.items()})


_ORDERED = "SELECT k, v FROM t ORDER BY v DESC LIMIT 2"


@pytest.mark.parametrize("got,ok", [
    # the tie at v = 5 may keep either row, in either order
    (dict(k=["b", "a"], v=[5, 5]), True),
    (dict(k=["a", "c"], v=[5, 5]), True),
    # a row that is in no tie, or keys out of order
    (dict(k=["a", "z"], v=[5, 5]), False),
    (dict(k=["a", "a"], v=[5, 5]), False),
    (dict(k=["a", "d"], v=[5, 4]), False),
])
def test_answers_agree_on_ties_only(got, ok):
    full = _table(k=["a", "b", "c", "d"], v=[5, 5, 5, 4])
    want = _table(k=["a", "b"], v=[5, 5])
    if ok:
        clickbench.answers_agree(_table(**got), want, _ORDERED, full)
    else:
        with pytest.raises(AssertionError):
            clickbench.answers_agree(_table(**got), want, _ORDERED, full)


def test_order_key_columns():
    keys = clickbench.order_key_columns
    assert keys(QUERIES[15], ["UserID", "count(1)"]) == [1]   # COUNT(*)
    assert keys(QUERIES[42], ["M", "PageViews"]) == [0]       # expression
    assert keys(QUERIES[30], ["a", "b", "c", "d", "e"]) == [2]  # alias
    assert keys(QUERIES[24], ["SearchPhrase"]) is None         # not output
    assert keys(QUERIES[17], ["a", "b", "c"]) == []            # no ORDER BY
