"""Every join type of the port's executor against the JAX reference, on
small seeded tables with NULL, duplicate, NaN and -0.0 keys: LEFT, RIGHT
and FULL OUTER (with and without a residual condition), semi and anti
joins, NOT IN with and without NULLs, string and multi-column keys, and
cross joins. Rows compare as sets (torch_tpch_common.py's rule)."""

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import numpy as np
import pyarrow as pa
import pytest

from sail_tpu_torch.exec import local as tlocal
from sail_tpu_torch.ops import join as tjoin
from torch_tpch_common import (assert_same_result, port_session,
                               reference_session)


def _tables():
    rng = np.random.default_rng(31)

    def nulls(n, p=0.15):
        return rng.random(n) < p

    n1, n2 = 60, 40
    words = np.array(["a", "b", "c", "d", "e"])
    floats = np.array([np.nan, -0.0, 0.0, 1.5, 2.5])
    return {
        "t1": pa.table({
            "k": pa.array(rng.integers(0, 12, n1), mask=nulls(n1)),
            "s": pa.array(rng.choice(words, n1), mask=nulls(n1)),
            "f": pa.array(rng.choice(floats, n1), mask=nulls(n1, 0.1)),
            "v": pa.array(rng.normal(0, 10, n1)),
        }),
        "t2": pa.table({
            "k": pa.array(rng.integers(5, 20, n2), mask=nulls(n2)),
            "s": pa.array(rng.choice(words[1:], n2), mask=nulls(n2)),
            "f": pa.array(rng.choice(floats, n2), mask=nulls(n2, 0.1)),
            "w": pa.array(rng.integers(-10, 10, n2).astype(np.int32)),
        }),
        "nonulls": pa.table({"k": pa.array(np.arange(3, 9))}),
    }


@pytest.fixture(scope="module")
def sessions():
    tables = _tables()
    return port_session(tables), reference_session(tables)


_QUERIES = {
    "inner_dup_keys": "select t1.k, t1.v, t2.w from t1 join t2 on t1.k = t2.k",
    "left": "select t1.k, t1.v, t2.w from t1 left join t2 on t1.k = t2.k",
    "right": "select t1.v, t2.k, t2.w from t1 right join t2 on t1.k = t2.k",
    "full": "select t1.k, t1.v, t2.k, t2.w from t1 full join t2 "
            "on t1.k = t2.k",
    "left_residual": "select t1.k, t1.v, t2.w from t1 left join t2 "
                     "on t1.k = t2.k and t2.w > t1.v",
    "right_residual": "select t1.v, t2.k, t2.w from t1 right join t2 "
                      "on t1.k = t2.k and t2.w < t1.v",
    "full_residual": "select t1.k, t1.v, t2.k, t2.w from t1 full join t2 "
                     "on t1.k = t2.k and t2.w > t1.v",
    "inner_residual": "select t1.k, t2.w from t1 join t2 "
                      "on t1.k = t2.k and t1.v < t2.w",
    "semi_in": "select k, v from t1 where k in (select k from t2)",
    "semi_exists": "select k, v from t1 where exists "
                   "(select t2.k from t2 where t2.k = t1.k and t2.w > 0)",
    "anti_not_exists": "select k, v from t1 where not exists "
                       "(select t2.k from t2 where t2.k = t1.k)",
    "not_in_with_nulls": "select k, v from t1 where k not in "
                         "(select k from t2)",
    "not_in_without_nulls": "select k, v from t1 where k not in "
                            "(select k from nonulls)",
    "not_in_empty": "select k, v from t1 where k not in "
                    "(select k from t2 where w > 100)",
    "string_key": "select t1.s, t1.v, t2.w from t1 join t2 on t1.s = t2.s",
    "string_and_int_key": "select t1.k, t1.s, t2.w from t1 left join t2 "
                          "on t1.k = t2.k and t1.s = t2.s",
    "cross": "select t1.k, t2.w from t1 cross join t2 where t1.v > t2.w",
    "string_compare_columns": "select t1.s, t2.s from t1 join t2 "
                              "on t1.k = t2.k where t1.s < t2.s",
}


@pytest.mark.parametrize("name", list(_QUERIES))
def test_join_matches_reference(sessions, name):
    port, reference = sessions
    sql = _QUERIES[name]
    assert_same_result(port.sql(sql).toArrow(), reference.sql(sql).toArrow(),
                       ordered=False)


def test_float_key_join_follows_spark_key_semantics(sessions):
    """NaN keys match NaN and -0.0 matches 0.0 (Spark normalises float
    join keys). Held against a count made here: the reference's executor
    returns fewer rows for this join (a fault of the reference, recorded
    in ROADMAP.md), so it is no yardstick."""
    port, _ = sessions
    tables = _tables()

    def counts(name):
        out = {}
        for x in tables[name].column("f").to_pylist():
            if x is not None:
                key = "nan" if x != x else x + 0.0
                out[key] = out.get(key, 0) + 1
        return out

    a, b = counts("t1"), counts("t2")
    want = sum(n * b.get(k, 0) for k, n in a.items())
    got = port.sql("select t1.f, t2.w from t1 join t2 on t1.f = t2.f") \
        .toArrow()
    assert got.num_rows == want == 600
    assert sum(1 for x in got.column("f").to_pylist() if x != x) == 9 * 7


def test_persistent_hash_ambiguity_raises(sessions, monkeypatch):
    """A hashed build that stays ambiguous after 4 seeds raises, as the
    reference does (it never answers from an ambiguous build)."""
    port, _ = sessions
    monkeypatch.setattr(tjoin, "hash_ambiguous",
                        lambda bt, cols: bt.num_valid >= 0)
    with pytest.raises(RuntimeError, match="unambiguous"):
        port.sql(_QUERIES["string_and_int_key"]).toArrow()
    assert tlocal.joink is tjoin


@pytest.mark.parametrize("q", [5, 21])
def test_runtime_filters_change_no_answer(q):
    """The same query with runtime join filters on (built, pushed to
    scans, pruning rows) and off gives the same rows; with them on the
    session logs each filter's rows before and after."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES

    tables = generate_tpch_sf(0.02, seed=3)
    on = port_session(tables)
    off = SparkSession({"spark.sail.device": "cpu",
                        "spark.sail.join.runtimeFilter.enabled": "false"})
    for name, table in tables.items():
        off.createDataFrame(table).createOrReplaceTempView(name)
    got = on.sql(QUERIES[q]).toArrow()
    assert on.last_runtime_filters
    assert any(after < before for f in on.last_runtime_filters
               for before, after in f["scan_rows"])
    assert_same_result(got, off.sql(QUERIES[q]).toArrow())
    assert off.last_runtime_filters == []
