"""The port's join order (``sail_tpu_torch/plan/join_reorder.py``) over
TPC-H: no cross join where the query's predicates connect its tables,
and no join output that grows faster than the scale factor.

Q2, Q8 and Q9 once joined a filtered ``part`` with ``supplier`` as a
cross join, and Q5 joined ``supplier`` with ``customer`` on their nation
key before ``orders``: intermediates that grow with the square of the
scale factor. The growth is measured, not read off the plan: the largest
join output (rows live and dead, ``SparkSession.last_join_rows``) of each
query at two scale factors, with the runtime join filters off: their
pruning of the scans, which depends on the data, would hide the order's.
"""

import pytest

from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks import tpch_data, tpch_queries
from sail_tpu_torch.plan import nodes as pn
from sail_tpu_torch.plan.optimizer import optimize
from sail_tpu_torch.plan.resolver import Resolver
from sail_tpu_torch.sql import parse_one

SMALL, LARGE = 0.01, 0.1


def _session(sf):
    spark = SparkSession({"spark.sail.device": "cpu",
                          "spark.sail.join.runtimeFilter.enabled": "false"})
    for name, table in tpch_data.generate_tpch_sf(sf, seed=0).items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    return spark


@pytest.fixture(scope="module")
def small():
    return _session(SMALL)


@pytest.fixture(scope="module")
def large():
    return _session(LARGE)


@pytest.mark.parametrize("q", range(1, 23))
def test_no_cross_join_between_connected_tables(small, q):
    plan = optimize(Resolver(small.catalog_manager).resolve(
        parse_one(tpch_queries.QUERIES[q])))
    crosses = [n for n in pn.walk_plan(plan)
               if isinstance(n, pn.JoinExec) and (
                   n.join_type == "cross" or
                   (n.join_type == "inner" and not n.left_keys))]
    assert not crosses, pn.explain(plan)


@pytest.mark.parametrize("q", (2, 5, 8, 9))
def test_largest_join_output_grows_with_the_scale_factor(small, large, q):
    sql = tpch_queries.QUERIES[q]
    small.sql(sql).toArrow()
    rows_small = max(small.last_join_rows)
    large.sql(sql).toArrow()
    rows_large = max(large.last_join_rows)
    # linear growth gives a ratio near LARGE / SMALL = 10; the square of
    # the scale factor, near 100
    assert rows_large <= 2 * (LARGE / SMALL) * rows_small, \
        (rows_small, rows_large)
