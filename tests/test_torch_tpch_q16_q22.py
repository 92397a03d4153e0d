"""TPC-H Q16-Q22 through ``sail_tpu_torch.SparkSession`` against the JAX
reference, on the reference's TPC-H test data (a file of its own so that
the reference's compile time spreads over test workers; the comparison
rule is torch_tpch_common.py's)."""

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import pytest

from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
from torch_tpch_common import (assert_same_result, has_order_by,
                               port_session, reference_session,
                               reference_tables)


@pytest.fixture(scope="module")
def sessions():
    tables = reference_tables()
    return port_session(tables), reference_session(tables)


@pytest.mark.parametrize("q", range(16, 23))
def test_query_matches_reference(sessions, q):
    port, reference = sessions
    assert_same_result(port.sql(QUERIES[q]).toArrow(),
                       reference.sql(QUERIES[q]).toArrow(),
                       ordered=has_order_by(QUERIES[q]))
