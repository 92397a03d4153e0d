"""Shared pieces of the port's TPC-H tests: the data the reference's own
TPC-H test uses, sessions of both packages over it, and the comparisons.

Comparison rule against the reference: integer, decimal, date, string and
bool columns exactly; float64 within a relative 1e-12 (sums are taken in
another order); row order only where the query has an ORDER BY.
"""

import numpy as np
import pyarrow as pa

import sail_tpu
from sail_tpu.benchmarks import tpch_data as jdata
from sail_tpu_torch import SparkSession

FLOAT_RTOL = 1e-12


def reference_tables():
    """tests/test_tpch.py's data."""
    return jdata.generate_tpch(0.005, seed=7)


def port_session(tables):
    spark = SparkSession({"spark.sail.device": "cpu"})
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    return spark


def reference_session(tables):
    """The reference on its XLA path (its cost model would route some
    aggregates to the native C++ backend) and without the mesh."""
    spark = sail_tpu.SparkSession({
        "spark.sail.execution.backend.force": "xla",
        "spark.sail.execution.mesh": "off"})
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    return spark


def _sorted_rows(t: pa.Table) -> pa.Table:
    names = [f"c{i}" for i in range(t.num_columns)]  # names may repeat
    return t.rename_columns(names).sort_by([(n, "ascending") for n in names])


def assert_same_result(got: pa.Table, want: pa.Table, ordered: bool = True):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    if not ordered:
        got, want = _sorted_rows(got), _sorted_rows(want)
    for i, name in enumerate(want.column_names):
        g, w = got.column(i), want.column(i)
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(),
                                       rtol=FLOAT_RTOL, atol=0)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def has_order_by(sql: str) -> bool:
    return "order by" in " ".join(sql.lower().split())
