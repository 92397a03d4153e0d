"""The window and UNION queries of ``benchmarks/window_queries.py`` (the
ones ``chip_smoke.py`` runs on the card at SF10) through both packages on
the reference's TPC-H test data, compared as in torch_window_common.

W4's ``s_prev`` sums ``lag(l_quantity, 1, -1)``: Spark's default there is
-1.00, the reference's the unscaled -0.01 (ROADMAP Queue C), so that
column is held to numpy instead of the reference."""

from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

from sail_tpu_torch.benchmarks.tpch_queries import QUERIES as TPCH
from sail_tpu_torch.benchmarks.window_queries import QUERIES
from torch_tpch_common import (has_order_by, port_session, reference_session,
                               reference_tables)
from torch_window_common import assert_window_result, run_both


@pytest.fixture(scope="module")
def tables():
    return reference_tables()


@pytest.fixture(scope="module")
def sessions(tables):
    return port_session(tables), reference_session(tables)


def _w4_s_prev(tables) -> Decimal:
    """sum(lag(l_quantity, 1, -1) OVER (PARTITION BY l_partkey ORDER BY
    l_shipdate, l_orderkey, l_linenumber)) in numpy: each row's previous
    quantity in its part's order, -1.00 on a part's first row."""
    li = tables["lineitem"]
    col = {c: li.column(c) for c in ("l_partkey", "l_shipdate", "l_orderkey",
                                     "l_linenumber", "l_quantity")}
    qty = np.round(col["l_quantity"].cast(pa.float64()).to_numpy() * 100
                   ).astype(np.int64)
    keys = [col[c].cast(pa.int64()).to_numpy() if c != "l_shipdate" else
            col[c].cast(pa.int32()).to_numpy()
            for c in ("l_linenumber", "l_orderkey", "l_shipdate",
                      "l_partkey")]
    order = np.lexsort(keys)
    part, q = keys[-1][order], qty[order]
    first = np.ones(len(q), bool)
    first[1:] = part[1:] != part[:-1]
    prev = np.where(first, -100, np.roll(q, 1))
    return Decimal(int(prev.sum())) / 100


@pytest.mark.parametrize("name", list(QUERIES))
def test_window_query_matches_reference(sessions, tables, name):
    sql = QUERIES[name]
    port, ref = sessions
    got = port.sql(sql).toArrow()
    want = ref.sql(sql).toArrow()
    if name == "w4":
        i = want.column_names.index("s_prev")
        assert want.column(i).to_pylist() != [_w4_s_prev(tables)]
        want = want.set_column(i, want.field(i), pa.array(
            [_w4_s_prev(tables)], want.field(i).type))
    assert_window_result(got, want, ordered=has_order_by(sql))
    assert got.num_rows > 0


def test_w7_equals_q17(sessions):
    port, _ = sessions
    assert port.sql(QUERIES["w7"]).toArrow().column(0).to_pylist() == \
        port.sql(TPCH[17]).toArrow().column(0).to_pylist()


def test_w7_without_the_brand_returns_a_value(sessions):
    """W7 over every brand's MED BOX parts: more partitions, a non-null
    answer at any size."""
    sql = QUERIES["w7"].replace("and p_brand = 'Brand#23'", "")
    assert sql != QUERIES["w7"]
    got = run_both(*sessions, sql)
    assert got.column(0).to_pylist()[0] is not None
