"""The PyTorch port end to end: TPC-H Q1-Q8 through
``sail_tpu_torch.SparkSession`` against the JAX reference (Q9-Q22 in
test_torch_tpch_q09_q15.py and test_torch_tpch_q16_q22.py, so that the
reference's compile time spreads over test workers), Q1 and Q6 against an
exact pandas oracle, the generators, the port's isolation from JAX and
``sail_tpu``, and its device default.

Comparison rule (torch_tpch_common.py): integer, decimal, date, string and
bool columns exactly; float64 within a relative 1e-12, since sums are
taken in another order; row order only where the query has ORDER BY.
"""

import ast
import datetime
import decimal
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import numpy as np
import pyarrow as pa
import pytest
import torch

import sail_tpu
from sail_tpu.benchmarks import tpch_data as jdata
from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks import tpch_data as tdata
from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
from torch_tpch_common import (FLOAT_RTOL, assert_same_result, has_order_by,
                               port_session, reference_session,
                               reference_tables)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    return reference_tables()


@pytest.fixture(scope="module")
def lineitem():
    return tdata.generate_tpch(0.01, seed=0)["lineitem"]


@pytest.fixture(scope="module")
def port(tables):
    return port_session(tables)


@pytest.fixture(scope="module")
def reference(tables):
    return reference_session(tables)


@pytest.fixture(scope="module")
def port_lineitem(lineitem):
    spark = SparkSession({"spark.sail.device": "cpu"})
    spark.createDataFrame(lineitem).createOrReplaceTempView("lineitem")
    return spark


def test_generate_tpch_equals_reference():
    want = jdata.generate_tpch(0.01, seed=0)
    got = tdata.generate_tpch(0.01, seed=0)
    assert set(got) == set(want)
    for name in want:
        assert got[name].equals(want[name]), name


@pytest.mark.parametrize("q", range(1, 9))
def test_query_matches_reference(port, reference, q):
    assert_same_result(port.sql(QUERIES[q]).toArrow(),
                       reference.sql(QUERIES[q]).toArrow(),
                       ordered=has_order_by(QUERIES[q]))


def _unscaled(col: pa.ChunkedArray) -> np.ndarray:
    return np.array([int(v.scaleb(col.type.scale)) for v in col.to_pylist()],
                    dtype=np.int64)


def _pandas_oracle(lineitem: pa.Table):
    df = lineitem.select(["l_returnflag", "l_linestatus", "l_shipdate"]) \
        .to_pandas()
    for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        df[c] = _unscaled(lineitem.column(c))  # exact, in cents
    df["disc_price"] = df.l_extendedprice * (100 - df.l_discount)
    df["charge"] = df.disc_price * (100 + df.l_tax)
    q1 = df[df.l_shipdate <= datetime.date(1998, 9, 2)]
    q1 = q1.groupby(["l_returnflag", "l_linestatus"], sort=True).agg(
        sum_qty=("l_quantity", "sum"), sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"), avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"), count_order=("l_quantity", "size"),
    ).reset_index()
    lo, hi = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
    m6 = (df.l_shipdate >= lo) & (df.l_shipdate < hi) & \
        df.l_discount.between(5, 7) & (df.l_quantity < 2400)
    return q1, int((df.l_extendedprice[m6] * df.l_discount[m6]).sum())


def test_queries_match_pandas_oracle(port_lineitem, lineitem):
    port = port_lineitem
    q1, revenue = _pandas_oracle(lineitem)
    got = port.sql(QUERIES[1]).toArrow()
    assert got.column("l_returnflag").to_pylist() == list(q1.l_returnflag)
    assert got.column("l_linestatus").to_pylist() == list(q1.l_linestatus)
    for c in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge"):
        assert list(_unscaled(got.column(c))) == list(q1[c]), c
    assert got.column("count_order").to_pylist() == list(q1.count_order)
    for c in ("avg_qty", "avg_price", "avg_disc"):
        np.testing.assert_allclose(got.column(c).to_numpy(), q1[c] / 100,
                                   rtol=FLOAT_RTOL)
    q6 = port.sql(QUERIES[6]).toArrow()
    assert q6.column("revenue").to_pylist() == \
        [decimal.Decimal(revenue).scaleb(-4)]


def test_q1_with_nulls_matches_reference(lineitem):
    """NULL values and NULL group keys through the filter, the direct
    grouping and every aggregate."""
    rng = np.random.default_rng(4)
    cols = {}
    for name in lineitem.column_names:
        col = lineitem.column(name).combine_chunks()
        if name in ("l_quantity", "l_discount", "l_shipdate", "l_linestatus"):
            col = pa.array(col.to_pylist(), type=col.type,
                           mask=rng.random(len(col)) < 0.1)
        cols[name] = col
    table = pa.table(cols)
    port = SparkSession({"spark.sail.device": "cpu"})
    reference = sail_tpu.SparkSession({
        "spark.sail.execution.backend.force": "xla",
        "spark.sail.execution.mesh": "off"})
    for spark in (port, reference):
        spark.createDataFrame(table).createOrReplaceTempView("lineitem")
    got = port.sql(QUERIES[1]).toArrow()
    assert None in got.column("l_linestatus").to_pylist()
    assert_same_result(got, reference.sql(QUERIES[1]).toArrow())


def test_lineitem_sf_generator_is_lineitem_shaped():
    got = tdata.generate_lineitem_sf(0.002, seed=0)
    want = tdata.generate_tpch(0.002, seed=0)["lineitem"]
    assert got.column_names == want.column_names
    for name in got.column_names:
        g, w = got.schema.field(name).type, want.schema.field(name).type
        assert (g.value_type if pa.types.is_dictionary(g) else g) == w, name
    assert abs(got.num_rows - 6000 * 2) < 600
    again = tdata.generate_lineitem_sf(0.002, seed=0)
    assert again.equals(got)  # deterministic in the seed


def test_tpch_sf_generator_is_tpch_shaped():
    got = tdata.generate_tpch_sf(0.002, seed=0)
    want = tdata.generate_tpch(0.002, seed=0)
    assert set(got) == set(want)
    for name in want:
        assert got[name].column_names == want[name].column_names, name
        for f in want[name].schema:
            g = got[name].schema.field(f.name).type
            assert (g.value_type if pa.types.is_dictionary(g) else g) == \
                f.type, (name, f.name)
        assert abs(got[name].num_rows - want[name].num_rows) <= \
            0.1 * want[name].num_rows, name
    # lineitem is generate_lineitem_sf's, and orders holds its order keys
    assert got["lineitem"].equals(tdata.generate_lineitem_sf(0.002, seed=0))
    okeys = np.unique(got["lineitem"].column("l_orderkey").to_numpy())
    np.testing.assert_array_equal(
        got["orders"].column("o_orderkey").to_numpy(), okeys)
    assert tdata.generate_tpch_sf(0.002, seed=0)["orders"].equals(
        got["orders"])


# ---------------------------------------------------------------------------
# isolation and the device default
# ---------------------------------------------------------------------------

_ISOLATION = """
import sys
from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
spark = SparkSession.builder.config("spark.sail.device", "cpu").getOrCreate()
for name, table in generate_tpch_sf(0.01).items():
    spark.createDataFrame(table).createOrReplaceTempView(name)
assert spark.sql(QUERIES[1]).toArrow().num_rows > 0
assert spark.sql(QUERIES[3]).toArrow().num_rows > 0  # three joins
print(sorted(m for m in sys.modules
             if m.startswith("jax") or m == "sail_tpu" or m.startswith("sail_tpu.")))
"""


def test_port_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_source_imports_neither_jax_nor_reference():
    files = sorted((REPO / "sail_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "sail_tpu")]
    assert bad == []
    smoke = list(_imports(REPO / "chip_smoke.py"))
    assert not [m for m in smoke if m.split(".")[0] in ("jax", "sail_tpu")]


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert SparkSession({}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SparkSession.builder.getOrCreate()
    assert SparkSession.builder.config("spark.sail.device", "cpu") \
        .getOrCreate().device.type == "cpu"


def test_config_defaults_match_reference(monkeypatch):
    """The port keeps only the config keys it reads; each default equals
    the reference's, and SAIL_* env vars override them the same way."""
    from sail_tpu import config as jconfig
    from sail_tpu_torch import config as tconfig

    for key in tconfig._DEFAULTS:
        assert str(tconfig.get(key)).lower() == \
            str(jconfig.get(key)).lower(), key
    monkeypatch.setenv("SAIL_OPTIMIZER__ENABLE_JOIN_REORDER", "false")
    assert tconfig.truthy("optimizer.enable_join_reorder") is False
    assert jconfig.truthy("optimizer.enable_join_reorder") is False


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("q", range(1, 23))
def test_query_on_card_matches_cpu(tables, port, q):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = SparkSession({"spark.sail.device": "cuda"})
    for name, table in tables.items():
        card.createDataFrame(table).createOrReplaceTempView(name)
    assert_same_result(card.sql(QUERIES[q]).toArrow(),
                       port.sql(QUERIES[q]).toArrow(),
                       ordered=has_order_by(QUERIES[q]))

