"""All 22 TPC-H queries through ``sail_tpu_torch.SparkSession`` against
the pandas oracle of tests/tpch_oracle.py, on the reference's TPC-H test
data and on ``generate_tpch_sf``'s, compared as chip_smoke.py compares on
the card (tests/test_tpch.py's rule: floats within rtol 1e-6 after
rounding to 4 places, other columns exactly, rows as sets where the
ORDER BY leaves ties)."""

import pytest

from chip_smoke import _pandas_frames, compare_with_oracle
from sail_tpu_torch.benchmarks.tpch_data import generate_tpch, generate_tpch_sf
from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
from torch_tpch_common import port_session
from tpch_oracle import ORACLES

_DATA = {"generate_tpch(0.005, 7)": lambda: generate_tpch(0.005, seed=7),
         "generate_tpch_sf(0.01, 0)": lambda: generate_tpch_sf(0.01, seed=0)}


@pytest.fixture(scope="module", params=list(_DATA))
def data(request):
    tables = _DATA[request.param]()
    return port_session(tables), _pandas_frames(tables)


@pytest.mark.parametrize("q", range(1, 23))
def test_query_matches_pandas_oracle(data, q):
    spark, frames = data
    got = spark.sql(QUERIES[q]).toArrow()
    want = ORACLES[q](frames)
    assert got.num_rows > 0 or len(want) == 0
    compare_with_oracle(got.to_pandas(), want, q)
