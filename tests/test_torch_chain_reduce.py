"""K17 (``sail_tpu_torch/ops/chain.py`` ``run_chain_reduce``) on the CPU,
and the chain routes of the path's queries.

An aggregate whose grouping is keyless or direct (dictionary codes and
booleans) and whose aggregates are COUNT, SUM, MIN and MAX of non-string
values absorbs its chain into K17. On the CPU, K17's plain version reduces
the program's registers through the K1 route's functions, so its answer
must equal the unfused route's (the chain's closures, then K2 and K1)
exactly, NaN and empty groups included, and the reference's as
``torch_tpch_common.assert_same_result`` compares them. K17's bins are
K2's numbers: the key columns decoded from a bin are the codes of the rows
K2 puts in it (``tests/test_torch_chain_path.py`` holds the path's
queries).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch.ops import aggregate as aggk
from sail_tpu_torch.spec import data_type as dt
from torch_chain_common import (REDUCE_QUERIES, PerOp, chain_table,
                                session)
from torch_tpch_common import assert_same_result, reference_session

TABLE = chain_table()


def _rows(t: pa.Table):
    return [[None if v is None else ("nan" if v != v else v) for v in row]
            for row in zip(*(c.to_pylist() for c in t.columns))]


@pytest.fixture(scope="module")
def cpu():
    return session("cpu", TABLE)


@pytest.mark.parametrize("kind", sorted(REDUCE_QUERIES))
def test_k17_equals_unfused_route(cpu, kind):
    got = cpu.sql(REDUCE_QUERIES[kind]).toArrow()
    routes = [r["route"] for r in cpu.last_chain_routes]
    assert routes[0] == "K17", cpu.last_chain_routes
    with PerOp():
        want = cpu.sql(REDUCE_QUERIES[kind]).toArrow()
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)


# the kinds the reference computes as Spark does (its float MIN/MAX
# ignore NaN where Spark orders it above every number)
@pytest.mark.parametrize("kind", sorted(set(REDUCE_QUERIES) -
                                        {"nan_extremes", "keyless",
                                         "keyless_expr"}))
def test_k17_equals_reference(cpu, kind):
    got = cpu.sql(REDUCE_QUERIES[kind]).toArrow()
    want = reference_session({"t": TABLE}).sql(
        REDUCE_QUERIES[kind]).toArrow()
    assert_same_result(got, want, ordered=False)


def test_k17_on_empty_input(cpu):
    spark = session("cpu", TABLE.slice(0, 0))
    for kind in ("keyless", "one_key", "two_keys"):
        got = spark.sql(REDUCE_QUERIES[kind]).toArrow()
        assert spark.last_chain_routes[0]["route"] == "K17"
        with PerOp():
            want = spark.sql(REDUCE_QUERIES[kind]).toArrow()
        assert _rows(got) == _rows(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bins_are_k2_numbers(seed):
    """Each live row's codes (clipped into their domain, NULL in the extra
    slot) are the key columns K17 decodes from the bin K2 gives it."""
    rng = np.random.default_rng(seed)
    n, domains = 500, [3, 2, 5]
    codes = [torch.from_numpy(rng.integers(-1, d + 1, n).astype(np.int32))
             for d in domains[:2]]
    codes.append(torch.from_numpy(rng.random(n) < 0.5))
    domains[2] = 2
    valid = [None, torch.from_numpy(rng.random(n) < 0.8),
             torch.from_numpy(rng.random(n) < 0.9)]
    sel = torch.from_numpy(rng.random(n) < 0.7)
    gid, counts = aggk.direct_group_ids_plain(codes, valid, domains, sel)
    keys = aggk.direct_key_columns(
        domains, [torch.int32, torch.int32, torch.bool], [False, True, True],
        [dt.IntegerType(), dt.IntegerType(), dt.BooleanType()], "cpu")
    assert all(k.data.shape[0] == counts.shape[0] for k in keys)
    live = sel.nonzero().flatten()
    for j, (c, v, d) in enumerate(zip(codes, valid, domains)):
        g = gid[live].long()
        dec = keys[j]
        ok = torch.ones(live.shape[0], dtype=torch.bool) if v is None \
            else v[live]
        if dec.validity is not None:
            assert torch.equal(dec.validity[g], ok)
        want = c[live].to(torch.int32).clamp(0, d - 1) if c.dtype != \
            torch.bool else c[live]
        assert torch.equal(dec.data[g][ok], want.to(dec.data.dtype)[ok])


def test_accumulators_past_the_limit_take_k16():
    """4096 bins x 4 slots is past K17's shared-memory accumulators: the
    chain runs K16, then K2 and K1, with the same answer."""
    n = 20_000
    rng = np.random.default_rng(5)
    t = pa.table({
        "a": pa.array([f"a{x}" for x in rng.integers(0, 63, n)]
                      ).dictionary_encode(),
        "c": pa.array([f"c{x}" for x in rng.integers(0, 63, n)]
                      ).dictionary_encode(),
        "v": pa.array(rng.integers(0, 100, n))})
    spark = session("cpu", t)
    sql = "SELECT a, c, sum(v + 1), max(v), min(v) FROM t GROUP BY a, c"
    got = spark.sql(sql).toArrow()
    assert [r["route"] for r in spark.last_chain_routes][:1] == ["K16"]
    with PerOp():
        want = spark.sql(sql).toArrow()
    assert _rows(got) == _rows(want)
