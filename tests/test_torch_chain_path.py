"""The path's queries with fused chains (K16, K17, K18) on the CPU.

The 22 TPC-H queries at SF 0.01, E1-E7 and the window and union queries
give the same answer with their chains fused as with every chain forced
onto its closures (``torch_chain_common.PerOp``), NaN-aware and exactly;
and every chain of the 22 TPC-H queries, E1-E7 and ClickBench Q30 that
computes an expression runs K16, K17 or K18 (``last_chain_routes``).
E7's sort and each sorted grouping over a chain in TPC-H, E3 and E4
write their words in K18, and those whose keys fit in 63 bits sort one
packed word (``last_sort_routes``). One session runs every query fused
once; each case runs its query unfused.
"""

import pyarrow as pa
import pytest

from sail_tpu_torch.benchmarks import clickbench as cb
from sail_tpu_torch.benchmarks import expr_queries, window_queries
from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
from sail_tpu_torch.benchmarks.tpch_queries import QUERIES as TPCH
from torch_chain_common import PerOp
from torch_tpch_common import port_session


def _rows(t: pa.Table):
    return [[None if v is None else ("nan" if v != v else v) for v in row]
            for row in zip(*(c.to_pylist() for c in t.columns))]


def _path_queries():
    qs = {f"q{q}": TPCH[q] for q in range(1, 23)}
    qs.update(expr_queries.QUERIES)
    qs.update(window_queries.QUERIES)
    return qs


@pytest.fixture(scope="module")
def fused():
    """(the session, {query: (its answer's rows, its chains' routes)})."""
    spark = port_session(generate_tpch_sf(0.01, seed=0))
    runs = {}
    for name, sql in _path_queries().items():
        rows = _rows(spark.sql(sql).toArrow())
        runs[name] = (rows, list(spark.last_chain_routes),
                      list(spark.last_sort_routes))
    return spark, runs


@pytest.mark.parametrize("name", sorted(_path_queries()))
def test_path_fused_equals_unfused(fused, name):
    spark, runs = fused
    with PerOp():
        want = _rows(spark.sql(_path_queries()[name]).toArrow())
    assert [r["route"] for r in spark.last_chain_routes
            if r["route"] != "refs"] == \
        ["per-op"] * len([r for r in spark.last_chain_routes
                          if r["route"] != "refs"])
    assert runs[name][0] == want


def _computing(routes):
    return [r for r in routes if r["route"] != "refs"]


def test_route_report(fused):
    """Every chain of the 22 TPC-H queries, E1-E7 and ClickBench Q30 that
    computes an expression runs as one program: K16 or K17."""
    _, runs = fused
    seen = {q: _computing(routes) for q, (_, routes, _) in runs.items()
            if not q.startswith(("w", "u"))}
    cbs = port_session({"hits": cb.generate_hits(20_000, 0,
                                                  dictionary=True)})
    cbs.sql(cb.load_queries()[29]).toArrow()
    seen["cb30"] = _computing(cbs.last_chain_routes)
    bad = {q: [r for r in rs if r["route"] not in ("K16", "K17", "K18")]
           for q, rs in seen.items()}
    assert not any(bad.values()), bad
    for q in ("q1", "q6", "e1", "e2", "e5", "cb30"):
        assert "K17" in [r["route"] for r in seen[q]], (q, seen[q])
    assert seen["cb30"][0]["nodes"] >= 1


# the sorted groupings over a chain (K18) of TPC-H at SF 0.01, E3 and E4,
# and the ORDER BYs over one, with their keys' count; every other sort or
# sorted grouping of these queries reads its columns through K3
K18_GROUPINGS = {"q3": [3], "q7": [3], "q8": [1], "q9": [2], "q10": [7],
                 "q11": [1], "q15": [1, 1], "q20": [2], "e3": [2],
                 "e4": [2]}
K18_SORTS = {"q1": [2], "q2": [4], "q8": [1], "q11": [1], "e1": [2],
             "e4": [2], "e5": [1], "e6": [1], "e7": [4]}


def test_sort_routes(fused):
    """E7's sort and each sorted grouping over a chain write their words
    in K18; each whose keys fit in 63 bits at SF 0.01 sorts one packed
    word. Q10's grouping (seven keys, its names and addresses as
    dictionary codes, its balance a decimal) and E7's sort (two float64
    keys) do not fit, and sort by the passes."""
    _, runs = fused
    for q, (_, _, sorts) in runs.items():
        if q.startswith(("w", "u")):
            continue
        groups = [r["keys"] for r in sorts if r["route"] == "K18" and
                  r["consumer"] == "AggregateExec"]
        orders = [r["keys"] for r in sorts if r["route"] == "K18" and
                  r["consumer"] == "SortExec"]
        assert groups == K18_GROUPINGS.get(q, []), (q, sorts)
        assert orders == K18_SORTS.get(q, []), (q, sorts)
        for r in sorts:
            assert r["route"] in ("K18", "K3"), (q, r)
            wide = (q, r["consumer"]) in (("q10", "AggregateExec"),
                                          ("e7", "SortExec"))
            assert r["form"] == ("passes" if wide else "packed"), (q, r)
