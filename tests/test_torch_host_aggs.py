"""The host aggregates (``sail_tpu_torch/functions/host_aggregates.py``
``HOST_AGGS``: statistics, percentiles, max_by/min_by, bit folds,
collections, try_sum) through ``SparkSession.sql`` in both packages on
the CPU, and their kernels (K19 seg_moments, K20 seg_pick, K1's bit
kinds) on the card against their plain versions.

Every one of the 38 aggregates (all of ``HOST_AGGS`` but any_value,
which both resolvers take as ``first``) runs over one small seeded table
in three forms: grouped by a dictionary key (K2's bins), by an int64 key
(the sort) and keyless. The table holds NULLs in every field, a group
whose values are all NULL, a group that a filter removes, a one-row
group, ties of max_by/min_by's key, NaN, decimals, strings, a group whose
x is three 0.1s, intervals, and int64 sums on both sides of overflow.
Groups are matched by key; integers, decimals, strings, dates and
intervals exactly, floats within ``FLOAT_RTOL`` (``same_cv``'s rule:
relative, against at least 1), the percentiles exactly, collect_set as a
set, every list in order (each group's rows come in row order in both).

Where the reference is wrong, the port is held to Spark's rule and the
reference is asserted to differ (``REFERENCE_WRONG``, as in
tests/test_torch_expr_queries.py): a group whose x is three 0.1s has a
variance of exactly 0 (the reference's mean, 0.10000000000000002, leaves
its centred sum a rounding error, so corr, skewness, kurtosis,
regr_slope, regr_intercept and regr_r2 come out as numbers where they
are NULL), and a listagg without a delimiter joins with "" (the
reference takes the second character of the group's first value).

The card tests (``-m gpu``) build K19 and K20 from the repo's sources and
hold them and K1's bit kinds to their plain versions at a million rows
with 4, 100,000 and a million groups, in the three context modes:
``python -m pytest tests/test_torch_host_aggs.py -m gpu``.
"""

import datetime
import decimal
import math
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch import csrc
from sail_tpu_torch.functions.host_aggregates import HOST_AGGS
from sail_tpu_torch.ops import aggregate as aggk
from torch_chain_common import same_cv
from torch_tpch_common import port_session, reference_session

FLOAT_RTOL = 1e-12
WHERE = "WHERE o <> 99"
FORMS = ("dict", "int", "keyless")
_KEY = {"dict": "g", "int": "k", "keyless": None}

# (case id, SQL expression, comparison): "float" within FLOAT_RTOL,
# "exact", "set" (a list compared as a set)
CASES = [
    ("corr", "corr(x, y)", "float"),
    ("corr_nan", "corr(xn, y)", "float"),
    ("covar_samp", "covar_samp(x, y)", "float"),
    ("covar_pop", "covar_pop(d, y)", "float"),
    ("skewness", "skewness(x)", "float"),
    ("skewness_nan", "skewness(xn)", "float"),
    ("kurtosis", "kurtosis(x)", "float"),
    ("regr_count", "regr_count(y, x)", "exact"),
    ("regr_avgx", "regr_avgx(y, x)", "float"),
    ("regr_avgy", "regr_avgy(y, x)", "float"),
    ("regr_sxx", "regr_sxx(y, x)", "float"),
    ("regr_syy", "regr_syy(y, x)", "float"),
    ("regr_sxy", "regr_sxy(y, x)", "float"),
    ("regr_slope", "regr_slope(y, x)", "float"),
    ("regr_intercept", "regr_intercept(y, x)", "float"),
    ("regr_r2", "regr_r2(y, x)", "float"),
    ("median", "median(x)", "exact"),
    ("median_interval", "median(dti)", "exact"),
    ("percentile", "percentile(y, 0.3)", "exact"),
    ("percentile_cont", "percentile_cont(0.25) WITHIN GROUP "
                        "(ORDER BY x DESC)", "exact"),
    ("percentile_approx", "percentile_approx(d, 0.5)", "exact"),
    ("approx_percentile", "approx_percentile(y, 0.9)", "exact"),
    ("percentile_disc", "percentile_disc(0.4) WITHIN GROUP (ORDER BY y)",
     "exact"),
    ("percentile_disc_desc", "percentile_disc(0.4) WITHIN GROUP "
                             "(ORDER BY d DESC)", "exact"),
    ("mode", "mode(s)", "exact"),
    ("mode_int", "mode(i)", "exact"),
    ("mode_ordered", "mode() WITHIN GROUP (ORDER BY s DESC)", "exact"),
    ("max_by", "max_by(s, o)", "exact"),
    ("min_by", "min_by(d, x)", "exact"),
    ("product", "product(x)", "float"),
    ("collect_list", "collect_list(s)", "exact"),
    ("array_agg", "array_agg(d)", "exact"),
    ("collect_set", "collect_set(i)", "set"),
    ("listagg", "listagg(s, ',')", "exact"),
    ("string_agg", "string_agg(s, '-')", "exact"),
    ("listagg_double", "listagg(x, ',')", "exact"),
    ("listagg_int", "string_agg(i, ',')", "exact"),
    ("listagg_bool", "listagg(o > 3, '|')", "exact"),
    ("listagg_ordered", "listagg(s, ',') WITHIN GROUP (ORDER BY x)",
     "exact"),
    ("listagg_ordered_desc", "listagg(s, ';') WITHIN GROUP (ORDER BY o DESC)",
     "exact"),
    ("bit_and", "bit_and(y)", "exact"),
    ("bit_or", "bit_or(i)", "exact"),
    ("bit_xor", "bit_xor(y)", "exact"),
    ("histogram_numeric", "histogram_numeric(o, 3)", "exact"),
    ("try_sum", "try_sum(y)", "exact"),
    ("try_sum_float", "try_sum(x)", "float"),
    ("try_avg", "try_avg(y)", "float"),
    ("try_avg_decimal", "try_avg(d)", "float"),
    ("try_avg_ym", "try_avg(ym)", "exact"),
    ("collect_list_distinct", "collect_list(DISTINCT s)", "exact"),
    ("collect_set_distinct", "collect_set(DISTINCT s)", "set"),
    ("median_distinct", "median(DISTINCT y)", "exact"),
    ("try_sum_distinct", "try_sum(DISTINCT y)", "exact"),
    ("max_by_distinct", "max_by(DISTINCT s, o)", "exact"),
    ("covar_pop_distinct", "covar_pop(DISTINCT x, y)", "float"),
]
CHUNK = 9  # aggregates a query

# cases where the reference breaks a rule the port keeps: (case, group k)
# → the port's answer there. Group 3's x is three 0.1s: a variance of 0.
REFERENCE_WRONG = {(c, 3): None for c in (
    "corr", "skewness", "kurtosis", "regr_slope", "regr_intercept",
    "regr_r2")}


def _names() -> set:
    """The HOST_AGGS names the cases' SQL reaches."""
    out = set()
    for _, sql, _ in CASES:
        name = sql.split("(")[0]
        if "WITHIN GROUP" in sql and name in ("mode", "listagg"):
            name = "__mode_ordered" if name == "mode" else \
                "__listagg_ordered"
        if name == "try_avg" and "ym" in sql:
            name = "try_avg_ym"
        out.add(name)
    return out


def test_cases_cover_every_host_aggregate():
    assert set(HOST_AGGS) - {"any_value"} == _names()
    assert len(_names()) == 38


def _table() -> pa.Table:
    rng = np.random.default_rng(17)
    rows = []  # (k, g, x, xn, y, d, s, o, i, ym, dti)

    def add(k, n, x=None, y=None, o=None, s=None, d=None, i=None,
            ym=None, nulls=0.0, xn=None):
        for j in range(n):
            def pick(v, default):
                if v is not None:
                    return v[j] if isinstance(v, list) else v
                if rng.random() < nulls:
                    return None
                return default()
            rows.append((
                k, _NAMES[k],
                pick(x, lambda: float(np.round(rng.normal(3, 2), 3))),
                pick(xn, lambda: float(rng.normal())),
                pick(y, lambda: int(rng.integers(-50, 50))),
                pick(d, lambda: decimal.Decimal(int(rng.integers(-9999, 9999)))
                     .scaleb(-2)),
                pick(s, lambda: "pqrst"[int(rng.integers(0, 5))] * 2),
                pick(o, lambda: int(rng.integers(0, 8))),
                pick(i, lambda: int(rng.integers(0, 1 << 20))),
                pick(ym, lambda: int(rng.integers(-30, 30))),
                pick(None, lambda: int(rng.integers(-10**9, 10**9)))))

    add(1, 24, nulls=0.2)                      # mixed, NULLs everywhere
    add(2, 1)                                  # one row
    add(3, 3, x=0.1, d=decimal.Decimal("0.10"))  # constant x
    add(4, 4, x=[None] * 4, xn=[None] * 4, y=[None] * 4, d=[None] * 4,
        s=[None] * 4, i=[None] * 4, ym=[None] * 4)  # every value NULL
    add(5, 3, y=1 << 62, ym=1 << 30)           # sums past int64, int32
    add(6, 2, y=[1 << 62, (1 << 62) - 1])      # 2^63 - 1: fits
    add(7, 3, y=[-(1 << 62), -(1 << 62), -1])  # -2^63 - 1: past int64
    add(8, 2, y=[-(1 << 62), -(1 << 62)])      # -2^63: fits
    add(9, 5, o=[5, 3, 5, 1, 5], s=["pp", "qq", "rr", "qq", "tt"],
        xn=[1.0, float("nan"), 2.0, 0.5, 3.0], x=[2.0, 1.0, 2.0, 3.0, 1.0])
    add(10, 2, o=99)                           # filtered away
    order = rng.permutation(len(rows))
    rows = [rows[j] for j in order]
    cols = list(zip(*rows))
    return pa.table({
        "k": pa.array(cols[0], pa.int64()),
        "g": pa.array(cols[1], pa.string()),
        "x": pa.array(cols[2], pa.float64()),
        "xn": pa.array(cols[3], pa.float64()),
        "y": pa.array(cols[4], pa.int64()),
        "d": pa.array(cols[5], pa.decimal128(10, 2)),
        "s": pa.array(cols[6], pa.string()),
        "o": pa.array(cols[7], pa.int32()),
        "i": pa.array(cols[8], pa.int32()),
        "ym": pa.array([None if v is None else (v, 0, 0) for v in cols[9]],
                       pa.month_day_nano_interval()),
        "dti": pa.array([None if v is None else datetime.timedelta(
            microseconds=v) for v in cols[10]], pa.duration("us")),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


@pytest.fixture(scope="module")
def sessions(table):
    return port_session({"t": table}), reference_session({"t": table})


_NAMES = "gabcdefhijz"  # group k's string key g


def _sql(form: str, exprs) -> str:
    """The aggregates in ``form``, with a COUNT(*) beside them: a chunk of
    DISTINCT aggregates alone would take the reference's two-level plan,
    which raises where one has several arguments
    (``test_lone_distinct_of_several_arguments``)."""
    key = _KEY[form]
    sel = ", ".join(["count(*) AS n"] + [
        f"{e} AS a{j}" for j, e in enumerate(exprs)])
    if key is None:
        return f"SELECT {sel} FROM t {WHERE}"
    return f"SELECT {key} AS key, {sel} FROM t {WHERE} GROUP BY {key}"


def _group(key):
    """Group k of a result row's key (None: keyless)."""
    return _NAMES.index(key) if isinstance(key, str) else key


@pytest.fixture(scope="module")
def answers(sessions):
    """(form, case id) → {group k: (port's value, reference's value)}."""
    port, ref = sessions
    out = {}
    for form in FORMS:
        for c0 in range(0, len(CASES), CHUNK):
            chunk = CASES[c0:c0 + CHUNK]
            sql = _sql(form, [e for _, e, _ in chunk])
            got = port.sql(sql).toArrow().to_pylist()
            want = ref.sql(sql).toArrow().to_pylist()
            assert len(got) == len(want)

            def by_key(rows):
                return {_group(r.get("key")): r for r in rows}
            got, want = by_key(got), by_key(want)
            assert got.keys() == want.keys()
            for j, (cid, _, _) in enumerate(chunk):
                out[(form, cid)] = {k: (got[k][f"a{j}"], want[k][f"a{j}"])
                                    for k in got}
    return out


def _floats_equal(g, w) -> bool:
    """One value each side, as ``same_cv`` compares float columns."""
    if g is None or w is None:
        return g is None and w is None
    try:
        same_cv((torch.tensor([float(g)], dtype=torch.float64), None),
                (torch.tensor([float(w)], dtype=torch.float64), None),
                exact=False, rtol=FLOAT_RTOL)
    except AssertionError:
        return False
    return True


def _equal(kind: str, g, w) -> bool:
    if kind == "float":
        return _floats_equal(g, w)
    if kind == "set":
        return (g is None and w is None) or (
            g is not None and w is not None and
            sorted(g, key=repr) == sorted(w, key=repr))
    if isinstance(g, float) and isinstance(w, float) and \
            math.isnan(g) and math.isnan(w):
        return True
    return g == w


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("cid,sql,kind", CASES, ids=[c[0] for c in CASES])
def test_host_aggregate_matches_reference(answers, form, cid, sql, kind):
    for k, (g, w) in answers[(form, cid)].items():
        if (cid, k) in REFERENCE_WRONG:
            assert g == REFERENCE_WRONG[(cid, k)], (k, g)
            assert w is not None, (k, w)
            continue
        assert _equal(kind, g, w), (form, k, g, w)


# the DISTINCT cases of an aggregate of several arguments (a struct)
_SEVERAL = [c for c in CASES if "DISTINCT" in c[1] and "," in c[1]]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("cid,sql,kind", _SEVERAL,
                         ids=[c[0] for c in _SEVERAL])
def test_lone_distinct_of_several_arguments(sessions, answers, form, cid,
                                            sql, kind):
    """A DISTINCT aggregate of several arguments alone dedupes its rows'
    tuples as it does beside a non-DISTINCT aggregate. The reference's
    plan for DISTINCT aggregates alone groups by their arguments first:
    by the struct of several, which raises where that grouping sorts and
    dedupes nothing where it bins the struct's positional codes (ROADMAP
    Queue C). So the port keeps the flag on the aggregate there, and is
    held to its answer beside COUNT(*), which ``answers`` holds to the
    reference's."""
    port, _ = sessions
    key = _KEY[form]
    lone = f"SELECT {sql} AS a0 FROM t {WHERE}" if key is None else \
        f"SELECT {key} AS key, {sql} AS a0 FROM t {WHERE} GROUP BY {key}"
    got = {_group(r.get("key")): r["a0"]
           for r in port.sql(lone).toArrow().to_pylist()}
    beside = answers[(form, cid)]
    assert got.keys() == beside.keys()
    for k, g in got.items():
        assert _equal(kind, g, beside[k][0]), (form, k, g, beside[k])


def test_listagg_without_delimiter_joins_with_nothing(sessions):
    """The reference takes the second character of a group's first value
    as the delimiter of a one-argument listagg; Spark's is empty."""
    port, ref = sessions
    sql = "SELECT k, listagg(s) AS l FROM t GROUP BY k"
    got = {r["k"]: r["l"] for r in port.sql(sql).toArrow().to_pylist()}
    want = {r["k"]: r["l"] for r in ref.sql(sql).toArrow().to_pylist()}
    rows = port.sql("SELECT k, s FROM t").toArrow()
    joined: dict = {k: None for k in got}
    for k, s in zip(rows.column("k").to_pylist(), rows.column("s").to_pylist()):
        if s is not None:
            joined[k] = (joined[k] or "") + s
    assert got == joined
    assert any(want[k] != joined[k] for k in joined)


def test_nested_columns_pass_through_the_operators(sessions):
    """A collected list carried by Filter, Sort, Limit and UNION, and an
    uploaded list column, as the reference carries them."""
    port, ref = sessions
    for sql in (
            "SELECT k, l FROM (SELECT k, collect_list(o) AS l FROM t "
            "GROUP BY k) WHERE k > 2 ORDER BY k DESC LIMIT 4",
            "SELECT k, collect_list(s) AS l FROM t WHERE k = 9 GROUP BY k "
            "UNION ALL SELECT k, collect_list(s) FROM t WHERE k = 1 "
            "GROUP BY k"):
        assert port.sql(sql).toArrow().to_pylist() == \
            ref.sql(sql).toArrow().to_pylist()
    lists = pa.table({"j": pa.array([3, 1, 2], pa.int64()),
                      "v": pa.array([[1, 2], None, [3]],
                                    pa.list_(pa.int64()))})
    p2, r2 = port_session({"u": lists}), reference_session({"u": lists})
    sql = "SELECT j, v FROM u WHERE j > 1 ORDER BY j"
    assert p2.sql(sql).toArrow().to_pylist() == \
        r2.sql(sql).toArrow().to_pylist()


def test_struct_outside_a_host_aggregate_raises(sessions):
    port, _ = sessions
    with pytest.raises(NotImplementedError, match="host functions"):
        port.sql("SELECT struct(x, y) FROM t").toArrow()


def test_percentage_not_a_literal_waits_for_array(sessions):
    """p is a literal scalar: a column raises, naming the slice that
    brings ``array``; ``array`` itself is not a function of the port
    yet."""
    port, _ = sessions
    with pytest.raises(NotImplementedError, match="array"):
        port.sql("SELECT percentile(x, o) FROM t").toArrow()
    with pytest.raises(TypeError, match="array"):
        port.sql("SELECT percentile(x, array(0.1, 0.9)) FROM t").toArrow()


def test_host_aggregates_take_no_k17(sessions):
    """An aggregate with a host aggregate keeps its chain apart (K17 would
    reduce only the device aggregates)."""
    port, _ = sessions
    port.sql("SELECT g, sum(y), median(x) FROM t WHERE o > 1 GROUP BY g"
             ).toArrow()
    assert "K17" not in {r["route"] for r in port.last_chain_routes}


# ---------------------------------------------------------------------------
# the families' plain versions against the reference's functions
# ---------------------------------------------------------------------------

def _ctx(mode: str, ids: np.ndarray, groups: int, sel: np.ndarray):
    """A GroupContext of ``mode`` over group ids (row order)."""
    ids_t = torch.from_numpy(ids.astype(np.int32))
    sel_t = torch.from_numpy(sel)
    if mode == "keyless":
        return aggk.group_rows([], sel_t, 1)[0]
    if mode == "binned":
        seg = torch.where(sel_t, ids_t, groups).to(torch.int32)
        ctx = aggk.GroupContext(sel_t, groups, groups, seg_ids=seg,
                                group_mask=torch.ones(groups, dtype=torch.bool))
        return ctx
    key = aggk.Column(torch.from_numpy(ids.astype(np.int64)), None, None)
    return aggk.group_rows([key], sel_t, ids.shape[0])[0]


@pytest.mark.parametrize("mode", ("binned", "sorted", "keyless"))
def test_families_match_per_group_python(mode):
    """K19's two passes, K20 and K1's bit kinds (plain versions, as the
    CPU runs them) against the reference's per-group Python, in the three
    context modes."""
    rng = np.random.default_rng(5)
    n, groups = 400, 7
    ids = rng.integers(0, groups, n)
    sel = rng.random(n) < 0.9
    x = rng.normal(size=n)
    y = rng.integers(-100, 100, n)
    xv = rng.random(n) < 0.85
    ctx = _ctx(mode, ids, groups, sel)
    slots = aggk.output_slots(ctx)
    # each slot's group: its smallest live id in sort mode (ids sorted)
    live = sel if mode != "keyless" else sel
    gid = np.zeros(n, dtype=np.int64) if mode == "keyless" else ids
    if mode == "sorted":
        order = sorted(set(ids[sel]))
        gid = np.array([order.index(v) if s else -1
                        for v, s in zip(ids, sel)])
    xt = aggk.Operand(torch.from_numpy(x), torch.from_numpy(xv))
    yt = aggk.Operand(torch.from_numpy(y), None)
    m = aggk.agg_moments(ctx, slots, xt, yt, 31)
    pick = aggk.agg_pick(ctx, slots, torch.from_numpy(y),
                         torch.from_numpy(xv), True)
    xor = aggk.agg_bit(ctx, aggk.Column(torch.from_numpy(y), torch.from_numpy(
        xv), None), "xor")
    for g in range(slots):
        rows = [r for r in range(n) if live[r] and gid[r] == g and xv[r]]
        pairs = [(x[r], float(y[r])) for r in rows]
        assert int(m["count"][g]) == len(rows)
        if rows:
            cov = HOST_AGGS["covar_pop"].impl(pairs)
            assert _floats_equal(float(m["ab"][g]) / len(rows), cov)
            assert _floats_equal(float(m["aa"][g]) / len(rows),
                                 np.var([p[0] for p in pairs]))
            best = max(rows, key=lambda r: y[r])
            assert int(pick[g]) == best
            want = 0
            for r in rows:
                want ^= int(y[r])
            assert int(xor.data[g]) == want and bool(xor.validity[g])


def test_constant_group_is_centred_exactly():
    """Three 0.1s: the first pass's mean is 0.10000000000000002, but the
    group's minimum equals its maximum, so it centres on 0.1 and its
    centred sums are exactly 0."""
    sel = torch.ones(3, dtype=torch.bool)
    ctx = aggk.group_rows([], sel, 1)[0]
    x = aggk.Operand(torch.full((3,), 0.1, dtype=torch.float64), None)
    m = aggk.agg_moments(ctx, 1, x, None, 1 | 8 | 16)
    assert float(m["sa"][0]) / 3 != 0.1
    assert float(m["aa"][0]) == float(m["aaa"][0]) == float(m["aaaa"][0]) == 0


def test_new_entry_points_match_their_c_signatures():
    """Each new C entry point's parameters against the ctypes argtypes
    csrc/__init__.py gives it."""
    for src, name in (("seg_moments.cu", "sail_seg_moments"),
                      ("seg_pick.cu", "sail_seg_pick")):
        text = (csrc._HERE / src).read_text()
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S)
        params = [p for p in sig.group(1).split(",") if p.strip()]
        assert len(params) == len(csrc._ENTRY[src][name]), name
    assert "seg_moments.cu" in csrc.SOURCES and "seg_pick.cu" in csrc.SOURCES
    text = (csrc._HERE / "seg_reduce.cu").read_text()
    assert "kAnd = 3, kOr = 4, kXor = 5" in text
    assert {aggk._KINDS[k] for k in ("and", "or", "xor")} == {3, 4, 5}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_new_kernels_build_from_the_sources(cuda):
    libs = csrc.build()
    for src in ("seg_moments.cu", "seg_pick.cu", "seg_reduce.cu"):
        assert src in libs
    assert csrc.entry("seg_moments.cu") is not None
    assert csrc.entry("seg_pick.cu") is not None


def _card_ctx(mode: str, groups: int, n: int, dev):
    gen = torch.Generator().manual_seed(groups)
    ids = torch.randint(0, groups, (n,), generator=gen)
    sel = torch.rand(n, generator=gen) < 0.95
    if mode == "keyless":
        return aggk.group_rows([], sel.to(dev), 1)[0]
    if mode == "binned":
        seg = torch.where(sel, ids, groups).to(torch.int32).to(dev)
        return aggk.GroupContext(sel.to(dev), groups, groups, seg_ids=seg,
                                 group_mask=torch.ones(groups, dtype=torch.bool,
                                                       device=dev))
    key = aggk.Column(ids.to(dev), None, None)
    return aggk.group_rows([key], sel.to(dev), n)[0]


# keyless is one group; K1's binned entry point takes at most BINNED_MAX
# bins (K2 makes at most 4096), K19 and K20 any number
_CARD_SHAPES = [(m, g) for m in ("binned", "sorted", "keyless")
                for g in (4, 100_000, 1_000_000)
                if not (m == "keyless" and g > 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,groups", _CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, mode, groups):
    n = 1_000_000
    ctx = _card_ctx(mode, groups, n, cuda)
    slots = aggk.output_slots(ctx)
    ids, rows = aggk.positions(ctx)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(n, generator=gen, dtype=torch.float64)
    y = torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen)
    ok = torch.rand(n, generator=gen) < 0.9
    a = aggk.Operand(x.to(cuda), ok.to(cuda))
    b = aggk.Operand(y.to(cuda), None, 2)
    got = aggk.seg_moments(ids, rows, slots, a, b)
    want = aggk.seg_moments_plain(ids, rows, slots, a, b)
    assert torch.equal(got[0], want[0])
    has = want[0] > 0
    for gt, wt in zip(got[1:], want[1:]):
        same_cv((gt[has], None), (wt[has], None), exact=False, rtol=1e-9)
    means = want[1] / want[0].clamp_min(1)[:, None].to(torch.float64)
    got = aggk.seg_centred(ids, rows, slots, a, b, means, 31)
    want = aggk.seg_centred_plain(ids, rows, slots, a, b, means, 31)
    same_cv((got, None), (want, None), exact=False, rtol=1e-9)
    keys = y.to(cuda)
    for is_max in (True, False):
        got = aggk.seg_pick(ids, rows, slots, keys, ok.to(cuda), is_max)
        want = aggk.seg_pick_plain(ids, rows, slots, keys, ok.to(cuda), is_max)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if mode == "binned" and groups > aggk.BINNED_MAX:
        return
    col = aggk.Column(y.to(cuda), ok.to(cuda), None)
    for kind in ("and", "or", "xor"):
        got = aggk.agg_bit(ctx, col, kind)
        if ctx.perm is not None:
            want, _ = aggk.seg_reduce_runs_plain(
                ctx.sorted_ids, ctx.perm, ctx.n_live, ctx.max_groups, kind,
                col.data, col.validity)
        else:
            want = aggk.seg_reduce_plain(col.data, ctx.seg_ids,
                                         ctx.max_groups, kind, col.validity)
        assert torch.equal(got.data, want)


# ---------------------------------------------------------------------------
# H1-H3 (benchmarks/host_agg_queries.py) at TPC-H SF 0.01
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    from sail_tpu_torch.benchmarks import tpch_data
    tables = tpch_data.generate_tpch_sf(0.01, seed=0)
    return tables, port_session(tables), reference_session(tables)


# H1's skewness and kurtosis over thousands of rows: the third and fourth
# centred sums cancel, and Python's (x - m) ** 3 rounds once where the
# product d * d * d rounds twice (chip_smoke.py's HOST_FLOAT_RTOL)
H_RTOL = 1e-9


@pytest.mark.parametrize("name", ["h1", "h1k", "h2", "h3"])
def test_h_query_matches_oracle_and_reference(tpch, name):
    """Each group held to the oracle (the copied per-group functions over
    pandas groups) and to the reference's answer, floats within
    ``H_RTOL``."""
    from sail_tpu_torch.benchmarks import host_agg_queries as hq
    tables, port, ref = tpch
    got = port.sql(hq.QUERIES[name]).toArrow()
    assert hq.check(got, hq.oracle(tables, name), name, H_RTOL) == \
        got.num_rows > 0
    want = ref.sql(hq.QUERIES[name]).toArrow()
    nk = len(hq.SPECS[name][0])
    ref_rows = {tuple(r.values())[:nk]: list(r.values())[nk:]
                for r in want.to_pylist()}
    assert len(ref_rows) == got.num_rows
    for r in got.to_pylist():
        vals = list(r.values())
        for (fn, _, _), g, w in zip(hq.SPECS[name][1], vals[nk:],
                                    ref_rows[tuple(vals[:nk])]):
            assert hq.same_answer(fn, g, w, H_RTOL), (name, fn, g, w)
