"""Parity of the PyTorch port's kernels with the JAX reference.

Each kernel of ``sail_tpu_torch`` (segmented reduction, direct group ids,
order keys) and the operators built on it are fed the same numpy inputs,
made from a seed, as their ``sail_tpu`` counterparts. On the CPU the port
runs its plain PyTorch versions; the tests marked ``gpu`` hold the CUDA
kernels against those plain versions on the card.

Tolerances: integer results and min/max are exact; float64 sums agree to
a relative 1e-12 (FLOAT_RTOL), with an absolute 1e-9 (FLOAT_ATOL) for sums
that cancel to near zero: the two sides add in different orders (the
reference in row order, the port's plain versions in a segmented scan over
rows sorted by id, the kernels through atomics or a block-wide scan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.columnar.batch import Column as JColumn
from sail_tpu.ops import aggregate as jagg
from sail_tpu.ops import sort as jsort
from sail_tpu.spec import data_type as jdt
from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.ops import aggregate as tagg
from sail_tpu_torch.ops import sort as tsort
from sail_tpu_torch.spec import data_type as tdt

FLOAT_RTOL = 1e-12
FLOAT_ATOL = 1e-9

_TYPES = {  # numpy dtype → (reference spec type, port spec type)
    "bool": (jdt.BooleanType(), tdt.BooleanType()),
    "int8": (jdt.ByteType(), tdt.ByteType()),
    "int16": (jdt.ShortType(), tdt.ShortType()),
    "int32": (jdt.IntegerType(), tdt.IntegerType()),
    "int64": (jdt.LongType(), tdt.LongType()),
    "float32": (jdt.FloatType(), tdt.FloatType()),
    "float64": (jdt.DoubleType(), tdt.DoubleType()),
}


def _values(rng, dtype: str, n: int, nan: bool = False) -> np.ndarray:
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        v = rng.normal(0, 1e3, n).astype(dtype)
        v[rng.random(n) < 0.05] = 0.0
        v[rng.random(n) < 0.05] = -0.0
        v[rng.random(n) < 0.02] = np.inf
        v[rng.random(n) < 0.02] = -np.inf
        if nan:
            v[rng.random(n) < 0.05] = np.nan
        return v
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    v[: min(n, 2)] = [info.min, info.max][: min(n, 2)]
    return v


def _assert_equal(got: torch.Tensor, want, float_rtol: float = 0.0):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=float_rtol,
                                   atol=FLOAT_ATOL if float_rtol else 0,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


# ---------------------------------------------------------------------------
# K1: segmented reduction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_segments", [1, 13, 5000])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_seg_reduce_matches_reference(kind, dtype, num_segments):
    rng = np.random.default_rng(num_segments)
    n = 20_000
    vals = _values(rng, dtype, n, nan=True)
    # ids past either end are dead rows, dropped as the reference drops them
    seg = rng.integers(-2, num_segments + 2, n).astype(np.int32)
    want = jagg._seg_reduce(jnp.asarray(vals), jnp.asarray(seg),
                            num_segments, kind, 0)
    got = tagg.seg_reduce(torch.from_numpy(vals), torch.from_numpy(seg),
                          num_segments, kind)
    _assert_equal(got, want, FLOAT_RTOL)


def test_seg_reduce_nan_propagates_like_reference():
    vals = np.array([1.0, np.nan, 3.0, 2.0, np.nan, 5.0, np.nan])
    seg = np.array([0, 0, 0, 1, 1, 2, 3], dtype=np.int32)
    for kind in ("sum", "min", "max"):
        want = jagg._seg_reduce(jnp.asarray(vals), jnp.asarray(seg), 5,
                                kind, 0)
        got = tagg.seg_reduce(torch.from_numpy(vals), torch.from_numpy(seg),
                              5, kind)
        _assert_equal(got, want)
        assert np.isnan(got.numpy()[[0, 1, 3]]).all()


def _sorted_grouping(rng, n: int, n_live: int, groups: int):
    """(ids, perm) of a sort-based grouping: dense ids that never decrease
    over the live prefix, in runs of random length, dead rows (id n) after
    it; a random permutation."""
    ids = np.full(n, n, dtype=np.int32)
    if n_live:
        groups = max(1, min(groups, n_live))
        cuts = np.sort(rng.choice(np.arange(1, n_live), groups - 1,
                                  replace=False)) if groups > 1 else []
        starts = np.zeros(n_live, dtype=np.int32)
        starts[cuts] = 1
        ids[:n_live] = np.cumsum(starts)
    return ids, rng.permutation(n).astype(np.int64)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "index"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_seg_reduce_runs_plain_matches_reference(kind, dtype, nulls):
    """K1's runs version against the reference's _seg_reduce over the same
    gathered values (dtype "index": the value is the row index perm[i])."""
    rng = np.random.default_rng(23)
    n, n_live = 20_000, 15_000
    ids, perm = _sorted_grouping(rng, n, n_live, 2_000)
    valid = (rng.random(n) < 0.8) if nulls else None
    vals = None if dtype == "index" else _values(rng, dtype, n, nan=True)
    live = perm[:n_live]
    gathered = live if vals is None else vals[live]
    seg = ids[:n_live] if valid is None else \
        np.where(valid[live], ids[:n_live], n)
    want = jagg._seg_reduce(jnp.asarray(gathered), jnp.asarray(seg), n,
                            kind, 0)
    want_cnt = jagg._seg_sum(jnp.ones(n_live, dtype=jnp.int64),
                             jnp.asarray(seg), n)
    got, cnt = tagg.seg_reduce_runs(
        torch.from_numpy(ids), torch.from_numpy(perm), torch.tensor(n_live),
        n, kind, None if vals is None else torch.from_numpy(vals),
        None if valid is None else torch.from_numpy(valid), counts=True)
    _assert_equal(got, want, FLOAT_RTOL)
    _assert_equal(cnt, want_cnt)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_seg_reduce_runs_plain_fewer_segments_than_groups(kind):
    """A caller that asks for fewer segments than there are groups gets
    the first num_segments groups; the rest are dropped, as the
    reference's _seg_reduce drops ids at or past num_segments."""
    rng = np.random.default_rng(29)
    n, n_live, num_segments = 20_000, 15_000, 500
    ids, perm = _sorted_grouping(rng, n, n_live, 2_000)
    vals = _values(rng, "int64", n)
    valid = rng.random(n) < 0.8
    live = perm[:n_live]
    seg = np.where(valid[live], ids[:n_live], n)
    want = jagg._seg_reduce(jnp.asarray(vals[live]), jnp.asarray(seg),
                            num_segments, kind, 0)
    want_cnt = jagg._seg_sum(jnp.ones(n_live, dtype=jnp.int64),
                             jnp.asarray(seg), num_segments)
    got, cnt = tagg.seg_reduce_runs(
        torch.from_numpy(ids), torch.from_numpy(perm), torch.tensor(n_live),
        num_segments, kind, torch.from_numpy(vals), torch.from_numpy(valid),
        counts=True)
    _assert_equal(got, want)
    _assert_equal(cnt, want_cnt)


@pytest.mark.parametrize("n_live", [0, 1, 999, 1000])
def test_seg_reduce_runs_plain_count_only(n_live):
    """No value: only the count, and slots past the last group hold 0."""
    rng = np.random.default_rng(n_live)
    ids, perm = _sorted_grouping(rng, 1000, n_live, 37)
    out, cnt = tagg.seg_reduce_runs(torch.from_numpy(ids),
                                    torch.from_numpy(perm),
                                    torch.tensor(n_live), 1000, None,
                                    counts=True)
    assert out is None
    _assert_equal(cnt, np.bincount(ids[:n_live], minlength=1000))


# ---------------------------------------------------------------------------
# K2: direct group ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nulls", [False, True])
def test_group_rows_direct_matches_reference(nulls):
    rng = np.random.default_rng(3)
    n = 5000
    codes = rng.integers(-1, 4, n).astype(np.int32)  # clipped to [0, 2]
    flags = rng.random(n) < 0.5
    valid = (rng.random(n) < 0.8) if nulls else None
    sel = rng.random(n) < 0.7
    jcols = [JColumn(jnp.asarray(codes),
                     None if valid is None else jnp.asarray(valid),
                     jdt.StringType()),
             JColumn(jnp.asarray(flags), None, jdt.BooleanType())]
    tcols = [TColumn(torch.from_numpy(codes),
                     None if valid is None else torch.from_numpy(valid),
                     tdt.StringType()),
             TColumn(torch.from_numpy(flags), None, tdt.BooleanType())]
    jctx, _ = jagg.group_rows_direct(jcols, [3, 2], jnp.asarray(sel))
    tctx, _ = tagg.group_rows_direct(tcols, [3, 2], torch.from_numpy(sel))
    _assert_equal(tctx.seg_ids, jctx.seg_ids)
    _assert_equal(tagg.group_sel(tctx), jagg.group_sel(jctx))
    assert tctx.max_groups == jctx.max_groups == 12


# ---------------------------------------------------------------------------
# K3: order keys, and the sort built on them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", list(_TYPES))
def test_order_keys_bit_equal_to_reference(dtype, ascending):
    rng = np.random.default_rng(11)
    vals = _values(rng, dtype, 3000, nan=True)
    jtype, _ = _TYPES[dtype]
    want = np.asarray(jsort.order_bits(jnp.asarray(vals), jtype, ascending))
    got = tsort.order_keys(torch.from_numpy(vals), ascending).numpy()
    np.testing.assert_array_equal(
        got.view(np.uint64), want ^ np.uint64(1 << 63))


def _sort_keys(rng, n):
    """(numpy data, validity) of three key columns with ties and nulls."""
    return [
        (rng.integers(0, 5, n).astype(np.int32), rng.random(n) < 0.8),
        (rng.normal(0, 1, n).round(1), None),
        (rng.integers(0, 3, n).astype(np.int64), rng.random(n) < 0.9),
    ]


@pytest.mark.parametrize("nulls_first", [None, True, False])
@pytest.mark.parametrize("ascending", [True, False])
def test_lexsort_perm_matches_reference(ascending, nulls_first):
    rng = np.random.default_rng(5)
    n = 2000
    cols = _sort_keys(rng, n)
    sel = rng.random(n) < 0.75
    types = ["int32", "float64", "int64"]
    jkeys, tkeys = [], []
    for (d, v), t, asc in zip(cols, types, [ascending, not ascending, True]):
        jkeys.append((jnp.asarray(d), None if v is None else jnp.asarray(v),
                      _TYPES[t][0], asc, nulls_first))
        tkeys.append((torch.from_numpy(d),
                      None if v is None else torch.from_numpy(v),
                      _TYPES[t][1], asc, nulls_first))
    want = jsort.lexsort_perm(jkeys, jnp.asarray(sel))
    got = tsort.lexsort_perm(tkeys, torch.from_numpy(sel))
    _assert_equal(got, want)


# ---------------------------------------------------------------------------
# aggregates over both grouping modes
# ---------------------------------------------------------------------------

def _agg_inputs(seed: int, shape: str = "default"):
    """Inputs of the aggregate tests. ``shape`` (sorted mode only): "dead"
    followed by the share of dead rows in percent, "empty" (no rows),
    "one-group" (every row live in one group) or "row-groups" (every row
    live in a group of its own)."""
    rng = np.random.default_rng(seed)
    n = 0 if shape == "empty" else 3000
    x = dict(
        codes=rng.integers(0, 6, n).astype(np.int32),
        code_valid=rng.random(n) < 0.9,
        sel=rng.random(n) < 0.8,
        ints=rng.integers(-10**12, 10**12, n),
        int_valid=rng.random(n) < 0.85,
        floats=_values(rng, "float64", n, nan=False),
        flags=rng.random(n) < 0.5,
    )
    if shape.startswith("dead"):
        x["sel"] = rng.random(n) >= int(shape[4:]) / 100
    elif shape in ("one-group", "row-groups"):
        x["sel"] = np.ones(n, dtype=bool)
        x["code_valid"] = np.ones(n, dtype=bool)
        x["codes"] = np.full(n, 3, dtype=np.int32) if shape == "one-group" \
            else rng.permutation(n).astype(np.int32)
    return x


def _contexts(x, mode):
    """(reference context and keys, port context and keys); the reference's
    is None on no rows, where its grouping (which indexes row 0) raises."""
    jkey = JColumn(jnp.asarray(x["codes"]), jnp.asarray(x["code_valid"]),
                   jdt.StringType())
    tkey = TColumn(torch.from_numpy(x["codes"]),
                   torch.from_numpy(x["code_valid"]), tdt.StringType())
    jsel, tsel = jnp.asarray(x["sel"]), torch.from_numpy(x["sel"])
    if mode == "direct":
        return (jagg.group_rows_direct([jkey], [6], jsel),
                tagg.group_rows_direct([tkey], [6], tsel))
    n = len(x["sel"])
    if mode == "keyless":
        return jagg.group_rows([], jsel, 1), tagg.group_rows([], tsel, 1)
    port = tagg.group_rows([tkey], tsel, n)
    return (jagg.group_rows([jkey], jsel, n) if n else None), port


def _agg_outputs(agg, dtypes, column, ctx, keys, x):
    """(group keys, aggregate outputs, group selection) of one package:
    ``agg``, its data types module and its Column over inputs ``x``."""
    def col(name, valid, dtype):
        to = jnp.asarray if agg is jagg else torch.from_numpy
        return column(to(x[name]), None if valid is None else to(x[valid]),
                      dtype)
    ints = col("ints", "int_valid", dtypes.LongType())
    flts = col("floats", None, dtypes.DoubleType())
    flags = col("flags", None, dtypes.BooleanType())
    outs = [
        agg.agg_count(ctx, None), agg.agg_count(ctx, ints),
        agg.agg_sum(ctx, ints, dtypes.LongType()),
        agg.agg_sum(ctx, flts, dtypes.DoubleType()),
        agg.agg_min_max(ctx, ints, True), agg.agg_min_max(ctx, flts, False),
        agg.agg_min_max(ctx, flags, True),
        agg.agg_first_last(ctx, ints, True),
        agg.agg_first_last(ctx, ints, False, ignore_nulls=False),
        agg.agg_first_last(ctx, ints, True, ignore_nulls=False),
        agg.agg_first_last(ctx, ints, False),
    ]
    return ([(c.data, c.validity) for c in agg.group_key_output(ctx, keys)],
            [(o.data, o.validity) for o in outs], agg.group_sel(ctx))


def _rows(ctx_keys, outs, sel):
    """Live groups as sorted (key..., value...) tuples."""
    sel = np.asarray(sel)
    cols = []
    for d, v in ctx_keys + outs:
        d, v = np.asarray(d), None if v is None else np.asarray(v)
        cols.append([None if (v is not None and not v[i]) else
                     (float(d[i]) if d.dtype.kind == "f" else d[i].item())
                     for i in range(len(d))])
    return sorted((tuple(c[i] for c in cols) for i in range(len(sel))
                   if sel[i]), key=repr)


_SORTED_SHAPES = ["dead0", "dead85", "dead96", "dead100", "empty",
                  "one-group", "row-groups"]


@pytest.mark.parametrize("mode,shape", [
    pytest.param("direct", "default", id="direct"),
    pytest.param("sorted", "default", id="sorted"),
    pytest.param("keyless", "default", id="keyless"),
] + [pytest.param("sorted", shape, id=f"sorted-{shape}")
     for shape in _SORTED_SHAPES])
def test_aggregates_match_reference(mode, shape):
    x = _agg_inputs(17, shape)
    ref, (tctx, tkeys) = _contexts(x, mode)
    tk, touts, tsel = _agg_outputs(tagg, tdt, TColumn, tctx, tkeys, x)
    got = _rows(tk, touts, tsel)
    if ref is None:  # no rows: no group, and every output is empty
        assert got == [] and all(d.shape == (0,) for d, _ in tk + touts)
        return
    jk, jouts, jsel = _agg_outputs(jagg, jdt, JColumn, *ref, x)
    want = _rows(jk, jouts, jsel)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=FLOAT_RTOL, abs=FLOAT_ATOL) or \
                    (np.isnan(a) and np.isnan(b))
            else:
                assert a == b


@pytest.mark.parametrize("mode", ["direct", "sorted", "keyless"])
def test_sum_and_count_share_counts(mode):
    """SUM and COUNT of one column (AVG) take their counts from one
    reduction: the context keeps the counts by validity."""
    x = _agg_inputs(29)
    _, (ctx, _) = _contexts(x, mode)
    col = TColumn(torch.from_numpy(x["ints"]),
                  torch.from_numpy(x["int_valid"]), tdt.LongType())
    total = tagg.agg_sum(ctx, col, tdt.LongType())
    count = tagg.agg_count(ctx, col)
    assert count.data is ctx.counts_for(col.validity)
    assert torch.equal(total.validity, count.data > 0)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("num_segments", [13, tagg.BINNED_MAX])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_seg_reduce_kernel_matches_plain(cuda, kind, dtype, num_segments):
    rng = np.random.default_rng(1)
    n = 1_000_003
    vals = torch.from_numpy(_values(rng, dtype, n, nan=kind != "sum")).to(cuda)
    seg = torch.from_numpy(
        rng.integers(-1, num_segments + 1, n).astype(np.int32)).to(cuda)
    before = tagg.seg_reduce.launches
    got = tagg.seg_reduce(vals, seg, num_segments, kind)
    assert tagg.seg_reduce.launches == before + 1
    want = tagg.seg_reduce_plain(vals, seg, num_segments, kind)
    _assert_equal(got.cpu(), want.cpu().numpy(), FLOAT_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("num_segments", [12, 4096])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_seg_reduce_kernel_validity_matches_plain(cuda, kind, dtype,
                                                  num_segments):
    """The binned kernel with a validity, dead rows at id S (dropped)."""
    rng = np.random.default_rng(5)
    n = 1_000_003
    vals = torch.from_numpy(_values(rng, dtype, n, nan=kind != "sum")).to(cuda)
    seg = torch.from_numpy(
        rng.integers(0, num_segments + 1, n).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    before = tagg.seg_reduce.launches
    got = tagg.seg_reduce(vals, seg, num_segments, kind, valid)
    assert tagg.seg_reduce.launches == before + 1
    want = tagg.seg_reduce_plain(vals, seg, num_segments, kind, valid)
    _assert_equal(got.cpu(), want.cpu().numpy(), FLOAT_RTOL)


@pytest.mark.gpu
def test_seg_reduce_kernel_refuses_more_segments_than_it_bins(cuda):
    """The binned kernel keeps its bins in shared memory; past BINNED_MAX
    it raises and launches nothing (sort-based grouping, where S is the
    row count, reduces through seg_reduce_runs)."""
    vals = torch.ones(1000, dtype=torch.int64, device=cuda)
    seg = torch.zeros(1000, dtype=torch.int32, device=cuda)
    before = tagg.seg_reduce.launches
    with pytest.raises(ValueError, match="at most"):
        tagg.seg_reduce(vals, seg, tagg.BINNED_MAX + 1, "sum")
    assert tagg.seg_reduce.launches == before


# the runs kernel's tile (kTile in csrc/seg_reduce.cu); its grid splits
# the live prefix into contiguous ranges of whole tiles, one a block
_TILE = 1024
_RUNS_N = 1_000_003
# (n_live, run length: an int, or "random" lengths 1-2000[, segments:
# _RUNS_N unless given])
_RUNS_CASES = {
    "one segment": (_RUNS_N, _RUNS_N),
    "runs of 1": (_RUNS_N, 1),
    "cut by one tile edge": (_RUNS_N, "random"),
    "cut by many tile edges": (_RUNS_N, 50_000),
    "85% dead": (150_000, "random"),
    "n_live 0": (0, 1),
    "n_live 1": (1, 1),
    "n_live tile - 1": (_TILE - 1, 7),
    "n_live tile + 1": (_TILE + 1, 7),
    "n_live 200 tiles - 1": (200 * _TILE - 1, "random"),
    "n_live 200 tiles + 1": (200 * _TILE + 1, "random"),
    # 20,001 groups: the groups at or past S are dropped
    "5000 segments, fewer than the groups": (_RUNS_N, 50, 5000),
}


def _runs_grouping(rng, n_live: int, run):
    ids = np.full(_RUNS_N, _RUNS_N, dtype=np.int32)
    if run == "random":
        lengths = rng.integers(1, 2001, n_live // 500 + 2)
    else:
        lengths = np.full(n_live // run + 1, run)
    ids[:n_live] = np.repeat(np.arange(len(lengths), dtype=np.int32),
                             lengths)[:n_live]
    return ids, rng.permutation(_RUNS_N).astype(np.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int64", "float64", "index",
                                   "count"])
@pytest.mark.parametrize("case", list(_RUNS_CASES))
def test_seg_reduce_runs_kernel_matches_plain(cuda, case, dtype):
    """The runs kernel at its tile and block edges, every kind, with a
    validity and counts ("index": the value is the row index; "count": no
    value)."""
    rng = np.random.default_rng(len(case))
    n_live, run, *segments = _RUNS_CASES[case]
    num_segments = segments[0] if segments else _RUNS_N
    ids, perm = _runs_grouping(rng, n_live, run)
    ids, perm = torch.from_numpy(ids).to(cuda), torch.from_numpy(perm).to(cuda)
    n_live = torch.tensor(n_live, device=cuda)
    valid = torch.from_numpy(rng.random(_RUNS_N) < 0.9).to(cuda)
    vals = None
    if dtype not in ("index", "count"):
        vals = torch.from_numpy(_values(rng, dtype, _RUNS_N)).to(cuda)
    for kind in ([None] if dtype == "count" else ["sum", "min", "max"]):
        if dtype == "index" and kind == "sum":
            continue
        for v in (None, valid):
            args = (ids, perm, n_live, num_segments, kind, vals, v, True)
            before = tagg.seg_reduce_runs.launches
            got = tagg.seg_reduce_runs(*args)
            assert tagg.seg_reduce_runs.launches == before + 1
            want = tagg.seg_reduce_runs_plain(*args)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    _assert_equal(g.cpu(), w.cpu().numpy(), FLOAT_RTOL)


@pytest.mark.gpu
def test_sorted_sum_and_count_make_one_launch(cuda):
    """In sort mode AVG's SUM and COUNT are one runs launch, the group
    keys another; nothing goes through the binned kernel."""
    x = _agg_inputs(31)
    key = TColumn(torch.from_numpy(x["codes"]).to(cuda),
                  torch.from_numpy(x["code_valid"]).to(cuda), tdt.StringType())
    col = TColumn(torch.from_numpy(x["ints"]).to(cuda),
                  torch.from_numpy(x["int_valid"]).to(cuda), tdt.LongType())
    sel = torch.from_numpy(x["sel"]).to(cuda)
    runs, binned = tagg.seg_reduce_runs.launches, tagg.seg_reduce.launches
    ctx, keys = tagg.group_rows([key], sel, sel.shape[0])
    tagg.group_key_output(ctx, keys)
    tagg.agg_sum(ctx, col, tdt.LongType())
    tagg.agg_count(ctx, col)
    assert tagg.seg_reduce_runs.launches == runs + 2
    assert tagg.seg_reduce.launches == binned


@pytest.mark.gpu
def test_direct_group_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    n = 1_000_003
    codes = torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    flags = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    sel = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    got = tagg.direct_group_ids([codes, flags], [valid, None], [3, 2], sel)
    want = tagg.direct_group_ids_plain([codes, flags], [valid, None], [3, 2],
                                       sel)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dtype", list(_TYPES))
def test_order_keys_kernel_matches_plain(cuda, dtype, ascending):
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(_values(rng, dtype, 1_000_003, nan=True)).to(cuda)
    got = tsort.order_keys(vals, ascending)
    assert torch.equal(got, tsort.order_keys_plain(vals, ascending))
