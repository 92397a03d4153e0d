"""Parity of the port's window functions (``sail_tpu_torch/ops/window.py``;
on the CPU, the kernels' plain versions) with ``sail_tpu/ops/window.py``
run on the CPU with x64: the same numpy inputs, made from a seed, on live
rows in row order (the reference leaves dead rows undefined; the port
writes 0, invalid).

Tolerances: integers, positions and MIN/MAX exactly; float64 sums and
averages within ``atol = 1e-12 * sum(|v|)`` plus ``rtol = 1e-12``
(torch_window_common). Three faults of the reference are held against
numpy instead (ROADMAP Queue C).

K10 and K11 read values gathered into sorted order once per context and
unpermute each output: the cache, ``inv_perm`` and the unpermute are held
to the reference's ``inv_perm`` and ``_unsort`` and to ``_scatter``; a
``gpu`` test holds the kernels to their plain versions at 100,000 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.columnar.batch import Column as JColumn
from sail_tpu.ops import window as jwin
from sail_tpu.ops.sort import order_bits as jorder_bits
from sail_tpu.spec import data_type as jdt
from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.ops import window as twin
from sail_tpu_torch.spec import data_type as tdt
from torch_window_common import FLOAT_RTOL, FLOAT_SUM_ATOL, close, identical

# ---------------------------------------------------------------------------
# ops: the port's functions against sail_tpu/ops/window.py
# ---------------------------------------------------------------------------


def _inputs(case: str):
    """Numpy inputs of one context: partition keys (float64 with NaN,
    -0.0, 0.0 and nulls; int32), order keys (int64 with ties and nulls,
    descending float), values, and a selection with dead rows."""
    rng = np.random.default_rng(11)
    n = {"empty": 0, "one_row": 1}.get(case, 300)
    pf = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.0]), n)
    pf_valid = rng.random(n) < 0.9
    pi = rng.integers(0, 4, n).astype(np.int32)
    ok = rng.integers(0, 6, n).astype(np.int64)
    ok_valid = rng.random(n) < 0.85
    of = rng.normal(size=n)
    sel = rng.random(n) < 0.8
    if case == "one_row":
        sel[:] = True
    part = [(pf, pf_valid, "float64"), (pi, None, "int32")]
    order = [(ok, ok_valid, "int64", True, None), (of, None, "float64",
                                                   False, None)]
    if case == "no_keys":
        part, order = [], []
    elif case == "one_segment":
        part = []
    vals = {
        "i64": (rng.integers(-50, 50, n).astype(np.int64), rng.random(n) < 0.8),
        "i32": (rng.integers(-9, 9, n).astype(np.int32), None),
        "f64": (rng.normal(0, 100, n), rng.random(n) < 0.9),
    }
    nan_vals = rng.normal(size=n)
    nan_vals[rng.random(n) < 0.05] = np.nan
    vals["f64nan"] = (nan_vals, None)
    return part, order, sel, vals


_SPEC = {"float64": (jdt.DoubleType(), tdt.DoubleType()),
         "int32": (jdt.IntegerType(), tdt.IntegerType()),
         "int64": (jdt.LongType(), tdt.LongType())}


def _both_contexts(part, order, sel):
    jparts = [JColumn(jnp.asarray(d), None if v is None else jnp.asarray(v),
                      _SPEC[t][0]) for d, v, t in part]
    tparts = [TColumn(torch.from_numpy(d), None if v is None else
                      torch.from_numpy(v), _SPEC[t][1]) for d, v, t in part]
    jorder = [(jnp.asarray(d), None if v is None else jnp.asarray(v),
               _SPEC[t][0], a, nf) for d, v, t, a, nf in order]
    torder = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v),
               _SPEC[t][1], a, nf) for d, v, t, a, nf in order]
    jctx = jwin.build_window_context(jparts, jorder, jnp.asarray(sel))
    tctx = twin.build_window_context(tparts, torder, torch.from_numpy(sel))
    okbits = [(jorder_bits(d[jctx.perm], kdt, a),
               None if v is None else v[jctx.perm])
              for d, v, kdt, a, _ in jorder]
    return jctx, tctx, okbits


def _same_on(rows, got, want, float_sum: bool = False) -> None:
    """got (torch) equals want (jax/numpy) at ``rows``."""
    g = got.numpy()[rows]
    w = np.asarray(want)[rows]
    if w.dtype.kind == "f":
        scale = np.nansum(np.abs(w[np.isfinite(w)])) if float_sum else 0.0
        np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL if float_sum else 0,
                                   atol=FLOAT_SUM_ATOL * scale,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def _same_result(sel, got, want, float_sum: bool = False) -> None:
    """(data, validity) of the port against the reference's, at live rows:
    the validity equal, the data where valid."""
    (gd, gv), (wd, wv) = got, want
    n = sel.shape[0]
    gvalid = np.ones(n, bool) if gv is None else gv.numpy()
    wvalid = np.ones(n, bool) if wv is None else np.asarray(wv)
    np.testing.assert_array_equal(gvalid[sel], wvalid[sel])
    _same_on(sel & wvalid, gd, wd, float_sum)


_CASES = ["general", "no_keys", "one_segment", "one_row"]


def test_no_rows_give_empty_outputs():
    """n = 0 (the reference's context needs a row: it sets flag 0)."""
    part, order, sel, vals = _inputs("empty")
    torder = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v),
               _SPEC[t][1], a, nf) for d, v, t, a, nf in order]
    tparts = [TColumn(torch.from_numpy(d), None if v is None else
                      torch.from_numpy(v), _SPEC[t][1]) for d, v, t in part]
    ctx = twin.build_window_context(tparts, torder, torch.from_numpy(sel))
    _, tcol = _column_pair(vals, "i64")
    outs = list(twin.window_ranks(ctx, twin._RANKS, 3).values())
    outs += list(twin.shift(ctx, tcol, 1, -1)) + list(twin.nth(ctx, tcol, 2))
    for fn in ("sum", "count", "avg", "min", "max", "first", "last"):
        for lower, upper in ((None, 0), (-2, 3), (1, None)):
            outs += [t for t in twin.framed_agg(ctx, tcol, fn, lower, upper)
                     if t is not None]
    assert outs and all(t.shape == (0,) for t in outs)


@pytest.mark.parametrize("case", _CASES)
def test_context_matches_reference(case):
    part, order, sel, _ = _inputs(case)
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    np.testing.assert_array_equal(tctx.perm.numpy(), np.asarray(jctx.perm))
    live = np.arange(sel.shape[0]) < int(sel.sum())
    _same_on(live, tctx.seg_start, jctx.seg_start)
    _same_on(live, tctx.seg_len, jctx.seg_len)
    _same_on(live, tctx.pos, jctx.pos)
    # the reference's peer groups may run on into dead rows; clipped to
    # the segment they are the port's
    seg_last = np.asarray(jctx.seg_start) + np.asarray(jctx.seg_len) - 1
    _same_on(live, twin.peer_group_end(tctx),
             np.minimum(np.asarray(jwin.peer_group_end(jctx, okbits)),
                        seg_last))


@pytest.mark.parametrize("case", _CASES)
def test_rank_family_matches_reference(case):
    part, order, sel, _ = _inputs(case)
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    _same_on(sel, twin.row_number(tctx), jwin.row_number(jctx))
    _same_on(sel, twin.rank(tctx, []), jwin.rank(jctx, okbits))
    _same_on(sel, twin.dense_rank(tctx, []), jwin.dense_rank(jctx, okbits))
    _same_on(sel, twin.percent_rank(tctx, []),
             jwin.percent_rank(jctx, okbits))
    # cume_dist: the reference's formula over its peer groups clipped to
    # the live rows (unclipped, they may run into dead rows: see
    # test_cume_dist_stops_at_the_live_rows)
    ss = np.asarray(jctx.seg_start)
    seg_len = np.asarray(jctx.seg_len)
    peer_end = np.minimum(np.asarray(jwin.peer_group_end(jctx, okbits)),
                          ss + seg_len - 1)
    cd = (peer_end - ss + 1) / np.maximum(seg_len, 1)
    _same_on(sel, twin.cume_dist(tctx, []), cd[np.asarray(jctx.inv_perm)])
    for k in (1, 3, 7, 400):
        _same_on(sel, twin.ntile(tctx, k), jwin.ntile(jctx, k))
    # one K9 call for the whole family gives the same columns
    together = twin.window_ranks(tctx, ("row_number", "rank", "ntile"), 3)
    _same_on(sel, together["ntile"], jwin.ntile(jctx, 3))
    _same_on(sel, together["rank"], jwin.rank(jctx, okbits))


def _column_pair(vals, name):
    d, v = vals[name]
    spec = _SPEC[str(d.dtype)]
    return (JColumn(jnp.asarray(d), None if v is None else jnp.asarray(v),
                    spec[0]),
            TColumn(torch.from_numpy(d), None if v is None else
                    torch.from_numpy(v), spec[1]))


@pytest.mark.parametrize("case", _CASES)
def test_shift_and_nth_match_reference(case):
    part, order, sel, vals = _inputs(case)
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    jcol, tcol = _column_pair(vals, "i64")
    for offset in (1, 2, -1, -3):
        for default in (None, -7):
            _same_result(sel, twin.shift(tctx, tcol, offset, default),
                         jwin.shift(jctx, jcol, offset, default))
    peer = jwin.peer_group_end(jctx, okbits)
    for n_th in (1, 2, 5):
        _same_result(sel, twin.nth(tctx, tcol, n_th),
                     jwin.nth(jctx, jcol, n_th))
        _same_result(sel, twin.nth(tctx, tcol, n_th, tctx.peer_end),
                     jwin.nth(jctx, jcol, n_th, peer))


# -- lag/lead, nth_value, first and last in sorted order -------------------

_DEC = (jdt.DecimalType(15, 2), tdt.DecimalType(15, 2))


def _value_column(data, valid, spec):
    return (JColumn(jnp.asarray(data), None if valid is None else
                    jnp.asarray(valid), spec[0]),
            TColumn(torch.from_numpy(data), None if valid is None else
                    torch.from_numpy(valid), spec[1]))


def _dead_rows_empty(sel, got) -> None:
    """A dead row gets 0 and invalid."""
    data, valid = got
    assert not data.numpy()[~sel].any() and not valid.numpy()[~sel].any()


# (offsets, default, value column); a decimal holds its unscaled int64 and
# takes a default already scaled (1.50 -> 150), as the executor gives it
_SHIFT_EDGES = {
    "past_segment_back": ((5, 40, 299, 300, 10**12), None, "i64"),
    "past_segment_forward": ((-5, -40, -299, -300, -10**12), -7, "i64"),
    "decimal_default": ((1, 3, -2), 150, "dec"),
    "nullable_default": ((1, -1, 2, -4), -7, "nullable"),
    "no_default_float": ((1, -2), None, "f64"),
    "zero_offset": ((0,), -7, "nullable"),
}


@pytest.mark.parametrize("case", list(_SHIFT_EDGES))
def test_shift_edges_match_reference(case):
    """lag/lead past the segment at both ends (and past every row), with
    and without a default, over a decimal, a nullable and a float column:
    the reference's answers on live rows, 0 and invalid on dead ones."""
    part, order, sel, vals = _inputs("general")
    jctx, tctx, _ = _both_contexts(part, order, sel)
    offsets, default, name = _SHIFT_EDGES[case]
    if name == "dec":
        jcol, tcol = _value_column(vals["i64"][0] * 25, vals["i64"][1], _DEC)
    elif name == "nullable":
        jcol, tcol = _column_pair(vals, "i64")
        assert tcol.validity is not None and not tcol.validity.all()
    else:
        jcol, tcol = _column_pair(vals, name)
    for offset in offsets:
        got = twin.shift(tctx, tcol, offset, default)
        _same_result(sel, got, jwin.shift(jctx, jcol, offset, default))
        _dead_rows_empty(sel, got)
        assert got[0].dtype == tcol.data.dtype


@pytest.mark.parametrize("case", ["all_dead", "no_rows"])
def test_shift_nth_first_last_without_live_rows(case):
    """Every row dead (n_live = 0), and n = 0: lag/lead (with a default),
    nth_value, first and last give 0 and invalid everywhere."""
    part, order, sel, vals = _inputs("empty" if case == "no_rows"
                                     else "general")
    sel = np.zeros_like(sel)
    torder = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v),
               _SPEC[t][1], a, nf) for d, v, t, a, nf in order]
    tparts = [TColumn(torch.from_numpy(d), None if v is None else
                      torch.from_numpy(v), _SPEC[t][1]) for d, v, t in part]
    ctx = twin.build_window_context(tparts, torder, torch.from_numpy(sel))
    _, tcol = _column_pair(vals, "i64")
    outs = [twin.shift(ctx, tcol, 1, -1), twin.shift(ctx, tcol, -2),
            twin.nth(ctx, tcol, 1), twin.nth(ctx, tcol, 2, ctx.peer_end)]
    outs += [twin.framed_agg(ctx, tcol, fn, lower, upper)
             for fn in ("first", "last")
             for lower, upper in ((None, 0), (-2, 3), (None, None))]
    for data, valid in outs:
        assert data.shape == valid.shape == sel.shape
        assert not data.any() and not valid.any()


def test_outputs_over_one_column_share_one_gather(monkeypatch):
    """lag, lead, nth_value, first and last over one column (W4's shape:
    two outputs over l_quantity) move it into sorted order once, and each
    matches the reference."""
    part, order, sel, vals = _inputs("general")
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    calls = _counting_gathers(monkeypatch)
    jcol, tcol = _column_pair(vals, "i64")
    peer = jwin.peer_group_end(jctx, okbits)
    pairs = [(twin.shift(tctx, tcol, 1, -7), jwin.shift(jctx, jcol, 1, -7)),
             (twin.shift(tctx, tcol, -2), jwin.shift(jctx, jcol, -2)),
             (twin.nth(tctx, tcol, 2, tctx.peer_end),
              jwin.nth(jctx, jcol, 2, peer))]
    for fn in ("first", "last"):
        pairs.append((twin.framed_agg(tctx, tcol, fn, -2, 1),
                      jwin.framed_agg(jctx, jcol, fn, -2, 1)))
    for got, want in pairs:
        _same_result(sel, got, want)
        _dead_rows_empty(sel, got)
    assert calls == [(tcol.data, tcol.validity)]


_FRAMES = [(-3, 2), (None, 0), (None, None), (0, None), (-2, None),
           (None, 3), (2, 5), (-1, -1), ("range", None, 0)]


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("frame", _FRAMES, ids=str)
def test_framed_agg_matches_reference(case, frame):
    part, order, sel, vals = _inputs(case)
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    jpeer = tpeer = None
    if frame[0] == "range":
        jpeer, tpeer = jwin.peer_group_end(jctx, okbits), tctx.peer_end
        frame = frame[1:]
    lower, upper = frame
    for name in ("i64", "i32", "f64", "f64nan"):
        jcol, tcol = _column_pair(vals, name)
        fns = ("min", "max", "first", "last") if name == "f64nan" else \
            ("sum", "count", "avg", "min", "max", "first", "last")
        for fn in fns:
            got = twin.framed_agg(tctx, tcol, fn, lower, upper, tpeer)
            want = jwin.framed_agg(jctx, jcol, fn, lower, upper, jpeer)
            _same_result(sel, got, want, float_sum=fn in ("sum", "avg"))
    got = twin.framed_agg(tctx, None, "count", lower, upper, tpeer)
    want = jwin.framed_agg(jctx, None, "count", lower, upper, jpeer)
    _same_result(sel, got, want)


def test_sorted_order_helpers_match_reference():
    rng = np.random.default_rng(3)
    part, order, sel, _ = _inputs("general")
    jctx, tctx, _ = _both_contexts(part, order, sel)
    n = sel.shape[0]
    vals = rng.normal(size=n)
    vals[rng.random(n) < 0.05] = np.nan
    live = np.arange(n) < int(sel.sum())
    for is_min in (True, False):
        _same_on(live,
                 twin._segmented_scan(torch.from_numpy(vals),
                                      tctx.seg_start, is_min),
                 jwin._segmented_scan(jnp.asarray(vals), jctx.seg_start,
                                      is_min))
    lo = rng.integers(0, n, n)
    hi = np.minimum(lo + rng.integers(-2, 40, n), n - 1)
    fill = np.inf
    for is_min in (True, False):
        _same_on(hi >= lo,
                 twin._range_extreme(torch.from_numpy(vals),
                                     torch.from_numpy(lo),
                                     torch.from_numpy(hi), n, is_min,
                                     fill if is_min else -fill),
                 jwin._range_extreme(jnp.asarray(vals), jnp.asarray(lo),
                                     jnp.asarray(hi), n, is_min,
                                     fill if is_min else -fill))
    valid = rng.random(n) < 0.7
    _same_on(hi >= lo,
             twin._segment_count(torch.from_numpy(valid), tctx,
                                 torch.from_numpy(lo), torch.from_numpy(hi),
                                 n),
             jwin._segment_count(jnp.asarray(valid), jctx, jnp.asarray(lo),
                                 jnp.asarray(hi), n))


# -- three faults of the reference, held against numpy ------------------------


def test_cume_dist_stops_at_the_live_rows():
    """The last live peer group ties with the first dead rows: the
    reference's peer group runs into them and its cume_dist passes 1;
    the port's ends at the live rows."""
    key = np.array([1, 2, 3, 3, 3, 3], dtype=np.int64)
    sel = np.array([True, True, True, True, False, False])
    jctx, tctx, okbits = _both_contexts(
        [], [(key, None, "int64", True, None)], sel)
    got = twin.cume_dist(tctx, []).numpy()[sel]
    np.testing.assert_array_equal(got, [0.25, 0.5, 1.0, 1.0])
    assert np.asarray(jwin.cume_dist(jctx, okbits))[sel].max() > 1.0


def test_float_sum_frames_stay_inside_their_segment():
    """A NaN in one segment: the reference's global cumsum carries it into
    every later segment's frames; the port's scan restarts per segment."""
    g = np.array([0, 0, 1, 1], dtype=np.int64)
    v = np.array([np.nan, 1.0, 2.0, 3.0])
    sel = np.ones(4, bool)
    jctx, tctx, _ = _both_contexts([(g, None, "int64")], [], sel)
    got, _ = twin.framed_agg(tctx, TColumn(torch.from_numpy(v), None,
                                           tdt.DoubleType()),
                             "sum", None, None)
    assert np.isnan(got.numpy()[:2]).all()
    np.testing.assert_array_equal(got.numpy()[2:], [5.0, 5.0])
    want, _ = jwin.framed_agg(jctx, JColumn(jnp.asarray(v), None,
                                            jdt.DoubleType()),
                              "sum", None, None)
    assert np.isnan(np.asarray(want)[2:]).all()


@pytest.mark.parametrize("first", [np.nan, np.inf])
def test_bounded_float_frames_read_only_their_rows(first):
    """A NaN or an infinity on a segment's first row: frames that no
    longer hold it are finite. The reference subtracts two prefixes of its
    cumsum, which both hold it, and gives NaN there."""
    v = np.array([first, 1.0, 2.0, 3.0])
    sel = np.ones(4, bool)
    jctx, tctx, _ = _both_contexts([], [], sel)
    tcol = TColumn(torch.from_numpy(v), None, tdt.DoubleType())
    jcol = JColumn(jnp.asarray(v), None, jdt.DoubleType())
    for lower, upper, fn, want in (
            (-1, 0, "sum", [first, first, 3.0, 5.0]),
            (-1, 0, "avg", [first, first, 1.5, 2.5]),
            (1, 2, "sum", [3.0, 5.0, 3.0, 0.0]),
            (-1, None, "avg", [np.nan if np.isnan(first) else np.inf] * 2
             + [2.0, 2.5])):
        got, valid = twin.framed_agg(tctx, tcol, fn, lower, upper)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(valid.numpy(), [True] * 3 + [
            upper is None or upper <= 0])
        if lower == -1 and upper == 0:
            ref, _ = jwin.framed_agg(jctx, jcol, fn, lower, upper)
            assert np.isnan(np.asarray(ref)[2:]).all()


# -- sorted order: the value cache, inv_perm and the unpermute ----------------


def _counting_gathers(monkeypatch) -> list:
    calls = []
    plain = twin.window_gather

    def counted(inv, vals, valid):
        calls.append((vals, valid))
        return plain(inv, vals, valid)

    monkeypatch.setattr(twin, "window_gather", counted)
    return calls


def test_sorted_values_are_gathered_once_per_column(monkeypatch):
    part, order, sel, vals = _inputs("general")
    jctx, tctx, _ = _both_contexts(part, order, sel)
    calls = _counting_gathers(monkeypatch)
    jcol, tcol = _column_pair(vals, "f64")
    # MIN and MAX of one column share one gather of value and validity
    for fn in ("min", "max"):
        _same_result(sel, twin.framed_agg(tctx, tcol, fn, -2, 2),
                     jwin.framed_agg(jctx, jcol, fn, -2, 2))
    assert len(calls) == 1
    assert calls[0][0] is tcol.data and calls[0][1] is tcol.validity
    vs, oks = tctx.sorted_values(tcol.data, tcol.validity)
    assert len(calls) == 1
    # the live positions' values; 0 and false at the dead ones
    perm, live = tctx.perm.numpy(), tctx.alive.numpy()
    np.testing.assert_array_equal(
        vs.numpy(), np.where(live, tcol.data.numpy()[perm], 0))
    np.testing.assert_array_equal(
        oks.numpy(), live & tcol.validity.numpy()[perm])
    # another column is gathered anew
    _, other = _column_pair(vals, "i64")
    twin.framed_agg(tctx, other, "min", -2, 2)
    assert len(calls) == 2 and calls[1][0] is other.data
    # the same values under another validity: the validity alone
    flipped = ~tcol.validity
    vs2, oks2 = tctx.sorted_values(tcol.data, flipped)
    assert len(calls) == 3 and calls[2] == (None, flipped)
    assert vs2 is vs
    np.testing.assert_array_equal(oks2.numpy(), live & ~oks.numpy())
    # the count scan of a validity reads the cached sorted validity
    np.testing.assert_array_equal(
        tctx.count_scan(flipped).numpy(),
        twin.window_scan_plain(tctx, None, oks2, "count").numpy())
    assert len(calls) == 3


@pytest.mark.parametrize("case", _CASES + ["empty"])
def test_inv_perm_inverts_perm(case):
    part, order, sel, _ = _inputs(case)
    if case == "empty":  # the reference's context needs a row
        tctx = twin.build_window_context(
            [TColumn(torch.from_numpy(d), None if v is None else
                     torch.from_numpy(v), _SPEC[t][1]) for d, v, t in part],
            [(torch.from_numpy(d), None if v is None else torch.from_numpy(v),
              _SPEC[t][1], a, nf) for d, v, t, a, nf in order],
            torch.from_numpy(sel))
        jctx = None
    else:
        jctx, tctx, _ = _both_contexts(part, order, sel)
    inv = tctx.inv_perm
    assert inv.dtype == torch.int32 and tctx.inv_perm is inv  # built once
    # a live row's sorted position, as argsort(perm) and the reference's
    # inv_perm give it; -1 for a dead row
    live_rows = tctx.perm.numpy()[:int(sel.sum())]
    want = np.full(sel.shape[0], -1)
    want[live_rows] = np.argsort(tctx.perm.numpy())[live_rows]
    np.testing.assert_array_equal(inv.numpy(), want)
    if jctx is not None:
        np.testing.assert_array_equal(inv.numpy()[live_rows],
                                      np.asarray(jctx.inv_perm)[live_rows])
    recs = twin.pack_records(torch.ones(sel.shape[0]),
                             torch.ones(sel.shape[0], dtype=torch.bool))
    out, ok = twin.window_unpermute(tctx, recs)
    np.testing.assert_array_equal(ok.numpy(), sel)
    np.testing.assert_array_equal(out.numpy(), sel.astype(float))


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_unpermute_matches_scatter_and_reference(dtype):
    part, order, sel, _ = _inputs("general")
    jctx, tctx, _ = _both_contexts(part, order, sel)
    rng = np.random.default_rng(5)
    n = sel.shape[0]
    if dtype.startswith("float"):
        v = rng.normal(0, 100, n).astype(dtype)
        v[:3] = [np.nan, np.inf, -np.inf]
    else:
        v = rng.integers(-1000, 1000, n).astype(dtype)
    ok = rng.random(n) < 0.7
    vs, oks = torch.from_numpy(v), torch.from_numpy(ok)
    recs = twin.pack_records(vs, oks)
    assert recs.shape == (n, 2) and recs.dtype == vs.dtype
    got, got_ok = twin.window_unpermute(tctx, recs)
    # live rows: the scatter's and the reference's rows; dead: 0, invalid
    live = tctx.alive
    np.testing.assert_array_equal(
        got.numpy(),
        twin._scatter(tctx.perm, torch.where(live, vs, 0)).numpy())
    np.testing.assert_array_equal(
        got_ok.numpy(), twin._scatter(tctx.perm, oks & live).numpy())
    np.testing.assert_array_equal(got.numpy()[sel],
                                  np.asarray(jwin._unsort(jctx, v))[sel])
    assert not got_ok.numpy()[~sel].any() and not got.numpy()[~sel].any()
    words, none = twin.window_unpermute(tctx, vs)
    assert none is None
    np.testing.assert_array_equal(words.numpy(), got.numpy())


@pytest.mark.parametrize("frame", _FRAMES, ids=str)
def test_all_null_values_match_reference(frame):
    part, order, sel, vals = _inputs("general")
    jctx, tctx, okbits = _both_contexts(part, order, sel)
    jpeer = tpeer = None
    if frame[0] == "range":
        jpeer, tpeer = jwin.peer_group_end(jctx, okbits), tctx.peer_end
        frame = frame[1:]
    lower, upper = frame
    null = np.zeros(sel.shape[0], bool)
    nulls = {name: (vals[name][0], null) for name in ("i64", "f64")}
    for name in nulls:
        jcol, tcol = _column_pair(nulls, name)
        for fn in ("sum", "count", "avg", "min", "max"):
            got = twin.framed_agg(tctx, tcol, fn, lower, upper, tpeer)
            want = jwin.framed_agg(jctx, jcol, fn, lower, upper, jpeer)
            _same_result(sel, got, want, float_sum=fn in ("sum", "avg"))
            if fn != "count":
                assert not bool(got[1].any())


def _frame_oracle(ctx, vals, valid, lower, upper, fn):
    """numpy, row by row in sorted order: fn over the valid values of the
    ROWS frame [i + lower, i + upper] clipped to the segment, added left
    to right; (out, ok) in row order, 0 where not ok."""
    perm = ctx.perm.numpy()
    ss, se = ctx.seg_start.numpy(), ctx.seg_end.numpy()
    n_live = int(ctx.n_live)
    n = perm.shape[0]
    out, ok = np.zeros(n), np.zeros(n, bool)
    for i in range(n_live):
        rows = perm[max(i + lower, ss[i]):min(i + upper, se[i]) + 1]
        x = vals[rows][valid[rows]]
        if x.size == 0:
            continue
        ok[perm[i]] = True
        if fn in ("min", "max"):
            r = np.nan if np.isnan(x).any() else (x.min() if fn == "min"
                                                  else x.max())
        else:
            r = 0.0
            for y in x:
                r = r + y
            if fn == "avg":
                r = r / x.size
        out[perm[i]] = r
    return out, ok


@pytest.mark.parametrize("frame", [(-2, 2), (1, 3), (-4, -1), (-40, 40)],
                         ids=str)
def test_bounded_float_frames_among_nan_and_inf(frame):
    """NaN, +inf and -inf among the values: each bounded frame combines
    only its own rows (a NaN or an infinity outside it does not reach it)."""
    part, order, sel, _ = _inputs("general")
    _, tctx, _ = _both_contexts(part, order, sel)
    rng = np.random.default_rng(17)
    n = sel.shape[0]
    v = rng.normal(0, 10, n)
    v[rng.choice(n, 12, replace=False)] = np.repeat([np.nan, np.inf,
                                                     -np.inf], 4)
    valid = rng.random(n) < 0.9
    col = TColumn(torch.from_numpy(v), torch.from_numpy(valid),
                  tdt.DoubleType())
    lower, upper = frame
    for fn in ("sum", "avg", "min", "max"):
        got, ok = twin.framed_agg(tctx, col, fn, lower, upper)
        want, want_ok = _frame_oracle(tctx, v, valid, lower, upper, fn)
        np.testing.assert_array_equal(ok.numpy(), want_ok)
        np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL,
                                   atol=0, equal_nan=True)


def _wide_inputs(n: int, groups: int, seed: int):
    """A context of n rows in ``groups`` partitions (several 1024-row
    tiles each) in a random order, int64 and float64 values."""
    rng = np.random.default_rng(seed)
    part = [(rng.integers(0, groups, n).astype(np.int64), None, "int64")]
    order = [(rng.permutation(n).astype(np.int64), None, "int64", True,
              None)]
    sel = rng.random(n) < 0.97
    vals = {"i64": (rng.integers(-10**6, 10**6, n).astype(np.int64),
                    rng.random(n) < 0.9),
            "f64": (rng.normal(0, 1e3, n), None)}
    return part, order, sel, vals


@pytest.mark.parametrize("frame", [(-1200, 300), (1, 1100), (-3000, 3000),
                                   (-1025, -1), (None, 0), (-700, None)],
                         ids=str)
def test_wide_frames_across_tiles_match_reference(frame):
    """Segments of about 2,400 rows (several 1024-row tiles) and frames
    wider than 1,025 rows (K11's chunked path on the card) crossing tile
    edges."""
    part, order, sel, vals = _wide_inputs(5000, 2, 23)
    jctx, tctx, _ = _both_contexts(part, order, sel)
    lower, upper = frame
    for name in ("i64", "f64"):
        jcol, tcol = _column_pair(vals, name)
        for fn in ("sum", "count", "avg", "min", "max"):
            got = twin.framed_agg(tctx, tcol, fn, lower, upper)
            want = jwin.framed_agg(jctx, jcol, fn, lower, upper)
            _same_result(sel, got, want, float_sum=fn in ("sum", "avg"))


# -- the card: each kernel of the sorted-order path against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the moves' shapes: (n, tile bytes); a bucket holds MOVE_CLUSTER tiles.
# The default tile (the inverse's 2^15 rows, its bucket 2^18): 5,000 rows
# are a single part bucket and the first tile of it, 100,000 three whole
# tiles and a part, 262,144 one whole bucket. A 64 B tile holds 16 rows:
# 300,001 rows make 2,344 buckets (two binning sweeps), 600,000 make 4,688
# (three).
_MOVE_SHAPES = [(100_000, twin.MOVE_TILE_BYTES), (5_000, twin.MOVE_TILE_BYTES),
                (262_144, twin.MOVE_TILE_BYTES), (300_001, 64), (600_000, 64),
                (300_001, 4096)]
_MOVE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                torch.float64)


def _check_moves(cuda, rng, order: str) -> None:
    """The inverse and the gather, torch.equal to their plain versions, at
    each of _MOVE_SHAPES and n_live of 0, 0.1%, 95% and all of n, perm
    ``order`` (random, identity or reversed), every value width with and
    without a validity, and a validity alone."""
    for n, tile in _MOVE_SHAPES:
        perm = {"random": torch.from_numpy(rng.permutation(n)),
                "identity": torch.arange(n),
                "reversed": torch.arange(n - 1, -1, -1)}[order].to(cuda)
        valid = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
        for n_live in (0, n // 1000, n * 95 // 100, n):
            live = torch.tensor(n_live, dtype=torch.int64, device=cuda)
            inv = twin.window_inverse(perm, live, tile)
            assert torch.equal(inv, twin.window_inverse_plain(perm, live)), \
                (n, tile, n_live)
            cases = [(None, valid)]
            for dtype in _MOVE_DTYPES:
                v = torch.from_numpy(rng.integers(-100, 100, n)).to(
                    cuda).to(dtype)
                cases += [(v, None), (v, valid)]
            for v, ok in cases:
                got = twin.window_gather(inv, v, ok, tile)
                want = twin.window_gather_plain(inv, v, ok)
                for g, w, t in zip(got, want, (v, ok)):
                    assert (g is None) == (t is None)
                    assert g is None or torch.equal(g, w), \
                        (n, tile, n_live, None if v is None else v.dtype)
                # the gather through perm at the live positions
                if v is not None:
                    at = torch.arange(n, device=cuda) < n_live
                    assert torch.equal(got[0][at], v[perm][at])


def _segments(cuda, rng, n: int, n_live: int) -> torch.Tensor:
    """seg_start (int32) of a context over n sorted positions: segments
    of 1 to 200 live positions, each dead position its own start (as K8
    writes it)."""
    starts = np.zeros(n, bool)
    cuts = np.cumsum(rng.integers(1, 200, n // 2 + 1))
    starts[cuts[cuts < n]] = True
    starts[0] = True
    starts[n_live:] = True
    idx = np.arange(n)
    seg = np.maximum.accumulate(np.where(starts, idx, 0))
    return torch.from_numpy(seg.astype(np.int32)).to(cuda)


def _check_unpermute(cuda, rng, order: str) -> None:
    """The unpermute's three sources, torch.equal to their plain version,
    at each of _MOVE_SHAPES and n_live of 0, 1, 0.1%, 95% and all of n,
    perm ``order``: records of 4- and 8-byte values; every value width as
    two arrays, with a validity and without (plain words); and the shift
    at offsets within and past the segments, with a default and without,
    over a column with NULLs and one without."""
    for n, tile in _MOVE_SHAPES:
        perm = {"random": torch.from_numpy(rng.permutation(n)),
                "identity": torch.arange(n),
                "reversed": torch.arange(n - 1, -1, -1)}[order].to(cuda)
        valid = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
        for n_live in (0, 1, n // 1000, n * 95 // 100, n):
            seg = _segments(cuda, rng, n, n_live)
            ctx = twin.WindowContext(
                perm, torch.tensor(n_live, dtype=torch.int64, device=cuda),
                seg, seg, seg, seg, seg)
            cases = []
            for dtype in (torch.int32, torch.float64):
                v = torch.from_numpy(rng.normal(0, 1e3, n)).to(cuda).to(dtype)
                cases.append((twin.pack_records(v, valid), None, None))
            for dtype in _MOVE_DTYPES + (torch.bool,):
                v = torch.from_numpy(rng.integers(-100, 100, n)).to(
                    cuda).to(dtype)
                cases += [(v, None, None), (v, valid, None)]
            v = torch.from_numpy(rng.integers(-10**12, 10**12, n)).to(cuda)
            for offset, default in ((1, -7), (-2, None), (3, None), (0, 5),
                                    (-3, 9), (250, None), (-n, -1)):
                cases += [(v, valid, twin.Shift(offset, default)),
                          (v, None, twin.Shift(offset, default))]
            small = torch.from_numpy(rng.integers(-100, 100, n)).to(cuda)
            for dtype in (torch.int8, torch.int16, torch.bool):
                cases.append((small.to(dtype), valid, twin.Shift(1, 1)))
            for src, ok, shift in cases:
                got = twin.window_unpermute(ctx, src, ok, shift, tile)
                want = twin.window_unpermute_plain(ctx, src, ok, shift)
                label = (n, tile, n_live, src.dtype, ok is None, shift)
                for g, w in zip(got, want):
                    assert (g is None) == (w is None), label
                    assert g is None or torch.equal(g, w), label


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["random", "identity", "reversed"])
def test_unpermute_sources_match_plain_on_card(cuda, order):
    """The partitioned scatter of each of the unpermute's sources
    (records, two arrays, lag/lead's shift) against its plain version at
    100,000 rows and the other move shapes, its bucket and sweep edges."""
    before = twin.window_unpermute.launches
    _check_unpermute(cuda, np.random.default_rng(21), order)
    assert twin.window_unpermute.launches > before


@pytest.mark.gpu
def test_sorted_order_kernels_match_plain_at_100k_rows(cuda):
    """The gather, the inverse permutation, K10's scan (every op, both
    directions) and frame evaluation, K11 (5 and 1,500 rows) and the
    unpermute at 100,000 rows in a random order, 5% of them
    dead, each against its plain version on the same inputs; lag, lead,
    nth_value, first and last against the CPU; and the inverse and the
    gather at their bucket edges (_check_moves) in a random, the identity
    and the reversed order."""
    rng = np.random.default_rng(8)
    n = 100_000
    sel = torch.from_numpy(rng.random(n) < 0.95).to(cuda)
    ctx = twin.build_window_context(
        [TColumn(torch.from_numpy(rng.integers(0, 700, n)).to(cuda), None,
                 tdt.LongType())],
        [(torch.from_numpy(rng.permutation(n)).to(cuda), None,
          tdt.LongType(), True, None)], sel)
    fv = torch.from_numpy(rng.normal(0, 1e3, n)).to(cuda)
    fv[::97] = float("nan")
    iv = torch.from_numpy(rng.integers(-1000, 1000, n)).to(cuda)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    launches = {k: getattr(twin, k).launches for k in (
        "window_gather", "window_inverse", "window_scan", "window_frame",
        "window_extreme", "window_unpermute")}

    assert torch.equal(ctx.inv_perm,
                       twin.window_inverse_plain(ctx.perm, ctx.n_live))
    fs, oks = twin.window_gather(ctx.inv_perm, fv, valid)
    is_, none = twin.window_gather(ctx.inv_perm, iv, None)
    want = twin.window_gather_plain(ctx.inv_perm, fv, valid)
    assert none is None and identical(fs, want[0])
    assert torch.equal(oks, want[1])
    assert torch.equal(is_, twin.window_gather_plain(ctx.inv_perm, iv,
                                                     None)[0])
    counts = twin.window_scan(ctx, None, oks, "count")
    assert torch.equal(counts, twin.window_scan_plain(ctx, None, oks,
                                                      "count"))
    for op, v in (("sum", is_), ("sum", fs), ("min", fs), ("max", is_)):
        for backward in (False, True):
            close(twin.window_scan(ctx, v, oks, op, backward),
                  twin.window_scan_plain(ctx, v, oks, op, backward),
                  fs if op == "sum" and v is fs else None)
    sums = twin.window_scan(ctx, is_, oks, "sum")
    back_max = twin.window_scan(ctx, fs, oks, "max", True)
    for scan, fn, lower, upper, peer, backward in (
            (sums, "avg", -6, 0, None, False),
            (sums, "sum", None, 0, ctx.peer_end, False),
            (None, "count", -3, 3, None, False),
            (back_max, "max", 2, None, None, True)):
        got = twin.window_frame(ctx, scan, counts, fn, lower, upper, peer,
                                backward)
        want = twin.window_frame_plain(ctx, scan, counts, fn, lower, upper,
                                       peer, backward)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or identical(g, w), (fn, lower, upper)
    for width in (5, 1500):
        lower, upper = -(width // 2), width // 2
        for fn, v in (("min", fs), ("max", is_), ("avg", fs)):
            got = twin.window_extreme(ctx, v, oks, counts, lower, upper, fn)
            want = twin.window_extreme_plain(ctx, v, oks, counts, lower,
                                             upper, fn)
            assert torch.equal(got[1], want[1]), (fn, width)
            if fn == "avg":
                close(got[0], want[0], fs)
            else:
                assert identical(got[0], want[0]), (fn, width)
    recs = twin.pack_records(fs, oks)
    want = twin.window_unpermute_plain(ctx, recs)
    got = twin.window_unpermute(ctx, recs)
    assert identical(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(twin.window_unpermute(ctx, is_)[0],
                       torch.where(sel, iv, 0))
    for name, before in launches.items():
        assert getattr(twin, name).launches > before, name
    # lag, lead, nth_value, first and last on the card against the CPU
    col = TColumn(iv, valid, tdt.LongType())
    cpu_ctx = twin.WindowContext(
        *[t.cpu() for t in (ctx.perm, ctx.n_live, ctx.seg_start, ctx.seg_end,
                            ctx.peer_start, ctx.peer_end, ctx.dense)])
    cpu_col = TColumn(iv.cpu(), valid.cpu(), tdt.LongType())
    for fn in (lambda c, v: twin.shift(c, v, 1, -7),
               lambda c, v: twin.shift(c, v, -3),
               lambda c, v: twin.nth(c, v, 2, c.peer_end),
               lambda c, v: twin.framed_agg(c, v, "first", -2, 1),
               lambda c, v: twin.framed_agg(c, v, "last", None, 0,
                                            c.peer_end)):
        for g, w in zip(fn(ctx, col), fn(cpu_ctx, cpu_col)):
            assert torch.equal(g.cpu(), w)
    for order in ("random", "identity", "reversed"):
        _check_moves(cuda, rng, order)
