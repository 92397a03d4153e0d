"""Parity of the port's window functions (``sail_tpu_torch/ops/window.py``;
on the CPU, the kernels' plain versions) with ``sail_tpu/ops/window.py``
run on the CPU with x64: the same numpy inputs, made from a seed, on live
rows in row order (the reference leaves dead rows undefined; the port
writes 0, invalid).

Tolerances: integers, positions and MIN/MAX exactly; float64 sums and
averages within ``atol = 1e-12 * sum(|v|)`` plus ``rtol = 1e-12``
(torch_window_common). Three faults of the reference are held against
numpy instead (ROADMAP Queue C).
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
from torch_window_common import FLOAT_RTOL, FLOAT_SUM_ATOL

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
