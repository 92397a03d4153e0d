"""The window's return to row order (``sail_tpu_torch/ops/window.py``
``window_unpermute``; on the CPU its plain version) against
``sail_tpu/ops/window.py`` run on the CPU with x64, for each of its three
sources: window.cuh records {value, ok}, a value column with its validity
(and plain words without one), and lag/lead's shift.

The same numpy inputs, made from a seed, build both packages' contexts;
the sorted values are the row-order values gathered through the
reference's ``perm``. The port's result equals the reference's ``_unsort``
of the same sorted values (its ``shift`` for lag/lead) on live rows:
values exactly where valid, the validity exactly; dead rows get 0 and
invalid (the reference leaves them undefined). The card's kernel is held
to this plain version by the ``gpu`` tests of ``test_torch_window_ops.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.columnar.batch import Column as JColumn
from sail_tpu.ops import window as jwin
from sail_tpu.spec import data_type as jdt
from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.ops import window as twin
from sail_tpu_torch.spec import data_type as tdt

_TYPES = {"int64": (jdt.LongType(), tdt.LongType()),
          "int32": (jdt.IntegerType(), tdt.IntegerType()),
          "float64": (jdt.DoubleType(), tdt.DoubleType()),
          "bool": (jdt.BooleanType(), tdt.BooleanType())}


def _contexts(n: int, live: str, seed: int = 3):
    """Both packages' contexts over n rows, partitioned by an int64 key of
    a few values (segments of ~n/6 rows) and ordered by an int64 with
    ties; ``live``: "most" (80% live), "none", "one" (every row dead but
    one) or "all"."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 6, n).astype(np.int64)
    order = rng.integers(0, 40, n).astype(np.int64)
    sel = {"most": rng.random(n) < 0.8, "none": np.zeros(n, bool),
           "all": np.ones(n, bool)}.get(live)
    if live == "one":
        sel = np.zeros(n, bool)
        sel[n // 3] = True
    long_j, long_t = _TYPES["int64"]
    jctx = jwin.build_window_context(
        [JColumn(jnp.asarray(part), None, long_j)],
        [(jnp.asarray(order), None, long_j, True, None)], jnp.asarray(sel))
    tctx = twin.build_window_context(
        [TColumn(torch.from_numpy(part), None, long_t)],
        [(torch.from_numpy(order), None, long_t, True, None)],
        torch.from_numpy(sel))
    np.testing.assert_array_equal(tctx.perm.numpy(), np.asarray(jctx.perm))
    return jctx, tctx, sel, rng


def _values(rng, n: int, dtype: str, nulls: bool):
    """A row-order column of ``dtype`` and its validity (None: no NULLs)."""
    if dtype == "float64":
        v = rng.normal(0, 100, n)
        v[: min(n, 3)] = [np.nan, np.inf, -np.inf][: min(n, 3)]
    elif dtype == "bool":
        v = rng.random(n) < 0.5
    else:
        v = rng.integers(-1000, 1000, n).astype(dtype)
    return v, (rng.random(n) < 0.7 if nulls else None)


def _check(sel, got, want_data, want_valid) -> None:
    """The port's (out, ok) against the reference's row-order data and
    validity: the validity on live rows, the data where valid (all live
    rows where there is no validity), 0 and invalid on dead rows."""
    out, ok = got
    data = out.numpy()
    wd = np.asarray(want_data)
    if want_valid is None:
        assert ok is None
        np.testing.assert_array_equal(data[sel], wd[sel])
    else:
        wv = np.asarray(want_valid)
        np.testing.assert_array_equal(ok.numpy()[sel], wv[sel])
        np.testing.assert_array_equal(data[sel & wv], wd[sel & wv])
        assert not ok.numpy()[~sel].any()
    assert not data[~sel].any()


_LIVE = ["most", "none", "one", "all"]


@pytest.mark.parametrize("live", _LIVE)
@pytest.mark.parametrize("dtype", ["int32", "float64"])
def test_records_match_unsort(live, dtype):
    """[n, 2] records {value, ok} in sorted order, as K10 and K11 write
    them: the reference's ``_unsort`` of the values and of the validity."""
    jctx, tctx, sel, rng = _contexts(300, live)
    v, ok = _values(rng, 300, dtype, True)
    recs = twin.pack_records(torch.from_numpy(v), torch.from_numpy(ok))
    got = twin.window_unpermute(tctx, recs)
    assert got[0].dtype == recs.dtype
    _check(sel, got, jwin._unsort(jctx, jnp.asarray(v)),
           jwin._unsort(jctx, jnp.asarray(ok)))


@pytest.mark.parametrize("live", _LIVE)
@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "bool"])
@pytest.mark.parametrize("nulls", [True, False], ids=["nulls", "words"])
def test_arrays_match_unsort(live, dtype, nulls):
    """A value column and its bool column in sorted order (no validity:
    plain words, and none comes back): the reference's ``_unsort`` of
    each."""
    jctx, tctx, sel, rng = _contexts(300, live)
    v, ok = _values(rng, 300, dtype, nulls)
    got = twin.window_unpermute(
        tctx, torch.from_numpy(v), None if ok is None else torch.from_numpy(ok))
    assert got[0].dtype == torch.from_numpy(v).dtype
    _check(sel, got, jwin._unsort(jctx, jnp.asarray(v)),
           None if ok is None else jwin._unsort(jctx, jnp.asarray(ok)))


# offsets within a segment (-3 to 3) and past it (segments hold ~50 rows;
# 299 and 10**6 pass every row)
_OFFSETS = (-3, -2, -1, 0, 1, 2, 3, 60, -60, 299, -10**6)


@pytest.mark.parametrize("live", _LIVE)
@pytest.mark.parametrize("default", [None, -7], ids=["no_default",
                                                     "default"])
@pytest.mark.parametrize("nulls", [True, False], ids=["nulls", "no_nulls"])
def test_shift_matches_reference(live, default, nulls):
    """lag/lead as the unpermute's source, over the sorted values and
    validity (``ctx.sorted_values``): the reference's ``shift`` of the
    row-order column, which unsorts its shifted sorted values, at every
    offset of _OFFSETS."""
    jctx, tctx, sel, rng = _contexts(300, live)
    v, ok = _values(rng, 300, "int64", nulls)
    long_j, long_t = _TYPES["int64"]
    tcol = TColumn(torch.from_numpy(v), None if ok is None else
                   torch.from_numpy(ok), long_t)
    jcol = JColumn(jnp.asarray(v), None if ok is None else jnp.asarray(ok),
                   long_j)
    vals_s, valid_s = tctx.sorted_values(tcol.data, tcol.validity)
    for offset in _OFFSETS:
        got = twin.window_unpermute(tctx, vals_s, valid_s,
                                    twin.Shift(offset, default))
        want = jwin.shift(jctx, jcol, offset, default)
        _check(sel, got, *want)
        for g, w in zip(got, twin.shift(tctx, tcol, offset, default)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["int32", "float64", "bool"])
def test_shift_of_other_types_matches_reference(dtype):
    """lag/lead over int32, float64 (NaN and infinities) and bool values
    with NULLs, with a default of the value's type and without."""
    jctx, tctx, sel, rng = _contexts(300, "most", seed=9)
    v, ok = _values(rng, 300, dtype, True)
    jt, tt = _TYPES[dtype]
    tcol = TColumn(torch.from_numpy(v), torch.from_numpy(ok), tt)
    jcol = JColumn(jnp.asarray(v), jnp.asarray(ok), jt)
    default = {"int32": 5, "float64": -2.5, "bool": True}[dtype]
    for offset in (-3, -1, 1, 3, 299):
        for d in (None, default):
            got = twin.shift(tctx, tcol, offset, d)
            assert got[0].dtype == tcol.data.dtype
            _check(sel, got, *jwin.shift(jctx, jcol, offset, d))


def test_sources_agree_with_each_other():
    """The three sources move the same sorted values alike: records, the
    two arrays, and a shift by 0 (each row its own value, no default)."""
    _, tctx, sel, rng = _contexts(500, "most", seed=17)
    v, ok = _values(rng, 500, "float64", True)
    vs, oks = torch.from_numpy(v), torch.from_numpy(ok)
    got = [twin.window_unpermute(tctx, twin.pack_records(vs, oks)),
           twin.window_unpermute(tctx, vs, oks),
           twin.window_unpermute(tctx, vs, oks, twin.Shift(0))]
    for out, valid in got[1:]:
        assert torch.equal(valid, got[0][1])
        np.testing.assert_array_equal(out.numpy(), got[0][0].numpy())
