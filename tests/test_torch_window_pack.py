"""The window context's sort over one packed word and K8 over sorted words
(``sail_tpu_torch/ops/window.py``: ``pack_layout``, ``window_pack``,
``sort_window_keys``, ``window_bounds``), K9's records, and lag, lead,
nth_value, first and last over each context, on the CPU through the plain
versions.

For every context below, the same numpy inputs (made from a seed) go
through the port and ``sail_tpu/ops/window.py`` ``build_window_context``:
the port's ``perm`` equals the reference's and the port's own
``lexsort_keys`` passes element for element, dead positions included; the
five bounds equal the through-``perm`` oracle of
``torch_window_common.bounds_through_perm`` everywhere and the reference's
on live rows; both key sources of K8 (the packed word, and each key
gathered into sorted order) give the same perm and bounds; K9's outputs
(records through ``inv_perm``) and lag/lead/nth/first/last (the sorted
values read in sorted order, one unpermute an output) equal the
reference's on live rows and are 0 on dead ones. All comparisons are
exact: positions and ranks are integers, and
percent_rank and cume_dist divide the same integers in float64. n = 0
runs on the port alone (the reference's context needs a row).
"""

import zlib

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
from sail_tpu_torch.ops.sort import lexsort_keys, order_keys
from sail_tpu_torch.spec import data_type as tdt
from torch_window_common import bounds_through_perm

_SPEC = {"float64": (jdt.DoubleType(), tdt.DoubleType()),
         "int32": (jdt.IntegerType(), tdt.IntegerType()),
         "int64": (jdt.LongType(), tdt.LongType())}

N = 300


def _ties(rng, lo, hi, n=N, dtype=np.int64):
    """n values drawn from a few between lo and hi, both ends among them."""
    pool = np.unique(np.r_[lo, hi, rng.integers(lo, hi, 6, endpoint=True)])
    return rng.choice(pool, n).astype(dtype)


def _case(name: str):
    """(partition keys, order keys, sel, whether they pack into one word).
    Keys as (data, validity, dtype name) and (data, validity, dtype name,
    ascending, nulls_first)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = {"empty": 0, "one_row": 1}.get(name, N)
    valid = lambda p: rng.random(n) < p  # noqa: E731
    sel = rng.random(n) < 0.8
    i32 = lambda lo, hi: _ties(rng, lo, hi, n, np.int32)  # noqa: E731
    i64 = lambda lo, hi: _ties(rng, lo, hi, n)  # noqa: E731
    fkey = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.0]), n)
    if name == "general":  # test_torch_window_ops' context
        part = [(fkey, valid(0.9), "float64"), (i32(0, 3), None, "int32")]
        order = [(i64(0, 5), valid(0.85), "int64", True, None),
                 (rng.normal(size=n), None, "float64", False, None)]
        return part, order, sel, False
    if name == "one_segment":
        return [], [(i64(0, 5), valid(0.85), "int64", True, None),
                    (rng.normal(size=n), None, "float64", False, None)], \
            sel, False
    if name in ("no_keys", "all_dead_no_keys"):
        return [], [], sel & (name == "no_keys"), True
    if name == "one_row":
        return [(i32(0, 3), valid(0.5), "int32")], \
            [(i64(-4, 9), None, "int64", False, None)], np.ones(1, bool), True
    if name == "empty":
        return [(i32(0, 3), None, "int32")], \
            [(i64(0, 5), valid(0.5), "int64", True, None)], sel, True
    if name.startswith("nullable"):
        # nulls first and last, ascending and descending
        nf = {"nullable_default": (None, None),
              "nullable_asc_last": (False, False),
              "nullable_desc_first": (True, True)}[name]
        part = [(i32(-7, 40), valid(0.8), "int32")]
        order = [(i64(-3, 3), valid(0.7), "int64", True, nf[0]),
                 (i64(10**6, 10**6 + 50), valid(0.9), "int64", False,
                  nf[1])]
        return part, order, sel, True
    if name == "float_nan_zero":
        return [(fkey, valid(0.9), "float64")], \
            [(i64(0, 9), None, "int64", True, None)], sel, False
    if name == "float_desc_ties":
        return [(i32(0, 4), None, "int32")], \
            [(rng.choice(np.array([1.0, -0.0, 0.0, np.nan, 2.5]), n),
              valid(0.9), "float64", False, None)], sel, False
    if name == "int64_extremes":
        info = np.iinfo(np.int64)
        return [(i32(0, 5), None, "int32")], \
            [(i64(info.min, info.max), None, "int64", True, None)], sel, \
            False
    if name == "one_value":  # width 0: only its null rank takes a bit
        return [(np.full(n, 7, np.int64), valid(0.6), "int64")], \
            [(i64(0, 3), None, "int64", False, None),
             (np.full(n, -5, np.int32), None, "int32", True, None)], \
            sel, True
    if name in ("bits_63", "bits_64"):
        # 20 + (41 + 1 null rank) + the dead bit = 63; one more value: 64
        top = 5 + (1 << 41) - (1 if name == "bits_63" else 0)
        return [(i32(0, (1 << 20) - 1), None, "int32")], \
            [(i64(5, top), valid(0.9), "int64", True, None)], sel, \
            name == "bits_63"
    if name == "all_dead":
        return [(i32(0, 3), valid(0.5), "int32")], \
            [(i64(0, 5), None, "int64", True, None)], \
            np.zeros(n, bool), True
    raise KeyError(name)


_NAMES = ["general", "one_segment", "no_keys", "one_row", "empty",
          "nullable_default", "nullable_asc_last", "nullable_desc_first",
          "float_nan_zero", "float_desc_ties", "int64_extremes", "one_value",
          "bits_63", "bits_64", "all_dead", "all_dead_no_keys"]


def _port(part, order, sel):
    """The port's context, and its K3 keys split into partition and order
    keys, as (key, validity, nulls_first)."""
    tparts = [TColumn(torch.from_numpy(d), None if v is None else
                      torch.from_numpy(v), _SPEC[t][1]) for d, v, t in part]
    torder = [(torch.from_numpy(d), None if v is None else torch.from_numpy(v),
               _SPEC[t][1], a, nf) for d, v, t, a, nf in order]
    ctx = twin.build_window_context(tparts, torder, torch.from_numpy(sel))
    pk = [(order_keys(c.data), c.validity, True) for c in tparts]
    ok = [(order_keys(d, a), v, a if nf is None else nf)
          for d, v, _, a, nf in torder]
    return ctx, pk, ok


def _reference(part, order, sel):
    jparts = [JColumn(jnp.asarray(d), None if v is None else jnp.asarray(v),
                      _SPEC[t][0]) for d, v, t in part]
    jorder = [(jnp.asarray(d), None if v is None else jnp.asarray(v),
               _SPEC[t][0], a, nf) for d, v, t, a, nf in order]
    jctx = jwin.build_window_context(jparts, jorder, jnp.asarray(sel))
    okbits = [(jorder_bits(d[jctx.perm], kdt, a),
               None if v is None else v[jctx.perm])
              for d, v, kdt, a, _ in jorder]
    return jctx, okbits


def _bounds(ctx):
    return (ctx.seg_start, ctx.seg_end, ctx.peer_start, ctx.peer_end,
            ctx.dense)


@pytest.mark.parametrize("name", _NAMES)
def test_packed_sort_matches_reference_and_passes(name):
    part, order, sel, fits = _case(name)
    ctx, pk, ok = _port(part, order, sel)
    assert ctx.packed == fits
    # today's passes: one stable sort a key, a validity and the dead rows
    np.testing.assert_array_equal(
        ctx.perm.numpy(), lexsort_keys(pk + ok, torch.from_numpy(sel)).numpy())
    for got, want in zip(_bounds(ctx), bounds_through_perm(
            ctx.perm, ctx.n_live, [(k, v) for k, v, _ in pk],
            [(k, v) for k, v, _ in ok])):
        assert torch.equal(got, want)
    if sel.shape[0] == 0:
        return
    jctx, okbits = _reference(part, order, sel)
    np.testing.assert_array_equal(ctx.perm.numpy(), np.asarray(jctx.perm))
    live = np.arange(sel.shape[0]) < int(sel.sum())
    seg_start = np.asarray(jctx.seg_start)
    seg_last = seg_start + np.asarray(jctx.seg_len) - 1
    np.testing.assert_array_equal(ctx.seg_start.numpy()[live],
                                  seg_start[live])
    np.testing.assert_array_equal(ctx.seg_end.numpy()[live], seg_last[live])
    # the reference's peer groups may run on into dead rows; clipped to
    # the segment they are the port's
    peer_end = np.minimum(np.asarray(jwin.peer_group_end(jctx, okbits)),
                          seg_last)
    np.testing.assert_array_equal(ctx.peer_end.numpy()[live], peer_end[live])
    np.testing.assert_array_equal(
        ctx.peer_start.numpy()[live],
        np.asarray(jwin._peer_group_start(jctx, okbits))[live])


@pytest.mark.parametrize("name", [n for n in _NAMES
                                  if n not in ("no_keys", "all_dead_no_keys")])
def test_both_key_sources_give_one_context(name):
    """The packed word and the keys gathered into sorted order give K8 the
    same perm and bounds; keys that do not fit refuse to pack."""
    part, order, sel, fits = _case(name)
    ctx, pk, ok = _port(part, order, sel)

    def source(packed):
        perm, words, was_packed, inv = twin.sort_window_keys(
            pk + ok, len(pk), torch.from_numpy(sel), ctx.n_live, packed)
        assert was_packed == packed
        # the general path gathers its keys through the inverse it built
        assert (inv is None) == packed
        assert packed or torch.equal(
            inv, twin.window_inverse_plain(perm, ctx.n_live))
        return perm, twin.window_bounds(ctx.n_live, words)

    general = source(False)
    if not fits:
        with pytest.raises(ValueError):
            source(True)
        return
    packed = source(True)
    assert torch.equal(packed[0], general[0])
    for got, want in zip(packed[1], general[1]):
        assert torch.equal(got, want)


def _reference_ranks(jctx, okbits, n_tiles):
    ss = np.asarray(jctx.seg_start)
    seg_len = np.asarray(jctx.seg_len)
    peer_end = np.minimum(np.asarray(jwin.peer_group_end(jctx, okbits)),
                          ss + seg_len - 1)
    # cume_dist over the peer groups clipped to the live rows (the
    # reference's own runs into dead rows: test_torch_window_ops'
    # test_cume_dist_stops_at_the_live_rows)
    cume = (peer_end - ss + 1) / np.maximum(seg_len, 1)
    return {"row_number": jwin.row_number(jctx),
            "rank": jwin.rank(jctx, okbits),
            "dense_rank": jwin.dense_rank(jctx, okbits),
            "percent_rank": jwin.percent_rank(jctx, okbits),
            "cume_dist": cume[np.asarray(jctx.inv_perm)],
            "ntile": jwin.ntile(jctx, n_tiles)}


@pytest.mark.parametrize("name", _NAMES)
def test_rank_forms_match_reference(name):
    part, order, sel, _ = _case(name)
    ctx, _, _ = _port(part, order, sel)
    got = twin.window_ranks(ctx, twin._RANKS, 3)
    for fn in twin._RANKS:
        assert got[fn].dtype == (torch.float64 if fn in (
            "percent_rank", "cume_dist") else torch.int64)
        assert not got[fn][~torch.from_numpy(sel)].any(), fn  # dead: 0
    if sel.shape[0] == 0:
        return
    jctx, okbits = _reference(part, order, sel)
    for fn, want in _reference_ranks(jctx, okbits, 3).items():
        np.testing.assert_array_equal(got[fn].numpy()[sel],
                                      np.asarray(want)[sel].astype(
                                          got[fn].numpy().dtype), err_msg=fn)


@pytest.mark.parametrize("name", _NAMES)
def test_shift_nth_first_last_match_reference(name):
    """lag (with a default), lead, nth_value to the last peer, and first
    and last over two frames, read from the sorted values: the
    reference's answers on live rows, 0 and invalid on dead ones."""
    part, order, sel, _ = _case(name)
    ctx, _, _ = _port(part, order, sel)
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    n = sel.shape[0]
    vals = rng.integers(-50, 50, n).astype(np.int64)
    valid = rng.random(n) < 0.8
    col = TColumn(torch.from_numpy(vals), torch.from_numpy(valid),
                  tdt.LongType())
    got = [twin.shift(ctx, col, 1, -7), twin.shift(ctx, col, -2),
           twin.nth(ctx, col, 2, ctx.peer_end),
           twin.framed_agg(ctx, col, "first", -1, 2),
           twin.framed_agg(ctx, col, "last", None, 0, ctx.peer_end)]
    for data, ok in got:
        assert not data.numpy()[~sel].any() and not ok.numpy()[~sel].any()
    if n == 0:
        return
    jctx, okbits = _reference(part, order, sel)
    jcol = JColumn(jnp.asarray(vals), jnp.asarray(valid), jdt.LongType())
    # the reference's peer groups may run on into dead rows: clipped to
    # the segment they are the port's
    ss = np.asarray(jctx.seg_start)
    peer = jnp.asarray(np.minimum(
        np.asarray(jwin.peer_group_end(jctx, okbits)),
        ss + np.asarray(jctx.seg_len) - 1))
    want = [jwin.shift(jctx, jcol, 1, -7), jwin.shift(jctx, jcol, -2),
            jwin.nth(jctx, jcol, 2, peer),
            jwin.framed_agg(jctx, jcol, "first", -1, 2),
            jwin.framed_agg(jctx, jcol, "last", None, 0, peer)]
    for (gd, gv), (wd, wv) in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_array_equal(gv.numpy()[sel], wv[sel])
        np.testing.assert_array_equal(gd.numpy()[sel & wv],
                                      np.asarray(wd)[sel & wv])


@pytest.mark.parametrize("wanted", [("row_number",), ("ntile",),
                                    ("rank", "cume_dist")])
def test_ranks_go_through_one_inverse_a_context(wanted, monkeypatch):
    """K9's records go to row order through the context's inv_perm, built
    once (window_inverse) and shared with the later window functions."""
    part, order, sel, _ = _case("nullable_default")
    ctx, _, _ = _port(part, order, sel)
    built = []
    inverse = twin.window_inverse

    def counted(perm, n_live, *args):
        built.append(perm)
        return inverse(perm, n_live, *args)

    monkeypatch.setattr(twin, "window_inverse", counted)
    first = twin.window_ranks(ctx, wanted, 2)
    second = twin.window_ranks(ctx, wanted, 2)
    col = TColumn(torch.arange(sel.shape[0]), None, tdt.LongType())
    twin.shift(ctx, col, 1)
    assert len(built) == 1 and built[0] is ctx.perm
    jctx, okbits = _reference(part, order, sel)
    want = _reference_ranks(jctx, okbits, 2)
    for fn in wanted:
        assert torch.equal(first[fn], second[fn])
        np.testing.assert_array_equal(
            first[fn].numpy()[sel],
            np.asarray(want[fn])[sel].astype(first[fn].numpy().dtype))


@pytest.mark.parametrize("name", ["nullable_default", "bits_63", "one_value",
                                  "no_keys"])
def test_pack_layout_fields(name):
    """The packed word: the dead bit on top, each key's null rank above its
    bits, the most significant key highest; the mask covers the dead bit
    and the partition fields only."""
    part, order, sel, _ = _case(name)
    _, pk, ok = _port(part, order, sel)
    keys = pk + ok
    layout = twin.pack_layout(keys, len(pk))
    word = twin.window_pack(keys, torch.from_numpy(sel), layout)
    assert bool((word >= 0).all())
    assert torch.equal(word >> layout.dead_shift,
                       (~torch.from_numpy(sel)).to(torch.int64))
    top = layout.dead_shift
    for j in reversed(range(len(keys))):
        key, valid, nulls_first = keys[j]
        width = (int(key.max()) - int(key.min())).bit_length()
        assert layout.lo[j] == int(key.min())
        bits = (word >> layout.shift[j]) & ((1 << width) - 1)
        assert torch.equal(bits, key - layout.lo[j])
        if valid is not None:
            rank = (word >> layout.vshift[j]) & 1
            assert layout.vshift[j] == layout.shift[j] + width
            assert torch.equal(rank.bool(), valid if nulls_first else ~valid)
    assert layout.part_mask >> top == 1
    low = min([layout.shift[j] for j in range(len(pk))] + [top])
    assert layout.part_mask == ((1 << (top + 1)) - 1) ^ ((1 << low) - 1)
