"""K18 and the packed sort on the CPU, against the reference.

K18 (``sail_tpu_torch/ops/chain.py`` ``run_chain_sort_plain``, the plain
version of the chain's kernel that writes each row's sort words) over keys
of every type a sort or grouping takes: bool, int8-int64, float32 and
float64 with NaN and -0.0, dates, decimals and dictionary codes (through
a rank table, as a sort's string key is), both directions, NULLs first
and last, with dead rows from the selection and from a filter. Its words
equal the reference's ``order_bits(data, d, asc)``
(``sail_tpu/ops/sort.py:48``, run by JAX on the CPU) XOR (1 << 63)
exactly on live non-null rows, and its extremes the words' least and
greatest over the live rows (a grouping's key: its live non-null rows).

The packed sort (``ops/sort.py`` ``packed_perm``) over those words: with
K18's extremes, its live prefix equals the reference's ``lexsort_perm``
(:55); with the extremes over all rows, the whole permutation does.

The grouping (``ops/aggregate.py`` ``group_rows``, from K18's words and
extremes and from K3's): the same partition of the live rows as the
reference's ``group_rows`` (``sail_tpu/ops/aggregate.py:102``), each group
named by its first row, and each aggregate equal (integers exactly,
float64 sums within 1e-12 relative: the two add in other orders).

Inputs are made from a seed with numpy; every comparison is exact unless
stated.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu.columnar.batch import Column as JColumn
from sail_tpu.ops import aggregate as jagg
from sail_tpu.ops import sort as jsort
from sail_tpu.spec import data_type as jdt
from sail_tpu_torch.columnar import arrow_interop as ai
from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.ops import aggregate as tagg
from sail_tpu_torch.ops import chain as ch
from sail_tpu_torch.ops import sort as tsort
from sail_tpu_torch.spec import data_type as tdt

N = 3000
FLOAT_RTOL = 1e-12
_SIGN = np.uint64(1 << 63)
WORDS = ["MAIL", "AIR", "SHIP", "TRUCK", "REG AIR", "", "rail", "FOB"]

# key name → (numpy values maker, reference type, port type, torch dtype)
_KINDS = {
    "bool": (lambda r, n: r.random(n) < 0.5, jdt.BooleanType(),
             tdt.BooleanType(), torch.bool),
    "int8": (lambda r, n: r.integers(-128, 128, n).astype(np.int8),
             jdt.ByteType(), tdt.ByteType(), torch.int8),
    "int16": (lambda r, n: r.integers(-300, 300, n).astype(np.int16),
              jdt.ShortType(), tdt.ShortType(), torch.int16),
    "int32": (lambda r, n: r.integers(-1000, 1000, n).astype(np.int32),
              jdt.IntegerType(), tdt.IntegerType(), torch.int32),
    "int64": (lambda r, n: r.integers(-10**6, 10**6, n),
              jdt.LongType(), tdt.LongType(), torch.int64),
    "wide64": (lambda r, n: r.integers(-2**62, 2**62, n),
               jdt.LongType(), tdt.LongType(), torch.int64),
    "float32": (lambda r, n: _floats(r, n, np.float32), jdt.FloatType(),
                tdt.FloatType(), torch.float32),
    "float64": (lambda r, n: _floats(r, n, np.float64), jdt.DoubleType(),
                tdt.DoubleType(), torch.float64),
    "date": (lambda r, n: r.integers(8000, 10500, n).astype(np.int32),
             jdt.DateType(), tdt.DateType(), torch.int32),
    "decimal": (lambda r, n: r.integers(-10**5, 10**5, n),
                jdt.DecimalType(15, 2), tdt.DecimalType(15, 2), torch.int64),
    "dict": (lambda r, n: r.integers(0, len(WORDS), n).astype(np.int32),
             jdt.IntegerType(), tdt.IntegerType(), torch.int32),
}


def _floats(rng, n, dtype):
    """Values with ties, NaN, -0.0 and 0.0, and the infinities."""
    v = rng.integers(-20, 20, n).astype(dtype) / 4
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    v[rng.random(n) < 0.05] = 0.0
    v[:2] = [np.inf, -np.inf]
    return v


def _ranks() -> np.ndarray:
    """The rank of each code of WORDS' dictionary by value (what the
    session's rank table holds)."""
    return ai.dictionary_ranks(pa.array(WORDS))


class Keys:
    """Key columns made from ``seed``: per kind its data, validity (None
    for every third kind) and the value the reference sorts (a dictionary
    code's rank); a selection with dead rows; a filter column."""

    def __init__(self, kinds, seed: int, nulls: bool = True):
        rng = np.random.default_rng(seed)
        self.kinds = list(kinds)
        self.data, self.valid, self.sorted_value = [], [], []
        for j, kind in enumerate(self.kinds):
            d = _KINDS[kind][0](rng, N)
            v = rng.random(N) < 0.85 if nulls and j % 3 != 2 else None
            self.data.append(d)
            self.valid.append(v)
            self.sorted_value.append(_ranks()[d] if kind == "dict" else d)
        self.sel = rng.random(N) < 0.9
        self.filt = rng.integers(0, 10, N).astype(np.int32)

    def cols(self):
        """The program's bottom columns: the keys, then the filter's."""
        out = [(torch.from_numpy(d), None if v is None else
                torch.from_numpy(v)) for d, v in zip(self.data, self.valid)]
        return out + [(torch.from_numpy(self.filt), None)]

    def frag(self, j: int) -> ch.Frag:
        kind = self.kinds[j]
        f = ch.col(j, _KINDS[kind][3], self.valid[j] is not None)
        if kind == "dict":
            f = ch.op("lut", f, dtype=torch.int32, nullable=f.nullable,
                      imm=(ch.Table(torch.from_numpy(_ranks())),))
        return f

    def run_k18(self, desc, canonical: bool = False):
        """K18's plain version over a filter (filter column > 0) and the
        keys: (its ChainSorted, the live rows as numpy)."""
        filt = ch.strict("cmp", ch.col(len(self.kinds), torch.int32, False),
                         ch.const(0, torch.int32), dtype=torch.bool,
                         imm=(">",))
        keys = [ch.SortKey(self.frag(j), d, canonical)
                for j, d in enumerate(desc)]
        prog = ch.build_program([filt], [], "cpu", sort_keys=keys)
        out = ch.run_chain_sort_plain(prog, self.cols(),
                                      torch.from_numpy(self.sel))
        return out, self.sel & (self.filt > 0)


def _ref_bits(keys: Keys, j: int, asc: bool) -> np.ndarray:
    kind = keys.kinds[j]
    jtype = jdt.IntegerType() if kind == "dict" else _KINDS[kind][1]
    return np.asarray(jsort.order_bits(jnp.asarray(keys.sorted_value[j]),
                                       jtype, asc))


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_k18_words_equal_reference_order_bits(kind, desc):
    keys = Keys([kind, kind, kind], seed=len(kind) + 7 * desc)
    for canonical in (False, True):
        out, live = keys.run_k18([desc] * 3, canonical)
        assert torch.equal(out.sel, torch.from_numpy(live))
        for j, (word, valid) in enumerate(out.words):
            ok = live if keys.valid[j] is None else live & keys.valid[j]
            got = word.numpy().view(np.uint64)
            want = _ref_bits(keys, j, not desc) ^ _SIGN
            np.testing.assert_array_equal(got[ok], want[ok])
            if keys.valid[j] is None:
                assert valid is None
            else:
                np.testing.assert_array_equal(valid.numpy(), keys.valid[j])
            # the extremes: over the live rows, a grouping's over its live
            # non-null rows
            rows = ok if canonical else live
            w = word.numpy()[rows]
            assert out.ext[j].tolist() == [int(w.min()), int(w.max())]


def test_k18_extremes_of_no_live_row():
    keys = Keys(["int32", "float64"], seed=3)
    keys.sel[:] = False
    out, _ = keys.run_k18([False, True])
    big = torch.iinfo(torch.int64)
    assert out.ext.tolist() == [[big.max, big.min]] * 2


# (kinds, descending each, nulls_first each)
_SORTS = [
    (("int32", "int16", "date"), (False, True, False), (None, None, True)),
    (("dict", "decimal"), (True, False), (False, True)),
    (("bool", "int8", "int64"), (False, False, True), (True, False, None)),
    (("float32", "int16"), (True, False), (None, True)),
    (("date", "dict", "bool", "int8"), (False, True, False, True),
     (True, True, False, False)),
    (("float64", "int32"), (False, True), (None, False)),
    (("wide64", "int8"), (True, False), (True, True)),
]


def _reference_perm(keys: Keys, live, desc, nulls_first) -> np.ndarray:
    jkeys = []
    for j, kind in enumerate(keys.kinds):
        jtype = jdt.IntegerType() if kind == "dict" else _KINDS[kind][1]
        v = keys.valid[j]
        jkeys.append((jnp.asarray(keys.sorted_value[j]),
                      None if v is None else jnp.asarray(v), jtype,
                      not desc[j], nulls_first[j]))
    return np.asarray(jsort.lexsort_perm(jkeys, jnp.asarray(live)))


@pytest.mark.parametrize("case", range(len(_SORTS)))
def test_packed_perm_equals_reference_lexsort(case):
    kinds, desc, nulls_first = _SORTS[case]
    keys = Keys(kinds, seed=40 + case)
    out, live = keys.run_k18(list(desc))
    words = [(w, v, (not d) if nf is None else nf)
             for (w, v), d, nf in zip(out.words, desc, nulls_first)]
    want = _reference_perm(keys, live, desc, nulls_first)
    n_live = int(live.sum())
    # K18's extremes (the live rows'): the live prefix
    srt = tsort.sort_words(words, out.sel, out.ext)
    np.testing.assert_array_equal(srt.perm.numpy()[:n_live], want[:n_live])
    assert tsort.packed_perm(words, out.sel, out.ext).numpy()[:n_live] \
        .tolist() == want[:n_live].tolist()
    # extremes over all rows: the whole permutation, dead rows too
    np.testing.assert_array_equal(
        tsort.packed_perm(words, out.sel).numpy(), want)
    wide = any(k in ("float64", "wide64") for k in kinds)
    assert srt.form == ("passes" if wide else "packed")


def test_lexsort_perm_goes_through_the_pack():
    """The executor's K3 route: ``lexsort_perm`` packs keys that fit and
    equals the reference, dead rows included."""
    keys = Keys(["int32", "date", "dict"], seed=5)
    tkeys, jkeys = [], []
    for j, kind in enumerate(keys.kinds):
        v = keys.valid[j]
        data = keys.sorted_value[j]
        tkeys.append((torch.from_numpy(data), None if v is None else
                      torch.from_numpy(v), _KINDS[kind][2], j != 1, None))
        jkeys.append((jnp.asarray(data), None if v is None else
                      jnp.asarray(v), _KINDS[kind][1], j != 1, None))
    before = tsort.window_pack.launches
    got = tsort.lexsort_perm(tkeys, torch.from_numpy(keys.sel))
    want = jsort.lexsort_perm(jkeys, jnp.asarray(keys.sel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsort.window_pack.launches == before  # the CPU: plain version


# ---------------------------------------------------------------------------
# the grouping
# ---------------------------------------------------------------------------

_GROUPS = [("int32",), ("dict", "date"), ("float64",), ("bool", "int8",
                                                         "int16"),
           ("float32", "decimal"), ("wide64", "int8"), ("int64", "dict")]


def _port_labels(ctx, n: int) -> np.ndarray:
    """Each row's group named by its first row (-1: dead)."""
    seg = np.full(n, -1)
    perm, ids = ctx.perm.numpy(), ctx.sorted_ids.numpy()
    live = ids < ctx.max_groups
    seg[perm[live]] = ids[live]
    return _first_rows(seg)


def _first_rows(seg: np.ndarray) -> np.ndarray:
    out = np.full(seg.shape[0], -1)
    first = {}
    for i, g in enumerate(seg):
        if g >= 0:
            first.setdefault(int(g), i)
            out[i] = first[int(g)]
    return out


def _by_first(labels: np.ndarray, ids: np.ndarray, col) -> dict:
    """{a group's first row: (value, valid)} of a per-group output
    ``col`` ((data, validity) over group ids) through each live row's
    group id ``ids``."""
    d, v = (np.asarray(x) if x is not None else None for x in col)
    return {int(labels[i]): (d[ids[i]].item(), True if v is None else
                             bool(v[ids[i]]))
            for i in range(labels.shape[0]) if labels[i] >= 0}


def _spark_groups(keys: Keys, live) -> np.ndarray:
    """Spark's partition of the live rows, each row named by its group's
    first row: a NULL key is one value whatever lies under it, all NaNs
    are one value and -0.0 is 0.0."""
    def value(j, i):
        if keys.valid[j] is not None and not keys.valid[j][i]:
            return None
        x = keys.data[j][i].item()
        if isinstance(x, float):
            return "nan" if np.isnan(x) else x + 0.0
        return x
    first, out = {}, np.full(N, -1)
    for i in np.flatnonzero(live):
        out[i] = first.setdefault(tuple(value(j, i) for j in
                                        range(len(keys.kinds))), i)
    return out


# the groupings where the reference splits a key's NULLs by the data
# beneath them: keys that do not fit its packed word (can_pack) take its
# passes, which order a NULL row by its data bits before the next key, so
# (NULL, x) rows with other data under the NULL are not adjacent and
# ``_keys_equal_adjacent`` starts a new group. Spark groups them together;
# the port is held to Spark there (ROADMAP Queue C).
REFERENCE_SPLITS_NULLS = {1, 4, 5, 6}


@pytest.mark.parametrize("route", ["K18", "K3"])
@pytest.mark.parametrize("case", range(len(_GROUPS)))
def test_group_rows_partition_and_aggregates_equal_reference(case, route):
    keys = Keys(_GROUPS[case], seed=70 + case)
    out, live = keys.run_k18([False] * len(keys.kinds), canonical=True)
    rng = np.random.default_rng(case)
    ints = rng.integers(-10**9, 10**9, N)
    int_valid = rng.random(N) < 0.9
    flts = rng.normal(0, 1e3, N)
    tcols = [TColumn(torch.from_numpy(d), None if v is None else
                     torch.from_numpy(v), _KINDS[k][2])
             for d, v, k in zip(keys.data, keys.valid, keys.kinds)]
    words = out.words if route == "K18" else None
    ext = out.ext if route == "K18" else None
    ctx, tk = tagg.group_rows(tcols, out.sel, N, words, ext)
    jcols = [JColumn(jnp.asarray(d), None if v is None else jnp.asarray(v),
                     jdt.StringType() if k == "dict" else _KINDS[k][1])
             for d, v, k in zip(keys.data, keys.valid, keys.kinds)]
    jctx, jk = jagg.group_rows(jcols, jnp.asarray(live), N)
    got = _port_labels(ctx, N)
    jseg = np.asarray(jctx.seg_ids)
    ref = _first_rows(np.where(jseg < N, jseg, -1))
    spark = _spark_groups(keys, live)
    np.testing.assert_array_equal(got, spark)
    assert np.array_equal(ref, spark) == (case not in
                                          REFERENCE_SPLITS_NULLS)
    wide = any(k in ("float64", "wide64") for k in keys.kinds)
    assert ctx.sort_form == ("passes" if wide else "packed")
    port_ids = np.full(N, -1)
    port_ids[ctx.perm.numpy()] = ctx.sorted_ids.numpy()

    def outputs(agg, dts, col, to, c, k):
        iv = col(to(ints), to(int_valid), dts.LongType())
        fv = col(to(flts), None, dts.DoubleType())
        outs = [agg.agg_count(c, None), agg.agg_sum(c, iv, dts.LongType()),
                agg.agg_min_max(c, iv, True), agg.agg_sum(c, fv,
                                                          dts.DoubleType())]
        outs += agg.group_key_output(c, k)
        return [(o.data, o.validity) for o in outs]

    port = [_by_first(got, port_ids, o) for o in
            outputs(tagg, tdt, TColumn, torch.from_numpy, ctx, tk)]
    # numpy's, over Spark's groups
    members = {}
    for i in np.flatnonzero(live):
        members.setdefault(int(spark[i]), []).append(i)
    for row, rows in members.items():
        iv = [ints[i] for i in rows if int_valid[i]]
        assert port[0][row] == (len(rows), True)
        assert port[1][row] == (int(np.sum(iv)) if iv else 0, bool(iv))
        if iv:
            assert port[2][row] == (int(min(iv)), True)
        assert port[3][row][0] == pytest.approx(
            float(np.sum(flts[rows])), rel=FLOAT_RTOL, abs=1e-9)
    if case in REFERENCE_SPLITS_NULLS:
        return
    ref_out = [_by_first(ref, jseg, o) for o in
               outputs(jagg, jdt, JColumn, jnp.asarray, jctx, jk)]
    for j, (g, w) in enumerate(zip(port, ref_out)):
        assert g.keys() == w.keys()
        for row in g:
            (gv, gok), (wv, wok) = g[row], w[row]
            assert gok == wok
            if not gok:
                continue
            if j == 3:  # the float64 sums add in other orders
                assert gv == pytest.approx(wv, rel=FLOAT_RTOL, abs=1e-9)
            elif isinstance(wv, float) and np.isnan(wv):
                assert np.isnan(gv)
            else:
                assert gv == wv, (j, row)


def test_null_keys_group_together_whatever_lies_under_them():
    """A NULL key is one value in the grouping's word: NULL rows with
    different data beneath fall into one group (Spark's semantics)."""
    data = torch.tensor([5, 7, 5, 9, 7, 1], dtype=torch.int64)
    valid = torch.tensor([True, False, True, False, False, True])
    sel = torch.ones(6, dtype=torch.bool)
    words = [(tsort.order_keys(data), valid)]
    ext = tsort.key_extremes([(words[0][0], valid, True)], sel, True)
    ctx, _ = tagg.group_rows([TColumn(data, valid, tdt.LongType())], sel, 6,
                             words, ext)
    assert ctx.sort_form == "packed"
    assert int(ctx.num_groups) == 3  # NULL, 1 and 5
    np.testing.assert_array_equal(_port_labels(ctx, 6), [0, 1, 0, 1, 1, 5])
