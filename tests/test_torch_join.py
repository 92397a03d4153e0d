"""Parity of the port's join kernels with the JAX reference.

The plain versions of K4 (``join_keys``), K5 (``probe_ranges``), K6
(``join_expand``'s index triples) and K7 (the runtime filter's bloom) are
fed the same numpy inputs, made from a seed, as ``sail_tpu/ops/hash.py``,
``ops/join.py`` and ``ops/runtime_filter.py``, which run under JAX on the
CPU. Every comparison is exact: keys bit for bit (the port's key is the
reference's uint64 key XOR 1 << 63), the build permutation, match ranges,
index triples and filter masks value for value. The tests marked ``gpu``
hold each kernel against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.columnar.batch import Column as JColumn
from sail_tpu.columnar.batch import DeviceBatch as JBatch
from sail_tpu.ops import hash as jhash
from sail_tpu.ops import join as jjoin
from sail_tpu.ops import runtime_filter as jrtf
from sail_tpu.spec import data_type as jdt
from sail_tpu_torch.columnar.batch import Column as TColumn
from sail_tpu_torch.columnar.batch import DeviceBatch as TBatch
from sail_tpu_torch.ops import hash as thash
from sail_tpu_torch.ops import join as tjoin
from sail_tpu_torch.ops import runtime_filter as trtf
from sail_tpu_torch.spec import data_type as tdt

_TYPES = {  # numpy dtype → (reference spec type, port spec type)
    "bool": (jdt.BooleanType(), tdt.BooleanType()),
    "int8": (jdt.ByteType(), tdt.ByteType()),
    "int16": (jdt.ShortType(), tdt.ShortType()),
    "int32": (jdt.IntegerType(), tdt.IntegerType()),
    "int64": (jdt.LongType(), tdt.LongType()),
    "float32": (jdt.FloatType(), tdt.FloatType()),
    "float64": (jdt.DoubleType(), tdt.DoubleType()),
}
# key column sets: packed (≤ 64 bits) and hashed (> 64 bits)
_KEY_SETS = {
    "int64": ["int64"],
    "int32": ["int32"],
    "float64": ["float64"],
    "int32+int16+bool": ["int32", "int16", "bool"],
    "float32+int32": ["float32", "int32"],
    "int64+int64": ["int64", "int64"],
    "int32+float64": ["int32", "float64"],
    "int8+int64+float32": ["int8", "int64", "float32"],
}


def _column(rng, dtype: str, n: int, domain: int) -> np.ndarray:
    """Values from a small domain (so keys repeat and match), with the
    awkward ones: NaN, -0.0, 0.0 and -1 (the all-ones key bits)."""
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype.startswith("float"):
        pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf]
                        + list(range(domain)), dtype=dtype)
        return rng.choice(pool, n)
    v = rng.integers(-1, domain, n).astype(dtype)
    if dtype == "int64" and n > 3:
        v[:2] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    return v


def _cols(rng, dtypes, n, domain=6, nulls=True):
    out = []
    for d in dtypes:
        valid = rng.random(n) > 0.1 if nulls else None
        out.append((_column(rng, d, n, domain), valid, d))
    return out


def _jcols(cols):
    return [JColumn(jnp.asarray(v), None if m is None else jnp.asarray(m),
                    _TYPES[d][0]) for v, m, d in cols]


def _tcols(cols, device="cpu"):
    return [TColumn(torch.from_numpy(v.copy()).to(device),
                    None if m is None else torch.from_numpy(m).to(device),
                    _TYPES[d][1]) for v, m, d in cols]


def _u64_as_port(x) -> np.ndarray:
    """Reference uint64 keys → the port's int64 convention."""
    return (np.asarray(x).astype(np.uint64) ^ np.uint64(1 << 63)) \
        .view(np.int64)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K4: join keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("keyset", list(_KEY_SETS))
def test_join_keys_bit_equal_to_reference(keyset, seed):
    rng = np.random.default_rng(11)
    n = 500
    cols = _cols(rng, _KEY_SETS[keyset], n, domain=1000)
    sel = rng.random(n) < 0.9
    jk, ju, jexact = jjoin._join_keys(_jcols(cols), jnp.asarray(sel), seed)
    tk, tu, texact = thash.join_keys(_tcols(cols), torch.from_numpy(sel),
                                     seed)
    assert texact == jexact
    _eq(tk, _u64_as_port(jk))
    _eq(tu, ju)


def test_pack_and_hash_of_top_bit_keys():
    vals = np.array([-1, np.iinfo(np.int64).min, 0, 1 << 62], dtype=np.int64)
    jc, tc = jnp.asarray(vals), torch.from_numpy(vals)
    jt, tt = jdt.LongType(), tdt.LongType()
    _eq(thash.pack_keys([tc], [tt]),
        np.asarray(jhash.pack_keys([jc], [jt])).view(np.int64))
    for seed in (0, 1):
        _eq(thash.hash64([tc, tc], [tt, tt], seed),
            np.asarray(jhash.hash64([jc, jc], [jt, jt], seed))
            .view(np.int64))


@pytest.mark.parametrize("parts", [1, 7, 1000, (1 << 31) - 1])
def test_hash_partition_ids_match_reference(parts):
    rng = np.random.default_rng(5)
    vals = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        300, dtype=np.int64)
    want = jhash.hash_partition_ids([jnp.asarray(vals)], [jdt.LongType()],
                                    parts)
    got = thash.hash_partition_ids([torch.from_numpy(vals)],
                                   [tdt.LongType()], parts)
    _eq(got, want)


# ---------------------------------------------------------------------------
# K5: build side and probe ranges
# ---------------------------------------------------------------------------

def _both_sides(keyset, seed, nb, npr, nulls=True):
    rng = np.random.default_rng(seed)
    dtypes = _KEY_SETS[keyset]
    build = _cols(rng, dtypes, nb, nulls=nulls)
    probe = _cols(rng, dtypes, npr, nulls=nulls)
    bsel, psel = rng.random(nb) < 0.85, rng.random(npr) < 0.85
    return build, bsel, probe, psel


def _ref_join(build, bsel, probe, psel, seed):
    jb = _jcols(build)
    bt = jjoin.build_side(jb, jnp.asarray(bsel), seed)
    r = jjoin.probe_ranges(bt, _jcols(probe), jnp.asarray(psel),
                           build_key_cols=jb)
    return bt, r


def _port_join(build, bsel, probe, psel, seed, device="cpu"):
    tb = _tcols(build, device)
    bt = tjoin.build_side(tb, torch.from_numpy(bsel).to(device), seed)
    r = tjoin.probe_ranges(bt, _tcols(probe, device),
                           torch.from_numpy(psel).to(device),
                           build_key_cols=tb)
    return bt, r


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("keyset", list(_KEY_SETS))
def test_build_and_probe_match_reference(keyset, seed):
    build, bsel, probe, psel = _both_sides(keyset, 3, 200, 300)
    jbt, jr = _ref_join(build, bsel, probe, psel, seed)
    tbt, tr = _port_join(build, bsel, probe, psel, seed)
    assert tbt.exact == jbt.exact
    _eq(tbt.perm, jbt.perm)
    _eq(tbt.sorted_keys, _u64_as_port(jbt.sorted_keys))
    assert int(tbt.num_valid) == int(jbt.num_valid)
    # lo equals the reference's on usable rows; the port neither searches
    # nor keeps a position for the others
    usable = np.asarray(jr.usable)
    _eq(tr.lo[usable], np.asarray(jr.lo)[usable])
    assert not tr.lo[~usable].any() and not tr.cnt[~usable].any()
    _eq(tr.cnt, jr.cnt)
    _eq(tr.usable, jr.usable)
    assert bool(tjoin.has_duplicate_build_keys(tbt)) == \
        bool(jjoin.has_duplicate_build_keys(jbt))
    if not tbt.exact:
        assert bool(tjoin.hash_ambiguous(tbt, _tcols(build))) == \
            bool(jjoin.hash_ambiguous(jbt, _jcols(build)))
    _eq(tjoin.build_matched_mask(tbt, tr, torch.from_numpy(psel)),
        jjoin.build_matched_mask(jbt, jr, jnp.asarray(psel)))
    assert int(tjoin.join_output_count(tr, torch.from_numpy(psel), "left")) \
        == int(jjoin.join_output_count(jr, jnp.asarray(psel), "left"))


def test_all_ones_key_matches_and_its_duplicate_is_detected():
    """-1 as an int64 key packs to the sentinel's bit pattern (the
    reference's KEY_MAX, int64 max here) and must still match."""
    build = [(np.array([-1, 2], dtype=np.int64), None, "int64")]
    probe = [(np.array([-1, 2, 3], dtype=np.int64), None, "int64")]
    bsel, psel = np.ones(2, bool), np.ones(3, bool)
    jbt, jr = _ref_join(build, bsel, probe, psel, 0)
    tbt, tr = _port_join(build, bsel, probe, psel, 0)
    _eq(tr.cnt, jr.cnt)
    assert tr.cnt.tolist() == [1, 1, 0]
    assert not bool(tjoin.has_duplicate_build_keys(tbt))
    dup = [(np.array([-1, -1], dtype=np.int64), None, "int64")]
    tbt2, _ = _port_join(dup, bsel, probe, psel, 0)
    assert bool(tjoin.has_duplicate_build_keys(tbt2))


def test_empty_build_matches_nothing():
    probe = [(np.array([1, 2], dtype=np.int64), None, "int64")]
    empty = [(np.zeros(0, dtype=np.int64), None, "int64")]
    tbt, tr = _port_join(empty, np.zeros(0, bool), probe, np.ones(2, bool), 0)
    assert tr.cnt.tolist() == [0, 0]
    assert not bool(tjoin.has_duplicate_build_keys(tbt))
    payload = TBatch({"b": TColumn(torch.zeros(0, dtype=torch.int64), None,
                                   tdt.LongType())},
                     torch.zeros(0, dtype=torch.bool))
    probe_batch = TBatch({"k": _tcols(probe)[0]}, torch.ones(2, dtype=bool))
    out = tjoin.join_unique(tbt, tr, probe_batch, payload, "left", ["b"])
    assert out.columns["b"].validity.tolist() == [False, False]
    res = tjoin.join_expand(tbt, tr, probe_batch, payload, "left", ["b"], 2)
    assert res.is_match.tolist() == [False, False]


def test_forced_hash_ambiguity_is_detected():
    """Two build rows whose (forced) equal hashes hide different keys."""
    vals = [np.array([1, 2, 3], dtype=np.int64),
            np.array([5, 5, 6], dtype=np.int64)]
    perm = np.array([0, 1, 2])
    keys = np.array([7, 7, 9], dtype=np.uint64)
    jcols = [JColumn(jnp.asarray(v), None, jdt.LongType()) for v in vals]
    tcols = [TColumn(torch.from_numpy(v), None, tdt.LongType()) for v in vals]
    jbt = jjoin.BuildTable(jnp.asarray(perm, dtype=jnp.int32),
                           jnp.asarray(keys), False, jnp.asarray(3))
    tbt = tjoin.BuildTable(torch.from_numpy(perm),
                           torch.from_numpy(_u64_as_port(keys)), False,
                           torch.tensor(3))
    assert bool(jjoin.hash_ambiguous(jbt, jcols))
    assert bool(tjoin.hash_ambiguous(tbt, tcols))


@pytest.mark.parametrize("seed", [23, 24])
def test_probe_ranges_plain_on_sentinel_suffix_matches_reference(seed):
    """num_valid < nb: the usable prefix ends in a real all-ones key
    (int64 -1) and the sentinel fills the positions after it."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-1, 40, 300).astype(np.int64)
    vals[:5] = -1
    bsel = rng.random(300) < 0.6
    bsel[:5] = True
    keys = np.concatenate([rng.integers(-1, 50, 400), [-1, -1, 1 << 62]])
    probe = [(keys.astype(np.int64), rng.random(403) > 0.1, "int64")]
    psel = rng.random(403) < 0.8
    build = [(vals, None, "int64")]
    _, jr = _ref_join(build, bsel, probe, psel, 0)
    tbt, _ = _port_join(build, bsel, probe, psel, 0)
    nv = int(tbt.num_valid)
    assert 0 < nv < 300
    assert int(tbt.sorted_keys[nv - 1]) == np.iinfo(np.int64).max
    pkeys, pusable, _ = thash.join_keys(_tcols(probe),
                                        torch.from_numpy(psel))
    lo, cnt = tjoin.probe_ranges_plain(tbt.sorted_keys, tbt.num_valid,
                                       pkeys, pusable)
    usable = np.asarray(jr.usable)
    _eq(lo[usable], np.asarray(jr.lo)[usable])
    _eq(cnt, jr.cnt)
    assert not lo[~usable].any()
    ones = int(((vals == -1) & bsel).sum())
    assert ones >= 5
    assert (cnt[torch.from_numpy(keys == -1) & pusable] == ones).all()


@pytest.mark.parametrize("keyset", ["int64", "int64+int64"])
def test_all_dead_probe_gives_zeros(keyset):
    build, bsel, probe, _ = _both_sides(keyset, 4, 100, 200)
    psel = np.zeros(200, bool)
    _, jr = _ref_join(build, bsel, probe, psel, 0)
    _, tr = _port_join(build, bsel, probe, psel, 0)
    _eq(tr.cnt, jr.cnt)
    assert not tr.lo.any() and not tr.cnt.any() and not tr.usable.any()


# ---------------------------------------------------------------------------
# K6: expanding join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("keyset", ["int64", "int64+int64"])
def test_join_expand_indices_match_reference(keyset, join_type):
    build, bsel, probe, psel = _both_sides(keyset, 8, 120, 150)
    jbt, jr = _ref_join(build, bsel, probe, psel, 0)
    tbt, tr = _port_join(build, bsel, probe, psel, 0)
    total = int(jjoin.join_output_count(jr, jnp.asarray(psel), join_type))
    assert int(tjoin.join_output_count(tr, torch.from_numpy(psel),
                                       join_type)) == total
    assert total > 150  # duplicate build keys expand
    pb = JBatch({"k": _jcols(probe)[0]}, jnp.asarray(psel))
    bb = JBatch({"b": _jcols(build)[0]}, jnp.asarray(bsel))
    want = jjoin.join_expand(jbt, jr, pb, bb, join_type, ["b"], total + 8)
    tp = TBatch({"k": _tcols(probe)[0]}, torch.from_numpy(psel))
    tb = TBatch({"b": _tcols(build)[0]}, torch.from_numpy(bsel))
    got = tjoin.join_expand(tbt, tr, tp, tb, join_type, ["b"], total)
    _eq(got.probe_index, np.asarray(want.probe_index)[:total])
    _eq(got.is_match, np.asarray(want.is_match)[:total])
    # a left join's unmatched rows read no build row (their build columns
    # are NULL): the build index is compared where it is a match
    match = np.asarray(want.is_match)[:total]
    assert join_type == "left" or match.all()
    _eq(got.build_index[torch.from_numpy(match)],
        np.asarray(want.build_index)[:total][match])
    wb = want.batch.columns["b"]
    _eq(got.batch.columns["b"].validity, np.asarray(wb.validity)[:total])


# ---------------------------------------------------------------------------
# K7: runtime filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_bits", [1024, 1000, 1 << 20])
@pytest.mark.parametrize("keyset", ["int64", "int32+float64", "int64+int64"])
def test_bloom_matches_reference(keyset, num_bits):
    rng = np.random.default_rng(21)
    dtypes = _KEY_SETS[keyset]
    domain = 3000 if len(dtypes) == 1 else 60  # some keys match, some not
    src = _cols(rng, dtypes, 400, domain=domain)
    tgt = _cols(rng, dtypes, 2000, domain=domain)
    ssel, tsel = rng.random(400) < 0.8, rng.random(2000) < 0.9
    want = jrtf.build(_jcols(src), jnp.asarray(ssel), num_bits)
    got = trtf.build(_tcols(src), torch.from_numpy(ssel), num_bits)
    assert int(got.kmin) == int(_u64_as_port(want.kmin))
    assert int(got.kmax) == int(_u64_as_port(want.kmax))
    assert int(got.n_build) == int(want.n_build)
    assert int(got.ndv) == int(want.ndv)
    assert got.exact == want.exact
    bits = (got.words.numpy().view(np.uint32)[:, None]
            >> np.arange(32, dtype=np.uint32) & 1).astype(bool).ravel()
    np.testing.assert_array_equal(bits[:num_bits], np.asarray(want.bits))
    assert not bits[num_bits:].any()
    mask = trtf.apply(got, _tcols(tgt), torch.from_numpy(tsel))
    _eq(mask, jrtf.apply(want.bits, want.kmin, want.kmax, _jcols(tgt),
                         jnp.asarray(tsel)))
    assert 0 < int(mask.sum()) < int(tsel.sum())


def test_bloom_of_empty_source_rejects_everything():
    rng = np.random.default_rng(2)
    src = _cols(rng, ["int64"], 10)
    tgt = _cols(rng, ["int64"], 50)
    res = trtf.build(_tcols(src), torch.zeros(10, dtype=torch.bool), 1024)
    assert int(res.n_build) == 0 and int(res.ndv) == 0
    assert not trtf.apply(res, _tcols(tgt), torch.ones(50, dtype=bool)).any()


@pytest.mark.parametrize("dtype", ["int32", "int64", "float64"])
def test_column_bounds_match_reference(dtype):
    rng = np.random.default_rng(4)
    vals = _column(rng, dtype, 100, 50)
    usable = rng.random(100) < 0.5
    want = jrtf.column_bounds(jnp.asarray(vals), jnp.asarray(usable))
    got = trtf.column_bounds(torch.from_numpy(vals), torch.from_numpy(usable))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("keyset", list(_KEY_SETS))
def test_join_keys_kernel_matches_plain(cuda, keyset, seed):
    rng = np.random.default_rng(13)
    n = 100_003
    cols = _cols(rng, _KEY_SETS[keyset], n, domain=10_000)
    sel = torch.from_numpy(rng.random(n) < 0.9)
    got = thash.join_keys(_tcols(cols, cuda), sel.to(cuda), seed)
    want = thash.join_keys_plain(_tcols(cols), sel, seed)
    _eq(got[0], want[0].numpy())
    _eq(got[1], want[1].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("keyset", ["int64", "int64+int64"])
def test_probe_and_expand_kernels_match_plain(cuda, keyset):
    build, bsel, probe, psel = _both_sides(keyset, 9, 50_000, 200_000)
    tbt, tr = _port_join(build, bsel, probe, psel, 0, cuda)
    want_lo, want_cnt = tjoin.probe_ranges_plain(
        tbt.sorted_keys.cpu(), tbt.num_valid.cpu(),
        *[x.cpu() for x in thash.join_keys(_tcols(probe), torch.from_numpy(
            psel), tbt.seed)[:2]])
    if tbt.exact:
        _eq(tr.lo, want_lo.numpy())
        _eq(tr.cnt, want_cnt.numpy())
    eff = tjoin._effective_counts(tr.cnt, torch.from_numpy(psel).to(cuda),
                                  "left")
    offsets = torch.cumsum(eff, 0) - eff
    total = int(eff.sum())
    got = tjoin.expand_indices(eff, offsets, tr.cnt, tr.lo, tbt.perm, total)
    want = tjoin.expand_indices_plain(eff.cpu(), offsets.cpu(), tr.cnt.cpu(),
                                      tr.lo.cpu(), tbt.perm.cpu(), total)
    for g, w in zip(got, want):
        _eq(g, w.numpy())


@pytest.mark.gpu
def test_bloom_kernels_match_plain(cuda):
    rng = np.random.default_rng(17)
    vals = rng.integers(-2**63, 2**63 - 1, 300_000, dtype=np.int64)
    cols = [(vals, rng.random(300_000) < 0.95, "int64")]
    usable = torch.from_numpy(rng.random(300_000) < 0.9)
    sel = torch.from_numpy(rng.random(300_000) < 0.9)
    for num_bits in (1000, 1 << 20):
        got = trtf.filter_build(_tcols(cols, cuda), usable.to(cuda), num_bits)
        want = trtf.filter_build_plain(_tcols(cols), usable, num_bits)
        _eq(got.words, want.words.numpy())
        # the bounds of 100 source keys: they decide for most rows
        keys = thash.join_keys_plain(_tcols(cols), usable)[0][:100]
        lo, hi = keys.min(), keys.max()
        res = trtf.BuildResult(got.words, num_bits, lo.to(cuda), hi.to(cuda),
                               got.n_build, got.n_build, got.exact)
        mask = trtf.apply(res, _tcols(cols, cuda), sel.to(cuda))
        plain = trtf.BuildResult(want.words, num_bits, lo, hi, want.n_build,
                                 want.n_build, want.exact)
        _eq(mask, trtf.filter_apply_plain(plain, _tcols(cols), sel).numpy())


# K5's builds on the card, (capacity, usable rows): the splitter table in
# shared memory holds tjoin.PROBE_TABLE_MAX keys, so "fits" and
# "filtered_fits" (a large build whose usable prefix fits) are searched
# there whole, "just_over" with every second key there, and the others
# finish in global memory; "hot_key" has a run of half its rows
_K5_BUILDS = {
    "fits": (tjoin.PROBE_TABLE_MAX, tjoin.PROBE_TABLE_MAX),
    "filtered_fits": (500_000, tjoin.PROBE_TABLE_MAX - 100),
    "just_over": (tjoin.PROBE_TABLE_MAX + 1, tjoin.PROBE_TABLE_MAX + 1),
    "large_filtered": (1_000_000, 400_000),
    "hot_key": (100_000, 100_000),
    "nv0": (5_000, 0),
    "nv1": (5_000, 1),
}


def _card_build(cuda, rng, nb, nv, hot=False):
    """A one-column int64 build of nb rows, nv of them usable, with
    duplicate keys and the all-ones key (-1)."""
    vals = rng.integers(-1, nb // 2 + 2, nb).astype(np.int64)
    if hot:
        vals[: nb // 2] = 7
    bsel = np.zeros(nb, bool)
    bsel[rng.permutation(nb)[:nv]] = True
    bt = tjoin.build_side([TColumn(torch.from_numpy(vals).to(cuda), None,
                                   tdt.LongType())],
                          torch.from_numpy(bsel).to(cuda))
    assert int(bt.num_valid) == nv
    return bt


@pytest.mark.gpu
@pytest.mark.parametrize("probes", ["random", "sorted", "one_percent_live",
                                    "unaligned"])
@pytest.mark.parametrize("build", list(_K5_BUILDS))
def test_probe_kernel_matches_plain(cuda, build, probes):
    rng = np.random.default_rng(31)
    nb, nv = _K5_BUILDS[build]
    bt = _card_build(cuda, rng, nb, nv, hot=build == "hot_key")
    n = 300_001
    keys = rng.integers(-1, nb // 2 + 4, n).astype(np.int64)
    if probes == "sorted":
        keys.sort()
    live = rng.random(n) < (0.01 if probes == "one_percent_live" else 0.985)
    pk, pu, _ = thash.join_keys(
        [TColumn(torch.from_numpy(keys).to(cuda), None, tdt.LongType())],
        torch.from_numpy(live).to(cuda))
    if probes == "unaligned":  # flags off 4-byte alignment: scalar path
        pk, pu = pk[1:], pu[1:]
    before = tjoin.probe_ranges_kernel.launches
    lo, cnt = tjoin.probe_ranges_kernel(bt.sorted_keys, bt.num_valid, pk, pu)
    torch.cuda.synchronize()
    assert tjoin.probe_ranges_kernel.launches == before + 1
    want_lo, want_cnt = tjoin.probe_ranges_plain(
        bt.sorted_keys.cpu(), bt.num_valid.cpu(), pk.cpu(), pu.cpu())
    _eq(lo, want_lo.numpy())
    _eq(cnt, want_cnt.numpy())
    if build == "hot_key":
        assert int(cnt.max()) > 10_000


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["self_join", "one_percent_live", "hot_key",
                                  "all_dead", "empty_build"])
def test_expand_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(37)
    nb = 0 if case == "empty_build" else 200_000
    bt = _card_build(cuda, rng, nb, nb, hot=case == "hot_key")
    n = 200_003
    keys = rng.integers(-1, nb // 2 + 4, n).astype(np.int64)
    share = {"one_percent_live": 0.01, "all_dead": 0.0,
             "hot_key": 2e-4}.get(case, 0.985)
    sel = torch.from_numpy(rng.random(n) < share).to(cuda)
    if case == "hot_key":
        keys[:] = 7  # every live probe hits the run of 100,000
    pk, pu, _ = thash.join_keys(
        [TColumn(torch.from_numpy(keys).to(cuda), None, tdt.LongType())], sel)
    lo, cnt = tjoin.probe_ranges_kernel(bt.sorted_keys, bt.num_valid, pk, pu)
    eff = tjoin._effective_counts(
        cnt, sel, "left" if case == "empty_build" else "inner")
    offsets = torch.cumsum(eff, 0) - eff
    total = int(eff.sum())
    assert (total == 0) == (case == "all_dead")
    before = tjoin.expand_indices.launches
    got = tjoin.expand_indices(eff, offsets, cnt, lo, bt.perm, total)
    torch.cuda.synchronize()
    assert tjoin.expand_indices.launches == before + (total > 0)
    want = tjoin.expand_indices_plain(eff, offsets, cnt, lo, bt.perm, total)
    for g, w in zip(got, want):
        assert g.shape == (total,) and torch.equal(g, w)
    if case == "empty_build":
        assert not got[1].any() and not got[2].any()
