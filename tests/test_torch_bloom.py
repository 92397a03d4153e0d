"""Parity of the port's runtime filter (K7) with the JAX reference.

``build`` and ``apply`` of ``sail_tpu_torch/ops/runtime_filter.py`` run,
on the CPU, the fused plain versions of K7's two kernels (K4's keys, the
bloom's bits, the key bounds and count in one pass; K4's keys and the
probe in the other). They are fed the same numpy inputs, made from a seed,
as ``sail_tpu/ops/runtime_filter.py`` ``build`` and ``apply`` under JAX on
the CPU, for every key set and filter size, and compared exactly: kmin,
kmax, n_build, ndv, every bit and every mask value. The host side of the
kernels' division-free bit positions is held against Python's ``%``. The
tests marked ``gpu`` hold each fused kernel against its fused plain
version on the card, on each side of the shared-memory limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.ops import runtime_filter as jrtf
from sail_tpu_torch.ops import hash as thash
from sail_tpu_torch.ops import runtime_filter as trtf
from test_torch_join import _KEY_SETS, _cols, _eq, _jcols, _tcols, \
    _u64_as_port

_SIZES = [1000, 1024, 1_000_003, 1 << 20]


def _bits(words: torch.Tensor) -> np.ndarray:
    """One bool per bit of int32 words (bit p is word p >> 5, bit p & 31)."""
    w = words.cpu().numpy().view(np.uint32)
    return (w[:, None] >> np.arange(32, dtype=np.uint32) & 1).astype(
        bool).ravel()


def _source_and_target(keyset, seed, ns=400, nt=2000):
    rng = np.random.default_rng(seed)
    dtypes = _KEY_SETS[keyset]
    domain = 3000 if len(dtypes) == 1 else 60  # some keys match, some not
    src = _cols(rng, dtypes, ns, domain=domain)
    tgt = _cols(rng, dtypes, nt, domain=domain)
    return src, rng.random(ns) < 0.8, tgt, rng.random(nt) < 0.9


@pytest.mark.parametrize("num_bits", _SIZES)
@pytest.mark.parametrize("keyset", list(_KEY_SETS))
def test_fused_build_and_apply_match_reference(keyset, num_bits):
    src, ssel, tgt, tsel = _source_and_target(keyset, 41)
    want = jrtf.build(_jcols(src), jnp.asarray(ssel), num_bits)
    got = trtf.build(_tcols(src), torch.from_numpy(ssel), num_bits)
    assert int(got.kmin) == int(_u64_as_port(want.kmin))
    assert int(got.kmax) == int(_u64_as_port(want.kmax))
    assert int(got.n_build) == int(want.n_build)
    assert int(got.ndv) == int(want.ndv)
    assert got.exact == want.exact
    bits = _bits(got.words)
    np.testing.assert_array_equal(bits[:num_bits], np.asarray(want.bits))
    assert not bits[num_bits:].any()
    mask = trtf.apply(got, _tcols(tgt), torch.from_numpy(tsel))
    _eq(mask, jrtf.apply(want.bits, want.kmin, want.kmax, _jcols(tgt),
                         jnp.asarray(tsel)))
    # the build pass also yields K4's keys, which the ndv sort reads
    built = trtf.filter_build_plain(_tcols(src), torch.from_numpy(ssel),
                                    num_bits)
    keys, usable, _ = thash.join_keys_plain(_tcols(src),
                                            torch.from_numpy(ssel))
    assert torch.equal(built.keys, keys) and torch.equal(built.usable,
                                                         usable)


@pytest.mark.parametrize("num_bits", [1000, 1_000_003, 2 ** 31 - 1, 1 << 20])
def test_divisor_reduction_matches_modulo(num_bits):
    rng = np.random.default_rng(num_bits)
    d, mu = trtf.divisor(num_bits)
    assert d == num_bits and (mu == 0) == (num_bits == 1 << 20)
    ms = [int(x) for x in rng.integers(0, 2 ** 64, 20_000, dtype=np.uint64)]
    top = 2 ** 64 - 1
    ms += [0, 1, num_bits - 1, num_bits, num_bits + 1, top, top - 1,
           top - top % num_bits, top - top % num_bits - 1, 1 << 63,
           (1 << 63) - 1]
    ms += [k * num_bits + r for k in (1, 2 ** 32, (top // num_bits))
           for r in (0, num_bits - 1)]
    for m in ms:
        if m <= top:
            assert trtf.reduce_plain(m, d, mu) == m % num_bits, m


def test_divisor_rejects_sizes_outside_the_kernel_range():
    for bad in (0, -1, 2 ** 31):
        with pytest.raises(ValueError):
            trtf.divisor(bad)


def test_empty_source_zero_length_target_and_dead_rows():
    rng = np.random.default_rng(3)
    empty = _cols(rng, ["int64"], 0)
    res = trtf.build(_tcols(empty), torch.zeros(0, dtype=torch.bool), 1024)
    assert int(res.n_build) == 0 and int(res.ndv) == 0
    assert int(res.kmin) == torch.iinfo(torch.int64).max
    assert int(res.kmax) == torch.iinfo(torch.int64).min
    assert not res.words.any()
    tgt = _cols(rng, ["int64"], 50)
    assert not trtf.apply(res, _tcols(tgt), torch.ones(50, dtype=bool)).any()
    src = _cols(rng, ["int64"], 30, domain=5)
    live = trtf.build(_tcols(src), torch.ones(30, dtype=torch.bool), 1000)
    assert trtf.apply(live, _tcols(empty),
                      torch.zeros(0, dtype=torch.bool)).shape == (0,)
    assert not trtf.apply(live, _tcols(tgt),
                          torch.zeros(50, dtype=torch.bool)).any()


# ---------------------------------------------------------------------------
# on the card: each fused kernel against its fused plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_check(cuda, src, ssel, tgt, tsel, num_bits, offset=0):
    """Both kernels against their plain versions; ``offset`` slices every
    input off its 16-byte alignment (the kernels' scalar path)."""
    def on(cols, sel, device):
        tc = _tcols(cols, device)
        for c in tc:
            c.data = c.data[offset:]
            c.validity = None if c.validity is None else c.validity[offset:]
        return tc, torch.from_numpy(sel).to(device)[offset:]

    before = (trtf.filter_build.launches, trtf.apply.launches)
    got = trtf.filter_build(*on(src, ssel, cuda), num_bits)
    want = trtf.filter_build_plain(*on(src, ssel, "cpu"), num_bits)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            _eq(g, w.numpy())
        else:
            assert g == w
    res = trtf.BuildResult(got.words, num_bits, got.kmin, got.kmax,
                           got.n_build, got.n_build, got.exact)
    mask = trtf.apply(res, *on(tgt, tsel, cuda))
    torch.cuda.synchronize()
    plain = trtf.BuildResult(want.words, num_bits, want.kmin, want.kmax,
                             want.n_build, want.n_build, want.exact)
    _eq(mask, trtf.filter_apply_plain(plain, *on(tgt, tsel, "cpu")).numpy())
    ns, nt = len(ssel) - offset, len(tsel) - offset
    assert (trtf.filter_build.launches, trtf.apply.launches) == \
        (before[0] + (ns > 0), before[1] + (nt > 0))
    return got, mask


@pytest.mark.gpu
@pytest.mark.parametrize("keyset", list(_KEY_SETS))
def test_filter_kernels_match_plain(cuda, keyset):
    src, ssel, tgt, tsel = _source_and_target(keyset, 43, 100_003, 300_007)
    got, mask = _card_check(cuda, src, ssel, tgt, tsel, 1 << 20)
    assert int(got.n_build) > 0 and 0 < int(mask.sum()) < int(tsel.sum())


# filter sizes around the shared-memory limit, powers of two and not:
# every (shared, power of two) instance of both kernels
_CARD_SIZES = [1000, 1 << 20, 1_000_003, trtf.SHARED_BITS_MAX,
               trtf.SHARED_BITS_MAX + 1, 1 << 22]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("num_bits", _CARD_SIZES)
def test_filter_kernels_at_each_size(cuda, num_bits, offset):
    src, ssel, tgt, tsel = _source_and_target("int64+int64", 47, 200_001,
                                              300_001)
    _card_check(cuda, src, ssel, tgt, tsel, num_bits, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty_source", "empty_target",
                                  "dead_source", "dead_target"])
def test_filter_kernels_on_empty_and_dead_inputs(cuda, case):
    src, ssel, tgt, tsel = _source_and_target("int64", 53, 50_000, 70_000)
    if case == "empty_source":
        src, ssel = [(v[:0], None if m is None else m[:0], d)
                     for v, m, d in src], ssel[:0]
    elif case == "empty_target":
        tgt, tsel = [(v[:0], None if m is None else m[:0], d)
                     for v, m, d in tgt], tsel[:0]
    elif case == "dead_source":
        ssel = np.zeros_like(ssel)
    else:
        tsel = np.zeros_like(tsel)
    got, mask = _card_check(cuda, src, ssel, tgt, tsel, 1 << 20)
    if case in ("empty_source", "dead_source"):
        assert int(got.n_build) == 0 and not got.words.any()
    assert not mask.any()


@pytest.mark.gpu
@pytest.mark.parametrize("live", [0.002, 0.02, 0.1])
def test_filter_kernels_on_sparse_inputs(cuda, live):
    """Sparse sources and targets: warps whose rows are mostly dead mix
    only their live rows, in rounds."""
    src, ssel, tgt, tsel = _source_and_target("int64+int64", 59, 200_001,
                                              300_001)
    rng = np.random.default_rng(61)
    ssel = ssel & (rng.random(ssel.shape[0]) < live)
    tsel = tsel & (rng.random(tsel.shape[0]) < live)
    for num_bits in (1 << 20, 1_000_003, 1 << 22):
        got, mask = _card_check(cuda, src, ssel, tgt, tsel, num_bits)
        assert int(got.n_build) > 0 and int(mask.sum()) > 0
