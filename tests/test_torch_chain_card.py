"""K16, K17 and K18 (the kernels ``sail_tpu_torch/ops/chain_codegen.py``
generates for each chain program and NVRTC compiles) on the card against
their plain versions. Every chain of the chain tests' queries runs in a
session on the card; each K16 launch is held to ``run_chain_plain`` and
each K17 launch to ``run_chain_reduce_plain`` on the same inputs on the
card: integers, decimals, dates, codes and bools exactly, float64 exactly
(the kernel makes the same IEEE operations, without FMA contraction)
except where a chain calls a K12/K14 transcendental function, which the
card's math library and torch's may round an ulp apart (within 8 ulp, as
K12 and K14 are held), and K17's float sums within a relative 1e-12 (their
order varies). The answers must equal the CPU session's. Programs that
differ only in a scalar subquery's value share one compiled kernel, a
steady run compiles nothing, and a kernel's module is unloaded when no
program holds it. Each K18 launch (a sort's or a sorted grouping's chain
with its keys' words) is held to ``run_chain_sort_plain``: its words,
validities and extremes exactly (within 8 of a float64 key's word where
the chain calls a transcendental function), and the pack kernel with a
sort's and a grouping's flags (dead rows alone, NULLs canonical) to its
plain version exactly. Needs a card:
``python -m pytest tests/test_torch_chain_card.py -m gpu``.
"""

import gc

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch import csrc
from sail_tpu_torch.exec import local as xl
from sail_tpu_torch.ops import chain as ch
from sail_tpu_torch.ops import chain_codegen
from sail_tpu_torch.ops import sort as srt
from torch_chain_common import (CHAIN_QUERIES, REDUCE_QUERIES, SORT_QUERIES,
                                Capture, chain_table, same_cv, session,
                                ulps_close)

ULPS_KINDS = ("math", "calendar")
# a cast of NaN or an infinity to an integer is platform-defined in torch
# (the CPU gives INT64_MIN, the card saturates): the card's answer is held
# to its plain version only
CPU_DIFFERS = ("cast",)
SUM_RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _answers_equal(got, want):
    """The same rows: float columns NaN-aware within a relative 1e-9,
    every other column exactly (compared by Arrow, not row by row)."""
    assert got.schema == want.schema
    for gcol, wc in zip(got.columns, want.columns):
        gcol, wc = gcol.combine_chunks(), wc.combine_chunks()
        if not pa.types.is_floating(gcol.type):
            assert gcol.equals(wc)
            continue
        assert gcol.is_null().equals(wc.is_null())
        g = gcol.to_numpy(zero_copy_only=False)
        w = wc.to_numpy(zero_copy_only=False)
        with np.errstate(invalid="ignore"):  # inf - inf
            ok = np.isnan(g) & np.isnan(w) | (g == w) | \
                (np.abs(g - w) <= 1e-9 * np.maximum(1.0, np.abs(w)))
        assert bool(ok.all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CHAIN_QUERIES))
def test_k16_matches_plain_on_card(cuda, kind):
    table = chain_table(200_003)
    card, cpu = session("cuda", table), session("cpu", table)
    before = ch.run_chain.launches
    with Capture() as cap:
        got = card.sql(CHAIN_QUERIES[kind]).toArrow()
    assert ch.run_chain.launches > before
    for stage, child in cap.k16:
        cols, sel = xl.LocalExecutor._cols(child), child.device.sel
        kern, ksel = ch.run_chain(stage.prog, cols, sel)
        plain, psel = ch.run_chain_plain(stage.prog, cols, sel)
        assert torch.equal(ksel, psel)
        for k, p in zip(kern, plain):
            if kind in ULPS_KINDS:
                ulps_close(k, p)
            else:
                same_cv(k, p)
    if kind not in CPU_DIFFERS:
        _answers_equal(got, cpu.sql(CHAIN_QUERIES[kind]).toArrow())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(REDUCE_QUERIES))
def test_k17_matches_plain_on_card(cuda, kind):
    table = chain_table(200_003)
    card, cpu = session("cuda", table), session("cpu", table)
    before = ch.run_chain_reduce.launches
    with Capture() as cap:
        got = card.sql(REDUCE_QUERIES[kind]).toArrow()
    assert ch.run_chain_reduce.launches > before and cap.k17
    for ex, p, stage, child in cap.k17:
        cols, sel = xl.LocalExecutor._cols(child), child.device.sel
        kt = [p.input.schema[g].dtype for g in p.group_indices]
        at = [a.out_dtype for a in p.aggs]
        kern = ch.run_chain_reduce(stage.prog, cols, sel, kt, at)
        plain = ch.run_chain_reduce_plain(stage.prog, cols, sel, kt, at)
        assert torch.equal(kern.group_sel, plain.group_sel)
        live = plain.group_sel
        for k, q in zip(kern.keys, plain.keys):
            same_cv((k.data, k.validity), (q.data, q.validity), rows=live)
        for k, q in zip(kern.aggs, plain.aggs):
            same_cv((k.data, k.validity), (q.data, q.validity), rows=live,
                    exact=False, rtol=SUM_RTOL)
    _answers_equal(got, cpu.sql(REDUCE_QUERIES[kind]).toArrow())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(SORT_QUERIES))
def test_k18_matches_plain_on_card(cuda, kind):
    table = chain_table(200_003)
    card, cpu = session("cuda", table), session("cpu", table)
    before = ch.run_chain_sort.launches
    with Capture() as cap:
        got = card.sql(SORT_QUERIES[kind]).toArrow()
    assert ch.run_chain_sort.launches > before and cap.k18
    libm = kind == "sort_exprs"
    for stage, child, _ in cap.k18:
        cols, sel = xl.LocalExecutor._cols(child), child.device.sel
        kern = ch.run_chain_sort(stage.prog, cols, sel)
        plain = ch.run_chain_sort_plain(stage.prog, cols, sel)
        assert torch.equal(kern.sel, plain.sel)
        for k, p in zip(kern.cols, plain.cols):
            assert (k is None) == (p is None)
            if k is not None:
                (ulps_close if libm else same_cv)(k, p)
        for (kw, kv), (pw, pv) in zip(kern.words, plain.words):
            assert (kv is None) == (pv is None)
            assert kv is None or torch.equal(kv, pv)
            assert int((kw - pw).abs().max()) <= (8 if libm else 0)
        assert int((kern.ext - plain.ext).abs().max()) <= (8 if libm else 0)
    _answers_equal(got, cpu.sql(SORT_QUERIES[kind]).toArrow())


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
def test_pack_with_live_extremes_matches_plain_on_card(cuda, canonical):
    rng = np.random.default_rng(11)
    n = 1_000_003
    sel = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    keys = []
    for j, width in enumerate((1000, 70000, 3)):
        w = torch.from_numpy(rng.integers(-width, width, n)).to(cuda)
        v = None if j == 1 else torch.from_numpy(rng.random(n) < 0.8).to(cuda)
        keys.append((w, v, j != 2))
    ext = srt.key_extremes(keys, sel, canonical)
    layout = srt.pack_layout(keys, 0, ext.tolist(), canonical)
    assert layout is not None and layout.dead_only
    assert torch.equal(srt.window_pack(keys, sel, layout),
                       srt.window_pack_plain(keys, sel, layout))
    got = srt.sort_words(keys, sel, ext, canonical)
    zeroed = [(k if v is None or not canonical else torch.where(v, k, 0),
               v, nf) for k, v, nf in keys]
    n_live = int(sel.sum())
    assert torch.equal(got.perm[:n_live],
                       srt.lexsort_keys(zeroed, sel)[:n_live])


@pytest.mark.gpu
def test_subquery_values_share_one_compile(cuda):
    """Two sessions whose programs differ only in a scalar subquery's value
    launch one compiled kernel (while the first holds its programs, the
    second compiles and loads nothing), and a steady run compiles
    nothing; the answers are the CPU's."""
    sql = "SELECT i32 + (SELECT max(i16) FROM t) FROM t WHERE i32 > 0"
    table = chain_table(200_003)
    other = table.set_column(table.column_names.index("i16"), "i16",
                             pa.array(np.full(table.num_rows, 7,
                                              dtype=np.int16)))
    kernels, sessions = [], []
    for t in (table, other):
        spark = session("cuda", t)
        sessions.append(spark)
        with Capture() as cap:
            got = spark.sql(sql).toArrow()
        kernels.append([st.prog._kernel[1] for st, _ in cap.k16])
        _answers_equal(got, session("cpu", t).sql(sql).toArrow())
        if t is table:
            compiles, loads = csrc.jit_kernel.compiles, csrc.jit_kernel.loads
    assert kernels[0] and kernels[0] == kernels[1]
    assert (csrc.jit_kernel.compiles, csrc.jit_kernel.loads) == \
        (compiles, loads)
    spark.sql(sql).toArrow()
    assert (csrc.jit_kernel.compiles, csrc.jit_kernel.loads) == \
        (compiles, loads)


def _add_program(dev):
    """A K16 program of one output, x + a constant no other test uses."""
    x = ch.col(0, torch.int64, False)
    return ch.build_program([], [ch.strict(
        "add", x, ch.const(9_876_543_210, torch.int64), dtype=torch.int64)],
        dev)


@pytest.mark.gpu
def test_module_unloaded_when_no_program_holds_it(cuda):
    """A kernel's module stays loaded while a program holds the kernel and
    is unloaded after the last one goes (once the launch queued before
    has run); the same program built again loads the kept cubin without
    compiling and matches its plain version."""
    x = torch.arange(-50_000, 50_003, dtype=torch.int64, device=cuda)
    cols, sel = [(x, None)], x % 3 != 0
    (want,), want_sel = ch.run_chain_plain(_add_program(cuda), cols, sel)
    prog = _add_program(cuda)
    ch.run_chain(prog, cols, sel)
    _, kernel = chain_codegen.kernel(prog, cuda)
    key = (kernel.sha, torch.cuda.current_device())
    assert csrc._JIT[key] is kernel
    del prog, kernel
    gc.collect()
    assert key not in csrc._JIT
    compiles, loads = csrc.jit_kernel.compiles, csrc.jit_kernel.loads
    (got,), got_sel = ch.run_chain(_add_program(cuda), cols, sel)
    assert (csrc.jit_kernel.compiles, csrc.jit_kernel.loads) == \
        (compiles, loads + 1)
    assert torch.equal(got_sel, want_sel)
    same_cv(got, want)
