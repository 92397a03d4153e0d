"""K16 and K17 (``sail_tpu_torch/csrc/chain.cu``) on the card against
their plain versions. Every chain of the chain tests' queries runs in a
session on the card; each K16 launch is held to ``run_chain_plain`` and
each K17 launch to ``run_chain_reduce_plain`` on the same inputs on the
card: integers, decimals, dates, codes and bools exactly, float64 exactly
(the kernel makes the same IEEE operations, without FMA contraction)
except where a chain calls a K12/K14 transcendental function, which the
card's math library and torch's may round an ulp apart (within 8 ulp, as
K12 and K14 are held), and K17's float sums within a relative 1e-12 (their
order varies). The answers must equal the CPU session's. Needs a card:
``python -m pytest tests/test_torch_chain_card.py -m gpu``.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch.exec import local as xl
from sail_tpu_torch.ops import chain as ch
from torch_chain_common import (CHAIN_QUERIES, REDUCE_QUERIES, Capture,
                                chain_table, same_cv, session)

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


def _ulps_close(g, w):
    """(data, validity) within 8 ulp where valid (NaN-aware)."""
    (gd, gv), (wd, wv) = g, w
    assert (gv is None) == (wv is None)
    keep = torch.ones_like(wd, dtype=torch.bool) if wv is None else wv
    if gv is not None:
        assert torch.equal(gv, wv)
    gd, wd = gd[keep], wd[keep]
    if not gd.is_floating_point():
        assert torch.equal(gd, wd)
        return
    assert torch.equal(torch.isnan(gd), torch.isnan(wd))
    fin = ~torch.isnan(wd)
    gd, wd = gd[fin], wd[fin]
    inf = torch.isinf(wd)
    assert torch.equal(gd[inf], wd[inf])
    ulp = torch.nextafter(wd.abs(), torch.full_like(wd, float("inf"))) - \
        wd.abs()
    assert bool(((gd - wd).abs()[~inf] <= 8 * ulp[~inf]).all())


def _answers_equal(got, want):
    """The same rows: float columns NaN-aware within a relative 1e-9,
    every other column exactly (compared by Arrow, not row by row)."""
    assert got.schema == want.schema
    for gc, wc in zip(got.columns, want.columns):
        gc, wc = gc.combine_chunks(), wc.combine_chunks()
        if not pa.types.is_floating(gc.type):
            assert gc.equals(wc)
            continue
        assert gc.is_null().equals(wc.is_null())
        g = gc.to_numpy(zero_copy_only=False)
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
                _ulps_close(k, p)
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
