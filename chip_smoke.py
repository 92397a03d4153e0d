#!/usr/bin/env python3
"""Drive the sail_tpu_torch port on one CUDA card and check every part of it.

    python3 chip_smoke.py            # TPC-H SF10, kernels at SF10 shapes
    python3 chip_smoke.py --sf 1 --check-sf 0.1 --kernel-rows 2000000 --runs 1
                                     # a smaller, quicker run
    python3 chip_smoke.py --profile  # also trace each query once, with
                                     # its K1 (all launches, then by entry
                                     # point), K4, K5, K6 and K7 device ms,
                                     # its sorts and its host split

Phases, each of which fails the script (non-zero exit, no result line):

1. Device: the card's name, count and power limit.
2. Build: compile the CUDA kernels (sail_tpu_torch/csrc, one nvcc per
   source, all at once) and print the compiler's register report.
3. Kernels: run K1's two entry points (seg_reduce, binned;
   seg_reduce_runs, for sort-based grouping), K2 (direct_group_ids), K3
   (order_keys), K4 (join_keys), K5 (probe_ranges), K6 (join_expand) and
   K7's build and apply (bloom_build, bloom_apply) on the card at the
   main path's shapes (lineitem's ``--kernel-rows``, 60M at SF10, and the
   tables joined with it at their sizes), hold each against its plain
   PyTorch version on the same inputs, and time kernel, plain version
   and, where one exists, the one PyTorch call computing the same
   function. K1 runs at six shapes, each through the entry point its
   grouping takes: the runs kernel at the groupings of phase 5's lineitem
   that Q20, Q15, Q17 and Q18 make (group_rows as the executor calls it)
   and at l_orderkey's n/4 segments, the binned kernel at Q1's 12 bins;
   K5 at five (lineitem's l_orderkey into orders; l_partkey
   into part, with 98.5% and 1.3% of the probes live; into part filtered
   to 0.1%; l_suppkey into supplier), K6 at three (Q21's self-join, 1% of
   the probes live, a build key with 100,000 duplicates), K7 at the three
   filter sizes of ``FILTER_BITS`` (a filter of Q3's filtered orders
   applied to lineitem); the JSON entry carries each shape under
   ``shapes`` and the first shape's numbers as its own (the runs
   kernel's: those of the shape where ``index_add_`` comes closest).
4. Correctness: all 22 TPC-H queries at ``--check-sf`` (default 1, from
   ``generate_tpch_sf(sf, seed=0)``) through ``spark.sql(...).toArrow()``
   against the pandas oracle of tests/tpch_oracle.py, compared as the
   reference's TPC-H test compares; every answer is non-empty unless the
   oracle's is empty. Each run counts the host syncs the query makes
   (``torch.cuda.set_sync_debug_mode``).
5. Main path: all 22 queries at ``--sf`` (default 10), one warm-up and
   ``--runs`` timed runs each. The plans of Q2, Q5, Q8 and Q9 hold an
   intermediate that grows with the square of the scale factor (a cross
   join of filtered part x supplier in Q2, Q8 and Q9; supplier x customer
   on their nation in Q5); a query whose intermediate would exceed
   ``QUADRATIC_ROWS_MAX`` rows at that scale runs on phase 4's data, and
   says so. Q1 and Q6 also match a numpy oracle in exact integer decimal
   arithmetic. The launch counts are set to 0 before each query's warm-up
   and again before its first timed run, and read after that run: every
   query must launch the kernels ``PATH_KERNELS`` names for it.

It prints one ``{"kernels": [...]}`` JSON line (``launches`` is the sum
over the queries of their one-run counts, ``launches_on_path`` gives
each), the ``nvidia-smi`` name and power limit line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import datetime
import decimal
import json
import pathlib
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
_JOIN = ("join_keys", "probe_ranges")
# the kernels each main-path query must launch: every query with a keyed
# join launches K4 and K5; K6 and K7 are named where the plan always
# reaches them (Q13's and Q21's residual joins expand; Q5's and Q21's
# dimension filters prune their scans, so their runtime filters keep
# building)
PATH_KERNELS = {f"q{q}": _JOIN for q in range(1, 23) if q not in (1, 6)}
PATH_KERNELS.update({
    "q1": ("seg_reduce", "direct_group_ids", "order_keys"),
    "q6": ("seg_reduce",),
    "q5": _JOIN + ("bloom_build", "bloom_apply"),
    "q13": _JOIN + ("join_expand",),
    "q21": _JOIN + ("join_expand", "bloom_build", "bloom_apply"),
})
# the queries that group by sort: every aggregate there goes through K1's
# runs entry point
for _q in (2, 3, 7, 8, 9, 10, 11, 13, 15, 16, 17, 18, 20):
    PATH_KERNELS[f"q{_q}"] += ("seg_reduce_runs",)
# device functions of the kernels whose time and launches each profiled
# query reports: K1 over all its launches, then split by entry point (a
# runs call launches its grid, then one block over the grid's records)
PROFILED_KERNELS = {
    "K1 seg_reduce": re.compile(r"seg_reduce_kernel<|seg_runs_"),
    "K1 binned": re.compile(r"seg_reduce_kernel<"),
    "K1 runs": re.compile(r"seg_runs_kernel<"),
    "K1 runs merge": re.compile(r"seg_runs_merge_kernel<"),
    "K4 join_keys": re.compile(r"join_keys_kernel\("),
    "K5 probe_ranges": re.compile(r"probe_kernel\(|splitter_kernel\("),
    "K6 join_expand": re.compile(r"expand_kernel\("),
    "K7 bloom": re.compile(r"bloom_(build|apply)_kernel[<(]"),
}
# float64 sums add in an order that varies with the atomics: relative error
FLOAT_RTOL = 1e-12
# a query whose quadratic intermediate (quadratic_rows) is larger than this
# runs at the correctness phase's scale
QUADRATIC_ROWS_MAX = 2.5e8


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype.is_floating_point:
        both_nan = torch.isnan(got) & torch.isnan(want)
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError("NaN positions differ")
        if not torch.equal(torch.isinf(got), torch.isinf(want)) or \
                not torch.equal(got[torch.isinf(got)], want[torch.isinf(want)]):
            raise AssertionError("infinities differ")
        ok = ~(both_nan | torch.isinf(got))
        diff = (got[ok] - want[ok]).abs()
        tol = FLOAT_RTOL * want[ok].abs()
        if bool((diff > tol).any()):
            raise AssertionError(f"float mismatch beyond rel {FLOAT_RTOL}")
        return float(diff.max()) if diff.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError("integer results differ")
    return 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(n: int, dev: torch.device, lineitem: pa.Table) -> list:
    """Every kernel at the main path's shapes; K1 also at the groupings
    of ``lineitem`` (the main path's table) that four queries make."""
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.ops import sort as srt

    gen = torch.Generator(device=dev).manual_seed(0)
    # Q1's grouping: returnflag (3 codes) x linestatus (2 codes), 12 bins
    # and a dead-row bin; ~1.5% of rows fail the ship-date filter
    rf = torch.randint(0, 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    ls = torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.int32)
    sel = torch.rand(n, generator=gen, device=dev) < 0.985
    entries = []

    # K2 at Q1's keys
    k2 = lambda: agg.direct_group_ids([rf, ls], [None, None], [3, 2], sel)  # noqa: E731
    k2_plain = lambda: agg.direct_group_ids_plain(  # noqa: E731
        [rf, ls], [None, None], [3, 2], sel)
    (gid, counts), (gid_p, counts_p) = k2(), k2_plain()
    err = max(_max_abs_err(gid, gid_p), _max_abs_err(counts, counts_p))
    entries.append(dict(
        name="direct_group_ids", source="sail_tpu_torch/csrc/direct_group.cu",
        replaces="sail_tpu/ops/aggregate.py:146", max_abs_err=err,
        ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain, 3),
        bound_ms=_bound_ms(n * (4 + 4 + 1 + 4) + 12 * 8), library_ms=None))
    print(f"K2 direct_group_ids n={n}: exact", flush=True)

    # K1's binned entry point at Q1's grouping (12 bins; dead rows carry
    # id 12, which the kernel drops), every type and kind, with and
    # without a validity
    seg = gid
    S = 12
    vals = {
        "int64": torch.randint(0, 10_500_000 * 10_800, (n,), generator=gen,
                               device=dev, dtype=torch.int64),
        "int32": torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                               device=dev, dtype=torch.int32),
        "float64": torch.randn(n, generator=gen, device=dev,
                               dtype=torch.float64) * 1e4,
    }
    nan_vals = vals["float64"].clone()
    nan_vals[torch.rand(n, generator=gen, device=dev) < 1e-7] = float("nan")
    # the draws added since the other kernels' shapes were fixed take a
    # generator of their own, so those shapes keep their data
    k1_gen = torch.Generator(device=dev).manual_seed(3)
    valid = torch.rand(n, generator=k1_gen, device=dev) < 0.9
    k1_err = 0.0
    for label, v in list(vals.items()) + [("float64+NaN", nan_vals)]:
        for kind in ("sum", "min", "max"):
            for m in (None, valid):
                got = agg.seg_reduce(v, seg, S, kind, m)
                want = agg.seg_reduce_plain(v, seg, S, kind, m)
                k1_err = max(k1_err, _max_abs_err(got, want))
            print(f"K1 seg_reduce {kind} {label} n={n} S={S}, with and "
                  f"without validity: ok", flush=True)
    # times at each shape, int64 sums, through the entry point its
    # grouping takes: the binned kernel at Q1's 12 bins (direct grouping);
    # the runs kernel at the four sort-mode groupings of lineitem
    # (k1_query_shapes) and at l_orderkey's n/4 segments (Q3's and Q18's
    # grouping as the kernel phase has always timed it; perm the identity)
    v = vals["int64"]
    binned = check_binned_shape("Q1, 12 bins", v, seg, S)
    del valid
    runs_err, shapes = k1_query_shapes(lineitem, dev, k1_gen)
    # a generator of its own, so the later phases' data do not depend on
    # this shape
    lines = torch.randint(1, 8, (n // 4,), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    order_seg = torch.repeat_interleave(
        torch.arange(n // 4, device=dev, dtype=torch.int32), lines)[:n]
    order_seg = torch.cat([order_seg, order_seg[-1:].repeat(
        n - order_seg.shape[0])])
    shapes.append(check_runs_shape("l_orderkey, n/4 segments", v,
                                   _sorted_layout(order_seg, n // 4), n // 4,
                                   counts=False))
    del lines, order_seg
    entries.append(dict(
        name="seg_reduce", source="sail_tpu_torch/csrc/seg_reduce.cu",
        replaces="sail_tpu/ops/aggregate.py:208", max_abs_err=k1_err,
        ms=binned["ms"], plain_ms=binned["plain_ms"],
        bound_ms=binned["bound_ms"], library_ms=binned["library_ms"],
        shapes=[binned]))
    # the runs kernel's own numbers: those of the shape where index_add_
    # comes closest to it
    near = min(shapes, key=lambda x: x["library_ms"] / x["ms"])
    entries.append(dict(
        name="seg_reduce_runs", source="sail_tpu_torch/csrc/seg_reduce.cu",
        replaces="sail_tpu/ops/aggregate.py:208", max_abs_err=runs_err,
        ms=near["ms"], plain_ms=near["plain_ms"], bound_ms=near["bound_ms"],
        library_ms=near["library_ms"], shapes=shapes))

    # K3 over the main path's key types, both directions
    keys = {
        "int32": torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                               device=dev, dtype=torch.int32),
        "int64": vals["int64"],
        "float64": nan_vals,
        "date": torch.randint(8036, 10562, (n,), generator=gen, device=dev,
                              dtype=torch.int32),
    }
    for label, k in keys.items():
        for asc in (True, False):
            if not torch.equal(srt.order_keys(k, asc),
                               srt.order_keys_plain(k, asc)):
                raise AssertionError(f"order_keys {label} asc={asc} differs")
            print(f"K3 order_keys {label} ascending={asc} n={n}: exact",
                  flush=True)
    k = keys["int32"]
    entries.append(dict(
        name="order_keys", source="sail_tpu_torch/csrc/order_keys.cu",
        replaces="sail_tpu/ops/sort.py:48", max_abs_err=0.0,
        ms=cuda_ms(lambda: srt.order_keys(k)),
        plain_ms=cuda_ms(lambda: srt.order_keys_plain(k)),
        bound_ms=_bound_ms(n * (4 + 8)), library_ms=None))
    del vals, nan_vals, keys, v, k, rf, ls, gid, gid_p, seg
    torch.cuda.empty_cache()
    return entries + check_join_kernels(n, dev, gen)


def _sorted_layout(seg, S):
    """(ids, perm, n_live) of a sort-based grouping of row-order ids
    ``seg`` (dead rows at S): a stable sort, the groups renumbered densely
    in sort order, as group_rows numbers them."""
    ids, perm = torch.sort(seg, stable=True)
    live = ids < S
    new = live.clone()
    new[1:] &= ids[1:] != ids[:-1]
    dense = torch.cumsum(new.to(torch.int64), 0) - 1
    return torch.where(live, dense, S).to(torch.int32), perm, live.sum()


def _k1_line(out: dict) -> None:
    share = 100 * out["bound_ms"] / out["ms"]
    gather = f", gather {out['gather_ms']:.3f} ms" if "gather_ms" in out \
        else ""
    print(f"K1 {out['shape']}: n={out['n']} live={out['live']} groups="
          f"{out['groups']} S={out['segments']}"
          f"{' + counts' if out['counts'] else ''}: exact; {out['entry']} "
          f"{out['ms']:.3f} ms (bound {out['bound_ms']:.3f}, {share:.0f}%), "
          f"index_add_ {out['library_ms']:.3f} ms{gather}, plain "
          f"{out['plain_ms']:.3f} ms", flush=True)


def check_binned_shape(label, v, seg, S) -> dict:
    """K1's binned entry point on ids in row order (dead rows at S), an
    int64 sum, exact against its plain version and against index_add_
    into S + 1 slots (the dead rows into the last, cut off); then timed
    with both. Bound: the bytes it needs, each read once: n x 4 B ids +
    live rows x 8 B + S x 8 B written."""
    from sail_tpu_torch.ops import aggregate as agg

    n = v.shape[0]

    def binned():
        return agg.seg_reduce(v, seg, S, "sum")

    def plain():
        return agg.seg_reduce_plain(v, seg, S, "sum")

    def lib():
        return torch.zeros(S + 1, dtype=v.dtype, device=v.device).index_add_(
            0, seg, v)[:S]
    got = binned()
    _exact(f"seg_reduce {label}", [got], [plain()])
    if not torch.equal(got, lib()):
        raise AssertionError(f"seg_reduce {label} differs from index_add_")
    live = int((seg < S).sum())
    out = dict(shape=label, entry="binned", n=n, live=live,
               groups=int(torch.unique(seg[seg < S]).numel()), segments=S,
               counts=False, ms=cuda_ms(binned), library_ms=cuda_ms(lib),
               plain_ms=cuda_ms(plain, 3),
               bound_ms=_bound_ms(n * 4 + live * 8 + S * 8))
    _k1_line(out)
    return out


def check_runs_shape(label, v, layout, S, counts: bool) -> dict:
    """K1's runs entry point on one sort-based grouping (``layout``: the
    sorted ids, perm and n_live), an int64 sum and, when ``counts``, its
    count (as agg_sum takes them), exact against its plain version and
    the sum against index_add_ over the same layout (the live rows'
    values gathered through perm, added at their sorted ids); then timed
    with both and with that gather alone (``gather_ms``: the kernel's
    value reads as one PyTorch index, random where perm is). index_add_
    makes the sum alone. Bound: the bytes the kernel needs, each read
    once: live rows x (4 B id + 8 B perm + 8 B value) + S x (8 B + 8 B
    count) written."""
    from sail_tpu_torch.ops import aggregate as agg

    ids, perm, n_live = layout
    n = v.shape[0]
    live = int(n_live)
    args = (ids, perm, n_live, S, "sum", v, None, counts)

    def runs():
        return agg.seg_reduce_runs(*args)

    def plain():
        return agg.seg_reduce_runs_plain(*args)

    def lib():
        return torch.zeros(S, dtype=v.dtype, device=v.device).index_add_(
            0, ids[:live], v[perm[:live]])
    got = runs()
    _exact(f"seg_reduce_runs {label}", [t for t in got if t is not None],
           [t for t in plain() if t is not None])
    if not torch.equal(got[0], lib()):
        raise AssertionError(f"seg_reduce_runs {label} differs from "
                             f"index_add_")
    out = dict(shape=label, entry="runs", n=n, live=live,
               groups=int(ids[live - 1]) + 1 if live else 0, segments=S,
               counts=counts, ms=cuda_ms(runs), library_ms=cuda_ms(lib),
               gather_ms=cuda_ms(lambda: v[perm[:live]]),
               plain_ms=cuda_ms(plain, 3),
               bound_ms=_bound_ms(live * (4 + 8 + 8) + S * (8 + 8 * counts)))
    _k1_line(out)
    return out


def _days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def k1_query_shapes(lineitem: pa.Table, dev, gen):
    """K1 at the sort-mode groupings of lineitem that Q20, Q15, Q17 and
    Q18 aggregate, made by agg.group_rows as _exec_AggregateExec calls it
    (max_groups = n): Q20 live in 1994 by (l_partkey, l_suppkey), sum of
    l_quantity; Q15 live in 1996-01..03 by l_suppkey, sum of
    l_extendedprice * (1 - l_discount); Q17 every row by l_partkey and
    Q18 every row by l_orderkey, sum of l_quantity; each with its count.
    First, at Q20's grouping, the runs kernel against its plain version
    for every type and kind, with and without a validity and counts, and
    for the row index (first/last, the group keys). Returns (largest
    float error, the shape rows)."""
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.spec import data_type as dt

    def col(name):
        arr = lineitem.column(name)
        if pa.types.is_decimal(arr.type):
            data = _unscaled(arr)
        elif pa.types.is_date(arr.type):
            data = np.asarray(arr.combine_chunks().view(pa.int32()))
        else:
            data = arr.to_numpy()
        return torch.from_numpy(data).to(dev)

    def key(name):
        return Column(col(name), None, dt.LongType())
    ship, qty = col("l_shipdate"), col("l_quantity")
    n = qty.shape[0]
    every = torch.ones(n, dtype=torch.bool, device=dev)
    q20 = (ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
    q15 = (ship >= _days("1996-01-01")) & (ship < _days("1996-04-01"))
    revenue = col("l_extendedprice") * (100 - col("l_discount"))
    groupings = (
        ("Q20", [key("l_partkey"), key("l_suppkey")], q20, qty),
        ("Q15", [key("l_suppkey")], q15, revenue),
        ("Q17", [key("l_partkey")], every, qty),
        ("Q18", [key("l_orderkey")], every, qty))
    shapes, err = [], 0.0
    for label, keys, sel, v in groupings:
        ctx, _ = agg.group_rows(keys, sel, n)
        layout = (ctx.sorted_ids, ctx.perm, ctx.n_live)
        if label == "Q20":
            err = _check_runs_kinds(layout, n, dev, gen)
        shapes.append(check_runs_shape(label, v, layout, n, counts=True))
        del ctx, layout
    del ship, qty, revenue, every, q20, q15, groupings
    torch.cuda.empty_cache()
    return err, shapes


def _check_runs_kinds(layout, n, dev, gen) -> float:
    """The runs kernel on one sorted grouping against its plain version:
    int32, int64, float64 (positive, so no sum cancels; and with NaNs) and
    the row index, sum, min and max, with and without a validity."""
    from sail_tpu_torch.ops import aggregate as agg

    pos = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * 1e4
    nan = pos.clone()
    nan[torch.rand(n, generator=gen, device=dev) < 1e-4] = float("nan")
    vals = {
        "int32": torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                               device=dev, dtype=torch.int32),
        "int64": torch.randint(-2**62, 2**62, (n,), generator=gen,
                               device=dev, dtype=torch.int64),
        "float64": pos, "float64+NaN": nan, "row index": None}
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    err = 0.0
    for label, v in vals.items():
        for kind in ("sum", "min", "max"):
            if v is None and kind == "sum":
                continue
            for m in (None, valid):
                args = (*layout, n, kind, v, m, True)
                got = agg.seg_reduce_runs(*args)
                want = agg.seg_reduce_runs_plain(*args)
                err = max(err, _max_abs_err(got[0], want[0]))
                _exact("seg_reduce_runs count", got[1:], want[1:])
            print(f"K1 seg_reduce_runs {kind} {label} n={n} at Q20's "
                  f"grouping, with and without validity: ok", flush=True)
    return err


def _exact(name: str, got, want) -> None:
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} differs from its plain version")


def check_probe_shape(label, build, build_sel, probe_cols,
                      probe_sel) -> dict:
    """K5 on one shape: exact against its plain version, then timed with
    the plain version and searchsorted x2 (the library's two searches).
    Bound: the usable flags read and lo, cnt written (n * 9 bytes), the
    live rows' keys read and the usable build prefix read once;
    ``bound_ms_full_read`` counts every key and the whole build read."""
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import hash as hsh
    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.spec import data_type as dt

    bt = jn.build_side([Column(build, None, dt.LongType())], build_sel)
    keys, usable, _ = hsh.join_keys(probe_cols, probe_sel)
    args = (bt.sorted_keys, bt.num_valid, keys, usable)
    _exact("probe_ranges", jn.probe_ranges_kernel(*args),
           jn.probe_ranges_plain(*args))
    sk = bt.sorted_keys

    def lib():
        return (torch.searchsorted(sk, keys, side="left"),
                torch.searchsorted(sk, keys, side="right"))
    n, nb = keys.shape[0], sk.shape[0]
    live, nv = int(usable.sum()), int(bt.num_valid)
    out = dict(shape=label, n=n, nb=nb, num_valid=nv, live=live,
               ms=cuda_ms(lambda: jn.probe_ranges_kernel(*args)),
               plain_ms=cuda_ms(lambda: jn.probe_ranges_plain(*args), 3),
               library_ms=cuda_ms(lib),
               bound_ms=_bound_ms(n * (1 + 8) + live * 8 + nv * 8),
               bound_ms_full_read=_bound_ms(n * (8 + 1 + 8) + nb * 8))
    print(f"K5 probe_ranges {label}: {n} probes ({live} live) into {nb} "
          f"keys ({nv} usable): exact, {out['ms']:.3f} ms, searchsorted x2 "
          f"{out['library_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {out['bound_ms']:.3f} ms", flush=True)
    return out


def check_expand_shape(label, build, probe, build_sel, probe_sel) -> dict:
    """K6 on one inner-join shape: exact against its plain version, then
    timed with the plain version and repeat_interleave (the probe index
    alone). Bound: every row's offset read, cnt and lo of the rows with
    output, each perm entry the matches read once, 17 bytes a row written;
    ``bound_ms_full_read`` counts every input read in full."""
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.spec import data_type as dt

    bt = jn.build_side([Column(build, None, dt.LongType())], build_sel)
    r = jn.probe_ranges(bt, [Column(probe, None, dt.LongType())], probe_sel)
    eff = jn._effective_counts(r.cnt, probe_sel, "inner")
    offsets = torch.cumsum(eff, 0) - eff
    total = int(eff.sum())
    args = (eff, offsets, r.cnt, r.lo, bt.perm, total)
    _exact("join_expand", jn.expand_indices(*args),
           jn.expand_indices_plain(*args))
    n, nb = eff.shape[0], bt.perm.shape[0]
    rows_out = int((eff > 0).sum())
    touched = int(jn.build_matched_mask(bt, r, probe_sel).sum())
    arange = torch.arange(n, device=eff.device)
    out = dict(shape=label, n=n, nb=nb, rows_with_output=rows_out,
               total=total,
               ms=cuda_ms(lambda: jn.expand_indices(*args)),
               plain_ms=cuda_ms(lambda: jn.expand_indices_plain(*args), 3),
               library_ms=cuda_ms(lambda: torch.repeat_interleave(
                   arange, eff, output_size=total)),
               bound_ms=_bound_ms(n * 8 + rows_out * 8 + touched * 8
                                  + total * 17),
               bound_ms_full_read=_bound_ms(n * 24 + nb * 8 + total * 17))
    print(f"K6 join_expand {label}: {n} probes ({rows_out} with output) -> "
          f"{total} rows: exact, {out['ms']:.3f} ms, repeat_interleave "
          f"{out['library_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
          f"bound {out['bound_ms']:.3f} ms", flush=True)
    del bt, r, eff, offsets, args, arange
    torch.cuda.empty_cache()
    return out


def check_join_kernels(n: int, dev: torch.device, gen) -> list:
    """K4-K7 at the shapes lineitem (n rows) and the tables joined with it
    give them: orders n/4, supplier n/600, part n/30."""
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import hash as hsh
    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.spec import data_type as dt

    n_orders, n_supp, n_part = n // 4, max(1, n // 600), max(1, n // 30)
    entries = []
    sel = torch.rand(n, generator=gen, device=dev) < 0.985
    # K4: l_orderkey (packed) and (l_suppkey, l_partkey) (hashed)
    lines = torch.randint(1, 8, (n_orders,), generator=gen, device=dev)
    okeys = torch.arange(1, n_orders + 1, device=dev) * 4 - 3
    l_orderkey = torch.repeat_interleave(okeys, lines)[:n]
    l_orderkey = torch.cat([l_orderkey, okeys[-1].repeat(n - l_orderkey.shape[0])])
    l_suppkey = torch.randint(1, n_supp + 1, (n,), generator=gen, device=dev)
    l_partkey = torch.randint(1, n_part + 1, (n,), generator=gen, device=dev)
    packed = [Column(l_orderkey, None, dt.LongType())]
    hashed = [Column(l_suppkey, None, dt.LongType()),
              Column(l_partkey, None, dt.LongType())]
    for label, cols, seed in (("l_orderkey packed", packed, 0),
                              ("(l_suppkey, l_partkey) hashed", hashed, 0),
                              ("(l_suppkey, l_partkey) hashed", hashed, 1)):
        got = hsh.join_keys(cols, sel, seed)
        want = hsh.join_keys_plain(cols, sel, seed)
        _exact("join_keys", got[:2], want[:2])
        print(f"K4 join_keys {label} seed {seed} n={n}: exact, "
              f"{cuda_ms(lambda: hsh.join_keys(cols, sel, seed)):.3f} ms",
              flush=True)
    entries.append(dict(
        name="join_keys", source="sail_tpu_torch/csrc/join_keys.cu",
        replaces="sail_tpu/ops/hash.py:75", max_abs_err=0.0,
        ms=cuda_ms(lambda: hsh.join_keys(packed, sel)),
        plain_ms=cuda_ms(lambda: hsh.join_keys_plain(packed, sel), 3),
        bound_ms=_bound_ms(n * (8 + 1) + n * 9), library_ms=None))

    # K5 at the shapes the queries give it (PERF.md §6)
    order_sel = torch.rand(n_orders, generator=gen, device=dev) < 0.5
    probe_keys, probe_usable, _ = hsh.join_keys(packed, sel)
    part_keys = torch.arange(1, n_part + 1, device=dev)
    every_part = torch.ones(n_part, dtype=torch.bool, device=dev)
    k5_shapes = (
        # Q3/Q18-like: l_orderkey in lineitem order into half of orders
        ("orders", okeys, order_sel, packed, sel),
        # Q9/Q17/Q19-like: l_partkey, random over part, into all of part
        ("part random", part_keys, every_part, hashed[1:], sel),
        # Q14: the same probes, ~1.3% live (one month of l_shipdate)
        ("part, Q14 live", part_keys, every_part, hashed[1:],
         torch.rand(n, generator=gen, device=dev) < 0.013),
        # Q17: part filtered to ~0.1% (one brand and container)
        ("filtered part", part_keys,
         torch.rand(n_part, generator=gen, device=dev) < 0.001, hashed[1:],
         sel),
        # Q5/Q7/Q9-like: l_suppkey, random over supplier
        ("supplier", torch.arange(1, n_supp + 1, device=dev),
         torch.ones(n_supp, dtype=torch.bool, device=dev), hashed[:1], sel))
    k5 = [check_probe_shape(*shape) for shape in k5_shapes]
    main = k5[0]
    entries.append(dict(
        name="probe_ranges", source="sail_tpu_torch/csrc/join_probe.cu",
        replaces="sail_tpu/ops/join.py:117", max_abs_err=0.0,
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], library_ms=main["library_ms"],
        shapes=k5))

    # K6 at Q21's self-join (half of lineitem probes all of it on
    # l_orderkey), with 1% of lineitem live, and with a hot build key
    half = sel & (torch.rand(n, generator=gen, device=dev) < 0.5)
    sparse = sel & (torch.rand(n, generator=gen, device=dev) < 0.01)
    hot_build = l_orderkey.clone()
    hot_build[torch.randperm(n, generator=gen, device=dev)[:100_000]] = 1
    hot_probe = l_orderkey.clone()
    hot_rows = torch.randperm(n, generator=gen, device=dev)[:600]
    hot_probe[hot_rows] = 1
    hot_sel = sparse.clone()
    hot_sel[hot_rows] = True
    k6 = [check_expand_shape(*shape) for shape in (
        ("Q21 self-join", l_orderkey, l_orderkey, sel, half),
        ("1% live", l_orderkey, l_orderkey, sel, sparse),
        ("hot key x 100,000", hot_build, hot_probe, sel, hot_sel))]
    main = k6[0]
    entries.append(dict(
        name="join_expand", source="sail_tpu_torch/csrc/join_expand.cu",
        replaces="sail_tpu/ops/join.py:180", max_abs_err=0.0,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        library_ms=main["library_ms"], shapes=k6))
    del half, sparse, hot_build, hot_probe, hot_sel
    torch.cuda.empty_cache()

    # K7: a filter from Q3's filtered orders (~n/8 keys) applied to lineitem
    src = [Column(okeys, None, dt.LongType())]
    entries.extend(check_filter_kernels(src, order_sel, packed, sel))
    return entries


# K7's filter sizes: the executor's default (join.runtime_filter.max_bits),
# one that is no power of two, and one above the shared-memory limit
FILTER_BITS = (1 << 20, 1_000_003, 1 << 22)


def _key_bytes(cols, with_sel: bool = True) -> int:
    """Bytes a row of key columns (their validities) and sel takes."""
    return sum(c.data.element_size() + (c.validity is not None)
               for c in cols) + with_sel


def check_filter_kernels(src, src_sel, tgt, tgt_sel) -> list:
    """K7 build over the source's key columns and K7 apply over the
    target's, at each of FILTER_BITS: each exact against its plain version,
    then timed with it. Bounds: build reads its key columns and sel and
    writes 9 bytes a row and the words; apply reads its key columns, sel
    and the words and writes 1 byte a row. At 1 << 20 bits both are also
    timed as the whole call the executor makes (runtime_filter.build, which
    adds the ndv sort, and runtime_filter.apply, the kernel's wrapper), and
    with 1.3% of the rows live."""
    from sail_tpu_torch.ops import runtime_filter as rf

    ns, nt = src_sel.shape[0], tgt_sel.shape[0]
    rows = {"bloom_build": [], "bloom_apply": []}
    for bits in FILTER_BITS:
        built = rf.filter_build(src, src_sel, bits)
        _exact("bloom_build", [t for t in built if torch.is_tensor(t)],
               [t for t in rf.filter_build_plain(src, src_sel, bits)
                if torch.is_tensor(t)])
        res = rf.build(src, src_sel, bits)
        kept = rf.apply(res, tgt, tgt_sel)
        _exact("bloom_apply", [kept], [rf.filter_apply_plain(res, tgt,
                                                             tgt_sel)])
        words = res.words.numel() * 4
        build = dict(shape=f"{bits} bits", n=ns, keys=int(built.n_build),
                     ms=cuda_ms(lambda: rf.filter_build(src, src_sel, bits)),
                     plain_ms=cuda_ms(lambda: rf.filter_build_plain(
                         src, src_sel, bits), 3),
                     bound_ms=_bound_ms(ns * (_key_bytes(src) + 9) + words))
        apply = dict(shape=f"{bits} bits", n=nt, kept=int(kept.sum()),
                     ms=cuda_ms(lambda: rf.apply(res, tgt, tgt_sel)),
                     plain_ms=cuda_ms(lambda: rf.filter_apply_plain(
                         res, tgt, tgt_sel), 3),
                     bound_ms=_bound_ms(nt * (_key_bytes(tgt) + 1) + words))
        shapes = [("bloom_build", build), ("bloom_apply", apply)]
        if bits == FILTER_BITS[0]:
            build["pipeline_ms"] = cuda_ms(lambda: rf.build(src, src_sel,
                                                            bits))
            shapes += _sparse_rows(res, src, src_sel, tgt, tgt_sel)
        for name, row in shapes:
            rows[name].append(row)
            print(f"K7 {name} {row['shape']}: {row['n']} rows, exact, "
                  f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"bound {row['bound_ms']:.3f} ms" + (
                      f", pipeline_ms {row['pipeline_ms']:.3f} ms"
                      if "pipeline_ms" in row else ""), flush=True)
    return [_filter_entry(name, shapes) for name, shapes in rows.items()]


def _sparse_rows(res, src, src_sel, tgt, tgt_sel) -> list:
    """K7 build and apply with 1.3% of the rows live (Q14's share of
    lineitem): each exact against its plain version, then timed. Bounds:
    build still derives and writes every row's key; apply reads sel and
    writes out for every row, and the keys of the live rows only."""
    from sail_tpu_torch.ops import runtime_filter as rf

    gen = torch.Generator(device=tgt_sel.device).manual_seed(2)
    ssel = src_sel & (torch.rand(src_sel.shape[0], generator=gen,
                                 device=src_sel.device) < 0.013)
    tsel = tgt_sel & (torch.rand(tgt_sel.shape[0], generator=gen,
                                 device=tgt_sel.device) < 0.013)
    bits, words = res.num_bits, res.words.numel() * 4
    _exact("bloom_build sparse",
           [t for t in rf.filter_build(src, ssel, bits) if torch.is_tensor(t)],
           [t for t in rf.filter_build_plain(src, ssel, bits)
            if torch.is_tensor(t)])
    kept = rf.apply(res, tgt, tsel)
    _exact("bloom_apply sparse", [kept], [rf.filter_apply_plain(res, tgt,
                                                                tsel)])
    ns, nt = ssel.shape[0], tsel.shape[0]
    slive, tlive = int(ssel.sum()), int(tsel.sum())
    shape = f"{bits} bits, 1.3% live"
    return [
        ("bloom_build", dict(
            shape=shape, n=ns, live=slive,
            ms=cuda_ms(lambda: rf.filter_build(src, ssel, bits)),
            plain_ms=cuda_ms(lambda: rf.filter_build_plain(src, ssel, bits),
                             3),
            bound_ms=_bound_ms(ns * (_key_bytes(src) + 9) + words))),
        ("bloom_apply", dict(
            shape=shape, n=nt, live=tlive, kept=int(kept.sum()),
            ms=cuda_ms(lambda: rf.apply(res, tgt, tsel)),
            plain_ms=cuda_ms(lambda: rf.filter_apply_plain(res, tgt, tsel),
                             3),
            bound_ms=_bound_ms(nt * 2 + tlive * (_key_bytes(tgt) - 1)
                               + words)))]


def _filter_entry(name: str, shapes: list) -> dict:
    main = shapes[0]
    return dict(name=name, source="sail_tpu_torch/csrc/bloom.cu",
                replaces="sail_tpu/ops/runtime_filter.py:"
                + ("62" if name == "bloom_build" else "94"),
                max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], library_ms=None, shapes=shapes)


# ---------------------------------------------------------------------------
# phase 4: the main path, and its oracle
# ---------------------------------------------------------------------------

def _unscaled(col) -> np.ndarray:
    arr = col.combine_chunks()
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    return words[2 * arr.offset::2][: len(arr)].copy()


def _codes(col, values) -> np.ndarray:
    """Codes of a dictionary column against the ``values`` order."""
    arr = col.combine_chunks()
    remap = np.array([list(values).index(v)
                      for v in arr.dictionary.to_pylist()])
    return remap[np.asarray(arr.indices)]


def oracle(table: pa.Table):
    """Q1 rows and the Q6 revenue in exact integer arithmetic (unscaled
    decimals), by a group-at-a-time numpy pass."""
    qty = _unscaled(table.column("l_quantity"))
    price = _unscaled(table.column("l_extendedprice"))
    disc = _unscaled(table.column("l_discount"))
    tax = _unscaled(table.column("l_tax"))
    ship = np.asarray(table.column("l_shipdate").combine_chunks()
                      .view(pa.int32()))
    rf = _codes(table.column("l_returnflag"), "ANR")
    ls = _codes(table.column("l_linestatus"), "FO")
    epoch = datetime.date(1970, 1, 1)
    q1_cut = (datetime.date(1998, 9, 2) - epoch).days
    keep = ship <= q1_cut
    q1 = []
    for r in range(3):
        for s in range(2):
            m = keep & (rf == r) & (ls == s)
            cnt = int(m.sum())
            if not cnt:
                continue
            q, p, d, t = qty[m], price[m], disc[m], tax[m]
            disc_price = p * (100 - d)
            q1.append(("ANR"[r], "FO"[s], int(q.sum()), int(p.sum()),
                       int(disc_price.sum()),
                       int((disc_price * (100 + t)).sum()),
                       q.sum() / 100 / cnt, p.sum() / 100 / cnt,
                       d.sum() / 100 / cnt, cnt))
    lo = (datetime.date(1994, 1, 1) - epoch).days
    hi = (datetime.date(1995, 1, 1) - epoch).days
    m6 = (ship >= lo) & (ship < hi) & (disc >= 5) & (disc <= 7) & (qty < 2400)
    return q1, int((price[m6] * disc[m6]).sum())


def _unscaled_result(arr: pa.Array) -> list:
    scale = arr.type.scale
    return [int(v.scaleb(scale)) for v in arr.to_pylist()]


def check_q1(result: pa.Table, want) -> None:
    if result.num_rows != len(want):
        raise AssertionError(f"Q1: {result.num_rows} rows, oracle {len(want)}")
    cols = result.columns
    dec = [_unscaled_result(cols[i].combine_chunks()) for i in (2, 3, 4, 5)]
    for i, row in enumerate(want):
        got_keys = (cols[0][i].as_py(), cols[1][i].as_py())
        if got_keys != row[:2]:
            raise AssertionError(f"Q1 row {i}: keys {got_keys} != {row[:2]}")
        if [d[i] for d in dec] != list(row[2:6]):
            raise AssertionError(f"Q1 row {i}: decimal sums differ")
        for j, w in zip((6, 7, 8), row[6:9]):
            g = cols[j][i].as_py()
            if abs(g - w) > FLOAT_RTOL * abs(w):
                raise AssertionError(f"Q1 row {i} col {j}: {g} != {w}")
        if cols[9][i].as_py() != row[9]:
            raise AssertionError(f"Q1 row {i}: count differs")


def _sort_ms(roots) -> float:
    """Device ms of the torch sorts run inside the ``roots`` events (an
    outer sort's time includes any sort it calls)."""
    total, stack = 0.0, list(roots)
    while stack:
        e = stack.pop()
        if e.name == "aten::sort":
            total += e.device_time_total / 1e3
        else:
            stack.extend(e.cpu_children)
    return total


def profile_query(spark, sql: str) -> dict:
    """One more run of ``sql`` under torch.profiler: device time by kernel,
    the device's busy share of the wall time (profiler overhead included
    in the wall), the device time of the sorts of the joins' build sides
    and of the runtime filters' ndv counts (their calls run inside named
    ranges for this run), and the host's split: the self time on the
    host of each operator and CUDA runtime call (the wall less their sum
    is Python and the profiler)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.ops import runtime_filter as rf

    def labelled(fn, label):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    build_side, rtf_build = jn.build_side, rf.build
    jn.build_side = labelled(build_side, "sail.build_side")
    rf.build = labelled(rtf_build, "sail.runtime_filter_build")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            spark.sql(sql).toArrow()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        jn.build_side, rf.build = build_side, rtf_build
    # device-side events only (kernels, copies): a CPU op's own entry
    # would count its kernels a second time, and so would the device-side
    # spans of the named ranges
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and not e.key.startswith("sail.")]
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events if e.self_device_time_total > 0),
                     key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in by_name)
    kernel_ms = {k: sum(ms for name, ms, _ in by_name if pat.search(name))
                 for k, pat in PROFILED_KERNELS.items()}
    kernel_launches = {k: sum(c for name, _, c in by_name
                              if pat.search(name))
                       for k, pat in PROFILED_KERNELS.items()}
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if not str(e.device_type).endswith("CUDA")
                   and not e.key.startswith("sail.")
                   and e.self_cpu_time_total > 0), key=lambda x: -x[1])
    host_ms = sum(ms for _, ms, _ in host)
    fevents = prof.events()
    sort_ms = {"all": _sort_ms(e for e in fevents if e.cpu_parent is None)}
    for key, label in (("build_side", "sail.build_side"),
                       ("runtime_filter_ndv", "sail.runtime_filter_build")):
        sort_ms[key] = _sort_ms(e for e in fevents if e.name == label)
    print(f"  profile: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%), {len(by_name)} kernels; "
          + ", ".join(f"{k} {ms:.3f} ms x{kernel_launches[k]}"
                      for k, ms in kernel_ms.items())
          + "; sorts " + ", ".join(f"{k} {ms:.3f} ms"
                                   for k, ms in sort_ms.items()))
    for name, ms, count in by_name[:15]:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    print(f"  host: operators and runtime calls {host_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall (self time); "
          + ", ".join(f"{name} {ms:.2f} ms x{count}"
                      for name, ms, count in host[:10]))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_ms": kernel_ms, "kernel_launches": kernel_launches,
            "sort_ms": sort_ms,
            "top": [[n[:90], ms, c] for n, ms, c in by_name[:15]],
            "host_ms": host_ms,
            "host_top": [[n[:90], ms, c] for n, ms, c in host[:15]]}


# ---------------------------------------------------------------------------
# phase 4: all 22 queries against the pandas oracle
# ---------------------------------------------------------------------------

def _pandas_frames(tables: dict) -> dict:
    """The oracle's inputs: strings decoded, decimals as float64, dates as
    datetime64 (the reference's TPC-H test feeds its oracle the same)."""
    import pandas as pd

    out = {}
    for name, table in tables.items():
        cols = {}
        for cname, col in zip(table.column_names, table.columns):
            if pa.types.is_dictionary(col.type):
                col = col.cast(pa.string())
            elif pa.types.is_decimal(col.type):
                col = col.cast(pa.float64())
            cols[cname] = col
        df = pa.table(cols).to_pandas()
        for cname, col in zip(table.column_names, table.columns):
            if pa.types.is_date(col.type):
                df[cname] = pd.to_datetime(df[cname])
        out[name] = df
    return out


def _normalize(df):
    """tests/test_tpch.py's normalisation: positional names, decimals to
    float, dates to datetime64, integers to int64, floats rounded to 4
    places."""
    import pandas as pd

    out = df.copy()
    out.columns = [f"c{i}" for i in range(len(out.columns))]
    for c in out.columns:
        s = out[c]
        if s.dtype == object and len(s):
            first = next((v for v in s if v is not None), None)
            if first is None:  # all-NULL column (e.g. SUM over zero rows)
                out[c] = pd.Series([np.nan] * len(s), dtype=np.float64)
            elif isinstance(first, decimal.Decimal):
                out[c] = s.astype(np.float64)
            elif isinstance(first, datetime.date):
                out[c] = pd.to_datetime(s)
        if str(out[c].dtype).startswith("datetime64"):
            out[c] = pd.to_datetime(out[c]).dt.normalize()
            out[c] = out[c].astype("datetime64[us]")
        if out[c].dtype.kind in "iu":
            out[c] = out[c].astype(np.int64)
        if out[c].dtype.kind == "f":
            out[c] = out[c].astype(np.float64).round(4)
    return out.reset_index(drop=True)


# queries whose ORDER BY leaves ties: compared as sets (tests/test_tpch.py)
_UNORDERED = {2, 11, 13, 16, 18, 21}


def compare_with_oracle(got, exp, q: int) -> None:
    """tests/test_tpch.py's comparison: row count, then every column,
    floats within rtol 1e-6 / atol 1e-4 after rounding to 4 places."""
    got_n, exp_n = _normalize(got), _normalize(exp)
    if len(got_n) != len(exp_n):
        raise AssertionError(f"Q{q}: {len(got_n)} rows, oracle {len(exp_n)}")
    if q in _UNORDERED:
        cols = list(got_n.columns)
        got_n = got_n.sort_values(cols).reset_index(drop=True)
        exp_n = exp_n.sort_values(cols).reset_index(drop=True)
    for c in got_n.columns:
        g, e = got_n[c], exp_n[c]
        if g.dtype.kind == "f":
            ok = (g.isna() & e.isna()) | np.isclose(
                g.fillna(0), e.fillna(0), rtol=1e-6, atol=1e-4)
        else:
            ok = (g == e) | (g.isna() & e.isna())
        if not ok.all():
            raise AssertionError(f"Q{q} column {c}: {g[~ok].head().tolist()}"
                                 f" != {e[~ok].head().tolist()}")


def _register(spark, tables: dict) -> None:
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)


def _run_counting_syncs(spark, sql: str):
    """Run a query once; returns (Arrow result, the number of operations
    that made the host wait for the device)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = spark.sql(sql).toArrow()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return result, syncs


def check_queries(spark, tables: dict, sf: float) -> dict:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
    from tpch_oracle import ORACLES

    t = time.perf_counter()
    frames = _pandas_frames(tables)
    print(f"oracle inputs SF{sf}: {time.perf_counter() - t:.1f} s", flush=True)
    report = {}
    for q in range(1, 23):
        t = time.perf_counter()
        result, syncs = _run_counting_syncs(spark, QUERIES[q])
        run_s = time.perf_counter() - t
        exp = ORACLES[q](frames)
        if result.num_rows == 0 and len(exp):
            raise AssertionError(f"Q{q}: empty answer, oracle has {len(exp)}")
        compare_with_oracle(result.to_pandas(), exp, q)
        report[f"q{q}"] = dict(rows=result.num_rows, host_syncs=syncs,
                               first_s=run_s)
        print(f"Q{q} SF{sf}: {result.num_rows} rows match the oracle "
              f"({syncs} host syncs, first run {run_s:.2f} s)", flush=True)
    return report


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def quadratic_rows(tables: dict, q: int) -> int:
    """Rows of the intermediate of Q2, Q5, Q8 or Q9 that grows with the
    square of the scale factor (0 for the other queries), from the data:
    the cross join of filtered part x supplier (Q2's suppliers are those
    of EUROPE) or, in Q5, supplier x customer joined on their nation
    within ASIA."""
    part, supp = tables["part"], tables["supplier"]
    nation = tables["nation"]

    def region_nations(region: int) -> np.ndarray:
        keep = pc.equal(nation.column("n_regionkey"), region)
        return pc.filter(nation.column("n_nationkey"), keep).to_numpy()

    def per_nation(table: str, column: str) -> np.ndarray:
        return np.bincount(tables[table].column(column).to_numpy(),
                           minlength=25)

    ptype = part.column("p_type").cast(pa.string())
    if q == 9:
        parts = pc.match_substring(part.column("p_name").cast(pa.string()),
                                   "green")
        return int(pc.sum(parts).as_py()) * supp.num_rows
    if q == 8:
        parts = pc.equal(ptype, "ECONOMY ANODIZED STEEL")
        return int(pc.sum(parts).as_py()) * supp.num_rows
    if q == 2:
        parts = pc.and_(pc.equal(part.column("p_size"), 15),
                        pc.ends_with(ptype, "BRASS"))
        eu = per_nation("supplier", "s_nationkey")[region_nations(3)].sum()
        return int(pc.sum(parts).as_py()) * int(eu)
    if q == 5:
        asia = region_nations(2)
        return int((per_nation("supplier", "s_nationkey")[asia]
                    * per_nation("customer", "c_nationkey")[asia]).sum())
    return 0


def _counters():
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.ops import hash as hsh
    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.ops import runtime_filter as rf
    from sail_tpu_torch.ops import sort as srt
    return {"seg_reduce": agg.seg_reduce,
            "seg_reduce_runs": agg.seg_reduce_runs,
            "direct_group_ids": agg.direct_group_ids,
            "order_keys": srt.order_keys, "join_keys": hsh.join_keys,
            "probe_ranges": jn.probe_ranges_kernel,
            "join_expand": jn.expand_indices,
            "bloom_build": rf.filter_build, "bloom_apply": rf.apply}


def run_main_path(tables: dict, sf: float, runs: int, small,
                  profile: bool) -> dict:
    """``tables``: TPC-H at ``sf``; ``small``: (session, tables, scale
    factor) of phase 4, where a query whose cross join is too large at
    ``sf`` runs."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
    from sail_tpu_torch.columnar import arrow_interop

    want_q1, want_q6 = oracle(tables["lineitem"])

    # time every upload (Arrow -> card) the scans make
    upload = {"s": 0.0, "bytes": 0}
    from_arrow = arrow_interop.from_arrow

    def timed_from_arrow(tbl, device):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = from_arrow(tbl, device)
        torch.cuda.synchronize()
        upload["s"] += time.perf_counter() - t
        upload["bytes"] += tbl.nbytes
        return out

    arrow_interop.from_arrow = timed_from_arrow
    spark = SparkSession.builder.getOrCreate()
    if spark.device.type != "cuda":
        raise AssertionError(f"session runs on {spark.device}, not cuda")
    _register(spark, tables)
    counters = _counters()

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    torch.cuda.reset_peak_memory_stats()
    small_spark, small_tables, small_sf = small
    report = {"launches_on_path": {}}
    for q in range(1, 23):
        qrows = quadratic_rows(tables, q)
        session, q_sf = spark, sf
        if qrows > QUADRATIC_ROWS_MAX:
            session, q_sf = small_spark, small_sf
            print(f"Q{q}: an intermediate of {qrows} rows at SF{sf} exceeds "
                  f"{QUADRATIC_ROWS_MAX:.0f}; runs at SF{small_sf} "
                  f"({quadratic_rows(small_tables, q)} rows)", flush=True)
        upload_before = upload["s"]
        zero_counts()
        t = time.perf_counter()
        result = session.sql(QUERIES[q]).toArrow()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        times = []
        for i in range(runs):
            if i == 0:
                zero_counts()
            t = time.perf_counter()
            result = session.sql(QUERIES[q]).toArrow()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                # the launches of this path's one run, counted from 0
                launches = {n: fn.launches for n, fn in counters.items()}
                filters = session.last_runtime_filters
        report["launches_on_path"][f"q{q}"] = launches
        entry = dict(sf=q_sf, quadratic_rows=quadratic_rows(
            tables if session is spark else small_tables, q),
            first_s=first, upload_s=upload["s"] - upload_before,
            query_s=times, rows=result.num_rows, runtime_filters=filters)
        if profile:
            entry["profile"] = profile_query(session, QUERIES[q])
        if q == 1:
            check_q1(result, want_q1)
        elif q == 6:
            got = _unscaled_result(result.column(0).combine_chunks())
            if got != [want_q6]:
                raise AssertionError(f"Q6: {got} != {[want_q6]}")
        report[f"q{q}"] = entry
        print(f"Q{q} SF{q_sf}: first run {first:.3f} s (upload "
              f"{entry['upload_s']:.3f} s), then "
              f"{', '.join(f'{x * 1e3:.1f} ms' for x in times)}; "
              f"{result.num_rows} rows; launches in one run "
              f"{ {k: v for k, v in launches.items() if v} }; runtime "
              f"filters (scan rows, mask rows) "
              f"{[(f['scan_rows'], f['mask_rows']) for f in filters]}",
              flush=True)
        for name in PATH_KERNELS[f"q{q}"]:
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched on Q{q}'s path")
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    report["upload_bytes"] = upload["bytes"]
    print(f"peak device memory {report['peak_bytes'] / 2**30:.2f} GiB; "
          f"uploaded {upload['bytes'] / 2**30:.2f} GiB", flush=True)
    spark.stop()
    arrow_interop.from_arrow = from_arrow
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the main path (default 10)")
    ap.add_argument("--check-sf", type=float, default=1.0,
                    help="scale factor of the oracle check (default 1)")
    ap.add_argument("--kernel-rows", type=int, default=60_000_000,
                    help="lineitem rows of the kernel checks (default 60M, "
                         "SF10's)")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs of each query (default 3)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one more run of each query with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--report", type=pathlib.Path,
                    help="also write the whole report as JSON to this file")
    args = ap.parse_args()
    if args.runs < 1:
        ap.error("--runs must be at least 1: the launches are read in the "
                 "first timed run")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sail_tpu_torch import SparkSession, csrc
    from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; {smi}", flush=True)
    phases = {}

    t = time.perf_counter()
    csrc.build()
    phases["build"] = time.perf_counter() - t
    print(f"built the kernels in {phases['build']:.1f} s", flush=True)
    for src, log in csrc.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {src}: {line.strip()}")

    t = time.perf_counter()
    tables = generate_tpch_sf(args.sf, seed=0)
    phases["generate"] = time.perf_counter() - t
    print(f"generated TPC-H SF{args.sf}: lineitem "
          f"{tables['lineitem'].num_rows} rows in {phases['generate']:.1f} s",
          flush=True)

    t = time.perf_counter()
    entries = check_kernels(args.kernel_rows, dev, tables["lineitem"])
    phases["kernels"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    t = time.perf_counter()
    small_tables = generate_tpch_sf(args.check_sf, seed=0)
    small = SparkSession({"spark.sail.device": "cuda"})
    _register(small, small_tables)
    checks = check_queries(small, small_tables, args.check_sf)
    phases["correctness"] = time.perf_counter() - t

    t = time.perf_counter()
    report = run_main_path(tables, args.sf, args.runs,
                           (small, small_tables, args.check_sf), args.profile)
    phases["main_path"] = time.perf_counter() - t
    print(f"phase wall times (s): {phases}", flush=True)
    on_path = report["launches_on_path"]
    kernels = [dict(name=e["name"], route="cuda", source=e["source"],
                    replaces=e["replaces"],
                    launches=sum(c[e["name"]] for c in on_path.values()),
                    launches_on_path={q: c[e["name"]]
                                      for q, c in on_path.items()},
                    max_abs_err=e["max_abs_err"], ms=e["ms"],
                    plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                    bound_by="bytes", library_ms=e["library_ms"],
                    **({"shapes": e["shapes"]} if "shapes" in e else {}))
               for e in entries]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} launched on no query's path")
    full = {"main_path": report, "checks": checks, "sf": args.sf,
            "check_sf": args.check_sf, "phases_s": phases,
            "kernel_rows": args.kernel_rows, "kernels": kernels, "smi": smi}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(full, indent=1))
    print(json.dumps({k: full[k] for k in ("main_path", "checks", "sf",
                                           "check_sf", "phases_s")}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
