#!/usr/bin/env python3
"""Drive the sail_tpu_torch port on one CUDA card and check every part of it.

    python3 chip_smoke.py            # TPC-H SF10, kernels at SF10 shapes
    python3 chip_smoke.py --sf 1 --check-sf 0.1 --kernel-rows 2000000 --runs 1
                                     # a smaller, quicker run
    python3 chip_smoke.py --profile  # also trace each query once, with
                                     # its K1 (global path), K4, K5, K6
                                     # and K7 device ms and its sorts

Phases, each of which fails the script (non-zero exit, no result line):

1. Device: the card's name, count and power limit.
2. Build: compile the CUDA kernels (sail_tpu_torch/csrc, one nvcc per
   source, all at once) and print the compiler's register report.
3. Kernels: run K1 (seg_reduce), K2 (direct_group_ids), K3 (order_keys),
   K4 (join_keys), K5 (probe_ranges), K6 (join_expand) and K7's build
   and apply (bloom_build, bloom_apply) on the card at the main path's
   shapes (lineitem's ``--kernel-rows``, 60M at SF10, and the tables
   joined with it at their sizes), hold each against its plain PyTorch
   version on the same inputs, and time kernel, plain version and, where
   one exists, the one PyTorch call computing the same function. K1 runs
   at two shapes (Q1's 13 segments; l_orderkey's n/4, Q3's and Q18's
   grouping), K5 at five (lineitem's l_orderkey into orders; l_partkey
   into part, with 98.5% and 1.3% of the probes live; into part filtered
   to 0.1%; l_suppkey into supplier), K6 at three (Q21's self-join, 1% of
   the probes live, a build key with 100,000 duplicates), K7 at the three
   filter sizes of ``FILTER_BITS`` (a filter of Q3's filtered orders
   applied to lineitem); the JSON entry carries each shape under
   ``shapes`` and the first shape's numbers as its own.
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
# device functions of the kernels whose time and launches each profiled
# query reports (K1's global-atomic path: more than 4,097 segments)
PROFILED_KERNELS = {
    "K1 seg_reduce, global": re.compile(r"seg_reduce_kernel<[^>]*false>"),
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

def check_kernels(n: int, dev: torch.device) -> list:
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

    # K1 at Q1's segments (12 groups + the dead bin), every type and kind
    seg = gid
    S = 13
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
    k1_err = 0.0
    for label, v in list(vals.items()) + [("float64+NaN", nan_vals)]:
        for kind in ("sum", "min", "max"):
            got = agg.seg_reduce(v, seg, S, kind)
            want = agg.seg_reduce_plain(v, seg, S, kind)
            k1_err = max(k1_err, _max_abs_err(got, want))
            print(f"K1 seg_reduce {kind} {label} n={n} S={S}: ok", flush=True)
    # times at the dominant case of the path: int64 sums, at Q1's 13
    # segments (in shared memory) and at Q3's and Q18's grouping on
    # l_orderkey (~n/4 segments, global atomics)
    v = vals["int64"]
    k1 = [check_seg_reduce_shape(f"Q1, {S} segments", v, seg, S)]
    # a generator of its own, so the later phases' data do not depend on
    # this shape
    lines = torch.randint(1, 8, (n // 4,), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    order_seg = torch.repeat_interleave(
        torch.arange(n // 4, device=dev, dtype=torch.int32), lines)[:n]
    order_seg = torch.cat([order_seg, order_seg[-1:].repeat(
        n - order_seg.shape[0])])
    k1.append(check_seg_reduce_shape("l_orderkey, n/4 segments", v,
                                     order_seg, n // 4))
    del lines, order_seg
    entries.append(dict(
        name="seg_reduce", source="sail_tpu_torch/csrc/seg_reduce.cu",
        replaces="sail_tpu/ops/aggregate.py:208", max_abs_err=k1_err,
        ms=k1[0]["ms"], plain_ms=k1[0]["plain_ms"], bound_ms=k1[0]["bound_ms"],
        library_ms=k1[0]["library_ms"], shapes=k1))

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


def check_seg_reduce_shape(label, v, seg, S) -> dict:
    """K1's int64 sum at one shape: exact against its plain version and
    index_add_, then timed with both. Bound: values and ids read once, the
    segments written once."""
    from sail_tpu_torch.ops import aggregate as agg

    def lib():
        return torch.zeros(S, dtype=v.dtype, device=v.device).index_add_(
            0, seg, v)
    got = agg.seg_reduce(v, seg, S, "sum")
    if not torch.equal(got, agg.seg_reduce_plain(v, seg, S, "sum")) or \
            not torch.equal(got, lib()):
        raise AssertionError(f"seg_reduce {label} differs")
    n = v.shape[0]
    out = dict(shape=label, n=n, segments=S,
               ms=cuda_ms(lambda: agg.seg_reduce(v, seg, S, "sum")),
               plain_ms=cuda_ms(lambda: agg.seg_reduce_plain(v, seg, S,
                                                             "sum"), 3),
               library_ms=cuda_ms(lib),
               bound_ms=_bound_ms(n * (8 + 4) + S * 8))
    print(f"K1 seg_reduce sum int64 {label}: n={n} S={S}: exact, "
          f"{out['ms']:.3f} ms, index_add_ {out['library_ms']:.3f} ms, plain "
          f"{out['plain_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms",
          flush=True)
    return out


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
    in the wall), and the device time of the sorts of the joins' build
    sides and of the runtime filters' ndv counts (their calls run inside
    named ranges for this run)."""
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_ms": kernel_ms, "kernel_launches": kernel_launches,
            "sort_ms": sort_ms,
            "top": [[n[:90], ms, c] for n, ms, c in by_name[:15]]}


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
            "direct_group_ids": agg.direct_group_ids,
            "order_keys": srt.order_keys, "join_keys": hsh.join_keys,
            "probe_ranges": jn.probe_ranges_kernel,
            "join_expand": jn.expand_indices,
            "bloom_build": rf.filter_build, "bloom_apply": rf.apply}


def run_main_path(sf: float, runs: int, small, profile: bool) -> dict:
    """``small``: (session, tables, scale factor) of phase 4, where a query
    whose cross join is too large at ``sf`` runs."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
    from sail_tpu_torch.columnar import arrow_interop

    t0 = time.perf_counter()
    tables = generate_tpch_sf(sf, seed=0)
    print(f"generated TPC-H SF{sf}: lineitem {tables['lineitem'].num_rows} "
          f"rows in {time.perf_counter() - t0:.1f} s", flush=True)
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
    entries = check_kernels(args.kernel_rows, dev)
    phases["kernels"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    t = time.perf_counter()
    small_tables = generate_tpch_sf(args.check_sf, seed=0)
    small = SparkSession({"spark.sail.device": "cuda"})
    _register(small, small_tables)
    checks = check_queries(small, small_tables, args.check_sf)
    phases["correctness"] = time.perf_counter() - t

    t = time.perf_counter()
    report = run_main_path(args.sf, args.runs,
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
