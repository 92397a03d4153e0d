#!/usr/bin/env python3
"""Drive the sail_tpu_torch port on one CUDA card and check every part of it.

    python3 chip_smoke.py            # TPC-H SF10, kernels at SF10 shapes,
                                     # ClickBench at 99,997,497 rows
    python3 chip_smoke.py --sf 1 --check-sf 0.1 --kernel-rows 2000000
        --runs 1 --cb-rows 5000000 --cb-check-rows 200000
                                     # (one command) a smaller, quicker run
    python3 chip_smoke.py --profile  # also trace each query once, with
                                     # its K1 (all launches, then by entry
                                     # point), K2-K15 device ms, its sorts
                                     # and its host split

Phases, each of which fails the script (non-zero exit, no result line):

1. Device: the card's name, count and power limit.
2. Build: compile the CUDA kernels (sail_tpu_torch/csrc, one nvcc per
   source, all at once) and print the compiler's register report. The
   chain kernels (K16, K17, K18) are generated for each chain program
   (ops/chain_codegen.py) and compiled with NVRTC where a query binds
   the chain (csrc/chain_jit.cu, the cubins under build/): the run counts
   the programs compiled and their seconds.
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
   ``--runs`` timed runs each, Q2, Q5, Q8 and Q9 too: the join order no
   longer holds an intermediate that grows with the square of the scale
   factor (each query prints its largest join output). Q1 and Q6 also
   match a numpy oracle in exact integer decimal arithmetic. The launch counts are set to 0 before each query's warm-up
   and again before its first timed run, and read after that run: every
   query must launch the kernels ``PATH_KERNELS`` names for it.
6. ClickBench correctness: the 43 queries and the mechanism queries
   (``clickbench.MECHANISM_QUERIES``: string MIN/MAX, DISTINCT beside
   other aggregates, the time fields and truncation, bool_and/bool_or,
   and Q28, Q29, Q39 and Q40 cut to what this size reaches, in queries
   that return rows) over ``generate_hits(--cb-check-rows, --seed)`` on
   the card against the port's CPU session, by
   ``clickbench.check_answer``: the same rows, float64 within 1e-12;
   where a LIMIT (or Q18's LIMIT without ORDER BY) cuts through rows that
   tie on the ORDER BY keys, the keys in order and each row one of its
   tie in the CPU's whole answer (the query without its LIMIT). No answer
   may be empty unless the CPU's is.
7. ClickBench main path: the 43 queries over ``generate_hits(--cb-rows,
   --seed)``, the published dataset's 99,997,497 rows by default, no
   cut: its string columns dictionary-encoded once, as a Parquet reader
   with dictionary pages gives them, so no query encodes 100M URLs at
   upload. Each query runs in a fresh session, so in a fresh scan cache:
   the cache is keyed by projection (exec/local.py), and 43 projections
   of hits would otherwise pile up on the card. One warm-up (the upload
   and the session's dictionary tables) and ``--runs`` timed runs; first
   run, upload, steady times, rows and peak device memory per query. Q1,
   Q5 and Q10 match numpy; every query launches the kernels its
   ``PATH_KERNELS`` entry names (``CB_PLANS``, from its plan), and no
   steady run builds a dictionary table.

Then, after phase 5 and before the ClickBench phases (on phase 5's
SF10 tables and phase 4's tables):

8. Window kernels: the context's sort (the stable passes of
   ``lexsort_keys`` against the pack pass, window_pack, and one stable
   sort of the packed word: the two perms must be equal), K8
   (window_bounds) on the sorted packed word and, at lineitem, on each
   key gathered into sorted order, K9 (window_ranks) at 6, 2 and 1
   outputs (records through the inverse permutation, with it built and
   building it), the gather of
   a column into sorted order (window_gather), K10's two entry points
   (window_scan, window_frame), K11 (window_extreme), the context's
   inverse permutation (window_inverse) and the unpermute back to row
   order (window_unpermute, a scatter through perm: of records, and at
   lineitem of a value column and its validity) at the contexts the
   window queries build at ``--sf``: lineitem's rows by (l_suppkey;
   l_shipdate, l_orderkey, l_linenumber), orders' by (o_custkey;
   o_orderdate), and orders in one segment; K11 at frames of 5 and
   10,001 rows (past the shared-memory halo). The inverse, the gather and
   the unpermute (one engine, a two-pass partitioned scatter) also run at
   W8's order (orders by o_orderkey, near the stored one) and at lineitem
   with 1% of its rows live, and at half the shared-memory tile. lag and
   lead at lineitem (the unpermute reading
   the sorted values shifted) are held to their plain version, the torch
   route before sorted order (gathers and scatters through perm) and the
   sorted-order route they replaced (torch ops over the sorted values,
   the records stacked, then the unpermute), and timed beside them
   (``window_functions``). Each
   against its plain version, then timed beside it and, where one
   exists, a PyTorch call computing as much on sorted values
   (``unique_consecutive`` of the sorted word for K8, and of its first
   key alone, ``vals[perm]`` for the gather,
   ``index_put_`` of the live positions for the inverse, ``cumsum`` for
   K10's scan, ``unfold(...).amin`` for K11 at 5 rows (and K11's float64
   SUM and AVG over the same 5 rows, ``unfold(...).sum``),
   ``index_select`` of one 16 B element a row through ``inv_perm`` for
   the unpermute, ``index_copy_`` of the live ones where rows are dead),
   and that call with its gather
   and its return to row order (``library_perm_ms``) beside the kernel
   with its own gather (``with_gather_ms``).
9. Window correctness: the queries of ``benchmarks/window_queries.py``
   (W1-W8, U1, U2) over the tables at ``--check-sf`` on the card, each
   counting its host syncs (a window context reads its keys' extremes
   once), against the port's CPU session: integers, decimals, dates and
   strings
   exactly, float64 within
   ``WINDOW_FLOAT_RTOL``; no answer empty unless the CPU's is.
10. Window main path: the same queries at ``--sf``, one warm-up and
   ``--runs`` timed runs each, with rows and peak device memory; W1
   against numpy (the three most expensive orders of each customer), W7
   against Q17's answer; every query launches what ``PATH_KERNELS``
   names for it.

Then, after phase 10, on the same tables:

11. Expression kernels: K12 (math_unary), K13 (round_number), K14
   (math_binary) and K15 (calendar) of functions/numeric.py over
   lineitem's columns at ``--sf`` (l_extendedprice, l_quantity and
   l_discount as unscaled decimals, l_orderkey; 60M rows at SF10) and
   l_shipdate and orders' o_orderdate (15M) for K15, in copies with
   NULLs, NaN, +-inf,
   x <= 0 for the logarithms, INT64_MIN for abs and shift counts of 64
   and more planted. Each op against its plain version (integers,
   decimals, dates and bools exactly; float64 within ``EXPR_ULPS`` ulp),
   then timed beside it, its bound (the bytes the op moves: a validity
   where it reads one) and, where one PyTorch call computes
   the same function on the same input, that call (``torch.sqrt``,
   ``torch.exp``, ``torch.log``, ``log10``, ``log2``, ``log1p``,
   ``expm1``, the trigonometric and hyperbolic calls, ``torch.round``
   for rint, ``sign``, ``isnan``, ``floor``, ``ceil``, ``rad2deg``,
   ``deg2rad``, ``neg``, ``torch.abs``, ``bitwise_not``,
   ``torch.round(x, decimals=3)``,
   ``torch.pow``, ``torch.atan2``, ``torch.hypot``, ``torch.bitwise_and``,
   ``bitwise_or``, ``bitwise_xor`` and the shifts, a left shift's counts
   masked to 0-63 beforehand, as Spark masks them). K12, K14 and K15 are
   one kernel entry an operation (``math_unary:<op>``,
   ``math_binary:<op>``, ``calendar:<op>``, its instantiations the
   operand types), each instantiation's registers and spill stores
   printed from the compiler's report (none may spill). A literal
   operand is a scalar on the host, as the compiler passes it; K14 also
   runs power(float64, 2) and ``|`` of two aligned columns without a
   validity, K15 its ops at lineitem's 60M rows and orders' 15M. Each
   kernel's first (headline) shape (K12's: sqrt of float64; K14's
   power(decimal, 2); K15's add_months at 60M) must reach
   ``EXPR_BOUND_SHARE`` of its bound.
12. Expression correctness: the queries of
   ``benchmarks/expr_queries.py`` (E1-E6) over the tables at
   ``--check-sf`` on the card against the port's CPU session, as phase 9
   compares; each counts its host syncs.
13. Expression main path: E1-E7 at ``--sf``, one warm-up and ``--runs``
   timed runs each, with rows and peak device memory; E3 and E5 against
   numpy at full size (their answers are integers and dates); every
   query launches what its ``expr_queries.KERNELS`` entry names.
14. Chain kernels: K16 (chain) and K17 (chain_reduce) of ops/chain.py, the
   kernels generated for each program, at the path's shapes: K17 over
   Q1's, Q6's and E2's chains at ``--sf`` (and each of those chains as a
   K16 program), K16 over Q3's lineitem filter and Q19's predicate, and,
   inside phase 7, K17 over ClickBench Q30's 90 sums at ``--cb-rows``.
   Each against its plain version (run_chain_plain; K17: its registers
   reduced by the K1 route): integers, decimals, dates, codes and bools
   exactly, K16's float64 exactly (EXPR_ULPS ulp where the chain calls a
   libm function), K17's float sums within FLOAT_RTOL; then timed beside
   it, its bound (bytes once; K17 reads each input only in the 32-byte
   sectors that hold a row its filters have left, ``_k17_bytes``) and the
   closures it replaced
   (``library_ms``: the chain's torch ops, then for K17 the K2/sort and
   K1 route), the program's compile ms and the registers and local bytes
   (spills and stack) the driver reports of its kernel; the printed line
   adds the earlier interpreter's time where it had one
   (``INTERPRETER_MS``, from PERF.md, in brackets). The run prints the
   programs compiled, their seconds and how many of them spill. Then
   Spark's casts and IN (``CAST_IN_SQL``: a double to BIGINT, INT and
   DECIMAL(12,2), ``k IN (1, NULL)``) over ``CAST_IN_ROWS`` of lineitem's
   rows with NaN, +-inf, +-1e30 and +-3e9 planted, as one generated K16
   program (F2I, F2I32): its answer against Spark's (numpy), the kernel
   against run_chain_plain, timed as a K16 row.

15. Sort words: K18 (chain_sort, ops/chain.py run_chain_sort), the
   chain's kernel that also writes each sort key's K3 word, validity and
   extremes, at the path's shapes: E7's sort over orders and E3's
   grouping over lineitem at ``--sf``, Q18's grouping of lineitem's
   l_orderkey (read through K3 on the path: here the K18 program of its
   key alone) and, inside phase 7, ClickBench Q25's sort and Q40's
   grouping of five keys at ``--cb-rows``. Each against its plain version
   (run_chain_sort_plain: the words, validities and extremes exactly;
   within EXPR_ULPS of a float64 key's word where the chain calls a libm
   function), the packed permutation's live prefix against the passes'
   on the same words (where the keys fit in 63 bits), then timed beside
   its bound (bytes once: the chain's inputs, the outputs it writes, 8 B
   a key word and 1 B a key validity) and the route it replaced
   (``library_ms``: K16, the keys' closures and K3, then the passes, and
   for a grouping each key gathered and compared with its neighbour),
   with the sort of the words as the passes against the packed word, and
   the program's compile ms, registers and local bytes.
16. Host aggregates (``benchmarks/host_agg_queries.py``): K19
   (seg_moments, both passes) at H1's four bins of lineitem and keyless,
   K20 (seg_pick, max_by's pick) at H2's grouping of l_suppkey, and K1's
   bit kinds (``seg_reduce:and``, ``:or``, ``:xor``; binned at H1's bins,
   runs at H2's grouping), each against its plain version (K19 within
   HOST_FLOAT_RTOL, K20 and the bit kinds exactly), timed beside it, its
   bound and a PyTorch call (``index_add_`` of K19's products, two
   ``scatter_reduce_`` for K20); then H1, H1 keyless, H2 and H3 over
   TPC-H at ``--check-sf`` on the card (phase 4's session), each
   group held to the oracle (the copied ``functions/host_aggregates.py``
   per-group functions over pandas groups, floats within HOST_FLOAT_RTOL);
   then the four at ``--sf``, one warm-up and ``--runs`` timed runs each,
   ``cuda_ms`` over ``--runs`` more, one profiled run (device busy
   share), and every query launches what its ``KERNELS`` entry names.

Every query of phases 5, 7, 10, 13 and 16 prints its chains' routes (K16,
K17, K18, per-op, with the first expression that kept a chain on its
closures) and its sorts' (K18 or K3, packed or passes); a TPC-H, E or
ClickBench Q30 chain that computes an expression must run K16, K17 or
K18. Phases 4, 9 and 12 print each query's host syncs beside its count
before K18 (``PARENT_SYNCS``).

It prints one ``{"kernels": [...]}`` JSON line (``launches`` is the sum
over the TPC-H, window, expression and ClickBench queries of their
one-run counts, ``launches_on_path`` gives each, ``qN``, ``wN``/``uN``,
``eN``, ``hN`` and ``cbN``), the
``nvidia-smi`` name and power limit line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import decimal
import gc
import json
import math
import os
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
PATH_KERNELS = {f"q{q}": _JOIN + ("chain",) for q in range(1, 23)
                if q not in (1, 6, 13)}
PATH_KERNELS.update({
    "q1": ("chain_reduce", "window_pack"),
    "q6": ("chain_reduce",),
    "q5": _JOIN + ("chain", "bloom_build", "bloom_apply"),
    "q13": _JOIN + ("join_expand",),
    "q21": _JOIN + ("chain", "join_expand", "bloom_build", "bloom_apply"),
})
# the queries that group by sort: every aggregate there goes through K1's
# runs entry point
for _q in (2, 3, 7, 8, 9, 10, 11, 13, 15, 16, 17, 18, 20):
    PATH_KERNELS[f"q{_q}"] += ("seg_reduce_runs",)
# the queries whose keyless or direct aggregate absorbs its chain (K17;
# Q21's s_name takes more than 4096 bins from SF1 up, so it sorts); every
# other query's computed chains run K16 (Q13 computes none)
for _q in (4, 5, 11, 12, 14, 15, 17, 19, 22):
    PATH_KERNELS[f"q{_q}"] += ("chain_reduce",)
# the queries whose sort or sorted grouping takes its chain and keys in
# (K18; ops/chain.py run_chain_sort): Q1's, Q2's, Q8's and Q11's ORDER BY
# over a computing chain, the groupings of Q3, Q7-Q11, Q15 and Q20 over
# one (Q13's, Q16's, Q17's and Q18's group their columns, through K3)
for _q in (1, 2, 3, 7, 8, 9, 10, 11, 15, 20):
    PATH_KERNELS[f"q{_q}"] += ("chain_sort",)
# every query that sorts or groups by sort packs some of its keys into one
# word at SF10 (ops/sort.py); Q2's ORDER BY, Q10's and Q18's groupings of
# names, keys and prices take more than 63 bits and sort by the passes
for _q in range(2, 23):
    if _q not in (6, 14, 19):
        PATH_KERNELS[f"q{_q}"] += ("window_pack",)
# the kernels phase 11 holds to their plain versions that no query of the
# path launches: their element functions run inside the chains' programs
# (K16-K18), E7's sort keys in its K18 program (K12, K14 and K15 by
# operation, ``math_unary:<op>``, ``math_binary:<op>``, ``calendar:<op>``:
# each its own instantiations)
OFF_PATH = ("round_number", "math_unary:", "math_binary:", "calendar:")
# device functions of the kernels whose time and launches each profiled
# query reports: K1 over all its launches, then split by entry point (a
# runs call launches its grid, then one block over the grid's records)
PROFILED_KERNELS = {
    "K1 seg_reduce": re.compile(r"seg_reduce_kernel<|seg_runs_"),
    "K1 binned": re.compile(r"seg_reduce_kernel<"),
    "K1 runs": re.compile(r"seg_runs_kernel<"),
    "K1 runs merge": re.compile(r"seg_runs_merge_kernel<"),
    "K2 direct_group": re.compile(r"direct_group_kernel\("),
    "K3 order_keys": re.compile(r"order_keys_kernel<"),
    "K4 join_keys": re.compile(r"join_keys_kernel\("),
    "K5 probe_ranges": re.compile(r"probe_kernel\(|splitter_kernel\("),
    "K6 join_expand": re.compile(r"expand_kernel\("),
    "K7 bloom": re.compile(r"bloom_(build|apply)_kernel[<(]"),
    "K8 window_bounds": re.compile(r"bounds_(forward|backward)_kernel"),
    "K8 pack": re.compile(r"\bpack_kernel\("),
    "K9 window_ranks": re.compile(r"\branks_(unpermute_)?kernel[<(]"),
    "K10 window_scan": re.compile(r"\bscan_kernel<|\bframe_kernel<"),
    "K11 window_extreme": re.compile(r"extreme_(narrow|chunks|wide)_kernel<"),
    "window gather, inverse, unpermute": re.compile(
        r"\bbin_kernel<|\bplace_kernel<"),
    "K12 math_unary": re.compile(r"\bunary_kernel[<(]"),
    "K13 round_number": re.compile(r"\bround_kernel\("),
    "K14 math_binary": re.compile(r"\bbinary_kernel[<(]"),
    "K15 calendar": re.compile(r"\bcalendar_kernel[<(]"),
    "K16 chain": re.compile(r"\bsail_chain_k16\b"),
    "K17 chain_reduce": re.compile(r"\bsail_chain_k17\b"),
    "K18 chain_sort": re.compile(r"\bsail_chain_k18\b"),
    "K19 seg_moments": re.compile(r"\bmoments_kernel<"),
    "K20 seg_pick": re.compile(r"\bpick_kernel<"),
}
# float64 sums add in an order that varies with the atomics: relative error
FLOAT_RTOL = 1e-12


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
    is Python and the profiler). The traced run follows a run in which
    the profiler warms up and records nothing kept: a trace that starts
    cold misses the first kernels of its window."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

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
    traced = {}

    def keep(prof):
        traced["averages"], traced["events"] = prof.key_averages(), \
            prof.events()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=keep) as prof:
            for _ in range(2):
                t = time.perf_counter()
                spark.sql(sql).toArrow()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
                prof.step()
    finally:
        jn.build_side, rf.build = build_side, rtf_build
    averages = [e for e in traced["averages"]
                if not e.key.startswith(("sail.", "ProfilerStep"))]
    # device-side events only (kernels, copies): a CPU op's own entry
    # would count its kernels a second time, and so would the device-side
    # spans of the named ranges
    events = [e for e in averages if str(e.device_type).endswith("CUDA")]
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
                   for e in averages
                   if not str(e.device_type).endswith("CUDA")
                   and e.self_cpu_time_total > 0), key=lambda x: -x[1])
    host_ms = sum(ms for _, ms, _ in host)
    fevents = traced["events"]
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


# each query's host syncs in phases 4, 9 and 12 (its first run at
# --check-sf 1) before the sorts' words moved into the chains' kernel (K18)
# and a sort of one packed word (PERF.md §5: the default run before it;
# NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_SYNCS = {
    "q1": 30, "q2": 66, "q3": 22, "q4": 14, "q5": 40, "q6": 13, "q7": 38,
    "q8": 44, "q9": 33, "q10": 36, "q11": 39, "q12": 27, "q13": 7,
    "q14": 17, "q15": 28, "q16": 31, "q17": 15, "q18": 26, "q19": 29,
    "q20": 30, "q21": 31, "q22": 33, "w1": 7, "w2": 9, "w3": 17, "w4": 10,
    "w5": 16, "w6": 22, "w7": 14, "w8": 10, "u1": 13, "u2": 15, "e1": 33,
    "e2": 25, "e3": 19, "e4": 13, "e5": 22, "e6": 27, "e7": 8}


def _syncs_line(name: str, syncs: int) -> str:
    before = PARENT_SYNCS.get(name)
    return f"{syncs} host syncs" + ("" if before is None else
                                    f", {before} before K18")


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
              f"({_syncs_line(f'q{q}', syncs)}, first run {run_s:.2f} s)",
              flush=True)
    return report


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def _by_op(kernel: str, op: str) -> str:
    """The kernels entry of one operation of K12, K14 or K15 (its
    instantiations): ``math_unary:sqrt``."""
    return f"{kernel}:{op}"


def _counters():
    from sail_tpu_torch.functions import numeric as num
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.ops import chain as chn
    from sail_tpu_torch.ops import hash as hsh
    from sail_tpu_torch.ops import join as jn
    from sail_tpu_torch.ops import runtime_filter as rf
    from sail_tpu_torch.ops import sort as srt
    from sail_tpu_torch.ops import window as win
    return {"seg_reduce": agg.seg_reduce,
            "seg_reduce_runs": agg.seg_reduce_runs,
            "direct_group_ids": agg.direct_group_ids,
            "order_keys": srt.order_keys, "join_keys": hsh.join_keys,
            "probe_ranges": jn.probe_ranges_kernel,
            "join_expand": jn.expand_indices,
            "bloom_build": rf.filter_build, "bloom_apply": rf.apply,
            "window_pack": win.window_pack,
            "window_bounds": win.window_bounds,
            "window_ranks": win.window_ranks, "window_scan": win.window_scan,
            "window_frame": win.window_frame,
            "window_extreme": win.window_extreme,
            "window_gather": win.window_gather,
            "window_inverse": win.window_inverse,
            "window_unpermute": win.window_unpermute,
            **{_by_op(k, op): c for k, fn in (
                ("math_unary", num.math_unary),
                ("math_binary", num.math_binary),
                ("calendar", num.calendar)) for op, c in fn.by_op.items()},
            "round_number": num.round_number,
            "chain": chn.run_chain, "chain_reduce": chn.run_chain_reduce,
            "chain_sort": chn.run_chain_sort,
            "seg_moments": agg.seg_moments, "seg_pick": agg.seg_pick,
            **{f"seg_reduce:{k}": c for k, c in agg.BIT_LAUNCHES.items()}}


@contextlib.contextmanager
def timed_uploads():
    """Time every upload (Arrow -> card) the scans make while the block
    runs: yields {"s": seconds, "bytes": Arrow bytes}, which grow."""
    from sail_tpu_torch.columnar import arrow_interop

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
    try:
        yield upload
    finally:
        arrow_interop.from_arrow = from_arrow


def run_main_path(tables: dict, sf: float, runs: int,
                  profile: bool) -> dict:
    """``tables``: TPC-H at ``sf``."""
    with timed_uploads() as upload:
        return _run_main_path(tables, sf, runs, profile, upload)


def _run_main_path(tables, sf, runs, profile, upload) -> dict:
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES

    want_q1, want_q6 = oracle(tables["lineitem"])
    spark = SparkSession.builder.getOrCreate()
    if spark.device.type != "cuda":
        raise AssertionError(f"session runs on {spark.device}, not cuda")
    _register(spark, tables)
    counters = _counters()

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    torch.cuda.reset_peak_memory_stats()
    report = {"launches_on_path": {}}
    session = spark
    for q in range(1, 23):
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
                routes = session.last_chain_routes
                sorts = session.last_sort_routes
        report["launches_on_path"][f"q{q}"] = launches
        entry = dict(sf=sf, first_s=first,
                     upload_s=upload["s"] - upload_before, query_s=times,
                     rows=result.num_rows, runtime_filters=filters,
                     largest_join_rows=max(session.last_join_rows or [0]),
                     chain_routes=_print_routes(f"Q{q}", routes, True),
                     sort_routes=_print_sorts(f"Q{q}", sorts))
        if profile:
            entry["profile"] = profile_query(session, QUERIES[q])
        if q == 1:
            check_q1(result, want_q1)
        elif q == 6:
            got = _unscaled_result(result.column(0).combine_chunks())
            if got != [want_q6]:
                raise AssertionError(f"Q6: {got} != {[want_q6]}")
        report[f"q{q}"] = entry
        print(f"Q{q} SF{sf}: first run {first:.3f} s (upload "
              f"{entry['upload_s']:.3f} s), then "
              f"{', '.join(f'{x * 1e3:.1f} ms' for x in times)}; "
              f"{result.num_rows} rows; largest join "
              f"{entry['largest_join_rows']} rows; launches in one run "
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
    return report


# ---------------------------------------------------------------------------
# phases 8-10: windows and unions
# ---------------------------------------------------------------------------

# K8 reads the sorted packed word where the keys fit in 63 bits (every
# context of W2-W8 at SF10), else each key gathered into sorted order
# through the inverse permutation (W1: o_custkey, o_totalprice and
# o_orderkey take 74 bits)
_K8, _K8_GENERAL = ("window_pack", "window_bounds"), \
    ("window_bounds", "window_inverse", "window_gather")
_K9 = ("window_ranks",)
# K10 and K11 read a gathered column and unpermute their outputs through
# the context's inverse permutation
_K10 = ("window_gather", "window_scan", "window_frame", "window_inverse",
        "window_unpermute")
# the kernels each window/union query must launch (W4's lag and lead read
# their values in sorted order and unpermute each output; the unions group
# their merged dictionary codes directly; W5's five rank outputs go to row
# order through the inverse permutation; W1's and W6's ORDER BY and W2's
# and W6's groupings take their chains in, K18; every ORDER BY of these
# queries packs its keys, W1's too)
WINDOW_PATH = {
    "w1": _K8_GENERAL + _K9 + ("chain_sort", "window_pack"),
    "w2": _K8 + _K10 + ("chain_sort",),
    "w3": _K8 + _K10 + ("window_extreme",),
    "w4": _K8 + ("window_gather", "window_inverse", "window_unpermute"),
    "w5": _K8 + _K9 + ("window_inverse",),
    "w6": _K8 + _K9 + _JOIN + ("chain_sort",),
    "w7": _K8 + _K10 + _JOIN, "w8": _K8 + _K9 + _K10,
    "u1": ("chain_reduce", "window_pack"),
    "u2": ("chain_reduce", "window_pack"),
}
PATH_KERNELS.update(WINDOW_PATH)
# float64 answers of a window query on the card against the CPU session:
# the tile scans and K1 add in another order than the CPU's sequential
# passes (relative)
WINDOW_FLOAT_RTOL = 1e-9
# the widths K11 runs at: the queries' 5-row band, and a frame past the
# shared-memory halo (the chunked path)
EXTREME_WIDTHS = (5, 10_001)


def _device_column(table: pa.Table, name: str, dev) -> torch.Tensor:
    """A TPC-H column on the card: decimals unscaled, dates as days."""
    col = table.column(name)
    if pa.types.is_decimal(col.type):
        values = _unscaled(col)
    elif pa.types.is_date(col.type):
        values = np.asarray(col.combine_chunks().view(pa.int32()))
    else:
        values = col.to_numpy()
    return torch.from_numpy(np.ascontiguousarray(values)).to(dev)


def _window_shapes(tables: dict, dev):
    """(label, partition columns, order columns, values) of the contexts the
    queries build at this scale: lineitem by (l_suppkey; ORD), orders by
    (o_custkey; o_orderdate), orders in one segment."""
    li, od = tables["lineitem"], tables["orders"]
    c = lambda t, n: _device_column(t, n, dev)  # noqa: E731
    return [
        ("lineitem by l_suppkey; l_shipdate, l_orderkey, l_linenumber",
         [c(li, "l_suppkey")],
         [c(li, "l_shipdate"), c(li, "l_orderkey"), c(li, "l_linenumber")],
         c(li, "l_extendedprice")),
        ("orders by o_custkey; o_orderdate", [c(od, "o_custkey")],
         [c(od, "o_orderdate")], c(od, "o_totalprice")),
        ("orders in one segment; o_totalprice, o_orderkey", [],
         [c(od, "o_totalprice"), c(od, "o_orderkey")], c(od, "o_totalprice")),
    ]


def _timed(label, n, fn, plain, bound_bytes, library=None, compare=None,
           extra=None):
    """One kernel at one shape: its result against its plain version's
    (``compare``, exact by default), then kernel, plain and library ms,
    and the ms of each further call in ``extra`` ({key: fn})."""
    got, want = fn(), plain()
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    err = 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        err = max(err, compare(g, w) if compare else _max_abs_err(g, w))
    row = dict(shape=label, n=n, max_abs_err=err, ms=cuda_ms(fn),
               plain_ms=cuda_ms(plain, 3), bound_ms=_bound_ms(bound_bytes),
               library_ms=None if library is None else cuda_ms(library))
    row.update({k: cuda_ms(f) for k, f in (extra or {}).items()})
    print(f"  {label}: n={n}, max abs err {err:g}, {row['ms']:.3f} ms, "
          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms"
          + ("" if library is None else
             f", library {row['library_ms']:.3f} ms")
          + "".join(f", {k} {row[k]:.3f}" for k in extra or {}), flush=True)
    return row


def _segment_sum_err(got, want, vals, ctx) -> float:
    """float64 scans: within 1e-12 of the sum of |v| over the segment."""
    from sail_tpu_torch.ops import window as win
    scale = win.window_scan_plain(ctx, vals.abs(), None, "sum",
                                  backward=False)
    seg_total = scale[ctx.seg_end.clamp(min=0).long()]
    diff = (got - want).abs()
    if bool((diff > FLOAT_RTOL * seg_total + 1e-300).any()):
        raise AssertionError("float64 scan beyond 1e-12 of its segment's "
                             "sum of |v|")
    return float(diff.max()) if diff.numel() else 0.0


def _time_moves(rows: dict, label: str, perm, n_live, vals) -> None:
    """The inverse permutation and the gather of ``vals`` (int64) into
    sorted order at one context (phase 8), each equal to its plain version
    (and the gather to ``vals[perm]``), timed beside its library call
    (torch's scatter of the live positions; ``vals[perm]`` over them) and
    at half the shared-memory tile (``half_tile_ms``). Bounds: the inverse
    reads perm at the live positions and writes n int32; the gather reads
    inv and the live rows' values and writes n values."""
    from sail_tpu_torch.ops import window as win
    n = perm.shape[0]
    live = int(n_live)
    half = win.MOVE_TILE_BYTES // 2
    positions = torch.arange(n, dtype=torch.int32, device=perm.device)
    if live == n:
        library = lambda: torch.empty_like(positions).index_put_(  # noqa
            (perm,), positions)
    else:
        library = lambda: torch.full_like(positions, -1).index_put_(  # noqa
            (perm[:live],), positions[:live])
    rows["window_inverse"].append(_timed(
        f"inverse permutation, {label}", n,
        lambda: win.window_inverse(perm, n_live),
        lambda: win.window_inverse_plain(perm, n_live), live * 8 + n * 4,
        library,
        extra={"half_tile_ms": lambda: win.window_inverse(perm, n_live,
                                                          half)}))
    del positions, library
    inv = win.window_inverse(perm, n_live)
    got = win.window_gather(inv, vals, None)[0]
    if not torch.equal(got[:live], vals[perm[:live]]) or \
            bool(got[live:].any()):
        raise AssertionError(f"{label}: the gather is not vals[perm]")
    del got
    rows["window_gather"].append(_timed(
        f"gather into sorted order, int64, {label}", n,
        lambda: win.window_gather(inv, vals, None),
        lambda: win.window_gather_plain(inv, vals, None),
        n * (4 + 8) + live * 8, lambda: vals[perm[:live]],
        extra={"half_tile_ms": lambda: win.window_gather(inv, vals, None,
                                                         half)}))


def _torch_route_shift(ctx, value, offset: int, default):
    """lag/lead as the port computed them before they read sorted values:
    a gather through perm and two scatters an output, three with a
    default; the yardstick of the sorted-order path."""
    perm = ctx.perm
    n = perm.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=perm.device)
    src = idx - offset
    in_seg = (src >= ctx.seg_start) & (src <= ctx.seg_end)
    rows = perm[torch.clamp(src, 0, max(n - 1, 0))]
    alive = idx < ctx.n_live
    ok = in_seg & alive
    data = torch.where(ok, value.data[rows], torch.zeros_like(value.data[:1]))
    if value.validity is not None:
        ok = ok & value.validity[rows]

    def scatter(t):
        out = torch.empty_like(t)
        out[perm] = t
        return out
    data, validity = scatter(data), scatter(ok)
    if default is not None:
        outside = scatter(~in_seg & alive)
        data = torch.where(outside, torch.full_like(data, default), data)
        validity = validity | outside
    return data, validity


def _sorted_torch_shift(ctx, value, offset: int, default):
    """lag/lead as the port computed them before the unpermute read them
    shifted: torch ops over the sorted values (shifted slices, ``where``,
    ``cat``), the records stacked (``pack_records``), then one unpermute of
    the records."""
    from sail_tpu_torch.ops import window as win
    vals, valid = ctx.sorted_values(value.data, value.validity)
    data, ok = win._shift_plain(ctx, vals, valid, win.Shift(offset, default))
    return win.window_unpermute(ctx, win.pack_records(data, ok))


def _time_shift(ctx, col, offset: int, default, label: str) -> dict:
    """lag/lead over ``col`` (int64) at one context: the unpermute reading
    the sorted values shifted (the context's sorted values cached, as for
    a second output over the column; and with its gather,
    ``with_gather_ms``) equal to its plain version, to the torch route
    before it read sorted values and to the sorted-order route it replaced,
    and timed beside them (``plain_ms``; ``torch_route_ms``;
    ``sorted_route_ms``). Bound: the values, inv and seg_start read, the
    values and validity written."""
    from sail_tpu_torch.ops import window as win
    n = ctx.perm.shape[0]
    shift = win.Shift(offset, default)
    new = win.shift(ctx, col, offset, default)
    vals, valid = ctx.sorted_values(col.data, col.validity)
    for other in (win.window_unpermute_plain(ctx, vals, valid, shift),
                  _torch_route_shift(ctx, col, offset, default),
                  _sorted_torch_shift(ctx, col, offset, default)):
        if not all(torch.equal(a, b) for a, b in zip(new, other)):
            raise AssertionError(f"{label}: lag/lead differs from its "
                                 f"plain version or an earlier route")
    del new, other

    def fresh():
        ctx._sorted.clear()
        return win.shift(ctx, col, offset, default)
    row = dict(shape=label, n=n, max_abs_err=0.0, ms=cuda_ms(
        lambda: win.shift(ctx, col, offset, default)),
        with_gather_ms=cuda_ms(fresh),
        plain_ms=cuda_ms(lambda: win.window_unpermute_plain(
            ctx, vals, valid, shift), 3),
        torch_route_ms=cuda_ms(lambda: _torch_route_shift(
            ctx, col, offset, default), 3),
        sorted_route_ms=cuda_ms(lambda: _sorted_torch_shift(
            ctx, col, offset, default)),
        bound_ms=_bound_ms(n * (8 + 4 + 4 + 8 + 1)))
    print(f"  {label}: n={n}, {row['ms']:.3f} ms, with its gather "
          f"{row['with_gather_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
          f"torch route {row['torch_route_ms']:.3f} ms, sorted route "
          f"{row['sorted_route_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms",
          flush=True)
    return row


def _time_unpermute(rows: dict, label: str, ctx, fsorted) -> None:
    """The unpermute of float64 records {value, ok} (K10's and K11's
    output; ok: the live positions) at one context (phase 8), equal to its
    plain version exactly, timed beside it, its bound and one PyTorch
    call (``library_ms``): ``index_select`` of one 16 B element a row
    through ``inv_perm`` where every row lives, else ``index_copy_`` of
    the live records into a zeroed array; and at half the shared-memory
    tile. Bound: n * (4 B of inv + 8 B + 1 B) + n_live * 16 B of
    records."""
    from sail_tpu_torch.ops import window as win
    n, live = fsorted.shape[0], int(ctx.n_live)
    recs = win.pack_records(fsorted, ctx.alive)
    whole = recs.view(torch.complex128).squeeze(-1)
    inv, perm = ctx.inv_perm, ctx.perm
    if live == n:
        library = lambda: whole.index_select(0, inv)  # noqa: E731
    else:
        library = lambda: torch.zeros_like(whole).index_copy_(  # noqa: E731
            0, perm[:live], whole[:live])
    rows["window_unpermute"].append(_timed(
        f"unpermute, float64 records, {label}", n,
        lambda: win.window_unpermute(ctx, recs),
        lambda: win.window_unpermute_plain(ctx, recs),
        n * (4 + 8 + 1) + live * 16, library,
        extra={"half_tile_ms": lambda: win.window_unpermute(
            ctx, recs, tile_bytes=win.MOVE_TILE_BYTES // 2)}))


def check_window_kernels(tables: dict, dev) -> list:
    """K8-K11, the inverse permutation, the gather into sorted order and
    the unpermute at the contexts the window queries build from
    ``tables`` (phase 8): each against its plain version, then timed
    beside it, a PyTorch call that computes as much on sorted values (the
    port never calls it), and that call with its gather and its return to
    row order (``library_perm_ms``; the kernel's own composite is
    ``with_gather_ms``); the inverse, the gather and the unpermute also
    where the order is near the stored one (W8's) and where 1% of
    lineitem lives; lag and lead (the unpermute's shift) beside their
    plain version and the routes they replaced. Bounds: bytes once at
    HBM_BYTES_PER_S. Returns (the kernels' entries, the lag/lead rows)."""
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import window as win
    from sail_tpu_torch.ops.sort import lexsort_keys, order_keys
    from sail_tpu_torch.spec import data_type as dt

    functions = []
    rows = {name: [] for name in ("window_pack", "window_bounds",
                                  "window_ranks", "window_gather",
                                  "window_inverse", "window_scan",
                                  "window_frame", "window_extreme",
                                  "window_unpermute")}
    for label, part, order, vals in _window_shapes(tables, dev):
        n = vals.shape[0]
        sel = torch.ones(n, dtype=torch.bool, device=dev)
        ctx = win.build_window_context(
            [Column(p, None, dt.LongType()) for p in part],
            [(o, None, dt.LongType(), True, None) for o in order], sel)
        keys = [(order_keys(k), None, True) for k in part + order]
        n_part = len(part)
        perm, n_live = ctx.perm, ctx.n_live
        print(f"K8-K11 at {label}:", flush=True)
        # the context's sort: the passes (one stable sort a key and the
        # dead rows) against the pack pass and one stable sort
        layout = win.pack_layout(keys, n_part)
        srt = win.sort_window_keys(keys, n_part, sel, n_live, True)
        packed_perm, words = srt.perm, srt.words
        del srt
        if not (ctx.packed and torch.equal(packed_perm, perm)
                and torch.equal(lexsort_keys(keys, sel), perm)):
            raise AssertionError(f"{label}: the packed sort's perm is not "
                                 f"the passes'")
        del packed_perm
        word = win.window_pack(keys, sel, layout)
        rows["window_pack"].append(_timed(
            f"pack pass, {layout.dead_shift + 1} bits, {label}", n,
            lambda: win.window_pack(keys, sel, layout),
            lambda: win.window_pack_plain(keys, sel, layout),
            n * (8 * len(keys) + 1 + 8),
            extra={"passes_ms": lambda: lexsort_keys(keys, sel),
                   "packed_sort_ms": lambda: win.sort_window_keys(
                       keys, n_part, sel, n_live, True),
                   "layout_ms": lambda: win.pack_layout(keys, n_part),
                   "sort_ms": lambda: torch.sort(word, stable=True)}))
        del word
        # K8 on the sorted word; its yardstick counts the runs of equal
        # words, and those of the first key alone, sorted and through perm
        sorted_word, key = words[0][0], keys[0][0]
        first = key[perm]
        rows["window_bounds"].append(_timed(
            f"K8 packed word, {label}", n,
            lambda: win.window_bounds(n_live, words),
            lambda: win.window_bounds_plain(n_live, words),
            n * (8 + 5 * 4),
            lambda: torch.unique_consecutive(sorted_word, return_inverse=True,
                                             return_counts=True),
            extra={"first_key_ms": lambda: torch.unique_consecutive(
                       first, return_inverse=True, return_counts=True),
                   "first_key_perm_ms": lambda: torch.unique_consecutive(
                       key[perm], return_inverse=True, return_counts=True)}))
        del first, key, words, sorted_word
        if label.startswith("lineitem"):
            # K8 on the general path: the inverse permutation, then each
            # key gathered into sorted order through it
            def gathered():
                inv_ = win.window_inverse(perm, n_live)
                out = []
                for j, (k, v, _) in enumerate(keys):
                    k_s, v_s = win.window_gather(inv_, k, v)
                    out.append((k_s, -1 if j < n_part else 0, v_s))
                return out
            gwords = gathered()
            general = win.window_bounds(n_live, gwords)
            if not all(torch.equal(g, b) for g, b in zip(general, (
                    ctx.seg_start, ctx.seg_end, ctx.peer_start, ctx.peer_end,
                    ctx.dense))):
                raise AssertionError(f"{label}: K8's two key sources differ")
            del general
            rows["window_bounds"].append(_timed(
                f"K8 general path, {len(keys)} keys gathered, {label}", n,
                lambda: win.window_bounds(n_live, gwords),
                lambda: win.window_bounds_plain(n_live, gwords),
                n * (8 * len(keys) + 5 * 4),
                extra={"with_gathers_ms": lambda: win.window_bounds(
                    n_live, gathered())}))
            del gwords
        # K9's records and their unpermute through inv_perm, timed with
        # it built (as after K10) and building it (a fresh context)
        inv = ctx.inv_perm

        def building_inv(wanted):
            def run():
                ctx._inv_perm = None
                return list(win.window_ranks(ctx, wanted, 4).values())
            return run
        for wanted, n_bounds in ((win._RANKS, 5), (("rank", "cume_dist"), 4),
                                 (("ntile",), 2)):
            k = len(wanted)
            rows["window_ranks"].append(_timed(
                f"K9 records, {k} output{'s' if k > 1 else ''}, {label}",
                n, lambda: list(win.window_ranks(ctx, wanted, 4).values()),
                lambda: list(win.window_ranks_plain(ctx, wanted,
                                                    4).values()),
                n * (4 + 4 * n_bounds + 8 * k),
                extra={"building_inv_perm_ms": building_inv(wanted)}))
            ctx._inv_perm = inv
        _time_moves(rows, label, perm, n_live, vals)
        fvals = vals.to(torch.float64) / 100
        gather = lambda: win.window_gather(inv, vals, None)  # noqa: E731
        sorted_vals, _ = gather()
        fsorted, _ = win.window_gather(inv, fvals, None)
        if label.startswith("lineitem"):  # W4's lag and lead
            col = Column(vals, None, dt.LongType())
            for offset, default in ((1, -1), (-2, None)):
                functions.append(_time_shift(
                    ctx, col, offset, default,
                    f"{'lag' if offset > 0 else 'lead'}({abs(offset)}"
                    f"{'' if default is None else ', -1'}), {label}"))
            del col
        rows["window_scan"].append(_timed(
            f"K10 scan, int64 sum, {label}", n,
            lambda: win.window_scan(ctx, sorted_vals, None, "sum"),
            lambda: win.window_scan_plain(ctx, sorted_vals, None, "sum"),
            n * (8 + 4 + 8), lambda: torch.cumsum(sorted_vals, 0),
            extra={"with_gather_ms": lambda: win.window_scan(
                       ctx, gather()[0], None, "sum"),
                   "library_perm_ms": lambda: torch.cumsum(
                       vals[perm], 0)[inv]}))
        rows["window_scan"].append(_timed(
            f"K10 scan, float64 sum, {label}", n,
            lambda: win.window_scan(ctx, fsorted, None, "sum"),
            lambda: win.window_scan_plain(ctx, fsorted, None, "sum"),
            n * (8 + 4 + 8), None,
            lambda g, w: _segment_sum_err(g, w, fsorted, ctx)))
        for backward in (False, True):
            rows["window_scan"].append(_timed(
                f"K10 scan, {'backward max' if backward else 'min'}, {label}",
                n,
                lambda: win.window_scan(ctx, sorted_vals, None, "max"
                                        if backward else "min", backward),
                lambda: win.window_scan_plain(ctx, sorted_vals, None, "max"
                                              if backward else "min",
                                              backward),
                n * (8 + 4 + 8)))
        scan = win.window_scan(ctx, sorted_vals, None, "sum")
        # the frames with their unpermute (int32 inv_perm in the bound)
        rows["window_frame"].append(_timed(
            f"K10 frame, avg over rows -6..0, {label}", n,
            lambda: win.window_frame(ctx, scan, None, "avg", -6, 0),
            lambda: win.window_frame_plain(ctx, scan, None, "avg", -6, 0),
            n * (4 + 4 + 8 + 4 + 8 + 1)))
        rows["window_frame"].append(_timed(
            f"K10 frame, sum to the last peer, {label}", n,
            lambda: win.window_frame(ctx, scan, None, "sum", None, 0,
                                     ctx.peer_end),
            lambda: win.window_frame_plain(ctx, scan, None, "sum", None, 0,
                                           ctx.peer_end),
            n * (4 + 4 + 4 + 8 + 4 + 8 + 1)))
        del scan
        _time_unpermute(rows, label, ctx, fsorted)
        if label.startswith("lineitem"):  # nth_value's, first's, last's
            ok = ctx.alive
            rows["window_unpermute"].append(_timed(
                f"unpermute, float64 and its validity as two arrays, "
                f"{label}", n,
                lambda: win.window_unpermute(ctx, fsorted, ok),
                lambda: win.window_unpermute_plain(ctx, fsorted, ok),
                n * (4 + 8 + 1) + n * (8 + 1)))
            del ok
        del fvals, fsorted
        if part:  # K11 at the moving frames of the partitioned contexts
            for width in EXTREME_WIDTHS:
                lo, hi = -(width // 2), width // 2
                # unfold reads width values a row: at 10,001 that is TBs
                library = library_perm = None
                if width <= 16:
                    pad = sorted_vals.new_full((hi,), torch.iinfo(
                        torch.int64).max)
                    library = lambda: torch.cat(  # noqa: E731
                        [pad, sorted_vals, pad]).unfold(0, width, 1).amin(1)
                    library_perm = lambda: torch.cat(  # noqa: E731
                        [pad, vals[perm], pad]).unfold(
                            0, width, 1).amin(1)[inv]
                rows["window_extreme"].append(_timed(
                    f"K11 min over rows {lo}..{hi}, {label}", n,
                    lambda: win.window_extreme(ctx, sorted_vals, None, None,
                                               lo, hi, "min"),
                    lambda: win.window_extreme_plain(ctx, sorted_vals, None,
                                                     None, lo, hi, "min"),
                    n * (8 + 4 + 4 + 4 + 8 + 1), library,
                    extra={"with_gather_ms": lambda: win.window_extreme(
                        ctx, gather()[0], None, None, lo, hi, "min"),
                        **({} if library_perm is None else
                           {"library_perm_ms": library_perm})}))
                # its float SUM and AVG over the queries' band
                # (framed_agg's sums over two finite offsets; the plain
                # version of a 10,001-row frame takes 27 s a call)
                if width > 16:
                    continue
                fs, _ = ctx.sorted_values(vals.to(torch.float64) / 100,
                                          None)
                zero = fs.new_zeros(hi)
                for fn in ("sum", "avg"):
                    rows["window_extreme"].append(_timed(
                        f"K11 float64 {fn} over rows {lo}..{hi}, {label}", n,
                        lambda: win.window_extreme(ctx, fs, None, None, lo,
                                                   hi, fn),
                        lambda: win.window_extreme_plain(ctx, fs, None, None,
                                                         lo, hi, fn),
                        n * (8 + 4 + 4 + 4 + 8 + 1),
                        lambda: torch.cat([zero, fs, zero]).unfold(
                            0, width, 1).sum(1),
                        compare=_rel_err))
                del fs, zero
        del ctx, keys, perm, inv, sorted_vals, part, order, vals, sel
        torch.cuda.empty_cache()
    # the moves where the order is near the stored one (W8's running total
    # over o_orderkey) and where few rows live (1% of lineitem's)
    od, li = tables["orders"], tables["lineitem"]
    for label, table, part, order, vals, live in (
            ("orders in one segment by o_orderkey (W8's order)", od, [],
             ["o_orderkey"], "o_totalprice", None),
            ("lineitem by l_suppkey; ORD, l_partkey % 100 = 0 live", li,
             ["l_suppkey"], ["l_shipdate", "l_orderkey", "l_linenumber"],
             "l_extendedprice", "l_partkey")):
        c = lambda name: _device_column(table, name, dev)  # noqa: E731
        n = table.num_rows
        sel = torch.ones(n, dtype=torch.bool, device=dev) if live is None \
            else c(live) % 100 == 0
        ctx = win.build_window_context(
            [Column(c(p), None, dt.LongType()) for p in part],
            [(c(o), None, dt.LongType(), True, None) for o in order], sel)
        print(f"moves at {label}: {int(ctx.n_live)} of {n} rows live",
              flush=True)
        values = c(vals)
        _time_moves(rows, label, ctx.perm, ctx.n_live, values)
        fsorted, _ = ctx.sorted_values(values.to(torch.float64) / 100, None)
        _time_unpermute(rows, label, ctx, fsorted)
        del ctx, sel, values, fsorted
        torch.cuda.empty_cache()
    sources = {"window_pack": ("window_bounds.cu", "sail_tpu/ops/sort.py:65"),
               "window_bounds": ("window_bounds.cu", "sail_tpu/ops/window.py:52"),
               "window_ranks": ("window_ranks.cu", "sail_tpu/ops/window.py:108"),
               "window_gather": ("window_perm.cu", "sail_tpu/ops/window.py:219"),
               "window_inverse": ("window_perm.cu", "sail_tpu/ops/window.py:78"),
               "window_scan": ("window_scan.cu", "sail_tpu/ops/window.py:328"),
               "window_frame": ("window_scan.cu", "sail_tpu/ops/window.py:207"),
               "window_extreme": ("window_extreme.cu",
                                  "sail_tpu/ops/window.py:293"),
               "window_unpermute": ("window_perm.cu",
                                    "sail_tpu/ops/window.py:82")}
    entries = []
    for name, shapes in rows.items():
        main = shapes[0]
        src, replaces = sources[name]
        entries.append(dict(
            name=name, source=f"sail_tpu_torch/csrc/{src}", replaces=replaces,
            max_abs_err=max(s["max_abs_err"] for s in shapes),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], library_ms=main["library_ms"],
            shapes=shapes))
    return entries, functions


def _answers_agree(name: str, got: pa.Table, want: pa.Table) -> None:
    """Window/union answers: the same rows in the same order; integers,
    decimals, dates and strings exactly, float64 within
    WINDOW_FLOAT_RTOL."""
    if got.schema != want.schema or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got.num_rows} rows {got.schema} != "
                             f"{want.num_rows} rows {want.schema}")
    for i, cname in enumerate(want.column_names):
        g, w = got.column(i), want.column(i)
        if pa.types.is_floating(w.type):
            gv, wv = g.to_numpy(zero_copy_only=False), \
                w.to_numpy(zero_copy_only=False)
            ok = np.isclose(gv, wv, rtol=WINDOW_FLOAT_RTOL, atol=0,
                            equal_nan=True)
            if not ok.all():
                raise AssertionError(f"{name} column {cname}: "
                                     f"{gv[~ok][:3]} != {wv[~ok][:3]}")
        elif g.to_pylist() != w.to_pylist():
            raise AssertionError(f"{name} column {cname} differs")


def check_with_cpu(tables: dict, sf: float, queries: dict) -> dict:
    """Phases 9 and 12: ``queries`` ({name: sql}) over ``tables`` on the
    card against the port's CPU session, each counting its host syncs."""
    from sail_tpu_torch import SparkSession

    card = SparkSession({"spark.sail.device": "cuda"})
    cpu = SparkSession({"spark.sail.device": "cpu"})
    _register(card, tables)
    _register(cpu, tables)
    report = {}
    for name, sql in queries.items():
        t = time.perf_counter()
        got, syncs = _run_counting_syncs(card, sql)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        want = cpu.sql(sql).toArrow()
        cpu_s = time.perf_counter() - t
        if got.num_rows == 0 and want.num_rows:
            raise AssertionError(f"{name}: empty answer, the CPU's has "
                                 f"{want.num_rows} rows")
        _answers_agree(name, got, want)
        report[name] = dict(rows=got.num_rows, card_first_s=card_s,
                            cpu_s=cpu_s, syncs=syncs)
        print(f"{name.upper()} SF{sf}: {got.num_rows} rows agree with the "
              f"CPU session (card {card_s:.2f} s, "
              f"{_syncs_line(name, syncs)}; CPU {cpu_s:.2f} s)", flush=True)
    card.stop()
    cpu.stop()
    return report


def _check_w1(result: pa.Table, orders: pa.Table) -> None:
    """W1 against numpy: the three most expensive orders of each customer
    (ties by order key), ordered by customer and rank."""
    cust = orders.column("o_custkey").to_numpy()
    key = orders.column("o_orderkey").to_numpy()
    price = _unscaled(orders.column("o_totalprice"))
    order = np.lexsort((key, -price, cust))
    c = cust[order]
    start = np.r_[True, c[1:] != c[:-1]]
    pos = np.arange(len(c)) - np.maximum.accumulate(
        np.where(start, np.arange(len(c)), 0))
    keep = order[pos < 3]
    want = (cust[keep], key[keep], price[keep], pos[pos < 3] + 1)
    got = (result.column(0).to_numpy(), result.column(1).to_numpy(),
           _unscaled(result.column(2)), result.column(3).to_numpy())
    for g, w, label in zip(got, want, ("custkey", "orderkey", "totalprice",
                                       "rn")):
        if not np.array_equal(g, w):
            raise AssertionError(f"W1: {label} differs from numpy")


def run_query_path(tables: dict, sf: float, runs: int, profile: bool,
                   queries: dict, kernels: dict, check) -> dict:
    """Phases 10 and 13: ``queries`` at ``sf``, one warm-up and ``runs``
    timed runs each, with rows and peak device memory; ``check(name,
    result, spark)`` holds an answer to its oracle (and returns what to
    add to the query's entry, or None); every query launches the kernels
    ``kernels`` names for it."""
    from sail_tpu_torch import SparkSession

    spark = SparkSession({"spark.sail.device": "cuda"})
    _register(spark, tables)
    counters = _counters()
    report = {"launches_on_path": {}}
    for name, sql in queries.items():
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        result = spark.sql(sql).toArrow()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        times = []
        for i in range(runs):
            if i == 0:
                for fn in counters.values():
                    fn.launches = 0
            t = time.perf_counter()
            result = spark.sql(sql).toArrow()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                launches = {k: fn.launches for k, fn in counters.items()}
                routes = spark.last_chain_routes
                sorts = spark.last_sort_routes
        report["launches_on_path"][name] = launches
        entry = dict(first_s=first, query_s=times, rows=result.num_rows,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     chain_routes=_print_routes(name.upper(), routes,
                                                name.startswith("e")),
                     sort_routes=_print_sorts(name.upper(), sorts))
        if profile:
            entry["profile"] = profile_query(spark, sql)
        entry.update(check(name, result, spark) or {})
        report[name] = entry
        print(f"{name.upper()} SF{sf}: first run {first:.3f} s, then "
              f"{', '.join(f'{x * 1e3:.1f} ms' for x in times)}; "
              f"{result.num_rows} rows; peak "
              f"{entry['peak_bytes'] / 2**30:.2f} GiB; launches in one run "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for kernel in kernels[name]:
            if launches[kernel] == 0:
                raise AssertionError(f"{kernel} never launched on "
                                     f"{name.upper()}'s path")
    spark.stop()
    return report


def run_window_path(tables: dict, sf: float, runs: int,
                    profile: bool) -> dict:
    """Phase 10: the window and union queries; W1 against numpy, W7
    against Q17's answer."""
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES as TPCH
    from sail_tpu_torch.benchmarks.window_queries import QUERIES

    def check(name, result, spark):
        if name == "w1":
            _check_w1(result, tables["orders"])
        elif name == "w7":
            q17 = spark.sql(TPCH[17]).toArrow()
            if result.column(0).to_pylist() != q17.column(0).to_pylist():
                raise AssertionError(f"W7 {result.column(0).to_pylist()} != "
                                     f"Q17 {q17.column(0).to_pylist()}")
            return {"q17": q17.column(0).to_pylist()}
        return None

    return run_query_path(tables, sf, runs, profile, QUERIES, PATH_KERNELS,
                          check)


# ---------------------------------------------------------------------------
# phases 11-13: the expression kernels and the analytical SQL over them
# ---------------------------------------------------------------------------

# K12-K15 against their plain versions: float64 within EXPR_ULPS units in
# the last place of the plain version's value (CUDA's double functions are
# within 1-2 ulp of the correctly rounded result, torch's and the plain
# formulas within a few); integers, decimals, dates and bools exactly
EXPR_ULPS = 8
# a kernel's time at its headline shape must be within twice its bound
EXPR_BOUND_SHARE = 0.5
_EXPR_SOURCE = "sail_tpu_torch/csrc/expr_math.cu"


def _ulp_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of a kernel's output and its plain version's:
    exact for integers and bools, within EXPR_ULPS ulp for float64 (NaN
    and infinities in the same places)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    if not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError("exact results differ")
        return 0.0
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("NaN positions differ")
    fin = torch.isfinite(want)
    if not torch.equal(got[~fin & ~torch.isnan(want)],
                       want[~fin & ~torch.isnan(want)]):
        raise AssertionError("infinities differ")
    diff = (got[fin] - want[fin]).abs()
    tol = EXPR_ULPS * 2.0 ** -52 * want[fin].abs()
    bad = diff > tol
    if bool(bad.any()):
        i = int(bad.nonzero()[0])
        raise AssertionError(f"float64 beyond {EXPR_ULPS} ulp: "
                             f"{float(got[fin][i])!r} != "
                             f"{float(want[fin][i])!r}")
    return float(diff.max()) if diff.numel() else 0.0


def _cv_err(got, want) -> float:
    """_ulp_err over (data, validity) pairs (or a lone tensor)."""
    got = got if isinstance(got, tuple) else (got, None)
    want = want if isinstance(want, tuple) else (want, None)
    (g, gv), (w, wv) = got, want
    if (gv is None) != (wv is None) or \
            (gv is not None and not torch.equal(gv, wv)):
        raise AssertionError("validities differ")
    return _ulp_err(g, w)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None and t.dim() > 0)


def _expr_columns(tables: dict, dev) -> dict:
    """The columns phase 11 runs the kernels over, from the SF tables:
    lineitem's l_extendedprice (unscaled decimal), l_quantity,
    l_discount, l_orderkey and orders' o_orderdate, and copies with the
    edge values planted (NULLs, NaN, +-inf, x <= 0 for the logarithms,
    INT64_MIN for abs, shift counts of 64 and more)."""
    li, od = tables["lineitem"], tables["orders"]
    gen = torch.Generator(device=dev).manual_seed(11)
    price = _device_column(li, "l_extendedprice", dev)
    n = price.shape[0]
    c = dict(price=price, qty=_device_column(li, "l_quantity", dev),
             disc=_device_column(li, "l_discount", dev),
             okey=_device_column(li, "l_orderkey", dev),
             ship=_device_column(li, "l_shipdate", dev),
             date=_device_column(od, "o_orderdate", dev))
    c["valid"] = torch.rand(n, generator=gen, device=dev) < 0.9
    edge = c["price"].clone()
    edge[::1000] = 0
    edge[1::1001] = -edge[1::1001]
    c["price_edge"] = edge  # x <= 0 for the logs
    dbl = c["price"].to(torch.float64) / 100.0
    dbl[::997] = float("nan")
    dbl[1::991] = float("inf")
    dbl[2::983] = float("-inf")
    dbl[3::13] = -dbl[3::13]
    dbl[4::1009] = 0.0
    c["dbl"] = dbl
    okey = c["okey"].clone()
    okey[::10_007] = -(1 << 63)
    c["okey_edge"] = okey
    c["counts"] = torch.randint(0, 130, (n,), generator=gen, device=dev,
                                dtype=torch.int64)
    nd = c["date"].shape[0]
    c["date_valid"] = torch.rand(nd, generator=gen, device=dev) < 0.9
    c["months"] = torch.randint(-30, 31, (nd,), generator=gen, device=dev,
                                dtype=torch.int32)
    c["us"] = c["date"].to(torch.int64) * 86_400_000_000 + torch.randint(
        0, 86_400_000_000, (nd,), generator=gen, device=dev)
    return c


# ptxas's report of each K12, K14 and K15 instantiation (nvcc -Xptxas
# -v): the template arguments of unary_kernel<OP, In>, binary_kernel<OP,
# X, Y, YS> and calendar_kernel<OP, XK, YK, SC> in their mangled names
_TEMPLATE_ARG = re.compile(r"Li(-?\d+)E|Lb([01])E|([ixd])")
_MANGLED_TYPES = {"i": "int", "x": "int64", "d": "float64"}


def _instantiations(log: str, kernel: str) -> dict:
    """{template arguments: (registers, spill store bytes)} of each
    instantiation of ``kernel`` in a compiler log (integers, ``int``,
    ``int64``, ``float64`` and bools in their order)."""
    pattern = re.compile(kernel + r"I((?:Li-?\d+E|Lb[01]E|[ixd])+)E")
    out, current, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = pattern.search(line)
            current = None if m is None else tuple(
                int(a) if a else bool(int(b)) if b else _MANGLED_TYPES[t]
                for a, b, t in _TEMPLATE_ARG.findall(m.group(1)))
            spill = 0
        elif current is not None and "bytes spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores",
                                  line).group(1))
        elif current is not None and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[current] = (regs, spill)
            current = None
    return out


def _print_instantiations(label: str, regs: dict, ops) -> None:
    """Print each instantiation's registers and spill stores (the op by
    name); fail on a spill or on none."""
    print(f"{label} instantiations (op, arguments: registers, spill store "
          f"bytes): " + "; ".join(
              f"{ops[k[0]]} {' '.join(map(str, k[1:]))}: {r}, {sp}"
              for k, (r, sp) in sorted(regs.items())), flush=True)
    spilling = [k for k, (_, sp) in regs.items() if sp]
    if not regs or spilling:
        raise AssertionError(f"{label}: {len(regs)} instantiations, "
                             f"spilling {spilling}")


def _op_registers(regs: dict, code: int) -> dict:
    """The registers of each instantiation of one op, by its other
    template arguments."""
    return {" ".join(map(str, k[1:])): r for k, (r, _) in regs.items()
            if k[0] == code}


def _expr_entry(name: str, replaces: str, rows: list,
                enforce: bool = True) -> dict:
    """A kernel's JSON entry: its headline (first) shape's numbers, every
    shape under ``shapes``; the headline must reach EXPR_BOUND_SHARE of
    its bound where ``enforce``."""
    head = rows[0]
    share = head["bound_ms"] / head["ms"]
    print(f"{name}: headline {head['shape']} {head['ms']:.3f} ms against a "
          f"bound of {head['bound_ms']:.3f} ms ({share:.0%})", flush=True)
    if enforce and share < EXPR_BOUND_SHARE:
        raise AssertionError(f"{name}: {share:.0%} of its bound at "
                             f"{head['shape']}, under "
                             f"{EXPR_BOUND_SHARE:.0%}")
    return dict(name=name, source=_EXPR_SOURCE, replaces=replaces,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], library_ms=head["library_ms"],
                shapes=rows)


def check_expr_kernels(tables: dict, dev) -> list:
    """Phase 11: K12-K15 over the SF tables' columns with the edge values
    planted, each op against its plain version, then timed beside it,
    its bound and, where one PyTorch call computes the same function on
    the same input, that call."""
    from sail_tpu_torch import csrc
    from sail_tpu_torch.functions import numeric as num

    c = _expr_columns(tables, dev)
    n, nd = c["price"].shape[0], c["date"].shape[0]
    valid, dvalid = c["valid"], c["date_valid"]
    print(f"phase 11: {n} lineitem rows, {nd} orders", flush=True)
    entries = []

    def unary(label, x, v, op, scale=0, library=None):
        # the bytes the op moves: its validity where it reads one (the
        # logarithms, isnan) and the logarithms' fresh one
        reads = v if op in num.LOG_OPS or op == "isnan" else None
        out_size = 1 if op == "isnan" else (
            8 if op in num.FLOAT_OPS or op in ("floor", "ceil")
            else x.element_size())
        row = _timed(f"{op} {label}", x.shape[0],
                     lambda: num.math_unary(x, v, op, scale),
                     lambda: num.math_unary_plain(x, v, op, scale),
                     _nbytes(x, reads) + x.shape[0] * (
                         out_size + (op in num.LOG_OPS)),
                     library, _cv_err)
        row["op"] = op
        return row

    price, dbl, okey = c["price_edge"], c["dbl"], c["okey_edge"]
    rows = [unary("l_extendedprice as float64, NaN, +-inf planted", dbl,
                  None, "sqrt", library=lambda: torch.sqrt(dbl))]
    rows.append(unary("l_extendedprice decimal(15,2), NULLs", price, valid,
                      "sqrt", 2))
    rows.append(unary("float64", dbl, None, "exp",
                      library=lambda: torch.exp(dbl)))
    for op in ("ln", "log10", "log1p"):
        rows.append(unary("l_extendedprice decimal, x <= 0 planted, NULLs",
                          price, valid, op, 2))
    # each op that one PyTorch call computes, beside that call on the
    # same float64 input (the call ignores the validity the kernel reads)
    for op, call in (("ln", torch.log), ("log10", torch.log10),
                     ("log2", torch.log2), ("log1p", torch.log1p),
                     ("expm1", torch.expm1), ("sin", torch.sin),
                     ("cos", torch.cos), ("tan", torch.tan),
                     ("asin", torch.asin), ("acos", torch.acos),
                     ("atan", torch.atan), ("sinh", torch.sinh),
                     ("cosh", torch.cosh), ("tanh", torch.tanh),
                     ("rint", torch.round), ("sign", torch.sign),
                     ("isnan", torch.isnan), ("floor", torch.floor),
                     ("ceil", torch.ceil), ("cbrt", None),
                     ("degrees", torch.rad2deg), ("radians", torch.deg2rad)):
        rows.append(unary("float64", dbl, valid, op, library=None
                          if call is None else lambda f=call: f(dbl)))
    for op in ("floor", "ceil"):
        rows.append(unary("l_quantity decimal(15,2)", c["qty"], None, op, 2))
    qty = c["qty"]
    rows.append(unary("l_quantity decimal(15,2)", qty, None, "negative", 2,
                      library=lambda: torch.neg(qty)))
    rows.append(unary("l_quantity decimal(15,2)", qty, None, "abs", 2,
                      library=lambda: torch.abs(qty)))
    rows.append(unary("l_orderkey int64, INT64_MIN planted", okey, None,
                      "abs", library=lambda: torch.abs(okey)))
    rows.append(unary("l_orderkey int64", okey, valid, "~",
                      library=lambda: torch.bitwise_not(okey)))
    rows.append(unary("float64", dbl, None, "negative",
                      library=lambda: torch.neg(dbl)))
    rows.append(unary("float64", dbl, None, "abs",
                      library=lambda: torch.abs(dbl)))
    # an int32 column (l_linenumber's width) through the int instantiations
    i32 = c["okey"].to(torch.int32)
    rows.append(unary("int32", i32, None, "sqrt"))
    rows.append(unary("int32", i32, None, "~",
                      library=lambda: torch.bitwise_not(i32)))
    log = csrc.build_logs()["expr_math.cu"]
    regs = _instantiations(log, "unary_kernel")
    _print_instantiations("K12", regs, num.UNARY_OPS)
    if len(regs) != 3 * len(num.UNARY_OPS) - 1:
        raise AssertionError(f"K12: {len(regs)} instantiations")
    for op in num.UNARY_OPS:
        # the headline: the first shape beside a PyTorch call, if any
        mine = sorted((r for r in rows if r["op"] == op),
                      key=lambda r: r["library_ms"] is None)
        for r in mine:
            r["registers"] = _op_registers(regs, num.UNARY_OPS.index(op))
        # K12's headline, as when it was one kernel: sqrt of float64
        entries.append(_expr_entry(_by_op("math_unary", op),
                                   "sail_tpu/plan/compiler.py:937", mine,
                                   enforce=op == "sqrt"))

    def rounding(label, x, half_even, digits, s, so, library=None):
        return _timed(f"{'bround' if half_even else 'round'}({digits}) "
                      f"{label}", x.shape[0],
                      lambda: num.round_number(x, half_even, digits, s, so),
                      lambda: num.round_number_plain(x, half_even, digits, s,
                                                     so),
                      2 * _nbytes(x), library, _cv_err)

    rows = [rounding("l_extendedprice decimal(15,2) to scale 0", price,
                     False, -2, 2, 0)]
    rows.append(rounding("l_extendedprice decimal(15,2) to scale 1", price,
                         True, 1, 2, 1))
    rows.append(rounding("l_orderkey int64", okey, False, -1, 0, 0))
    rows.append(rounding("l_orderkey int64", okey, True, -2, 0, 0))
    rows.append(rounding("float64", dbl, True, 3, 0, 0,
                         library=lambda: torch.round(dbl, decimals=3)))
    rows.append(rounding("float64", dbl, False, 2, 0, 0))
    entries.append(_expr_entry("round_number",
                               "sail_tpu/plan/compiler.py:1313", rows))

    # a literal operand is a scalar on the host, as the compiler passes it
    # (read there without waiting for the card)
    two = torch.tensor(2, dtype=torch.int32)
    seven = torch.tensor(7, dtype=torch.int32)
    four = torch.tensor(4, dtype=torch.int32)
    tax_d = c["disc"].to(torch.float64) / 100.0

    def binary(label, x, xv, y, yv, op, sx=0, sy=0, library=None):
        fresh = op in ("log", "nanvl") or (xv is not None and yv is not None)
        out_size = x.element_size() if op in num.BITWISE_OPS else 8
        # the validities are read where the result's is written
        read = _nbytes(x, xv, y, yv) if fresh else _nbytes(x, y)
        if op == "nanvl":  # y is read where x is a NaN only
            read -= _nbytes(y) - int(torch.isnan(x).sum()) * y.element_size()
        row = _timed(f"{op} {label}", n,
                     lambda: num.math_binary(x, xv, y, yv, op, sx, sy),
                     lambda: num.math_binary_plain(x, xv, y, yv, op, sx,
                                                   sy),
                     read + n * (out_size + fresh), library, _cv_err)
        row["op"] = op
        return row

    rows = [binary("l_discount decimal(15,2), 2", c["disc"], None, two, None,
                   "power", 2, library=lambda: torch.pow(tax_d, 2))]
    rows.append(binary("float64, 2", dbl, None, two, None, "power",
                       library=lambda: torch.pow(dbl, 2)))
    rows.append(binary("float64, l_orderkey", dbl, valid, okey, None,
                       "atan2", library=lambda: torch.atan2(
                           dbl, okey.to(torch.float64))))
    rows.append(binary("float64, l_quantity decimal", dbl, None, c["qty"],
                       valid, "hypot", 0, 2))
    rows.append(binary("float64, float64", dbl, None, tax_d, None, "hypot",
                       library=lambda: torch.hypot(dbl, tax_d)))
    rows.append(binary("l_extendedprice decimal, float64, x <= 0 planted",
                       price, valid, dbl, valid, "log", 2))
    rows.append(binary("float64, l_extendedprice decimal", dbl, valid, price,
                       None, "nanvl", 0, 2))
    rows.append(binary("l_orderkey int64, 7", okey, None, seven, None, "&",
                       library=lambda: torch.bitwise_and(okey, 7)))
    counts = c["counts"]
    rows.append(binary("l_orderkey int64, counts, both 16 B-aligned", okey,
                       None, counts, None, "|",
                       library=lambda: torch.bitwise_or(okey, counts)))
    rows.append(binary("l_orderkey int64, counts", okey, valid, counts,
                       None, "|", library=lambda: torch.bitwise_or(
                           okey, counts)))
    rows.append(binary("l_orderkey int64, counts", okey, None, counts,
                       valid, "^", library=lambda: torch.bitwise_xor(
                           okey, counts)))
    # Spark masks a shift count to 0-63: the call shifts by the counts
    # masked beforehand (outside its time)
    masked = counts.to(torch.int64) & 63
    rows.append(binary("l_orderkey int64 by 0-129", okey, None, counts,
                       None, "shiftleft", library=lambda:
                       torch.bitwise_left_shift(okey, masked)))
    rows.append(binary("l_orderkey int64 by 4", okey, None, four, None,
                       "shiftright", library=lambda:
                       torch.bitwise_right_shift(okey, 4)))
    regs = _instantiations(log, "binary_kernel")
    _print_instantiations("K14", regs, num.BINARY_OPS + ("square",))
    for op in num.BINARY_OPS:
        mine = sorted((r for r in rows if r["op"] == op),
                      key=lambda r: r["library_ms"] is None)
        for r in mine:
            r["registers"] = _op_registers(regs, num.BINARY_OPS.index(op))
        # K14's headline, as when it was one kernel: power(decimal, 2)
        entries.append(_expr_entry(_by_op("math_binary", op),
                                   "sail_tpu/plan/compiler.py:954", mine,
                                   enforce=op == "power"))

    date, us, ship = c["date"], c["us"], c["ship"]
    base = torch.tensor(10592, dtype=torch.int32)  # 1999-01-01
    three = torch.tensor(3, dtype=torch.int32)
    one = torch.tensor(1, dtype=torch.int32)

    def cal(label, op, x, xv, y=None, yv=None, xm=False, ym=False):
        out_size = 8 if op == "months_between" else 4
        fresh = xv is not None and yv is not None
        rows = max(t.shape[0] for t in (x, y) if t is not None and t.dim())
        read = _nbytes(x, xv, y, yv) if fresh else _nbytes(x, y)
        row = _timed(f"{op} {label}", rows,
                     lambda: num.calendar(x, xv, op, y, yv, xm, ym),
                     lambda: num.calendar_plain(x, xv, op, y, yv, xm, ym),
                     read + rows * (out_size + fresh), None, _cv_err)
        row["op"] = op
        return row

    rows = [cal("l_shipdate, 1 (E5)", "add_months", ship, None, one),
            cal("o_orderdate, 3", "add_months", date, None, three),
            cal("o_orderdate, months, NULLs", "add_months", date, dvalid,
                c["months"], dvalid),
            cal("1999-01-01, o_orderdate", "months_between", base, None,
                date, dvalid),
            cal("o_orderdate, 1999-01-01", "months_between", date, None,
                base),
            cal("timestamps", "months_between", us, dvalid, us.flip(0),
                dvalid, True, True),
            cal("o_orderdate", "last_day", date, dvalid),
            cal("l_shipdate", "last_day", ship, None),
            cal("o_orderdate", "weekofyear", date, None),
            cal("l_shipdate", "weekofyear", ship, None),
            cal("timestamps", "weekofyear", us, None, xm=True)]
    regs = _instantiations(log, "calendar_kernel")
    _print_instantiations("K15", regs, num.CALENDAR_OPS)
    for op in num.CALENDAR_OPS:
        for r in rows:
            if r["op"] == op:
                r["registers"] = _op_registers(regs,
                                               num.CALENDAR_OPS.index(op))
        # K15's headline, as when it was one kernel: add_months at 60M
        entries.append(_expr_entry(
            _by_op("calendar", op), "sail_tpu/plan/compiler.py:1177",
            [r for r in rows if r["op"] == op],
            enforce=op == "add_months"))
    del c
    torch.cuda.empty_cache()
    return entries


def _e3_numpy(li: pa.Table) -> list:
    """E3 in numpy: (bucket, d10, count, sum(l_orderkey & 7),
    max(l_orderkey >> 4), sum(l_linenumber | 8), sum(l_suppkey ^
    l_partkey)) of the first 100 groups by (bucket, d10). The groups are
    few (buckets of 1000 up to l_extendedprice's 104,950, d10 0 or 1), so
    one small key a row, a radix sort of it and segment reductions; the
    float64 bincount sums are exact (below 2^53)."""
    price = _unscaled(li.column("l_extendedprice"))
    disc = _unscaled(li.column("l_discount"))
    okey = li.column("l_orderkey").to_numpy()
    line = li.column("l_linenumber").to_numpy().astype(np.int64)
    supp = li.column("l_suppkey").to_numpy()
    part = li.column("l_partkey").to_numpy()
    bucket = np.floor((price / 100.0) / 1000.0).astype(np.int64)
    d10 = -((-(disc * 10)) // 100)
    if bucket.min() < 0 or d10.min() < 0 or d10.max() > 15 or \
            bucket.max() > 2000:
        raise AssertionError("E3: keys outside the oracle's packing")
    key = (bucket * 16 + d10).astype(np.int16)
    order = np.argsort(key, kind="stable")  # a radix sort of int16
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    groups = k[starts[:100]].astype(np.int64)
    counts = np.bincount(key, minlength=int(key.max()) + 1)[groups]
    width = int(key.max()) + 1

    def total(values):
        return np.bincount(key, weights=values.astype(np.float64),
                           minlength=width)[groups].astype(np.int64)

    top = np.maximum.reduceat((okey >> 4)[order], starts)[:100]
    return [(int(g // 16), int(g % 16), int(c), int(a), int(m), int(b),
             int(x)) for g, c, a, m, b, x in zip(
                 groups, counts, total(okey & 7), top, total(line | 8),
                 total(supp ^ part))]


def _add_months_np(days: np.ndarray, k: int) -> np.ndarray:
    month = days.astype("datetime64[D]").astype("datetime64[M]")
    day = days - month.astype("datetime64[D]").astype(np.int64)
    target = month + k
    length = ((target + 1).astype("datetime64[D]") -
              target.astype("datetime64[D]")).astype(np.int64)
    return target.astype("datetime64[D]").astype(np.int64) + \
        np.minimum(day, length - 1)


def _e5_numpy(li: pa.Table) -> list:
    """E5 in numpy, by l_shipmode in order: (mode, avg datediff(receipt,
    ship), late count, min(ship + 30), max(commit - 7), max(add_months(
    ship, 1))), dates as days. add_months is monotone in the date, so the
    last is add_months of the latest ship date."""
    def days(name):
        return np.asarray(li.column(name).combine_chunks().view(pa.int32())
                          ).astype(np.int64)
    ship, commit, receipt = days("l_shipdate"), days("l_commitdate"), \
        days("l_receiptdate")
    modes = li.column("l_shipmode").combine_chunks()
    if pa.types.is_dictionary(modes.type):
        modes = modes.cast(modes.type.value_type)
    names = sorted(pc.unique(modes).to_pylist())
    codes = np.asarray(pc.index_in(modes, value_set=pa.array(names)))
    out = []
    for k, mode in enumerate(names):
        m = codes == k
        s = ship[m]
        out.append((mode, (receipt[m] - s).sum() / m.sum(),
                    int((receipt[m] - commit[m] > 0).sum()),
                    int(s.min() + 30), int(commit[m].max() - 7),
                    int(_add_months_np(s.max(keepdims=True), 1)[0])))
    return out


def _check_e3(result: pa.Table, li: pa.Table) -> None:
    want = _e3_numpy(li)
    got = [(r[0], int(r[1]), *r[2:]) for r in
           (tuple(x.values()) for x in result.to_pylist())]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w) \
            if len(got) == len(want) else None
        raise AssertionError(f"E3 differs from numpy at row {bad}: "
                             f"{got[bad] if bad is not None else len(got)} "
                             f"!= {want[bad] if bad is not None else len(want)}")


def _check_e5(result: pa.Table, li: pa.Table) -> None:
    want = _e5_numpy(li)
    epoch = datetime.date(1970, 1, 1)
    got = [tuple(x.values()) for x in result.to_pylist()]
    if len(got) != len(want):
        raise AssertionError(f"E5: {len(got)} rows, numpy {len(want)}")
    for g, w in zip(got, want):
        g = (g[0], g[1], g[2], *((d - epoch).days for d in g[3:]))
        if g[0] != w[0] or g[2:] != w[2:] or \
                not math.isclose(g[1], w[1], rel_tol=FLOAT_RTOL):
            raise AssertionError(f"E5: {g} != numpy {w}")


def run_expr_path(tables: dict, sf: float, runs: int, profile: bool) -> dict:
    """Phase 13: E1-E6; E3 and E5 against numpy at full size."""
    from sail_tpu_torch.benchmarks.expr_queries import KERNELS, QUERIES

    def check(name, result, spark):
        if name == "e3":
            _check_e3(result, tables["lineitem"])
        elif name == "e5":
            _check_e5(result, tables["lineitem"])

    return run_query_path(tables, sf, runs, profile, QUERIES, KERNELS,
                          check)


# ---------------------------------------------------------------------------
# phase 14: K16 and K17 at the path's shapes
# ---------------------------------------------------------------------------

CHAIN_SOURCE = "sail_tpu_torch/ops/chain_codegen.py"
CHAIN_REPLACES = {"chain": "sail_tpu/exec/local.py:1598",
                  "chain_reduce": "sail_tpu/exec/local.py:1869"}
# the queries phase 14 runs at --sf: K17 over Q1's, Q6's and E2's chains
# (and each of them as a K16 program, as an aggregate past K17's limits
# would run it), K16 where Q3 filters lineitem under its joins and over
# Q19's predicate; Q30's K17 runs in phase 7 at --cb-rows
CHAIN_QUERIES = ("q1", "q6", "e2", "q3", "q19")
# the chain interpreter's times (ms) at these shapes, before the kernels
# were generated a program (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W):
# (kernel, query, whether it is a K17 chain run as a K16 program)
INTERPRETER_MS = {("chain", "q1", True): 3.964, ("chain", "q6", True): 5.606,
                  ("chain", "e2", True): 10.662, ("chain", "q3", False): 0.541,
                  ("chain", "q19", False): 1.002,
                  ("chain_reduce", "q1", False): 8.183,
                  ("chain_reduce", "q6", False): 6.504,
                  ("chain_reduce", "e2", False): 13.346,
                  ("chain_reduce", "q19", False): 0.169,
                  ("chain_reduce", "cb30", False): 50.414}
# the ops whose float64 results the card's math library and torch's may
# round apart (K12 and K14 are held to EXPR_ULPS ulp for them)
_LIBM_UNARY = frozenset(("exp", "expm1", "ln", "log10", "log2", "log1p",
                         "sin", "cos", "tan", "asin", "acos", "atan",
                         "sinh", "cosh", "tanh", "cbrt"))


@contextlib.contextmanager
def captured_chains():
    """Records each K16 stage and each K17 aggregate the executors run
    while the block runs: {"k16": [(executor, stage, child)], "k17":
    [(executor, aggregate, stage, child)]}."""
    from sail_tpu_torch.exec import local as xl

    got = {"k16": [], "k17": []}
    apply, reduce = xl.LocalExecutor._apply_stage, \
        xl.LocalExecutor._reduce_chain

    def applied(ex, stage, child, consumer):
        if stage.route == "K16":
            got["k16"].append((ex, stage, child))
        return apply(ex, stage, child, consumer)

    def reduced(ex, p, stage, child):
        got["k17"].append((ex, p, stage, child))
        return reduce(ex, p, stage, child)

    xl.LocalExecutor._apply_stage = applied
    xl.LocalExecutor._reduce_chain = reduced
    try:
        yield got
    finally:
        xl.LocalExecutor._apply_stage = apply
        xl.LocalExecutor._reduce_chain = reduce


def _libm(prog) -> bool:
    """The program calls a function that libm and the card may round
    apart."""
    from sail_tpu_torch.functions import numeric as num
    from sail_tpu_torch.ops import chain as chn

    for ins in prog.instrs:
        name = chn.OPCODES[ins[0]]
        if name == "NUM1" and num.UNARY_OPS[ins[5]] in _LIBM_UNARY or \
                name == "NUM2" and num.BINARY_OPS[ins[5]] in (
                    "atan2", "hypot", "power", "log") or \
                name == "CAL" and num.CALENDAR_OPS[ins[5]] == \
                "months_between":
            return True
    return False


def _cv_compare(ulps: bool):
    """K16's outputs against the plain version's: (data, validity) pairs,
    the validity exactly and the data where valid, exactly (float64 too)
    or, with ``ulps``, within EXPR_ULPS ulp."""
    def compare(got, want):
        (g, gv), (w, wv) = got, want
        if (gv is None) != (wv is None) or \
                (gv is not None and not torch.equal(gv, wv)):
            raise AssertionError("validities differ")
        if gv is not None:
            g, w = g[wv], w[wv]
        if g.is_floating_point():
            if ulps:
                return _ulp_err(g, w)
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            if not bool(same.all()):
                raise AssertionError("float64 differs")
            return 0.0
        if not torch.equal(g, w):
            raise AssertionError("values differ")
        return 0.0
    return compare


def _elem(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sectors(live: torch.Tensor, width: int) -> int:
    """The bytes of the 32-byte sectors of a column of ``width``-byte
    values that hold at least one ``live`` row."""
    per = 32 // width
    pad = -live.shape[0] % per
    if pad:
        live = torch.cat([live, live.new_zeros(pad)])
    return 32 * int(live.view(-1, per).any(1).sum())


def _k16_bytes(prog, sel) -> int:
    """What a K16 program must move: the selection read once, each input
    (and validity) read once, each stored column (and validity) and the
    selection written once."""
    n = sel.shape[0]
    read = n + sum(n * _elem(d) + (n if null else 0)
                   for _, d, null in prog.inputs)
    return read + n + sum(n * _elem(d) + (n if null else 0)
                          for d, null in prog.outputs)


def _k17_bytes(prog, filters, cols, sel) -> int:
    """What a K17 program must move: the selection once, and each input
    (and validity) in the 32-byte sectors that hold a row still live where
    the program first reads it: selected, and kept by every filter before
    that read (a row a filter killed needs no more of its columns). The
    filters' predicates come from one plain run of them as outputs; the
    program has one FILTER a filter, in their order."""
    from sail_tpu_torch.ops import chain as chn

    live = [sel]
    if filters:
        preds, _ = chn.run_chain_plain(
            chn.build_program([], filters, sel.device), cols, sel)
        for d, v in preds:
            keep = d.bool() if v is None else d.bool() & v
            live.append(live[-1] & keep)
    seen, at = {}, 0
    for ins in prog.instrs:
        name = chn.OPCODES[ins[0]]
        if name == "FILTER":
            at += 1
        elif name == "COL":
            seen.setdefault(ins[5], at)
    if at != len(filters):
        raise AssertionError(f"{at} FILTERs for {len(filters)} filters")
    total = sel.shape[0]
    for slot, (_, d, null) in enumerate(prog.inputs):
        rows = live[seen[slot]]
        total += _sectors(rows, _elem(d)) + (_sectors(rows, 1) if null
                                             else 0)
    return total


def _compiled_row(row: dict, prog, key) -> dict:
    """A phase-14 row with its program's compile and the driver's report
    of its kernel; the interpreter's time at the shape, if any, is printed
    beside it (PERF.md's, not measured in this run)."""
    from sail_tpu_torch.ops import chain_codegen as cg

    gen, k = cg.kernel(prog, torch.device("cuda"))
    row.update(compile_ms=k.compile_s * 1e3, regs=k.regs,
               local_bytes=k.local_bytes, blocks_per_sm=k.per_sm,
               rows_a_thread=gen.rows,
               bound_share=row["bound_ms"] / row["ms"])
    old = INTERPRETER_MS.get(key)
    print(f"    compiled in {row['compile_ms']:.1f} ms; {k.regs} registers, "
          f"{k.local_bytes} B of local memory a thread, {k.per_sm} blocks "
          f"an SM; "
          f"{100 * row['bound_share']:.0f}% of its bound"
          + ("" if old is None else f"; [interpreter {old:.3f} ms]"),
          flush=True)
    return row


def _k16_row(label, prog, chain_fn, cols, sel, key) -> dict:
    from sail_tpu_torch.ops import chain as chn

    n = sel.shape[0]

    def flat(res):
        outs, s = res
        return [(s, None)] + list(outs)

    return _compiled_row(_timed(
        f"{label} ({len(prog.instrs)} instructions)", n,
        lambda: flat(chn.run_chain(prog, cols, sel)),
        lambda: flat(chn.run_chain_plain(prog, cols, sel)),
        _k16_bytes(prog, sel), library=lambda: chain_fn(cols, sel),
        compare=_cv_compare(_libm(prog))), prog, key)


def _k17_row(label, ex, p, stage, child, key) -> dict:
    from sail_tpu_torch.ops import chain as chn

    cols, sel = ex._cols(child), child.device.sel
    kt = [p.input.schema[g].dtype for g in p.group_indices]
    at = [a.out_dtype for a in p.aggs]
    n = sel.shape[0]

    def flat(red):
        return [red.group_sel] + [c.data for c in red.keys + red.aggs] + \
            [c.validity for c in red.keys + red.aggs]

    def closures():
        out, s = stage.chain_fn(cols, sel)
        return ex._aggregate(p, out, s, stage.dicts)

    prog = stage.prog
    chain, node = ex._split_chain(p.input)
    _, filters, _, _, _, _ = ex._lower_chain(chain, child, node)
    return _compiled_row(_timed(
        f"{label} ({len(prog.instrs)} instructions, {prog.nbins} bins x "
        f"{len(prog.slots)} accumulators)", n,
        lambda: flat(chn.run_chain_reduce(prog, cols, sel, kt, at)),
        lambda: flat(chn.run_chain_reduce_plain(prog, cols, sel, kt, at)),
        _k17_bytes(prog, filters, cols, sel), library=closures), prog, key)


def check_chain_query(spark, name: str, sql: str, k16_too: bool) -> dict:
    """Phase 14 for one query: each K17 aggregate of ``sql`` against its
    plain version, timed beside it and beside the closures it replaced
    (``library_ms``: the chain's torch ops, then K2 or the sort and K1);
    with ``k16_too``, each K17 aggregate's chain also as a K16 program,
    else the query's largest K16 chain."""
    from sail_tpu_torch.ops import chain as chn

    with captured_chains() as got:
        spark.sql(sql).toArrow()
    torch.cuda.synchronize()
    rows = {"chain": [], "chain_reduce": []}
    for ex, p, stage, child in got["k17"]:
        rows["chain_reduce"].append(_k17_row(f"{name} K17", ex, p, stage,
                                             child,
                                             ("chain_reduce", name, False)))
        if k16_too:
            chain, node = ex._split_chain(p.input)
            fn, filters, frags, _, _, _ = ex._lower_chain(chain, child, node)
            prog = chn.build_program(filters, frags, child.device.sel.device)
            rows["chain"].append(_k16_row(
                f"{name}'s chain as K16", prog, fn, ex._cols(child),
                child.device.sel, ("chain", name, True)))
    if got["k16"] and not k16_too:
        ex, stage, child = max(got["k16"],
                               key=lambda x: x[2].device.sel.shape[0])
        rows["chain"].append(_k16_row(f"{name} K16", stage.prog,
                                      stage.chain_fn, ex._cols(child),
                                      child.device.sel,
                                      ("chain", name, False)))
    return rows


# Spark's casts of a float and IN with a NULL item, in one chain
CAST_IN_SQL = ("SELECT CAST(f AS BIGINT), CAST(f AS INT), "
               "CAST(f AS DECIMAL(12,2)), k IN (1, NULL) FROM t")
CAST_IN_EDGES = (math.nan, math.inf, -math.inf, 1e30, -1e30, 3e9, -3e9)


# rows of the cast and IN check: orders' count at SF10
CAST_IN_ROWS = 15_000_000


def _cast_in_table(lineitem: pa.Table) -> pa.Table:
    """lineitem's first CAST_IN_ROWS rows as f = l_extendedprice / 100
    (float64) with CAST_IN_EDGES planted in turn every 997th row, and k =
    l_linenumber."""
    lineitem = lineitem.slice(0, CAST_IN_ROWS)
    f = _unscaled(lineitem.column("l_extendedprice")) / 100.0
    for j, v in enumerate(CAST_IN_EDGES):
        f[j::997 * len(CAST_IN_EDGES)] = v
    return pa.table({"f": f, "k": lineitem.column("l_linenumber")})


def _cast_in_spark(table: pa.Table) -> list:
    """Spark's answers to CAST_IN_SQL, in numpy: (values, valid) a column.
    A double to BIGINT and INT: toward zero, NaN 0, saturated; to
    DECIMAL(12,2): rounded half up, NULL at NaN, +-inf and past 12 digits;
    k IN (1, NULL): TRUE at 1, else NULL."""
    f = table.column("f").to_numpy()
    k = table.column("k").to_numpy()
    fin = np.nan_to_num(f, nan=0.0)  # the infinities to the largest doubles
    big = np.trunc(np.clip(fin, -2.0 ** 63, 2.0 ** 63 - 1024)).astype(np.int64)
    big[f >= 2.0 ** 63] = (1 << 63) - 1
    big[f <= -2.0 ** 63] = -(1 << 63)
    small = np.trunc(np.clip(fin, -2.0 ** 31, 2.0 ** 31 - 1)).astype(np.int32)
    y = f * 100.0
    with np.errstate(invalid="ignore"):
        r = np.sign(y) * np.floor(np.abs(y) + 0.5)
        ok = np.isfinite(r) & (np.abs(r) < 1e12)
    dec = np.where(ok, r, 0).astype(np.int64)
    every = np.ones(len(f), dtype=bool)
    return [(big, every), (small, every), (dec, ok),
            (np.ones(len(f), dtype=bool), k == 1)]


def check_cast_in_chain(lineitem: pa.Table) -> dict:
    """Phase 14's cast and IN check: CAST_IN_SQL over CAST_IN_ROWS of
    lineitem's rows with NaN, +-inf, +-1e30 and +-3e9 planted, as one
    generated K16 program (F2I, F2I32, the decimal's bound, IN's NULL),
    held to run_chain_plain (exactly) and its answer to Spark's (numpy);
    then timed as a K16 row."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.ops import chain as chn

    table = _cast_in_table(lineitem)
    spark = SparkSession({"spark.sail.device": "cuda"})
    spark.createDataFrame(table).createOrReplaceTempView("t")
    with captured_chains() as got:
        result = spark.sql(CAST_IN_SQL).toArrow()
    torch.cuda.synchronize()
    routes = [r["route"] for r in spark.last_chain_routes]
    (ex, stage, child), = got["k16"]
    names = {chn.OPCODES[ins[0]] for ins in stage.prog.instrs}
    if routes != ["K16"] or not {"F2I", "F2I32", "ANDV"} <= names:
        raise AssertionError(f"cast/IN: routes {routes}, ops {names}")
    for j, (want, valid) in enumerate(_cast_in_spark(table)):
        col = result.column(j).combine_chunks()
        if not np.array_equal(col.is_valid().to_numpy(zero_copy_only=False),
                              valid):
            raise AssertionError(f"cast/IN column {j}: NULLs differ")
        got_values = _unscaled(result.column(j)) if j == 2 else \
            col.to_numpy(zero_copy_only=False)
        if not np.array_equal(np.asarray(got_values)[valid], want[valid]):
            raise AssertionError(f"cast/IN column {j}: values differ")
    print(f"  cast/IN: {table.num_rows} rows equal Spark's answers "
          f"({len(CAST_IN_EDGES)} edge values planted)", flush=True)
    row = _k16_row("cast/IN K16", stage.prog, stage.chain_fn,
                   ex._cols(child), child.device.sel, ("chain", "cast", False))
    spark.stop()
    return row


def check_chain_kernels(tables: dict) -> dict:
    """Phase 14: K16 and K17 over the SF tables (CHAIN_QUERIES), and the
    cast and IN check."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.expr_queries import QUERIES as EXPR
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES as TPCH

    spark = SparkSession({"spark.sail.device": "cuda"})
    _register(spark, tables)
    print("phase 14: K16 and K17 against their plain versions", flush=True)
    rows = {"chain": [], "chain_reduce": []}
    for name in CHAIN_QUERIES:
        sql = EXPR[name] if name.startswith("e") else TPCH[int(name[1:])]
        spark.sql(sql).toArrow()  # the uploads and the programs' build
        for k, v in check_chain_query(spark, name, sql,
                                      k16_too=name in ("q1", "q6", "e2")
                                      ).items():
            rows[k] += v
    spark.stop()
    rows["chain"].append(check_cast_in_chain(tables["lineitem"]))
    torch.cuda.empty_cache()
    return rows


def _chain_entry(name: str, rows: list) -> dict:
    head = rows[0]
    return dict(name=name, source=CHAIN_SOURCE, replaces=CHAIN_REPLACES[name],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], library_ms=head["library_ms"],
                shapes=rows)


# ---------------------------------------------------------------------------
# phase 15: K18 (the sort words) and the packed sort at the path's shapes
# ---------------------------------------------------------------------------

SORT_REPLACES = "sail_tpu/exec/local.py:1404"
# the queries phase 15 runs at --sf: E7's sort over orders and E3's
# grouping over lineitem (each K18 over its chain), Q18's grouping of
# lineitem by l_orderkey (over no chain, through K3 on the path: here as
# the K18 program of its key alone); ClickBench's Q25 sort and Q40's
# grouping of five keys run in phase 7 at --cb-rows
SORT_QUERIES = ("e7", "e3", "q18")
CB_SORT_SHAPES = (25, 40)


@contextlib.contextmanager
def captured_sorts():
    """Records what the executors sort while the block runs: {"k18":
    [(executor, chain, bottom batch, bottom node, the sort or aggregate,
    its K18 stage)], "k3": [(executor, aggregate, its columns, selection)]
    for each sorted grouping of columns (K3)}."""
    from sail_tpu_torch.exec import local as xl

    got = {"k18": [], "k3": []}
    stage_fn, agg_fn = xl.LocalExecutor._stage, xl.LocalExecutor._aggregate

    def staged(ex, chain, bottom, node, agg=None, sort=None):
        st = stage_fn(ex, chain, bottom, node, agg, sort)
        if st.route == "K18":
            got["k18"].append((ex, chain, bottom, node,
                               agg if agg is not None else sort, st))
        return st

    def aggregated(ex, p, cols, sel, dicts, words=None, ext=None):
        if words is None and p.group_indices:
            got["k3"].append((ex, p, cols, sel))
        return agg_fn(ex, p, cols, sel, dicts, words, ext)

    xl.LocalExecutor._stage = staged
    xl.LocalExecutor._aggregate = aggregated
    try:
        yield got
    finally:
        xl.LocalExecutor._stage = stage_fn
        xl.LocalExecutor._aggregate = agg_fn


def _k18_bytes(prog, sel) -> int:
    """What a K18 program must move: K16's bytes, and each key's word (8
    B) and validity (1 B) written once a row."""
    n = sel.shape[0]
    return _k16_bytes(prog, sel) + sum(n * (8 + int(nullable))
                                       for _, nullable, _, _ in
                                       prog.sort_keys)


def _k18_compare(libm: bool):
    """K18's outputs against its plain version's: the selection, the
    validities and the integers exactly; the chain's columns as phase 14
    holds K16's; each key's word and the extremes exactly, or where the
    program calls a libm function within EXPR_ULPS of a float64 key's word
    (a word of a finite double moves by one a ulp)."""
    cv = _cv_compare(libm)

    def compare(got, want):
        kind, g, gv = got
        _, w, wv = want
        if kind == "col":
            return cv((g, gv), (w, wv))
        if (gv is None) != (wv is None) or \
                (gv is not None and not torch.equal(gv, wv)):
            raise AssertionError(f"{kind}: validities differ")
        if torch.equal(g, w):
            return 0.0
        diff = float((g - w).abs().max()) if libm else math.inf
        if diff > EXPR_ULPS:
            raise AssertionError(f"{kind}: K18 differs from its plain "
                                 f"version by {diff}")
        return diff
    return compare


def _k18_items(res) -> list:
    return [("sel", res.sel, None)] + \
        [("col", d, v) for c in res.cols if c is not None for d, v in [c]] + \
        [("word", w, v) for w, v in res.words] + [("ext", res.ext, None)]


def _sort_row(label, ex, chain, bottom, node, top, prog, nulls_first,
              grouping: bool) -> dict:
    """Phase 15 at one shape: K18 against its plain version, then timed
    beside its bound and beside the route it replaced (``library_ms``:
    K16 where the chain computes, the keys' closures and K3, then the
    passes, and for a grouping each key gathered into sorted order and
    compared with its neighbour); the sort of K18's words as the passes
    against the packed word (the extremes read, the pack, one sort), whose
    permutations' live prefixes must be equal."""
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.ops import chain as chn
    from sail_tpu_torch.ops import sort as srt
    from sail_tpu_torch.columnar.batch import Column

    cols, sel = ex._cols(bottom), bottom.device.sel
    n = sel.shape[0]
    chain_fn, filters, frags, dicts, schema, _ = ex._lower_chain(
        chain, bottom, node)
    k16 = chn.build_program(filters, frags, sel.device)
    if k16.instrs:
        ex._compiled(k16)

    def replaced():
        if k16.instrs:
            top_cols, top_sel = chn.run_chain(k16, cols, sel)
        else:
            top_cols, top_sel = [cols[k] for _, k in k16.out_map], sel
        if grouping:
            keys = [top_cols[g] for g in top.group_indices]
            words = [(srt.order_keys(d), v, True) for d, v in keys]
        else:
            words = ex._sort_words(top, top_cols, top_sel, dicts, schema)
        perm = srt.lexsort_keys(words, top_sel)
        if grouping:
            agg._keys_equal_adjacent([Column(d[perm], None if v is None
                                             else v[perm], None)
                                      for d, v in keys])
        return perm

    out = chn.run_chain_sort(prog, cols, sel)
    words = [(w, v, nf) for (w, v), nf in zip(out.words, nulls_first)]
    passes_words = [(w if v is None or not grouping else
                     torch.where(v, w, 0), v, nf) for w, v, nf in words]
    got = srt.sort_words(words, out.sel, out.ext, grouping)
    passes = srt.lexsort_keys(passes_words, out.sel)
    n_live = int(out.sel.sum())
    if got.layout is not None and not torch.equal(got.perm[:n_live],
                                                  passes[:n_live]):
        raise AssertionError(f"{label}: the packed permutation's live "
                             f"prefix differs from the passes'")
    layout = got.layout
    extra = {"passes_ms": lambda: srt.lexsort_keys(passes_words, out.sel),
             "packed_ms": lambda: srt.sort_words(words, out.sel, out.ext,
                                                 grouping)}
    if layout is not None:
        extra["pack_ms"] = lambda: srt.window_pack(words, out.sel, layout)
        extra["pack_plain_ms"] = lambda: srt.window_pack_plain(
            words, out.sel, layout)
    row = _timed(
        f"{label} ({len(prog.instrs)} instructions, "
        f"{len(prog.sort_keys)} keys, {n_live} live rows, "
        f"{'packed in ' + str(layout.dead_shift + 1) + ' bits' if layout else 'passes: over 63 bits'})",
        n, lambda: _k18_items(chn.run_chain_sort(prog, cols, sel)),
        lambda: _k18_items(chn.run_chain_sort_plain(prog, cols, sel)),
        _k18_bytes(prog, sel), library=replaced,
        compare=_k18_compare(_libm(prog)), extra=extra)
    row.update(form=got.form, live_rows=n_live, keys=len(prog.sort_keys),
               bits=None if layout is None else layout.dead_shift + 1)
    if layout is not None:
        # the pack reads sel and writes one word a row, and reads each
        # key's word (8 B) and validity (1 B) where the row is live (a dead
        # row is its dead bit alone): in the 32-byte sectors holding one
        row["pack_bound_ms"] = _bound_ms(n * 9 + sum(
            _sectors(out.sel, 8) + (0 if v is None else _sectors(out.sel, 1))
            for _, v, _ in words))
    print(f"    the sort: passes {row['passes_ms']:.3f} ms, packed "
          f"{row['packed_ms']:.3f} ms ({got.form})"
          + ("" if layout is None else
             f"; the pack {row['pack_ms']:.3f} ms, bound "
             f"{row['pack_bound_ms']:.3f} ms, plain "
             f"{row['pack_plain_ms']:.3f} ms"), flush=True)
    return _compiled_row(row, prog, ("chain_sort", label, False))


def check_sort_query(spark, name: str, sql: str) -> list:
    """Phase 15 for one query: its largest K18 stage (or, where its
    largest sorted grouping reads columns through K3, that grouping's keys
    as a K18 program of their own), at the query's shape."""
    from sail_tpu_torch.exec import local as xl
    from sail_tpu_torch.ops import chain as chn

    with captured_sorts() as got:
        spark.sql(sql).toArrow()
    torch.cuda.synchronize()
    if got["k18"]:
        ex, chain, bottom, node, top, st = max(
            got["k18"], key=lambda x: x[2].device.sel.shape[0])
        grouping = not hasattr(top, "keys")
        return [_sort_row(f"{name} K18 {type(top).__name__}", ex, chain,
                          bottom, node, top, st.prog, st.nulls_first,
                          grouping)]
    ex, p, cols, sel = max(got["k3"], key=lambda x: x[3].shape[0])
    # the grouping's columns as a batch, and the K18 program a chain over
    # it would bind: its keys' words and the columns the aggregate reads
    batch = xl.HostBatch(xl.DeviceBatch(
        {xl._col_name(i): xl.Column(d, v, f.dtype)
         for i, ((d, v), f) in enumerate(zip(cols, p.input.schema))}, sel),
        {})
    frags = [chn.col(i, d.dtype, v is not None)
             for i, (d, v) in enumerate(cols)]
    keys = [frags[g] for g in p.group_indices]
    needed = set(p.group_indices) | {a.arg for a in p.aggs
                                     if a.arg is not None}
    prog = chn.build_program(
        [], [f if i in needed else None for i, f in enumerate(frags)],
        sel.device, sort_keys=[chn.SortKey(f, canonical=True) for f in keys])
    ex._compiled(prog)
    return [_sort_row(f"{name} grouping of columns as K18", ex, [], batch,
                      p.input, p, prog, (True,) * len(keys), True)]


def check_sort_kernels(tables: dict) -> list:
    """Phase 15: K18 and the packed sort over the SF tables
    (SORT_QUERIES)."""
    from sail_tpu_torch import SparkSession
    from sail_tpu_torch.benchmarks.expr_queries import QUERIES as EXPR
    from sail_tpu_torch.benchmarks.tpch_queries import QUERIES as TPCH

    spark = SparkSession({"spark.sail.device": "cuda"})
    _register(spark, tables)
    print("phase 15: K18 and the packed sort against their plain versions",
          flush=True)
    rows = []
    for name in SORT_QUERIES:
        sql = EXPR[name] if name.startswith("e") else TPCH[int(name[1:])]
        spark.sql(sql).toArrow()  # the uploads and the programs' build
        rows += check_sort_query(spark, name, sql)
    spark.stop()
    torch.cuda.empty_cache()
    return rows


def _print_sorts(label: str, sorts: list) -> list:
    """Print a query's sorts and sorted groupings: each one's consumer,
    the route of its words (K18, K3), its form (packed, passes) and its
    keys."""
    if sorts:
        print(f"  {label} sorts: " + ", ".join(
            f"{r['consumer']} {r['route']} {r['form']} ({r['keys']} keys)"
            for r in sorts), flush=True)
    return [[r["consumer"], r["route"], r["form"], r["keys"]]
            for r in sorts]


def _print_routes(label: str, routes: list, strict: bool) -> list:
    """Print a query's chain routes; with ``strict``, fail where a chain
    that computes an expression kept its closures."""
    computing = [r for r in routes if r["route"] != "refs"]
    print(f"  {label} chains: " + ", ".join(
        f"{r['route']}->{r['consumer']}" + (f" [{r['first_unfused']}]"
                                            if r["first_unfused"] else "")
        for r in computing), flush=True)
    if strict and any(r["route"] == "per-op" for r in computing):
        raise AssertionError(f"{label}: a chain kept its closures: "
                             f"{computing}")
    return [[r["route"], r["consumer"], r["first_unfused"]]
            for r in computing]


# ---------------------------------------------------------------------------
# phase 16: the host aggregates
# ---------------------------------------------------------------------------

# float64 answers and sums against the oracle and the plain versions: the
# card's atomics add in another order than Python's and index_add_'s
# (relative to max(|want|, 1))
HOST_FLOAT_RTOL = 1e-9
# the oracle's forked workers: its per-group Python takes about 76 s of
# one core at SF1, over phase 16's budget of 120 s
ORACLE_PROCESSES = max(1, len(os.sched_getaffinity(0)))
HOST_REPLACES = {
    "seg_moments": "sail_tpu/functions/host_aggregates.py:52",
    "seg_pick": "sail_tpu/functions/host_aggregates.py:217",
    "seg_reduce:": "sail_tpu/functions/host_aggregates.py:342",
}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """float64 within HOST_FLOAT_RTOL of max(|want|, 1), NaN-aware;
    integers exactly. Returns the largest relative difference."""
    if not got.dtype.is_floating_point:
        return _max_abs_err(got, want)
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError("NaN positions differ")
    diff = ((got - want).abs() / want.abs().clamp_min(1.0))[~nan]
    err = float(diff.max()) if diff.numel() else 0.0
    if err > HOST_FLOAT_RTOL:
        raise AssertionError(f"beyond relative {HOST_FLOAT_RTOL}: {err}")
    return err


def _host_contexts(tables: dict, dev):
    """The groupings H1 and H2 make at this scale, as the executor makes
    them: lineitem binned by (l_returnflag, l_linestatus) through K2,
    keyless, and sorted by l_suppkey (K3, the pack pass, one sort); and
    lineitem's columns the aggregates read."""
    from sail_tpu_torch.columnar import arrow_interop as ai
    from sail_tpu_torch.columnar.batch import Column
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.spec import data_type as dt

    li = tables["lineitem"]
    hb = ai.from_arrow(li.select(["l_returnflag", "l_linestatus"]), dev)
    flags = [hb.device.columns[c] for c in ("l_returnflag", "l_linestatus")]
    domains = [len(hb.dicts[c]) for c in ("l_returnflag", "l_linestatus")]
    n = li.num_rows
    sel = torch.ones(n, dtype=torch.bool, device=dev)
    direct, _ = agg.group_rows_direct(flags, domains, sel)
    keyless, _ = agg.group_rows([], sel, 1)
    supp = Column(_device_column(li, "l_suppkey", dev), None, dt.LongType())
    by_supp, _ = agg.group_rows([supp], sel, n)
    cols = {c: _device_column(li, c, dev) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_orderkey",
        "l_partkey")}
    return {"H1's bins": direct, "H1 keyless": keyless,
            "H2's l_suppkey": by_supp}, cols, sel


def check_host_agg_kernels(tables: dict, dev) -> list:
    """Phase 16's kernels at H1's and H2's shapes (``tables``: TPC-H at
    ``--sf``): K19 (seg_moments: both passes, qty and price as the
    statistics read them, decimals unscaled at scale 2) at H1's bins and
    keyless, K20 (seg_pick: max_by's key, l_extendedprice's K3 word, every
    row valid) at H2's 100,000 suppliers, K1's bit kinds (and, or, xor of
    l_orderkey) at H1's bins (the binned entry point) and H2's grouping
    (the runs entry point). Each against its plain version (K19 within
    HOST_FLOAT_RTOL, K20 and the bit kinds exactly), then timed beside
    it, its bound (bytes once at HBM_BYTES_PER_S) and a PyTorch call
    computing as much: K19's ``index_add_`` of the rows' products
    (precomputed), K20's two ``scatter_reduce_`` (amax, then amin of the
    row index where the key is the best); none for the bit kinds."""
    from sail_tpu_torch.ops import aggregate as agg
    from sail_tpu_torch.ops.sort import order_keys

    print("phase 16: K19, K20 and K1's bit kinds against their plain "
          "versions", flush=True)
    ctxs, cols, sel = _host_contexts(tables, dev)
    n = sel.shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    qty = agg.Operand(cols["l_quantity"], ok, 2)
    price = agg.Operand(cols["l_extendedprice"], None, 2)
    rows = {"seg_moments": [], "seg_pick": [],
            **{f"seg_reduce:{k}": [] for k in ("and", "or", "xor")}}
    for label in ("H1's bins", "H1 keyless"):
        ctx = ctxs[label]
        ids, perm = agg.positions(ctx)
        slots = agg.output_slots(ctx)
        g = ids.to(torch.int64).clamp_max(slots)
        x = qty.data.to(torch.float64) / 100
        y = price.data.to(torch.float64) / 100
        products = torch.stack([torch.ones_like(x), x, y], 1)
        rows["seg_moments"].append(_timed(
            f"K19 pass 1 (count, sums, extremes), qty and price, {label}, "
            f"{slots} groups", n,
            lambda: agg.seg_moments(ids, perm, slots, qty, price),
            lambda: agg.seg_moments_plain(ids, perm, slots, qty, price),
            n * (4 + 8 + 8 + 1) + slots * 7 * 8,
            lambda: torch.zeros(slots + 1, 3, dtype=torch.float64,
                                device=dev).index_add_(0, g, products),
            compare=_rel_err))
        cnt, sums, _ = agg.seg_moments_plain(ids, perm, slots, qty, price)
        means = sums / cnt.clamp_min(1)[:, None].to(torch.float64)
        dx, dy = x - means[g.clamp_max(slots - 1), 0], \
            y - means[g.clamp_max(slots - 1), 1]
        centred = torch.stack([dx * dx, dy * dy, dx * dy], 1)
        rows["seg_moments"].append(_timed(
            f"K19 pass 2 (three centred sums), {label}", n,
            lambda: agg.seg_centred(ids, perm, slots, qty, price, means, 7),
            lambda: agg.seg_centred_plain(ids, perm, slots, qty, price,
                                          means, 7),
            n * (4 + 8 + 8 + 1) + slots * (2 + 5) * 8,
            lambda: torch.zeros(slots + 1, 3, dtype=torch.float64,
                                device=dev).index_add_(0, g, centred),
            compare=_rel_err))
        del x, y, products, dx, dy, centred, g
    for label in ("H1's bins", "H2's l_suppkey"):
        ctx = ctxs[label]
        binned = ctx.perm is None
        for kind in ("and", "or", "xor"):
            value = agg.Column(cols["l_orderkey"], ok, None)
            if binned:
                plain = lambda: agg.seg_reduce_plain(  # noqa: E731
                    value.data, ctx.seg_ids, ctx.max_groups, kind, ok)
                nbytes = n * (4 + 8 + 1) + ctx.max_groups * 8
            else:
                plain = lambda: agg.seg_reduce_runs_plain(  # noqa: E731
                    ctx.sorted_ids, ctx.perm, ctx.n_live, ctx.max_groups,
                    kind, value.data, ok)[0]
                nbytes = n * (4 + 8 + 8 + 1) + \
                    agg.output_slots(ctx) * (8 + 8)
            rows[f"seg_reduce:{kind}"].append(_timed(
                f"K1 {kind} of l_orderkey, {label}", n,
                lambda: agg.agg_bit(ctx, value, kind).data, plain, nbytes))
    ctx = ctxs["H2's l_suppkey"]
    ids, perm = agg.positions(ctx)
    slots = agg.output_slots(ctx)
    keys = order_keys(cols["l_extendedprice"])
    g = ids.to(torch.int64)
    live = g < slots
    gl, rl = g[live], perm[live]

    def library():
        best = torch.full((slots,), -(1 << 63), dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, gl, keys[rl], "amax")
        at = keys[rl] == best[gl]
        index = torch.full((slots,), (1 << 63) - 1, dtype=torch.int64,
                           device=dev)
        return index.scatter_reduce_(0, gl[at], rl[at], "amin")
    rows["seg_pick"].append(_timed(
        f"K20 max_by's pick, H2's l_suppkey, {slots} groups", n,
        lambda: agg.seg_pick(ids, perm, slots, keys, ok, True),
        lambda: agg.seg_pick_plain(ids, perm, slots, keys, ok, True),
        n * (4 + 8 + 1 + 8) + 2 * slots * 8, library))
    del ctxs, cols, keys, g, live, gl, rl
    torch.cuda.empty_cache()
    entries = []
    for name, shapes in rows.items():
        main = shapes[0]
        src = "seg_reduce.cu" if name.startswith("seg_reduce:") \
            else name + ".cu"
        entries.append(dict(
            name=name, source=f"sail_tpu_torch/csrc/{src}",
            replaces=HOST_REPLACES["seg_reduce:" if name.startswith(
                "seg_reduce:") else name],
            max_abs_err=max(s["max_abs_err"] for s in shapes),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], library_ms=main["library_ms"],
            shapes=shapes))
    return entries


def check_host_oracle(card, tables: dict, sf: float) -> dict:
    """Phase 16's answers: H1-H3 (and H1 keyless) over ``tables`` (TPC-H
    at ``sf``, registered in the card's session ``card``), each group held
    to ``host_agg_queries.oracle`` (the copied module's per-group functions
    over pandas groups of the same tables), floats within HOST_FLOAT_RTOL
    of max(|want|, 1)."""
    from sail_tpu_torch.benchmarks import host_agg_queries as hq

    report = {}
    for name, sql in hq.QUERIES.items():
        t = time.perf_counter()
        got = card.sql(sql).toArrow()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        want = hq.oracle(tables, name, ORACLE_PROCESSES)
        oracle_s = time.perf_counter() - t
        groups = hq.check(got, want, name, HOST_FLOAT_RTOL)
        report[name] = dict(groups=groups, card_first_s=card_s,
                            oracle_s=oracle_s)
        print(f"{name.upper()} SF{sf}: {groups} groups equal the oracle's "
              f"(card {card_s:.2f} s, oracle {oracle_s:.2f} s)", flush=True)
    return report


def run_host_path(tables: dict, sf: float, runs: int) -> dict:
    """Phase 16's main path: H1-H3 and H1 keyless at ``sf``, one warm-up
    and ``runs`` timed runs each (host clock), then ``cuda_ms`` over
    ``runs`` more, and one profiled run (device busy share); every query
    launches what ``host_agg_queries.KERNELS`` names."""
    from sail_tpu_torch.benchmarks import host_agg_queries as hq

    def check(name, result, spark):
        sql = hq.QUERIES[name]
        return {"cuda_ms": cuda_ms(lambda: spark.sql(sql).toArrow(), runs)}

    return run_query_path(tables, sf, runs, True, hq.QUERIES, hq.KERNELS,
                          check)


# ---------------------------------------------------------------------------
# phases 6 and 7: ClickBench
# ---------------------------------------------------------------------------

_K17 = ("chain_reduce",)
_DIRECT = ("direct_group_ids", "seg_reduce")
_SORTED = ("order_keys", "seg_reduce_runs")
_ORDER = ("order_keys",)
_K16 = ("chain",)
_K18 = ("chain_sort",)
_SORTED18 = _K18 + ("seg_reduce_runs",)
# the kernels each ClickBench query's plan launches, from the plan: a
# keyless aggregate, or a grouping over small dictionary domains
# (SearchPhrase, MobilePhoneModel), of COUNT, SUM, MIN and MAX of numbers
# absorbs its chain into K17; a sorted grouping or an ORDER BY over a
# chain that computes (a filter counts) takes its chain and keys into
# K18, and any other chain that computes runs K16; a direct grouping with
# string MIN/MAX or DISTINCT (Q22, Q23, Q29) launches K2 and the binned K1
# after K16; a grouping of plain columns sorts them through K3; every
# sorted grouping reduces through K1's runs entry point; a lone
# COUNT(DISTINCT x) groups by x first (K17), then counts (K1 binned, Q6);
# an ORDER BY of plain columns launches K3 over the rows it sorts (none in
# Q22, whose groups are empty at any size: no generated URL holds
# "google"; none in Q41-Q43, whose groupings keep no row at
# 99,997,497). Q20 filters and projects only.
CB_PLANS = {1: _K17, 2: _K17, 3: _K17 + _K16, 4: _K17 + _K16,
            5: _SORTED + _K17, 6: _K17 + ("seg_reduce",), 7: _K17,
            9: _SORTED, 10: _SORTED + _K18, 12: _SORTED18 + _SORTED,
            11: _SORTED18 + _K17 + _ORDER, 13: _K17 + _ORDER,
            14: _SORTED18 + _K17 + _ORDER, 16: _SORTED, 17: _SORTED,
            18: _SORTED, 20: _K16, 21: _K17, 22: _K16 + _DIRECT,
            23: _K16 + _DIRECT + _ORDER, 24: _K18, 25: _K18, 26: _K18,
            27: _K18, 28: _SORTED18, 29: _K16 + _DIRECT + _K18, 30: _K17,
            31: _SORTED18, 32: _SORTED18, 33: _SORTED + _K18, 34: _SORTED,
            41: _SORTED18, 42: _SORTED18, 43: _SORTED18}
# the queries that pack some sort's keys into one word at --cb-rows
# (ops/sort.py): every one that sorts. The groupings whose keys take more
# than 63 bits sort by the passes: Q9's (RegionID, UserID: its DISTINCT),
# Q19's (UserID, the minute, SearchPhrase), Q32's and Q33's (WatchID,
# ClientIP) and Q36's (ClientIP and three offsets of it); UserID and
# WatchID are random 64-bit identifiers
CB_PACKED = (5, *range(8, 20), *range(24, 30), *range(31, 44))
for _q in range(1, 44):
    PATH_KERNELS[f"cb{_q}"] = CB_PLANS.get(_q, _SORTED18 + _ORDER) + \
        (("window_pack",) if _q in CB_PACKED else ())


def _cb_queries(mechanisms: bool) -> dict:
    from sail_tpu_torch.benchmarks import clickbench as cb

    queries = {f"cb{q}": sql for q, sql in enumerate(cb.load_queries(), 1)}
    if mechanisms:
        queries.update(cb.MECHANISM_QUERIES)
    return queries


def _hits_session(hits: pa.Table, device: str):
    from sail_tpu_torch import SparkSession

    spark = SparkSession({"spark.sail.device": device})
    spark.createDataFrame(hits).createOrReplaceTempView("hits")
    return spark


def check_clickbench(n: int, seed: int) -> dict:
    """The 43 queries and the mechanism queries over generate_hits(n,
    seed) on the card against the port's CPU session (the plain versions,
    which the tier-1 tests hold to the reference), compared by
    clickbench.check_answer: where a LIMIT cuts through a tie, each row
    must belong to the tie in the CPU's whole answer (the query without
    its LIMIT)."""
    from sail_tpu_torch.benchmarks import clickbench as cb

    hits = cb.generate_hits(n, seed, dictionary=True)
    card, cpu = _hits_session(hits, "cuda"), _hits_session(hits, "cpu")
    report = {}
    for name, sql in _cb_queries(mechanisms=True).items():
        t = time.perf_counter()
        got = card.sql(sql).toArrow()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        try:
            cb.check_answer(got, cpu, sql)
        except AssertionError as e:
            raise AssertionError(f"ClickBench {name} at {n} rows: the card's "
                                 f"answer differs from the CPU's: {e}") from e
        report[name] = dict(rows=got.num_rows, first_s=card_s)
        print(f"ClickBench {name} at {n} rows: {got.num_rows} rows agree "
              f"with the CPU session's (first run on the card "
              f"{card_s:.2f} s)", flush=True)
    card.stop()
    cpu.stop()
    return report


def check_cb_oracle(q: int, result: pa.Table, hits: pa.Table) -> None:
    """Q1's count, Q5's distinct users (np.unique) and Q10's rows (counts
    and sums by np.bincount, the distinct users of its regions by a numpy
    lexsort of (RegionID, UserID)) against the card's answers."""
    if q == 1:
        got, want = result.column(0)[0].as_py(), hits.num_rows
    elif q == 5:
        got = result.column(0)[0].as_py()
        want = int(np.unique(hits.column("UserID").to_numpy()).size)
    else:
        rid = hits.column("RegionID").to_numpy()
        counts = np.bincount(rid)
        regions = result.column(0).to_numpy()
        rows = (np.isin(rid, regions))
        r, u = rid[rows], hits.column("UserID").to_numpy()[rows]
        order = np.lexsort((u, r))
        r, u = r[order], u[order]
        new = np.ones(r.size, dtype=bool)
        new[1:] = (r[1:] != r[:-1]) | (u[1:] != u[:-1])
        users = np.bincount(r[new], minlength=counts.size)
        adv = np.bincount(rid, weights=hits.column("AdvEngineID").to_numpy())
        width = np.bincount(
            rid, weights=hits.column("ResolutionWidth").to_numpy())
        got = [list(map(float, row)) for row in zip(
            *(result.column(i).to_numpy() for i in range(5)))]
        want = [[float(x), adv[x], counts[x], width[x] / counts[x],
                 users[x]] for x in regions]
        top = sorted(counts)[::-1][:10]
        if [row[2] for row in got] != top or not all(
                abs(g - w) <= FLOAT_RTOL * abs(w)
                for gr, wr in zip(got, want) for g, w in zip(gr, wr)):
            raise AssertionError(f"ClickBench Q10: {got} != numpy {want}")
        print(f"ClickBench Q10: its rows match numpy (counts {top})",
              flush=True)
        return
    if got != want:
        raise AssertionError(f"ClickBench Q{q}: {got} != numpy {want}")
    print(f"ClickBench Q{q}: {got} matches numpy", flush=True)


def run_clickbench(n: int, seed: int, runs: int, profile: bool) -> dict:
    """All 43 queries over generate_hits(n, seed), its string columns
    dictionary-encoded once, as a Parquet reader with dictionary pages
    gives them: a fresh session for each query (so its scan cache, keyed
    by projection, holds one query's columns at a time), one warm-up and
    ``runs`` timed runs, the launches counted in the first timed run."""
    from sail_tpu_torch.benchmarks import clickbench as cb

    t = time.perf_counter()
    hits = cb.generate_hits(n, seed, dictionary=True)
    report = {"generate_s": time.perf_counter() - t, "rows": n,
              "dictionary_entries": {
                  name: len(col.chunk(0).dictionary)
                  for name, col in zip(hits.column_names, hits.columns)
                  if pa.types.is_dictionary(col.type)},
              "launches_on_path": {}}
    print(f"generated hits: {n} rows, {hits.nbytes / 2**30:.2f} GiB of "
          f"Arrow, in {report['generate_s']:.1f} s; dictionary entries "
          f"{report['dictionary_entries']}", flush=True)
    counters = _counters()

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    with timed_uploads() as upload:
        for name, sql in _cb_queries(mechanisms=False).items():
            q = int(name[2:])
            spark = _hits_session(hits, "cuda")
            torch.cuda.reset_peak_memory_stats()
            upload_before = upload["s"]
            zero_counts()
            t = time.perf_counter()
            result = spark.sql(sql).toArrow()
            torch.cuda.synchronize()
            first = time.perf_counter() - t
            built = spark.dict_tables.builds
            times = []
            for i in range(runs):
                if i == 0:
                    zero_counts()
                t = time.perf_counter()
                result = spark.sql(sql).toArrow()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                if i == 0:
                    launches = {k: fn.launches for k, fn in counters.items()}
                    routes = spark.last_chain_routes
                    sorts = spark.last_sort_routes
            if spark.dict_tables.builds != built:
                raise AssertionError(f"ClickBench Q{q}: a steady run built "
                                     f"{spark.dict_tables.builds - built} "
                                     f"dictionary tables")
            entry = dict(first_s=first, upload_s=upload["s"] - upload_before,
                         query_s=times, rows=result.num_rows,
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         dict_tables=built,
                         chain_routes=_print_routes(f"ClickBench Q{q}",
                                                    routes, q == 30),
                         sort_routes=_print_sorts(f"ClickBench Q{q}", sorts))
            report["launches_on_path"][name] = launches
            if profile:
                entry["profile"] = profile_query(spark, sql)
            report[name] = entry
            ms = sorted(x * 1e3 for x in times)
            print(f"ClickBench Q{q} at {n} rows: first run {first:.3f} s "
                  f"(upload {entry['upload_s']:.3f} s, {built} dictionary "
                  f"tables built), then {', '.join(f'{x:.1f}' for x in ms)} "
                  f"ms; {result.num_rows} rows; peak "
                  f"{entry['peak_bytes'] / 2**30:.2f} GiB; launches in one "
                  f"run { {k: v for k, v in launches.items() if v} }",
                  flush=True)
            if q in (1, 5, 10):
                check_cb_oracle(q, result, hits)
            if q == 30:  # phase 14 at Q30's 90 sums
                report["chain_rows"] = check_chain_query(
                    spark, "cb30", sql, k16_too=False)["chain_reduce"]
            if q in CB_SORT_SHAPES:  # phase 15 at Q25's sort, Q40's grouping
                report.setdefault("sort_rows", []).extend(
                    check_sort_query(spark, f"cb{q}", sql))
            for kernel in PATH_KERNELS[name]:
                if launches[kernel] == 0:
                    raise AssertionError(f"{kernel} never launched on "
                                         f"ClickBench Q{q}'s path")
            spark.stop()
            del spark, result
            torch.cuda.empty_cache()
        report["upload_bytes"] = upload["bytes"]
    return report


def main() -> int:
    from sail_tpu_torch.benchmarks.clickbench import PUBLISHED_ROWS

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
    ap.add_argument("--cb-rows", type=int, default=PUBLISHED_ROWS,
                    help="hits rows of the ClickBench main path (default "
                         f"{PUBLISHED_ROWS:,}, the published dataset's)")
    ap.add_argument("--cb-check-rows", type=int, default=1_000_000,
                    help="hits rows of the ClickBench check against the CPU "
                         "(default 1,000,000)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated hits tables (default 0)")
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
    from sail_tpu_torch.benchmarks.expr_queries import QUERIES as EXPR_SQL
    from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
    from sail_tpu_torch.benchmarks.window_queries import QUERIES as WINDOW_SQL

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
    report = run_main_path(tables, args.sf, args.runs, args.profile)
    phases["main_path"] = time.perf_counter() - t

    t = time.perf_counter()
    win_entries, win_functions = check_window_kernels(tables, dev)
    entries += win_entries
    phases["window_kernels"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    t = time.perf_counter()
    win_checks = check_with_cpu(small_tables, args.check_sf, WINDOW_SQL)
    phases["window_correctness"] = time.perf_counter() - t

    t = time.perf_counter()
    win_report = run_window_path(tables, args.sf, args.runs, args.profile)
    phases["window_main_path"] = time.perf_counter() - t

    t = time.perf_counter()
    entries += check_expr_kernels(tables, dev)
    phases["expr_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    expr_checks = check_with_cpu(small_tables, args.check_sf, EXPR_SQL)
    phases["expr_correctness"] = time.perf_counter() - t

    t = time.perf_counter()
    expr_report = run_expr_path(tables, args.sf, args.runs, args.profile)
    phases["expr_main_path"] = time.perf_counter() - t

    t = time.perf_counter()
    chain_rows = check_chain_kernels(tables)
    phases["chain_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    sort_rows = check_sort_kernels(tables)
    phases["sort_kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    entries += check_host_agg_kernels(tables, dev)
    host_checks = check_host_oracle(small, small_tables, args.check_sf)
    host_report = run_host_path(tables, args.sf, args.runs)
    phases["host_aggregates"] = time.perf_counter() - t
    small.stop()
    del tables, small_tables, small
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    cb_checks = check_clickbench(args.cb_check_rows, args.seed)
    phases["clickbench_correctness"] = time.perf_counter() - t

    t = time.perf_counter()
    cb_report = run_clickbench(args.cb_rows, args.seed, args.runs,
                               args.profile)
    phases["clickbench_main_path"] = time.perf_counter() - t
    chain_rows["chain_reduce"] += cb_report.pop("chain_rows")
    entries += [_chain_entry(k, chain_rows[k])
                for k in ("chain", "chain_reduce")]
    sort_rows += cb_report.pop("sort_rows")
    entries.append(dict(
        name="chain_sort", source=CHAIN_SOURCE, replaces=SORT_REPLACES,
        max_abs_err=max(r["max_abs_err"] for r in sort_rows),
        **{k: sort_rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")}, shapes=sort_rows))
    print(f"phase wall times (s): {phases}", flush=True)
    compiled = dict(programs=csrc.jit_kernel.compiles,
                    seconds=csrc.jit_kernel.compile_s,
                    spilling=csrc.jit_kernel.spilling)
    on_path = {**report["launches_on_path"], **win_report["launches_on_path"],
               **expr_report["launches_on_path"],
               **host_report["launches_on_path"],
               **cb_report["launches_on_path"]}
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
        if k["launches"] == 0 and not any(
                k["name"] == o or o.endswith(":") and k["name"].startswith(o)
                for o in OFF_PATH):
            raise AssertionError(f"{k['name']} launched on no query's path")
    full = {"main_path": report, "checks": checks, "sf": args.sf,
            "check_sf": args.check_sf, "window": win_report,
            "window_checks": win_checks, "window_functions": win_functions,
            "expr": expr_report, "expr_checks": expr_checks,
            "host": host_report, "host_checks": host_checks,
            "clickbench": cb_report,
            "clickbench_checks": cb_checks, "cb_rows": args.cb_rows,
            "cb_check_rows": args.cb_check_rows, "seed": args.seed,
            "phases_s": phases, "kernel_rows": args.kernel_rows,
            "kernels": kernels, "smi": smi, "chain_compiles": compiled}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(full, indent=1))
    print(json.dumps({k: full[k] for k in (
        "main_path", "checks", "sf", "check_sf", "window", "window_checks",
        "window_functions", "expr", "expr_checks", "host", "host_checks",
        "clickbench",
        "clickbench_checks", "cb_rows", "cb_check_rows", "seed",
        "phases_s", "chain_compiles")}))
    print(f"chain kernels compiled with NVRTC in this run: "
          f"{compiled['programs']} programs in {compiled['seconds']:.1f} s, "
          f"{compiled['spilling']} of them spilling registers", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
