"""Time TPC-H, window and ClickBench queries through the port and split
one run's host time.

    python -m sail_tpu_torch.benchmarks.tpch_profile --sf 10 \\
        --queries 1-4,6,7,10,11 --runs 30 --profile 11 --report out.json
    python -m sail_tpu_torch.benchmarks.tpch_profile --sf 10 \\
        --queries w1,w2,w3,u1 --runs 10   # the window and union queries
                                          # of window_queries.py, by name
    python -m sail_tpu_torch.benchmarks.tpch_profile \\
        --queries cb12,cb30 --runs 10   # ClickBench queries by number,
                                        # over generate_hits(--cb-rows)

The queries run in the order given in one session over
``generate_tpch_sf(--sf, seed=0)``, each with one warm-up and ``--runs``
timed runs (host clock around ``spark.sql(q).toArrow()``, ending in a
device synchronize). A ClickBench query runs over
``generate_hits(--cb-rows, seed=0, dictionary=True)`` in a session of its
own, as ``chip_smoke.py`` runs them: the scan cache keeps each
projection of the table on the card for the session's life. Each query of ``--profile`` then runs twice more:
once under ``torch.profiler`` (after one untraced profiler step), for the
device's busy time and the host's self time by operator and runtime call,
and once under ``cProfile``, for the host's Python time by function.

It uses only the session's public entry points, so it runs as well
against another checkout of the package put first on ``PYTHONPATH``: two
trees compare in one process each, in turns, on one card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pathlib
import pstats
import statistics
import time

import torch

from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks import clickbench
from sail_tpu_torch.benchmarks.tpch_data import generate_tpch_sf
from sail_tpu_torch.benchmarks.tpch_queries import QUERIES
from sail_tpu_torch.benchmarks.window_queries import QUERIES as WINDOW_QUERIES

TOP = 12  # operators and functions listed in a host split


def parse_queries(text: str) -> list:
    """"1-4,6,w3" → [1, 2, 3, 4, 6, "w3"]: TPC-H queries by number or
    range, window and union queries by name."""
    out = []
    for part in text.split(","):
        if part[:1].isalpha():
            out.append(part)
            continue
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def _is_clickbench(q) -> bool:
    return isinstance(q, str) and q.startswith("cb")


def _sql(q) -> str:
    if _is_clickbench(q):
        return clickbench.load_queries()[int(q[2:]) - 1]
    return QUERIES[q] if isinstance(q, int) else WINDOW_QUERIES[q]


def _label(q) -> str:
    return f"q{q}" if isinstance(q, int) else q


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _run_ms(spark, sql: str) -> float:
    t = time.perf_counter()
    spark.sql(sql).toArrow()
    _sync(spark.device)
    return (time.perf_counter() - t) * 1e3


def torch_split(spark, sql: str) -> dict:
    """One traced run: wall ms, device busy ms, the host's self ms by
    operator and runtime call (the wall less their sum is Python)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = {}
    activities = [ProfilerActivity.CPU]
    if spark.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.update(
                     averages=p.key_averages())) as prof:
        for _ in range(2):
            wall_ms = _run_ms(spark, sql)
            prof.step()
    events = [e for e in kept["averages"]
              if not e.key.startswith("ProfilerStep")]
    on_device = [e for e in events if str(e.device_type).endswith("CUDA")]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in events if e not in on_device
                   and e.self_cpu_time_total > 0), key=lambda x: -x[1])
    host_ms = sum(ms for _, ms, _ in host)
    return {"wall_ms": wall_ms,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in on_device) / 1e3,
            "host_ops_ms": host_ms, "python_ms": wall_ms - host_ms,
            "host_top": [[k[:80], ms, c] for k, ms, c in host[:TOP]]}


def python_split(spark, sql: str) -> dict:
    """One run under cProfile: its total calls and the functions with the
    most own time."""
    prof = cProfile.Profile()
    prof.enable()
    spark.sql(sql).toArrow()
    _sync(spark.device)
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(((f"{f.rsplit('/', 2)[-1]}:{line}({name})", tt, nc)
                   for (f, line, name), (_, nc, tt, _, _)
                   in stats.stats.items()), key=lambda x: -x[1])
    return {"calls": stats.total_calls, "seconds": stats.total_tt,
            "top": [[k[:80], s * 1e3, c] for k, s, c in rows[:TOP]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--queries", default="11",
                    help="queries to time, in order (default 11)")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--profile", default="",
                    help="queries to split the host time of")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cb-rows", type=int, default=clickbench.PUBLISHED_ROWS,
                    help="hits rows of the ClickBench queries")
    ap.add_argument("--report", type=pathlib.Path)
    args = ap.parse_args(argv)

    spark = SparkSession({"spark.sail.device": args.device})
    if spark.device.type == "cuda":
        from sail_tpu_torch import csrc
        csrc.build()
    queries = parse_queries(args.queries)
    if not all(_is_clickbench(q) for q in queries):
        for name, table in generate_tpch_sf(args.sf, seed=0).items():
            spark.createDataFrame(table).createOrReplaceTempView(name)
    hits = clickbench.generate_hits(args.cb_rows, seed=0, dictionary=True) \
        if any(_is_clickbench(q) for q in queries) else None
    profiled = set(parse_queries(args.profile)) if args.profile else set()
    report = {"sf": args.sf, "device": str(spark.device), "queries": {}}
    for q in queries:
        sql = _sql(q)
        session = spark
        if _is_clickbench(q):
            session = SparkSession({"spark.sail.device": args.device})
            session.createDataFrame(hits).createOrReplaceTempView("hits")
        first_ms = _run_ms(session, sql)
        times = sorted(_run_ms(session, sql) for _ in range(args.runs))
        quart = statistics.quantiles(times, n=4) if len(times) > 1 \
            else times * 3
        entry = {"first_ms": first_ms, "ms": times, "median_ms": quart[1],
                 "quartiles_ms": [quart[0], quart[2]]}
        print(f"{_label(q).upper()}: median {quart[1]:.2f} ms "
              f"(quartiles "
              f"{quart[0]:.2f}-{quart[2]:.2f}, min {times[0]:.2f}, max "
              f"{times[-1]:.2f}) of {len(times)}", flush=True)
        if q in profiled:
            entry["torch"] = t = torch_split(session, sql)
            entry["python"] = p = python_split(session, sql)
            print(f"  traced: wall {t['wall_ms']:.2f} ms, device busy "
                  f"{t['device_busy_ms']:.2f}, host operators "
                  f"{t['host_ops_ms']:.2f}, Python {t['python_ms']:.2f}; "
                  + ", ".join(f"{k} {ms:.2f} x{c}"
                              for k, ms, c in t["host_top"]))
            print(f"  cProfile: {p['calls']} calls, {p['seconds'] * 1e3:.2f}"
                  f" ms; " + ", ".join(f"{k} {ms:.2f} x{c}"
                                       for k, ms, c in p["top"]), flush=True)
        report["queries"][_label(q)] = entry
        if session is not spark:
            session.stop()
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    spark.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
