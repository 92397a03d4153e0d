"""Time the window's moves between row order and sorted order on the card.

    python sail_tpu_torch/benchmarks/window_moves.py --rows 59996845,15000000

For each row count, over a random permutation with every row live: the
inverse permutation (``window_inverse``), the gather of an int64 column
into sorted order with and without its validity and of a validity alone
(``window_gather``), and the unpermute back to row order of float64
records, of an int64 column with its validity, and of lag(1, -1) over it
(``window_unpermute``; where the package has its ``Shift``). Each is the
mean of ``--runs`` launches after one warm-up (CUDA events), then once
more under ``torch.profiler``, for the device time of its two passes
(``bin_kernel``, ``place_kernel``).

It uses only the package's public entry points, so it runs as well
against another checkout put first on ``PYTHONPATH``: two trees compare
in one process each, in turns, on one card.
"""

from __future__ import annotations

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

from sail_tpu_torch import csrc
from sail_tpu_torch.ops import window as win


def _ms(fn, runs: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def _passes(fn, runs: int) -> dict:
    """Device ms a call of each pass (bin, place), from the profiler."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        for name in ("bin", "place"):
            if f"{name}_kernel" in event.key:
                out[name] = out.get(name, 0.0) + \
                    event.device_time_total / runs / 1000
    return out


def moves(n: int, runs: int, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    perm = torch.randperm(n, device=dev, generator=gen)
    n_live = torch.tensor(n, device=dev)
    vals = torch.randint(-10**9, 10**9, (n,), device=dev, generator=gen)
    valid = torch.rand(n, device=dev, generator=gen) < 0.7
    inv = win.window_inverse(perm, n_live)
    calls = {
        "inverse": lambda: win.window_inverse(perm, n_live),
        "gather": lambda: win.window_gather(inv, vals, None),
        "gather with validity": lambda: win.window_gather(inv, vals, valid),
        "gather of a validity": lambda: win.window_gather(inv, None, valid),
    }
    if hasattr(win, "Shift"):
        seg = torch.zeros(n, dtype=torch.int32, device=dev)
        ctx = win.WindowContext(perm, n_live, seg, seg, seg, seg, seg)
        recs = win.pack_records(vals.to(torch.float64), ctx.alive)
        shift = win.Shift(1, -1)
        calls.update({
            "unpermute records": lambda: win.window_unpermute(ctx, recs),
            "unpermute two arrays": lambda: win.window_unpermute(ctx, vals,
                                                                 valid),
            "unpermute lag(1, -1)": lambda: win.window_unpermute(
                ctx, vals, valid, shift)})
    return {name: {"ms": _ms(fn, runs), **_passes(fn, runs)}
            for name, fn in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="59996845,15000000",
                    help="row counts, comma-separated")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    csrc.build()
    dev = torch.device("cuda")
    for n in (int(r) for r in args.rows.split(",")):
        for name, row in moves(n, args.runs, dev).items():
            print(f"n={n} {name}: {row['ms']:.3f} ms (bin "
                  f"{row.get('bin', 0.0):.3f}, place "
                  f"{row.get('place', 0.0):.3f})", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
