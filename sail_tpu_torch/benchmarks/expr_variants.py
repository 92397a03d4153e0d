"""Time design variants of K14 and K15 against the kernels as built.

    python -m sail_tpu_torch.benchmarks.expr_variants --rows 15000000,59996845

Each variant is ``csrc/expr_math.cu`` with a few lines replaced (each
replaced text must occur in the source once, so a variant that no longer
applies fails), built with the package's nvcc flags beside the package's
own library. Every variant and the source as built run the same calls on
the same columns, in turns (A, B, B, A), each the mean of ``--runs``
launches after one warm-up (CUDA events); their outputs must be equal.

- K15's month starts: read through the read-only data cache (``__ldg``,
  as built) against a copy of them in every block's shared memory, made
  with 16 B loads before the block's rows (add_months by 3, last_day,
  weekofyear and months_between of 1999-01-01, over int32 days of
  1992-1998, TPC-H's dates).
- K14's libm rows, log(base, x) of an unscaled decimal and a double with
  a fresh validity: the 16 B vectors a thread holds in flight and the
  resident blocks an SM of its launch bounds (two at 3, as built; one at
  4; four at 2).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess

import torch

from sail_tpu_torch import csrc
from sail_tpu_torch.functions import numeric as num

_SOURCE = pathlib.Path(csrc.__file__).parent / "expr_math.cu"

# K15: the month starts copied into the block's shared memory
_SHARED_STARTS = [
    ("    return __ldg(starts + j);", "    return starts[j];"),
    ("const MonthTable ms, long long n, long long n_vec,",
     "const MonthTable table, long long n, long long n_vec,"),
    ("  const bool valid = out_valid != nullptr;\n",
     "  const bool valid = out_valid != nullptr;\n"
     "  __shared__ int4 copy[(kMonths + 4) / 4];\n"
     "  for (int i = threadIdx.x; i < (kMonths + 4) / 4; i += kCalThreads)\n"
     "    copy[i] = reinterpret_cast<const int4*>(table.starts)[i];\n"
     "  __syncthreads();\n"
     "  const MonthTable ms{reinterpret_cast<const int*>(copy), table.of};\n"),
]


def _k14_vecs(vecs: int, blocks: int) -> list:
    """K14's libm ops at ``vecs`` vectors in flight, ``blocks`` an SM."""
    return [("  return is_libm2(op) ? 2 : 4;",
             f"  return is_libm2(op) ? {vecs} : 4;"),
            ("  return is_libm2(op) || rows == 4 ? 3 : 4;",
             f"  return is_libm2(op) ? {blocks} : rows == 4 ? 3 : 4;")]


VARIANTS = {
    "k15_shared_starts": ("calendar", _SHARED_STARTS),
    "k14_libm_1_at_4": ("math_binary", _k14_vecs(1, 4)),
    "k14_libm_4_at_2": ("math_binary", _k14_vecs(4, 2)),
}


def build_variants(names) -> dict:
    """{variant: its library}, built in parallel from the replaced
    source."""
    out = csrc.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out / f"{name}.cu"
        src.write_text(variant_source(name))
        lib = out / f"{name}.so"
        cmd = [csrc._nvcc(), *csrc.NVCC_FLAGS, f"-I{_SOURCE.parent}", "-o",
               str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = str(lib)
    return libs


def _entry(lib: str, name: str):
    fn = getattr(ctypes.CDLL(lib), name)
    fn.argtypes = csrc._ENTRY["expr_math.cu"][name]
    return fn


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal outputs, a double bit for bit (NaN too)."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def variant_source(name: str) -> str:
    """expr_math.cu with ``name``'s lines replaced."""
    text = _SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


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


def calendar_calls(n: int, dev) -> dict:
    """{label: (call of sail_calendar in a library, output)}: K15's ops
    over int32 days, a scalar second operand read on the host."""
    gen = torch.Generator(device=dev).manual_seed(3)
    days = torch.randint(8035, 10592, (n,), device=dev, dtype=torch.int32,
                         generator=gen)
    starts, of_day = num.calendar_tables(dev)
    padded = torch.zeros(starts.numel() + 4, dtype=torch.int32, device=dev)
    padded[:starts.numel()] = starts  # the copy's last 16 B load
    stream = csrc.stream_ptr(dev)
    calls = {}
    for op, word in (("add_months", 3), ("last_day", 0), ("weekofyear", 0),
                     ("months_between", 10592)):
        out = torch.empty(n, dtype=torch.float64 if op == "months_between"
                          else torch.int32, device=dev)
        two = op in ("add_months", "months_between")

        def call(entry, op=op, word=word, out=out, two=two):
            csrc.check(entry(days.data_ptr(), 0, None, None, 1 if two else 0,
                             None, int(two), word, n, num._CALENDAR_CODE[op],
                             padded.data_ptr(), of_day.data_ptr(),
                             out.data_ptr(), None, stream), op)
        calls[f"{op} of {n} days"] = (call, out)
    return calls


def binary_calls(n: int, dev) -> dict:
    """{label: (call of sail_math_binary, output)}: log(base, x) of an
    unscaled decimal (scale 2) and a double, x <= 0 planted."""
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.randint(1, 10_000_000, (n,), device=dev, generator=gen)
    x = torch.rand(n, device=dev, dtype=torch.float64, generator=gen) * 1e4
    x[::97] = -1.0
    out = torch.empty(n, dtype=torch.float64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    stream = csrc.stream_ptr(dev)

    def call(entry):
        csrc.check(entry(base.data_ptr(), 1, 2, None, x.data_ptr(), 2, 0,
                         None, 0, 0.0, 0, n, num._BINARY_CODE["log"], 0,
                         out.data_ptr(), ok.data_ptr(), stream), "log")
    return {f"log(b, x) of {n} rows": (call, (out, ok))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="15000000,59996845",
                    help="row counts, comma-separated")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    built = csrc.build()["expr_math.cu"]
    libs = build_variants(VARIANTS)
    kernels = {"calendar": ("sail_calendar", calendar_calls),
               "math_binary": ("sail_math_binary", binary_calls)}
    for n in (int(r) for r in args.rows.split(",")):
        for kernel, (name, make) in kernels.items():
            calls = make(n, dev)
            for variant, (of, _) in VARIANTS.items():
                if of != kernel:
                    continue
                a, b = _entry(built, name), _entry(libs[variant], name)
                for label, (call, out) in calls.items():
                    outs = out if isinstance(out, tuple) else (out,)
                    call(a)
                    want = [t.clone() for t in outs]
                    call(b)
                    same = all(_same(w, t) for w, t in zip(want, outs))
                    times = [_ms(lambda e=e: call(e), args.runs)
                             for e in (a, b, b, a)]
                    print(f"{label}: built {times[0]:.3f}, {times[3]:.3f} ms; "
                          f"{variant} {times[1]:.3f}, {times[2]:.3f} ms; "
                          f"equal {same}", flush=True)
                    if not same:
                        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
