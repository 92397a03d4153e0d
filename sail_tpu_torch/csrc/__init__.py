"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` file here compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``.
The libraries go to ``build/sail_tpu_torch/<digest>/`` at the root of the
checkout, where ``<digest>`` hashes the sources and flags, so a changed
source builds anew and an unchanged one is built once. The first call
that needs a kernel builds all of them, one ``nvcc`` process per source,
all started together. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = ("seg_reduce.cu", "direct_group.cu", "order_keys.cu",
           "join_keys.cu", "join_probe.cu", "join_expand.cu", "bloom.cu",
           "window_bounds.cu", "window_ranks.cu", "window_scan.cu",
           "window_extreme.cu", "window_perm.cu", "expr_math.cu",
           "chain.cu")
_HEADERS = ("common.cuh", "join_keys.cuh", "window.cuh", "expr_math.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags after NVCC_FLAGS: K16/K17 mirror torch's float64
# operations one rounding each, so nvcc may not contract a*b+c into an FMA
_SOURCE_FLAGS = {"chain.cu": ("--fmad=false",)}

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
ULL = ctypes.c_ulonglong
D = ctypes.c_double
# C signature of each library's entry points: {name: argtypes}
_ENTRY = {
    "seg_reduce.cu": {"sail_seg_reduce": [P, P, P, LL, I, I, I, P, P, I, P],
                      "sail_seg_reduce_runs": [P, P, P, P, P, I, I, I, P, P,
                                               P, P, I, P]},
    "direct_group.cu": {"sail_direct_group":
                        [P, P, P, P, I, P, LL, I, P, P, I, P]},
    "order_keys.cu": {"sail_order_keys": [P, I, LL, I, P, I, P]},
    "join_keys.cu": {"sail_join_keys": [P, P, LL, I, ULL, P, P, I, P]},
    "join_probe.cu": {"sail_join_probe": [P, LL, P, P, P, LL, P, LL, P, P,
                                          P]},
    "join_expand.cu": {"sail_join_expand": [P, P, P, LL, LL, P, LL, P, LL,
                                            P, P, P, P]},
    "bloom.cu": {"sail_bloom_build": [P, P, LL, I, ULL, LL, ULL, P, P, P,
                                      P, P],
                 "sail_bloom_apply": [P, P, LL, I, ULL, P, LL, ULL, P, P,
                                      P, P]},
    "window_bounds.cu": {"sail_window_pack": [P, P, P, P, P, P, I, I, P, LL,
                                              P, I, P],
                         "sail_window_bounds": [P, LL, P, P, P, I, P, P, P,
                                                P, P, P, P, P]},
    "window_ranks.cu": {"sail_window_ranks": [P, LL, P, P, P, P, P, LL, P, I,
                                              P, I, P],
                        "sail_window_ranks_unpermute": [P, LL, P, I, P, P]},
    "window_scan.cu": {"sail_window_scan": [P, LL, P, P, P, I, I, I, P, P,
                                            P],
                       "sail_window_frame": [P, LL, P, P, P, P, P, I, I, I,
                                             LL, LL, I, I, P, I, P]},
    "window_extreme.cu": {"sail_window_extreme": [P, LL, P, P, P, P, P, I, I,
                                                  LL, LL, P, P, P]},
    "window_perm.cu": {"sail_window_gather": [P, LL, P, I, P, P, P, I, P,
                                              LL, P],
                       "sail_window_inverse": [P, P, LL, P, I, P, LL, P],
                       "sail_window_unpermute": [P, LL, P, I, P, P, P]},
    "expr_math.cu": {"sail_math_unary": [P, I, I, P, LL, I, P, P, I, P],
                     "sail_round": [P, I, LL, I, I, I, I, D, P, I, P],
                     "sail_math_binary": [P, I, I, I, P, P, I, I, I, P, LL,
                                          I, I, P, P, I, P],
                     "sail_calendar": [P, I, I, P, P, I, I, P, LL, I, P, P,
                                       I, P]},
    "chain.cu": {name: [P, I, P, P, P, P, I, I, P, P, P, P, P, LL, P, I, I,
                        P, P, P, I, P]
                 for name in ("sail_chain", "sail_chain_reduce")},
}


def build_dir() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(_SOURCE_FLAGS.items())).encode())
    for name in SOURCES + _HEADERS:
        digest.update(name.encode())
        digest.update((_HERE / name).read_bytes())
    return _HERE.parents[1] / "build" / "sail_tpu_torch" / \
        digest.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Dict[str, str]:
    """Compile every kernel source that has no library yet; returns
    ``{source: path of its .so}``. Writes each compiler log next to its
    library (``<source>.log``: the ``-Xptxas -v`` register and shared
    memory report)."""
    out_dir = build_dir()
    libs = {src: str(out_dir / (src[:-3] + ".so")) for src in SOURCES}
    todo = [src for src in SOURCES if not os.path.exists(libs[src])]
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *_SOURCE_FLAGS.get(src, ()), "-o", tmp,
               str(_HERE / src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / (src + ".log")).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, libs[src])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def build_logs() -> Dict[str, str]:
    """The compiler log of each source from the last build."""
    out_dir = build_dir()
    return {src: (out_dir / (src + ".log")).read_text()
            if (out_dir / (src + ".log")).exists() else ""
            for src in SOURCES}


@functools.cache
def entry(source: str, name: str = ""):
    """The C entry point ``name`` of ``source``'s library (its only one
    when ``name`` is empty), built on first use."""
    entries = _ENTRY[source]
    if not name:
        (name,) = entries
    argtypes = entries[name]
    fn = getattr(ctypes.CDLL(build()[source]), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def grid_for(n: int, device: torch.device, blocks_per_sm: int = 8,
             block: int = 256) -> int:
    """Blocks for a grid-stride loop over n rows: enough to fill the card,
    no more than the rows need."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // block), sms * blocks_per_sm))


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
