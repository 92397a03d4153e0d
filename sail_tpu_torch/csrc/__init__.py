"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` file here compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into a shared library with a plain C interface, loaded with ``ctypes``.
The libraries go to ``build/sail_tpu_torch/<digest>/`` at the root of the
checkout, where ``<digest>`` hashes the sources and flags, so a changed
source builds anew and an unchanged one is built once. The first call
that needs a kernel builds all of them, one ``nvcc`` process per source,
all started together. Nothing is built when this module is imported.

The chain kernels (K16, K17, K18) are generated, one for each chain program
(``ops/chain_codegen.py``), and compiled when a chain is bound:
``jit_kernel`` hands a generated source to NVRTC through
``chain_jit.cu`` and keeps each cubin under ``<digest>/chain/``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Dict, Tuple

import torch

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = ("seg_reduce.cu", "seg_moments.cu", "seg_pick.cu",
           "direct_group.cu", "order_keys.cu",
           "join_keys.cu", "join_probe.cu", "join_expand.cu", "bloom.cu",
           "window_bounds.cu", "window_ranks.cu", "window_scan.cu",
           "window_extreme.cu", "window_perm.cu", "expr_math.cu",
           "chain_jit.cu")
_HEADERS = ("common.cuh", "join_keys.cuh", "window.cuh", "expr_math.cuh",
            "order_keys.cuh", "chain.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the libraries a source links, after it on nvcc's command line (the
# toolkit's library directory is added, and set as the run path)
_SOURCE_LIBS = {"chain_jit.cu": ("-lnvrtc", "-lcuda")}
# NVRTC's options for the chain kernels: K16-K18 mirror torch's float64
# operations one rounding each, so the compiler may not contract a*b+c
# into an FMA; a generated kernel declares every operand's word and
# validity, some unread (warnings 177, 550); the header directories are
# added
JIT_OPTIONS = ("--gpu-architecture=sm_90a", "--fmad=false", "-std=c++17",
               "--ptxas-options=-v", "--diag-suppress=177,550")

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
    "seg_moments.cu": {"sail_seg_moments": [I, P, P, LL, I, P, P, I, D, P,
                                            P, I, D, I, P, P, P, P, I, P]},
    "seg_pick.cu": {"sail_seg_pick": [P, P, LL, I, P, P, I, P, P, I, P]},
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
    "window_bounds.cu": {"sail_window_pack": [P, P, P, P, P, P, I, I, I, P,
                                              LL, P, I, P],
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
                       "sail_window_unpermute": [P, P, LL, I, P, I, P, P,
                                                 LL, I, ULL, P, P, I, P, LL,
                                                 P]},
    "expr_math.cu": {"sail_math_unary": [P, I, I, P, LL, I, P, P, P],
                     "sail_round": [P, I, LL, I, I, I, I, D, P, I, P],
                     "sail_math_binary": [P, I, I, P, P, I, I, P, I, D, LL,
                                          LL, I, I, P, P, P],
                     "sail_calendar": [P, I, P, P, I, P, I, LL, LL, I, P, P,
                                       P, P, P]},
    "chain_jit.cu": {"sail_jit_compile": [P, P, P, I],
                     "sail_jit_result": [P],
                     "sail_jit_log": [P, P, LL],
                     "sail_jit_cubin": [P, P, LL],
                     "sail_jit_free": [P],
                     "sail_jit_load": [P, P, I, P, P],
                     "sail_jit_unload": [P],
                     "sail_jit_attributes": [P, I, I, P],
                     "sail_jit_launch": [P, P, I, I, I, P]},
}
# entry points that return other than an int error code
_RESTYPE = {"sail_jit_compile": P, "sail_jit_log": LL, "sail_jit_cubin": LL,
            "sail_jit_free": None}


def build_dir() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(repr(sorted(_SOURCE_LIBS.items())).encode())
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


def _toolkit() -> Tuple[pathlib.Path, pathlib.Path]:
    """The CUDA toolkit's (include, library) directories, beside nvcc's
    ``bin/``."""
    root = pathlib.Path(_nvcc()).resolve().parents[1]
    lib = root / "lib64"
    if not lib.is_dir():
        lib = root / "targets" / "x86_64-linux" / "lib"
    return root / "include", lib


def _link_flags(src: str):
    if src not in _SOURCE_LIBS:
        return []
    _, lib = _toolkit()
    stubs = lib / "stubs"  # libcuda's link stub; the driver's at run time
    return [f"-L{lib}", *([f"-L{stubs}"] if stubs.is_dir() else []),
            *_SOURCE_LIBS[src], "-Xlinker", f"-rpath,{lib}"]


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
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_HERE / src),
               *_link_flags(src)]
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
    fn.restype = _RESTYPE.get(name, ctypes.c_int)
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


# ---------------------------------------------------------------------------
# generated kernels, compiled with NVRTC (chain_jit.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class JitKernel:
    """A generated kernel, loaded on one device: its CUfunction, what the
    driver reports of it (registers and local bytes, spills and stack, a
    thread; resident blocks an SM at ``block`` threads and ``smem``
    dynamic shared bytes), the seconds its compile took (0.0: loaded from
    the cubin cache) and NVRTC's log. Its module stays loaded while
    something holds the kernel, and is unloaded after the last reference
    goes."""

    function: int
    block: int
    smem: int
    regs: int
    local_bytes: int
    per_sm: int
    compile_s: float
    log: str
    sha: str


# the kernels loaded, by (source sha, device index), for as long as
# something holds them: a chain program keeps its kernel
# (chain_codegen.kernel), and a session keeps at most exec/local.py's
# _MAX_PROGRAMS bound programs, so the modules loaded are bounded too
_JIT: "weakref.WeakValueDictionary[Tuple[str, int], JitKernel]" = \
    weakref.WeakValueDictionary()
_JIT_LOCK = threading.Lock()
# cubins kept under build_dir()/chain; past this count the least recently
# used go
MAX_CUBINS = 1024
# ptxas's report of a kernel that spills registers
_SPILLS = re.compile(r"\b[1-9][0-9]* bytes spill stores")


def _jit_entry(name: str):
    return entry("chain_jit.cu", name)


@functools.cache
def _preload_nvrtc_builtins() -> None:
    """NVRTC opens ``libnvrtc-builtins`` by name at its first compile; the
    toolkit's library directory may not be on the loader's path, so load
    it from there first (a library already loaded is found by name)."""
    _, lib = _toolkit()
    for path in sorted(lib.glob("libnvrtc-builtins.so.*")):
        ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)


def _compile(source: str, name: str) -> Tuple[bytes, str]:
    """NVRTC's cubin and log of ``source``; raises with the log."""
    _preload_nvrtc_builtins()
    include, _ = _toolkit()
    opts = [*JIT_OPTIONS, f"-I{_HERE}", f"-I{include}"]
    argv = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
    handle = _jit_entry("sail_jit_compile")(source.encode(), name.encode(),
                                            argv, len(opts))
    try:
        size = _jit_entry("sail_jit_log")(handle, None, 0)
        buf = ctypes.create_string_buffer(size)
        _jit_entry("sail_jit_log")(handle, buf, size)
        log = buf.raw[:size].decode(errors="replace")
        if _jit_entry("sail_jit_result")(handle) != 0:
            raise RuntimeError(f"NVRTC failed on {name}:\n{log}")
        size = _jit_entry("sail_jit_cubin")(handle, None, 0)
        buf = ctypes.create_string_buffer(size)
        _jit_entry("sail_jit_cubin")(handle, buf, size)
        return buf.raw[:size], log
    finally:
        _jit_entry("sail_jit_free")(handle)


def _cached(cubin_path: pathlib.Path, log_path: pathlib.Path):
    """(cubin, log) kept on disk, marked as used now; None if absent."""
    try:
        cubin = cubin_path.read_bytes()
        log = log_path.read_text() if log_path.exists() else ""
        os.utime(cubin_path)
    except FileNotFoundError:  # never kept, or pruned by another process
        return None
    return cubin, log


def _prune(out: pathlib.Path) -> None:
    """Remove the least recently used cubins, and their logs, past
    MAX_CUBINS."""
    cubins = []
    for path in out.glob("*.cubin"):
        with contextlib.suppress(FileNotFoundError):
            cubins.append((path.stat().st_mtime, path))
    cubins.sort()
    for _, path in cubins[:max(0, len(cubins) - MAX_CUBINS)]:
        for old in (path, path.with_suffix(".log")):
            with contextlib.suppress(FileNotFoundError):
                old.unlink()


def _unload(module: int, device: int) -> None:
    """Unload a kernel's module once nothing holds the kernel; the C side
    waits for the device's queued work first, which may still run it."""
    with torch.cuda.device(device):
        _jit_entry("sail_jit_unload")(module)


def jit_kernel(source: str, name: str, block: int, smem: int,
               device: torch.device) -> JitKernel:
    """The kernel ``name`` of a generated CUDA ``source`` (which may
    include this directory's headers), compiled by NVRTC for sm_90a with
    ``JIT_OPTIONS`` once and loaded once a device while it is held,
    allowed ``smem`` bytes of dynamic shared memory. Each cubin is kept
    with NVRTC's log (its ``ptxas`` register report) under
    ``build_dir()/chain/<sha of source and options>.cubin`` and ``.log``,
    so a later process loads it without compiling. Raises with NVRTC's log
    on a compile error and with the error code on a load error: there is
    no other route. Counts its compiles (``.compiles``), their seconds
    (``.compile_s``), those whose log reports spill stores
    (``.spilling``) and its module loads (``.loads``)."""
    digest = hashlib.sha256(source.encode())
    digest.update("\0".join(JIT_OPTIONS).encode())
    sha = digest.hexdigest()
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (sha, index)
    with _JIT_LOCK:
        hit = _JIT.get(key)
    if hit is not None:
        return hit
    out = build_dir() / "chain"
    cubin_path, log_path = out / (sha + ".cubin"), out / (sha + ".log")
    seconds = 0.0
    kept = _cached(cubin_path, log_path)
    if kept is not None:
        cubin, log = kept
    else:
        t = time.perf_counter()
        cubin, log = _compile(source, name)
        seconds = time.perf_counter() - t
        out.mkdir(parents=True, exist_ok=True)
        for path, data in ((log_path, log.encode()), (cubin_path, cubin)):
            fd, tmp = tempfile.mkstemp(dir=out)
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic: concurrent builders agree
        _prune(out)
    module, function = P(), P()
    attrs = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        check(_jit_entry("sail_jit_load")(cubin, name.encode(), smem,
                                          ctypes.byref(module),
                                          ctypes.byref(function)),
              f"loading {name} ({sha[:12]})")
        try:
            check(_jit_entry("sail_jit_attributes")(function, block, smem,
                                                    attrs),
                  f"attributes of {name}")
        except RuntimeError:
            _unload(module.value, index)
            raise
    kernel = JitKernel(function.value, block, smem, *attrs, seconds, log,
                       sha)
    finalizer = weakref.finalize(kernel, _unload, module.value, index)
    finalizer.atexit = False  # the process's end frees its context
    with _JIT_LOCK:
        jit_kernel.loads += 1
        if seconds:
            jit_kernel.compiles += 1
            jit_kernel.compile_s += seconds
            jit_kernel.spilling += bool(_SPILLS.search(log))
        won = _JIT.setdefault(key, kernel)
    return won


jit_kernel.compiles = 0
jit_kernel.compile_s = 0.0
jit_kernel.loads = 0
jit_kernel.spilling = 0


def jit_launch(kernel: JitKernel, args, grid: int,
               device: torch.device) -> None:
    """Launch ``kernel`` over ``grid`` blocks on ``device``'s current
    stream; ``args``: its one parameter (a ctypes array of 64-bit
    words)."""
    with torch.cuda.device(device):
        check(_jit_entry("sail_jit_launch")(
            kernel.function, ctypes.byref(args), grid, kernel.block,
            kernel.smem, stream_ptr(device)), f"chain kernel {kernel.sha[:12]}")
