"""Key packing and hashing over tensors.

The PyTorch counterpart of ``sail_tpu/ops/hash.py``. When a set of key
columns fits losslessly in 64 bits the columns are *packed*; otherwise
they are hashed (splitmix64 finaliser per column, folded with a seed).

The reference computes in uint64. Torch has no uint64 arithmetic, so
keys are int64 tensors holding the same 64-bit patterns: multiply and XOR
wrap identically, a logical right shift masks off the sign extension,
and an unsigned ``%`` splits the value into 32-bit halves.

``join_keys`` (kernel K4 on the card) returns the key of each row XOR
``1 << 63``, the convention of ``ops/sort.order_keys``: signed order of
the result is the reference's unsigned order of the key, so the join can
sort and binary-search it as int64.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import csrc
from ..columnar.batch import Column, physical_torch_dtype
from ..spec import data_type as dt
from .sort import _MIN64, _normalize_float

# Bit width of each physical dtype when used as a join/group key.
_KEY_BITS = {
    "bool": 1,
    "int8": 8,
    "int16": 16,
    "int32": 32,
    "int64": 64,
    "float32": 32,
    "float64": 64,
}

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """The int64 with the bit pattern of the uint64 ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def key_bits(d: dt.DataType) -> int:
    return _KEY_BITS[d.physical_dtype]


def can_pack(types: Sequence[dt.DataType], reserve_bits: int = 1) -> bool:
    """True if the key columns (plus ``reserve_bits`` for null/sel flags)
    fit losslessly in a single int64 sort key."""
    try:
        total = sum(key_bits(t) for t in types)
    except KeyError:
        return False
    return total + reserve_bits <= 64


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (uint64 ``>>``)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """uint64 ``x % m`` of int64 bit patterns, for 0 < m < 2**31."""
    hi = shr(x, 32) % m
    lo = x & 0xFFFFFFFF
    return (hi * ((1 << 32) % m) + lo) % m


def _to_bits(data: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Map a column to key bits preserving equality (int64 patterns)."""
    pd = d.physical_dtype
    if pd == "bool":
        return data.to(torch.int64) & 1
    if pd in ("int8", "int16", "int32", "int64"):
        bits = _KEY_BITS[pd]
        u = data.to(torch.int64)
        return u if bits == 64 else u & ((1 << bits) - 1)
    if pd == "float32":
        f = _normalize_float(data.to(torch.float32))
        return f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if pd == "float64":
        return _normalize_float(data.to(torch.float64)).view(torch.int64)
    raise TypeError(pd)


def pack_keys(columns, types: Sequence[dt.DataType]) -> torch.Tensor:
    """Pack key columns into one 64-bit key (int64 pattern). Null/dead
    rows are NOT encoded here; callers combine with validity separately.
    Requires can_pack(types, reserve_bits=0)."""
    acc = torch.zeros(columns[0].shape[0], dtype=torch.int64,
                      device=columns[0].device)
    for data, d in zip(columns, types):
        bits = key_bits(d)
        # a 64-bit column is the only one: the shift would empty acc
        acc = _to_bits(data, d) if bits == 64 else \
            (acc << bits) | _to_bits(data, d)
    return acc


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finaliser."""
    x = (x ^ shr(x, 30)) * _i64(_MIX1)
    x = (x ^ shr(x, 27)) * _i64(_MIX2)
    return x ^ shr(x, 31)


def hash64(columns, types: Sequence[dt.DataType], seed: int = 0
           ) -> torch.Tensor:
    """64-bit mixing hash over key columns (int64 pattern)."""
    acc = torch.full((columns[0].shape[0],), _i64(_GOLDEN ^ seed),
                     dtype=torch.int64, device=columns[0].device)
    for data, d in zip(columns, types):
        acc = (acc ^ _mix(_to_bits(data, d))) * _i64(_GOLDEN)
        acc = acc ^ shr(acc, 29)
    return acc


def hash_partition_ids(columns, types: Sequence[dt.DataType],
                       num_partitions: int) -> torch.Tensor:
    """Partition id per row for hash shuffle (int32 in [0, num_partitions))."""
    return umod(hash64(columns, types), num_partitions).to(torch.int32)


# ---------------------------------------------------------------------------
# K4: join keys
# ---------------------------------------------------------------------------

_MAX_KEY_COLS = 4
_DTYPE_CODES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
                torch.int64: 4, torch.float32: 5, torch.float64: 6}


class _KeyCols(ctypes.Structure):
    """Mirror of ``struct KeyCols`` in csrc/join_keys.cuh."""

    _fields_ = [("data", ctypes.c_void_p * _MAX_KEY_COLS),
                ("valid", ctypes.c_void_p * _MAX_KEY_COLS),
                ("dtype", ctypes.c_int * _MAX_KEY_COLS),
                ("ncols", ctypes.c_int)]


def join_keys_plain(cols: Sequence[Column], sel: torch.Tensor, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(keys, usable, exact): the reference's ``_join_keys`` key XOR
    ``1 << 63`` as int64; usable = sel and no NULL key part; exact when
    the columns pack (else hashed with ``seed``)."""
    types = [c.dtype for c in cols]
    usable = sel
    for c in cols:
        if c.validity is not None:
            usable = usable & c.validity
    datas = [c.data for c in cols]
    exact = can_pack(types, reserve_bits=0)
    keys = pack_keys(datas, types) if exact else hash64(datas, types, seed)
    return keys ^ _MIN64, usable, exact


def key_spec(cols: Sequence[Column], sel: torch.Tensor
             ) -> Tuple[_KeyCols, list, bool]:
    """The C description of key columns on the card, for K4 and K7: (spec,
    the buffers it points to, which the caller keeps alive while a kernel
    reads them, with ``sel`` first; exact)."""
    if not 1 <= len(cols) <= _MAX_KEY_COLS:
        raise TypeError(f"join keys: 1..{_MAX_KEY_COLS} key columns, "
                        f"got {len(cols)}")
    n = sel.shape[0]
    if sel.dtype != torch.bool or sel.shape != (n,):
        raise TypeError(f"join keys: sel must be a 1-D bool tensor, got "
                        f"{sel.dtype}{tuple(sel.shape)}")
    spec = _KeyCols(ncols=len(cols))
    held = [sel.contiguous()]
    for i, c in enumerate(cols):
        # the key's declared type fixes its bit width, as in the reference
        data = c.data.to(physical_torch_dtype(c.dtype))
        if data.shape != (n,) or data.device != sel.device or \
                data.dtype not in _DTYPE_CODES:
            raise TypeError(f"join keys: column {i} is {data.dtype}"
                            f"{tuple(data.shape)} on {data.device}, needs "
                            f"({n},) on {sel.device}")
        data = data.contiguous()
        held.append(data)
        spec.data[i] = data.data_ptr()
        spec.dtype[i] = _DTYPE_CODES[data.dtype]
        if c.validity is not None:
            v = c.validity.contiguous()
            if v.dtype != torch.bool or v.shape != (n,) or \
                    v.device != sel.device:
                raise TypeError(f"join keys: validity of column {i} must be "
                                f"bool ({n},) on {sel.device}")
            held.append(v)
            spec.valid[i] = v.data_ptr()
    return spec, held, can_pack([c.dtype for c in cols], reserve_bits=0)


def join_keys(cols: Sequence[Column], sel: torch.Tensor, seed: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """K4: ``join_keys_plain`` as one kernel pass on the card.

    Replaces ``sail_tpu/ops/hash.py`` ``_to_bits``/``pack_keys``/
    ``hash64`` as ``sail_tpu/ops/join.py`` ``_join_keys`` calls them; the
    kernel's source (csrc/join_keys.cu) states its bound. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if sel.device.type == "cpu":
        return join_keys_plain(cols, sel, seed)
    spec, held, exact = key_spec(cols, sel)
    n = sel.shape[0]
    keys = torch.empty(n, dtype=torch.int64, device=sel.device)
    usable = torch.empty(n, dtype=torch.bool, device=sel.device)
    if n:
        with torch.cuda.device(sel.device):
            csrc.check(csrc.entry("join_keys.cu")(
                ctypes.addressof(spec), held[0].data_ptr(), n,
                0 if exact else 1, ctypes.c_ulonglong(seed), keys.data_ptr(),
                usable.data_ptr(), csrc.grid_for(n, sel.device),
                csrc.stream_ptr(sel.device)), "join_keys")
        join_keys.launches += 1
    return keys, usable, exact


join_keys.launches = 0
