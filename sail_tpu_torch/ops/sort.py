"""Sort / permutation kernels over tensors.

The PyTorch counterpart of ``sail_tpu/ops/sort.py``. Every key column is
mapped to an order-preserving int64 key (``order_keys``, kernel K3 on the
card), so one stable ``torch.sort`` pass per key column, plus stable
passes for null placement and dead rows, gives the reference's total
order.
"""

from __future__ import annotations

import torch

from .. import csrc
from ..columnar.batch import Column, DeviceBatch

_MIN64 = torch.iinfo(torch.int64).min  # the bit pattern 1 << 63
_DTYPE_CODES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
                torch.int64: 4, torch.float32: 5, torch.float64: 6}


def _normalize_float(data: torch.Tensor) -> torch.Tensor:
    """Spark key semantics: -0.0 keys equal 0.0, and all NaNs are one value."""
    data = data + 0.0  # -0.0 + 0.0 == +0.0
    return torch.where(torch.isnan(data), torch.full_like(data, float("nan")),
                       data)


def order_keys_plain(data: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """int64 keys whose signed order is the value order: the reference's
    uint64 order bits XOR (1 << 63). Descending is the bitwise NOT."""
    if data.dtype == torch.bool:
        key = data.to(torch.int64) ^ _MIN64
    elif data.dtype == torch.float32:
        b = _normalize_float(data).view(torch.int32).to(torch.int64) \
            & 0xFFFFFFFF
        neg = (b >> 31) != 0
        key = torch.where(neg, ~b & 0xFFFFFFFF, b | 0x80000000) ^ _MIN64
    elif data.dtype == torch.float64:
        b = _normalize_float(data).view(torch.int64)
        key = torch.where(b < 0, ~b, b | _MIN64) ^ _MIN64
    elif data.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        key = data.to(torch.int64)
    else:
        raise TypeError(data.dtype)
    return key if ascending else ~key


def order_keys(data: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """K3: ``order_keys_plain`` as a kernel on the card.

    Replaces ``sail_tpu/ops/sort.py`` ``order_bits``; the kernel's source
    (csrc/order_keys.cu) states its bound. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if data.device.type == "cpu":
        return order_keys_plain(data, ascending)
    code = _DTYPE_CODES.get(data.dtype)
    if code is None or data.dim() != 1:
        raise TypeError(f"order_keys: unsupported input {data.dtype}, "
                        f"shape {tuple(data.shape)}")
    data = data.contiguous()
    n = data.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=data.device)
    if n == 0:
        return out
    with torch.cuda.device(data.device):
        csrc.check(csrc.entry("order_keys.cu")(
            data.data_ptr(), code, n, 0 if ascending else 1, out.data_ptr(),
            csrc.grid_for(n, data.device), csrc.stream_ptr(data.device)),
            "order_keys")
    order_keys.launches += 1
    return out


order_keys.launches = 0


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def lexsort_perm(keys, sel=None) -> torch.Tensor:
    """Stable lexicographic sort permutation.

    ``keys``: sequence of (data, validity, dtype, ascending, nulls_first),
    most significant first. Spark null ordering (default nulls first when
    ascending, last when descending). Dead rows (sel == False) always sort
    last. Returns the int64 permutation of row indices.
    """
    if not keys:
        return lexsort_keys([], sel)
    return lexsort_keys([(order_keys(data, asc), validity,
                          asc if nf is None else nf)
                         for data, validity, _d, asc, nf in keys], sel)


def lexsort_keys(keys, sel=None) -> torch.Tensor:
    """``lexsort_perm`` over keys already mapped to K3 order keys:
    ``keys`` is a sequence of (int64 key, validity, nulls_first), most
    significant first."""
    n = keys[0][0].shape[0] if keys else sel.shape[0]
    device = keys[0][0].device if keys else sel.device
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for bits, validity, nulls_first in reversed(list(keys)):
        perm = perm[_stable_argsort(bits[perm])]
        if validity is not None:
            null_rank = (validity if nulls_first else ~validity).to(torch.uint8)
            perm = perm[_stable_argsort(null_rank[perm])]
    if sel is not None:
        dead = (~sel).to(torch.uint8)
        perm = perm[_stable_argsort(dead[perm])]
    return perm


def take_column(col: Column, perm: torch.Tensor) -> Column:
    validity = None if col.validity is None else col.validity[perm]
    return Column(col.data[perm], validity, col.dtype)


def take_batch(batch: DeviceBatch, perm: torch.Tensor) -> DeviceBatch:
    cols = {n: take_column(c, perm) for n, c in batch.columns.items()}
    return DeviceBatch(cols, batch.sel[perm])


def compact_perm(sel: torch.Tensor) -> torch.Tensor:
    """Permutation moving live rows to the front, preserving order."""
    return _stable_argsort((~sel).to(torch.uint8))


def compact(batch: DeviceBatch) -> DeviceBatch:
    """The live rows only, in order."""
    idx = torch.nonzero(batch.sel).squeeze(1)
    return take_batch(batch, idx)


def limit(batch: DeviceBatch, n: int, offset: int = 0) -> DeviceBatch:
    """LIMIT/OFFSET over live rows (compacts first)."""
    out = compact(batch)
    return take_batch(out, torch.arange(min(offset, out.capacity),
                                        min(out.capacity, offset + n),
                                        device=out.device))
