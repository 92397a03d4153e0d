"""Columnar batches of tensors on one device.

The PyTorch counterpart of ``sail_tpu/columnar/batch.py``:

- A ``Column`` is a 1-D tensor plus an optional validity (null) mask.
- A ``DeviceBatch`` holds named columns plus a boolean *selection* mask.
  Filters never compact: they narrow ``sel``. Sort, limit and the
  aggregate's output compact explicitly.
- Variable-width data (strings/binary) is dictionary-encoded: the device
  carries int32 codes; the dictionary (a pyarrow Array) stays on the host
  in the ``HostBatch`` wrapper.

PyTorch runs eagerly, so there is no compile cache to keep stable and no
capacity padding: every tensor has the exact row count of its batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..spec import data_type as dt

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}


class Column:
    """A device tensor + optional validity mask + logical type."""

    __slots__ = ("data", "validity", "dtype")

    def __init__(self, data: torch.Tensor, validity: Optional[torch.Tensor],
                 dtype: dt.DataType):
        self.data = data
        self.validity = validity  # bool[n] or None (all valid)
        self.dtype = dtype

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def __repr__(self):
        return f"Column({self.dtype.simple_string()}, n={self.data.shape[0]})"


class StructData:
    """A struct value kept as Arrow lays one out: a column of each field
    (``fields``: (data, validity) pairs, a literal field's a 0-d tensor),
    with each field's dictionary (``dicts``: a string field's, else None)
    and, for a literal field, its value (``literals``: the Python value,
    else None). It stands in for a column's data where a projection
    computes ``struct(...)``; the struct itself is never NULL. Only a host
    aggregate reads one (the arguments of a multi-argument aggregate):
    the executor raises where one reaches any other consumer."""

    __slots__ = ("fields", "dicts", "literals")

    def __init__(self, fields, dicts, literals):
        self.fields = list(fields)
        self.dicts = list(dicts)
        self.literals = list(literals)


class DeviceBatch:
    """Named columns + selection mask. All tensors share one length."""

    __slots__ = ("columns", "sel")

    def __init__(self, columns: Dict[str, Column], sel: torch.Tensor):
        self.columns = columns
        self.sel = sel  # bool[n]

    @property
    def capacity(self) -> int:
        return self.sel.shape[0]

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def num_rows(self) -> int:
        """Live row count (synchronises with the device)."""
        return int(self.sel.sum())

    def with_sel(self, sel: torch.Tensor) -> "DeviceBatch":
        return DeviceBatch(self.columns, sel)

    def __repr__(self):
        return f"DeviceBatch({list(self.columns)}, n={self.capacity})"


@dataclasses.dataclass
class HostBatch:
    """A DeviceBatch plus its host-side string dictionaries (column name →
    pyarrow Array of dictionary values for String/Binary columns)."""

    device: DeviceBatch
    dicts: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.device.capacity

    def num_rows(self) -> int:
        return self.device.num_rows()


def physical_torch_dtype(d: dt.DataType) -> torch.dtype:
    if isinstance(d, (dt.ArrayType, dt.MapType, dt.StructType)):
        return torch.int32  # dictionary code handle (values on host)
    name = d.physical_dtype
    if name is None:
        raise TypeError(f"type {d.simple_string()} has no device representation")
    return _TORCH_DTYPES[name]


def _numpy_dtype(d: dt.DataType) -> np.dtype:
    if isinstance(d, (dt.ArrayType, dt.MapType, dt.StructType)):
        return np.dtype(np.int32)
    return np.dtype(d.physical_dtype)


def _upload(values: np.ndarray, dtype: np.dtype,
            device: torch.device) -> torch.Tensor:
    """Copy host values into a new tensor on ``device``. The copy goes
    through a host tensor of its own (pinned when bound for a card), so
    the result never aliases Arrow's read-only buffers."""
    host = torch.empty(len(values), dtype=_TORCH_DTYPES[dtype.name],
                       pin_memory=device.type == "cuda")
    host.numpy()[:] = values
    return host.to(device, non_blocking=True)


def batch_from_numpy(columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray],
                                              dt.DataType]],
                     sel: np.ndarray, device) -> DeviceBatch:
    """A DeviceBatch from host arrays: ``columns`` maps each name to
    ``(data, validity or None, spec type)``; ``sel`` is the bool
    selection. Every array is copied to ``device`` in the type's physical
    dtype."""
    device = torch.device(device)
    cols = {}
    for name, (values, validity, dtype) in columns.items():
        v = None if validity is None else \
            _upload(validity, np.dtype(bool), device)
        cols[name] = Column(_upload(values, _numpy_dtype(dtype), device),
                            v, dtype)
    return DeviceBatch(cols, _upload(sel, np.dtype(bool), device))


def make_batch(columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray],
                                        dt.DataType]],
               num_rows: int, device) -> DeviceBatch:
    """A DeviceBatch of ``num_rows`` live rows from host arrays."""
    return batch_from_numpy(columns, np.ones(num_rows, dtype=bool), device)
