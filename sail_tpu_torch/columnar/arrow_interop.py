"""Arrow ⇄ device-columnar conversion.

The PyTorch counterpart of ``sail_tpu/columnar/arrow_interop.py``:

- fixed-width types upload as tensors (temporal types as their epoch
  integers)
- decimal128(p≤18) uploads as the *unscaled* int64 (exact arithmetic on
  device; the low 64 bits of the two's-complement decimal128 value equal
  the int64 value whenever it fits)
- strings/binary dictionary-encode; int32 codes upload, the dictionary
  stays on the host
- a nested column (array, struct, map) uploads each row's position as its
  int32 code, the Arrow column its dictionary on the host (the
  reference's ``encode_host_column`` codes)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..spec import data_type as dt
from .batch import DeviceBatch, HostBatch, make_batch


def arrow_type_to_spec(t: pa.DataType) -> dt.DataType:
    if pa.types.is_boolean(t):
        return dt.BooleanType()
    if pa.types.is_int8(t):
        return dt.ByteType()
    if pa.types.is_int16(t):
        return dt.ShortType()
    if pa.types.is_int32(t):
        return dt.IntegerType()
    if pa.types.is_int64(t):
        return dt.LongType()
    if pa.types.is_uint8(t):
        return dt.ShortType()
    if pa.types.is_uint16(t):
        return dt.IntegerType()
    if pa.types.is_uint32(t) or pa.types.is_uint64(t):
        return dt.LongType()
    if pa.types.is_float32(t):
        return dt.FloatType()
    if pa.types.is_float64(t):
        return dt.DoubleType()
    if pa.types.is_decimal(t):
        return dt.DecimalType(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return dt.StringType()
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return dt.BinaryType()
    if pa.types.is_date32(t):
        return dt.DateType()
    if pa.types.is_date64(t):
        return dt.DateType()
    if pa.types.is_timestamp(t):
        return dt.TimestampType(t.tz)
    if pa.types.is_time(t):
        return dt.TimeType()
    if pa.types.is_duration(t):
        return dt.DayTimeIntervalType()
    if pa.types.is_interval(t):
        return dt.YearMonthIntervalType()
    if pa.types.is_dictionary(t):
        return arrow_type_to_spec(t.value_type)
    if pa.types.is_null(t):
        return dt.NullType()
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return dt.ArrayType(arrow_type_to_spec(t.value_type))
    if pa.types.is_struct(t):
        return dt.StructType(tuple(
            dt.StructField(f.name, arrow_type_to_spec(f.type), f.nullable)
            for f in t))
    if pa.types.is_map(t):
        return dt.MapType(arrow_type_to_spec(t.key_type), arrow_type_to_spec(t.item_type))
    raise TypeError(f"unsupported arrow type {t}")


def spec_type_to_arrow(d: dt.DataType) -> pa.DataType:
    if isinstance(d, dt.BooleanType):
        return pa.bool_()
    if isinstance(d, dt.ByteType):
        return pa.int8()
    if isinstance(d, dt.ShortType):
        return pa.int16()
    if isinstance(d, dt.IntegerType):
        return pa.int32()
    if isinstance(d, dt.LongType):
        return pa.int64()
    if isinstance(d, dt.FloatType):
        return pa.float32()
    if isinstance(d, dt.DoubleType):
        return pa.float64()
    if isinstance(d, dt.DecimalType):
        return pa.decimal128(d.precision, d.scale)
    if isinstance(d, dt.StringType):
        return pa.string()
    if isinstance(d, dt.BinaryType):
        return pa.binary()
    if isinstance(d, dt.DateType):
        return pa.date32()
    if isinstance(d, dt.TimestampType):
        return pa.timestamp("us", tz=d.timezone)
    if isinstance(d, dt.TimeType):
        return pa.time64("us")
    if isinstance(d, dt.DayTimeIntervalType):
        return pa.duration("us")
    if isinstance(d, dt.YearMonthIntervalType):
        return pa.month_day_nano_interval()  # months carry the value
    if isinstance(d, dt.NullType):
        return pa.null()
    if isinstance(d, dt.ArrayType):
        return pa.list_(spec_type_to_arrow(d.element_type))
    if isinstance(d, dt.StructType):
        return pa.struct([pa.field(f.name, spec_type_to_arrow(f.data_type), f.nullable)
                          for f in d.fields])
    if isinstance(d, dt.MapType):
        return pa.map_(spec_type_to_arrow(d.key_type), spec_type_to_arrow(d.value_type))
    raise TypeError(f"unsupported spec type {d}")


def _decimal_to_unscaled_int64(arr: pa.Array, validity=None) -> np.ndarray:
    """Unscaled int64 values of a decimal128 array (zero-copy-ish).

    Validates that every value fits in int64 (high word must be the sign
    extension of the low word) — wide-decimal overflow is a loud error, not
    silent corruption."""
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    buf = arr.buffers()[1]
    raw = np.frombuffer(buf, dtype=np.int64)
    # decimal128 is 16 bytes LE; low word at even indices (plus array offset)
    lo = raw[2 * arr.offset::2][: len(arr)]
    hi = raw[2 * arr.offset + 1::2][: len(arr)]
    ok = hi == (lo >> 63)
    if validity is not None:
        ok = ok | ~validity
    if len(lo) and not ok.all():
        raise TypeError(
            f"decimal values exceed the engine's int64 unscaled range "
            f"(type {arr.type}); reduce precision or cast to double")
    return lo.copy()


def _unscaled_int64_to_decimal(vals: np.ndarray, validity: Optional[np.ndarray],
                               d: dt.DecimalType) -> pa.Array:
    """Vectorized decimal128 construction from unscaled int64 values:
    low word = the value, high word = its sign extension."""
    n = len(vals)
    words = np.empty((n, 2), dtype=np.int64)
    words[:, 0] = vals
    words[:, 1] = vals >> 63  # arithmetic shift: 0 or -1
    data_buf = pa.py_buffer(words.tobytes())
    if validity is not None:
        null_buf = pa.py_buffer(np.packbits(validity.astype(np.uint8), bitorder="little").tobytes())
    else:
        null_buf = None
    return pa.Array.from_buffers(pa.decimal128(d.precision, d.scale), n,
                                 [null_buf, data_buf])


def from_arrow(table: pa.Table, device) -> HostBatch:
    """Convert a pyarrow Table to a HostBatch with its columns on
    ``device``."""
    n = table.num_rows
    columns: Dict[str, Tuple[np.ndarray, Optional[np.ndarray], dt.DataType]] = {}
    dicts: Dict[str, pa.Array] = {}
    for name, col in zip(table.column_names, table.columns):
        spec_t = arrow_type_to_spec(col.type)
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        validity = None
        if arr.null_count > 0:
            validity = np.asarray(pc.is_valid(arr))
        if pa.types.is_uint64(arr.type):
            mx = pc.max(arr).as_py()
            if mx is not None and mx >= 2**63:
                raise TypeError(
                    f"column {name!r}: uint64 values >= 2^63 cannot be represented "
                    f"on device (int64); cast to decimal or string first")
        if isinstance(spec_t, (dt.StringType, dt.BinaryType)):
            if pa.types.is_dictionary(arr.type):
                denc = arr
            else:
                denc = pc.dictionary_encode(arr)
            if isinstance(denc, pa.ChunkedArray):
                denc = denc.combine_chunks()
            codes = np.asarray(denc.indices.fill_null(0)).astype(np.int32)
            dicts[name] = denc.dictionary
            columns[name] = (codes, validity, spec_t)
        elif isinstance(spec_t, dt.DecimalType) and spec_t.physical_dtype == "int64":
            if pa.types.is_decimal256(arr.type):
                arr = arr.cast(pa.decimal128(spec_t.precision, spec_t.scale))
            vals = _decimal_to_unscaled_int64(arr, validity)
            columns[name] = (vals, validity, spec_t)
        elif isinstance(spec_t, dt.DecimalType):
            vals = np.asarray(arr.cast(pa.float64()).fill_null(0.0))
            columns[name] = (vals, validity, spec_t)
        elif isinstance(spec_t, dt.NullType):
            columns[name] = (np.zeros(n, dtype=np.int8), np.zeros(n, dtype=bool), spec_t)
        elif isinstance(spec_t, (dt.ArrayType, dt.StructType, dt.MapType)):
            # a nested value stays on the host: the card carries each
            # row's position as its code, the column itself is the
            # dictionary (codes need not name distinct values)
            dicts[name] = arr
            columns[name] = (np.arange(n, dtype=np.int32), validity, spec_t)
        else:
            # Temporal types upload as their epoch integers.
            if isinstance(spec_t, dt.DateType):
                if pa.types.is_date64(arr.type):
                    arr = arr.cast(pa.date32())
                arr = arr.view(pa.int32())
            elif isinstance(spec_t, dt.TimestampType):
                arr = arr.cast(pa.timestamp("us", tz=arr.type.tz)).view(pa.int64())
            elif isinstance(spec_t, dt.DayTimeIntervalType):
                arr = arr.cast(pa.duration("us")).view(pa.int64())
            elif isinstance(spec_t, dt.TimeType):
                arr = arr.cast(pa.time64("us")).view(pa.int64())
            elif isinstance(spec_t, dt.YearMonthIntervalType) and \
                    pa.types.is_interval(arr.type):
                months = np.array(
                    [0 if v is None else v[0] for v in arr.to_pylist()],
                    dtype=np.int32)
                columns[name] = (months, validity, spec_t)
                continue
            fill = False if pa.types.is_boolean(arr.type) else 0
            np_vals = np.asarray(arr.fill_null(fill) if arr.null_count else arr)
            columns[name] = (np_vals, validity, spec_t)
    return HostBatch(make_batch(columns, n, device), dicts)


def to_arrow(batch: HostBatch) -> pa.Table:
    """Download a HostBatch to a pyarrow Table (live rows only, in order).
    Live rows are gathered on the device first, so only they cross to the
    host."""
    dev = batch.device
    idx = torch.nonzero(dev.sel).squeeze(1)
    arrays = []
    fields = []
    for name, col in dev.columns.items():
        data = col.data[idx].cpu().numpy()
        validity = (col.validity[idx].cpu().numpy()
                    if col.validity is not None else None)
        arr = column_to_arrow(data, validity, col.dtype,
                               batch.dicts.get(name), name in batch.dicts)
        arrays.append(arr)
        fields.append(pa.field(name, arr.type, nullable=True))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def column_to_arrow(data, validity, d, dictionary, has_dict) -> pa.Array:
    if isinstance(d, (dt.ArrayType, dt.StructType, dt.MapType)) and has_dict:
        codes = pa.array(data.astype(np.int32),
                         mask=None if validity is None else ~validity)
        return dictionary.take(codes)
    if isinstance(d, (dt.StringType, dt.BinaryType)) and has_dict:
        codes = pa.array(data.astype(np.int32),
                         mask=None if validity is None else ~validity)
        # only the rows' values: a dictionary may be too large for the
        # result's 32-bit offsets
        arr = dictionary.take(codes).cast(
            pa.string() if isinstance(d, dt.StringType) else pa.binary())
    elif isinstance(d, dt.DecimalType) and d.physical_dtype == "int64":
        arr = _unscaled_int64_to_decimal(data, validity, d)
    elif isinstance(d, dt.DecimalType):
        arr = pa.array(data, mask=None if validity is None else ~validity)
        arr = arr.cast(pa.decimal128(d.precision, d.scale), safe=False)
    elif isinstance(d, dt.NullType):
        arr = pa.nulls(len(data))
    else:
        at = spec_type_to_arrow(d)
        if isinstance(d, dt.TimestampType):
            arr = pa.array(data.astype("datetime64[us]"),
                           mask=None if validity is None else ~validity).cast(at)
        elif isinstance(d, dt.DateType):
            arr = pa.array(data.astype(np.int32),
                           mask=None if validity is None else ~validity).cast(at)
        elif isinstance(d, dt.DayTimeIntervalType):
            arr = pa.array(data.astype("timedelta64[us]"),
                           mask=None if validity is None else ~validity)
        elif isinstance(d, dt.YearMonthIntervalType):
            vals = [None if (validity is not None and not validity[i])
                    else (int(data[i]), 0, 0) for i in range(len(data))]
            arr = pa.array(vals, type=pa.month_day_nano_interval())
        elif isinstance(d, dt.TimeType):
            arr = pa.array(data.astype(np.int64),
                           mask=None if validity is None else ~validity
                           ).cast(pa.time64("us"))
        else:
            arr = pa.array(data, mask=None if validity is None else ~validity)
            if arr.type != at:
                arr = arr.cast(at, safe=False)
    return arr


def unify_dictionaries(dict_a: pa.Array, dict_b: pa.Array
                       ) -> Tuple[pa.Array, np.ndarray, np.ndarray]:
    """Merge two dictionaries; returns (merged, remap_a, remap_b) where
    remap_x maps old codes → merged codes. Used before joins on string
    columns and comparisons of two string columns, so device-side code
    comparison is exact."""
    merged = pa.concat_arrays([dict_a.cast(pa.string()),
                               dict_b.cast(pa.string())])
    enc = pc.dictionary_encode(merged)
    if isinstance(enc, pa.ChunkedArray):
        enc = enc.combine_chunks()
    codes = np.asarray(enc.indices)
    return (enc.dictionary, codes[: len(dict_a)].astype(np.int32),
            codes[len(dict_a):].astype(np.int32))


def dictionary_ranks(dictionary: pa.Array) -> np.ndarray:
    """Order-preserving rank per dictionary code (for ORDER BY / range
    comparisons on dictionary-encoded strings)."""
    order = pc.sort_indices(dictionary)
    ranks = np.empty(len(dictionary), dtype=np.int32)
    ranks[np.asarray(order)] = np.arange(len(dictionary), dtype=np.int32)
    return ranks
