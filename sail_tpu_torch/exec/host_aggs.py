"""The host aggregates of an AggregateExec, grouped on the device.

The counterpart of ``sail_tpu/exec/local.py`` ``_host_aggregate`` and
``_host_agg_one``. The reference downloads the whole input to Python
lists, groups it in a dict and calls each aggregate's Python function
(``functions/host_aggregates.py``) once a group. Here the aggregate groups
once, on the device, as any other (K2's bins, the sort, or keyless), and
each host aggregate reduces by its family (``ops/aggregate.py``):

- A, moments: corr, covar_*, skewness, kurtosis, regr_* (K19);
- B, arg-extremes: max_by, min_by (K20), mode and its ordered form (K20
  over the runs of a sort of each group's values);
- C, ranks: median and the percentiles, by one sort of (group, value);
- D, exact sums: try_sum, try_avg, try_avg_ym (two K1 sums of 32-bit
  halves), float and decimal sums as K1 takes them;
- E, bit_and, bit_or, bit_xor (K1's bit kinds) and product;
- F, collections: collect_list, array_agg, collect_set, listagg,
  string_agg and their ordered form, built on the host from each group's
  rows and offsets (one download), histogram_numeric by the copied
  function over those lists.

Each follows ``_host_agg_one``'s null rules: max_by/min_by drop rows
whose ordering key is NULL; the value-first aggregates (``_VALUE_FIRST``)
rows whose first field is NULL; the other multi-argument ones rows with
any NULL field; DISTINCT keeps the first of each equal row. Intervals
reduce as their integers (months, microseconds) and a fractional result
rounds half to even, as ``_intervalize`` gives. Results are over the
aggregate's output slots (``aggregate.output_slots``); an array or struct
result is a nested column (int32 codes of an Arrow array on the host).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..columnar import arrow_interop as ai
from ..columnar.batch import Column, StructData
from ..functions.host_aggregates import HOST_AGGS, _histogram, _to_str
from ..ops import aggregate as aggk
from ..ops.sort import order_keys
from ..plan import nodes as pn
from ..spec import data_type as dt

# the aggregates that drop only the rows whose first field is NULL
_VALUE_FIRST = ("listagg", "string_agg", "percentile", "percentile_approx",
                "approx_percentile", "percentile_cont", "percentile_disc",
                "histogram_numeric", "__listagg_ordered", "__mode_ordered",
                "mode")
MOMENTS = ("corr", "covar_samp", "covar_pop", "skewness", "kurtosis",
           "regr_count", "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy",
           "regr_sxy", "regr_slope", "regr_intercept", "regr_r2")
# the centred sums each statistical aggregate reads (the first field is
# a, the second b; regr_*(y, x): y is a)
_NEEDS = {"corr": ("aa", "bb", "ab"), "covar_samp": ("ab",),
          "covar_pop": ("ab",), "skewness": ("aa", "aaa"),
          "kurtosis": ("aa", "aaaa"), "regr_sxx": ("bb",),
          "regr_syy": ("aa",), "regr_sxy": ("ab",),
          "regr_slope": ("bb", "ab"), "regr_intercept": ("bb", "ab"),
          "regr_r2": ("aa", "bb", "ab")}
_RANKS = ("median", "percentile", "percentile_cont", "percentile_approx",
          "approx_percentile", "percentile_disc")
_COLLECT = ("collect_list", "array_agg", "collect_set", "listagg",
            "string_agg", "__listagg_ordered", "histogram_numeric")
_BITS = {"bit_and": "and", "bit_or": "or", "bit_xor": "xor"}
_MAX64 = (1 << 63) - 1


class Field(NamedTuple):
    """One argument of a host aggregate: its data (0-d for a literal),
    validity, type, dictionary and, for a literal, its Python value."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    dtype: dt.DataType
    dictionary: Optional[pa.Array] = None
    literal: object = None


def host_name(fn: str) -> Optional[str]:
    """The HOST_AGGS name of an aggregate function, or None."""
    return fn[len("__host__"):] if fn.startswith("__host__") else None


def arg_fields(data, validity, dtype: dt.DataType,
               dictionary: Optional[pa.Array]) -> List[Field]:
    """The fields of an aggregate's argument column: a struct's fields,
    else the column itself."""
    if isinstance(data, StructData):
        return [Field(d, v, f.data_type, dic, lit)
                for (d, v), f, dic, lit in zip(data.fields, dtype.fields,
                                               data.dicts, data.literals)]
    return [Field(data, validity, dtype, dictionary)]


def needed_sums(aggs) -> dict:
    """(argument, DISTINCT) → the mask of K19's centred sums the
    aggregate's statistical aggregates of it read, so one second pass
    serves them all."""
    out: dict = {}
    for a in aggs:
        name = host_name(a.fn)
        if name in MOMENTS:
            mask = 0
            for k in _NEEDS.get(name, ()):
                mask |= aggk.CENTRED[k]
            key = (a.arg, a.distinct)
            out[key] = out.get(key, 0) | mask
    return out


class HostAgg:
    """The host aggregates of one grouping: ``ctx`` its context, ``slots``
    its output groups, ``dict_order`` the executor's rank tables of a
    dictionary, ``masks`` ``needed_sums`` of its aggregates."""

    def __init__(self, ctx: aggk.GroupContext, slots: int,
                 dict_order: Callable, masks: dict):
        self.ctx = ctx
        self.slots = slots
        self.dict_order = dict_order
        self.masks = masks
        self.n = ctx.alive.shape[0]
        self.dev = ctx.alive.device
        self._moments: dict = {}

    # -- helpers ----------------------------------------------------------
    def _ok(self, f: Field) -> torch.Tensor:
        if f.validity is None:
            return torch.ones(self.n, dtype=torch.bool, device=self.dev)
        return f.validity.expand(self.n) if f.validity.dim() == 0 \
            else f.validity

    def _word(self, f: Field, ascending: bool = True) -> torch.Tensor:
        """The field's K3 order word by row; a string's by value, through
        its dictionary's rank table."""
        data = f.data
        if f.dictionary is not None and len(f.dictionary) > 0:
            data = self.dict_order(f.dictionary)[0][data.long()]
        return order_keys(data, ascending)

    def _float(self, f: Field, rows: torch.Tensor) -> torch.Tensor:
        """The field's values at ``rows`` as float64 (a decimal's
        unscaled value divided by its power of ten), as ``float()`` of
        the reference's Python value."""
        return aggk._as_float(self._operand(f), rows)

    def _operand(self, f: Field) -> aggk.Operand:
        scale = f.dtype.scale if isinstance(f.dtype, dt.DecimalType) and \
            not f.data.is_floating_point() else 0
        data = f.data.expand(self.n) if f.data.dim() == 0 else f.data
        return aggk.Operand(data, f.validity, scale)

    def _literal(self, f: Field, what: str):
        """A literal field's Python value (a constant expression's is read
        from the device)."""
        if f.literal is not None:
            return f.literal
        if f.data.dim() == 0:
            if f.validity is not None and not bool(f.validity):
                return None
            v = f.data.item()
            if isinstance(f.dtype, dt.DecimalType) and \
                    not f.data.is_floating_point():
                v = v / 10 ** f.dtype.scale
            return v
        raise NotImplementedError(
            f"a {what} that is not a literal is not ported yet: it waits "
            f"for the slice that ports the host functions (array)")

    def _eligible(self, name: str, fields: List[Field], distinct: bool
                  ) -> torch.Tensor:
        """bool by row: the rows ``_host_agg_one`` hands the aggregate."""
        if len(fields) == 1:
            ok = self._ok(fields[0])
        elif name in ("max_by", "min_by"):
            ok = self._ok(fields[1])
        elif name in _VALUE_FIRST:
            ok = self._ok(fields[0])
        else:
            ok = self._ok(fields[0])
            for f in fields[1:]:
                ok = ok & self._ok(f)
        if distinct:
            first = fields[0]
            data = first.data
            more = [Column(f.data, f.validity, f.dtype) for f in fields[1:]]
            if first.validity is not None and name in ("max_by", "min_by"):
                # its NULL rows are kept: a NULL keys as 0 and its
                # validity, equal to another NULL whatever its slot holds
                data = torch.where(first.validity, data, 0)
                more.insert(0, Column(data, first.validity, first.dtype))
            ok = aggk.distinct_rows(self.ctx, Column(data, ok, first.dtype),
                                    more)
        return ok

    def _nested(self, arr: pa.Array, dtype: dt.DataType
                ) -> Tuple[Column, pa.Array]:
        """A host array of one value a group as a nested column:
        positional int32 codes, the array its dictionary."""
        codes = torch.arange(self.slots, dtype=torch.int32, device=self.dev)
        valid = torch.from_numpy(
            np.asarray(arr.is_valid()).astype(bool)).to(self.dev)
        return Column(codes, valid, dtype), arr

    def _string(self, arr: pa.Array, dtype: dt.DataType
                ) -> Tuple[Column, pa.Array]:
        """A host string array of one value a group as a string column:
        its dictionary's codes (a dictionary of distinct values)."""
        enc = pc.dictionary_encode(arr)
        codes = np.asarray(enc.indices.fill_null(0)).astype(np.int32)
        valid = np.asarray(arr.is_valid()).astype(bool)
        return Column(torch.from_numpy(codes).to(self.dev),
                      torch.from_numpy(valid).to(self.dev), dtype), \
            enc.dictionary

    @staticmethod
    def _round(x: torch.Tensor, dtype: dt.DataType) -> torch.Tensor:
        """A numeric result in the output type: an interval's rounds half
        to even (``_intervalize``)."""
        if isinstance(dtype, (dt.YearMonthIntervalType,
                              dt.DayTimeIntervalType)):
            return torch.round(x).to(torch.int32 if isinstance(
                dtype, dt.YearMonthIntervalType) else torch.int64)
        return x

    # -- dispatch ----------------------------------------------------------
    def run(self, a: pn.AggSpec, fields: List[Field]
            ) -> Tuple[Column, Optional[pa.Array]]:
        """One host aggregate's column over the output slots, and its
        dictionary (a string's or a nested value's), or None."""
        name = host_name(a.fn)
        if name not in HOST_AGGS:
            raise NotImplementedError(f"host aggregate {name!r} is not "
                                      f"ported yet")
        ok = self._eligible(name, fields, a.distinct)
        out_t = a.out_dtype
        if name in MOMENTS:
            return self._moments_of(a, name, fields, ok), None
        if name in ("max_by", "min_by"):
            return self._by(name, fields, ok, out_t)
        if name in ("mode", "__mode_ordered"):
            desc = name == "__mode_ordered" and \
                bool(self._literal(fields[1], "mode order"))
            return self._mode(fields[0], ok, desc, out_t)
        if name in _RANKS:
            return self._rank(name, fields, ok, out_t)
        if name in ("try_sum", "try_avg", "try_avg_ym"):
            return self._exact(name, fields[0], ok, out_t), None
        if name in _BITS:
            col = aggk.agg_bit(self.ctx, Column(fields[0].data, ok,
                                                fields[0].dtype), _BITS[name])
            return self._slice(col, out_t), None
        if name == "product":
            prod, count = aggk.agg_product(
                self.ctx, self.slots,
                self._operand(fields[0])._replace(validity=ok))
            return Column(prod, count > 0, out_t), None
        if name in _COLLECT:
            return self._collect(name, fields, ok, out_t)
        raise NotImplementedError(f"host aggregate {name!r} is not ported "
                                  f"yet")

    def _slice(self, col: Column, dtype) -> Column:
        s = self.slots
        return Column(col.data[:s], None if col.validity is None
                      else col.validity[:s], dtype)

    # -- A: moments ---------------------------------------------------------
    def _moments_of(self, a: pn.AggSpec, name: str, fields: List[Field],
                    ok: torch.Tensor) -> Column:
        key = (a.arg, a.distinct)
        m = self._moments.get(key)
        if m is None:
            x = self._operand(fields[0])._replace(validity=ok)
            y = None if len(fields) < 2 else \
                self._operand(fields[1])._replace(validity=None)
            m = self._moments[key] = aggk.agg_moments(
                self.ctx, self.slots, x, y, self.masks.get(key, 0))
        n = m["count"].to(torch.float64)
        has = m["count"] > 0
        t = a.out_dtype
        if name == "regr_count":
            return Column(m["count"], None, t)
        if name == "corr":
            # rows (y, x) as the reference names them: a is y, b is x
            vy, vx, cov = m["aa"], m["bb"], m["ab"]
            ok = (m["count"] >= 2) & (vy != 0) & (vx != 0)
            return Column(cov / torch.sqrt(vy * vx), ok, t)
        if name in ("covar_samp", "covar_pop"):
            pop = name == "covar_pop"
            ok = has if pop else m["count"] >= 2
            return Column(m["ab"] / (n if pop else n - 1), ok, t)
        if name in ("skewness", "kurtosis"):
            m2 = m["aa"] / n
            ok = has & (m2 != 0)
            if name == "kurtosis":
                return Column(m["aaaa"] / n / (m2 * m2) - 3.0, ok, t)
            return Column(m["aaa"] / n / torch.pow(m2, 1.5), ok, t)
        my, mx = m["sa"] / n, m["sb"] / n
        if name == "regr_avgy":
            return Column(my, has, t)
        if name == "regr_avgx":
            return Column(mx, has, t)
        sxx, syy, sxy = m.get("bb"), m.get("aa"), m.get("ab")
        if name == "regr_sxx":
            return Column(sxx, has, t)
        if name == "regr_syy":
            return Column(syy, has, t)
        if name == "regr_sxy":
            return Column(sxy, has, t)
        ok = has & (sxx != 0)
        if name == "regr_slope":
            return Column(sxy / sxx, ok, t)
        if name == "regr_intercept":
            return Column(my - (sxy / sxx) * mx, ok, t)
        # regr_r2
        return Column(torch.where(syy == 0, 1.0,
                                  (sxy * sxy) / (sxx * syy)), ok, t)

    # -- B: arg-extremes ----------------------------------------------------
    def _gather(self, f: Field, rows: torch.Tensor, has: torch.Tensor,
                dtype) -> Tuple[Column, Optional[pa.Array]]:
        """The field's value at each group's row (``rows`` clipped into
        the input), NULL where ``has`` is False."""
        rows = rows.clamp(0, max(self.n - 1, 0))
        if self.n == 0:
            data = torch.zeros(self.slots, dtype=f.data.dtype,
                               device=self.dev)
            return Column(data, has, dtype), f.dictionary
        data = f.data.expand(self.n)[rows] if f.data.dim() == 0 \
            else f.data[rows]
        valid = has if f.validity is None else has & self._ok(f)[rows]
        return Column(data, valid, dtype), f.dictionary

    def _by(self, name, fields, ok, out_t):
        index = aggk.agg_pick(self.ctx, self.slots, self._word(fields[1]), ok,
                              name == "max_by")
        return self._gather(fields[0], index, index != _MAX64, out_t)

    def _mode(self, f: Field, ok, desc: bool, out_t):
        words = self._word(f, ascending=not desc)
        srt = aggk.group_sorted(self.ctx, self.slots, ok,
                                [(words, None, True)])
        rows = aggk.agg_mode(self.ctx, self.slots, srt, words)
        return self._gather(f, rows, aggk.group_counts(srt) > 0, out_t)

    # -- C: ranks -----------------------------------------------------------
    def _rank(self, name, fields, ok, out_t):
        f = fields[0]
        p = 0.5 if name == "median" or len(fields) < 2 else \
            float(self._literal(fields[1], "percentage"))
        srt = aggk.group_sorted(self.ctx, self.slots, ok,
                                [(self._word(f), None, True)])
        cnt = aggk.group_counts(srt)
        has = cnt > 0
        if name in ("percentile_approx", "approx_percentile"):
            # _rank_percentile: the observed value at floor(p * (n - 1))
            idx = torch.floor(p * (cnt - 1).to(torch.float64)).to(torch.int64)
            return self._gather(f, aggk.pick_at(srt, idx), has, out_t)
        if name == "percentile_disc":
            desc = len(fields) > 2 and bool(self._literal(fields[2],
                                                          "percentile order"))
            up = torch.ceil(p * cnt.to(torch.float64)).to(torch.int64)
            up = up.clamp_min(1)
            idx = (cnt - up).clamp_min(0) if desc else \
                torch.minimum(up - 1, cnt - 1)
            x = self._float(f, aggk.pick_at(srt, idx))
            return Column(self._round(x, out_t), has, out_t), None
        # _percentile: interpolate between the values at floor and ceil
        pos = (cnt - 1).to(torch.float64) * p
        lo, hi = torch.floor(pos), torch.ceil(pos)
        x_lo = self._float(f, aggk.pick_at(srt, lo.to(torch.int64)))
        x_hi = self._float(f, aggk.pick_at(srt, hi.to(torch.int64)))
        x = torch.where(lo == hi, x_lo, x_lo + (x_hi - x_lo) * (pos - lo))
        return Column(self._round(x, out_t), has, out_t), None

    # -- D: exact sums ------------------------------------------------------
    def _exact(self, name: str, f: Field, ok, out_t) -> Column:
        value = Column(f.data, ok, f.dtype)
        if f.data.is_floating_point() or (
                isinstance(f.dtype, dt.DecimalType) and name == "try_sum"):
            # floats and decimals sum as K1 sums them
            total = aggk.agg_sum(self.ctx, value, f.dtype if name != "try_sum"
                                 else out_t)
            col = self._slice(total, out_t)
            if name == "try_sum":
                return col
            cnt = aggk._group_counts(self.ctx, value)[:self.slots]
            x = col.data.to(torch.float64)
            if isinstance(f.dtype, dt.DecimalType) and \
                    not f.data.is_floating_point():
                x = x / 10.0 ** f.dtype.scale
            return Column(x / cnt.clamp_min(1).to(torch.float64), cnt > 0,
                          out_t)
        hi, lo, cnt = (t[:self.slots] for t in aggk.agg_exact_sum(self.ctx,
                                                                  value))
        has = cnt > 0
        if name == "try_sum":
            fits = (hi >= -(1 << 31)) & (hi < (1 << 31))
            return Column((hi << 32) | lo, has & fits, out_t)
        total = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
        if isinstance(f.dtype, dt.DecimalType):
            total = total / 10.0 ** f.dtype.scale
        avg = total / cnt.clamp_min(1).to(torch.float64)
        if name == "try_avg_ym":
            # the month sum must fit int32
            fits = ((hi == 0) & (lo < (1 << 31))) | \
                ((hi == -1) & (lo >= (1 << 31)))
            return Column(self._round(avg, out_t), has & fits, out_t)
        return Column(self._round(avg, out_t), has, out_t)

    # -- F: collections -----------------------------------------------------
    def _values(self, f: Field, rows: torch.Tensor) -> pa.Array:
        """The field's values at ``rows`` downloaded as one Arrow array."""
        data = (f.data.expand(self.n) if f.data.dim() == 0 else f.data)[rows]
        valid = None if f.validity is None else self._ok(f)[rows]
        return ai.column_to_arrow(
            data.cpu().numpy(), None if valid is None else
            valid.cpu().numpy(), f.dtype, f.dictionary,
            f.dictionary is not None)

    def _lists(self, srt: aggk.GroupSorted, f: Field) -> pa.Array:
        offsets = pa.array(srt.offsets.to(torch.int32).cpu().numpy())
        return pa.ListArray.from_arrays(offsets, self._values(f, srt.rows))

    def _join_values(self, f: Field, srt: aggk.GroupSorted,
                     values: pa.Array) -> pa.Array:
        """The strings listagg joins, written as the reference writes its
        host values (``_to_str``, Python's ``str``): a double 2.0 as
        '2.0', a boolean as 'True', an interval as its months or
        microseconds (``_norm_intervals``)."""
        if pa.types.is_dictionary(values.type):
            values = values.dictionary_decode()
        if pa.types.is_string(values.type):
            return values
        if isinstance(f.dtype, (dt.YearMonthIntervalType,
                                dt.DayTimeIntervalType)):
            data = f.data.expand(self.n) if f.data.dim() == 0 else f.data
            vals = data[srt.rows].cpu().tolist()
        else:
            vals = values.to_pylist()
        return pa.array([_to_str(v) for v in vals], pa.string())

    def _collect(self, name, fields, ok, out_t):
        f = fields[0]
        if name == "collect_set":
            ok = aggk.distinct_rows(self.ctx, Column(f.data, ok, f.dtype))
        words = []
        if name == "__listagg_ordered":
            desc = bool(self._literal(fields[3], "listagg order"))
            key = fields[2]
            if key.data.dim():  # a literal key orders nothing
                words = [(self._word(key, not desc), key.validity, not desc)]
        srt = aggk.group_sorted(self.ctx, self.slots, ok, words)
        lists = self._lists(srt, f)
        if name in ("collect_list", "array_agg", "collect_set"):
            return self._nested(lists.cast(ai.spec_type_to_arrow(out_t)),
                                out_t)
        cnt = aggk.group_counts(srt).cpu().numpy()
        if name == "histogram_numeric":
            nb = self._literal(fields[1], "bin count") \
                if len(fields) > 1 else 5
            vals = lists.to_pylist()
            out = [_histogram(v, nb) if c else None
                   for v, c in zip(vals, cnt)]
            return self._nested(pa.array(out, type=ai.spec_type_to_arrow(
                out_t)), out_t)
        # listagg, string_agg: the first row's delimiter ("" for NULL)
        if len(fields) > 1:
            d = fields[1]
            if d.data.dim() == 0:
                delim = self._literal(d, "delimiter") or ""
            else:
                first = self._values(d, aggk.pick_at(
                    srt, torch.zeros(self.slots, dtype=torch.int64,
                                     device=self.dev)))
                delim = first.fill_null("").cast(pa.string())
        else:
            delim = ""
        strings = pa.ListArray.from_arrays(
            lists.offsets, self._join_values(f, srt, lists.values),
            mask=pa.array(cnt == 0))
        return self._string(pc.binary_join(strings, delim), out_t)
