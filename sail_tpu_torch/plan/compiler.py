"""Expression compiler: resolved expressions → closures over tensors.

The PyTorch counterpart of ``sail_tpu/plan/compiler.py``. It binds a Rex
tree against a batch schema (+ its host-side string dictionaries) and
produces a closure over column ``(data, validity)`` pairs. PyTorch runs
the closure eagerly, one elementwise op at a time; literals are 0-d
tensors that broadcast against columns.

Ported subset: column refs, literals, pre-evaluated scalar subqueries,
casts between numeric, decimal, boolean and date types, of timestamps to
dates (in the session's zone) and from strings,
CASE (over strings too), decimal ``+ - *`` with rescale, ``/``,
comparisons (of strings through unified dictionaries, or against a
literal), Kleene AND/OR/NOT, the null-handling functions, IN,
LIKE/ILIKE/RLIKE, the date and time fields, ``trunc``/``date_trunc``,
date ± interval arithmetic and the dictionary transforms (``substring``
among them). Strings stay int32 dictionary codes on the device; every
string function runs on the host over the dictionary at bind time
(Arrow's kernels where their result is Spark's: LIKE, the lengths,
comparisons with a literal) and reaches the device as a lookup table.
Those tables are kept from one query to the next in a ``DictTables``
(the session's), keyed by the dictionary objects they were made from: a
steady query builds none. Anything else raises ``NotImplementedError``
naming the expression; nothing falls back silently.

Beside its closure, each expression the chain program covers gets a
fragment (``Compiled.frag``, an ``ops/chain.py`` ``Frag``): the same
computation as program nodes, torch type for torch type and NULL for
NULL, which a Filter/Project chain lowers to one K16 or K17 program. A
builder without a fragment (or one whose arguments have none) leaves
``frag`` None, and its chain keeps the closures; ``ExprCompiler.unfused``
lists the first such expressions.
"""

from __future__ import annotations

import datetime
import decimal
import hashlib
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..columnar.arrow_interop import dictionary_ranks, unify_dictionaries
from ..columnar.batch import StructData, physical_torch_dtype
from ..functions import kernels as K
from ..functions import numeric as NUM
from ..functions.numeric import civil_from_days, days_from_civil
from ..functions.numeric import month_len as _month_len
from ..ops import chain as ch
from ..spec import data_type as dt
from ..spec.literal import Literal as LV
from ..utils.tz import session_timezone_name
from . import rex as rx

CV = K.CV


@dataclass
class Compiled:
    """A bind-time-compiled expression: ``fn(cols)`` maps the column
    ``(data, validity)`` pairs, by position, to the expression's value."""

    fn: Callable[[List[CV]], CV]
    dtype: dt.DataType
    dictionary: Optional[pa.Array] = None  # for string/binary outputs
    # the same computation as a chain program's nodes (None: not covered)
    frag: Optional[ch.Frag] = None


class DictTables:
    """What queries derive from string dictionaries (lookup tables on the
    device, rank tables, transformed dictionaries), kept for the session's
    life as the scan cache beside it keeps uploaded columns, and as the
    reference's ``_OP_CACHE`` keeps its compiled operators with their
    tables; ``clear()`` (``SparkSession.stop``) drops them.

    An entry is keyed by the identity of the dictionaries it was made
    from and by what was made (``key``); it holds those dictionaries, so
    the ids in its key stay theirs. ``builds`` counts the entries made."""

    def __init__(self):
        self.builds = 0
        self._entries: dict = {}

    def get(self, dictionaries: Tuple[pa.Array, ...], key, build):
        """The entry for (dictionaries, key), made by ``build()`` if it is
        not kept."""
        k = (tuple(id(d) for d in dictionaries), key)
        hit = self._entries.get(k)
        if hit is None:
            hit = self._entries[k] = (tuple(dictionaries), build())
            self.builds += 1
        return hit[1]

    def clear(self) -> None:
        self._entries.clear()


def _is_str(d: dt.DataType) -> bool:
    return isinstance(d, (dt.StringType, dt.BinaryType))


def _unported(r: rx.Rex, why: str) -> NotImplementedError:
    return NotImplementedError(f"{why} is not ported yet: {r!r}")


def _text(dictionary: pa.Array) -> pa.Array:
    """A dictionary's values as Arrow text (binary decodes as UTF-8)."""
    if pa.types.is_string(dictionary.type) or \
            pa.types.is_large_string(dictionary.type):
        return dictionary
    return dictionary.cast(pa.large_string() if
                           pa.types.is_large_binary(dictionary.type)
                           else pa.string())


def _dict_strings(dictionary: pa.Array) -> List[Optional[str]]:
    return _text(dictionary).to_pylist()


def _arrow_like(pattern: str, escape: Optional[str] = None) -> str:
    """A LIKE pattern with escape character ``escape`` (Spark's default:
    backslash) in Arrow's ``match_like`` syntax, whose escape is the
    backslash: an escaped character matches itself."""
    esc = escape or "\\"
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == esc and i + 1 < len(pattern):
            out.append("\\" + pattern[i + 1])
            i += 2
            continue
        out.append("\\\\" if c == "\\" else c)
        i += 1
    return "".join(out)


_PY_RE_ESCAPES = set("dDwWsSbBAZnrtfv0123456789\\.^$*+?()[]{}|/")


def _jre(pattern: str) -> str:
    """Java-regex → python re, leniently: escapes python's re rejects
    (like \\U outside known classes) lose the backslash instead of
    failing the whole query."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in _PY_RE_ESCAPES:
                out.append(c)
                out.append(nxt)
            else:
                out.append(re.escape(nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


class ExprCompiler:
    """Compiles Rex against (schema types, dictionaries) for tensors on
    ``device``."""

    def __init__(self, column_types: Sequence[dt.DataType],
                 dictionaries: Dict[int, pa.Array], device,
                 subquery_values: Optional[Dict[int, LV]] = None,
                 tables: Optional[DictTables] = None,
                 column_frags: Optional[Sequence[Optional[ch.Frag]]] = None):
        self.column_types = list(column_types)
        self.dicts = dictionaries  # column index → dictionary
        self.device = torch.device(device)
        # id(RScalarSubquery) → its value, evaluated before the plan runs
        self.subquery_values = subquery_values or {}
        self.tables = DictTables() if tables is None else tables
        # each column's fragment where the compiler lowers a chain (None:
        # closures only)
        self.column_frags = column_frags
        # the innermost expressions that got no fragment, in compile order
        self.unfused: List[rx.Rex] = []

    def _cached(self, dictionaries: Sequence[pa.Array], key, build):
        """``build()``'s value for tables on this compiler's device, kept
        in ``self.tables`` under the dictionaries and ``key``."""
        return self.tables.get(tuple(dictionaries), (key, self.device),
                               build)

    def compile(self, r: rx.Rex) -> Compiled:
        seen = len(self.unfused)
        out = self._compile(r)
        if out.frag is None and self.column_frags is not None and \
                len(self.unfused) == seen:
            self.unfused.append(r)
        return out

    def _compile(self, r: rx.Rex) -> Compiled:
        if isinstance(r, rx.BoundRef):
            idx = r.index
            frag = None if self.column_frags is None else \
                self.column_frags[idx]
            return Compiled(lambda cols, i=idx: cols[i], r.dtype,
                            self.dicts.get(idx), frag)
        if isinstance(r, rx.RLit):
            return self._compile_literal(r.value, r)
        if isinstance(r, rx.RScalarSubquery):
            if id(r) not in self.subquery_values:
                raise RuntimeError("scalar subquery not pre-evaluated")
            # its value an argument of a chain's kernel, not a literal
            return self._compile_literal(self.subquery_values[id(r)], r,
                                         arg=id(r))
        if isinstance(r, rx.RCast):
            return self._compile_cast(r)
        if isinstance(r, rx.RCase):
            return self._compile_case(r)
        if isinstance(r, rx.RCall):
            return self._compile_call(r)
        raise _unported(r, f"expression {type(r).__name__}")

    # -- literals ---------------------------------------------------------
    def _compile_literal(self, v: LV, r: rx.Rex,
                         arg: Optional[int] = None) -> Compiled:
        d = v.data_type
        if isinstance(d, (dt.ArrayType, dt.MapType, dt.StructType)):
            raise _unported(r, "a complex literal")
        if v.is_null:
            tdt = physical_torch_dtype(d if d.physical_dtype else dt.NullType())
            data = torch.zeros((), dtype=tdt, device=self.device)
            invalid = torch.zeros((), dtype=torch.bool, device=self.device)
            # the fragments' constants come from host tensors: reading a
            # value back from the card would wait for it
            return Compiled(lambda cols: (data, invalid), d,
                            self._literal_dict("") if _is_str(d) else None,
                            ch.const_of(torch.zeros((), dtype=tdt),
                                        torch.zeros((), dtype=torch.bool),
                                        arg))
        if _is_str(d):
            code = torch.zeros((), dtype=torch.int32, device=self.device)
            return Compiled(lambda cols: (code, None), d,
                            self._literal_dict(v.value),
                            ch.const(0, torch.int32))
        tdt = physical_torch_dtype(d)
        value = torch.tensor(v.physical_value(), dtype=tdt,
                             device=self.device)
        return Compiled(lambda cols: (value, None), d,
                        frag=ch.const_of(torch.tensor(v.physical_value(),
                                                      dtype=tdt), None, arg))

    def _literal_dict(self, value) -> pa.Array:
        """A string literal's one-entry dictionary: one object for each
        value, so the tables made from it are kept like a column's."""
        return self.tables.get((), ("literal", type(value), value),
                               lambda: pa.array([value]))

    # -- casts -----------------------------------------------------------
    def _compile_cast(self, r: rx.RCast) -> Compiled:
        child = self.compile(r.child)
        src, dst = child.dtype, r.dtype
        if src == dst:
            return child
        if isinstance(src, dt.NullType):
            return self._compile_literal(LV(dst, None), r)
        if _is_str(src) and _is_str(dst):
            return Compiled(child.fn, dst, child.dictionary, child.frag)
        if _is_str(src) and child.dictionary is not None and \
                dst.physical_dtype:
            return self._cast_from_string(child, dst)
        if _is_str(src) or _is_str(dst):
            raise _unported(r, "a cast to a string or of a complex type")
        if not (src.physical_dtype and dst.physical_dtype) or \
                isinstance(dst, (dt.ArrayType, dt.MapType, dt.StructType)):
            raise _unported(r, "a cast of a complex type")
        tdt = physical_torch_dtype(dst)
        src_scale = _decimal_scale(src)
        dst_scale = _decimal_scale(dst)
        if isinstance(src, dt.TimestampType) and isinstance(dst, dt.DateType):
            def to_date(cols):
                # days = floor((µs + the zone's offset at that instant) /
                # 86,400,000,000)
                x, validity = child.fn(cols)
                return _to_days(x, src).to(tdt), validity
            days = _f_to_days(child.frag, src)
            return Compiled(to_date, dst,
                            frag=None if days is None else ch.conv(days, tdt))

        # a value past the target decimal's precision is NULL, as in Spark
        fit = _decimal_fit(src, dst)

        def fn(cols):
            x, validity = child.fn(cols)
            fits = None
            if src_scale is not None and dst_scale is None:
                x = x.to(torch.float64) / (10.0 ** src_scale)
            if dst_scale is not None:
                if src_scale is not None and dst_scale < src_scale:
                    x = _rescale_down(x, src_scale - dst_scale)
                    if fit is not None:
                        fits = _within(x, fit)
                elif src_scale is not None or not x.is_floating_point():
                    if src_scale is None:
                        x = x.to(torch.int64)
                    if fit is not None:  # before the multiply can wrap
                        fits = _within(x, fit)
                    up = dst_scale - (src_scale or 0)
                    if up:
                        x = x * (10 ** up)
                else:
                    y = x * (10.0 ** dst_scale)
                    r = (torch.sign(y) * torch.floor(torch.abs(y) + 0.5)
                         ).to(torch.float64)
                    if fit is not None:
                        fits = _within(r, fit)
                    x = NUM.saturating_long(r)
            elif isinstance(dst, dt.BooleanType):
                x = x != 0
            elif not tdt.is_floating_point and x.is_floating_point():
                x = _spark_int(x, tdt)
            elif fit is not None:  # a decimal held as a double
                fits = _within(x.to(torch.float64), fit)
            if fits is not None:
                validity = fits if validity is None else validity & fits
            return x.to(tdt), validity

        return Compiled(fn, dst, frag=_f_cast(child.frag, src_scale,
                                              dst_scale, dst, tdt, fit))

    def _cast_from_string(self, child: Compiled, dst: dt.DataType
                          ) -> Compiled:
        """Parse each dictionary value on the host; the device gathers the
        parsed value (NULL where it does not parse) by code."""
        def build():
            parsed = [_parse_string_value(v, dst)
                      for v in _dict_strings(child.dictionary)]
            return (self._lut([v for v, _ in parsed],
                              physical_torch_dtype(dst)),
                    self._lut([good for _, good in parsed], torch.bool))

        # a timestamp parses in the session's zone
        zone = session_timezone_name() \
            if isinstance(dst, dt.TimestampType) else None
        lut, ok = self._cached([child.dictionary], ("cast", dst, zone), build)

        def fn(cols):
            data, validity = child.fn(cols)
            good = ok[data.long()]
            return lut[data.long()], \
                good if validity is None else validity & good

        return Compiled(fn, dst, frag=_f_by_code(child.frag, lut, ok))

    def _lut(self, values, tdt: torch.dtype) -> torch.Tensor:
        """A per-dictionary-code lookup table on the device (one neutral
        entry for an empty dictionary, whose codes are never valid)."""
        if isinstance(values, np.ndarray):
            if not values.size:
                values = np.zeros(1, dtype=values.dtype)
            return torch.from_numpy(np.require(values, requirements="CW")
                                    ).to(device=self.device, dtype=tdt)
        return torch.tensor(list(values) or [0], dtype=tdt,
                            device=self.device)

    def _compare_with_literal(self, name: str, col: Compiled, lit: str
                              ) -> Compiled:
        """``col <name> lit`` for a non-null string literal: Arrow compares
        each dictionary value with it (bytewise, as Spark orders strings)
        into a table of booleans."""
        def build():
            values = _text(col.dictionary)
            hits = _ARROW_CMP[name](values, pa.scalar(lit, values.type))
            return self._lut(np.asarray(hits.fill_null(False)), torch.bool)

        lut = self._cached([col.dictionary], ("cmp", name, lit), build)

        def fn(cols):
            d, v = col.fn(cols)
            hit = lut[d.long()]
            if name == "<=>":  # never null: a null value is not the literal
                return (hit if v is None else hit & v), None
            return hit, v

        frag = _f_by_code(col.frag, lut)
        if frag is not None and name == "<=>" and frag.nullable:
            frag = ch.op("band_nv", frag, ch.op(
                "isnotnull", col.frag, dtype=torch.bool, nullable=False),
                dtype=torch.bool, nullable=False)
        return Compiled(fn, dt.BooleanType(), frag=frag)

    def _unified_luts(self, dict_a: pa.Array, dict_b: pa.Array,
                      ordering: bool):
        """Both sides' codes into one dictionary's codes (its ranks when
        ``ordering``), as device tables."""
        merged, ra, rb = unify_dictionaries(dict_a, dict_b)
        if ordering:
            ranks = dictionary_ranks(merged)
            ra, rb = ranks[ra], ranks[rb]
        return self._lut(ra, torch.int32), self._lut(rb, torch.int32)

    # -- case ------------------------------------------------------------
    def _compile_case(self, r: rx.RCase) -> Compiled:
        branches = [(self.compile(c), self.compile(v)) for c, v in r.branches]
        else_c = self.compile(r.else_value) if r.else_value is not None else None
        if _is_str(r.dtype):
            return self._compile_case_string(r, branches, else_c)
        tdt = physical_torch_dtype(r.dtype)

        def fn(cols):
            if else_c is not None:
                acc, accv = else_c.fn(cols)
                acc = acc.to(tdt)
            else:
                acc = torch.zeros((), dtype=tdt, device=self.device)
                accv = torch.zeros((), dtype=torch.bool, device=self.device)
            for cond_c, val_c in reversed(branches):
                cd, cv = cond_c.fn(cols)
                cd = cd.bool()
                if cv is not None:
                    cd = cd & cv
                vd, vv = val_c.fn(cols)
                acc = torch.where(cd, vd.to(tdt), acc)
                if vv is not None or accv is not None:
                    new_v = vv if vv is not None else torch.ones_like(cd)
                    old_v = accv if accv is not None else torch.ones_like(cd)
                    accv = torch.where(cd, new_v, old_v)
            return acc, accv

        return Compiled(fn, r.dtype, frag=_f_case(
            branches, else_c, tdt, lambda c: ch.conv(c.frag, tdt)))

    def _compile_case_string(self, r: rx.RCase, branches, else_c
                             ) -> Compiled:
        """CASE over strings: the branches' dictionaries merge into one and
        each branch's codes remap into it."""
        dicts = [v.dictionary for _, v in branches]
        if else_c is not None:
            dicts.append(else_c.dictionary)

        def build():
            merged, remaps = _merge_dicts(dicts)
            return merged, [self._lut(rm, torch.int32) for rm in remaps]
        merged, luts = self._cached([d for d in dicts if d is not None],
                                    ("merge", tuple(d is None for d in dicts)),
                                    build)

        def fn(cols):
            if else_c is not None:
                acc, accv = else_c.fn(cols)
                acc = luts[-1][acc.long()]
            else:
                acc = torch.zeros((), dtype=torch.int32, device=self.device)
                accv = torch.zeros((), dtype=torch.bool, device=self.device)
            for i, (cond_c, val_c) in reversed(list(enumerate(branches))):
                cd, cv = cond_c.fn(cols)
                cd = cd.bool()
                if cv is not None:
                    cd = cd & cv
                vd, vv = val_c.fn(cols)
                acc = torch.where(cd, luts[i][vd.long()], acc)
                if vv is not None or accv is not None:
                    new_v = vv if vv is not None else torch.ones_like(cd)
                    old_v = accv if accv is not None else torch.ones_like(cd)
                    accv = torch.where(cd, new_v, old_v)
            return acc, accv

        remap = {id(c): lut for c, lut in
                 zip([v for _, v in branches] +
                     ([else_c] if else_c is not None else []), luts)}
        return Compiled(fn, r.dtype, merged, _f_case(
            branches, else_c, torch.int32,
            lambda c: _f_by_code(c.frag, remap[id(c)])))

    # -- calls -----------------------------------------------------------
    def _compile_call(self, r: rx.RCall) -> Compiled:
        if r.fn == "struct":
            return self._compile_struct(r)
        args = [self.compile(a) for a in r.args]
        if any(_is_str(a.dtype) for a in args):
            out = self._compile_string_call(r, args)
            if out is not None:
                return out
            if r.fn not in _FORMAT_ARG_FNS:
                raise _unported(r, f"function {r.fn!r} over strings")
        builder = _BUILDERS.get(r.fn)
        if builder is None:
            raise _unported(r, f"function {r.fn!r}")
        built = builder(args, r)
        fn, frag = built if isinstance(built, tuple) else (built, None)
        if frag is not None and any(a.frag is None for a in args):
            frag = None
        return Compiled(fn, r.dtype, frag=frag)

    def _compile_struct(self, r: rx.RCall) -> Compiled:
        """``struct(...)`` as its fields' columns (``StructData``), the
        arguments of a multi-argument host aggregate; no fragment, so its
        chain runs on the closures."""
        args = [self.compile(a) for a in r.args]
        dicts = [a.dictionary for a in args]
        literals = [a.value.value if isinstance(a, rx.RLit) else None
                    for a in r.args]

        def fn(cols):
            return StructData([a.fn(cols) for a in args], dicts,
                              literals), None
        return Compiled(fn, r.dtype)

    # -- string calls ------------------------------------------------------
    def _compile_string_call(self, r: rx.RCall, args: List[Compiled]
                             ) -> Optional[Compiled]:
        """A function with a string argument, as a lookup table over the
        dictionary codes; None when the function has no such form."""
        name, opts = r.fn, dict(r.options)

        def dict_of(a: Compiled) -> pa.Array:
            if a.dictionary is None:
                raise _unported(r, f"a string argument without a "
                                   f"dictionary in {name!r}")
            return a.dictionary

        def by_code(child: Compiled, lut: torch.Tensor, dtype: dt.DataType,
                    ok: Optional[torch.Tensor] = None) -> Compiled:
            def fn(cols):
                d, v = child.fn(cols)
                if ok is None:
                    return lut[d.long()], v
                good = ok[d.long()]
                return lut[d.long()], good if v is None else v & good
            return Compiled(fn, dtype, frag=_f_by_code(child.frag, lut, ok))

        if name in _CMP_OPS or name == "<=>":
            a, b = args
            if _is_str(a.dtype) and _is_str(b.dtype):
                lit = _string_literal(r.args[1]) if a.dictionary is not None \
                    else None
                if lit is not None:
                    return self._compare_with_literal(name, a, lit)
                lit = _string_literal(r.args[0]) if b.dictionary is not None \
                    else None
                if lit is not None:
                    return self._compare_with_literal(
                        _FLIPPED.get(name, name), b, lit)
                lut_a, lut_b = self._cached(
                    [dict_of(a), dict_of(b)], ("unify", name in _ORDERING),
                    lambda: self._unified_luts(a.dictionary, b.dictionary,
                                               name in _ORDERING))

                def fn(cols):
                    (ad, av), (bd, bv) = a.fn(cols), b.fn(cols)
                    x, y = lut_a[ad.long()], lut_b[bd.long()]
                    if name == "<=>":
                        return K.eq_null_safe((x, av), (y, bv))
                    return _CMP_OPS[name](x, y), K.merge_validity(av, bv)

                fx, fy = _f_by_code(a.frag, lut_a), _f_by_code(b.frag, lut_b)
                frag = None
                if fx is not None and fy is not None:
                    frag = ch.op("eqns", fx, fy, dtype=torch.bool,
                                 nullable=False) if name == "<=>" else \
                        ch.strict("cmp", fx, fy, dtype=torch.bool,
                                  imm=(name,))
                return Compiled(fn, dt.BooleanType(), frag=frag)
            # string vs non-string: parse the string side's dictionary
            sa, other = (a, b) if _is_str(a.dtype) else (b, a)
            if sa.dictionary is None or not other.dtype.physical_dtype:
                return None
            casted = self._cast_from_string(sa, other.dtype)
            x_c, y_c = (casted, other) if _is_str(a.dtype) else (other, casted)
            op = _CMP_OPS.get(name, torch.eq)  # the reference's "<=>" too

            def fn2(cols):
                (x, xv), (y, yv) = x_c.fn(cols), y_c.fn(cols)
                x, y = _promote(x, y)
                return op(x, y), K.merge_validity(xv, yv)

            frag = None
            if x_c.frag is not None and y_c.frag is not None:
                fx, fy = _f_promote(x_c.frag, y_c.frag)
                frag = ch.strict("cmp", fx, fy, dtype=torch.bool,
                                 imm=(name if name in _CMP_OPS else "==",))
            return Compiled(fn2, dt.BooleanType(), frag=frag)

        if name in ("like", "ilike", "rlike"):
            child, pat = args
            pat_dict = _dict_strings(dict_of(pat))
            if len(pat_dict) != 1:
                raise _unported(r, "a LIKE pattern that is not a literal")
            pattern, escape = pat_dict[0], opts.get("escape")
            values = dict_of(child)

            def build():
                if name == "rlike":
                    match = re.compile(_jre(pattern)).search
                    hits = [bool(v is not None and match(v))
                            for v in _dict_strings(values)]
                else:
                    hits = pc.match_like(
                        _text(values), _arrow_like(pattern, escape),
                        ignore_case=name == "ilike").fill_null(False)
                return self._lut(np.asarray(hits, dtype=bool), torch.bool)

            lut = self._cached([values], (name, pattern, escape), build)
            return by_code(child, lut, dt.BooleanType())

        if name == "in":
            child = args[0]
            if not _is_str(child.dtype):
                return None
            # a NULL item: the rows no item matches are NULL (Spark)
            items, null_item = set(), False
            for a in args[1:]:
                if _is_null_literal(a):
                    null_item = True
                else:
                    items.update(_dict_strings(dict_of(a)))
            values = dict_of(child)

            def build():
                text = _text(values)
                return self._lut(np.asarray(pc.is_in(
                    text, value_set=pa.array(sorted(items), type=text.type))),
                    torch.bool)

            lut = self._cached([values], ("in", tuple(sorted(items))), build)
            return by_code(child, lut, dt.BooleanType(),
                           lut if null_item else None)

        length = _ARROW_LENGTHS.get(name)
        if length is not None:
            values = dict_of(args[0])
            tdt = physical_torch_dtype(r.dtype)
            # no dictionary value is null
            lut = self._cached([values], name, lambda: self._lut(
                np.asarray(length(_text(values))), tdt))
            return by_code(args[0], lut, r.dtype)

        # dictionary transforms: apply to the dictionary values on the host
        transform = _STRING_TRANSFORMS.get(name)
        if transform is not None:
            child = args[0]
            extra = []
            for a in args[1:]:
                if _is_str(a.dtype):
                    ds = _dict_strings(dict_of(a))
                    if len(ds) != 1:
                        raise _unported(r, f"a non-literal string argument "
                                           f"to {name!r}")
                    extra.append(ds[0])
                else:
                    lit = _extract_literal(a)
                    if lit is None:
                        raise _unported(r, f"a non-literal argument to "
                                           f"{name!r}")
                    extra.append(lit)
            values = dict_of(child)
            if _is_str(r.dtype):
                # canonicalize: transforms can map distinct inputs to equal
                # outputs (substring!), and equality/grouping runs on codes —
                # re-encode and remap so equal strings share one code.
                def build():
                    new_dict, remap, null_out = _canonical_dict(
                        [None if v is None else transform(v, *extra)
                         for v in _dict_strings(values)])
                    return new_dict, self._lut(remap, torch.int32), \
                        None if null_out is None else \
                        self._lut(null_out, torch.bool)

                new_dict, lut, ok = self._cached([values],
                                                 (name, tuple(extra)), build)
                coded = by_code(child, lut, r.dtype, ok)
                return Compiled(coded.fn, r.dtype, new_dict, coded.frag)
            tdt = physical_torch_dtype(r.dtype)

            def build():
                out_vals = [None if v is None else transform(v, *extra)
                            for v in _dict_strings(values)]
                return (self._lut([0 if v is None else v for v in out_vals],
                                  tdt),
                        self._lut([v is not None for v in out_vals],
                                  torch.bool))

            lut, ok = self._cached([values], (name, tuple(extra)), build)
            return by_code(child, lut, r.dtype, ok)

        if name == "concat":
            return self._compile_concat(r, args, dict_of)
        return None

    def _compile_concat(self, r: rx.RCall, args: List[Compiled], dict_of
                        ) -> Compiled:
        """concat of literals and at most one string column: a new
        dictionary over the column's codes."""
        if len([a for a in args if a.dictionary is not None
                and len(a.dictionary) > 1]) > 1:
            raise _unported(r, "concat of several string columns")
        parts = []
        col = None
        for a in args:
            if len(dict_of(a)) == 1:
                parts.append(("lit", _dict_strings(a.dictionary)[0]))
            else:
                col = a
                parts.append(("col", None))
        if col is None:
            return self._compile_literal(
                LV.string("".join(p[1] or "" for p in parts)), r)
        out_dict = self._cached(
            [col.dictionary], ("concat", tuple(parts)),
            lambda: pa.array([None if v is None else
                              "".join(v if p[0] == "col" else (p[1] or "")
                                      for p in parts)
                              for v in _dict_strings(col.dictionary)],
                             type=pa.string()))

        def fn(cols):
            validity = K.merge_validity(*[a.fn(cols)[1] for a in args])
            return col.fn(cols)[0], validity

        frag = col.frag
        for a in args:
            if frag is None or a.frag is None:
                frag = None
            elif a is not col and a.frag.nullable:
                frag = ch.op("passv", frag, a.frag, dtype=frag.dtype,
                             nullable=True)
        return Compiled(fn, r.dtype, out_dict, frag)


def _string_literal(r: rx.Rex) -> Optional[str]:
    """The value of a non-null string literal, else None."""
    if isinstance(r, rx.RLit) and isinstance(r.dtype, dt.StringType):
        return r.value.value
    return None


def _extract_literal(c: Compiled):
    """The Python value of a compiled literal argument, else None."""
    try:
        d, v = c.fn([])
    except IndexError:  # it reads a column
        return None
    if d.dim() != 0 or (v is not None and not bool(v)):
        return None
    val = d.item()
    if isinstance(c.dtype, dt.DecimalType) and \
            c.dtype.physical_dtype == "int64":
        return val / (10 ** c.dtype.scale)
    return val


def _canonical_dict(values: List[Optional[str]]):
    """Deduplicate transformed dictionary values.

    Returns (dictionary, remap[int32], null_lut|None): codes map through
    ``remap``; positions whose transformed value is None are flagged via
    ``null_lut`` (False = null)."""
    uniq: Dict[str, int] = {}
    remap = np.empty(len(values), dtype=np.int32)
    has_null = False
    for i, v in enumerate(values):
        if v is None:
            has_null = True
            remap[i] = 0
            continue
        remap[i] = uniq.setdefault(v, len(uniq))
    dictionary = pa.array(list(uniq.keys()), type=pa.string())
    if len(dictionary) == 0:
        dictionary = pa.array([""], type=pa.string())
    null_lut = [v is not None for v in values] if has_null else None
    return dictionary, remap, null_lut


def _merge_dicts(dicts: List[Optional[pa.Array]]):
    """One dictionary over several; returns (merged, remap per input)."""
    all_vals: List[str] = []
    offsets = []
    for d in dicts:
        offsets.append(len(all_vals))
        if d is not None:  # NULL-typed branch: no dictionary
            all_vals.extend(_dict_strings(d))
    enc = pc.dictionary_encode(pa.array(all_vals, type=pa.string()))
    codes = np.asarray(enc.indices)
    remaps = []
    for off, d in zip(offsets, dicts):
        n = 0 if d is None else len(d)
        remaps.append(codes[off: off + n].astype(np.int32))
    return enc.dictionary, remaps


def _parse_string_value(s: Optional[str], target: dt.DataType):
    """(physical value, parsed) of a string cast to ``target``."""
    if s is None:
        return 0, False
    s = s.strip()
    try:
        if isinstance(target, (dt.ByteType, dt.ShortType, dt.IntegerType,
                               dt.LongType)):
            return int(s), True
        if isinstance(target, (dt.FloatType, dt.DoubleType)):
            return float(s), True
        if isinstance(target, dt.DecimalType):
            v = decimal.Decimal(s).scaleb(target.scale)
            if target.physical_dtype == "int64":
                return int(v.to_integral_value(
                    rounding=decimal.ROUND_HALF_UP)), True
            return float(s), True
        if isinstance(target, dt.BooleanType):
            if s.lower() in ("true", "t", "yes", "y", "1"):
                return True, True
            if s.lower() in ("false", "f", "no", "n", "0"):
                return False, True
            return False, False
        if isinstance(target, dt.DateType):
            return (datetime.date.fromisoformat(s[:10])
                    - datetime.date(1970, 1, 1)).days, True
        if isinstance(target, dt.TimestampType):
            v = datetime.datetime.fromisoformat(s)
            if v.tzinfo is None:
                from ..utils.tz import localize
                v = localize(v)  # session timezone (Spark semantics)
            return int(v.timestamp() * 1_000_000), True
    except (ValueError, ArithmeticError):
        return 0, False
    return 0, False


def _substring(v: str, start: int, length: Optional[int] = None) -> str:
    start = int(start)
    if start > 0:
        i = start - 1
    elif start == 0:
        i = 0
    else:
        i = max(len(v) + start, 0)
    if length is None:
        return v[i:]
    return v[i: i + int(length)]


_ARROW_CMP = {"==": pc.equal, "!=": pc.not_equal, "<": pc.less,
              "<=": pc.less_equal, ">": pc.greater, ">=": pc.greater_equal,
              "<=>": pc.equal}
_ORDERING = frozenset(("<", "<=", ">", ">="))
_FLIPPED = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
# the lengths of a dictionary's values, by Arrow's kernels: code points
# (Spark's length), UTF-8 bytes
_ARROW_LENGTHS: Dict[str, Callable] = {
    "length": pc.utf8_length,
    "char_length": pc.utf8_length,
    "character_length": pc.utf8_length,
    "octet_length": pc.binary_length,
    "bit_length": lambda a: pc.multiply(pc.binary_length(a), 8),
}
# functions whose string argument is a literal format, which their builder
# reads at bind time
_FORMAT_ARG_FNS = frozenset(("trunc", "date_trunc"))


# string dictionary transforms: name → fn(value, *extra) → value
_STRING_TRANSFORMS: Dict[str, Callable] = {
    "upper": lambda v: v.upper(),
    "ucase": lambda v: v.upper(),
    "lower": lambda v: v.lower(),
    "lcase": lambda v: v.lower(),
    "trim": lambda v, chars=None: v.strip(chars),
    "ltrim": lambda v, chars=None: v.lstrip(chars),
    "rtrim": lambda v, chars=None: v.rstrip(chars),
    "substring": _substring,
    "substr": _substring,
    "left": lambda v, n: v[: int(n)] if n >= 0 else "",
    "right": lambda v, n: v[-int(n):] if n > 0 else "",
    "replace": lambda v, search, rep="": v.replace(search, rep),
    "reverse": lambda v: v[::-1],
    "initcap": lambda v: v.title(),
    "ascii": lambda v: ord(v[0]) if v else 0,
    "lpad": lambda v, n, pad=" ": v.rjust(int(n), pad[0] if pad else " ")[: int(n)],
    "rpad": lambda v, n, pad=" ": v.ljust(int(n), pad[0] if pad else " ")[: int(n)],
    "repeat": lambda v, n: v * int(n),
    "startswith": lambda v, p: v.startswith(p),
    "endswith": lambda v, p: v.endswith(p),
    "contains": lambda v, p: p in v,
    "instr": lambda v, sub: v.find(sub) + 1,
    # NOTE arg order: position/locate take the needle first
    "position": lambda sub, v, pos=1: v.find(sub, max(int(pos) - 1, 0)) + 1,
    "locate": lambda sub, v, pos=1: v.find(sub, max(int(pos) - 1, 0)) + 1,
    "regexp_extract": lambda v, pat, idx=1: (
        (re.search(pat, v).group(int(idx)) if re.search(pat, v) else "")),
    "regexp_replace": lambda v, pat, rep: re.sub(pat, rep, v),
    "translate": lambda v, frm, to: v.translate(
        str.maketrans(frm[: len(to)], to[: len(frm)])),
    "space_trimmed_length": lambda v: len(v.rstrip()),
    "soundex": lambda v: _soundex(v),
    "md5": lambda v: hashlib.md5(v.encode()).hexdigest(),
    "sha1": lambda v: hashlib.sha1(v.encode()).hexdigest(),
    "sha2": lambda v, bits=256: hashlib.new(f"sha{int(bits) or 256}",
                                            v.encode()).hexdigest(),
}


def _soundex(s: str) -> str:
    """American Soundex, as Spark's ``soundex``: the first letter, then
    the codes of the letters after it, a code not repeated across
    neighbours (nor across an H or a W between them), padded or cut to
    four characters."""
    if not s:
        return s
    s = s.upper()
    codes = {"B": "1", "F": "1", "P": "1", "V": "1",
             "C": "2", "G": "2", "J": "2", "K": "2", "Q": "2", "S": "2",
             "X": "2", "Z": "2", "D": "3", "T": "3", "L": "4",
             "M": "5", "N": "5", "R": "6"}
    out = s[0]
    prev = codes.get(s[0], "")
    for ch in s[1:]:
        c = codes.get(ch, "")
        if c and c != prev:
            out += c
        if ch not in "HW":
            prev = c
    return (out + "000")[:4]


# ---------------------------------------------------------------------------
# temporal helpers (proleptic Gregorian; days since 1970-01-01)
# ---------------------------------------------------------------------------

def _utc_offset(us: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Per-value session-zone UTC offset (microseconds) for tz-aware
    timestamps; 0 otherwise. The zone's offset step function is applied
    with a searchsorted + gather."""
    if not (isinstance(d, dt.TimestampType) and d.timezone is not None):
        return torch.zeros_like(us)
    from ..utils.tz import session_timezone_name, utc_offset_transitions
    if session_timezone_name().upper() == "UTC":
        return torch.zeros_like(us)
    starts, offsets = utc_offset_transitions()
    starts = torch.from_numpy(starts).to(us.device)
    offsets = torch.from_numpy(offsets).to(us.device)
    return offsets[torch.searchsorted(starts, us, right=True) - 1]


def _local_us(data: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Session-zone local microseconds for tz-aware timestamps."""
    us = data.to(torch.int64)
    return us + _utc_offset(us, d)


def _to_days(data: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    if isinstance(d, dt.TimestampType):
        # floor-div towards -inf for pre-epoch correctness
        return torch.floor_divide(_local_us(data, d), 86_400_000_000)
    return data.to(torch.int64)


# ---------------------------------------------------------------------------
# builders: name → builder(args, rcall) → closure
# ---------------------------------------------------------------------------

_CMP_OPS = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def _decimal_scale(d: dt.DataType) -> Optional[int]:
    if isinstance(d, dt.DecimalType) and d.physical_dtype == "int64":
        return d.scale
    return None


def _promote(x: torch.Tensor, y: torch.Tensor):
    """Both operands in their common type. Torch lets a 0-d tensor (a
    literal here) lose to a column's narrower type; SQL typing does not."""
    t = torch.promote_types(x.dtype, y.dtype)
    return x.to(t), y.to(t)


def _spark_int(x: torch.Tensor, tdt: torch.dtype) -> torch.Tensor:
    """A float cast to an integer type as Spark's non-ANSI cast: toward
    zero, NaN 0, out of range saturated at a long's limits (BIGINT) or an
    int's (INT; SMALLINT and TINYINT then keep that int's low 16 or 8
    bits, as Spark's ``toInt(b).toShort``)."""
    x = x.to(torch.float64)
    if tdt == torch.int64:
        return NUM.saturating_long(x)
    return NUM.saturating_int(x).to(tdt)


# the integer digits a value of each integer type may hold
_INT_DIGITS = {dt.ByteType: 3, dt.ShortType: 5, dt.IntegerType: 10,
               dt.LongType: 19, dt.BooleanType: 1}


def _decimal_fit(src: dt.DataType, dst: dt.DataType):
    """The bound a cast of ``src`` to the decimal ``dst`` holds its value
    to (Spark gives NULL past the target's precision; NaN and the
    infinities fail it too), or None where no value of ``src`` can pass
    it (a widening cast: no check). The bound is on the unscaled int64
    before the scale is raised (|x| < bound) or after it is lowered and
    rounded; on the rounded scaled double of a float (also within int64's
    range); or on the value of a decimal held as a double (scale over
    6). An int64 holds at most 19 digits, so a decimal held in one past
    that is read as having 19."""
    if not isinstance(dst, dt.DecimalType):
        return None
    p, s = dst.precision, dst.scale
    src_scale = _decimal_scale(src)
    if src_scale is not None:  # rounding may add a digit
        src_digits = min(src.precision, 19) - src_scale + (src_scale > s)
    elif isinstance(src, dt.DecimalType):
        src_digits = src.precision - src.scale + (src.scale > s)
    elif isinstance(src, (dt.FloatType, dt.DoubleType)):
        src_digits = None
    elif type(src) in _INT_DIGITS:
        src_digits = _INT_DIGITS[type(src)]
    else:
        return None
    if src_digits is not None and src_digits <= p - s:
        return None
    if _decimal_scale(dst) is None:  # held as a double: its value
        return float(10 ** (p - s))
    if src_digits is None or src_scale is None and \
            isinstance(src, dt.DecimalType):  # a double: rounded, scaled
        return float(min(10 ** p, 1 << 63))
    up = s - (src_scale or 0)
    # lowered and rounded: the result; raised: the source before the
    # multiply (then under 10^18: a bound past 19 digits is none)
    return 10 ** p if up <= 0 else 10 ** max(p - up, 0)


def _within(x: torch.Tensor, bound) -> torch.Tensor:
    """-bound < x < bound (false at NaN)."""
    return (x < bound) & (x > -bound)


def _host_literal(c: Compiled) -> Optional[torch.Tensor]:
    """A literal operand's value as a 0-d host tensor (else None): the
    kernels read a scalar on the host, and this one needs no wait for the
    card."""
    f = c.frag
    return None if f is None or f.op != "const" else ch.host_value(f)[0]


def _is_null_literal(c: Compiled) -> bool:
    """``c`` is a NULL literal (its fragment a constant that is not
    valid)."""
    f = c.frag
    return f is not None and f.op == "const" and len(f.imm) == 2 and \
        not f.imm[1]


def _rescale_down(x: torch.Tensor, digits: int) -> torch.Tensor:
    """Divide an unscaled decimal by 10**digits, rounding half away from
    zero."""
    f = 10 ** digits
    return torch.sign(x) * ((torch.abs(x) + f // 2) // f)


# ---------------------------------------------------------------------------
# fragments: each mirrors its closure's torch ops, type for type
# ---------------------------------------------------------------------------

_F64 = torch.float64
_I64 = torch.int64
_DAY_US = 86_400_000_000


def _frags(*cs: Compiled):
    """The fragments of ``cs``, or None where one has none."""
    fs = [c.frag for c in cs]
    return None if any(f is None for f in fs) else fs


def _f_promote(x: ch.Frag, y: ch.Frag):
    """``_promote``: both in their common type."""
    t = torch.promote_types(x.dtype, y.dtype)
    return ch.conv(x, t), ch.conv(y, t)


def _f_times(x: ch.Frag, k) -> Optional[ch.Frag]:
    """``x * k`` for a Python number k, as torch computes it on an int64 or
    a float64 tensor (None for other types)."""
    if x.dtype == _I64 and isinstance(k, int):
        return ch.strict("mul", x, ch.const(k, _I64), dtype=_I64)
    if x.dtype == _F64:
        return ch.strict("mul", x, ch.const(float(k), _F64), dtype=_F64)
    return None


def _f_over(x: ch.Frag, k: float) -> ch.Frag:
    """``x.to(float64) / k`` (a true division)."""
    return ch.strict("div", ch.conv(x, _F64), ch.const(k, _F64), dtype=_F64)


def _zero_offset(d: dt.DataType) -> bool:
    """``_utc_offset`` is 0 for every value of ``d``."""
    return not (isinstance(d, dt.TimestampType) and d.timezone is not None) \
        or session_timezone_name().upper() == "UTC"


def _f_local_us(f: Optional[ch.Frag], d: dt.DataType) -> Optional[ch.Frag]:
    """``_local_us`` where the zone adds nothing (else no fragment)."""
    if f is None or not _zero_offset(d):
        return None
    return ch.conv(f, _I64)


def _f_floordiv(x: ch.Frag, k: int) -> ch.Frag:
    return ch.strict("floordiv", x, ch.const(k, _I64), dtype=_I64)


def _f_floormod(x: ch.Frag, k: int) -> ch.Frag:
    return ch.strict("floormod", x, ch.const(k, _I64), dtype=_I64)


def _f_to_days(f: Optional[ch.Frag], d: dt.DataType) -> Optional[ch.Frag]:
    """``_to_days``."""
    if f is None:
        return None
    if isinstance(d, dt.TimestampType):
        us = _f_local_us(f, d)
        return None if us is None else _f_floordiv(us, _DAY_US)
    return ch.conv(f, _I64)


def _f_cast(x: Optional[ch.Frag], src_scale, dst_scale, dst: dt.DataType,
            tdt: torch.dtype, fit) -> Optional[ch.Frag]:
    """``_compile_cast``'s numeric fn: a float to an integer through
    F2I/F2I32 (Spark's cast), a value past ``fit`` NULL."""
    if x is None:
        return None
    ok = None
    if src_scale is not None and dst_scale is None:
        x = _f_over(x, 10.0 ** src_scale)
    if dst_scale is not None:
        if src_scale is not None and dst_scale < src_scale:
            if x.dtype != _I64:
                return None
            x = ch.op("rescale", x, dtype=_I64, nullable=x.nullable,
                      imm=(src_scale - dst_scale,))
            ok = _f_within(x, fit)
        elif src_scale is not None or not ch.is_float(x.dtype):
            if src_scale is None:
                x = ch.conv(x, _I64)
            ok = _f_within(x, fit)
            up = dst_scale - (src_scale or 0)
            if up:
                x = _f_times(x, 10 ** up)
        else:
            y = _f_times(x, 10.0 ** dst_scale)
            if y is None:
                return None
            r = ch.op("rha_f", y, dtype=_F64, nullable=y.nullable)
            ok = _f_within(r, fit)
            x = ch.conv(r, _I64)
    elif isinstance(dst, dt.BooleanType):
        x = ch.op("ne0", x, dtype=torch.bool, nullable=x.nullable)
    elif fit is not None:  # a decimal held as a double
        ok = _f_within(ch.conv(x, _F64), fit)
    if x is None:
        return None
    if ok is not None:
        x = ch.op("andv", x, ok, dtype=x.dtype, nullable=True)
    return ch.conv(x, tdt)


def _f_within(x: ch.Frag, bound) -> Optional[ch.Frag]:
    """``_within``: -bound < x < bound, never NULL (None: no bound)."""
    if bound is None:
        return None
    lt = ch.strict("cmp", x, ch.const(bound, x.dtype), dtype=torch.bool,
                   imm=("<",))
    gt = ch.strict("cmp", x, ch.const(-bound, x.dtype), dtype=torch.bool,
                   imm=(">",))
    return ch.op("band_nv", lt, gt, dtype=torch.bool, nullable=False)


def _f_by_code(f: Optional[ch.Frag], lut: torch.Tensor,
               ok: Optional[torch.Tensor] = None) -> Optional[ch.Frag]:
    """``lut[code]``, NULL also where ``ok[code]`` is false."""
    if f is None or lut.dtype not in ch.TYPE_CODE:
        return None
    base = ch.op("lut", f, dtype=lut.dtype, nullable=f.nullable,
                 imm=(ch.Table(lut),))
    if ok is None:
        return base
    good = ch.op("lut", f, dtype=torch.bool, nullable=False,
                 imm=(ch.Table(ok),))
    return ch.op("andv", base, good, dtype=lut.dtype, nullable=True)


def _f_case(branches, else_c, tdt: torch.dtype, value) -> Optional[ch.Frag]:
    """CASE as selects from the last branch up: ``value(c)`` is a branch
    value's fragment in the result's type."""
    if else_c is not None:
        acc = None if else_c.frag is None else value(else_c)
    else:
        acc = ch.const_of(torch.zeros((), dtype=tdt),
                          torch.zeros((), dtype=torch.bool))
    for cond_c, val_c in reversed(branches):
        v = None if val_c.frag is None else value(val_c)
        if acc is None or v is None or cond_c.frag is None:
            return None
        acc = ch.op("select", cond_c.frag, v, acc, dtype=tdt,
                    nullable=acc.nullable or v.nullable)
    return acc


def _kernel_dtype(d: torch.dtype) -> torch.dtype:
    """The type ``functions/numeric.py`` reads a ``d`` column in."""
    if d in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return torch.int32
    if d in (torch.float16, torch.bfloat16, torch.float32):
        return _F64
    return d


def _binary_numeric(op: str):
    def build(args, r):
        a, b = args
        sa, sb = _decimal_scale(a.dtype), _decimal_scale(b.dtype)
        so = _decimal_scale(r.dtype)
        tdt = physical_torch_dtype(r.dtype)

        def fn(cols):
            (x, xv), (y, yv) = a.fn(cols), b.fn(cols)
            if op in ("+", "-") or op in _CMP_OPS:
                # align decimal scales
                if sa is not None or sb is not None:
                    s = max(sa or 0, sb or 0)
                    x = _to_scale(x, sa, s)
                    y = _to_scale(y, sb, s)
                    if x.is_floating_point() or y.is_floating_point():
                        x = x.to(torch.float64) / (10.0 ** s)
                        y = y.to(torch.float64) / (10.0 ** s)
            x, y = _promote(x, y)
            validity = K.merge_validity(xv, yv)
            if op in _CMP_OPS:
                return _CMP_OPS[op](x, y), validity
            if op == "+":
                res = x + y
            elif op == "-":
                res = x - y
            else:
                res = x * y
                if so is not None and (sa is not None or sb is not None):
                    extra = (sa or 0) + (sb or 0) - so
                    if extra > 0:
                        res = _rescale_down(res, extra)
            return res.to(tdt), validity

        return fn, _f_binary_numeric(op, a.frag, b.frag, sa, sb, so, tdt)

    return build


def _f_binary_numeric(op: str, x, y, sa, sb, so, tdt):
    if x is None or y is None:
        return None
    if op in ("+", "-") or op in _CMP_OPS:
        if sa is not None or sb is not None:
            s = max(sa or 0, sb or 0)
            x, y = _f_to_scale(x, sa, s), _f_to_scale(y, sb, s)
            if x is None or y is None:
                return None
            if ch.is_float(x.dtype) or ch.is_float(y.dtype):
                x, y = _f_over(x, 10.0 ** s), _f_over(y, 10.0 ** s)
    x, y = _f_promote(x, y)
    if op in _CMP_OPS:
        return ch.strict("cmp", x, y, dtype=torch.bool, imm=(op,))
    if x.dtype == torch.bool:
        return None
    res = ch.strict({"+": "add", "-": "sub", "*": "mul"}[op], x, y,
                    dtype=x.dtype)
    if op == "*" and so is not None and (sa is not None or sb is not None):
        extra = (sa or 0) + (sb or 0) - so
        if extra > 0:
            if res.dtype != _I64:
                return None
            res = ch.op("rescale", res, dtype=_I64, nullable=res.nullable,
                        imm=(extra,))
    return ch.conv(res, tdt)


def _f_to_scale(x: ch.Frag, scale: Optional[int], target: int):
    if scale is not None:
        return x if scale == target else _f_times(x, 10 ** (target - scale))
    if ch.is_float(x.dtype):
        return _f_times(x, 10 ** target)
    return _f_times(ch.conv(x, _I64), 10 ** target)


def _to_scale(x: torch.Tensor, scale: Optional[int], target: int):
    if scale is not None:
        return x if scale == target else x * (10 ** (target - scale))
    if x.is_floating_point():
        return x * (10 ** target)
    return x.to(torch.int64) * (10 ** target)


def _div_builder(args, r):
    a, b = args
    sa, sb = _decimal_scale(a.dtype), _decimal_scale(b.dtype)

    def fn(cols):
        (x, xv), (y, yv) = a.fn(cols), b.fn(cols)
        x = x.to(torch.float64) / (10.0 ** (sa or 0))
        y = y.to(torch.float64) / (10.0 ** (sb or 0))
        return K.div((x, xv), (y, yv))

    fs = _frags(a, b)
    frag = None if fs is None else ch.op(
        "sdiv", _f_over(fs[0], 10.0 ** (sa or 0)),
        _f_over(fs[1], 10.0 ** (sb or 0)), dtype=_F64, nullable=True)
    return fn, frag


def _date_arith(op: str):
    """date/timestamp ± interval; date ± int days."""
    sign = 1 if op == "+" else -1

    def build(args, r):
        a, b = args
        # canonical order: temporal on the left
        swap = isinstance(b.dtype, (dt.DateType, dt.TimestampType))
        t_dtype, o_dtype = (b.dtype, a.dtype) if swap else (a.dtype, b.dtype)

        def fn(cols):
            (xd, xv), (yd, yv) = a.fn(cols), b.fn(cols)
            val, amt = (yd, xd) if swap else (xd, yd)
            validity = K.merge_validity(xv, yv)
            if isinstance(o_dtype, dt.YearMonthIntervalType):
                days = _to_days(val, t_dtype)
                y, m, d = civil_from_days(days)
                months = y * 12 + (m - 1) + sign * amt.to(torch.int64)
                ny, nm = months // 12, months % 12 + 1
                # clamp day to month end
                out_days = days_from_civil(ny, nm,
                                           torch.minimum(d, _month_len(ny, nm)))
                if isinstance(t_dtype, dt.TimestampType):
                    tod = val - days * 86_400_000_000
                    return out_days * 86_400_000_000 + tod, validity
                return out_days.to(torch.int32), validity
            if isinstance(o_dtype, dt.DayTimeIntervalType):
                if isinstance(t_dtype, dt.TimestampType):
                    return val + sign * amt, validity
                us = val.to(torch.int64) * 86_400_000_000 + sign * amt
                return torch.floor_divide(us, 86_400_000_000).to(torch.int32), \
                    validity
            # date ± integer days
            return (val + sign * amt.to(val.dtype)).to(val.dtype), validity

        fs = _frags(a, b)
        if fs is None:
            return fn, None
        val, amt = (fs[1], fs[0]) if swap else (fs[0], fs[1])
        return fn, _f_date_arith(sign, val, amt, t_dtype, o_dtype)

    return build


def _f_date_arith(sign: int, val: ch.Frag, amt: ch.Frag,
                  t_dtype: dt.DataType, o_dtype: dt.DataType):
    nullable = val.nullable or amt.nullable
    if isinstance(o_dtype, dt.YearMonthIntervalType):
        days = _f_to_days(val, t_dtype)
        if days is None:
            return None
        out_days = ch.op("ymadd", days, ch.conv(amt, _I64), dtype=_I64,
                         nullable=nullable, imm=(sign,))
        if isinstance(t_dtype, dt.TimestampType):
            day = ch.const(_DAY_US, _I64)
            tod = ch.strict("sub", val, ch.strict("mul", days, day,
                                                  dtype=_I64), dtype=_I64)
            return ch.strict("add", ch.strict("mul", out_days, day,
                                              dtype=_I64), tod, dtype=_I64)
        return ch.conv(out_days, torch.int32)
    name = "add" if sign > 0 else "sub"
    if isinstance(o_dtype, dt.DayTimeIntervalType):
        if amt.dtype != _I64:
            return None
        if isinstance(t_dtype, dt.TimestampType):
            return None if val.dtype != _I64 else \
                ch.strict(name, val, amt, dtype=_I64)
        us = ch.strict(name, _f_times(ch.conv(val, _I64), _DAY_US), amt,
                       dtype=_I64)
        return ch.conv(_f_floordiv(us, _DAY_US), torch.int32)
    return ch.strict(name, val, ch.conv(amt, val.dtype), dtype=val.dtype)


def _temporal_field(which: str):
    def build(args, r):
        (a,) = args

        def fn(cols):
            xd, xv = a.fn(cols)
            days = _to_days(xd, a.dtype)
            y, m, d = civil_from_days(days)
            if which == "year":
                out = y
            elif which == "month":
                out = m
            elif which == "day":
                out = d
            elif which == "quarter":
                out = (m - 1) // 3 + 1
            elif which == "dayofweek":  # Sunday=1
                out = (days + 4) % 7 + 1
            elif which == "weekday":  # Monday=0
                out = (days + 3) % 7
            else:  # dayofyear
                out = days - days_from_civil(y, torch.ones_like(m),
                                             torch.ones_like(d)) + 1
            return out.to(torch.int32), xv

        days = _f_to_days(a.frag, a.dtype)
        return fn, None if days is None else ch.conv(ch.op(
            "datefield", days, dtype=_I64, nullable=days.nullable,
            imm=(which,)), torch.int32)

    return build


def _time_field(which: str):
    """hour, minute or second of a timestamp, in the session zone."""
    def build(args, r):
        a = args[0]

        def fn(cols):
            xd, xv = a.fn(cols)
            sec_of_day = torch.floor_divide(_local_us(xd, a.dtype),
                                            1_000_000) % 86_400
            if which == "hour":
                out = sec_of_day // 3600
            elif which == "minute":
                out = (sec_of_day // 60) % 60
            else:
                out = sec_of_day % 60
            return out.to(torch.int32), xv

        us = _f_local_us(a.frag, a.dtype)
        if us is None:
            return fn, None
        sec = _f_floormod(_f_floordiv(us, 1_000_000), 86_400)
        if which == "hour":
            out = _f_floordiv(sec, 3600)
        elif which == "minute":
            out = _f_floormod(_f_floordiv(sec, 60), 60)
        else:
            out = _f_floormod(sec, 60)
        return fn, ch.conv(out, torch.int32)

    return build


_DATE_TRUNC_FMTS = {"year", "yyyy", "yy", "quarter", "month", "mon", "mm",
                    "week", "day", "dd"}
_TIME_TRUNC_US = {"hour": 3_600_000_000, "minute": 60_000_000,
                  "second": 1_000_000, "millisecond": 1_000, "microsecond": 1}


def _trunc_builder(args, r):
    """trunc(date, fmt) / date_trunc(fmt, ts); fmt must be a literal and is
    read at bind time."""
    def build_fn(date_arg, fmt_arg, out_is_ts):
        fmt_vals = [] if fmt_arg.dictionary is None else \
            _dict_strings(fmt_arg.dictionary)
        if len(fmt_vals) != 1 or fmt_vals[0] is None:
            raise _unported(r, "a trunc format that is not a literal")
        fmt = fmt_vals[0].lower()
        if fmt not in _DATE_TRUNC_FMTS and \
                not (out_is_ts and fmt in _TIME_TRUNC_US):
            raise _unported(r, f"trunc format {fmt!r}")

        def fn(cols):
            xd, xv = date_arg.fn(cols)
            if out_is_ts and fmt in _TIME_TRUNC_US:
                unit = _TIME_TRUNC_US[fmt]
                us = xd.to(torch.int64)
                # truncate in LOCAL time (matters for fractional-offset
                # zones); the offset is constant within any sub-day unit
                off0 = _utc_offset(us, date_arg.dtype)
                return torch.floor_divide(us + off0, unit) * unit - off0, xv
            days = _to_days(xd, date_arg.dtype)
            y, m, d = civil_from_days(days)
            if fmt in ("year", "yyyy", "yy"):
                out_days = days_from_civil(y, torch.ones_like(m),
                                           torch.ones_like(d))
            elif fmt == "quarter":
                out_days = days_from_civil(y, ((m - 1) // 3) * 3 + 1,
                                           torch.ones_like(d))
            elif fmt in ("month", "mon", "mm"):
                out_days = days_from_civil(y, m, torch.ones_like(d))
            elif fmt == "week":
                out_days = days - (days + 3) % 7
            else:  # day / dd
                out_days = days
            if out_is_ts:
                # local midnight back to UTC with the offset AT THE
                # TRUNCATED BOUNDARY (one fixed-point step handles windows
                # that span a DST transition)
                local_mid = out_days * 86_400_000_000
                guess = local_mid - _utc_offset(xd.to(torch.int64),
                                                date_arg.dtype)
                return local_mid - _utc_offset(guess, date_arg.dtype), xv
            return out_days.to(torch.int32), xv

        return fn, _f_trunc(date_arg, fmt, out_is_ts)

    if isinstance(args[0].dtype, dt.TimestampType) or _is_str(args[0].dtype):
        # date_trunc(fmt, ts): fmt first
        return build_fn(args[1], args[0], out_is_ts=True)
    return build_fn(args[0], args[1], out_is_ts=False)


def _f_trunc(date_arg: Compiled, fmt: str, out_is_ts: bool):
    if date_arg.frag is None or not _zero_offset(date_arg.dtype):
        return None
    if out_is_ts and fmt in _TIME_TRUNC_US:
        unit = _TIME_TRUNC_US[fmt]
        return _f_times(_f_floordiv(ch.conv(date_arg.frag, _I64), unit),
                        unit)
    days = _f_to_days(date_arg.frag, date_arg.dtype)
    if fmt in ("year", "yyyy", "yy"):
        days = ch.op("truncdays", days, dtype=_I64, nullable=days.nullable,
                     imm=("year",))
    elif fmt in ("quarter", "month", "mon", "mm", "week"):
        days = ch.op("truncdays", days, dtype=_I64, nullable=days.nullable,
                     imm=({"mon": "month", "mm": "month"}.get(fmt, fmt),))
    if out_is_ts:
        return _f_times(days, _DAY_US)
    return ch.conv(days, torch.int32)


def _in_builder(args, r):
    """``x IN (items)`` as Spark evaluates it: TRUE where an item equals
    x; NULL where x is NULL, or where no item does and an item is NULL;
    else FALSE."""
    child, items = args[0], args[1:]
    s = _decimal_scale(child.dtype)

    def fn(cols):
        xd, xv = child.fn(cols)
        hit = torch.zeros(xd.shape, dtype=torch.bool, device=xd.device)
        unknown = None  # an item is NULL in the row
        for it in items:
            yd, yv = it.fn(cols)
            si = _decimal_scale(it.dtype)
            x, y = xd, yd
            if _in_doubles(x, s, y, si):
                if s is not None:
                    x = NUM._div(x.to(torch.float64), 10.0 ** s)
                if si is not None:
                    y = NUM._div(y.to(torch.float64), 10.0 ** si)
                x = x.to(torch.float64)
            elif s is not None or si is not None:
                sc = max(s or 0, si or 0)
                if s is not None:
                    x = x * (10 ** (sc - s))
                if si is not None:
                    y = y * (10 ** (sc - si))
            eq = x == y.to(x.dtype)
            if yv is not None:
                eq = eq & yv
                unknown = ~yv if unknown is None else unknown | ~yv
            hit = hit | eq
        if unknown is not None:
            known = hit | ~unknown
            xv = known if xv is None else xv & known
        return hit, xv

    return fn, _f_in(child, items, s)


def _in_doubles(x, s, y, si) -> bool:
    """IN compares x and an item as doubles where a decimal meets a
    float (a tensor or a fragment each; s, si: their decimal scales)."""
    def fl(v):
        return v.dtype.is_floating_point
    return (s is not None and fl(y)) or (si is not None and fl(x))


def _f_in(child: Compiled, items, s):
    """``_in_builder``'s fn. An item known on the host (a literal, or an
    expression of literals) is compared as its literal, converted there as
    the closure converts it; a NULL one leaves the rows no item matched
    NULL (one ANDV). Any other item (a column, a subquery's value, read
    when the kernel runs) joins by a Kleene OR of its comparison, which
    is NULL where the item is."""
    if child.frag is None:
        return None
    x0 = child.frag
    hit, null_item, rest = None, False, []
    for it in items:
        f = it.frag
        if f is not None and f.op == "const" and len(f.imm) > 2:
            rest.append(it)  # a subquery's value, an argument of the kernel
            continue
        if f is not None and f.op == "const":
            yd, yv = ch.host_value(f)  # no wait for the card
        else:
            try:
                yd, yv = it.fn([])
            except IndexError:  # it reads a column
                rest.append(it)
                continue
        if yd.dim() != 0:
            return None
        si = _decimal_scale(it.dtype)
        x, y = x0, yd
        if _in_doubles(x, s, y, si):
            if s is not None:
                x = _f_over(x, 10.0 ** s)
            if si is not None:
                y = NUM._div(y.to(torch.float64), 10.0 ** si)
            x = ch.conv(x, _F64)
        elif s is not None or si is not None:
            sc = max(s or 0, si or 0)
            if s is not None and sc != s:
                x = _f_times(x, 10 ** (sc - s))
            if si is not None:
                y = y * (10 ** (sc - si))
        if x is None:
            return None
        if yv is not None and not bool(yv):
            null_item = True  # matches no row
            continue
        lit = ch.const_of(y.to(x.dtype).cpu(), None)
        if lit is None:
            return None
        eq = ch.strict("cmp", x, lit, dtype=torch.bool, imm=("==",))
        hit = eq if hit is None else ch.strict("bor", hit, eq,
                                               dtype=torch.bool)
    if hit is None:
        hit = ch.const(False, torch.bool)
    out = ch.op("setv", hit, x0, dtype=torch.bool, nullable=x0.nullable)
    if null_item:
        out = ch.op("andv", out, hit, dtype=torch.bool, nullable=True)
    for it in rest:
        if it.frag is None:
            return None
        si = _decimal_scale(it.dtype)
        x, y = x0, it.frag
        if _in_doubles(x, s, y, si):
            if s is not None:
                x = _f_over(x, 10.0 ** s)
            if si is not None:
                y = _f_over(y, 10.0 ** si)
            x = ch.conv(x, _F64)
        elif s is not None or si is not None:
            sc = max(s or 0, si or 0)
            if s is not None and sc != s:
                x = _f_times(x, 10 ** (sc - s))
            if si is not None and sc != si:
                y = _f_times(y, 10 ** (sc - si))
        if x is None or y is None:
            return None
        eq = ch.strict("cmp", x, ch.conv(y, x.dtype), dtype=torch.bool,
                       imm=("==",))
        out = ch.strict("or3", out, eq, dtype=torch.bool)
    return out


def _rtf_member_builder(args, r):
    """A runtime join filter's exact key list (plan/runtime_filters.py
    ``bounds_conjuncts``), as a device membership test."""
    (a,) = args
    values = dict(r.options)["values"]

    def fn(cols):
        d, v = a.fn(cols)
        hit = torch.isin(d, torch.tensor(values, dtype=d.dtype,
                                         device=d.device))
        return hit, v

    return fn


def _math_unary(op: str):
    """K12 (``functions/numeric.py`` ``math_unary``) over one operand, a
    decimal read at its scale."""
    def build(args, r):
        (a,) = args
        scale = _decimal_scale(a.dtype) or 0
        tdt = physical_torch_dtype(r.dtype)

        def fn(cols):
            x, v = a.fn(cols)
            out, ok = NUM.math_unary(x, v, op, scale)
            return out.to(tdt), ok

        return fn, _f_math_unary(a.frag, op, scale, tdt)

    return build


def _f_math_unary(x: Optional[ch.Frag], op: str, scale: int, tdt):
    if x is None or not 0 <= scale <= 18 or x.dtype not in ch.TYPE_CODE:
        return None
    kt = _kernel_dtype(x.dtype)
    if op == "~" and ch.is_float(kt):
        return None
    if op in NUM.FLOAT_OPS:
        raw = _F64
    elif op in ("floor", "ceil"):
        raw = _I64
    elif op == "isnan":
        raw = torch.bool
    else:
        raw = kt
    nullable = True if op in NUM.LOG_OPS else \
        False if op == "isnan" else x.nullable
    return ch.conv(ch.op("num1", x, dtype=raw, nullable=nullable,
                         imm=(op, scale)), tdt)


def _math_binary(op: str):
    """K14 (``functions/numeric.py`` ``math_binary``) over two operands,
    each decimal read at its own scale."""
    def build(args, r):
        a, b = args
        sa, sb = _decimal_scale(a.dtype) or 0, _decimal_scale(b.dtype) or 0
        tdt = physical_torch_dtype(r.dtype)

        hx, hy = _host_literal(a), _host_literal(b)

        def fn(cols):
            (x, xv), (y, yv) = a.fn(cols), b.fn(cols)
            out, ok = NUM.math_binary(x if hx is None else hx, xv,
                                      y if hy is None else hy, yv, op, sa,
                                      sb)
            return out.to(tdt), ok

        return fn, _f_math_binary(a.frag, b.frag, op, sa, sb, tdt)

    return build


def _f_math_binary(x, y, op: str, sa: int, sb: int, tdt):
    if x is None or y is None or not (0 <= sa <= 18 and 0 <= sb <= 18) or \
            x.dtype not in ch.TYPE_CODE or y.dtype not in ch.TYPE_CODE:
        return None
    kx, ky = _kernel_dtype(x.dtype), _kernel_dtype(y.dtype)
    if op in NUM.BITWISE_OPS and (ch.is_float(kx) or ch.is_float(ky)):
        return None
    if op == "nanvl" and not ch.is_float(kx):
        return None
    raw = kx if op in NUM.BITWISE_OPS else _F64
    if op == "log":
        nullable = True
    else:
        nullable = x.nullable or y.nullable
    return ch.conv(ch.op("num2", x, y, dtype=raw, nullable=nullable,
                         imm=(op, sa, sb)), tdt)


def _log_builder(args, r):
    """log(x) is ln; log(base, x) is K14's log."""
    if len(args) == 1:
        return _math_unary("ln")(args, r)
    return _math_binary("log")(args, r)


def _nanvl_builder(args, r):
    a, b = args
    if not isinstance(a.dtype, (dt.DoubleType, dt.FloatType)):
        return a.fn, a.frag  # no NaN to replace
    return _math_binary("nanvl")(args, r)


def _round_builder(half_even: bool):
    """round (half up) and bround (half even): K13
    (``functions/numeric.py`` ``round_number``); digits a literal."""
    def build(args, r):
        a = args[0]
        digits = 0
        if len(args) > 1:
            lit = _extract_literal(args[1])
            if lit is None:
                raise _unported(r, "round digits that are not a literal")
            digits = int(lit)
        s = _decimal_scale(a.dtype)
        so = _decimal_scale(r.dtype)
        tdt = physical_torch_dtype(r.dtype)

        def fn(cols):
            x, v = a.fn(cols)
            if s is not None:
                out = NUM.round_number(x, half_even, digits, s,
                                       s if so is None else so)
            else:
                out = NUM.round_number(x, half_even, digits)
            return out.to(tdt), v

        in_s = 0 if s is None else s
        out_s = 0 if s is None else (s if so is None else so)
        frag = None
        if a.frag is not None and a.frag.dtype in ch.TYPE_CODE and \
                0 <= in_s <= 18 and 0 <= out_s <= 18 and \
                out_s - digits <= 18 and out_s >= in_s - 18:
            frag = ch.conv(ch.op(
                "round", a.frag, dtype=_kernel_dtype(a.frag.dtype),
                nullable=a.frag.nullable,
                imm=(half_even, digits, in_s, out_s)), tdt)
        return fn, frag

    return build


def _calendar_builder(op: str):
    """add_months, months_between, last_day, weekofyear: K15
    (``functions/numeric.py`` ``calendar``); a timestamp goes in as local
    microseconds."""
    def build(args, r):
        if op == "months_between" and len(args) != 2:
            raise _unported(r, "months_between with its roundOff flag")
        a = args[0]
        b = args[1] if len(args) > 1 else None

        def operand(c: Compiled, data: torch.Tensor):
            if isinstance(c.dtype, dt.TimestampType):
                return _local_us(data, c.dtype), True
            return data, False

        # a literal operand on the host (a timestamp's local µs made there)
        hx = _host_literal(a)
        hy = None if b is None else _host_literal(b)

        def fn(cols):
            xd, xv = a.fn(cols)
            x, x_us = operand(a, xd if hx is None else hx)
            if b is None:
                return NUM.calendar(x, xv, op, x_micros=x_us)
            yd, yv = b.fn(cols)
            yd = yd if hy is None else hy
            if op == "add_months":  # a count of months
                return NUM.calendar(x, xv, op, yd, yv, x_us)
            y, y_us = operand(b, yd)
            return NUM.calendar(x, xv, op, y, yv, x_us, y_us)

        return fn, _f_calendar(op, a, b)

    return build


def _f_calendar(op: str, a: Compiled, b: Optional[Compiled]):
    def operand(c: Compiled):
        if isinstance(c.dtype, dt.TimestampType):
            return _f_local_us(c.frag, c.dtype), True
        return c.frag, False

    x, xm = operand(a)
    y, ym = (None, False) if b is None else \
        (b.frag, False) if op == "add_months" else operand(b)
    if x is None or (b is not None and y is None):
        return None
    for f, micros in ((x, xm), (y, ym)):
        if f is not None and (f.dtype not in ch.TYPE_CODE or
                              ch.is_float(_kernel_dtype(f.dtype)) or
                              (micros and f.dtype != _I64)):
            return None
    raw = _F64 if op == "months_between" else torch.int32
    nullable = x.nullable or (y is not None and y.nullable)
    args = (x,) if y is None else (x, y)
    return ch.op("cal", *args, dtype=raw, nullable=nullable,
                 imm=(op, xm, ym))


def _day_arith(op: str):
    """datediff, date_add, date_sub: one integer subtraction or addition
    of days (torch ops)."""
    def build(args, r):
        a, b = args

        def fn(cols):
            (xd, xv), (yd, yv) = a.fn(cols), b.fn(cols)
            x, y = _to_days(xd, a.dtype), yd.to(torch.int64)
            if op == "datediff":
                y = _to_days(yd, b.dtype)
            out = x - y if op in ("datediff", "date_sub") else x + y
            return out.to(torch.int32), K.merge_validity(xv, yv)

        x = _f_to_days(a.frag, a.dtype)
        y = _f_to_days(b.frag, b.dtype) if op == "datediff" else \
            None if b.frag is None else ch.conv(b.frag, _I64)
        if x is None or y is None:
            return fn, None
        return fn, ch.conv(ch.strict(
            "sub" if op in ("datediff", "date_sub") else "add", x, y,
            dtype=_I64), torch.int32)

    return build


def _nvl2_builder(args, r):
    """nvl2(c, t, f): t where c is not NULL, else f (one select)."""
    cond, t, f = args
    tdt = physical_torch_dtype(r.dtype)

    def fn(cols):
        cd, cv = cond.fn(cols)
        not_null = torch.ones_like(cd, dtype=torch.bool) if cv is None \
            else cv
        (td, tv), (fd, fv) = t.fn(cols), f.fn(cols)
        return K.if_((not_null, None), (td.to(tdt), tv), (fd.to(tdt), fv))

    fs = _frags(cond, t, f)
    if fs is None:
        return fn, None
    fc, ft, ff = fs
    return fn, ch.op("select", ch.op("isnotnull", fc, dtype=torch.bool,
                                     nullable=False),
                     ch.conv(ft, tdt), ch.conv(ff, tdt), dtype=tdt,
                     nullable=ft.nullable or ff.nullable)


def _sample_mask_builder(args, r):
    """TABLESAMPLE's row mask: splitmix64 of the row index and the seed
    (``functions/numeric.py`` ``sample_mask``, torch ops)."""
    frac_c, seed_c = args
    fraction, seed = _extract_literal(frac_c), _extract_literal(seed_c)
    if fraction is None or seed is None:
        raise _unported(r, "a sample fraction or seed that is not a literal")

    def fn(cols):
        n = cols[0][0].shape[0] if cols else 8
        device = cols[0][0].device if cols else torch.device("cpu")
        return NUM.sample_mask(n, float(fraction), int(seed), device), None

    return fn


def _strict1(k, frag=None):
    def build(args, r):
        (a,) = args
        fn = lambda cols: k(a.fn(cols))  # noqa: E731
        return fn, None if frag is None or a.frag is None else frag(a.frag)
    return build


def _strict2(k, frag=None):
    def build(args, r):
        a, b = args
        fn = lambda cols: k(a.fn(cols), b.fn(cols))  # noqa: E731
        fs = _frags(a, b)
        return fn, None if frag is None or fs is None else frag(*fs)
    return build


def _variadic(k, frag=None):
    def build(args, r):
        fn = lambda cols: k(*[a.fn(cols) for a in args])  # noqa: E731
        fs = _frags(*args)
        return fn, None if frag is None or fs is None else frag(*fs)
    return build


def _same(*fs: ch.Frag) -> bool:
    return all(f.dtype == fs[0].dtype for f in fs)


def _f_int_div(x, y):
    """``K.int_div``."""
    if not _same(x, y):
        return None
    q = ch.op("sdiv", x, y, dtype=x.dtype, nullable=True)
    return ch.conv(q, _I64) if ch.is_float(x.dtype) else q


def _f_mod(x, y):
    return ch.op("smod", x, y, dtype=x.dtype, nullable=True) \
        if _same(x, y) else None


def _f_pmod(x, y):
    m = _f_mod(x, y)
    return None if m is None else ch.op("pmodfix", m, y, dtype=x.dtype,
                                        nullable=True)


def _f_kleene(name):
    return lambda x, y: ch.strict(name, x, y, dtype=torch.bool)


def _f_coalesce(*fs):
    acc = fs[-1]
    for f in reversed(fs[:-1]):
        c = ch.conv(f, acc.dtype)
        acc = c if not f.nullable else ch.op(
            "selv", c, acc, dtype=acc.dtype, nullable=acc.nullable)
    return acc


def _f_if(c, t, f):
    return ch.op("select", c, ch.conv(t, f.dtype), f, dtype=f.dtype,
                 nullable=t.nullable or f.nullable)


def _f_extreme(is_max: bool):
    def build(*fs):
        if not _same(*fs):
            return None
        acc = fs[0]
        for f in fs[1:]:
            acc = ch.op("ext", acc, f, dtype=acc.dtype,
                        nullable=acc.nullable or f.nullable, imm=(is_max,))
        return acc
    return build


_BUILDERS: Dict[str, Callable] = {
    "+": _binary_numeric("+"),
    "-": _binary_numeric("-"),
    "*": _binary_numeric("*"),
    "==": _binary_numeric("=="),
    "!=": _binary_numeric("!="),
    "<": _binary_numeric("<"),
    "<=": _binary_numeric("<="),
    ">": _binary_numeric(">"),
    ">=": _binary_numeric(">="),
    "/": _div_builder,
    "div": _strict2(K.int_div, _f_int_div),
    "%": _strict2(K.mod, _f_mod),
    "pmod": _strict2(K.pmod, _f_pmod),
    "and": _strict2(K.kleene_and, _f_kleene("and3")),
    "or": _strict2(K.kleene_or, _f_kleene("or3")),
    "not": _strict1(K.not_, lambda x: ch.op("not", x, dtype=torch.bool,
                                            nullable=x.nullable)),
    "isnull": _strict1(K.isnull, lambda x: ch.op(
        "isnull", x, dtype=torch.bool, nullable=False)),
    "isnotnull": _strict1(K.isnotnull, lambda x: ch.op(
        "isnotnull", x, dtype=torch.bool, nullable=False)),
    "coalesce": _variadic(K.coalesce, _f_coalesce),
    "nullif": _strict2(K.nullif, lambda x, y: ch.op(
        "nullif", x, y, dtype=x.dtype, nullable=True) if _same(x, y)
        else None),
    "if": _variadic(K.if_, _f_if),
    "greatest": _variadic(K.greatest, _f_extreme(True)),
    "least": _variadic(K.least, _f_extreme(False)),
    "<=>": _strict2(K.eq_null_safe, lambda x, y: ch.op(
        "eqns", x, y, dtype=torch.bool, nullable=False) if _same(x, y)
        else None),
    "date+interval": _date_arith("+"),
    "date-interval": _date_arith("-"),
    "in": _in_builder,
    "year": _temporal_field("year"),
    "month": _temporal_field("month"),
    "day": _temporal_field("day"),
    "dayofmonth": _temporal_field("day"),
    "quarter": _temporal_field("quarter"),
    "dayofweek": _temporal_field("dayofweek"),
    "weekday": _temporal_field("weekday"),
    "dayofyear": _temporal_field("dayofyear"),
    "hour": _time_field("hour"),
    "minute": _time_field("minute"),
    "second": _time_field("second"),
    "trunc": _trunc_builder,
    "date_trunc": _trunc_builder,
    "rtf_member": _rtf_member_builder,
    "datediff": _day_arith("datediff"),
    "date_add": _day_arith("date_add"),
    "date_sub": _day_arith("date_sub"),
    "round": _round_builder(half_even=False),
    "bround": _round_builder(half_even=True),
    "log": _log_builder,
    "nanvl": _nanvl_builder,
    "nvl2": _nvl2_builder,
    "sample_mask": _sample_mask_builder,
}
_BUILDERS.update({op: _math_unary(op) for op in NUM.UNARY_OPS})
_BUILDERS.update({op: _math_binary(op) for op in NUM.BINARY_OPS
                  if op not in ("log", "nanvl")})
_BUILDERS.update({op: _calendar_builder(op) for op in NUM.CALENDAR_OPS})
# Spark's other names
_BUILDERS.update({"ceiling": _BUILDERS["ceil"], "signum": _BUILDERS["sign"],
                  "week": _BUILDERS["weekofyear"]})
