"""Function registry: Spark function names → type inference.

Reference role: sail-plan's function registry binding ~392 Spark names to
typed implementations (crates/sail-plan/src/function/). Here the registry
owns *type inference* (and agg classification); device kernels live in
plan/compiler.py keyed by the same names.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..spec import data_type as dt

# Aggregate function names the resolver extracts from expressions.
AGGREGATE_FUNCTIONS = {
    "sum", "count", "avg", "mean", "min", "max", "first", "first_value",
    "last", "last_value", "any_value", "bool_and", "every", "bool_or", "any",
    "some", "stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
    "var_pop", "count_if", "sum_distinct", "approx_count_distinct",
    "collect_list", "collect_set", "corr", "covar_samp", "covar_pop",
    "skewness", "kurtosis", "median", "mode", "percentile",
    "percentile_approx", "max_by", "min_by", "product", "try_sum", "try_avg",
    "bit_and", "bit_or", "bit_xor", "histogram_numeric", "grouping",
}

WINDOW_FUNCTIONS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
    "lag", "lead", "nth_value",
}


def is_aggregate(name: str) -> bool:
    n = name.lower()
    if n in AGGREGATE_FUNCTIONS:
        return True
    # the sketch aggregates (the reference's functions/sketches.py) are
    # not ported yet: HOST_AGGS holds none of them
    from .host_aggregates import HOST_AGGS
    return n in HOST_AGGS


def is_window(name: str) -> bool:
    return name.lower() in WINDOW_FUNCTIONS


_D = dt


def _widen_sum(t: dt.DataType) -> dt.DataType:
    if isinstance(t, dt.DecimalType):
        return dt.DecimalType(min(t.precision + 10, 38), t.scale)
    if t.is_integer:
        return dt.LongType()
    if isinstance(t, dt.FloatType):
        return dt.DoubleType()
    return t


def sum_result_type(t: dt.DataType) -> dt.DataType:
    return _widen_sum(t)


def avg_result_type(t: dt.DataType) -> dt.DataType:
    # Spark: avg(decimal(p,s)) → decimal(p+4, s+4); v0 computes double.
    return dt.DoubleType()


_NUMERIC_BIN = {"+", "-", "*", "/", "%", "div", "pmod", "power"}
_CMP = {"==", "!=", "<", "<=", ">", ">=", "<=>"}
_BOOL_FNS = {"and", "or", "not", "isnull", "isnotnull", "like", "ilike",
             "rlike", "in", "startswith", "endswith", "contains",
             "equal_null", "isnotnan"}
_FLOAT_FNS = {"sqrt", "exp", "ln", "log10", "log2", "log", "sin", "cos",
              "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
              "degrees", "radians", "cbrt", "log1p", "expm1", "rint",
              "hypot"}
_INT_FIELD_FNS = {"year", "month", "day", "dayofmonth", "quarter",
                  "dayofweek", "weekday", "dayofyear", "hour", "minute",
                  "second", "weekofyear", "week", "length", "char_length",
                  "character_length", "ascii", "instr", "bit_length",
                  "octet_length", "position", "locate"}
_STRING_FNS = {"upper", "ucase", "lower", "lcase", "trim", "ltrim", "rtrim",
               "substring", "substr", "left", "right", "replace", "reverse",
               "initcap", "lpad", "rpad", "repeat", "concat", "translate",
               "regexp_replace", "regexp_extract", "md5", "sha1", "sha2",
               "soundex", "concat_ws", "format_string", "lcase"}


def infer_function_type(name: str, arg_types: Sequence[dt.DataType]) -> dt.DataType:
    """Result type of a scalar function; raises TypeError when unsupported."""
    name = name.lower()
    if name in _CMP or name in _BOOL_FNS:
        return dt.BooleanType()
    if name in ("+", "-"):
        a, b = arg_types
        temporal = (dt.DateType, dt.TimestampType)
        interval = (dt.DayTimeIntervalType, dt.YearMonthIntervalType,
                    dt.CalendarIntervalType)
        if isinstance(a, temporal) or isinstance(b, temporal):
            t = a if isinstance(a, temporal) else b
            o = b if isinstance(a, temporal) else a
            if isinstance(o, interval):
                return t
            if isinstance(o, dt.StringType):
                return t
            if name == "-" and isinstance(a, dt.DateType) and isinstance(b, dt.DateType):
                return dt.IntegerType()
            if o.is_integer and isinstance(t, dt.DateType):
                return t
        if isinstance(a, interval) and isinstance(b, interval) and type(a) == type(b):
            return a
    if name in _NUMERIC_BIN:
        a, b = arg_types
        if name == "/":
            if isinstance(a, dt.DecimalType) or isinstance(b, dt.DecimalType):
                return dt.DoubleType()
            return dt.DoubleType()
        if name == "div":
            return dt.LongType()
        out = dt.common_type(a, b)
        if name == "*" and isinstance(out, dt.DecimalType):
            sa = a.scale if isinstance(a, dt.DecimalType) else 0
            sb = b.scale if isinstance(b, dt.DecimalType) else 0
            pa_ = a.precision if isinstance(a, dt.DecimalType) else 10
            pb = b.precision if isinstance(b, dt.DecimalType) else 10
            # Spark: (p1+p2+1, s1+s2) capped; keep scale workable for int64
            return dt.DecimalType(min(pa_ + pb + 1, 38), min(sa + sb, 6))
        if name in ("+", "-") and isinstance(out, dt.DecimalType):
            sa = a.scale if isinstance(a, dt.DecimalType) else 0
            sb = b.scale if isinstance(b, dt.DecimalType) else 0
            return dt.DecimalType(min(max(a.precision if isinstance(a, dt.DecimalType) else 11,
                                          b.precision if isinstance(b, dt.DecimalType) else 11) + 1, 38),
                                  max(sa, sb))
        if name == "power":
            return dt.DoubleType()
        return out
    if name in _FLOAT_FNS:
        return dt.DoubleType()
    if name == "atan2":
        return dt.DoubleType()
    if name in _INT_FIELD_FNS:
        return dt.IntegerType()
    # concat/reverse over arrays keep the array type
    if name == "concat" and any(isinstance(t, dt.ArrayType)
                                for t in arg_types):
        out = arg_types[0]
        for t in arg_types[1:]:
            if isinstance(t, dt.ArrayType) and isinstance(out, dt.ArrayType):
                try:
                    out = dt.ArrayType(dt.common_type(
                        out.element_type, t.element_type), True)
                except TypeError:
                    pass
        return out
    if name == "reverse" and isinstance(arg_types[0], dt.ArrayType):
        return arg_types[0]
    if name in _STRING_FNS:
        return dt.StringType()
    if name in ("abs", "negative"):
        return arg_types[0]
    if name in ("floor", "ceil", "ceiling"):
        return dt.LongType() if not isinstance(arg_types[0], dt.DecimalType) \
            else dt.DecimalType(arg_types[0].precision, 0)
    if name == "round" or name == "bround":
        return arg_types[0]
    if name == "sign" or name == "signum":
        return dt.DoubleType()
    if name == "isnan":
        return dt.BooleanType()
    if name == "nanvl":
        return arg_types[0]
    if name == "nvl2":
        return dt.common_type(arg_types[1], arg_types[2])
    if name in ("coalesce", "nullif", "nvl", "ifnull", "greatest", "least"):
        out = arg_types[0]
        for t in arg_types[1:]:
            if not isinstance(t, dt.NullType):
                out = t if isinstance(out, dt.NullType) else dt.common_type(out, t)
        return out
    if name == "if":
        return dt.common_type(arg_types[1], arg_types[2])
    if name in ("shiftleft", "shiftright", "&", "|", "^", "~"):
        return arg_types[0]
    if name in ("datediff", "date_diff"):
        return dt.IntegerType()
    if name in ("date_add", "date_sub", "last_day", "next_day", "to_date", "trunc"):
        return dt.DateType()
    if name in ("add_months",):
        return dt.DateType()
    if name in ("months_between",):
        return dt.DoubleType()
    if name in ("date_trunc", "to_timestamp"):
        return dt.TimestampType("UTC")
    if name in ("unix_timestamp", "to_unix_timestamp"):
        return dt.LongType()
    if name in ("current_date",):
        return dt.DateType()
    if name in ("current_timestamp", "now"):
        return dt.TimestampType("UTC")
    if name in ("current_user", "current_catalog", "current_schema",
                "current_database", "version", "user", "session_user"):
        return dt.StringType()
    if name in ("pow",):
        return dt.DoubleType()
    if name in ("mod",):
        return dt.common_type(*arg_types) if len(arg_types) == 2 \
            else arg_types[0]
    if name == "std":
        return dt.DoubleType()
    if name in ("rand", "random", "randn"):
        return dt.DoubleType()
    if name in ("hash",):
        return dt.IntegerType()
    if name in ("xxhash64",):
        return dt.LongType()
    if name in ("crc32",):
        return dt.LongType()
    if name in ("monotonically_increasing_id", "spark_partition_id"):
        return dt.LongType() if name == "monotonically_increasing_id" else dt.IntegerType()
    host = host_fn(name)
    if host is not None:
        return host.type_fn(list(arg_types))
    raise TypeError(f"unknown function {name!r} for types "
                    f"{[t.simple_string() for t in arg_types]}")


def host_fn(name: str):
    """Host-evaluated function lookup (arrays/maps/structs/json/url/...).
    None of them is ported yet."""
    return None


def aggregate_result_type(fn: str, arg_type: Optional[dt.DataType]) -> dt.DataType:
    fn = fn.lower()
    if fn == "count" or fn == "count_if" or fn == "approx_count_distinct":
        return dt.LongType()
    if fn == "sum" or fn == "try_sum" or fn == "product":
        return sum_result_type(arg_type)
    if fn in ("avg", "mean", "try_avg", "median", "percentile",
              "percentile_approx"):
        return avg_result_type(arg_type)
    if fn in ("min", "max", "first", "first_value", "last", "last_value",
              "any_value", "max_by", "min_by", "mode"):
        return arg_type
    if fn in ("bool_and", "every", "bool_or", "any", "some"):
        return dt.BooleanType()
    if fn in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
              "var_pop", "corr", "covar_samp", "covar_pop", "skewness",
              "kurtosis"):
        return dt.DoubleType()
    if fn in ("bit_and", "bit_or", "bit_xor"):
        return arg_type
    if fn == "grouping":
        return dt.ByteType()
    raise TypeError(f"unknown aggregate {fn!r}")
