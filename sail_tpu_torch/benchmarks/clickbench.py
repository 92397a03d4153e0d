"""ClickBench: the 43-query web-analytics suite over a synthetic hits
table.

The reference's queries (``data/clickbench_queries.sql``, the public
suite) over a generated table with the real dataset's schema: wide fact
rows, near-unique strings (URL, Title) and heavy-hitter users. The real
dataset has 99,997,497 rows of ClickHouse web logs; ``generate_hits``
makes a table of the same columns at any row count.

``generate_hits(n, seed)`` draws the same random numbers in the same
order as ``sail_tpu/benchmarks/clickbench.py`` and returns an equal table;
it builds the string columns with Arrow compute kernels over the drawn
integers instead of numpy's fixed-width unicode arrays, so 100M rows fit
in host memory. ``dictionary=True`` returns the string columns
dictionary-encoded (as a Parquet reader with dictionary pages gives
them), built from the integers without materializing a string per row.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

QUERIES_PATH = os.path.join(os.path.dirname(__file__), "data",
                            "clickbench_queries.sql")

# the rows ClickBench's published hits dataset holds
PUBLISHED_ROWS = 99_997_497

_PHRASES = np.array(
    ["", "", "", "", "", "", "",  # most hits have no search phrase
     "weather", "news today", "cat videos", "python tutorial",
     "cheap flights", "karelia wood", "holiday photos"])
_MOBILE_MODELS = np.array(["", "", "", "iPhone", "Galaxy S4", "Nexus 4",
                           "Lumia 920"])
_HOSTS = 500
# rows per Arrow chunk of a string column (int32 offsets hold 2 GiB)
_CHUNK = 1 << 22


# queries over hits that run the aggregate tail's mechanisms (string
# MIN/MAX, DISTINCT beside other aggregates, the time fields and
# truncation, bool_and/bool_or) where the suite's own queries that use
# them return no rows (Q22, Q23 and Q24 filter on "google", which no
# generated URL or Title holds; Q29 needs 100,000 rows a key; Q39, Q40
# and Q43 cut a CounterID's slice with OFFSET 1000), each under the
# grouping it takes
_TS = "CAST(EventTime AS TIMESTAMP)"
MECHANISM_QUERIES = {
    # Q23 without its Title filter: string MIN and COUNT(DISTINCT) under
    # direct grouping
    "q23_all_titles":
        "SELECT SearchPhrase, MIN(URL), MIN(Title), COUNT(*) AS c, "
        "COUNT(DISTINCT UserID) FROM hits WHERE URL NOT LIKE '%.google.%' "
        "AND SearchPhrase <> '' GROUP BY SearchPhrase ORDER BY c DESC "
        "LIMIT 10",
    # Q22 without its URL filter
    "q22_all_urls":
        "SELECT SearchPhrase, MIN(URL), COUNT(*) AS c FROM hits WHERE "
        "SearchPhrase <> '' GROUP BY SearchPhrase ORDER BY c DESC LIMIT 10",
    # sort-based grouping: string MIN/MAX, DISTINCT over a string and an
    # integer column
    "users":
        "SELECT UserID, MIN(URL), MAX(SearchPhrase), COUNT(DISTINCT "
        "SearchPhrase), SUM(DISTINCT RegionID), COUNT(*) FROM hits GROUP BY "
        "UserID ORDER BY COUNT(*) DESC, UserID LIMIT 10",
    # keyless: every DISTINCT form beside plain aggregates
    "distinct_keyless":
        "SELECT COUNT(DISTINCT UserID), COUNT(*), SUM(DISTINCT AdvEngineID), "
        "AVG(DISTINCT ResolutionWidth), MIN(URL), MAX(Title) FROM hits",
    # Q29 at a threshold the test sizes reach, with MAX as well
    "q29_small":
        "SELECT REGEXP_REPLACE(Referer, '^https?://(?:www\\.)?([^/]+)/.*$', "
        "'$1') AS k, AVG(length(Referer)) AS l, COUNT(*) AS c, "
        "MIN(Referer), MAX(Referer) FROM hits WHERE Referer <> '' GROUP BY k "
        "HAVING COUNT(*) > 100 ORDER BY l DESC LIMIT 25",
    # Q28 at a threshold the test sizes reach
    "q28_small":
        "SELECT CounterID, AVG(length(URL)) AS l, COUNT(*) AS c FROM hits "
        "WHERE URL <> '' GROUP BY CounterID HAVING COUNT(*) > 10 "
        "ORDER BY l DESC, CounterID LIMIT 25",
    # Q43 without CounterID = 62
    "q43_all_counters":
        f"SELECT DATE_TRUNC('minute', {_TS}) AS M, COUNT(*) AS PageViews "
        f"FROM hits WHERE EventDate >= '2013-07-14' AND EventDate <= "
        f"'2013-07-15' AND IsRefresh = 0 AND DontCountHits = 0 GROUP BY "
        f"DATE_TRUNC('minute', {_TS}) ORDER BY DATE_TRUNC('minute', {_TS}) "
        f"LIMIT 10 OFFSET 1000",
    # Q39 and Q40 without CounterID = 62, their ties broken by the keys:
    # a grouping by near-unique URLs (and Q40's CASE over Referer) cut by
    # OFFSET 1000
    "q39_all_counters":
        "SELECT URL, COUNT(*) AS PageViews FROM hits WHERE EventDate >= "
        "'2013-07-01' AND EventDate <= '2013-07-31' AND IsRefresh = 0 AND "
        "IsLink <> 0 AND IsDownload = 0 GROUP BY URL ORDER BY PageViews "
        "DESC, URL LIMIT 10 OFFSET 1000",
    "q40_all_counters":
        "SELECT TraficSourceID, SearchEngineID, AdvEngineID, CASE WHEN "
        "(SearchEngineID = 0 AND AdvEngineID = 0) THEN Referer ELSE '' END "
        "AS Src, URL AS Dst, COUNT(*) AS PageViews FROM hits WHERE "
        "EventDate >= '2013-07-01' AND EventDate <= '2013-07-31' AND "
        "IsRefresh = 0 GROUP BY TraficSourceID, SearchEngineID, AdvEngineID, "
        "Src, Dst ORDER BY PageViews DESC, Dst, Src, TraficSourceID, "
        "SearchEngineID, AdvEngineID LIMIT 10 OFFSET 1000",
    # the time fields and truncation, grouped by hour
    "time_of_day":
        f"SELECT hour({_TS}) AS h, COUNT(*) AS c, SUM(minute({_TS})), "
        f"SUM(second({_TS})), MIN(date_trunc('hour', {_TS})), "
        f"MAX(date_trunc('week', {_TS})), MAX(trunc(EventDate, 'month')) "
        f"FROM hits GROUP BY hour({_TS}) ORDER BY h",
    # bool_and/bool_or under sort-based, direct and keyless grouping
    "bool_by_region":
        "SELECT RegionID, bool_and(IsRefresh = 0), bool_or(AdvEngineID <> 0), "
        "COUNT(*) AS c FROM hits GROUP BY RegionID ORDER BY c DESC, RegionID "
        "LIMIT 10",
    "bool_by_model":
        "SELECT MobilePhoneModel, bool_and(IsLink = 0), bool_or(IsDownload "
        "<> 0) FROM hits GROUP BY MobilePhoneModel ORDER BY MobilePhoneModel",
    "bool_keyless":
        "SELECT bool_and(ResolutionWidth >= 0), bool_or(IsRefresh = 2) "
        "FROM hits",
    # LIKE's wildcards and ILIKE through Arrow's kernel
    "like_wildcards":
        "SELECT COUNT(*), SUM(IsLink) FROM hits WHERE URL LIKE "
        "'%site1_.example/page?id=1%' OR Title ILIKE 'PAGE TITLE 7%'",
}


def load_queries() -> List[str]:
    with open(QUERIES_PATH, "r", encoding="utf-8") as f:
        text = f.read()
    return [q.strip() for q in text.split(";") if q.strip()]


def _decimal(ints: np.ndarray, string_type) -> pa.Array:
    return pc.cast(pa.array(ints), string_type)


def _join(parts, string_type=pa.string(), n: int = 0):
    """Row-wise concatenation of string scalars and integer arrays (as
    their decimal digits), in chunks of ``_CHUNK`` rows."""
    chunks = []
    for lo in range(0, n, _CHUNK):
        args = [pa.scalar(p, string_type) if isinstance(p, str) else
                _decimal(p[lo: lo + _CHUNK], string_type) for p in parts]
        chunks.append(pc.binary_join_element_wise(
            *args, pa.scalar("", string_type)))
    return chunks


def _plain(chunks, string_type=pa.string()):
    if len(chunks) == 1:
        return chunks[0]
    return pa.chunked_array(chunks, type=string_type)


def _choice(values: np.ndarray, idx: np.ndarray, dictionary: bool):
    """values[idx] as an Arrow string column."""
    if dictionary:
        uniq, inverse = np.unique(values, return_inverse=True)
        return pa.DictionaryArray.from_arrays(
            pa.array(inverse[idx].astype(np.int32)), pa.array(uniq))
    return pa.array(values).take(pa.array(idx))


def generate_hits(n_rows: int = 100_000, seed: int = 0,
                  dictionary: bool = False) -> pa.Table:
    """Synthetic hits table covering every column the 43 queries touch."""
    rng = np.random.default_rng(seed)
    n = n_rows

    # user/session shape: Zipf-ish heavy hitters, many singletons
    user_pool = rng.integers(1, max(n // 3, 10), n).astype(np.uint64)
    user_id = (user_pool * np.uint64(2_654_435_761)
               % np.uint64(1 << 62)).astype(np.int64)
    del user_pool

    epoch = datetime.date(1970, 1, 1)
    d0 = (datetime.date(2013, 7, 1) - epoch).days
    event_date = (d0 + rng.integers(0, 31, n)).astype("datetime64[D]")
    event_time = (event_date.astype("datetime64[s]")
                  + rng.integers(0, 86400, n).astype("timedelta64[s]"))

    phrase_idx = rng.integers(0, len(_PHRASES), n)
    no_phrase = (_PHRASES == "")[phrase_idx]

    # near-unique URLs: host x page over 500 x n/2 values
    host_ids = rng.integers(0, _HOSTS, n)
    pages = max(n // 2, 10)
    page_ids = rng.integers(0, pages, n)
    no_referer = rng.random(n) < 0.4
    titles = max(n // 4, 10)
    title_ids = rng.integers(0, titles, n)

    if dictionary:
        # URL: one entry per distinct (host, page); the dictionary itself
        # may pass 2 GiB, so its offsets are 64-bit
        url_codes, inverse = np.unique(host_ids * pages + page_ids,
                                       return_inverse=True)
        url_dict = pa.concat_arrays(_join(
            ["http://site", url_codes // pages, ".example/page?id=",
             url_codes % pages], pa.large_string(), len(url_codes)))
        url = pa.DictionaryArray.from_arrays(
            pa.array(inverse.astype(np.int32).reshape(-1)), url_dict)
        del url_codes, inverse
        ref_dict = pa.concat_arrays(
            [pa.array([""])] + _join(["http://ref", np.arange(_HOSTS)],
                                     n=_HOSTS))
        referer = pa.DictionaryArray.from_arrays(
            pa.array(np.where(no_referer, 0, host_ids + 1).astype(np.int32)),
            ref_dict)
        title = pa.DictionaryArray.from_arrays(
            pa.array(title_ids.astype(np.int32)),
            pa.concat_arrays(_join(["Page title ", np.arange(titles)],
                                   n=titles)))
    else:
        url = _plain(_join(["http://site", host_ids, ".example/page?id=",
                            page_ids], n=n))
        referer = _plain([pc.if_else(pa.array(no_referer[lo: lo + _CHUNK]),
                                     "", part) for lo, part in zip(
            range(0, n, _CHUNK), _join(["http://ref", host_ids], n=n))])
        title = _plain(_join(["Page title ", title_ids], n=n))
    del host_ids, page_ids, no_referer, title_ids

    def u8(hi):
        return rng.integers(0, hi, n).astype(np.int16)

    table = pa.table({
        "WatchID": pa.array(rng.integers(1, 1 << 62, n), type=pa.int64()),
        "UserID": pa.array(user_id, type=pa.int64()),
        "CounterID": pa.array(rng.integers(1, 10_000, n), type=pa.int32()),
        "ClientIP": pa.array(rng.integers(0, 1 << 31, n), type=pa.int64()),
        "RegionID": pa.array(rng.integers(1, 6_000, n), type=pa.int32()),
        "AdvEngineID": pa.array(
            np.where(rng.random(n) < 0.95, 0,
                     rng.integers(1, 60, n)).astype(np.int16),
            type=pa.int16()),
        "SearchEngineID": pa.array(
            np.where(no_phrase, 0,
                     rng.integers(1, 100, n)).astype(np.int16),
            type=pa.int16()),
        "SearchPhrase": _choice(_PHRASES, phrase_idx, dictionary),
        "MobilePhone": pa.array(u8(8), type=pa.int16()),
        "MobilePhoneModel": _choice(
            _MOBILE_MODELS, rng.integers(0, len(_MOBILE_MODELS), n),
            dictionary),
        "EventDate": pa.array(event_date),
        "EventTime": pa.array(event_time),
        "ResolutionWidth": pa.array(
            rng.choice(np.array([0, 1024, 1280, 1366, 1440, 1536, 1600,
                                 1920], dtype=np.int32), n),
            type=pa.int32()),
        "WindowClientWidth": pa.array(rng.integers(0, 2000, n),
                                      type=pa.int32()),
        "WindowClientHeight": pa.array(rng.integers(0, 1200, n),
                                       type=pa.int32()),
        "IsRefresh": pa.array((rng.random(n) < 0.1).astype(np.int16),
                              type=pa.int16()),
        "IsLink": pa.array((rng.random(n) < 0.2).astype(np.int16),
                           type=pa.int16()),
        "IsDownload": pa.array((rng.random(n) < 0.02).astype(np.int16),
                               type=pa.int16()),
        "DontCountHits": pa.array((rng.random(n) < 0.05).astype(np.int16),
                                  type=pa.int16()),
        "TraficSourceID": pa.array(rng.integers(-1, 10, n).astype(np.int16),
                                   type=pa.int16()),
        "Title": title,
        "URL": url,
        "Referer": referer,
        "URLHash": pa.array(
            rng.integers(-(1 << 62), 1 << 62, n), type=pa.int64()),
        "RefererHash": pa.array(
            rng.integers(-(1 << 62), 1 << 62, n), type=pa.int64()),
    })
    return table


def register_hits(spark, n_rows: int = 100_000, seed: int = 0,
                  dictionary: bool = False) -> pa.Table:
    table = generate_hits(n_rows, seed, dictionary)
    spark.createDataFrame(table).createOrReplaceTempView("hits")
    return table


# ---------------------------------------------------------------------------
# comparing two answers to one query
# ---------------------------------------------------------------------------

# float64 answers agree within this relative error (sums add in another
# order on another device)
FLOAT_RTOL = 1e-12
_LIMIT = re.compile(r"\s+LIMIT\s+(\d+)(?:\s+OFFSET\s+(\d+))?\s*$", re.I)


def without_limit(sql: str) -> str:
    """The query with its trailing LIMIT (and OFFSET) cut off: its whole
    answer, in which a limited answer's ties are looked up."""
    return _LIMIT.sub("", sql)


def _split_top(text: str) -> List[str]:
    """``text`` split at the commas outside parentheses and quotes."""
    parts, depth, quote, start = [], 0, None, 0
    for i, c in enumerate(text):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p.strip() for p in parts]


def _norm(expr: str) -> str:
    return "".join(expr.split()).lower()


def order_key_columns(sql: str, names: List[str]) -> Optional[List[int]]:
    """The answer's columns that hold the ORDER BY keys of ``sql``, most
    significant first ([] without ORDER BY), or None where a key is not an
    output column. A key names an output column, a select item's alias or
    a select item's expression."""
    text = " ".join(sql.split())
    order = re.search(r"\sORDER BY (.*?)(?:\s+LIMIT\s.*)?$", text, re.I)
    if order is None:
        return []
    select = re.match(r"SELECT (.*?) FROM ", text, re.I)
    items = [] if select is None else _split_top(select.group(1))
    exprs, aliases = [], []
    for item in items:
        m = re.match(r"(.*?)\s+AS\s+(\w+)$", item, re.I)
        exprs.append(_norm(m.group(1) if m else item))
        aliases.append(m.group(2).lower() if m else None)
    columns = []
    for key in _split_top(order.group(1)):
        key = re.sub(r"\s+(ASC|DESC)$", "", key, flags=re.I)
        lowered = [n.lower() for n in names]
        if key.lower() in lowered:
            columns.append(lowered.index(key.lower()))
        elif "*" not in exprs and key.lower() in aliases:
            columns.append(aliases.index(key.lower()))
        elif "*" not in exprs and _norm(key) in exprs:
            columns.append(exprs.index(_norm(key)))
        else:
            return None
    return columns


def _rows(table: pa.Table) -> List[tuple]:
    return list(zip(*(c.to_pylist() for c in table.columns))) \
        if table.num_columns else []


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if a != a or b != b:
            return a != a and b != b
        return abs(a - b) <= FLOAT_RTOL * abs(b)
    return a == b


def _exact_part(row: tuple) -> tuple:
    return tuple(None if isinstance(x, float) else x for x in row)


def _same(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))


def answers_agree(got: pa.Table, want: pa.Table, sql: str,
                  full: Optional[pa.Table] = None) -> None:
    """Raise AssertionError unless ``got`` is a right answer to ``sql``
    where ``want`` is one: the same schema and rows, float64 within
    ``FLOAT_RTOL`` of each other. Rows that tie on the ORDER BY keys may
    come in any order, and where a LIMIT cuts through a tie, the rows
    kept from it may differ: then each row of ``got`` must be a row of
    the tie in ``full`` (the answer without the LIMIT, ``want`` when
    there is none), and the keys must come in ``want``'s order. Without
    ORDER BY every row ties. Where an ORDER BY key is not an output
    column the rows compare in order."""
    if got.schema != want.schema:
        raise AssertionError(f"schema {got.schema} != {want.schema}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{got.num_rows} rows, want {want.num_rows}")
    g, w = _rows(got), _rows(want)
    keys = order_key_columns(sql, want.column_names)
    if keys is None:
        for i, (a, b) in enumerate(zip(g, w)):
            if not _same(a, b):
                raise AssertionError(f"row {i}: {a} != {b}")
        return
    if _LIMIT.search(sql) is not None and full is None:
        raise AssertionError("a limited answer needs the whole answer")
    # the rows of the whole answer, by their fields other than floats
    pool: dict = {}
    for r in _rows(want if full is None else full):
        pool.setdefault(_exact_part(r), []).append(r)
    for i, (a, b) in enumerate(zip(g, w)):
        ka, kb = tuple(a[k] for k in keys), tuple(b[k] for k in keys)
        if not _same(ka, kb):
            raise AssertionError(f"row {i}: keys {ka} != {kb}")
        # a row of the same tie that no earlier row has taken
        same = pool.get(_exact_part(a), [])
        j = next((j for j, r in enumerate(same) if _same(a, r)), None)
        if j is None:
            raise AssertionError(f"row {i}: {a} is in no row of its tie")
        same.pop(j)


def check_answer(got: pa.Table, want_session, sql: str) -> None:
    """``answers_agree`` of ``got`` with ``want_session``'s answer to
    ``sql``, and with that session's whole answer where a LIMIT cuts."""
    want = want_session.sql(sql).toArrow()
    full = None
    if without_limit(sql) != sql:
        full = want_session.sql(without_limit(sql)).toArrow()
    answers_agree(got, want, sql, full)
