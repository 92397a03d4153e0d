"""TPC-H data generator (dbgen-lite).

Generates the eight TPC-H tables at a given scale factor with the standard
schemas and value domains (distributions simplified where the spec's exact
text-pool grammar doesn't affect query semantics). Used for correctness
testing against a pandas oracle and for benchmarking; the reference drives
the same queries against apache/datafusion-benchmarks data (SURVEY.md §6).
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np
import pyarrow as pa

_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONTAINERS_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
_CONTAINERS_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood",
           "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
           "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger",
           "drab", "firebrick", "floral", "forest", "frosted", "gainsboro",
           "ghost", "gold", "goldenrod", "green", "grey", "honeydew",
           "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
           "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
           "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
           "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
           "peru", "pink", "plum", "powder", "puff", "purple", "red",
           "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
           "sienna", "sky", "slate", "smoke", "snow", "spring", "steel",
           "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
           "white", "yellow"]
_COMMENT_WORDS = ("the of with regular final special express pending unusual "
                  "requests deposits packages accounts instructions theodolites "
                  "foxes ideas carefully slyly quickly blithely furiously bold "
                  "even silent daring Customer Complaints").split()

_EPOCH = datetime.date(1970, 1, 1)
_START = (datetime.date(1992, 1, 1) - _EPOCH).days
_END = (datetime.date(1998, 12, 1) - _EPOCH).days


def _dec(vals: np.ndarray, scale: int = 2, precision: int = 15) -> pa.Array:
    return pa.array([None if v is None else v for v in vals]).cast(
        pa.float64()).cast(pa.decimal128(precision, scale), safe=False)


def _comments(rng, n, maxwords=8) -> pa.Array:
    words = rng.choice(_COMMENT_WORDS, size=(n, maxwords))
    counts = rng.integers(3, maxwords + 1, n)
    return pa.array([" ".join(words[i, :counts[i]]) for i in range(n)])


def generate_tpch(sf: float = 0.01, seed: int = 0) -> Dict[str, pa.Table]:
    rng = np.random.default_rng(seed)
    n_part = max(1, int(200_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    n_cust = max(1, int(150_000 * sf))
    n_order = max(1, int(1_500_000 * sf))
    tables: Dict[str, pa.Table] = {}

    # region / nation
    tables["region"] = pa.table({
        "r_regionkey": pa.array(np.arange(5), type=pa.int64()),
        "r_name": pa.array(_REGIONS),
        "r_comment": _comments(rng, 5),
    })
    tables["nation"] = pa.table({
        "n_nationkey": pa.array(np.arange(25), type=pa.int64()),
        "n_name": pa.array([n for n, _ in _NATIONS]),
        "n_regionkey": pa.array(np.array([r for _, r in _NATIONS]), type=pa.int64()),
        "n_comment": _comments(rng, 25),
    })

    # part
    pk = np.arange(1, n_part + 1)
    p_name = [" ".join(rng.choice(_COLORS, 5, replace=False)) for _ in range(n_part)]
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    p_type = [f"{rng.choice(_TYPES_1)} {rng.choice(_TYPES_2)} {rng.choice(_TYPES_3)}"
              for _ in range(n_part)]
    p_container = [f"{rng.choice(_CONTAINERS_1)} {rng.choice(_CONTAINERS_2)}"
                   for _ in range(n_part)]
    retail = (90000 + (pk % 200001) / 10 + 100 * (pk % 1000)) / 100
    tables["part"] = pa.table({
        "p_partkey": pa.array(pk, type=pa.int64()),
        "p_name": pa.array(p_name),
        "p_mfgr": pa.array([f"Manufacturer#{m}" for m in mfgr]),
        "p_brand": pa.array([f"Brand#{b}" for b in brand]),
        "p_type": pa.array(p_type),
        "p_size": pa.array(rng.integers(1, 51, n_part), type=pa.int32()),
        "p_container": pa.array(p_container),
        "p_retailprice": _dec(retail),
        "p_comment": _comments(rng, n_part, 5),
    })

    # supplier
    sk = np.arange(1, n_supp + 1)
    s_nation = rng.integers(0, 25, n_supp)
    tables["supplier"] = pa.table({
        "s_suppkey": pa.array(sk, type=pa.int64()),
        "s_name": pa.array([f"Supplier#{i:09d}" for i in sk]),
        "s_address": pa.array([f"addr {i}" for i in sk]),
        "s_nationkey": pa.array(s_nation, type=pa.int64()),
        "s_phone": pa.array([f"{10 + n}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for n in s_nation]),
        "s_acctbal": _dec(np.round(rng.uniform(-999.99, 9999.99, n_supp), 2)),
        "s_comment": _comments(rng, n_supp),
    })

    # partsupp: 4 suppliers per part
    ps_part = np.repeat(pk, 4)
    ps_supp = np.empty(n_part * 4, dtype=np.int64)
    for j in range(4):
        ps_supp[j::4] = (pk + j * (n_supp // 4 + 1)) % n_supp + 1
    tables["partsupp"] = pa.table({
        "ps_partkey": pa.array(ps_part, type=pa.int64()),
        "ps_suppkey": pa.array(ps_supp, type=pa.int64()),
        "ps_availqty": pa.array(rng.integers(1, 10000, len(ps_part)), type=pa.int32()),
        "ps_supplycost": _dec(np.round(rng.uniform(1.0, 1000.0, len(ps_part)), 2)),
        "ps_comment": _comments(rng, len(ps_part)),
    })

    # customer
    ck = np.arange(1, n_cust + 1)
    c_nation = rng.integers(0, 25, n_cust)
    tables["customer"] = pa.table({
        "c_custkey": pa.array(ck, type=pa.int64()),
        "c_name": pa.array([f"Customer#{i:09d}" for i in ck]),
        "c_address": pa.array([f"addr {i}" for i in ck]),
        "c_nationkey": pa.array(c_nation, type=pa.int64()),
        "c_phone": pa.array([f"{10 + n}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for n in c_nation]),
        "c_acctbal": _dec(np.round(rng.uniform(-999.99, 9999.99, n_cust), 2)),
        "c_mktsegment": pa.array(rng.choice(_SEGMENTS, n_cust)),
        "c_comment": _comments(rng, n_cust),
    })

    # orders: only ~2/3 of customers have orders (spec: custkey % 3 != 0 pattern)
    ok = np.arange(1, n_order + 1) * 4 - 3  # sparse order keys, as in dbgen
    o_cust = rng.integers(1, n_cust + 1, n_order)
    o_cust = np.where(o_cust % 3 == 0, (o_cust % (max(n_cust - 1, 1))) + 1, o_cust)
    o_cust = np.where(o_cust % 3 == 0, 1 + (o_cust + 1) % max(n_cust, 1), o_cust)
    o_date = rng.integers(_START, _END - 151, n_order)
    tables["orders"] = pa.table({
        "o_orderkey": pa.array(ok, type=pa.int64()),
        "o_custkey": pa.array(o_cust, type=pa.int64()),
        "o_orderstatus": pa.array(rng.choice(["F", "O", "P"], n_order,
                                             p=[0.49, 0.49, 0.02])),
        "o_totalprice": _dec(np.round(rng.uniform(850, 550000, n_order), 2)),
        "o_orderdate": pa.array(o_date.astype("datetime64[D]")),
        "o_orderpriority": pa.array(rng.choice(_PRIORITIES, n_order)),
        "o_clerk": pa.array([f"Clerk#{rng.integers(1, 1001):09d}"
                             for _ in range(n_order)]),
        "o_shippriority": pa.array(np.zeros(n_order), type=pa.int32()),
        "o_comment": _comments(rng, n_order),
    })

    # lineitem: 1-7 lines per order
    lines_per = rng.integers(1, 8, n_order)
    l_order = np.repeat(ok, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    n_line = len(l_order)
    l_num = np.concatenate([np.arange(1, c + 1) for c in lines_per])
    qty = rng.integers(1, 51, n_line)
    l_part = rng.integers(1, n_part + 1, n_line)
    l_supp = (l_part + rng.integers(0, 4, n_line) * (n_supp // 4 + 1)) % n_supp + 1
    extended = qty * np.round((90000 + (l_part % 200001) / 10
                               + 100 * (l_part % 1000)) / 100, 2)
    discount = rng.integers(0, 11, n_line) / 100.0
    tax = rng.integers(0, 9, n_line) / 100.0
    ship_delta = rng.integers(1, 122, n_line)
    l_ship = l_odate + ship_delta
    l_commit = l_odate + rng.integers(30, 92, n_line)
    l_receipt = l_ship + rng.integers(1, 31, n_line)
    returnflag = np.where(
        l_receipt <= (datetime.date(1995, 6, 17) - _EPOCH).days,
        rng.choice(["R", "A"], n_line), "N")
    linestatus = np.where(l_ship > (datetime.date(1995, 6, 17) - _EPOCH).days,
                          "O", "F")
    tables["lineitem"] = pa.table({
        "l_orderkey": pa.array(l_order, type=pa.int64()),
        "l_partkey": pa.array(l_part, type=pa.int64()),
        "l_suppkey": pa.array(l_supp, type=pa.int64()),
        "l_linenumber": pa.array(l_num, type=pa.int32()),
        "l_quantity": _dec(qty.astype(np.float64)),
        "l_extendedprice": _dec(np.round(extended, 2)),
        "l_discount": _dec(discount),
        "l_tax": _dec(tax),
        "l_returnflag": pa.array(returnflag),
        "l_linestatus": pa.array(linestatus),
        "l_shipdate": pa.array(l_ship.astype("datetime64[D]")),
        "l_commitdate": pa.array(l_commit.astype("datetime64[D]")),
        "l_receiptdate": pa.array(l_receipt.astype("datetime64[D]")),
        "l_shipinstruct": pa.array(rng.choice(_INSTRUCTS, n_line)),
        "l_shipmode": pa.array(rng.choice(_SHIPMODES, n_line)),
        "l_comment": _comments(rng, n_line, 4),
    })
    return tables


def register_tpch(spark, sf: float = 0.01, seed: int = 0):
    """Create the TPC-H tables as temp views on a session."""
    tables = generate_tpch(sf, seed)
    for name, table in tables.items():
        spark.createDataFrame(table).createOrReplaceTempView(name)
    return tables


def _decimal_from_unscaled(vals: np.ndarray, precision: int = 15,
                           scale: int = 2) -> pa.Array:
    """decimal128 array from unscaled int64 values (no nulls)."""
    words = np.empty((len(vals), 2), dtype=np.int64)
    words[:, 0] = vals
    words[:, 1] = vals >> 63
    return pa.Array.from_buffers(pa.decimal128(precision, scale), len(vals),
                                 [None, pa.py_buffer(words)])


def _dict_column(codes: np.ndarray, values) -> pa.Array:
    return pa.DictionaryArray.from_arrays(
        pa.array(codes.astype(np.int32)), pa.array(values, type=pa.string()))


def generate_lineitem_sf(sf: float, seed: int = 0) -> pa.Table:
    """Lineitem alone at scale factor ``sf`` (~6M rows per unit), every
    column vectorised: decimals are built from their unscaled integers and
    strings as dictionary arrays from codes, so SF10 (~60M rows) takes
    seconds. Value domains follow ``generate_tpch``'s lineitem: 1-7 lines
    per order, the same date windows and the same returnflag/linestatus
    cut-off; the extended price is computed in exact cents."""
    return _lineitem_sf(np.random.default_rng(seed), sf)[0]


def _retail_cents(partkey: np.ndarray) -> np.ndarray:
    """Retail price in cents: 90000 + p/10 + 100 * (p % 1000), rounded."""
    return (900_000 + partkey % 200_001 + 1000 * (partkey % 1000) + 5) // 10


def _date(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32)).view(pa.date32())


def _lineitem_sf(rng, sf: float):
    """(lineitem, per-order (keys, dates, lines, all lines shipped,
    no line shipped))."""
    n_order = int(1_500_000 * sf)
    lines_per = rng.integers(1, 8, n_order)
    n = int(lines_per.sum())
    order_start = np.repeat(np.cumsum(lines_per) - lines_per, lines_per)
    okeys = np.arange(1, n_order + 1, dtype=np.int64) * 4 - 3
    odates = rng.integers(_START, _END - 151, n_order)
    okey = np.repeat(okeys, lines_per)
    odate = np.repeat(odates, lines_per)
    qty = rng.integers(1, 51, n)
    part = rng.integers(1, max(1, int(200_000 * sf)) + 1, n)
    n_supp = max(1, int(10_000 * sf))
    supp = (part + rng.integers(0, 4, n) * (n_supp // 4 + 1)) % n_supp + 1
    retail = _retail_cents(part)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    ship = odate + rng.integers(1, 122, n)
    commit = odate + rng.integers(30, 92, n)
    receipt = ship + rng.integers(1, 31, n)
    cutoff = (datetime.date(1995, 6, 17) - _EPOCH).days
    # returnflag dictionary ["A", "N", "R"]; linestatus ["F", "O"]
    returnflag = np.where(receipt <= cutoff, rng.integers(0, 2, n) * 2, 1)
    linestatus = (ship > cutoff).astype(np.int32)
    table = pa.table({
        "l_orderkey": pa.array(okey),
        "l_partkey": pa.array(part.astype(np.int64)),
        "l_suppkey": pa.array(supp.astype(np.int64)),
        "l_linenumber": pa.array(
            (np.arange(n) - order_start + 1).astype(np.int32)),
        "l_quantity": _decimal_from_unscaled(qty * 100),
        "l_extendedprice": _decimal_from_unscaled(qty * retail),
        "l_discount": _decimal_from_unscaled(discount),
        "l_tax": _decimal_from_unscaled(tax),
        "l_returnflag": _dict_column(returnflag, ["A", "N", "R"]),
        "l_linestatus": _dict_column(linestatus, ["F", "O"]),
        "l_shipdate": _date(ship),
        "l_commitdate": _date(commit),
        "l_receiptdate": _date(receipt),
        "l_shipinstruct": _dict_column(rng.integers(0, 4, n), _INSTRUCTS),
        "l_shipmode": _dict_column(rng.integers(0, 7, n), _SHIPMODES),
        "l_comment": _dict_column(rng.integers(0, 6, n), [
            "carefully final deposits", "quickly regular packages",
            "slyly special requests", "blithely even theodolites",
            "furiously bold accounts", "pending unusual ideas"]),
    })
    starts = np.cumsum(lines_per) - lines_per
    all_open = np.minimum.reduceat(linestatus, starts) == 1
    none_open = np.maximum.reduceat(linestatus, starts) == 0
    return table, (okeys, odates, none_open, all_open)


def _phrases(rng, count: int, words: int) -> list:
    """A vocabulary of ``count`` comment phrases of ``words`` words."""
    picks = rng.integers(0, len(_COMMENT_WORDS), (count, words))
    return [" ".join(_COMMENT_WORDS[j] for j in row) for row in picks]


def _numbered(prefix: str, keys: np.ndarray) -> pa.Array:
    """``prefix`` + the key zero-padded to 9 digits, one string per key."""
    return pa.array(np.char.add(prefix, np.char.zfill(
        keys.astype(str), 9)).astype(object), type=pa.string())


def _money(rng, lo_cents: int, hi_cents: int, n: int) -> pa.Array:
    return _decimal_from_unscaled(rng.integers(lo_cents, hi_cents + 1, n))


def generate_tpch_sf(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    """All eight TPC-H tables at scale factor ``sf``, every column
    vectorised, so SF10 takes seconds where ``generate_tpch`` takes
    minutes.

    ``lineitem`` is ``generate_lineitem_sf(sf, seed)`` bit for bit (the
    other tables draw from a second random stream), and ``orders`` holds
    its order keys and order dates; an order's status follows its lines'
    status (F all shipped by the cut-off, O none, else P). Value domains
    follow ``generate_tpch``. Strings are dictionary columns: names and
    addresses are unique per row, everything else comes from a bounded
    vocabulary chosen to keep the queries' predicates selective:
    ``p_name`` joins five of the 92 ``_COLORS`` (Q9's ``%green%``, Q20's
    ``forest%``), ``c_phone`` and ``s_phone`` start with the country code
    10 + nation (Q22), ``o_comment`` has "special ... requests" phrases
    (Q13) and ``s_comment`` "Customer ... Complaints" ones (Q16)."""
    lineitem, (okeys, odates, none_open, all_open) = _lineitem_sf(
        np.random.default_rng(seed), sf)
    rng = np.random.default_rng([seed, 1])
    n_part = max(1, int(200_000 * sf))
    n_supp = max(1, int(10_000 * sf))
    n_cust = max(1, int(150_000 * sf))
    n_order = okeys.shape[0]
    tables: Dict[str, pa.Table] = {}

    tables["region"] = pa.table({
        "r_regionkey": pa.array(np.arange(5), type=pa.int64()),
        "r_name": pa.array(_REGIONS),
        "r_comment": pa.array(_phrases(rng, 5, 6)),
    })
    tables["nation"] = pa.table({
        "n_nationkey": pa.array(np.arange(25), type=pa.int64()),
        "n_name": pa.array([n for n, _ in _NATIONS]),
        "n_regionkey": pa.array(np.array([r for _, r in _NATIONS]),
                                type=pa.int64()),
        "n_comment": pa.array(_phrases(rng, 25, 6)),
    })

    pk = np.arange(1, n_part + 1, dtype=np.int64)
    names = [" ".join(rng.choice(_COLORS, 5, replace=False))
             for _ in range(4096)]
    mfgr = rng.integers(1, 6, n_part)
    brand = (mfgr - 1) * 5 + rng.integers(0, 5, n_part)
    types = [f"{a} {b} {c}" for a in _TYPES_1 for b in _TYPES_2
             for c in _TYPES_3]
    containers = [f"{a} {b}" for a in _CONTAINERS_1 for b in _CONTAINERS_2]
    tables["part"] = pa.table({
        "p_partkey": pa.array(pk),
        "p_name": _dict_column(rng.integers(0, len(names), n_part), names),
        "p_mfgr": _dict_column(mfgr - 1,
                               [f"Manufacturer#{m}" for m in range(1, 6)]),
        "p_brand": _dict_column(brand, [f"Brand#{m}{b}" for m in range(1, 6)
                                        for b in range(1, 6)]),
        "p_type": _dict_column(rng.integers(0, len(types), n_part), types),
        "p_size": pa.array(rng.integers(1, 51, n_part).astype(np.int32)),
        "p_container": _dict_column(
            rng.integers(0, len(containers), n_part), containers),
        "p_retailprice": _decimal_from_unscaled(_retail_cents(pk)),
        "p_comment": _dict_column(rng.integers(0, 256, n_part),
                                  _phrases(rng, 256, 4)),
    })

    def phones(nations: np.ndarray) -> pa.Array:
        # 1000 numbers per country code
        vocab = [f"{10 + n}-{100 + j % 900}-{100 + (j * 7) % 900}-"
                 f"{1000 + (j * 13) % 9000}" for n in range(25)
                 for j in range(1000)]
        return _dict_column(nations * 1000 + rng.integers(0, 1000,
                                                          len(nations)),
                            vocab)

    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, n_supp)
    s_comments = _phrases(rng, 252, 5) + [
        "slyly Customer even Complaints", "Customer carefully Complaints ideas",
        "final Customer requests Complaints"]
    tables["supplier"] = pa.table({
        "s_suppkey": pa.array(sk),
        "s_name": _numbered("Supplier#", sk),
        "s_address": _numbered("addr ", sk),
        "s_nationkey": pa.array(s_nation.astype(np.int64)),
        "s_phone": phones(s_nation),
        "s_acctbal": _money(rng, -99_999, 999_999, n_supp),
        "s_comment": _dict_column(rng.integers(0, len(s_comments), n_supp),
                                  s_comments),
    })

    # partsupp: 4 suppliers per part, as lineitem's l_suppkey picks them
    ps_part = np.repeat(pk, 4)
    ps_supp = (ps_part + np.tile(np.arange(4), n_part) * (n_supp // 4 + 1))         % n_supp + 1
    tables["partsupp"] = pa.table({
        "ps_partkey": pa.array(ps_part),
        "ps_suppkey": pa.array(ps_supp.astype(np.int64)),
        "ps_availqty": pa.array(rng.integers(1, 10000, 4 * n_part)
                                .astype(np.int32)),
        "ps_supplycost": _money(rng, 100, 100_000, 4 * n_part),
        "ps_comment": _dict_column(rng.integers(0, 256, 4 * n_part),
                                   _phrases(rng, 256, 6)),
    })

    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, n_cust)
    tables["customer"] = pa.table({
        "c_custkey": pa.array(ck),
        "c_name": _numbered("Customer#", ck),
        "c_address": _numbered("addr ", ck),
        "c_nationkey": pa.array(c_nation.astype(np.int64)),
        "c_phone": phones(c_nation),
        "c_acctbal": _money(rng, -99_999, 999_999, n_cust),
        "c_mktsegment": _dict_column(rng.integers(0, 5, n_cust), _SEGMENTS),
        "c_comment": _dict_column(rng.integers(0, 256, n_cust),
                                  _phrases(rng, 256, 6)),
    })

    # orders: only customers whose key is not a multiple of 3 order (spec)
    o_cust = rng.integers(1, n_cust + 1, n_order)
    o_cust = np.where(o_cust % 3 == 0, o_cust % max(n_cust - 1, 1) + 1,
                      o_cust)
    o_cust = np.where(o_cust % 3 == 0, 1 + (o_cust + 1) % max(n_cust, 1),
                      o_cust)
    status = np.where(none_open, 0, np.where(all_open, 1, 2))
    o_comments = _phrases(rng, 250, 6) + [
        "carefully special final requests", "special pending requests",
        "blithely special unusual requests sleep", "special requests",
        "quickly special express requests", "slyly special bold requests"]
    n_clerk = max(1, int(1000 * sf))
    tables["orders"] = pa.table({
        "o_orderkey": pa.array(okeys),
        "o_custkey": pa.array(o_cust.astype(np.int64)),
        "o_orderstatus": _dict_column(status, ["F", "O", "P"]),
        "o_totalprice": _money(rng, 85_000, 55_000_000, n_order),
        "o_orderdate": _date(odates),
        "o_orderpriority": _dict_column(rng.integers(0, 5, n_order),
                                        _PRIORITIES),
        "o_clerk": _dict_column(rng.integers(0, n_clerk, n_order),
                                [f"Clerk#{i:09d}" for i in
                                 range(1, n_clerk + 1)]),
        "o_shippriority": pa.array(np.zeros(n_order, dtype=np.int32)),
        "o_comment": _dict_column(rng.integers(0, len(o_comments), n_order),
                                  o_comments),
    })
    tables["lineitem"] = lineitem
    return tables
