"""Window and UNION queries over the TPC-H tables.

Standard analytical SQL of the kinds a Spark engine's users send (top-N
per group, running totals, moving frames, lag/lead deltas, rank bands,
window forms of TPC-H queries, unions of fact tables), each cut to an
aggregate or a small answer so the result's transfer does not dominate.
``chip_smoke.py`` runs them on the card at TPC-H SF10 and the tests on
the CPU against the reference. ``ORD`` below stands for the lineitem
order ``l_shipdate, l_orderkey, l_linenumber``.
"""

_ORD = "l_shipdate, l_orderkey, l_linenumber"

QUERIES = {
    # top-N per group
    "w1": """
select o_custkey, o_orderkey, o_totalprice, rn
from (
    select o_custkey, o_orderkey, o_totalprice,
           row_number() over (partition by o_custkey
                              order by o_totalprice desc, o_orderkey) as rn
    from orders) t
where rn <= 3
order by o_custkey, rn
""",
    # running totals: the default RANGE frame, peers share the total
    "w2": """
select year(o_orderdate) as y, sum(run_total) as s, max(run_count) as m,
       count(*) as c
from (
    select o_orderdate,
           sum(o_totalprice) over (partition by o_custkey
                                   order by o_orderdate) as run_total,
           count(*) over (partition by o_custkey
                          order by o_orderdate) as run_count
    from orders) t
group by year(o_orderdate)
order by y
""",
    # moving frames: a 7-row average and a 5-row MIN/MAX band
    "w3": f"""
select l_returnflag, l_linestatus, sum(avg_q) as s_avg, sum(mn) as s_min,
       sum(mx) as s_max, count(*) as c
from (
    select l_returnflag, l_linestatus,
           avg(l_quantity) over (partition by l_suppkey order by {_ORD}
               rows between 6 preceding and current row) as avg_q,
           min(l_extendedprice) over (partition by l_suppkey order by {_ORD}
               rows between 2 preceding and 2 following) as mn,
           max(l_extendedprice) over (partition by l_suppkey order by {_ORD}
               rows between 2 preceding and 2 following) as mx
    from lineitem) t
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    # lag/lead deltas
    "w4": f"""
select count(*) as c, sum(l_extendedprice - prev_price) as d,
       count(*) - count(next_qty) as null_leads, sum(prev_qty) as s_prev
from (
    select l_extendedprice,
           lag(l_extendedprice) over (partition by l_partkey
                                      order by {_ORD}) as prev_price,
           lag(l_quantity, 1, -1) over (partition by l_partkey
                                        order by {_ORD}) as prev_qty,
           lead(l_quantity, 2) over (partition by l_partkey
                                     order by {_ORD}) as next_qty
    from lineitem) t
""",
    # the rank family over heavy ties (50 distinct quantities)
    "w5": """
select l_linestatus, sum(rk) as s_rank, sum(drk) as s_dense,
       sum(prk) as s_pr, sum(cd) as s_cd, sum(nt) as s_nt, count(*) as c
from (
    select l_linestatus,
           rank() over (partition by l_suppkey order by l_quantity) as rk,
           dense_rank() over (partition by l_suppkey
                              order by l_quantity) as drk,
           percent_rank() over (partition by l_suppkey
                                order by l_quantity) as prk,
           cume_dist() over (partition by l_suppkey
                             order by l_quantity) as cd,
           ntile(4) over (partition by l_suppkey order by l_quantity) as nt
    from lineitem) t
group by l_linestatus
order by l_linestatus
""",
    # a window over an aggregate over joins: the top suppliers per nation
    "w6": """
select n_name, s_suppkey, revenue, rk
from (
    select n_name, s_suppkey, revenue,
           rank() over (partition by n_name order by revenue desc) as rk
    from (
        select n_name, s_suppkey,
               sum(l_extendedprice * (1 - l_discount)) as revenue
        from lineitem, supplier, nation
        where l_suppkey = s_suppkey and s_nationkey = n_nationkey
        group by n_name, s_suppkey) a) b
where rk <= 5
order by n_name, rk, s_suppkey
""",
    # TPC-H Q17 in its window form (its answer equals Q17's)
    "w7": """
select sum(l_extendedprice) / 7.0 as avg_yearly
from (
    select l_extendedprice, l_quantity,
           avg(l_quantity) over (partition by l_partkey) as avg_q
    from lineitem, part
    where p_partkey = l_partkey
      and p_brand = 'Brand#23'
      and p_container = 'MED BOX') t
where l_quantity < 0.2 * avg_q
""",
    # one segment of every row: percentiles and a running total
    "w8": """
select tile, count(*) as c, sum(o_totalprice) as s, max(run) as m
from (
    select o_totalprice,
           ntile(100) over (order by o_totalprice, o_orderkey) as tile,
           sum(o_totalprice) over (order by o_orderkey
               rows between unbounded preceding and current row) as run
    from orders) t
group by tile
order by tile
""",
    # UNION ALL of two fact scans
    "u1": """
select src, count(*) as c, sum(amount) as s
from (
    select 'L' as src, l_extendedprice as amount
    from lineitem where l_shipmode = 'AIR'
    union all
    select 'O' as src, o_totalprice as amount
    from orders where o_orderpriority = '1-URGENT') u
group by src
order by src
""",
    # UNION DISTINCT of string columns from three dictionaries
    "u2": """
select v, count(*) as c
from (
    select c_mktsegment as v from customer
    union
    select p_brand as v from part
    union
    select o_orderpriority as v from orders) u
group by v
order by v
""",
}
