"""Cost-based join reordering (greedy operator ordering).

Reference role: the reference's cost-based JoinReorder physical rule
(crates/sail-physical-optimizer/src/join_reorder/, ~8k LoC DP-style) plus
its CollectLeft broadcast selection (src/collect_left.rs). This build uses
greedy operator ordering (GOO) instead of DP: at engine batch sizes the
difference between GOO and optimal is small for TPC-H-shaped star/
snowflake graphs, and GOO is O(n²) with no memo table.

The pass runs after filter pushdown (so leaf filters are in place and
implicit cross joins have been converted to inner joins with keys) and
before column pruning (so the restoring projection gets pruned away).

Cardinality model (no collected statistics yet — SURVEY.md §2.6
sail-cache statistics cache is the eventual source):
- scans: exact row counts for in-memory tables, parquet footer counts for
  parquet scans, a large default otherwise
- filters: per-conjunct selectivity guesses (equality 0.05, IN 0.2,
  range 0.3, LIKE 0.25, other 0.25)
- equi joins: |A ⋈ B| = |A|·|B| / Π_c ndv(c) over the key classes c
  the join's keys fall in. A class holds the key columns that the
  query's equalities make equal (``c_nationkey = s_nationkey`` and
  ``s_nationkey = n_nationkey``: one class); its ndv is the unfiltered
  base rows of its smallest leaf, the one taken to own the key (nation).
  A join where neither side owns its keys (supplier ⋈ customer on their
  nation) grows with the product of the sides, so with the square of
  the scale factor: the greedy order takes one only where no other
  connected leaf is left.
- cross joins inside an inner-join tree are flattened with it, so a
  written ``FROM part, supplier, partsupp`` is reordered by its
  predicates, and a cross join stays only between leaves that no
  predicate connects.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ..spec import data_type as dt
from . import nodes as pn
from . import rex as rx

_DEFAULT_ROWS = 1_000_000.0

#: optional leaf-estimate override: ``est(node) -> rows or None`` —
#: adaptive re-entry feeds OBSERVED stage output rows for exchange
#: leaves through this instead of the static model
EstFn = Optional[Callable[[pn.PlanNode], Optional[float]]]


@dataclasses.dataclass
class _Leaf:
    node: pn.PlanNode
    offset: int          # column offset in the ORIGINAL tree's output
    width: int
    rows: float          # estimated output rows (after its filters)
    base_rows: float     # unfiltered base-scan rows (ndv proxy)


@dataclasses.dataclass
class _Edge:
    a: int               # leaf index
    b: int
    a_expr: rx.Rex       # bound to leaf a's local schema
    b_expr: rx.Rex


@dataclasses.dataclass
class _Residual:
    expr: rx.Rex         # bound to the original tree's global schema
    leaves: Tuple[int, ...]


def reorder_joins(p: pn.PlanNode, est: EstFn = None) -> pn.PlanNode:
    """Recursively reorder every maximal inner-join tree in the plan."""
    if isinstance(p, pn.JoinExec) and _is_reorderable(p):
        return _reorder_tree(p, est)
    kids = {}
    for fname in ("input", "left", "right"):
        c = getattr(p, fname, None)
        if isinstance(c, pn.PlanNode):
            kids[fname] = reorder_joins(c, est)
    if hasattr(p, "inputs"):
        kids["inputs"] = tuple(reorder_joins(c, est) for c in p.inputs)
    if kids:
        return dataclasses.replace(p, **kids)
    return p


def _is_reorderable(j: pn.JoinExec) -> bool:
    return j.join_type == "inner" and not j.null_aware and bool(j.left_keys)


def _is_flattenable(j: pn.JoinExec) -> bool:
    """A join below a reorderable root that joins its tree: inner, with
    keys or without (a cross join)."""
    return j.join_type in ("inner", "cross") and not j.null_aware


def _reorder_tree(root: pn.JoinExec, est: EstFn = None) -> pn.PlanNode:
    leaves: List[_Leaf] = []
    edges: List[_Edge] = []
    residuals: List[_Residual] = []
    ok = _collect(root, leaves, edges, residuals, 0, est)
    if not ok or len(leaves) < 3 or len(leaves) > 16:
        # nothing to gain (or too odd a shape): recurse into children only
        return dataclasses.replace(
            root, left=reorder_joins(root.left, est),
            right=reorder_joins(root.right, est))
    order, plan = _greedy(leaves, edges, residuals)
    if plan is None:
        return dataclasses.replace(
            root, left=reorder_joins(root.left, est),
            right=reorder_joins(root.right, est))
    # restore the original column order with an identity projection
    new_offsets: Dict[int, int] = {}
    pos = 0
    for li in order:
        new_offsets[li] = pos
        pos += leaves[li].width
    out_schema = root.schema
    exprs = []
    for i, f in enumerate(out_schema):
        li = _leaf_of_index(leaves, i)
        new_i = new_offsets[li] + (i - leaves[li].offset)
        exprs.append((f.name, rx.BoundRef(new_i, f.name, f.dtype,
                                          f.nullable)))
    return pn.ProjectExec(plan, tuple(exprs))


def _collect(p: pn.PlanNode, leaves, edges, residuals, offset,
             est: EstFn = None) -> bool:
    """Flatten an inner-join tree; returns False on unsupported shapes."""
    if isinstance(p, pn.JoinExec) and _is_flattenable(p):
        wl = len(p.left.schema)
        if not _collect(p.left, leaves, edges, residuals, offset, est):
            return False
        if not _collect(p.right, leaves, edges, residuals, offset + wl,
                        est):
            return False
        for lk, rk in zip(p.left_keys, p.right_keys):
            ga = rx.shift_refs(lk, offset)
            gb = rx.shift_refs(rk, offset + wl)
            ea = _single_leaf(leaves, ga)
            eb = _single_leaf(leaves, gb)
            if ea is None or eb is None:
                # key spans leaves: keep this tree as written
                return False
            edges.append(_Edge(
                ea, eb,
                rx.shift_refs(ga, -leaves[ea].offset),
                rx.shift_refs(gb, -leaves[eb].offset)))
        if p.residual is not None:
            ge = rx.shift_refs(p.residual, offset)
            refs = rx.references(ge)
            ls = tuple(sorted({_leaf_of_index(leaves, i) for i in refs}))
            residuals.append(_Residual(ge, ls))
        return True
    leaves.append(_Leaf(reorder_joins(p, est), offset, len(p.schema),
                        max(_est_rows(p, est), 1.0),
                        max(_base_rows(p, est), 1.0)))
    return True


def _leaf_of_index(leaves: List[_Leaf], i: int) -> int:
    for k, lf in enumerate(leaves):
        if lf.offset <= i < lf.offset + lf.width:
            return k
    raise IndexError(i)


def _single_leaf(leaves, expr) -> Optional[int]:
    refs = rx.references(expr)
    if not refs:
        return None
    ls = {_leaf_of_index(leaves, i) for i in refs}
    if len(ls) != 1:
        return None
    return ls.pop()


# ---------------------------------------------------------------------------
# cardinality estimation
# ---------------------------------------------------------------------------

def _scan_rows(p: pn.ScanExec) -> float:
    if p.source is not None and hasattr(p.source, "num_rows"):
        return float(p.source.num_rows)
    # ANALYZE TABLE ... COMPUTE STATISTICS stores numRows on the catalog
    # entry, which the resolver copies into the scan options — computed
    # stats beat per-file footer reads
    num_rows = dict(p.options).get("numRows")
    if num_rows is not None:
        try:
            return float(num_rows)
        except (TypeError, ValueError):
            pass
    return _DEFAULT_ROWS


def _conjunct_selectivity(c: rx.Rex) -> float:
    if isinstance(c, rx.RCall):
        if c.fn == "==":
            return 0.05
        if c.fn == "in":
            return 0.2
        if c.fn in ("<", "<=", ">", ">="):
            return 0.3
        if c.fn in ("like", "ilike", "rlike"):
            return 0.25
        if c.fn == "and":
            return (_conjunct_selectivity(c.args[0])
                    * _conjunct_selectivity(c.args[1]))
        if c.fn == "or":
            a = _conjunct_selectivity(c.args[0])
            b = _conjunct_selectivity(c.args[1])
            return min(a + b, 1.0)
        if c.fn == "not":
            return max(1.0 - _conjunct_selectivity(c.args[0]), 0.05)
    return 0.25


def _est_rows(p: pn.PlanNode, est: EstFn = None) -> float:
    if est is not None:
        v = est(p)
        if v is not None:
            return float(v)
    obs = observed_rows(p)
    if obs is not None:
        return obs
    if isinstance(p, pn.ScanExec):
        return _scan_rows(p)
    if isinstance(p, pn.FilterExec):
        return _est_rows(p.input, est) * _conjunct_selectivity(p.condition)
    if isinstance(p, pn.AggregateExec):
        return max(_est_rows(p.input, est) * 0.1, 1.0)
    if isinstance(p, pn.JoinExec):
        lr, rr = _est_rows(p.left, est), _est_rows(p.right, est)
        if p.join_type in ("semi", "anti"):
            return lr * 0.5
        return max(lr, rr)
    if isinstance(p, pn.UnionExec):
        return sum(_est_rows(c, est) for c in p.inputs)
    child = getattr(p, "input", None)
    if isinstance(child, pn.PlanNode):
        return _est_rows(child, est)
    return _DEFAULT_ROWS


def _base_rows(p: pn.PlanNode, est: EstFn = None) -> float:
    """Unfiltered base cardinality — the ndv proxy for join keys.
    Observed post-filter rows do NOT feed this (they would corrupt the
    ndv proxy); only an explicit ``est`` override does (exchange leaves
    and stripped scans whose only known cardinality IS the supplied
    one)."""
    if est is not None:
        v = est(p)
        if v is not None:
            return float(v)
    if isinstance(p, pn.ScanExec):
        return _scan_rows(p)
    if isinstance(p, pn.JoinExec):
        return max(_base_rows(p.left, est), _base_rows(p.right, est))
    if isinstance(p, pn.UnionExec):
        return sum(_base_rows(c, est) for c in p.inputs)
    child = getattr(p, "input", None)
    if isinstance(child, pn.PlanNode):
        return _base_rows(child, est)
    return _DEFAULT_ROWS


# ---------------------------------------------------------------------------
# observed-cardinality feedback (adaptive execution satellite): completed
# leaf stages report their ACTUAL output rows; keyed by a stable
# fingerprint of the Filter/Project-over-Scan subtree, they replace the
# selectivity guesses above on repeat queries. Advisory: a stale or
# colliding observation only skews an estimate, never a result.
# ---------------------------------------------------------------------------

_OBS_CAP = 512
_OBS_LOCK = threading.Lock()
_OBSERVED_ROWS: "OrderedDict[tuple, float]" = OrderedDict()

_FEEDBACK_DEFAULT: Optional[bool] = None


def _feedback_enabled() -> bool:
    # observed_rows runs per node inside estimation loops: one direct
    # os.environ lookup (tests toggle the env var), falling back to the
    # config default resolved once per process — never the full
    # app-config re-flatten per call
    import os

    from ..config import truthy, truthy_value
    env = os.environ.get("SAIL_ADAPTIVE__STATS_FEEDBACK")
    if env is not None:
        return truthy_value(env)
    global _FEEDBACK_DEFAULT
    if _FEEDBACK_DEFAULT is None:
        _FEEDBACK_DEFAULT = truthy("adaptive.stats_feedback")
    return _FEEDBACK_DEFAULT


def observation_key(p: pn.PlanNode, scan_tables=None) -> Optional[tuple]:
    """Stable fingerprint of a pure Filter/Project-over-Scan chain,
    identical between the session plan (memory scans with a live
    source) and the driver's stripped stage plan (``__driver__`` scans
    resolved through ``scan_tables``). None for any other shape."""
    parts: List[tuple] = []
    scans = 0
    for n in pn.walk_plan(p):
        if isinstance(n, pn.FilterExec):
            parts.append(("f", pn._rex_str(n.condition)))
        elif isinstance(n, pn.ProjectExec):
            parts.append(("p", tuple(name for name, _e in n.exprs),
                          tuple(pn._rex_str(e) for _n, e in n.exprs)))
        elif isinstance(n, pn.ScanExec):
            scans += 1
            rows = None
            if n.format == "__driver__" and scan_tables is not None:
                t = scan_tables.get(n.table_name)
                rows = None if t is None else t.num_rows
            elif n.source is not None:
                rows = n.source.num_rows
            parts.append((
                "s", n.paths, tuple(f.name for f in n.schema), rows,
                tuple(pn._rex_str(c) for c in n.predicates)))
        else:
            return None
    if scans != 1:
        return None
    return tuple(parts)


def note_observed_rows(p: pn.PlanNode, rows, scan_tables=None) -> None:
    """Record a completed subtree's actual output row count."""
    if not _feedback_enabled():
        return
    key = observation_key(p, scan_tables)
    if key is None:
        return
    with _OBS_LOCK:
        _OBSERVED_ROWS[key] = float(rows)
        _OBSERVED_ROWS.move_to_end(key)
        while len(_OBSERVED_ROWS) > _OBS_CAP:
            _OBSERVED_ROWS.popitem(last=False)


def observed_rows(p: pn.PlanNode) -> Optional[float]:
    """The recorded cardinality of this exact subtree, if any."""
    if not _OBSERVED_ROWS:
        return None  # common case: nothing recorded, zero overhead
    if not _feedback_enabled():
        return None
    key = observation_key(p)
    if key is None:
        return None
    with _OBS_LOCK:
        return _OBSERVED_ROWS.get(key)


def clear_observed_rows() -> None:
    with _OBS_LOCK:
        _OBSERVED_ROWS.clear()


# ---------------------------------------------------------------------------
# greedy ordering + tree construction
# ---------------------------------------------------------------------------

def _key_classes(edges: List[_Edge]) -> List[int]:
    """The class of each edge: edges whose key columns the equalities make
    equal share one (union-find over (leaf, key expression))."""
    parent: Dict[tuple, tuple] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ends = [((e.a, pn._rex_str(e.a_expr)), (e.b, pn._rex_str(e.b_expr)))
            for e in edges]
    for x, y in ends:
        parent[find(x)] = find(y)
    roots: Dict[tuple, int] = {}
    return [roots.setdefault(find(x), len(roots)) for x, _ in ends]


class _KeyModel:
    """Which leaves own which keys, and the distinct count of each key
    class (see the module docstring)."""

    def __init__(self, leaves: List[_Leaf], edges: List[_Edge]):
        self.leaves = leaves
        self.cls = _key_classes(edges)
        self.carriers: Dict[int, set] = {}
        for e, c in zip(edges, self.cls):
            self.carriers.setdefault(c, set()).update((e.a, e.b))
        self.ndv = {c: min(leaves[i].base_rows for i in ls)
                    for c, ls in self.carriers.items()}
        self.edge_class = {id(e): c for e, c in zip(edges, self.cls)}

    def owns(self, leaf: int, classes: frozenset) -> bool:
        """``leaf`` is the smallest of the leaves that carry every key
        class of ``classes``: its rows are taken as unique on them."""
        holders = set.intersection(*(self.carriers[c] for c in classes))
        return leaf in holders and self.leaves[leaf].base_rows <= min(
            self.leaves[i].base_rows for i in holders)

    def join(self, rows_s: float, grain: frozenset, r: int,
             es: List[_Edge]):
        """(linear, estimated rows, new grain) of joining leaf ``r`` to a
        set of ``rows_s`` rows whose rows each ``grain`` leaf's row
        appears in at most once, through edges ``es``."""
        by_leaf: Dict[int, set] = {}
        for e in es:
            other = e.b if e.a == r else e.a
            by_leaf.setdefault(other, set()).add(self.edge_class[id(e)])
        classes = frozenset(self.edge_class[id(e)] for e in es)
        r_unique = self.owns(r, classes) or any(
            self.owns(r, frozenset(k)) for k in by_leaf.values())
        s_unique = any(leaf in grain and self.owns(leaf, frozenset(k))
                       for leaf, k in by_leaf.items())
        card = rows_s * self.leaves[r].rows
        for c in classes:
            card /= max(self.ndv[c], 1.0)
        if r_unique:
            card = min(card, rows_s)
        if s_unique:
            card = min(card, self.leaves[r].rows)
        if r_unique and s_unique:
            grain = grain | {r}
        elif s_unique:
            grain = frozenset((r,))
        elif not r_unique:
            grain = frozenset()
        return r_unique or s_unique, max(card, 1.0), grain


def _greedy(leaves: List[_Leaf], edges: List[_Edge], residuals):
    """Greedy operator ordering: seed with the connected pair of smallest
    estimated output, then add the connected leaf of smallest estimated
    output; a join that grows faster than its larger side (neither side
    owns the keys) only where every connected candidate does."""
    n = len(leaves)
    model = _KeyModel(leaves, edges)
    by_pair: Dict[Tuple[int, int], List[_Edge]] = {}
    for e in edges:
        key = (min(e.a, e.b), max(e.a, e.b))
        by_pair.setdefault(key, []).append(e)

    # seed: the connected pair with the smallest estimated join output
    best = None
    for (a, b), es in by_pair.items():
        if leaves[b].rows < leaves[a].rows:
            a, b = b, a  # smaller side leads (build side of the first join)
        linear, card, grain = model.join(leaves[a].rows, frozenset((a,)), b,
                                         es)
        cand = (not linear, card, a, b, grain)
        if best is None or cand[:2] < best[:2]:
            best = cand
    if best is None:
        return None, None
    _, cur_rows, a, b, grain = best
    order = [a, b]
    remaining = set(range(n)) - {a, b}

    while remaining:
        in_set = set(order)
        cand = None
        for r in sorted(remaining):
            es = [e for e in edges
                  if (e.a == r and e.b in in_set)
                  or (e.b == r and e.a in in_set)]
            if not es:
                continue
            linear, c, g = model.join(cur_rows, grain, r, es)
            if cand is None or (not linear, c) < cand[:2]:
                cand = (not linear, c, r, g)
        if cand is None:
            # disconnected: take the smallest remaining as a cross join
            r = min(remaining, key=lambda i: leaves[i].rows)
            cand = (True, cur_rows * leaves[r].rows, r, frozenset())
        _, cur_rows, r, grain = cand
        order.append(r)
        remaining.discard(r)

    plan = _build_tree(leaves, edges, residuals, order)
    return order, plan


def _build_tree(leaves, edges, residuals, order):
    # position of each original column in the NEW tree as it grows
    new_offsets: Dict[int, int] = {}

    li0 = order[0]
    plan = leaves[li0].node
    new_offsets[li0] = 0
    width = leaves[li0].width
    in_set = {li0}
    pending_res = list(residuals)

    for r in order[1:]:
        es = [e for e in edges
              if (e.a == r and e.b in in_set) or (e.b == r and e.a in in_set)]
        lks, rks = [], []
        for e in es:
            if e.a == r:
                set_leaf, set_expr, r_expr = e.b, e.b_expr, e.a_expr
            else:
                set_leaf, set_expr, r_expr = e.a, e.a_expr, e.b_expr
            lks.append(rx.shift_refs(set_expr, new_offsets[set_leaf]))
            rks.append(r_expr)
        join_type = "inner" if lks else "cross"
        new_offsets[r] = width
        in_set.add(r)
        width += leaves[r].width
        # residual conjuncts that just became fully bound ride this join
        now, later = [], []
        for res in pending_res:
            (now if all(l in in_set for l in res.leaves) else later).append(res)
        pending_res = later
        residual = None
        if now:
            parts = [_rebind_global(res.expr, leaves, new_offsets)
                     for res in now]
            residual = parts[0]
            for x in parts[1:]:
                residual = rx.RCall("and", (residual, x), dt.BooleanType())
        plan = pn.JoinExec(plan, leaves[r].node, join_type,
                           tuple(lks), tuple(rks), residual)
    if pending_res:
        return None  # residual referencing an unreachable combination
    return plan


def _rebind_global(expr: rx.Rex, leaves, new_offsets) -> rx.Rex:
    remap = {}
    for i in rx.references(expr):
        li = _leaf_of_index(leaves, i)
        remap[i] = new_offsets[li] + (i - leaves[li].offset)
    return _remap(expr, remap)


def _remap(r: rx.Rex, remap: Dict[int, int]) -> rx.Rex:
    if isinstance(r, rx.BoundRef):
        return dataclasses.replace(r, index=remap.get(r.index, r.index))
    if isinstance(r, rx.RCall):
        return dataclasses.replace(
            r, args=tuple(_remap(a, remap) for a in r.args))
    if isinstance(r, rx.RCast):
        return dataclasses.replace(r, child=_remap(r.child, remap))
    if isinstance(r, rx.RLambda):
        return dataclasses.replace(r, body=_remap(r.body, remap))
    if isinstance(r, rx.RCase):
        return dataclasses.replace(
            r,
            branches=tuple((_remap(c, remap), _remap(v, remap))
                           for c, v in r.branches),
            else_value=None if r.else_value is None
            else _remap(r.else_value, remap))
    return r
