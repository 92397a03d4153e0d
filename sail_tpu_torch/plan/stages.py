"""Stage vocabulary: which operators fuse into a chain, and the structural
cache key of a fused chain's compiled program.

The PyTorch counterpart of the parts of ``sail_tpu/plan/stages.py`` the
port uses (``FUSABLE_OPS``, ``is_leaf``, ``agg_absorbs_chain``,
``node_fingerprint``, ``stage_fingerprint``). A Filter/Project chain runs
as one program (kernel K16 on the card, ``ops/chain.py``); an aggregate
whose grouping and aggregates allow it absorbs its chain into K17. The
executor keys each compiled program on ``stage_fingerprint`` (with the
dictionaries, the subquery values and the device beside it), so a
repeated query of the same shape compiles nothing.
"""

from __future__ import annotations

from . import nodes as pn

#: operators a pipeline fuses through
FUSABLE_OPS = (pn.FilterExec, pn.ProjectExec)


def is_leaf(p: pn.PlanNode) -> bool:
    """Pipeline sources: nodes with no plan children. They materialize a
    batch by nature (scan upload, host rows)."""
    return not p.children


def agg_absorbs_chain(p: pn.PlanNode) -> bool:
    """Host-evaluated and DISTINCT aggregates run apart from their input
    chain, which is then a program of its own."""
    return not any(a.fn.startswith("__host__") or a.distinct
                   for a in p.aggs)


def node_fingerprint(p: pn.PlanNode):
    """Structural key of ONE operator: type + the fields that shape its
    compiled program (expressions, indices, dtypes), never source data
    identity, which the caches layer on separately."""
    t = type(p).__name__
    if isinstance(p, pn.FilterExec):
        return (t, p.condition)
    if isinstance(p, pn.ProjectExec):
        return (t, p.exprs)
    if isinstance(p, pn.AggregateExec):
        return (t, p.group_indices, p.aggs, p.max_groups_hint)
    if isinstance(p, pn.SortExec):
        return (t, p.keys, p.limit)
    if isinstance(p, pn.WindowExec):
        return (t, p.windows)
    if isinstance(p, pn.JoinExec):
        return (t, p.join_type, p.left_keys, p.right_keys, p.residual,
                p.null_aware, p.runtime_filters)
    if isinstance(p, pn.LimitExec):
        return (t, p.limit, p.offset)
    return (t,)


def stage_fingerprint(nodes, bottom_schema) -> tuple:
    """Cache key for one fused stage's compiled program: the structural
    fingerprint of every compute operator in the pipeline (top-down)
    plus the source schema the bottom binds to."""
    return ("stage",
            tuple(node_fingerprint(n) for n in nodes if not is_leaf(n)),
            tuple((f.name, f.dtype) for f in bottom_schema))
