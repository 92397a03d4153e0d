"""Name/type resolution: spec IR → physical plan nodes.

Reference role: sail-plan's PlanResolver (crates/sail-plan/src/resolver/),
the single choke point from unresolved plans to executable ones. Includes
the subquery handling TPC-H requires:

- EXISTS / NOT EXISTS           → semi / anti join (correlated conjuncts
                                  become join keys; non-equi ones residual)
- [NOT] IN (subquery)           → semi / anti join on the output column
- uncorrelated scalar subquery  → RScalarSubquery (executor pre-evaluates)
- correlated scalar aggregate   → grouped subplan + left outer join
                                  (the classic decorrelation rewrite)

Aggregation resolution decomposes compound aggregates (avg → sum/count,
variance family → sum/sum²/count) and rewrites DISTINCT aggregates into
two-level grouping.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..functions import registry as freg
from ..spec import data_type as dt
from ..spec import expression as ex
from ..spec import plan as sp
from ..spec.literal import Literal as LV
from . import nodes as pn
from . import rex as rx


class ResolutionError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class ROuterRef(rx.Rex):
    """Reference to a column of the enclosing query (correlation marker)."""

    index: int
    name: str = ""
    dtype: dt.DataType = dataclasses.field(default_factory=dt.NullType)
    nullable: bool = True


@dataclasses.dataclass
class ScopeField:
    name: str
    qualifiers: Tuple[str, ...]
    dtype: dt.DataType
    nullable: bool


class Scope:
    def __init__(self, fields: List[ScopeField], parent: Optional["Scope"] = None,
                 ctes: Optional[Dict[str, sp.QueryPlan]] = None):
        self.fields = fields
        self.parent = parent
        self.ctes = dict(ctes or {})
        self.used_outer = False
        # (input_scope) of the projection that produced this scope — lets
        # ORDER BY reach columns that were projected away (SQL allows it)
        self.below: Optional["Scope"] = None

    def find(self, name: Tuple[str, ...]) -> Optional[int]:
        col = name[-1].lower()
        quals = tuple(q.lower() for q in name[:-1])
        matches = []
        for i, f in enumerate(self.fields):
            if f.name.lower() != col:
                continue
            fq = tuple(q.lower() for q in f.qualifiers)
            if quals and not _qual_suffix_match(fq, quals):
                continue
            matches.append(i)
        if len(matches) > 1:
            # identical duplicate columns (e.g. USING) resolve to the first
            raise ResolutionError(f"ambiguous column reference {'.'.join(name)!r}")
        return matches[0] if matches else None


def _qual_suffix_match(field_quals: Tuple[str, ...], ref_quals: Tuple[str, ...]) -> bool:
    if len(ref_quals) > len(field_quals):
        return False
    return field_quals[len(field_quals) - len(ref_quals):] == ref_quals


_FRESH = itertools.count()


def _fresh(prefix: str) -> str:
    return f"__{prefix}{next(_FRESH)}"


class Resolver:
    def __init__(self, catalog):
        self.catalog = catalog
        self._lambda_env = []  # stack of {param_name: dtype} for lambdas

    # ------------------------------------------------------------------
    def resolve(self, plan: sp.QueryPlan) -> pn.PlanNode:
        # Deterministic generated names: identical queries resolve to
        # structurally-equal plans, which keys the executor's compiled-
        # operator cache.
        global _FRESH
        _FRESH = itertools.count()
        node, _ = self.resolve_query(plan, None)
        return node

    # ------------------------------------------------------------------
    def resolve_query(self, plan: sp.QueryPlan, scope: Optional[Scope],
                      outer: Optional[Scope] = None) -> Tuple[pn.PlanNode, Scope]:
        """Resolve a query node. ``scope`` carries CTEs in effect; ``outer``
        is the enclosing query's scope for correlation."""
        ctes = scope.ctes if scope is not None else {}
        if isinstance(plan, sp.WithWatermark):
            return self.resolve_query(plan.input, scope, outer)
        if isinstance(plan, sp.ReadNamedTable):
            return self._resolve_read(plan, ctes, outer)
        if isinstance(plan, sp.ReadDataSource):
            return self._resolve_read_source(plan, outer)
        if isinstance(plan, sp.LocalRelation):
            return self._resolve_local(plan, outer)
        if isinstance(plan, sp.OneRow):
            return pn.OneRowExec(), Scope([], outer, ctes)
        if isinstance(plan, sp.Range):
            node = pn.RangeExec(plan.start, plan.end, plan.step,
                                plan.num_partitions or 1)
            return node, self._scope_of(node, None, outer, ctes)
        if isinstance(plan, sp.Values):
            return self._resolve_values(plan, outer, ctes)
        if isinstance(plan, sp.ReadUdtf):
            return self._resolve_udtf(plan, outer, ctes)
        if isinstance(plan, sp.WithCtes):
            new_ctes = dict(ctes)
            for name, q in plan.ctes:
                new_ctes[name.lower()] = _InlinedCte(q, dict(new_ctes))
            inner_scope = Scope([], outer, new_ctes)
            return self.resolve_query(plan.input, inner_scope, outer)
        if isinstance(plan, sp.SubqueryAlias):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            fields = [dataclasses.replace(f, qualifiers=(plan.alias,))
                      for f in cscope.fields]
            if plan.columns:
                if len(plan.columns) != len(fields):
                    raise ResolutionError(
                        f"alias {plan.alias} has {len(plan.columns)} columns, "
                        f"input has {len(fields)}")
                fields = [dataclasses.replace(f, name=n)
                          for f, n in zip(fields, plan.columns)]
                child = pn.ProjectExec(child, tuple(
                    (n, rx.BoundRef(i, child.schema[i].name,
                                    child.schema[i].dtype, child.schema[i].nullable))
                    for i, n in enumerate(plan.columns)))
            return child, Scope(fields, outer, ctes)
        if isinstance(plan, sp.UdtfCall):
            return self._resolve_udtf_call(plan, outer,
                                           scope.ctes if scope else {})
        if isinstance(plan, sp.GroupMap):
            return self._resolve_group_map(plan, scope, outer)
        if isinstance(plan, sp.CoGroupMap):
            return self._resolve_cogroup_map(plan, scope, outer)
        if isinstance(plan, sp.MapPartitions):
            return self._resolve_map_partitions(plan, scope, outer)
        if isinstance(plan, sp.Filter):
            return self._resolve_filter(plan, scope, outer)
        if isinstance(plan, sp.Project):
            return self._resolve_project(plan, scope, outer)
        if isinstance(plan, sp.Aggregate):
            return self._resolve_aggregate(plan, scope, outer)
        if isinstance(plan, sp.Join):
            return self._resolve_join(plan, scope, outer)
        if isinstance(plan, sp.Sort):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            keys = []
            hidden: List[rx.Rex] = []
            for so in plan.order:
                try:
                    e = self._ordinal_or_expr(so.child, cscope, child)
                except ResolutionError:
                    # ORDER BY repeating a select-list expression of a
                    # GROUP BY query (e.g. ORDER BY COUNT(*) DESC) binds
                    # to that output column — spec exprs are frozen
                    # dataclasses, so structural equality works
                    matched = self._match_aggregate_output(plan.input,
                                                           so.child, child)
                    if matched is not None:
                        keys.append(pn.SortKey(matched, so.ascending,
                                               so.nulls_first))
                        continue
                    if cscope.below is None or not isinstance(child, pn.ProjectExec):
                        raise
                    inner = self._resolve_expr(so.child, cscope.below)
                    e = rx.BoundRef(len(child.exprs) + len(hidden),
                                    _fresh("sort"), rx.rex_type(inner),
                                    rx.rex_nullable(inner))
                    hidden.append(inner)
                keys.append(pn.SortKey(e, so.ascending, so.nulls_first))
            if hidden:
                ext = pn.ProjectExec(child.input, tuple(
                    list(child.exprs)
                    + [(_fresh("sk"), h) for h in hidden]))
                sorted_node = pn.SortExec(ext, tuple(keys))
                trim = pn.ProjectExec(sorted_node, tuple(
                    (n, rx.BoundRef(i, n, rx.rex_type(e2), rx.rex_nullable(e2)))
                    for i, (n, e2) in enumerate(child.exprs)))
                return trim, cscope
            return pn.SortExec(child, tuple(keys)), cscope
        if isinstance(plan, sp.Limit):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            if isinstance(child, pn.SortExec) and plan.offset == 0 and plan.limit is not None:
                return dataclasses.replace(child, limit=plan.limit), cscope
            return pn.LimitExec(child, plan.limit, plan.offset), cscope
        if isinstance(plan, sp.Offset):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            return pn.LimitExec(child, None, plan.offset), cscope
        if isinstance(plan, sp.Deduplicate):
            return self._resolve_dedup(plan, scope, outer)
        if isinstance(plan, sp.SetOperation):
            return self._resolve_setop(plan, scope, outer)
        if isinstance(plan, sp.WithColumns):
            return self._resolve_with_columns(plan, scope, outer)
        if isinstance(plan, sp.WithColumnsRenamed):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            renames = dict(plan.renames)
            exprs = []
            fields = []
            for i, f in enumerate(child.schema):
                new_name = renames.get(f.name, f.name)
                exprs.append((new_name, rx.BoundRef(i, f.name, f.dtype, f.nullable)))
                fields.append(ScopeField(new_name, (), f.dtype, f.nullable))
            node = pn.ProjectExec(child, tuple(exprs))
            return node, Scope(fields, outer, ctes)
        if isinstance(plan, sp.Drop):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            dropped = {c.lower() for c in plan.columns}
            exprs = []
            fields = []
            for i, f in enumerate(child.schema):
                if f.name.lower() in dropped:
                    continue
                exprs.append((f.name, rx.BoundRef(i, f.name, f.dtype, f.nullable)))
                fields.append(cscope.fields[i])
            return pn.ProjectExec(child, tuple(exprs)), Scope(fields, outer, ctes)
        if isinstance(plan, sp.Repartition):
            # single-process executor: repartitioning is a no-op placeholder;
            # the distributed planner lowers it to a shuffle exchange.
            child, cscope = self.resolve_query(plan.input, scope, outer)
            return child, cscope
        if isinstance(plan, sp.Sample):
            return self._resolve_sample(plan, scope, outer)
        if isinstance(plan, sp.Tail):
            child, cscope = self.resolve_query(plan.input, scope, outer)
            return pn.LimitExec(child, plan.limit, -1), cscope
        raise ResolutionError(f"unsupported query node {type(plan).__name__}")

    # ------------------------------------------------------------------
    # leaves
    # ------------------------------------------------------------------
    def _resolve_read(self, plan: sp.ReadNamedTable, ctes, outer):
        key = plan.name[-1].lower()
        if len(plan.name) == 1 and key in ctes:
            if plan.temporal:
                raise ResolutionError(
                    f"time travel is not supported on a CTE: "
                    f"{plan.name[-1]}")
            cte = ctes[key]
            node, cscope = self.resolve_query(
                cte.plan, Scope([], outer, cte.ctes), outer)
            fields = [dataclasses.replace(f, qualifiers=(plan.name[-1],))
                      for f in cscope.fields]
            return node, Scope(fields, outer, ctes)
        if plan.temporal and len(plan.name) == 3 and \
                plan.name[0].lower() == "system":
            raise ResolutionError(
                "time travel is not supported on system tables")
        if len(plan.name) == 3 and plan.name[0].lower() == "system":
            raise NotImplementedError("system tables are not ported yet")
        entry = self.catalog.lookup_table(plan.name)
        if entry is None:
            raise ResolutionError(f"table not found: {'.'.join(plan.name)}")
        if entry.view_plan is not None:
            if plan.temporal:
                raise ResolutionError(
                    f"time travel is not supported on views: "
                    f"{'.'.join(plan.name)}")
            node, cscope = self.resolve_query(entry.view_plan, Scope([], None, {}), None)
            fields = [dataclasses.replace(f, qualifiers=(plan.name[-1],))
                      for f in cscope.fields]
            return node, Scope(fields, outer, ctes)
        schema = tuple(pn.Field(f.name, f.data_type, f.nullable)
                       for f in entry.schema.fields)
        # catalog-vended options (e.g. an Iceberg metadata_location pin)
        # apply first; per-read options override them
        opts = dict(entry.options)
        opts.update(dict(plan.options))
        if plan.temporal:
            # SQL time travel (VERSION|TIMESTAMP AS OF) → the reader's
            # time-travel scan options; malformed specs are analysis
            # errors, not reader-time crashes
            raise NotImplementedError("time travel is not ported yet")
        node = pn.ScanExec(schema, entry.data, tuple(entry.paths), entry.format,
                           tuple(sorted(opts.items())), None,
                           ".".join(plan.name))
        qual = plan.name[-1]
        fields = [ScopeField(f.name, (qual,), f.dtype, f.nullable) for f in schema]
        return node, Scope(fields, outer, ctes)

    def _resolve_read_source(self, plan: sp.ReadDataSource, outer):
        raise NotImplementedError(
            f"reading {plan.format!r} sources is not ported yet")

    def _resolve_local(self, plan: sp.LocalRelation, outer):
        import pyarrow as pa
        from ..columnar.arrow_interop import arrow_type_to_spec
        table = plan.data
        assert isinstance(table, pa.Table)
        out = tuple(pn.Field(n, arrow_type_to_spec(t), True)
                    for n, t in zip(table.column_names, [c.type for c in table.columns]))
        node = pn.ScanExec(out, table, (), "memory")
        fields = [ScopeField(f.name, (), f.dtype, f.nullable) for f in out]
        return node, Scope(fields, outer, {})

    def _resolve_values(self, plan: sp.Values, outer, ctes):
        rows = []
        types: List[dt.DataType] = []
        exprs_rows = []
        all_literals = True
        for row in plan.rows:
            vals = []
            rexes = []
            for j, e in enumerate(row):
                r = self._resolve_expr(e, Scope([], None, {}))
                rexes.append(r)
                if isinstance(r, rx.RLit):
                    vals.append(r.value)
                    t = r.value.data_type
                else:
                    all_literals = False
                    vals.append(None)
                    t = rx.rex_type(r)
                if j >= len(types):
                    types.append(t)
                elif not isinstance(t, dt.NullType):
                    types[j] = t if isinstance(types[j], dt.NullType) \
                        else dt.common_type(types[j], t)
            rows.append(tuple(vals))
            exprs_rows.append(rexes)
        schema = tuple(pn.Field(f"col{j + 1}", t, True) for j, t in enumerate(types))
        if all_literals:
            node: pn.PlanNode = pn.ValuesExec(schema, tuple(rows))
        else:
            # general expressions: each row projects over OneRow, unioned
            parts = []
            for rexes in exprs_rows:
                exprs = tuple((schema[j].name,
                               rexes[j] if rx.rex_type(rexes[j]) ==
                               schema[j].dtype or isinstance(
                                   schema[j].dtype, dt.NullType)
                               else rx.RCast(rexes[j], schema[j].dtype))
                              for j in range(len(rexes)))
                parts.append(pn.ProjectExec(pn.OneRowExec(), exprs))
            node = parts[0] if len(parts) == 1 else pn.UnionExec(
                tuple(parts), True)
        fields = [ScopeField(f.name, (), f.dtype, f.nullable) for f in schema]
        return node, Scope(fields, outer, ctes)

    def _resolve_udtf(self, plan: sp.ReadUdtf, outer, ctes):
        if plan.name == "range":
            if not 1 <= len(plan.args) <= 4:
                raise ResolutionError(
                    f"range() takes 1-4 arguments, got {len(plan.args)}")
            vals = []
            for a in plan.args:
                r = self._resolve_expr(a, Scope([], None, {}))
                if not isinstance(r, rx.RLit):
                    raise ResolutionError("range() arguments must be literals")
                try:
                    vals.append(int(r.value.value))
                except (TypeError, ValueError) as e:
                    raise ResolutionError(
                        f"range() arguments must be integers: {e}") from e
            if len(vals) == 1:
                start, end, step = 0, vals[0], 1
            else:
                start, end = vals[0], vals[1]
                step = vals[2] if len(vals) > 2 else 1
            if step == 0:
                raise ResolutionError("range() step must not be zero")
            node = pn.RangeExec(start, end, step, 1)
            return node, self._scope_of(node, "range", outer, ctes)
        reg = getattr(self.catalog, "udfs", None)
        entry = reg.get_udtf(plan.name) if reg is not None else None
        if entry is not None:
            handler, rt = entry
            return self._resolve_udtf_call(
                sp.UdtfCall(handler, tuple(plan.args), rt, plan.name),
                outer, ctes)
        raise ResolutionError(f"unknown table function {plan.name!r}")

    def _scope_of(self, node: pn.PlanNode, qual, outer, ctes) -> Scope:
        quals = (qual,) if qual else ()
        return Scope([ScopeField(f.name, quals, f.dtype, f.nullable)
                      for f in node.schema], outer, ctes)

    @staticmethod
    def _match_aggregate_output(spec_input, sort_expr, child):
        """ORDER BY <expr> where <expr> structurally equals a select-list
        item of the input Aggregate → BoundRef to that output column."""
        from ..spec import expression as _ex

        node = spec_input
        if not isinstance(node, sp.Aggregate):
            return None

        def strip(e):
            return e.child if isinstance(e, _ex.Alias) else e

        target = strip(sort_expr)
        for i, ae in enumerate(node.aggregate):
            if strip(ae) == target and i < len(child.schema):
                f = child.schema[i]
                return rx.BoundRef(i, f.name, f.dtype, f.nullable)
        return None

    # ------------------------------------------------------------------
    # PySpark UDF relations (applyInPandas / cogroup / mapInPandas)
    # ------------------------------------------------------------------
    @staticmethod
    def _udf_out_schema(udf) -> Tuple[pn.Field, ...]:
        st = udf.return_type
        if not isinstance(st, dt.StructType):
            raise ResolutionError(
                f"{udf.name}: group/map UDFs must declare a struct return "
                f"type, got {st.simple_string()}")
        return tuple(pn.Field(f.name, f.data_type, True) for f in st.fields)

    def _key_indices(self, exprs, cscope, what) -> Tuple[int, ...]:
        out = []
        for e in exprs:
            r = self._resolve_expr(e, cscope)
            if not isinstance(r, rx.BoundRef):
                raise ResolutionError(
                    f"{what}: grouping expressions must be plain input "
                    f"columns")
            out.append(r.index)
        return tuple(out)

    def _resolve_udtf_call(self, plan: sp.UdtfCall, outer, ctes):
        vals = []
        for a in plan.args:
            r = self._resolve_expr(a, Scope([], None, {}))
            if not isinstance(r, rx.RLit):
                raise ResolutionError(
                    f"UDTF {plan.name}: arguments must be literals")
            vals.append(None if r.value.is_null else r.value.value)
        st = plan.return_type
        out = tuple(pn.Field(f.name, f.data_type, True) for f in st.fields)
        node = pn.UdtfExec(plan.handler, tuple(vals), out, plan.name)
        return node, self._scope_of(node, plan.name, outer, ctes)

    def _resolve_group_map(self, plan: sp.GroupMap, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        keys = self._key_indices(plan.grouping, cscope, "applyInPandas")
        node = pn.GroupMapExec(child, keys, plan.udf,
                               self._udf_out_schema(plan.udf))
        return node, self._scope_of(node, None, outer,
                                    scope.ctes if scope else {})

    def _resolve_cogroup_map(self, plan: sp.CoGroupMap, scope, outer):
        left, lscope = self.resolve_query(plan.input, scope, outer)
        right, rscope = self.resolve_query(plan.other, scope, outer)
        lk = self._key_indices(plan.input_grouping, lscope, "cogroup")
        rk = self._key_indices(plan.other_grouping, rscope, "cogroup")
        if len(lk) != len(rk):
            raise ResolutionError("cogroup: mismatched grouping arity")
        node = pn.CoGroupMapExec(left, right, lk, rk, plan.udf,
                                 self._udf_out_schema(plan.udf))
        return node, self._scope_of(node, None, outer,
                                    scope.ctes if scope else {})

    def _resolve_map_partitions(self, plan: sp.MapPartitions, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        node = pn.MapPartitionsExec(child, plan.udf,
                                    self._udf_out_schema(plan.udf))
        return node, self._scope_of(node, None, outer,
                                    scope.ctes if scope else {})

    # ------------------------------------------------------------------
    # filter + subquery rewrites
    # ------------------------------------------------------------------
    def _resolve_filter(self, plan: sp.Filter, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        conjuncts = _split_conjuncts(plan.condition)
        plain: List[ex.Expr] = []
        for c in conjuncts:
            rewritten = self._try_subquery_conjunct(c, child, cscope)
            if rewritten is not None:
                child, cscope = rewritten
            else:
                plain.append(c)
        if plain:
            cond = self._resolve_predicate(_and_all(plain), cscope)
            child = pn.FilterExec(child, cond)
        return child, cscope

    def _try_subquery_conjunct(self, c: ex.Expr, child: pn.PlanNode,
                               cscope: Scope):
        """Rewrite EXISTS/IN/correlated-scalar conjuncts into joins.
        Returns (new_child, new_scope) or None if not a subquery conjunct."""
        if isinstance(c, ex.Exists):
            return self._rewrite_exists(c.plan, c.negated, None, child, cscope)
        if isinstance(c, ex.Function) and c.name == "not" and \
                isinstance(c.args[0], ex.Exists):
            inner = c.args[0]
            return self._rewrite_exists(inner.plan, not inner.negated, None,
                                        child, cscope)
        if isinstance(c, ex.InSubquery):
            return self._rewrite_exists(c.plan, c.negated, c.child, child, cscope)
        if isinstance(c, ex.Function) and c.name == "not" and \
                isinstance(c.args[0], ex.InSubquery):
            inner = c.args[0]
            return self._rewrite_exists(inner.plan, not inner.negated,
                                        inner.child, child, cscope)
        # correlated scalar comparison: cmp(expr, subquery) / cmp(subquery, expr)
        if isinstance(c, ex.Function) and len(c.args) == 2:
            for i in (0, 1):
                if isinstance(c.args[i], ex.ScalarSubquery):
                    sub = c.args[i]
                    if self._is_correlated(sub.plan, cscope):
                        return self._rewrite_correlated_scalar(
                            c, i, sub.plan, child, cscope)
        return None

    def _is_correlated(self, sub_plan: sp.QueryPlan, outer_scope: Scope) -> bool:
        try:
            probe = Scope([], None, dict(outer_scope.ctes))
            node, sscope = self.resolve_query(sub_plan, probe, outer_scope)
            return _plan_has_outer_refs(node)
        except ResolutionError:
            return True  # resolution failed standalone → assume correlated

    def _rewrite_exists(self, sub_plan: sp.QueryPlan, negated: bool,
                        in_child: Optional[ex.Expr], child: pn.PlanNode,
                        cscope: Scope):
        sub_node, sub_scope = self.resolve_query(
            sub_plan, Scope([], None, dict(cscope.ctes)), cscope)
        sub_node, left_keys, right_keys, residual = _decorrelate(sub_node)
        if in_child is not None:
            # IN: add equality on the subquery's (single) output column.
            # Both sides are cast to the common key type — the join kernel
            # packs keys at the probe key's width, so an uncast wider build
            # key would alias (e.g. int32 IN (SELECT bigint)).
            probe = self._resolve_expr(in_child, cscope)
            if len(sub_node.schema) < 1:
                raise ResolutionError("IN subquery must output one column")
            f0 = sub_node.schema[0]
            build: rx.Rex = rx.BoundRef(0, f0.name, f0.dtype, f0.nullable)
            ktype = dt.common_type(rx.rex_type(probe), f0.dtype)
            if rx.rex_type(probe) != ktype:
                probe = rx.RCast(probe, ktype)
            if f0.dtype != ktype:
                build = rx.RCast(build, ktype)
            left_keys = left_keys + [probe]
            right_keys = right_keys + [build]
        join_type = "anti" if negated else "semi"
        node = pn.JoinExec(child, sub_node, join_type,
                           tuple(left_keys), tuple(right_keys),
                           _combine_residual(residual, len(child.schema)),
                           null_aware=negated and in_child is not None)
        return node, cscope

    def _rewrite_correlated_scalar(self, cmp: ex.Function, sub_pos: int,
                                   sub_plan: sp.QueryPlan, child: pn.PlanNode,
                                   cscope: Scope):
        sub_node, sub_scope = self.resolve_query(
            sub_plan, Scope([], None, dict(cscope.ctes)), cscope)
        # sub_node must be an aggregation producing one value. Strip the
        # correlated conjuncts from the filter chain under the aggregate's
        # pre-projection, then group by those correlation keys.
        if not (isinstance(sub_node, pn.ProjectExec)
                and isinstance(sub_node.input, pn.AggregateExec)):
            raise ResolutionError("correlated scalar subquery must be a "
                                  "single aggregate query")
        agg = sub_node.input
        pre = agg.input
        assert isinstance(pre, pn.ProjectExec)
        new_src, left_keys, right_keys, residual = _strip_correlated_filters(pre.input)
        if residual:
            raise ResolutionError(
                "correlated scalar subquery with non-equality correlation")
        if not left_keys:
            raise ResolutionError("scalar subquery classified correlated but "
                                  "no correlation keys found")
        new_pre = dataclasses.replace(pre, input=new_src)
        sub_node = dataclasses.replace(
            sub_node, input=dataclasses.replace(agg, input=new_pre))
        grouped, val_index, key_indices = _group_scalar_subplan(sub_node, right_keys)
        n_left = len(child.schema)
        joined = pn.JoinExec(child, grouped, "left", tuple(left_keys),
                             tuple(rx.BoundRef(i, grouped.schema[i].name,
                                               grouped.schema[i].dtype, True)
                                   for i in key_indices), None)
        # rebuild comparison with the value column substituted
        vf = grouped.schema[val_index]
        val_ref = rx.BoundRef(n_left + val_index, vf.name, vf.dtype, True)
        other = self._resolve_expr(cmp.args[1 - sub_pos], cscope)
        args = (other, val_ref) if sub_pos == 1 else (val_ref, other)
        cond = self._make_call(cmp.name, list(args))
        filtered = pn.FilterExec(joined, cond)
        # project back to the outer columns only
        exprs = tuple((f.name, rx.BoundRef(i, f.name, f.dtype, f.nullable))
                      for i, f in enumerate(child.schema))
        node = pn.ProjectExec(filtered, exprs)
        return node, cscope

    # ------------------------------------------------------------------
    # project / aggregate
    # ------------------------------------------------------------------
    def _expand_star(self, items: Sequence[ex.Expr], cscope: Scope) -> List[ex.Expr]:
        out: List[ex.Expr] = []
        for item in items:
            target = None
            if isinstance(item, ex.Star):
                target = item.target
            elif isinstance(item, ex.Function) and item.name == "count" and \
                    len(item.args) == 1 and isinstance(item.args[0], ex.Star):
                out.append(item)
                continue
            if target is None:
                out.append(item)
                continue
            quals = tuple(q.lower() for q in target)
            for f in cscope.fields:
                fq = tuple(q.lower() for q in f.qualifiers)
                if not quals or _qual_suffix_match(fq, quals):
                    parts = f.qualifiers[-1:] + (f.name,) if f.qualifiers else (f.name,)
                    out.append(ex.Attribute(parts))
        return out

    def _output_name(self, e: ex.Expr) -> str:
        if isinstance(e, ex.Alias):
            return e.name[-1]
        if isinstance(e, ex.Attribute):
            return e.name[-1]
        if isinstance(e, ex.Function):
            return f"{e.name}({', '.join(self._output_name(a) for a in e.args)})"
        if isinstance(e, ex.Literal):
            return str(e.value.value)
        if isinstance(e, ex.Cast):
            return self._output_name(e.child)
        if isinstance(e, ex.CaseWhen):
            return "CASE"
        if isinstance(e, ex.Extract):
            return e.field_name
        if isinstance(e, ex.Star):
            return "*"
        return type(e).__name__.lower()

    def _resolve_project(self, plan: sp.Project, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer) \
            if plan.input is not None else (pn.OneRowExec(), Scope([], outer, {}))
        items = self._expand_star(plan.expressions, cscope)
        if any(_is_generator(_unalias(e)) for e in items):
            return self._resolve_generate(items, child, cscope, outer)
        if any(_has_window(e) for e in items):
            return self._resolve_window_project(items, child, cscope, outer)
        # implicit global aggregate: SELECT sum(x) FROM t
        if any(_has_aggregate(e) for e in items):
            agg = sp.Aggregate(plan.input if plan.input is not None else sp.OneRow(),
                               (), tuple(items))
            return self._resolve_aggregate(agg, scope, outer,
                                           pre_resolved=(child, cscope))
        exprs = []
        fields = []
        alias_env: Dict[str, rx.Rex] = {}
        for item in items:
            name = self._output_name(item)
            try:
                r = self._resolve_expr(_unalias(item), cscope)
            except ResolutionError:
                # lateral column alias: a select item may reference an
                # EARLIER item's alias (Spark 3.4 semantics)
                if not alias_env:
                    raise
                r = self._resolve_expr(
                    _subst_alias(_unalias(item), alias_env), cscope)
            exprs.append((name, r))
            alias_env[name] = r
            fields.append(ScopeField(name, (), rx.rex_type(r), rx.rex_nullable(r)))
        node = pn.ProjectExec(child, tuple(exprs))
        out_scope = Scope(fields, outer, cscope.ctes)
        out_scope.below = cscope
        return node, out_scope

    # -- generators (explode / posexplode / inline / stack) ---------------
    def _resolve_generate(self, items, child: pn.PlanNode, cscope: Scope,
                          outer):
        """SELECT-list generators become a GenerateExec over the child
        (reference role: generator functions + Spark's Generate node)."""
        gen_idx = [i for i, it in enumerate(items)
                   if _is_generator(_unalias(it))]
        if len(gen_idx) != 1:
            raise ResolutionError(
                "exactly one generator function per SELECT list")
        gi = gen_idx[0]
        gen = _unalias(items[gi])
        name = gen.name.lower()
        outer_gen = name.endswith("_outer")
        base = name[:-6] if outer_gen else name
        args = [self._resolve_expr(a, cscope) for a in gen.args]
        aliases = tuple(items[gi].name) if isinstance(items[gi], ex.Alias) \
            else ()
        # passthrough items (plain columns only, before/after the generator)
        passthrough = []
        for i, it in enumerate(items):
            if i == gi:
                continue
            r = self._resolve_expr(_unalias(it), cscope)
            passthrough.append((self._output_name(it), r))
        at = rx.rex_type(args[0]) if args else dt.NullType()
        if base in ("explode", "posexplode") and not isinstance(
                at, (dt.ArrayType, dt.MapType, dt.NullType)):
            raise ResolutionError(
                f"{base}() requires an array or map argument, got "
                f"{at.simple_string()}")
        if base == "explode":
            if isinstance(at, dt.MapType):
                gcols = [("key", at.key_type), ("value", at.value_type)]
            else:
                et = at.element_type if isinstance(at, dt.ArrayType) \
                    else dt.NullType()
                gcols = [("col", et)]
        elif base == "posexplode":
            if isinstance(at, dt.MapType):
                gcols = [("pos", dt.IntegerType()), ("key", at.key_type),
                         ("value", at.value_type)]
            else:
                et = at.element_type if isinstance(at, dt.ArrayType) \
                    else dt.NullType()
                gcols = [("pos", dt.IntegerType()), ("col", et)]
        elif base == "inline":
            et = at.element_type if isinstance(at, dt.ArrayType) \
                else dt.NullType()
            if not isinstance(et, dt.StructType):
                raise ResolutionError("inline requires array<struct>")
            gcols = [(f.name, f.data_type) for f in et.fields]
        elif base == "json_tuple":
            gcols = [(f"c{i}", dt.StringType())
                     for i in range(len(args) - 1)]
        elif base == "stack":
            if not args or not isinstance(args[0], rx.RLit):
                raise ResolutionError("stack requires a literal row count")
            n_rows = int(args[0].value.value)
            if n_rows <= 0:
                raise ResolutionError("stack row count must be positive")
            vals = args[1:]
            per = -(-len(vals) // n_rows)
            gcols = []
            for c in range(per):
                col_ts = [rx.rex_type(vals[r * per + c])
                          for r in range(n_rows) if r * per + c < len(vals)]
                ct = col_ts[0] if col_ts else dt.NullType()
                for t in col_ts[1:]:
                    if not isinstance(t, dt.NullType):
                        ct = t if isinstance(ct, dt.NullType) \
                            else dt.common_type(ct, t)
                gcols.append((f"col{c}", ct))
        else:
            raise ResolutionError(f"unknown generator {name!r}")
        if aliases:
            if len(aliases) == len(gcols):
                gcols = [(a, t) for a, (_, t) in zip(aliases, gcols)]
            elif len(aliases) == 1 and len(gcols) == 1:
                gcols = [(aliases[0], gcols[0][1])]
            else:
                raise ResolutionError(
                    f"generator produces {len(gcols)} columns but "
                    f"{len(aliases)} aliases were given")
        node: pn.PlanNode = pn.GenerateExec(
            child, base, tuple(args), outer_gen, tuple(passthrough),
            tuple(pn.Field(n, t, True) for n, t in gcols))
        # GenerateExec lays out passthrough then generator columns;
        # restore the declared SELECT order POSITIONALLY (names may
        # collide between passthrough and generator outputs)
        n_pt = len(passthrough)
        declared_pos = []
        pt_i = 0
        for i, _ in enumerate(items):
            if i == gi:
                declared_pos.extend(n_pt + j for j in range(len(gcols)))
            else:
                declared_pos.append(pt_i)
                pt_i += 1
        if declared_pos != list(range(len(node.schema))):
            gschema = node.schema
            node = pn.ProjectExec(node, tuple(
                (gschema[j].name, rx.BoundRef(j, gschema[j].name,
                                              gschema[j].dtype,
                                              gschema[j].nullable))
                for j in declared_pos))
        fields = [ScopeField(f.name, (), f.dtype, f.nullable)
                  for f in node.schema]
        return node, Scope(fields, outer, cscope.ctes)

    def _resolve_window_project(self, items, child: pn.PlanNode, cscope: Scope,
                                outer):
        """SELECT items containing window expressions: pre-project the
        partition/order/arg columns, run WindowExec, post-project."""
        n_child = len(child.schema)
        pre_exprs: List[Tuple[str, rx.Rex]] = [
            (f.name, rx.BoundRef(i, f.name, f.dtype, f.nullable))
            for i, f in enumerate(child.schema)]

        def add_pre(r: rx.Rex) -> int:
            for i, (_, e) in enumerate(pre_exprs):
                if e == r:
                    return i
            pre_exprs.append((_fresh("w"), r))
            return len(pre_exprs) - 1

        specs: List[pn.WindowSpec] = []
        spec_index: Dict[ex.Window, int] = {}

        def make_spec(w: ex.Window) -> int:
            if w in spec_index:
                return spec_index[w]
            part_idx = tuple(add_pre(self._resolve_expr(p, cscope))
                             for p in w.partition_by)
            order_keys = []
            for so in w.order_by:
                r = self._resolve_expr(so.child, cscope)
                order_keys.append(pn.SortKey(
                    rx.BoundRef(add_pre(r), "", rx.rex_type(r), rx.rex_nullable(r)),
                    so.ascending, so.nulls_first))
            f = w.function
            assert isinstance(f, ex.Function)
            fname = f.name.lower()
            arg_i = None
            options: List[Tuple[str, object]] = []
            out_t: dt.DataType
            if fname in ("row_number", "rank", "dense_rank"):
                out_t = dt.LongType()
            elif fname in ("percent_rank", "cume_dist"):
                out_t = dt.DoubleType()
            elif fname == "ntile":
                out_t = dt.LongType()
                nt = f.args[0]
                if not isinstance(nt, ex.Literal):
                    raise ResolutionError("ntile() requires a literal bucket count")
                n_tiles = int(nt.value.value)
                if n_tiles <= 0:
                    raise ResolutionError(
                        f"ntile() bucket count must be positive, got {n_tiles}")
                options.append(("n", n_tiles))
            elif fname == "nth_value":
                arg = self._resolve_expr(f.args[0], cscope)
                arg_i = add_pre(arg)
                out_t = rx.rex_type(arg)
                if len(f.args) < 2 or not isinstance(f.args[1], ex.Literal):
                    raise ResolutionError(
                        "nth_value() requires a literal offset")
                options.append(("n", int(f.args[1].value.value)))
            elif fname in ("lag", "lead"):
                arg = self._resolve_expr(f.args[0], cscope)
                arg_i = add_pre(arg)
                out_t = rx.rex_type(arg)
                offset = 1
                if len(f.args) > 1:
                    if not isinstance(f.args[1], ex.Literal):
                        raise ResolutionError(
                            f"{fname}() offset must be a literal")
                    offset = int(f.args[1].value.value)
                default = None
                if len(f.args) > 2:
                    if not isinstance(f.args[2], ex.Literal):
                        raise ResolutionError(
                            f"{fname}() default must be a literal")
                    default = f.args[2].value.value
                options.append(("offset", offset if fname == "lag" else -offset))
                options.append(("default", default))
            elif fname in ("sum", "count", "min", "max", "avg", "mean",
                           "first", "last", "first_value", "last_value"):
                canon = {"mean": "avg", "first_value": "first",
                         "last_value": "last"}.get(fname, fname)
                fname = canon
                if f.args and not isinstance(f.args[0], ex.Star):
                    arg = self._resolve_expr(f.args[0], cscope)
                    arg_i = add_pre(arg)
                    at = rx.rex_type(arg)
                else:
                    at = dt.LongType()
                out_t = freg.aggregate_result_type(
                    "avg" if canon == "avg" else canon, at)
                if canon in ("first", "last") and f.ignore_nulls:
                    # first(v, true): the parser's ignore_nulls
                    options.append(("ignore_nulls", True))
            else:
                raise ResolutionError(f"window function {fname!r} not supported")
            frame_type = "rows"
            lower: Optional[int] = None
            upper: Optional[int] = 0
            if w.frame is not None:
                frame_type = w.frame.frame_type
                lower, upper = w.frame.lower, w.frame.upper
            elif fname in ("sum", "count", "min", "max", "avg", "first",
                           "last", "nth_value"):
                if not w.order_by:
                    upper = None  # whole partition when no ORDER BY
                else:
                    frame_type = "range"  # Spark default frame is RANGE
            specs.append(pn.WindowSpec(fname, arg_i, part_idx,
                                       tuple(order_keys), frame_type, lower,
                                       upper, out_t, tuple(options)))
            spec_index[w] = len(specs) - 1
            return len(specs) - 1

        # first pass: allocate all specs
        def scan(e: ex.Expr):
            if isinstance(e, ex.Window):
                make_spec(e)
                return
            for c in _expr_children(e):
                scan(c)

        for it in items:
            scan(it)
        pre_node = pn.ProjectExec(child, tuple(pre_exprs))
        win_node = pn.WindowExec(pre_node, tuple(specs),
                                 tuple(_fresh("wout") for _ in specs))
        n_pre = len(pre_exprs)

        # second pass: resolve items with Window → BoundRef substitution
        win_scope = Scope(list(cscope.fields), outer, cscope.ctes)

        def resolve_with_windows(e: ex.Expr) -> rx.Rex:
            if isinstance(e, ex.Window):
                i = spec_index[e]
                s = specs[i]
                return rx.BoundRef(n_pre + i, win_node.out_names[i],
                                   s.out_dtype, True)
            if isinstance(e, ex.Alias):
                return resolve_with_windows(e.child)
            if isinstance(e, ex.Function) and not freg.is_aggregate(e.name):
                args = [resolve_with_windows(a) for a in e.args]
                return self._finish_function(e.name, args)
            if isinstance(e, ex.Cast):
                return rx.RCast(resolve_with_windows(e.child), e.data_type, e.try_)
            if isinstance(e, ex.CaseWhen):
                branches = tuple((resolve_with_windows(c), resolve_with_windows(v))
                                 for c, v in e.branches)
                relse = resolve_with_windows(e.else_value) \
                    if e.else_value is not None else None
                vt = [rx.rex_type(v) for _, v in branches]
                if relse is not None:
                    vt.append(rx.rex_type(relse))
                out_t = vt[0]
                for t in vt[1:]:
                    if not isinstance(t, dt.NullType):
                        out_t = t if isinstance(out_t, dt.NullType) \
                            else dt.common_type(out_t, t)
                return rx.RCase(branches, relse, out_t, True)
            if isinstance(e, ex.Between):
                child_r = resolve_with_windows(e.child)
                low = resolve_with_windows(e.low)
                high = resolve_with_windows(e.high)
                r = self._make_call("and",
                                    [self._make_call(">=", [child_r, low]),
                                     self._make_call("<=", [child_r, high])])
                return self._make_call("not", [r]) if e.negated else r
            if isinstance(e, ex.InList):
                child_r = resolve_with_windows(e.child)
                vals = [resolve_with_windows(v) for v in e.values]
                r = rx.RCall("in", tuple([child_r] + vals), dt.BooleanType(), True)
                return self._make_call("not", [r]) if e.negated else r
            if isinstance(e, ex.Like):
                child_r = resolve_with_windows(e.child)
                pattern = resolve_with_windows(e.pattern)
                fn = "ilike" if e.case_insensitive else "like"
                opts = (("escape", e.escape),) if e.escape else ()
                r = rx.RCall(fn, (child_r, pattern), dt.BooleanType(), True, opts)
                return self._make_call("not", [r]) if e.negated else r
            if isinstance(e, ex.Extract):
                return self._resolve_expr(e, cscope) if not _has_window(e) else \
                    self._finish_function(e.field_name, [resolve_with_windows(e.child)])
            return self._resolve_expr(e, cscope)

        post = []
        fields = []
        for it in items:
            name = self._output_name(it)
            r = resolve_with_windows(_unalias(it))
            post.append((name, r))
            fields.append(ScopeField(name, (), rx.rex_type(r), rx.rex_nullable(r)))
        node = pn.ProjectExec(win_node, tuple(post))
        out_scope = Scope(fields, outer, cscope.ctes)
        out_scope.below = cscope
        return node, out_scope

    def _resolve_aggregate(self, plan: sp.Aggregate, scope, outer,
                           pre_resolved=None):
        if plan.grouping_sets is not None or plan.rollup or plan.cube:
            return self._resolve_grouping_sets(plan, scope, outer)
        rewritten = self._rewrite_time_window(plan)
        if rewritten is not plan:
            plan, pre_resolved = rewritten, None
        if pre_resolved is not None:
            child, cscope = pre_resolved
        else:
            child, cscope = self.resolve_query(plan.input, scope, outer)
        items = self._expand_star(plan.aggregate, cscope)
        # group expressions (support ordinals and output aliases)
        group_exprs: List[ex.Expr] = []
        for g in plan.group:
            if isinstance(g, ex.Literal) and g.value.data_type.is_integer:
                idx = int(g.value.value) - 1
                if not (0 <= idx < len(items)):
                    raise ResolutionError(f"GROUP BY ordinal {idx + 1} out of range")
                group_exprs.append(_unalias(items[idx]))
            else:
                group_exprs.append(_unalias(self._subst_alias(g, items)))
        group_rex = [self._resolve_expr(g, cscope) for g in group_exprs]

        collector = _AggCollector(self, cscope, group_exprs, group_rex)
        out_items: List[Tuple[str, ex.Expr]] = []
        for item in items:
            out_items.append((self._output_name(item), _unalias(item)))
        post_exprs = [(n, collector.rewrite(e)) for n, e in out_items]
        having_rex = None
        if plan.having is not None:
            having_rex = collector.rewrite(self._subst_alias(plan.having, items))

        # a DISTINCT host aggregate of several arguments dedupes the rows'
        # struct of them: the two-level plan would group by that struct
        # (the reference's raises or dedupes nothing), so the specs keep
        # their flags
        mixed_distinct = collector.has_distinct and any(
            not a.spec.distinct or (
                a.arg is not None and
                isinstance(rx.rex_type(collector.arg_rex[a.arg]),
                           dt.StructType))
            for a in collector.aggs)

        # pre-projection: group keys then agg args
        pre = [( _fresh("g"), g) for g in group_rex]
        for a_rex in collector.arg_rex:
            pre.append((_fresh("a"), a_rex))
        pre_node = pn.ProjectExec(child, tuple(pre))
        ngroup = len(group_rex)

        if collector.has_distinct and not mixed_distinct:
            # two-level: group by keys + distinct args, then aggregate
            inner = pn.AggregateExec(
                pre_node,
                tuple(range(len(pre))),
                (),
                tuple(n for n, _ in pre))
            specs = []
            for a in collector.aggs:
                arg = None if a.arg is None else ngroup + a.arg
                # the inner dedup already realized DISTINCT
                specs.append(dataclasses.replace(a.spec, arg=arg,
                                                 distinct=False))
            agg_node = pn.AggregateExec(
                inner, tuple(range(ngroup)), tuple(specs),
                tuple(n for n, _ in pre[:ngroup])
                + tuple(_fresh("agg") for _ in specs))
        else:
            # mixed DISTINCT/non-DISTINCT: specs keep their distinct flags
            # and the executor's host aggregation applies them per spec
            specs = []
            for a in collector.aggs:
                arg = None if a.arg is None else ngroup + a.arg
                specs.append(dataclasses.replace(a.spec, arg=arg))
            agg_node = pn.AggregateExec(
                pre_node, tuple(range(ngroup)), tuple(specs),
                tuple(n for n, _ in pre[:ngroup])
                + tuple(_fresh("agg") for _ in specs))

        post = pn.ProjectExec(agg_node, tuple(post_exprs))
        if having_rex is not None:
            # filter on an extended projection, then trim
            ext = pn.ProjectExec(agg_node, tuple(post_exprs) + (("__having", having_rex),))
            filt = pn.FilterExec(ext, rx.BoundRef(len(post_exprs), "__having",
                                                  dt.BooleanType(), True))
            post = pn.ProjectExec(filt, tuple(
                (n, rx.BoundRef(i, n, rx.rex_type(e), rx.rex_nullable(e)))
                for i, (n, e) in enumerate(post_exprs)))
        fields = [ScopeField(n, (), rx.rex_type(e), rx.rex_nullable(e))
                  for n, e in post_exprs]
        return post, Scope(fields, outer, cscope.ctes)

    def _resolve_grouping_sets(self, plan: sp.Aggregate, scope, outer):
        sets: List[Tuple[ex.Expr, ...]]
        if plan.rollup:
            base = list(plan.group)
            sets = [tuple(base[:i]) for i in range(len(base), -1, -1)]
        elif plan.cube:
            base = list(plan.group)
            sets = []
            for mask in range(1 << len(base), -1, -1):
                if mask == 1 << len(base):
                    continue
                sets.append(tuple(b for i, b in enumerate(base) if mask & (1 << i)))
        else:
            sets = list(plan.grouping_sets)
        branches = []
        if plan.rollup or plan.cube:
            all_group = list(plan.group)
        else:
            # first-appearance order across the sets — grouping_id()'s
            # bit order must be deterministic and leftmost-first
            all_group = []
            for s in sets:
                for g in s:
                    if g not in all_group:
                        all_group.append(g)
        for s in sets:
            # per grouping set: group by present keys; absent keys → NULL.
            # grouping(col) / grouping_id(...) are per-branch CONSTANTS
            # (1 bit per aggregated-away key) substituted before
            # aggregation resolution (Spark: Analyzer ResolveGroupingSets)
            items = []
            for it in plan.aggregate:
                it = self._subst_grouping(it, set(s), all_group)
                items.append(self._null_out_absent(it, set(s), set(all_group)))
            having = plan.having if plan.having is None else \
                self._subst_grouping(plan.having, set(s), all_group)
            branches.append(sp.Aggregate(plan.input, tuple(s), tuple(items),
                                         having))
        union: sp.QueryPlan = branches[0]
        for b in branches[1:]:
            union = sp.SetOperation(union, b, "union", all=True)
        return self.resolve_query(union, scope, outer)

    @staticmethod
    def _map_expr_children(e: ex.Expr, f) -> ex.Expr:
        """Generic one-level rewrite: apply ``f`` to every Expr-typed
        field (including tuples of Exprs and CaseWhen's branch pairs),
        rebuilding the node only when something changed."""
        if not dataclasses.is_dataclass(e):
            return e

        def map_val(v):
            if isinstance(v, ex.Expr):
                return f(v)
            if isinstance(v, tuple):
                if any(isinstance(x, (ex.Expr, tuple)) for x in v):
                    return tuple(map_val(x) for x in v)
            return v

        changes = {}
        for fld in dataclasses.fields(e):
            v = getattr(e, fld.name)
            nv = map_val(v)
            if nv is not v and nv != v:
                changes[fld.name] = nv
        return dataclasses.replace(e, **changes) if changes else e

    def _rewrite_time_window(self, plan: sp.Aggregate) -> sp.Aggregate:
        """GROUP BY window(ts, dur[, slide[, offset]]) or
        session_window(ts, gap) — Spark's time-window grouping. Not
        ported yet: such a plan raises; any other passes unchanged."""
        for g in plan.group:
            gg = _unalias(g)
            if isinstance(gg, ex.Function) and isinstance(gg.name, str):
                nm = gg.name.lower()
                if (nm == "window" and 2 <= len(gg.args) <= 4) or \
                        (nm == "session_window" and len(gg.args) == 2):
                    raise NotImplementedError(
                        "time windows are not ported yet")
        return plan

    def _subst_grouping(self, e: ex.Expr, present: Set[ex.Expr],
                        all_group: List[ex.Expr]) -> ex.Expr:
        """Rewrite grouping()/grouping_id() to the branch's constant:
        grouping(c) → 0/1; grouping_id(cols…) → bitmask, leftmost column
        most significant, defaulting to all group columns."""
        if isinstance(e, ex.Function):
            fname = e.name.lower() if isinstance(e.name, str) else ""
            if fname == "grouping" and len(e.args) == 1:
                bit = 0 if _unalias(e.args[0]) in present else 1
                return ex.Cast(ex.lit(bit), dt.ByteType())
            if fname == "grouping_id":
                cols = [_unalias(a) for a in e.args] or list(all_group)
                gid = 0
                for c in cols:
                    gid = (gid << 1) | (0 if c in present else 1)
                return ex.Cast(ex.lit(gid), dt.LongType())
        return self._map_expr_children(
            e, lambda c: self._subst_grouping(c, present, all_group))

    def _null_absent_expr(self, e: ex.Expr, present: Set[ex.Expr],
                          all_group: Set[ex.Expr]) -> ex.Expr:
        """Deep substitution: references to group columns absent from
        this grouping set become NULL — everywhere in the expression
        EXCEPT inside aggregate arguments (sum(a) in the rollup total
        still aggregates the real values)."""
        if e in all_group and e not in present:
            return ex.Cast(ex.Literal(LV.null()), dt.NullType())
        if isinstance(e, ex.Function) and isinstance(e.name, str) and \
                freg.is_aggregate(e.name.lower()):
            return e
        return self._map_expr_children(
            e, lambda c: self._null_absent_expr(c, present, all_group))

    def _null_out_absent(self, item: ex.Expr, present: Set[ex.Expr],
                         all_group: Set[ex.Expr]) -> ex.Expr:
        name = self._output_name(item)
        base = _unalias(item)
        new = self._null_absent_expr(base, present, all_group)
        if new is base and isinstance(item, ex.Alias):
            return item
        return ex.Alias(new, (name,))

    def _subst_alias(self, e: ex.Expr, items: Sequence[ex.Expr]) -> ex.Expr:
        """Replace references to select-list aliases (HAVING/GROUP BY)."""
        if isinstance(e, ex.Attribute) and len(e.name) == 1:
            for it in items:
                if isinstance(it, ex.Alias) and it.name[-1].lower() == e.name[0].lower():
                    return it.child
        if isinstance(e, ex.Function):
            return dataclasses.replace(
                e, args=tuple(self._subst_alias(a, items) for a in e.args))
        return e

    def _resolve_dedup(self, plan: sp.Deduplicate, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        n = len(child.schema)
        if plan.columns:
            keys = [cscope.find((c,)) for c in plan.columns]
            key_idx = [k for k in keys if k is not None]
        else:
            key_idx = list(range(n))
        aggs = []
        out_names = [child.schema[i].name for i in key_idx]
        for i, f in enumerate(child.schema):
            if i in key_idx:
                continue
            aggs.append(pn.AggSpec("first", i, False, f.dtype))
            out_names.append(f.name)
        node = pn.AggregateExec(child, tuple(key_idx), tuple(aggs), tuple(out_names))
        # restore original column order
        order = []
        for f in child.schema:
            order.append(node.schema[[s.name for s in node.schema].index(f.name)])
        exprs = tuple((f.name, rx.BoundRef([s.name for s in node.schema].index(f.name),
                                           f.name, f.dtype, f.nullable))
                      for f in child.schema)
        proj = pn.ProjectExec(node, exprs)
        fields = [ScopeField(f.name, (), f.dtype, f.nullable) for f in child.schema]
        return proj, Scope(fields, outer, cscope.ctes)

    def _resolve_setop(self, plan: sp.SetOperation, scope, outer):
        left, lscope = self.resolve_query(plan.left, scope, outer)
        right, rscope = self.resolve_query(plan.right, scope, outer)
        if len(left.schema) != len(right.schema):
            raise ResolutionError("set operation inputs have different arity")
        # Widen BOTH inputs to the per-column common type (Spark set-op
        # coercion); the union output schema is then the common schema.
        common = []
        for lf, rf in zip(left.schema, right.schema):
            common.append(pn.Field(lf.name, _setop_common(lf.dtype, rf.dtype),
                                   lf.nullable or rf.nullable))
        right = _coerce_to(right, common)
        left = _coerce_to(left, common)
        if plan.op == "union":
            node: pn.PlanNode = pn.UnionExec((left, right), True)
            out_scope = Scope([ScopeField(f.name, (), f.dtype, True)
                               for f in left.schema], outer, lscope.ctes)
            if not plan.all:
                dedup = sp.Deduplicate(_PreResolved(node, out_scope))
                return self._resolve_dedup_pre(node, out_scope, outer)
            return node, out_scope
        # intersect/except via semi/anti join on all columns
        join_type = "semi" if plan.op == "intersect" else "anti"
        lk = tuple(rx.BoundRef(i, f.name, f.dtype, f.nullable)
                   for i, f in enumerate(left.schema))
        rk = tuple(rx.BoundRef(i, f.name, f.dtype, f.nullable)
                   for i, f in enumerate(right.schema))
        node = pn.JoinExec(left, right, join_type, lk, rk, None)
        out_scope = Scope([ScopeField(f.name, (), f.dtype, f.nullable)
                           for f in left.schema], outer, lscope.ctes)
        if not plan.all:
            return self._resolve_dedup_pre(node, out_scope, outer)
        return node, out_scope

    def _resolve_dedup_pre(self, node: pn.PlanNode, nscope: Scope, outer):
        n = len(node.schema)
        agg = pn.AggregateExec(node, tuple(range(n)), (),
                               tuple(f.name for f in node.schema))
        return agg, nscope

    def _resolve_with_columns(self, plan: sp.WithColumns, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        new_cols = {}
        for a in plan.aliases:
            assert isinstance(a, ex.Alias)
            new_cols[a.name[-1].lower()] = self._resolve_expr(a.child, cscope)
        exprs = []
        fields = []
        seen = set()
        for i, f in enumerate(child.schema):
            key = f.name.lower()
            if key in new_cols:
                r = new_cols.pop(key)
                exprs.append((f.name, r))
                fields.append(ScopeField(f.name, (), rx.rex_type(r), True))
            else:
                exprs.append((f.name, rx.BoundRef(i, f.name, f.dtype, f.nullable)))
                fields.append(cscope.fields[i])
        for name, r in new_cols.items():
            exprs.append((name, r))
            fields.append(ScopeField(name, (), rx.rex_type(r), True))
        return pn.ProjectExec(child, tuple(exprs)), Scope(fields, outer, cscope.ctes)

    def _resolve_sample(self, plan: sp.Sample, scope, outer):
        child, cscope = self.resolve_query(plan.input, scope, outer)
        frac = plan.upper_bound - plan.lower_bound
        cond = rx.RCall("sample_mask", (rx.RLit(LV.float64(frac)),
                                        rx.RLit(LV.int64(plan.seed or 42))),
                        dt.BooleanType(), False)
        return pn.FilterExec(child, cond), cscope

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def _resolve_join(self, plan: sp.Join, scope, outer):
        left, lscope = self.resolve_query(plan.left, scope, outer)
        right, rscope = self.resolve_query(plan.right, scope, outer)
        nleft = len(left.schema)
        combined = Scope(lscope.fields + rscope.fields, outer,
                         {**lscope.ctes, **rscope.ctes})
        jt = plan.join_type
        using = list(plan.using)
        if plan.is_natural:
            lnames = {f.name.lower() for f in left.schema}
            using = [f.name for f in right.schema if f.name.lower() in lnames]
        left_keys: List[rx.Rex] = []
        right_keys: List[rx.Rex] = []
        residual: Optional[rx.Rex] = None
        if using:
            for u in using:
                li = lscope.find((u,))
                ri = rscope.find((u,))
                if li is None or ri is None:
                    raise ResolutionError(f"USING column {u!r} not on both sides")
                lf, rf = left.schema[li], right.schema[ri]
                left_keys.append(rx.BoundRef(li, lf.name, lf.dtype, lf.nullable))
                right_keys.append(rx.BoundRef(ri, rf.name, rf.dtype, rf.nullable))
        elif plan.condition is not None:
            conjuncts = _split_conjuncts(plan.condition)
            residual_parts = []
            for c in conjuncts:
                pair = self._try_equi_pair(c, lscope, rscope)
                if pair is not None:
                    left_keys.append(pair[0])
                    right_keys.append(pair[1])
                else:
                    residual_parts.append(self._resolve_predicate(c, combined))
            if residual_parts:
                residual = _and_rex(residual_parts)
        if jt == "cross" and (left_keys or residual):
            jt = "inner"
        node = pn.JoinExec(left, right, jt, tuple(left_keys), tuple(right_keys),
                           residual)
        if jt in ("semi", "anti"):
            out_fields = list(lscope.fields)
        else:
            out_fields = lscope.fields + rscope.fields
            if using:
                # drop right-side USING columns from the visible scope
                drop = {u.lower() for u in using}
                proj_exprs = []
                new_fields = []
                for i, f in enumerate(node.schema):
                    if i >= nleft and f.name.lower() in drop:
                        continue
                    proj_exprs.append((f.name, rx.BoundRef(i, f.name, f.dtype,
                                                           f.nullable)))
                    new_fields.append(out_fields[i])
                node = pn.ProjectExec(node, tuple(proj_exprs))
                out_fields = new_fields
        return node, Scope(out_fields, outer, {**lscope.ctes, **rscope.ctes})

    def _try_equi_pair(self, c: ex.Expr, lscope: Scope, rscope: Scope):
        if not (isinstance(c, ex.Function) and c.name in ("==", "=") and len(c.args) == 2):
            return None
        a, b = c.args
        for first, second, swap in ((a, b, False), (b, a, True)):
            try:
                lr = self._resolve_expr(first, Scope(lscope.fields, None, {}))
                rr = self._resolve_expr(second, Scope(rscope.fields, None, {}))
                lt, rt2 = rx.rex_type(lr), rx.rex_type(rr)
                if lt != rt2:
                    common = dt.common_type(lt, rt2)
                    if lt != common:
                        lr = rx.RCast(lr, common)
                    if rt2 != common:
                        rr = rx.RCast(rr, common)
                return (lr, rr)
            except ResolutionError:
                continue
        return None

    # ------------------------------------------------------------------
    # expressions
    # ------------------------------------------------------------------
    def _ordinal_or_expr(self, e: ex.Expr, cscope: Scope, child: pn.PlanNode) -> rx.Rex:
        if isinstance(e, ex.Literal) and e.value.data_type.is_integer:
            idx = int(e.value.value) - 1
            if 0 <= idx < len(child.schema):
                f = child.schema[idx]
                return rx.BoundRef(idx, f.name, f.dtype, f.nullable)
        return self._resolve_expr(e, cscope)

    def _resolve_predicate(self, e: ex.Expr, scope: Scope) -> rx.Rex:
        r = self._resolve_expr(e, scope)
        if not isinstance(rx.rex_type(r), dt.BooleanType):
            r = rx.RCast(r, dt.BooleanType())
        return r

    def _resolve_expr(self, e: ex.Expr, scope: Scope) -> rx.Rex:
        if isinstance(e, _PreRex):
            return e.rex
        if isinstance(e, ex.Literal):
            return rx.RLit(e.value)
        if isinstance(e, ex.LambdaVariable):
            for env in reversed(self._lambda_env):
                if e.name in env:
                    return rx.RLambdaVar(e.name, env[e.name], True)
            raise ResolutionError(f"unbound lambda variable {e.name!r}")
        if isinstance(e, ex.Alias):
            return self._resolve_expr(e.child, scope)
        if isinstance(e, ex.Attribute):
            return self._resolve_attribute(e, scope)
        if isinstance(e, ex.Cast):
            child = self._resolve_expr(e.child, scope)
            return rx.RCast(child, e.data_type, e.try_, rx.rex_nullable(child) or e.try_)
        if isinstance(e, ex.Between):
            child = self._resolve_expr(e.child, scope)
            low = self._resolve_expr(e.low, scope)
            high = self._resolve_expr(e.high, scope)
            ge = self._make_call(">=", [child, low])
            le = self._make_call("<=", [child, high])
            r = self._make_call("and", [ge, le])
            return self._make_call("not", [r]) if e.negated else r
        if isinstance(e, ex.InList):
            child = self._resolve_expr(e.child, scope)
            vals = [self._resolve_expr(v, scope) for v in e.values]
            r = rx.RCall("in", tuple([child] + vals), dt.BooleanType(), True)
            return self._make_call("not", [r]) if e.negated else r
        if isinstance(e, ex.Like):
            child = self._resolve_expr(e.child, scope)
            pattern = self._resolve_expr(e.pattern, scope)
            fn = "ilike" if e.case_insensitive else "like"
            opts = (("escape", e.escape),) if e.escape else ()
            r = rx.RCall(fn, (child, pattern), dt.BooleanType(), True, opts)
            return self._make_call("not", [r]) if e.negated else r
        if isinstance(e, ex.CaseWhen):
            branches = []
            vtypes = []
            for c, v in e.branches:
                rc = self._resolve_predicate(c, scope)
                rv = self._resolve_expr(v, scope)
                branches.append((rc, rv))
                vtypes.append(rx.rex_type(rv))
            relse = self._resolve_expr(e.else_value, scope) \
                if e.else_value is not None else None
            if relse is not None:
                vtypes.append(rx.rex_type(relse))
            out_t = vtypes[0]
            for t in vtypes[1:]:
                if not isinstance(t, dt.NullType):
                    out_t = t if isinstance(out_t, dt.NullType) else dt.common_type(out_t, t)
            branches = [(c, self._coerce(v, out_t)) for c, v in branches]
            if relse is not None:
                relse = self._coerce(relse, out_t)
            return rx.RCase(tuple(branches), relse, out_t, True)
        if isinstance(e, ex.Extract):
            child = self._resolve_expr(e.child, scope)
            fname = {"year": "year", "yearofweek": "year", "quarter": "quarter",
                     "month": "month", "day": "day", "dayofmonth": "day",
                     "week": "weekofyear", "dow": "dayofweek", "doy": "dayofyear",
                     "hour": "hour", "minute": "minute",
                     # EXTRACT(SECOND ...) is fractional (decimal), unlike
                     # the second() function
                     "second": "seconds"}.get(e.field_name, e.field_name)
            return self._finish_function(fname, [child])
        if isinstance(e, ex.ScalarSubquery):
            node, _ = self.resolve_query(e.plan, Scope([], None, dict(scope.ctes)),
                                         scope)
            if _plan_has_outer_refs(node):
                raise ResolutionError(
                    "correlated scalar subquery in unsupported position")
            if len(node.schema) != 1:
                raise ResolutionError("scalar subquery must return one column")
            f = node.schema[0]
            return rx.RScalarSubquery(node, f.dtype, True)
        if isinstance(e, ex.Exists) or isinstance(e, ex.InSubquery):
            raise ResolutionError(
                f"{type(e).__name__} is only supported in WHERE/HAVING conjuncts")
        if isinstance(e, ex.Window):
            raise ResolutionError("window expressions are resolved by the "
                                  "window planner (not yet reachable here)")
        if isinstance(e, ex.Function):
            return self._resolve_function(e, scope)
        from ..functions.udf import UdfExpr
        if isinstance(e, UdfExpr):
            args = tuple(self._resolve_expr(a, scope) for a in e.args)
            return rx.RCall("__pyudf", args, e.udf.return_type, True,
                            (("udf", e.udf),))
        raise ResolutionError(f"unsupported expression {type(e).__name__}")

    def _resolve_attribute(self, e: ex.Attribute, scope: Scope) -> rx.Rex:
        if len(e.name) == 1:
            for env in reversed(self._lambda_env):
                if e.name[0] in env:
                    return rx.RLambdaVar(e.name[0], env[e.name[0]], True)
        idx = scope.find(e.name)
        if idx is not None:
            f = scope.fields[idx]
            return rx.BoundRef(idx, f.name, f.dtype, f.nullable)
        # dotted struct access (s.a, t.s.a): resolve the longest column
        # prefix, then descend through the struct with getfield
        for cut in range(len(e.name) - 1, 0, -1):
            pidx = scope.find(e.name[:cut])
            if pidx is None:
                continue
            f = scope.fields[pidx]
            if not isinstance(f.dtype, dt.StructType):
                continue
            r: rx.Rex = rx.BoundRef(pidx, f.name, f.dtype, f.nullable)
            for part in e.name[cut:]:
                r = self._make_call(
                    "getfield", [r, rx.RLit(LV(dt.StringType(), part))])
            return r
        if scope.parent is not None:
            pidx = scope.parent.find(e.name)
            if pidx is not None:
                pf = scope.parent.fields[pidx]
                scope.used_outer = True
                return ROuterRef(pidx, pf.name, pf.dtype, pf.nullable)
        raise ResolutionError(f"column not found: {'.'.join(e.name)}")

    def _coerce(self, r: rx.Rex, target: dt.DataType) -> rx.Rex:
        if rx.rex_type(r) == target or isinstance(target, dt.NullType):
            return r
        if isinstance(r, rx.RLit) and not r.value.is_null and \
                r.value.data_type.is_integer and target.is_integer:
            # constant-fold integer widening so literals stay literals
            # (keeps comparisons scan-prunable)
            return rx.RLit(LV(target, r.value.value))
        return rx.RCast(r, target, False, rx.rex_nullable(r))

    def _make_call(self, name: str, args: List[rx.Rex]) -> rx.Rex:
        name = name.lower()
        if name == "=":
            name = "=="
        arg_types = [rx.rex_type(a) for a in args]
        # complex-type element access: the output type depends on the
        # CONTAINER type (and for structs, the literal field name), which
        # the arity-based registry cannot express
        if name == "getfield" and len(args) == 2 and \
                isinstance(arg_types[0], dt.StructType) and \
                isinstance(args[1], rx.RLit):
            fname = str(args[1].value.value)
            for f in arg_types[0].fields:
                if f.name.lower() == fname.lower():
                    return rx.RCall(
                        "getfield",
                        (args[0], rx.RLit(LV(dt.StringType(), f.name))),
                        f.data_type, True)
            raise ResolutionError(
                f"no field {fname!r} in "
                f"{arg_types[0].simple_string()}")
        if name == "getitem" and len(args) == 2:
            t0 = arg_types[0]
            if isinstance(t0, dt.StructType):
                return self._make_call("getfield", args)
            if isinstance(t0, dt.ArrayType):
                if not arg_types[1].is_integer:
                    raise ResolutionError(
                        f"array index must be integral, got "
                        f"{arg_types[1].simple_string()}")
                return rx.RCall("getitem", tuple(args), t0.element_type,
                                True)
            if isinstance(t0, dt.MapType):
                # maps surface as dicts OR pair-lists at runtime; a
                # distinct name keeps array indexing unambiguous
                return rx.RCall("getitem_map", tuple(args),
                                t0.value_type, True)
        if name in ("getfield", "getitem"):
            # anything the special-cases above did not accept is an
            # analysis error, not a silent NULL (the host registrations
            # are execution impls only)
            raise ResolutionError(
                f"cannot access element of "
                f"{arg_types[0].simple_string()}"
                + ("" if name == "getitem"
                   else " (field names must be literals)"))
        # numeric/comparison coercion
        if name in ("+", "-", "*", "/", "%", "div", "==", "!=", "<", "<=",
                    ">", ">=", "<=>", "pmod") and len(args) == 2:
            a, b = arg_types
            temporal = (dt.DateType, dt.TimestampType)
            interval = (dt.DayTimeIntervalType, dt.YearMonthIntervalType)
            if name in ("+", "-") and (isinstance(a, temporal) or isinstance(b, temporal)):
                if isinstance(a, interval) or isinstance(b, interval):
                    out = a if isinstance(a, temporal) else b
                    return rx.RCall(f"date{name}interval", tuple(args), out,
                                    any(rx.rex_nullable(x) for x in args))
                if name == "-" and isinstance(a, dt.DateType) and isinstance(b, dt.DateType):
                    return rx.RCall("datediff", tuple(args), dt.IntegerType(),
                                    any(rx.rex_nullable(x) for x in args))
                if isinstance(a, dt.DateType) and b.is_integer:
                    return rx.RCall("date_add" if name == "+" else "date_sub",
                                    tuple(args), dt.DateType(),
                                    any(rx.rex_nullable(x) for x in args))
            if not (isinstance(a, (dt.StringType, dt.BinaryType))
                    or isinstance(b, (dt.StringType, dt.BinaryType))):
                try:
                    common = dt.common_type(a, b)
                except TypeError:
                    common = None
                if common is not None and name not in ("/",):
                    args = [self._coerce(args[0], common), self._coerce(args[1], common)]
                    arg_types = [common, common]
        out_t = freg.infer_function_type(name, arg_types)
        # variadic/choice functions: coerce every argument to the result type
        if name in ("coalesce", "greatest", "least", "nvl2", "nanvl") or \
                (name == "if" and len(args) == 3):
            # 'if' and 'nvl2' test their first argument — never cast it
            skip = 1 if name in ("if", "nvl2") else 0
            args = args[:skip] + [self._coerce(a, out_t) for a in args[skip:]]
        nullable = any(rx.rex_nullable(a) for a in args) or \
            name in ("/", "div", "%", "nullif")
        return rx.RCall(name, tuple(args), out_t, nullable)

    def _resolve_function(self, e: ex.Function, scope: Scope) -> rx.Rex:
        name = e.name.lower()
        if freg.is_aggregate(name):
            raise ResolutionError(
                f"aggregate function {name}() used outside aggregation context")
        if any(isinstance(a, ex.LambdaFunction) for a in e.args):
            return self._resolve_higher_order(name, list(e.args), scope)
        args = [self._resolve_expr(a, scope) for a in e.args]
        return self._finish_function(name, args)

    # -- higher-order functions (lambdas) --------------------------------
    def _resolve_lambda(self, lam: ex.LambdaFunction, param_types,
                        scope: Scope) -> rx.RLambda:
        env = dict(zip(lam.arguments, param_types))
        self._lambda_env.append(env)
        try:
            body = self._resolve_expr(lam.body, scope)
        finally:
            self._lambda_env.pop()
        return rx.RLambda(body, tuple(lam.arguments), rx.rex_type(body),
                          rx.rex_nullable(body))

    def _resolve_higher_order(self, name: str, args, scope: Scope) -> rx.Rex:
        """Typed resolution of transform/filter/aggregate/zip_with/… —
        lambda parameters take the collection's element types."""
        def elem(t):
            return t.element_type if isinstance(t, dt.ArrayType) \
                else dt.NullType()

        first = self._resolve_expr(args[0], scope) \
            if not isinstance(args[0], ex.LambdaFunction) else None
        t0 = rx.rex_type(first) if first is not None else dt.NullType()
        idx_t = dt.IntegerType()
        if name in ("transform", "filter", "exists", "forall",
                    "any_match", "all_match"):
            lam0 = args[1]
            nparams = len(lam0.arguments)
            ptypes = [elem(t0)] + ([idx_t] if nparams == 2 else [])
            lam = self._resolve_lambda(lam0, ptypes, scope)
            if name == "transform":
                out: dt.DataType = dt.ArrayType(lam.dtype, True)
            elif name == "filter":
                out = t0
            else:
                out = dt.BooleanType()
            return rx.RCall(name, (first, lam), out, True)
        if name in ("aggregate", "reduce"):
            zero = self._resolve_expr(args[1], scope)
            acc_t = rx.rex_type(zero)
            merge = self._resolve_lambda(args[2], [acc_t, elem(t0)], scope)
            if len(args) > 3:
                finish = self._resolve_lambda(args[3], [acc_t], scope)
                return rx.RCall("aggregate", (first, zero, merge, finish),
                                finish.dtype, True)
            return rx.RCall("aggregate", (first, zero, merge), acc_t, True)
        if name == "array_sort":
            lam = self._resolve_lambda(args[1], [elem(t0), elem(t0)], scope)
            return rx.RCall("array_sort_cmp", (first, lam), t0, True)
        if name == "zip_with":
            second = self._resolve_expr(args[1], scope)
            t1 = rx.rex_type(second)
            lam = self._resolve_lambda(args[2], [elem(t0), elem(t1)], scope)
            return rx.RCall("zip_with", (first, second, lam),
                            dt.ArrayType(lam.dtype, True), True)
        if name in ("map_filter", "transform_keys", "transform_values"):
            mt = t0 if isinstance(t0, dt.MapType) else dt.MapType()
            lam = self._resolve_lambda(args[1], [mt.key_type, mt.value_type],
                                       scope)
            if name == "map_filter":
                out = mt
            elif name == "transform_keys":
                out = dt.MapType(lam.dtype, mt.value_type,
                                 mt.value_contains_null)
            else:
                out = dt.MapType(mt.key_type, lam.dtype, True)
            return rx.RCall(name, (first, lam), out, True)
        if name == "map_zip_with":
            second = self._resolve_expr(args[1], scope)
            m0 = t0 if isinstance(t0, dt.MapType) else dt.MapType()
            m1 = rx.rex_type(second)
            v1 = m1.value_type if isinstance(m1, dt.MapType) else dt.NullType()
            lam = self._resolve_lambda(
                args[2], [m0.key_type, m0.value_type, v1], scope)
            return rx.RCall(name, (first, second, lam),
                            dt.MapType(m0.key_type, lam.dtype, True), True)
        raise ResolutionError(
            f"function {name!r} does not take a lambda argument")

    def _finish_function(self, name: str, args: List[rx.Rex]) -> rx.Rex:
        """Name rewrites + UDF lookup + typed call construction (shared by
        the plain and window-aware expression resolvers)."""
        name = name.lower()
        if name == "named_struct":
            fields = []
            for k, v in zip(args[0::2], args[1::2]):
                key = k.value.value if isinstance(k, rx.RLit) else "col"
                fields.append(dt.StructField(str(key), rx.rex_type(v),
                                             rx.rex_nullable(v)))
            return rx.RCall("named_struct", tuple(args),
                            dt.StructType(tuple(fields)), False)
        if name == "struct":
            fields = tuple(
                dt.StructField(a.name if isinstance(
                    a, (rx.BoundRef, rx.RLambdaVar))
                    else f"col{i+1}", rx.rex_type(a),
                    rx.rex_nullable(a))
                for i, a in enumerate(args))
            return rx.RCall("struct", tuple(args), dt.StructType(fields),
                            False)
        if name in ("nvl", "ifnull"):
            name = "coalesce"
        if name == "substr":
            name = "substring"
        if name == "pow":
            name = "power"
        if name == "mod" and len(args) == 2:
            name = "%"
        if name == "sha":
            name = "sha1"
        if name == "dateadd":
            name = "date_add"
        if name == "date_diff":
            name = "datediff"
        # schema-carrying parsers (host-evaluated)
        if name in ("from_json", "from_csv", "from_xml"):
            raise NotImplementedError(f"{name} is not ported yet")
        # to_number: precision/scale come from the literal format
        if name in ("to_number", "try_to_number") and len(args) == 2 and \
                isinstance(args[1], rx.RLit):
            fmt = str(args[1].value.value).upper()
            digits = sum(1 for c in fmt if c in "09")
            sep = "D" if "D" in fmt else "."
            scale = sum(1 for c in fmt.split(sep, 1)[1] if c in "09") \
                if sep in fmt else 0
            return rx.RCall(name, tuple(args),
                            dt.DecimalType(max(digits, 1), scale), True)
        # ceil/floor with a target scale return decimals
        if name in ("ceil", "ceiling", "floor") and len(args) == 2 and \
                isinstance(args[1], rx.RLit):
            scale = int(args[1].value.value)
            base = "ceil" if name != "floor" else "floor"
            out = dt.DecimalType(38, max(scale, 0))
            return rx.RCall(f"__{base}_scaled", tuple(args), out, True)
        # round/bround on decimals shrink the scale to the literal digits
        if name in ("round", "bround") and len(args) >= 1 and \
                isinstance(rx.rex_type(args[0]), dt.DecimalType):
            d0 = rx.rex_type(args[0])
            digits = 0
            if len(args) > 1 and isinstance(args[1], rx.RLit):
                digits = int(args[1].value.value)
            ns = min(d0.scale, max(digits, 0))
            out = dt.DecimalType(max(d0.precision - d0.scale + ns, 1), ns)
            return rx.RCall(name, tuple(args), out,
                            any(rx.rex_nullable(a) for a in args))
        # try_* arithmetic: NULL on overflow / type mismatch (host, exact)
        if name in ("try_add", "try_subtract", "try_multiply",
                    "try_divide") and len(args) == 2:
            ats = [rx.rex_type(a) for a in args]
            out = _try_arith_type(name, ats)
            if out is not None:
                opname = name[4:]
                if any(isinstance(t, dt.YearMonthIntervalType)
                       for t in ats):
                    opname += "_ym"
                op = rx.RLit(LV.string(opname))
                tag = rx.RLit(LV.string(out.simple_string()))
                return rx.RCall("__try_arith", (op, tag) + tuple(args),
                                out, True)
        # constant-fold power so literal cases are exact (device pow is
        # exp·log-based)
        if name in ("power", "pow") and len(args) == 2 and \
                all(isinstance(a, rx.RLit) and a.value.value is not None
                    for a in args):
            try:
                return rx.RLit(LV.float64(
                    float(args[0].value.value) ** float(args[1].value.value)))
            except (OverflowError, ValueError, TypeError):
                pass
        # constant-fold cbrt: XLA's compile-time folder computes it
        # exp·log-based (cbrt(27) → 3.0000000000000004) while Java
        # Math.cbrt — and XLA's own runtime kernel — are exact
        if name == "cbrt" and len(args) == 1 and \
                isinstance(args[0], rx.RLit) and \
                args[0].value.value is not None:
            try:
                import math
                x = float(args[0].value.value)
                v = math.cbrt(x)
                r = round(v)
                if float(r) ** 3 == x:  # exact cube: Java Math.cbrt
                    v = float(r)
                return rx.RLit(LV.float64(v))
            except (OverflowError, ValueError, TypeError):
                pass
        # date_part/datepart with a literal part → the specific field fn
        if name in ("date_part", "datepart") and len(args) == 2 and \
                isinstance(args[0], rx.RLit) and \
                isinstance(args[0].value.value, str):
            part = args[0].value.value.strip().lower()
            canon = {
                "yr": "years", "yrs": "years", "year": "years",
                "years": "years", "mon": "months", "mons": "months",
                "month": "months", "months": "months", "day": "days",
                "days": "days", "d": "days", "hour": "hours",
                "hours": "hours", "hr": "hours", "hrs": "hours",
                "h": "hours", "minute": "minutes", "minutes": "minutes",
                "min": "minutes", "mins": "minutes", "m": "minutes",
                "second": "seconds", "seconds": "seconds",
                "sec": "seconds", "secs": "seconds", "s": "seconds",
                "quarter": "quarter", "qtr": "quarter",
                "week": "weekofyear", "w": "weekofyear",
                "dow": "dayofweek", "doy": "dayofyear",
            }
            if part in canon:
                return self._finish_function(canon[part], [args[1]])
        # EXTRACT field-name forms (plural parts, interval components)
        if args and name in ("seconds", "second", "days", "hours",
                             "minutes", "years", "months", "year", "month",
                             "day", "hour", "minute"):
            at0 = rx.rex_type(args[0])
            base = name.rstrip("s")
            if isinstance(at0, (dt.DayTimeIntervalType,
                                dt.YearMonthIntervalType)):
                name = "extract_" + base + "s"
            elif name in ("seconds",):
                name = "extract_seconds"
            elif name in ("days", "hours", "minutes", "years", "months"):
                name = base
        # temporal functions accept string datetime forms: cast up front so
        # device kernels never see dictionary codes as epoch values
        _DATE_ARG = {"day", "dayofmonth", "month", "year", "quarter",
                     "dayofweek", "weekday", "dayofyear", "weekofyear",
                     "week", "last_day", "next_day", "add_months",
                     "date_add", "date_sub", "datediff", "date_diff",
                     "dayname", "monthname", "unix_date"}
        _TS_ARG = {"hour", "minute", "second", "date_format",
                   "from_utc_timestamp", "to_utc_timestamp", "unix_seconds",
                   "unix_millis", "unix_micros"}
        if name in _DATE_ARG and args and \
                isinstance(rx.rex_type(args[0]), dt.StringType):
            args = [rx.RCast(args[0], dt.DateType(), False, True)] + args[1:]
        elif name in _TS_ARG and args and \
                isinstance(rx.rex_type(args[0]), dt.StringType):
            args = [rx.RCast(args[0], dt.TimestampType("UTC"), False,
                             True)] + args[1:]
        elif name in ("months_between",):
            args = [rx.RCast(a, dt.TimestampType("UTC"), False, True)
                    if isinstance(rx.rex_type(a), dt.StringType) else a
                    for a in args]
        if name == "datediff" or name == "date_diff":
            args = [rx.RCast(a, dt.DateType(), False, True)
                    if isinstance(rx.rex_type(a), dt.StringType) else a
                    for a in args]
        if name == "date_trunc" and len(args) == 2 and \
                isinstance(rx.rex_type(args[1]), dt.StringType):
            args = [args[0], rx.RCast(args[1], dt.TimestampType("UTC"),
                                      False, True)]
        if name in ("position", "locate") and len(args) == 2:
            # position(sub, str) → instr(str, sub)
            args = [args[1], args[0]]
            name = "instr"
        # named SQL UDFs
        u = getattr(self.catalog, "udfs", None)
        if u is not None:
            found = u.get(name)
            if found is not None:
                return rx.RCall("__pyudf", tuple(args), found.return_type, True,
                                (("udf", found),))
        return self._make_call(name, args)


class _PreRex(ex.Expr):
    """An already-resolved rex smuggled through the spec-expression layer
    (lateral column alias substitution)."""

    def __init__(self, rex):
        self.rex = rex


def _subst_alias(e, env):
    """Replace single-part Attributes found in ``env`` with their resolved
    rex (lateral column aliases)."""
    if isinstance(e, ex.Attribute) and len(e.name) == 1 and e.name[0] in env:
        return _PreRex(env[e.name[0]])
    if dataclasses.is_dataclass(e) and isinstance(e, ex.Expr):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, ex.Expr):
                nv = _subst_alias(v, env)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple) and any(
                    isinstance(x, ex.Expr) for x in v):
                nv = tuple(_subst_alias(x, env) if isinstance(x, ex.Expr)
                           else x for x in v)
                if nv != v:
                    changes[f.name] = nv
        if changes:
            return dataclasses.replace(e, **changes)
    return e


def _try_arith_type(name, ts):
    """Result type of try_add/subtract/multiply/divide, or None to fall
    back to the generic path."""
    a, b = ts
    op = name[4:]
    temporal = (dt.DateType, dt.TimestampType)
    interval = (dt.DayTimeIntervalType, dt.YearMonthIntervalType)
    if op == "add" and isinstance(b, temporal):
        a, b = b, a
    if isinstance(a, temporal):
        if isinstance(b, dt.YearMonthIntervalType) or (
                b.is_integer and isinstance(a, dt.DateType)):
            return a
        if isinstance(b, dt.DayTimeIntervalType):
            return a if isinstance(a, dt.TimestampType) else None
    if isinstance(a, interval) and type(a) == type(b) and \
            op in ("add", "subtract"):
        return a
    if op == "multiply":
        if isinstance(a, interval) and b.is_numeric:
            return a
        if isinstance(b, interval) and a.is_numeric:
            return b
    if op == "divide":
        if isinstance(a, interval) and b.is_numeric:
            return a
        if a.is_numeric and b.is_numeric:
            return dt.DoubleType()
        return None
    if a.is_numeric and b.is_numeric:
        try:
            return dt.common_type(a, b)
        except TypeError:
            return None
    return None


def sql_parse_data_type(text):
    from ..sql.parser import parse_data_type as _p
    return _p(text)


@dataclasses.dataclass
class _InlinedCte:
    plan: sp.QueryPlan
    ctes: Dict[str, "_InlinedCte"]


class _PreResolved(sp.QueryPlan):
    def __init__(self, node, scope):
        self.node = node
        self.scope = scope


@dataclasses.dataclass
class _CollectedAgg:
    spec: pn.AggSpec
    arg: Optional[int]          # index into collector.arg_rex


class _AggCollector:
    """Walks select/having expressions, extracting aggregate calls and
    group-key matches, producing post-aggregation expressions."""

    def __init__(self, resolver: Resolver, scope: Scope,
                 group_exprs: Sequence[ex.Expr], group_rex: Sequence[rx.Rex]):
        self.resolver = resolver
        self.scope = scope
        self.group_exprs = list(group_exprs)
        self.group_rex = list(group_rex)
        self.aggs: List[_CollectedAgg] = []
        self.arg_rex: List[rx.Rex] = []
        self.has_distinct = False

    def _arg_index(self, r: rx.Rex) -> int:
        for i, existing in enumerate(self.arg_rex):
            if existing == r:
                return i
        self.arg_rex.append(r)
        return len(self.arg_rex) - 1

    def _add_agg(self, fn: str, arg: Optional[rx.Rex], distinct: bool,
                 out_dtype: dt.DataType, ignore_nulls: bool = True) -> rx.Rex:
        ai = None if arg is None else self._arg_index(arg)
        spec = pn.AggSpec(fn, ai, distinct, out_dtype, None, ignore_nulls)
        for j, existing in enumerate(self.aggs):
            if existing.spec == spec:
                return self._post_ref(j)
        self.aggs.append(_CollectedAgg(spec, ai))
        return self._post_ref(len(self.aggs) - 1)

    def _post_ref(self, agg_index: int) -> rx.Rex:
        idx = len(self.group_rex) + agg_index
        spec = self.aggs[agg_index].spec
        return rx.BoundRef(idx, f"__agg{agg_index}", spec.out_dtype,
                           spec.fn != "count")

    def _group_ref(self, i: int) -> rx.Rex:
        g = self.group_rex[i]
        return rx.BoundRef(i, f"__g{i}", rx.rex_type(g), rx.rex_nullable(g))

    def rewrite(self, e: ex.Expr) -> rx.Rex:
        # group-key syntactic match first
        for i, g in enumerate(self.group_exprs):
            if _unalias(e) == g:
                return self._group_ref(i)
        if isinstance(e, ex.Function) and freg.is_aggregate(e.name):
            return self._rewrite_agg(e)
        from ..functions.udf import UdfExpr
        if isinstance(e, UdfExpr):
            if e.udf.eval_type == "grouped_agg":
                return self._rewrite_udaf(e)
            args = tuple(self.rewrite(a) for a in e.args)
            return rx.RCall("__pyudf", args, e.udf.return_type, True,
                            (("udf", e.udf),))
        if isinstance(e, ex.Alias):
            return self.rewrite(e.child)
        if isinstance(e, ex.Literal):
            return rx.RLit(e.value)
        if isinstance(e, ex.Cast):
            child = self.rewrite(e.child)
            return rx.RCast(child, e.data_type, e.try_)
        if isinstance(e, ex.CaseWhen):
            branches = tuple((self.rewrite(c), self.rewrite(v))
                             for c, v in e.branches)
            relse = self.rewrite(e.else_value) if e.else_value is not None else None
            vt = [rx.rex_type(v) for _, v in branches]
            if relse is not None:
                vt.append(rx.rex_type(relse))
            out_t = vt[0]
            for t in vt[1:]:
                if not isinstance(t, dt.NullType):
                    out_t = t if isinstance(out_t, dt.NullType) else dt.common_type(out_t, t)
            return rx.RCase(branches, relse, out_t, True)
        if isinstance(e, ex.Function):
            # a registered wire UDAF invoked by name in SQL
            reg = getattr(self.resolver.catalog, "udfs", None)
            named = reg.get(e.name) if reg is not None else None
            if named is not None and named.eval_type == "grouped_agg":
                from ..functions.udf import UdfExpr
                return self._rewrite_udaf(UdfExpr(named, tuple(e.args)))
            args = [self.rewrite(a) for a in e.args]
            # _finish_function (not _make_call): name rewrites and
            # literal-dependent typing (named_struct field names,
            # from_json schemas) apply inside aggregates too
            return self.resolver._finish_function(e.name, args)
        if isinstance(e, ex.Between):
            child = self.rewrite(e.child)
            low = self.rewrite(e.low)
            high = self.rewrite(e.high)
            r = self.resolver._make_call(
                "and", [self.resolver._make_call(">=", [child, low]),
                        self.resolver._make_call("<=", [child, high])])
            return self.resolver._make_call("not", [r]) if e.negated else r
        if isinstance(e, ex.ScalarSubquery):
            return self.resolver._resolve_expr(e, self.scope)
        if isinstance(e, ex.Attribute):
            # must be a group key (or alias of one)
            raise ResolutionError(
                f"column {'.'.join(e.name)!r} must appear in GROUP BY or inside "
                f"an aggregate function")
        raise ResolutionError(f"unsupported expression in aggregation: "
                              f"{type(e).__name__}")

    def _rewrite_udaf(self, e) -> rx.Rex:
        """Wire UDAF (pandas grouped-agg UDF): a host aggregate, not
        ported yet."""
        raise NotImplementedError("wire UDAFs are not ported yet")

    def _rewrite_agg(self, e: ex.Function) -> rx.Rex:
        fn = e.name.lower()
        distinct = e.is_distinct
        if distinct:
            self.has_distinct = True
        if fn in ("mean",):
            fn = "avg"
        if fn in ("first_value",):
            fn = "first"
        if fn in ("last_value",):
            fn = "last"
        if fn == "count" and (not e.args or isinstance(e.args[0], ex.Star)):
            return self._add_agg("count", None, distinct, dt.LongType())
        if fn == "count_if":
            arg = self.resolver._resolve_expr(e.args[0], self.scope)
            arg = rx.RCall("if", (arg, rx.RLit(LV.int32(1)),
                                  rx.RLit(LV(dt.IntegerType(), None))),
                           dt.IntegerType(), True)
            return self._add_agg("count", arg, False, dt.LongType())
        args = [self.resolver._resolve_expr(a, self.scope) for a in e.args]
        if not args:
            raise ResolutionError(f"{fn}() requires an argument")
        arg = args[0]
        at = rx.rex_type(arg)
        if fn == "sum":
            return self._add_agg("sum", arg, distinct, freg.sum_result_type(at))
        if fn == "try_sum":
            # exact host sum with NULL-on-overflow (device sum wraps)
            return self._add_agg("__host__try_sum", arg, distinct,
                                 freg.sum_result_type(at))
        if fn == "try_avg":
            if isinstance(at, dt.YearMonthIntervalType):
                return self._add_agg("__host__try_avg_ym", arg, distinct, at)
            out_ta = at if isinstance(at, dt.DayTimeIntervalType) \
                else dt.DoubleType()
            return self._add_agg("__host__try_avg", arg, distinct, out_ta)
        if fn == "count":
            return self._add_agg("count", arg, distinct, dt.LongType())
        if fn == "avg":
            s = self._add_agg("sum", arg, distinct, freg.sum_result_type(at))
            c = self._add_agg("count", arg, distinct, dt.LongType())
            return self.resolver._make_call("/", [s, c])
        if fn in ("min", "max", "first", "last", "any_value"):
            k = {"any_value": "first"}.get(fn, fn)
            # Spark default: first/last/any_value RESPECT nulls
            default = True if fn in ("min", "max") else False
            ignore = e.ignore_nulls if e.ignore_nulls is not None else default
            if fn in ("first", "last", "any_value") and len(e.args) > 1 \
                    and isinstance(e.args[1], ex.Literal) \
                    and e.ignore_nulls is None:
                ignore = bool(e.args[1].value.value)
            return self._add_agg(k, arg, False, at, ignore)
        if fn in ("bool_and", "every"):
            return self._add_agg("bool_and", arg, False, dt.BooleanType())
        if fn in ("bool_or", "any", "some"):
            return self._add_agg("bool_or", arg, False, dt.BooleanType())
        if fn in ("stddev", "stddev_samp", "stddev_pop", "variance",
                  "var_samp", "var_pop"):
            xf = arg if isinstance(at, dt.DoubleType) else rx.RCast(arg, dt.DoubleType())
            s1 = self._add_agg("sum", xf, False, dt.DoubleType())
            x2 = self.resolver._make_call("*", [xf, xf])
            s2 = self._add_agg("sum", x2, False, dt.DoubleType())
            c = self._add_agg("count", xf, False, dt.LongType())
            mk = self.resolver._make_call
            mean = mk("/", [s1, c])
            num = mk("-", [s2, mk("*", [mk("*", [mean, mean]),
                                        rx.RCast(c, dt.DoubleType())])])
            denom_c = c if fn.endswith("_pop") else mk("-", [c, rx.RLit(LV.int64(1))])
            var = mk("/", [num, denom_c])
            if fn.startswith("var"):
                return var
            return mk("sqrt", [var])
        if fn == "approx_count_distinct":
            return self._add_agg("count", arg, True, dt.LongType())
        from ..functions.host_aggregates import HOST_AGGS
        if fn in HOST_AGGS:
            spec = HOST_AGGS[fn]
            types = [rx.rex_type(a) for a in args]
            out_t = spec.type_fn(types)
            if len(args) > 1:
                st = dt.StructType(tuple(
                    dt.StructField(f"_{i}", t, True)
                    for i, t in enumerate(types)))
                arg = rx.RCall("struct", tuple(args), st, False)
            return self._add_agg("__host__" + fn, arg, distinct, out_t)
        # the sketch aggregates and wire UDAFs are not ported yet
        raise ResolutionError(f"aggregate {fn!r} not supported yet")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_GENERATORS = {"explode", "explode_outer", "posexplode",
               "posexplode_outer", "inline", "inline_outer", "stack",
               "json_tuple"}


def _is_generator(e: ex.Expr) -> bool:
    return isinstance(e, ex.Function) and e.name.lower() in _GENERATORS


def _unalias(e: ex.Expr) -> ex.Expr:
    while isinstance(e, ex.Alias):
        e = e.child
    return e


def _split_conjuncts(e: ex.Expr) -> List[ex.Expr]:
    if isinstance(e, ex.Function) and e.name == "and":
        return _split_conjuncts(e.args[0]) + _split_conjuncts(e.args[1])
    return [e]


def _and_all(parts: List[ex.Expr]) -> ex.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = ex.Function("and", (out, p))
    return out


def _and_rex(parts: List[rx.Rex]) -> rx.Rex:
    out = parts[0]
    for p in parts[1:]:
        out = rx.RCall("and", (out, p), dt.BooleanType(), True)
    return out


def _expr_children(e: ex.Expr):
    """Immediate sub-expressions of a spec expression (for generic walks)."""
    if isinstance(e, (ex.Alias, ex.Cast)):
        return (e.child,)
    if isinstance(e, ex.Function):
        return e.args
    if isinstance(e, ex.CaseWhen):
        out = [x for pair in e.branches for x in pair]
        if e.else_value is not None:
            out.append(e.else_value)
        return tuple(out)
    if isinstance(e, ex.Between):
        return (e.child, e.low, e.high)
    if isinstance(e, ex.InList):
        return (e.child,) + tuple(e.values)
    if isinstance(e, ex.Like):
        return (e.child, e.pattern)
    if isinstance(e, ex.Extract):
        return (e.child,)
    if isinstance(e, ex.SortOrder):
        return (e.child,)
    return ()


def _has_window(e: ex.Expr) -> bool:
    if isinstance(e, ex.Window):
        return True
    return any(_has_window(c) for c in _expr_children(e))


def _has_aggregate(e: ex.Expr) -> bool:
    from ..functions.udf import UdfExpr
    if isinstance(e, UdfExpr):
        if e.udf.eval_type == "grouped_agg":
            return True
        return any(_has_aggregate(a) for a in e.args)
    if isinstance(e, ex.Function):
        if freg.is_aggregate(e.name):
            return True
        return any(_has_aggregate(a) for a in e.args)
    if isinstance(e, ex.Alias):
        return _has_aggregate(e.child)
    if isinstance(e, ex.Cast):
        return _has_aggregate(e.child)
    if isinstance(e, ex.CaseWhen):
        return any(_has_aggregate(c) or _has_aggregate(v) for c, v in e.branches) \
            or (e.else_value is not None and _has_aggregate(e.else_value))
    if isinstance(e, ex.Between):
        return _has_aggregate(e.child) or _has_aggregate(e.low) or _has_aggregate(e.high)
    return False


def _rex_has_outer(r: rx.Rex) -> bool:
    if isinstance(r, ROuterRef):
        return True
    if isinstance(r, rx.RCall):
        return any(_rex_has_outer(a) for a in r.args)
    if isinstance(r, rx.RCast):
        return _rex_has_outer(r.child)
    if isinstance(r, rx.RCase):
        return any(_rex_has_outer(c) or _rex_has_outer(v) for c, v in r.branches) \
            or (r.else_value is not None and _rex_has_outer(r.else_value))
    return False


def _plan_has_outer_refs(node: pn.PlanNode) -> bool:
    for p in pn.walk_plan(node):
        for r in _node_rex(p):
            if _rex_has_outer(r):
                return True
    return False


def _node_rex(p: pn.PlanNode):
    if isinstance(p, pn.FilterExec):
        yield p.condition
    elif isinstance(p, pn.ProjectExec):
        for _, e in p.exprs:
            yield e
    elif isinstance(p, pn.JoinExec):
        yield from p.left_keys
        yield from p.right_keys
        if p.residual is not None:
            yield p.residual
    elif isinstance(p, pn.SortExec):
        for k in p.keys:
            yield k.expr


def _strip_correlated_filters(node: pn.PlanNode):
    """Strip correlated conjuncts from the FilterExec chain at the top of
    ``node`` (the aggregate source of a correlated scalar subquery).
    Returns (new_node, left_keys(outer), right_keys(bound to node schema),
    residuals)."""
    left_keys: List[rx.Rex] = []
    right_keys: List[rx.Rex] = []
    residuals: List[rx.Rex] = []
    while isinstance(node, pn.FilterExec):
        keep = []
        for c in _split_rex_conjuncts(node.condition):
            if not _rex_has_outer(c):
                keep.append(c)
                continue
            pair = _outer_eq_pair(c)
            if pair is None:
                residuals.append(c)
                continue
            outer_r, inner_r = pair
            left_keys.append(outer_r)
            right_keys.append(inner_r)
        child = node.input
        if keep:
            node = pn.FilterExec(child, _and_rex(keep))
            break
        node = child
    return node, left_keys, right_keys, residuals


def _decorrelate(node: pn.PlanNode):
    """Strip outer-ref conjuncts from FilterExec nodes inside ``node``.

    Returns (new_node, left_keys, right_keys, residuals). left_keys are Rex
    bound to the OUTER schema; right_keys to ``node``'s output schema.
    Correlated predicates are supported in filters whose columns pass through
    to the subquery output (v0: filters directly under the root, or under the
    root project whose exprs are simple column refs).
    """
    left_keys: List[rx.Rex] = []
    right_keys: List[rx.Rex] = []
    residuals: List[rx.Rex] = []

    def extract(p: pn.PlanNode, col_map) -> pn.PlanNode:
        """col_map: maps a BoundRef index at this level → output index of
        the subquery root (or None if not exposed)."""
        if isinstance(p, pn.FilterExec):
            conjuncts = _split_rex_conjuncts(p.condition)
            keep = []
            for c in conjuncts:
                if not _rex_has_outer(c):
                    keep.append(c)
                    continue
                pair = _outer_eq_pair(c)
                if pair is not None:
                    outer_r, inner_r = pair
                    mapped = _map_rex(inner_r, col_map)
                    if mapped is not None:
                        left_keys.append(outer_r)
                        right_keys.append(mapped)
                        continue
                mapped_res = _map_outer_residual(c, col_map)
                if mapped_res is None:
                    raise ResolutionError(
                        "unsupported correlated predicate (column not exposed "
                        "by subquery output)")
                residuals.append(mapped_res)
            child = extract(p.input, col_map)
            if not keep:
                return child
            return pn.FilterExec(child, _and_rex(keep))
        if isinstance(p, pn.ProjectExec):
            # build child col_map: child index → root output index
            child_map = {}
            for out_i, (_, e) in enumerate(p.exprs):
                if isinstance(e, rx.BoundRef) and col_map.get(out_i) is not None:
                    child_map[e.index] = col_map[out_i]
            new_child = extract(p.input, child_map)
            return dataclasses.replace(p, input=new_child)
        if isinstance(p, pn.JoinExec):
            return p  # do not descend into joins in v0
        if isinstance(p, (pn.ScanExec, pn.OneRowExec, pn.ValuesExec, pn.RangeExec)):
            return p
        if isinstance(p, pn.LimitExec) or isinstance(p, pn.SortExec):
            new_child = extract(p.input, col_map)
            return dataclasses.replace(p, input=new_child)
        return p

    root_map = {i: i for i in range(len(node.schema))}
    # For a root Filter (select * shape), every input column is exposed 1:1.
    new_node = extract(node, root_map)
    return new_node, left_keys, right_keys, residuals


def _split_rex_conjuncts(r: rx.Rex) -> List[rx.Rex]:
    if isinstance(r, rx.RCall) and r.fn == "and":
        return _split_rex_conjuncts(r.args[0]) + _split_rex_conjuncts(r.args[1])
    return [r]


def _outer_eq_pair(r: rx.Rex):
    if isinstance(r, rx.RCall) and r.fn == "==" and len(r.args) == 2:
        a, b = r.args
        a_outer, b_outer = _rex_has_outer(a), _rex_has_outer(b)
        if a_outer and not b_outer:
            return _outer_to_bound(a), b
        if b_outer and not a_outer:
            return _outer_to_bound(b), a
    return None


def _outer_to_bound(r: rx.Rex) -> rx.Rex:
    if isinstance(r, ROuterRef):
        return rx.BoundRef(r.index, r.name, r.dtype, r.nullable)
    if isinstance(r, rx.RCall):
        return dataclasses.replace(r, args=tuple(_outer_to_bound(a) for a in r.args))
    if isinstance(r, rx.RCast):
        return dataclasses.replace(r, child=_outer_to_bound(r.child))
    return r


def _map_rex(r: rx.Rex, col_map) -> Optional[rx.Rex]:
    """Rebind a Rex from a nested level to the subquery's output columns."""
    if isinstance(r, rx.BoundRef):
        m = col_map.get(r.index)
        if m is None:
            return None
        return dataclasses.replace(r, index=m)
    if isinstance(r, rx.RCall):
        new_args = []
        for a in r.args:
            m = _map_rex(a, col_map)
            if m is None:
                return None
            new_args.append(m)
        return dataclasses.replace(r, args=tuple(new_args))
    if isinstance(r, rx.RCast):
        m = _map_rex(r.child, col_map)
        return None if m is None else dataclasses.replace(r, child=m)
    if isinstance(r, rx.RLit):
        return r
    return None


def _map_outer_residual(r: rx.Rex, col_map) -> Optional[rx.Rex]:
    """Map a mixed outer/inner predicate to the combined join schema.

    Outer refs stay as ROuterRef markers; the join planner rebases them: the
    executor evaluates residuals over (probe ++ build) columns, with outer
    refs → probe side, inner refs → build side offset by len(left schema).
    We keep inner BoundRefs unmapped here and mark them via options at the
    JoinExec level; v0 encodes: ROuterRef(i) → probe col i, BoundRef(j) →
    build output col (must be exposed via col_map).
    """
    if isinstance(r, ROuterRef):
        return r
    if isinstance(r, rx.BoundRef):
        m = col_map.get(r.index)
        if m is None:
            return None
        return dataclasses.replace(r, index=m)
    if isinstance(r, rx.RLit):
        return r
    if isinstance(r, rx.RCall):
        new_args = []
        for a in r.args:
            m = _map_outer_residual(a, col_map)
            if m is None:
                return None
            new_args.append(m)
        return dataclasses.replace(r, args=tuple(new_args))
    if isinstance(r, rx.RCast):
        m = _map_outer_residual(r.child, col_map)
        return None if m is None else dataclasses.replace(r, child=m)
    return None


def _combine_residual(residuals: List[rx.Rex], n_left: int) -> Optional[rx.Rex]:
    """Residuals from decorrelation reference ROuterRef (outer/probe side)
    and BoundRef (subquery output). Rebase onto the combined left++right
    schema: outer i → i; inner j → n_left + j."""
    if not residuals:
        return None

    def rebase(r: rx.Rex) -> rx.Rex:
        if isinstance(r, ROuterRef):
            return rx.BoundRef(r.index, r.name, r.dtype, r.nullable)
        if isinstance(r, rx.BoundRef):
            return dataclasses.replace(r, index=r.index + n_left)
        if isinstance(r, rx.RCall):
            return dataclasses.replace(r, args=tuple(rebase(a) for a in r.args))
        if isinstance(r, rx.RCast):
            return dataclasses.replace(r, child=rebase(r.child))
        return r

    return _and_rex([rebase(r) for r in residuals])


def _group_scalar_subplan(node: pn.PlanNode, right_keys: List[rx.Rex]):
    """Convert a decorrelated global-aggregate subplan into a grouped one.

    ``node`` is the resolved subquery (after filter extraction): expected
    shape ProjectExec(AggregateExec(ProjectExec(child))) produced by the
    implicit-aggregate path, with exactly one output column. ``right_keys``
    are bound to the PRE-decorrelation subquery *source* columns, i.e. the
    aggregate's input child. Returns (grouped_plan, value_index, key_indices)
    where grouped_plan outputs [keys..., value].
    """
    if not (isinstance(node, pn.ProjectExec)
            and isinstance(node.input, pn.AggregateExec)):
        raise ResolutionError("correlated scalar subquery must be a single "
                              "aggregate query")
    post = node
    agg: pn.AggregateExec = node.input
    if agg.group_indices:
        raise ResolutionError("correlated scalar subquery already grouped")
    pre = agg.input
    assert isinstance(pre, pn.ProjectExec)
    # append key columns to the pre-projection
    key_names = [_fresh("k") for _ in right_keys]
    new_pre = pn.ProjectExec(pre.input, tuple(
        [(n, e) for n, e in pre.exprs]
        + list(zip(key_names, right_keys))))
    n_args = len(pre.exprs)
    new_agg = pn.AggregateExec(
        new_pre,
        tuple(range(n_args, n_args + len(right_keys))),
        tuple(dataclasses.replace(a, arg=None if a.arg is None else a.arg)
              for a in agg.aggs),
        tuple(key_names) + tuple(agg.out_names))
    # post-projection: keys first, then the original output expression with
    # refs shifted (agg outputs moved right by len(keys))
    nk = len(right_keys)

    def shift(r: rx.Rex) -> rx.Rex:
        if isinstance(r, rx.BoundRef):
            return dataclasses.replace(r, index=r.index + nk)
        if isinstance(r, rx.RCall):
            return dataclasses.replace(r, args=tuple(shift(a) for a in r.args))
        if isinstance(r, rx.RCast):
            return dataclasses.replace(r, child=shift(r.child))
        if isinstance(r, rx.RCase):
            return dataclasses.replace(
                r, branches=tuple((shift(c), shift(v)) for c, v in r.branches),
                else_value=None if r.else_value is None else shift(r.else_value))
        return r

    exprs = [(kn, rx.BoundRef(i, kn, new_agg.schema[i].dtype, True))
             for i, kn in enumerate(key_names)]
    name, val = post.exprs[0]
    exprs.append((name, shift(val)))
    out = pn.ProjectExec(new_agg, tuple(exprs))
    return out, nk, list(range(nk))


def _setop_common(a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """Set-operation column widening: like common_type, except string with
    a non-string side widens to STRING (Spark's findWiderTypeForTwo), not
    to the arithmetic double coercion."""
    if isinstance(a, dt.NullType):
        return b
    if isinstance(b, dt.NullType):
        return a
    if isinstance(a, dt.StringType) != isinstance(b, dt.StringType):
        return dt.StringType()
    return dt.common_type(a, b)


def _coerce_to(node: pn.PlanNode, target: Sequence[pn.Field]) -> pn.PlanNode:
    needs = False
    exprs = []
    for i, (f, t) in enumerate(zip(node.schema, target)):
        r: rx.Rex = rx.BoundRef(i, f.name, f.dtype, f.nullable)
        if f.dtype != t.dtype and not isinstance(t.dtype, dt.NullType):
            # cast straight to the caller-computed target type (a NullType
            # source lowers to a typed null literal in the compiler)
            r = rx.RCast(r, t.dtype)
            needs = True
        exprs.append((f.name, r))
    if not needs:
        return node
    return pn.ProjectExec(node, tuple(exprs))
