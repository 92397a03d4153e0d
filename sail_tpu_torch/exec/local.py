"""Local executor: physical plan → tensors on one device → Arrow.

The PyTorch counterpart of ``sail_tpu/exec/local.py`` for Scan (in-memory
tables), OneRow, Values, Range, Filter, Project, Aggregate, Sort, Limit,
Window, Union (UNION ALL; UNION DISTINCT, INTERSECT and EXCEPT resolve
to aggregates and semi/anti joins above it) and Join (equi-joins of
every type, cross joins, NOT IN), with runtime join filters and scalar
subqueries. Any other operator raises ``NotImplementedError``.

As in the reference, a Filter/Project chain runs as one stage with the
operator above it (aggregate, sort or join): the chain narrows ``sel``
and computes its output columns, and the consumer reads them directly.
A chain whose every expression has a program fragment runs as one
program (``ops/chain.py``): K16 on the card, which writes the selection
and each computed column once (a column the chain only passes through
is not copied). An aggregate whose grouping is keyless or direct
(dictionary codes and booleans, at most 4096 bins) and whose aggregates
are COUNT, SUM, MIN and MAX of non-string values absorbs its chain into
K17, which reduces in the same pass and materializes no column. Any
other chain runs its closures, one torch op a node; the route is decided
from the plan when the chain is bound, and ``chain_routes`` lists each
chain's route (with the first expression that kept a chain on the
closures). A chain's program or closures are compiled once per
(``plan/stages.py`` ``stage_fingerprint``, the dictionaries' identities,
the subquery values, the device, the session's time zone) and kept in
the session's ``chain_programs``, so a steady run compiles nothing; on
the card, binding a program also generates its kernel and compiles it
with NVRTC (``ops/chain_codegen.py``; once a process for each source,
which depends on no subquery value or dictionary). The
host waits for the device only where it needs a value to go on: a join
fetches its decision scalars (duplicate keys, hash ambiguity, output
size, filter counts) in one transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..columnar import arrow_interop as ai
from ..columnar.batch import (Column, DeviceBatch, HostBatch, StructData,
                              physical_torch_dtype)
from ..config import _DEFAULTS as config_defaults
from ..config import get as config_get
from ..config import truthy_value
from ..ops import aggregate as aggk
from ..ops import chain as chainop
from ..ops import chain_codegen
from ..ops import hash as hashk
from ..ops import join as joink
from ..ops import runtime_filter as rtfk
from ..ops import sort as sortk
from ..ops import window as wink
from . import host_aggs as hagg
from ..plan import join_reorder as jr
from ..plan import nodes as pn
from ..plan import rex as rx
from ..plan import runtime_filters as rtfp
from ..plan import stages
from ..plan.compiler import DictTables, ExprCompiler
from ..spec import data_type as dt
from ..spec.literal import Literal as LV
from ..utils.tz import session_timezone_name


# window functions computed by K9, and those whose output keeps the
# argument's dictionary
_RANK_FNS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
             "ntile")
_DICT_KEEPING = ("lag", "lead", "min", "max", "first", "last", "nth_value")


def _col_name(i: int) -> str:
    return f"c{i}"


def _full(x: torch.Tensor, n: int) -> torch.Tensor:
    """A 0-d (literal) result broadcast to n rows."""
    return x.expand(n) if x.dim() == 0 else x


class _RtfConf(NamedTuple):
    """spark.sail.join.runtimeFilter.* resolved for one executor."""

    enabled: bool
    min_build_rows: int
    max_bits: int
    in_list_max: int
    ndv_ratio: float
    min_selectivity: float


class _Rtf(NamedTuple):
    """A built runtime filter, ready to mask the filtered side."""

    res: rtfk.BuildResult
    ordinals: Tuple[int, ...]  # join-key ordinals folded into the bloom
    fids: Tuple[int, ...]      # annotated filter ids (scan stat lookup)
    history_key: object        # adaptive-skip key (None if unhashable)
    pushed: int                # scan targets that received conjuncts
    # False: built from the build (right) side, masks the probe side.
    # True: built from the probe (left) side, masks the build side.
    reverse: bool = False


class _Stage(NamedTuple):
    """A bound chain: its route ("K16", "K17", "K18", "per-op", or "refs"
    where it only passes columns through), its program (K16, K17, K18) or
    closures (``chain_fn``), its top's dictionaries and schema, and for a
    per-op chain the first expression without a fragment; K18's: each sort
    key's nulls_first."""

    route: str
    prog: Optional[chainop.ChainProgram]
    chain_fn: object
    dicts: Dict[str, pa.Array]
    schema: pn.Schema
    unfused: Optional[str]
    nodes: int
    # the dictionaries the key holds by identity
    held: tuple
    nulls_first: tuple = ()


# the most chain programs a session keeps
_MAX_PROGRAMS = 512
_STRUCT_UNPORTED = (
    "a struct value outside the arguments of a host aggregate is not "
    "ported yet: it waits for the slice that ports the host functions")


class LocalExecutor:
    """Runs one plan on ``device``. The session passes the same
    ``scan_cache`` (a memory scan's key → its uploaded batch, so a table's
    columns upload once), ``rtf_history`` (a join's runtime-filter key
    → the prune ratio it last observed; joins whose filters proved useless
    skip the build on later runs) and ``dict_tables`` (the lookup and
    rank tables made from string dictionaries) to every executor it
    makes, and ``chain_programs`` (each chain's bound program or closures,
    by its key). ``config`` is the session's conf. ``runtime_filters``
    logs, for each filter this executor built, the rows it saw and kept at
    the scans and at the join; ``chain_routes`` each chain's route, in the
    order the chains ran."""

    def __init__(self, device, scan_cache: Optional[dict] = None,
                 config: Optional[dict] = None,
                 rtf_history: Optional[dict] = None,
                 dict_tables: Optional[DictTables] = None,
                 chain_programs: Optional[dict] = None):
        self.device = torch.device(device)
        self.scan_cache = {} if scan_cache is None else scan_cache
        self.config = config or {}
        self.rtf_history = {} if rtf_history is None else rtf_history
        self.dict_tables = DictTables() if dict_tables is None \
            else dict_tables
        self.chain_programs = {} if chain_programs is None \
            else chain_programs
        self.chain_routes: List[dict] = []
        # each sort and sorted grouping: its consumer, the route of its
        # words (K18, or K3 over materialized keys) and its form (packed:
        # one sort of one word; passes: a sort a key, validity and the
        # dead rows)
        self.sort_routes: List[dict] = []
        self.runtime_filters: List[dict] = []
        # the rows (live and dead) each join of the plan put out, in the
        # order they ran: what a join order makes the card hold
        self.join_rows: List[int] = []
        self._subquery_cache: Dict[int, LV] = {}
        # per-fid (rows before, rows after as a device scalar) of the
        # runtime-filter conjuncts applied at a scan of this plan
        self._rtf_scan_stats: Dict[int, Tuple[int, torch.Tensor]] = {}

    def execute(self, plan: pn.PlanNode) -> pa.Table:
        """Run a plan to an Arrow table with the plan's output names."""
        self._pre_eval_subqueries(plan)
        table = ai.to_arrow(self.run(plan))
        return table.rename_columns([f.name for f in plan.schema])

    def run(self, plan: pn.PlanNode) -> HostBatch:
        method = getattr(self, "_exec_" + type(plan).__name__, None)
        if method is None:
            raise NotImplementedError(
                f"{type(plan).__name__} is not ported yet")
        out = method(plan)
        if isinstance(plan, pn.JoinExec):
            self.join_rows.append(int(out.device.sel.shape[0]))
        return out

    # -- scalar subqueries ----------------------------------------------------
    def _pre_eval_subqueries(self, plan: pn.PlanNode) -> None:
        for node in pn.walk_plan(plan):
            for r in _node_rex(node):
                for sub in rx.walk(r):
                    if isinstance(sub, rx.RScalarSubquery) and \
                            id(sub) not in self._subquery_cache:
                        self._subquery_cache[id(sub)] = self._eval_scalar(sub)

    def _eval_scalar(self, sub: rx.RScalarSubquery) -> LV:
        inner = LocalExecutor(self.device, self.scan_cache, self.config,
                              self.rtf_history, self.dict_tables,
                              self.chain_programs)
        inner._subquery_cache = self._subquery_cache
        table = inner.execute(sub.plan)
        self.runtime_filters.extend(inner.runtime_filters)
        self.join_rows.extend(inner.join_rows)
        self.chain_routes.extend(inner.chain_routes)
        self.sort_routes.extend(inner.sort_routes)
        if table.num_rows == 0:
            return LV(sub.dtype, None)
        if table.num_rows > 1:
            raise RuntimeError("scalar subquery returned more than one row")
        return LV(sub.dtype, table.column(0)[0].as_py())

    # -- expression plumbing ------------------------------------------------
    def _compiler(self, dicts: Dict[str, pa.Array], schema: pn.Schema,
                  frags=None) -> ExprCompiler:
        by_index = {i: dicts[_col_name(i)] for i in range(len(schema))
                    if _col_name(i) in dicts}
        return ExprCompiler([f.dtype for f in schema], by_index, self.device,
                            self._subquery_cache, self.dict_tables, frags)

    def _dict_order(self, dictionary: pa.Array
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rank of each code by value, code of each rank) on the device,
        kept in ``dict_tables``."""
        def build():
            ranks = ai.dictionary_ranks(dictionary)
            inverse = np.empty_like(ranks)
            inverse[ranks] = np.arange(len(ranks), dtype=ranks.dtype)
            return (torch.from_numpy(ranks).to(self.device),
                    torch.from_numpy(inverse).to(self.device))
        return self.dict_tables.get((dictionary,), ("order", self.device),
                                    build)

    def _eval_mask(self, cond: rx.Rex, batch: HostBatch,
                   schema: pn.Schema) -> torch.Tensor:
        """A boolean condition over a batch as a row mask (NULL is
        false)."""
        d, v = self._compiler(batch.dicts, schema).compile(cond).fn(
            self._cols(batch))
        n = batch.capacity
        keep = _full(d.bool(), n)
        return keep if v is None else keep & _full(v, n)

    @staticmethod
    def _cols(batch: HostBatch) -> List:
        dev = batch.device
        return [(dev.columns[_col_name(i)].data,
                 dev.columns[_col_name(i)].validity)
                for i in range(len(dev.columns))]

    # -- chains -------------------------------------------------------------
    @staticmethod
    def _split_chain(top: pn.PlanNode):
        """(the Filter/Project chain from ``top`` down, top-down; the node
        below it)."""
        chain = []
        node = top
        while isinstance(node, stages.FUSABLE_OPS):
            chain.append(node)
            node = node.input
        return chain, node

    def _lower_chain(self, chain: List[pn.PlanNode], bottom: HostBatch,
                     bottom_node: pn.PlanNode):
        """Compile a chain (top-down) over the bottom batch: (chain_fn,
        filter fragments, the top's column fragments, its dictionaries,
        its schema, the first expression without a fragment). chain_fn
        maps the bottom's (cols, sel) to the top's, one torch op a node;
        dictionaries propagate level by level."""
        dicts = dict(bottom.dicts)
        schema = bottom_node.schema
        frags = [chainop.col(i, d.dtype, v is not None)
                 for i, (d, v) in enumerate(self._cols(bottom))]
        steps, filters = [], []
        unfused = None
        for node in reversed(chain):
            comp = self._compiler(dicts, schema, frags)
            if isinstance(node, pn.FilterExec):
                c = comp.compile(node.condition)
                steps.append((c, None))
                filters.append(c.frag)
            else:
                compiled = [comp.compile(e) for _, e in node.exprs]
                types = [physical_torch_dtype(rx.rex_type(e))
                         for _, e in node.exprs]
                steps.append((compiled, types))
                frags = [None if c.frag is None else chainop.conv(c.frag, t)
                         for c, t in zip(compiled, types)]
                dicts = {_col_name(i): c.dictionary
                         for i, c in enumerate(compiled)
                         if c.dictionary is not None}
                schema = node.schema
            if unfused is None and comp.unfused:
                unfused = f"{type(node).__name__}: " \
                          f"{_describe(comp.unfused[0])}"

        def chain_fn(cols, sel):
            n = sel.shape[0]
            for compiled, types in steps:
                if types is None:  # filter: narrow the selection
                    d, v = compiled.fn(cols)
                    keep = d.bool() if v is None else (d.bool() & v)
                    sel = sel & keep
                    continue
                new_cols = []
                for c, tdt in zip(compiled, types):
                    d, v = c.fn(cols)
                    if isinstance(d, StructData):  # a host aggregate's
                        new_cols.append((d, None))
                        continue
                    new_cols.append((_full(d.to(tdt), n),
                                     None if v is None else _full(v, n)))
                cols = new_cols
            return cols, sel

        return chain_fn, filters, frags, dicts, schema, unfused

    def _stage(self, chain: List[pn.PlanNode], bottom: HostBatch,
               bottom_node: pn.PlanNode,
               agg: Optional[pn.AggregateExec] = None,
               sort: Optional[pn.SortExec] = None) -> _Stage:
        """The chain bound to a route, from ``chain_programs`` where it was
        bound before; ``agg`` or ``sort``: the operator it feeds, whose
        grouping or keys the program may take in (K17, K18)."""
        key = self._stage_key(chain, bottom, bottom_node, agg, sort)
        hit = None if key is None else self.chain_programs.get(key)
        if hit is None:
            hit = self._bind_stage(chain, bottom, bottom_node, agg, sort)
            if key is not None:
                while len(self.chain_programs) >= _MAX_PROGRAMS:
                    self.chain_programs.pop(next(iter(self.chain_programs)))
                self.chain_programs[key] = hit
        return hit

    def _stage_key(self, chain, bottom: HostBatch, bottom_node, agg,
                   sort=None):
        top = agg if agg is not None else sort
        nodes = ([top] if top is not None else []) + \
            [self._bind_subqueries(n) for n in chain]
        key = ("agg" if agg is not None else
               "sort" if sort is not None else "chain",
               stages.stage_fingerprint(nodes, bottom_node.schema),
               tuple((d.dtype, v is not None)
                     for d, v in self._cols(bottom)),
               tuple(sorted((k, id(v)) for k, v in bottom.dicts.items())),
               self.device, session_timezone_name())
        try:
            hash(key)
        except TypeError:  # an expression holds an unhashable option
            return None
        return key

    def _bind_subqueries(self, node: pn.PlanNode) -> pn.PlanNode:
        """``node`` with each scalar subquery replaced by its value (the
        value the program bakes in, and so keys on)."""
        def bind(r: rx.Rex) -> rx.Rex:
            if isinstance(r, rx.RScalarSubquery):
                return rx.RLit(self._subquery_cache[id(r)])
            if isinstance(r, rx.RCall):
                return dataclasses.replace(r, args=tuple(bind(a)
                                                         for a in r.args))
            if isinstance(r, rx.RCast):
                return dataclasses.replace(r, child=bind(r.child))
            if isinstance(r, rx.RCase):
                return dataclasses.replace(
                    r, branches=tuple((bind(c), bind(v))
                                      for c, v in r.branches),
                    else_value=None if r.else_value is None
                    else bind(r.else_value))
            return r

        exprs = [node.condition] if isinstance(node, pn.FilterExec) else \
            [e for _, e in node.exprs]
        if not any(isinstance(x, rx.RScalarSubquery)
                   for e in exprs for x in rx.walk(e)):
            return node
        if isinstance(node, pn.FilterExec):
            return dataclasses.replace(node, condition=bind(node.condition))
        return dataclasses.replace(node, exprs=tuple(
            (n, bind(e)) for n, e in node.exprs))

    def _bind_stage(self, chain, bottom: HostBatch, bottom_node,
                    agg, sort=None) -> _Stage:
        chain_fn, filters, frags, dicts, schema, unfused = \
            self._lower_chain(chain, bottom, bottom_node)
        held = tuple(bottom.dicts.values())

        def stage(route, prog, why=None, nulls_first=()):
            return _Stage(route, prog, chain_fn, dicts, schema, why,
                          len(chain), held, tuple(nulls_first))

        if unfused is not None:
            return stage("per-op", None, unfused)
        if agg is not None:
            sinks = _agg_sinks(agg, frags, dicts, schema)
            prog = None
            if sinks is not None:
                try:
                    prog = chainop.build_program(filters, (), self.device,
                                                 *sinks)
                except ValueError:
                    pass  # past K17's limits: K16, then the K1 route
            if prog is not None:
                return stage("K17", self._compiled(prog))
        sorted_ = None
        if agg is not None:
            sorted_ = _group_sort_sinks(agg, filters, frags, dicts)
        elif sort is not None:
            sorted_ = self._sort_sinks(sort, filters, frags, dicts, schema)
        if sorted_ is not None:
            outputs, keys, nulls_first = sorted_
            try:
                prog = chainop.build_program(filters, outputs, self.device,
                                             sort_keys=keys)
            except ValueError:
                prog = None  # past the kernel's limits: K16, then K3
            if prog is not None:
                return stage("K18", self._compiled(prog),
                             nulls_first=nulls_first)
        try:
            prog = chainop.build_program(filters, frags, self.device)
        except ValueError as e:
            return stage("per-op", None, f"{e}")
        if not prog.instrs:
            return stage("refs", prog)
        return stage("K16", self._compiled(prog))

    def _sort_sinks(self, p: pn.SortExec, filters, frags, dicts, schema):
        """K18's (outputs, sort keys, nulls_first) for the sort ``p`` over a
        chain whose top has ``frags``: every column stored or passed
        through (the sort gathers them all), each key's fragment (a
        dictionary code through the session's rank table, so its word
        orders by value). None where the sort takes K3 instead: a key
        without a fragment or with a scalar subquery (its value would be
        baked in), or plain key columns over no chain."""
        if any(isinstance(x, rx.RScalarSubquery)
               for k in p.keys for x in rx.walk(k.expr)):
            return None
        comp = self._compiler(dicts, schema, frags)
        keys, nulls_first, plain = [], [], not filters and all(
            f is not None and f.op == "col" for f in frags)
        for k in p.keys:
            c = comp.compile(k.expr)
            f = c.frag
            if f is None or f.dtype not in chainop.TYPE_CODE:
                return None
            plain = plain and f.op == "col"
            if c.dictionary is not None and len(c.dictionary) > 0:
                f = chainop.op("lut", f, dtype=torch.int32,
                               nullable=f.nullable, imm=(chainop.Table(
                                   self._dict_order(c.dictionary)[0]),))
            keys.append(chainop.SortKey(f, descending=not k.ascending))
            nulls_first.append(k.ascending if k.nulls_first is None
                               else k.nulls_first)
        if plain or not keys:
            return None
        return frags, keys, nulls_first

    def _compiled(self, prog: chainop.ChainProgram) -> chainop.ChainProgram:
        """On the card, the program's kernel generated and compiled (or
        loaded from the cubin cache) now, where the chain is bound, so a
        steady run compiles nothing; an NVRTC or load error raises."""
        if self.device.type == "cuda":
            chain_codegen.kernel(prog, self.device)
        return prog

    def _run_chain(self, top: pn.PlanNode, consumer: str
                   ) -> Tuple[List, torch.Tensor, Dict, pn.Schema]:
        """Execute the Filter/Project chain from ``top`` down over the batch
        below it; returns (cols, sel, dicts, schema) of the chain's top."""
        chain, node = self._split_chain(top)
        child = self.run(node)
        stage = self._stage(chain, child, node)
        cols, sel = self._apply_stage(stage, child, consumer)
        return cols, sel, stage.dicts, stage.schema

    def _apply_sort_stage(self, stage: _Stage, child: HostBatch,
                          consumer: str) -> chainop.ChainSorted:
        """Run a K18 stage over ``child``: the chain's columns, its
        selection, and its sort keys' words and extremes; logs its
        route."""
        self.chain_routes.append(dict(route="K18", nodes=stage.nodes,
                                      consumer=consumer, first_unfused=None))
        return chainop.run_chain_sort(stage.prog, self._cols(child),
                                      child.device.sel)

    def _apply_stage(self, stage: _Stage, child: HostBatch, consumer: str):
        """Run a bound chain (K16, its closures, or nothing where it only
        passes columns through) over ``child``; logs its route."""
        self.chain_routes.append(dict(route=stage.route, nodes=stage.nodes,
                                      consumer=consumer,
                                      first_unfused=stage.unfused))
        cols, sel = self._cols(child), child.device.sel
        if stage.route == "K16":
            return chainop.run_chain(stage.prog, cols, sel)
        if stage.route == "refs":
            return [cols[k] for _, k in stage.prog.out_map], sel
        cols, sel = stage.chain_fn(cols, sel)
        if consumer != "AggregateExec" and \
                any(isinstance(d, StructData) for d, _ in cols):
            raise NotImplementedError(_STRUCT_UNPORTED)
        return cols, sel

    # -- leaves -------------------------------------------------------------
    def _exec_ScanExec(self, p: pn.ScanExec) -> HostBatch:
        if p.format != "memory" or not isinstance(p.source, pa.Table):
            raise NotImplementedError(
                f"scans of {p.format!r} sources are not ported yet")
        key = ("mem", id(p.source), p.projection)
        hit = self.scan_cache.get(key)
        if hit is not None and hit[0] is p.source:
            hb = hit[1]
        else:
            table = p.source
            if p.projection is not None:
                table = table.select(list(p.projection))
            hb = _positional(ai.from_arrow(table, self.device))
            # the entry holds the table itself, so its id cannot be reused
            self.scan_cache[key] = (p.source, hb)
        if not p.runtime_predicates:
            return hb
        # runtime join-filter conjuncts pushed here by a join's source
        # side: the table stays resident, so they narrow the selection on
        # the device (the reference filters on the host before upload; the
        # answer is the same)
        sel = hb.device.sel
        for c in p.runtime_predicates:
            sel = sel & self._eval_mask(c, hb, p.schema)
        for t in p.runtime_filters:
            self._rtf_scan_stats[t.fid] = (hb.capacity, sel.sum())
        return HostBatch(hb.device.with_sel(sel), hb.dicts)

    def _exec_OneRowExec(self, p: pn.OneRowExec) -> HostBatch:
        return HostBatch(DeviceBatch({}, torch.ones(
            1, dtype=torch.bool, device=self.device)), {})

    def _exec_ValuesExec(self, p: pn.ValuesExec) -> HostBatch:
        arrays = []
        for j, f in enumerate(p.out_schema):
            vals = [row[j].value for row in p.rows]
            at = ai.spec_type_to_arrow(f.dtype)
            if isinstance(f.dtype, dt.YearMonthIntervalType):
                vals = [None if v is None else (int(v), 0, 0) for v in vals]
            arrays.append(pa.array(vals, type=at))
        table = pa.table({_col_name(j): a for j, a in enumerate(arrays)})
        return ai.from_arrow(table, self.device)

    def _exec_RangeExec(self, p: pn.RangeExec) -> HostBatch:
        ids = torch.arange(p.start, p.end, p.step, dtype=torch.int64,
                           device=self.device) if p.step else \
            torch.empty(0, dtype=torch.int64, device=self.device)
        return HostBatch(DeviceBatch(
            {_col_name(0): Column(ids, None, dt.LongType())},
            torch.ones(ids.shape[0], dtype=torch.bool, device=self.device)),
            {})

    # -- unary operators ----------------------------------------------------
    def _exec_ProjectExec(self, p: pn.ProjectExec) -> HostBatch:
        return self._chain_batch(p)

    def _exec_FilterExec(self, p: pn.FilterExec) -> HostBatch:
        return self._chain_batch(p)

    def _chain_batch(self, top: pn.PlanNode) -> HostBatch:
        cols, sel, dicts, schema = self._run_chain(top, "output")
        return HostBatch(DeviceBatch(
            {_col_name(i): Column(d, v, f.dtype)
             for i, ((d, v), f) in enumerate(zip(cols, schema))}, sel), dicts)

    def _exec_LimitExec(self, p: pn.LimitExec) -> HostBatch:
        child = self.run(p.input)
        dev = child.device
        if p.offset == -1:  # tail
            n = dev.num_rows()
            off = max(0, n - (p.limit or 0))
            out = sortk.limit(dev, p.limit or 0, off)
        else:
            out = sortk.limit(dev, p.limit if p.limit is not None
                              else dev.capacity, p.offset)
        return HostBatch(out, child.dicts)

    def _exec_SortExec(self, p: pn.SortExec) -> HostBatch:
        """The chain below and the sort keys' words as one K18 pass where
        the keys have fragments (else the chain, then the keys' closures
        and K3), then one sort of the packed word where the keys fit in
        it (else the passes), and the gathers."""
        chain, node = self._split_chain(p.input)
        child = self.run(node)
        stage = self._stage(chain, child, node, sort=p)
        dicts, schema = stage.dicts, stage.schema
        if stage.route == "K18":
            out = self._apply_sort_stage(stage, child, "SortExec")
            cols, sel, ext = out.cols, out.sel, out.ext
            words = [(w, v, nf) for (w, v), nf in zip(out.words,
                                                      stage.nulls_first)]
        else:
            cols, sel = self._apply_stage(stage, child, "SortExec")
            words, ext = self._sort_words(p, cols, sel, dicts, schema), None
        n = sel.shape[0]
        srt = sortk.sort_words(words, sel, ext) if words else \
            sortk.SortedWords(sortk.lexsort_keys([], sel), None, None)
        self.sort_routes.append(dict(consumer="SortExec", route=stage.route
                                     if stage.route == "K18" else "K3",
                                     form=srt.form, keys=len(words)))
        perm = srt.perm
        out_sel = sel[perm]
        if p.limit is not None:
            out_sel = out_sel & (torch.arange(n, device=self.device) < p.limit)
        out = {_col_name(i): Column(d[perm], None if v is None else v[perm],
                                    f.dtype)
               for i, ((d, v), f) in enumerate(zip(cols, schema))}
        return HostBatch(DeviceBatch(out, out_sel), dicts)

    def _sort_words(self, p: pn.SortExec, cols, sel, dicts, schema):
        """The sort keys' K3 words (int64, validity, nulls_first) by their
        closures over the chain's materialized columns: a dictionary code
        through the session's rank table first."""
        comp = self._compiler(dicts, schema)
        n = sel.shape[0]
        words = []
        for k in p.keys:
            c = comp.compile(k.expr)
            data, validity = c.fn(cols)
            data = _full(data, n)
            validity = None if validity is None else _full(validity, n)
            if c.dictionary is not None and len(c.dictionary) > 0:
                # order dictionary codes by VALUE through a rank table
                data = self._dict_order(c.dictionary)[0][data.long()]
            words.append((sortk.order_keys(data, k.ascending), validity,
                          k.ascending if k.nulls_first is None
                          else k.nulls_first))
        return words

    # -- aggregation ----------------------------------------------------------
    def _exec_AggregateExec(self, p: pn.AggregateExec) -> HostBatch:
        chain, node = self._split_chain(p.input)
        child = self.run(node)
        stage = self._stage(chain, child, node, agg=p)
        dicts = stage.dicts
        if stage.route == "K17":
            return self._reduce_chain(p, stage, child)
        if stage.route == "K18":
            out = self._apply_sort_stage(stage, child, "AggregateExec")
            return self._aggregate(p, out.cols, out.sel, dicts, out.words,
                                   out.ext)
        cols, sel = self._apply_stage(stage, child, "AggregateExec")
        return self._aggregate(p, cols, sel, dicts)

    def _aggregate(self, p: pn.AggregateExec, cols: List,
                   sel: torch.Tensor, dicts: Dict[str, pa.Array],
                   words=None, ext=None) -> HostBatch:
        """The aggregate over its input's columns: K2 or a sort groups the
        rows, K1 reduces each aggregate. ``words``, ``ext``: the group keys'
        K3 words and their extremes, where K18 wrote them."""
        in_schema = p.input.schema
        n = sel.shape[0]
        key_cols = [Column(cols[i][0], cols[i][1], in_schema[i].dtype)
                    for i in p.group_indices]
        # direct binning when every group key has a known small domain
        # (dictionary codes / booleans) — no sort needed
        domains = _direct_domains(p, dicts)
        if domains is not None:
            ctx, keys = aggk.group_rows_direct(key_cols, domains, sel)
        else:
            ctx, keys = aggk.group_rows(key_cols, sel,
                                        n if p.group_indices else 1, words,
                                        ext)
            if p.group_indices:
                self.sort_routes.append(dict(
                    consumer="AggregateExec",
                    route="K3" if words is None else "K18",
                    form=ctx.sort_form, keys=len(key_cols)))
        out_cols: Dict[str, Column] = {}
        out_dicts: Dict[str, pa.Array] = {}
        # host aggregates reduce into the groups there are (a sorted
        # grouping's count read once); the others' columns are cut to them
        host = None
        if any(hagg.host_name(a.fn) for a in p.aggs):
            host = hagg.HostAgg(ctx, aggk.output_slots(ctx),
                                self._dict_order, hagg.needed_sums(p.aggs))

        def cut(t):
            return t if host is None or t is None else t[:host.slots]

        def cut_column(col: Column) -> Column:
            return Column(cut(col.data), cut(col.validity), col.dtype)
        for j, (gi, g) in enumerate(zip(p.group_indices,
                                        aggk.group_key_output(ctx, keys))):
            out_cols[_col_name(j)] = cut_column(g)
            if _col_name(gi) in dicts:
                out_dicts[_col_name(j)] = dicts[_col_name(gi)]
        ng = len(p.group_indices)
        distinct: Dict[int, torch.Tensor] = {}  # arg → its distinct rows
        for j, a in enumerate(p.aggs):
            src_dict = None if a.arg is None else dicts.get(_col_name(a.arg))
            if hagg.host_name(a.fn):
                d, v = cols[a.arg]
                col, out_dict = host.run(a, hagg.arg_fields(
                    d, v, in_schema[a.arg].dtype, src_dict))
                out_cols[_col_name(ng + j)] = col
                if out_dict is not None:
                    out_dicts[_col_name(ng + j)] = out_dict
                continue
            if a.arg is not None and isinstance(cols[a.arg][0], StructData):
                raise NotImplementedError(_STRUCT_UNPORTED)
            arg = None if a.arg is None else \
                Column(cols[a.arg][0], cols[a.arg][1], in_schema[a.arg].dtype)
            if a.distinct and arg is not None:
                if a.arg not in distinct:
                    distinct[a.arg] = aggk.distinct_rows(ctx, arg)
                arg = Column(arg.data, distinct[a.arg], arg.dtype)
            col = self._run_agg(ctx, a, arg, src_dict)
            out_cols[_col_name(ng + j)] = cut_column(Column(
                col.data, col.validity, a.out_dtype))
            if src_dict is not None and a.fn in ("min", "max", "first",
                                                 "last"):
                out_dicts[_col_name(ng + j)] = src_dict
        out = sortk.compact(DeviceBatch(out_cols, cut(aggk.group_sel(ctx))))
        return HostBatch(out, out_dicts)

    def _reduce_chain(self, p: pn.AggregateExec, stage: _Stage,
                      child: HostBatch) -> HostBatch:
        """K17: the chain and the aggregate in one pass; its bins numbered
        as K2 numbers them, its columns as the K1 route's."""
        self.chain_routes.append(dict(route="K17", nodes=stage.nodes,
                                      consumer="AggregateExec",
                                      first_unfused=None))
        in_schema = p.input.schema
        red = chainop.run_chain_reduce(
            stage.prog, self._cols(child), child.device.sel,
            [in_schema[gi].dtype for gi in p.group_indices],
            [a.out_dtype for a in p.aggs])
        out_cols: Dict[str, Column] = {}
        out_dicts: Dict[str, pa.Array] = {}
        for j, (gi, g) in enumerate(zip(p.group_indices, red.keys)):
            out_cols[_col_name(j)] = g
            if _col_name(gi) in stage.dicts:
                out_dicts[_col_name(j)] = stage.dicts[_col_name(gi)]
        ng = len(p.group_indices)
        for j, (a, col) in enumerate(zip(p.aggs, red.aggs)):
            out_cols[_col_name(ng + j)] = Column(col.data, col.validity,
                                                 a.out_dtype)
        out = sortk.compact(DeviceBatch(out_cols, red.group_sel))
        return HostBatch(out, out_dicts)

    def _run_agg(self, ctx, a: pn.AggSpec, arg: Optional[Column],
                 dictionary: Optional[pa.Array]) -> Column:
        if a.fn in ("min", "max") and dictionary is not None and \
                len(dictionary) > 1:
            # MIN/MAX of strings order by VALUE: the codes go through the
            # dictionary's rank table, K1 reduces the ranks, and the
            # inverse table turns them back into codes of the dictionary
            ranks, inverse = self._dict_order(dictionary)
            col = aggk.agg_min_max(
                ctx, Column(ranks[arg.data.long()], arg.validity, arg.dtype),
                is_min=a.fn == "min")
            top = len(dictionary) - 1  # an empty group holds K1's identity
            return Column(inverse[torch.clamp(col.data, 0, top).long()],
                          col.validity, col.dtype)
        if a.fn == "count":
            return aggk.agg_count(ctx, arg)
        if a.fn == "sum":
            return aggk.agg_sum(ctx, arg, a.out_dtype)
        if a.fn in ("min", "max"):
            return aggk.agg_min_max(ctx, arg, is_min=a.fn == "min")
        if a.fn in ("first", "last"):
            return aggk.agg_first_last(ctx, arg, is_first=a.fn == "first",
                                       ignore_nulls=a.ignore_nulls)
        if a.fn in ("bool_and", "bool_or"):
            return aggk.agg_bool(ctx, arg, is_any=a.fn == "bool_or")
        raise NotImplementedError(f"aggregate {a.fn!r} is not ported yet")

    # -- windows --------------------------------------------------------------
    def _exec_WindowExec(self, p: pn.WindowExec) -> HostBatch:
        """One context (a sort and one K8 launch) per (partition, order)
        key; each context's rank functions in one K9 launch (one more
        per further ntile bucket count); the aggregates through K10 and
        K11; lag, lead, nth_value, first and last in sorted order over
        the values gathered once a column and context."""
        child = self.run(p.input)
        in_schema = p.input.schema
        cols = self._cols(child)
        sel = child.device.sel

        def ctx_key(s: pn.WindowSpec):
            return (tuple(s.partition_indices),
                    tuple((k.expr.index, k.ascending, k.nulls_first)
                          for k in s.order_keys))

        contexts: Dict[tuple, wink.WindowContext] = {}
        ranks: Dict[tuple, torch.Tensor] = {}  # (ctx key, fn, ntile n)
        for s in p.windows:
            ck = ctx_key(s)
            if ck in contexts:
                continue
            order = []
            for k in s.order_keys:
                i = k.expr.index
                d, v = cols[i]
                kdt = in_schema[i].dtype
                dictionary = child.dicts.get(_col_name(i))
                if dictionary is not None and len(dictionary) > 0:
                    # order dictionary codes by VALUE through a rank table
                    d = self._dict_order(dictionary)[0][d.long()]
                    kdt = dt.IntegerType()
                order.append((d, v, kdt, k.ascending, k.nulls_first))
            ctx = wink.build_window_context(
                [Column(cols[i][0], cols[i][1], in_schema[i].dtype)
                 for i in s.partition_indices], order, sel)
            contexts[ck] = ctx
            mine = [w for w in p.windows if ctx_key(w) == ck]
            names = sorted({w.function for w in mine
                            if w.function in _RANK_FNS})
            tiles = sorted({int(dict(w.options)["n"]) for w in mine
                            if w.function == "ntile"})
            for j, n_tiles in enumerate(tiles or [1]):
                wanted = [f for f in names if f != "ntile" and j == 0] + \
                    (["ntile"] if tiles else [])
                if wanted:
                    for f, t in wink.window_ranks(ctx, wanted,
                                                  n_tiles).items():
                        ranks[(ck, f, n_tiles if f == "ntile" else None)] = t

        out_cols = dict(child.device.columns)
        out_dicts = dict(child.dicts)
        n_in = len(in_schema)
        for j, s in enumerate(p.windows):
            ck = ctx_key(s)
            ctx = contexts[ck]
            opts = dict(s.options)
            f = s.function
            src_dict = None if s.arg is None else \
                child.dicts.get(_col_name(s.arg))
            arg = None if s.arg is None else \
                Column(cols[s.arg][0], cols[s.arg][1], in_schema[s.arg].dtype)
            out_dict = src_dict if f in _DICT_KEEPING else None
            if f in _RANK_FNS:
                n_tiles = int(opts["n"]) if f == "ntile" else None
                d, v = ranks[(ck, f, n_tiles)], None
            elif f in ("lag", "lead"):
                default = opts.get("default")
                if isinstance(default, str):
                    if src_dict is None:
                        raise ValueError(f"{f}() string default over a "
                                         f"non-string column")
                    vals = src_dict.cast(pa.string()).to_pylist()
                    if default not in vals:  # extend the dictionary
                        out_dict = pa.array(vals + [default])
                        vals.append(default)
                    default = vals.index(default)
                elif default is not None and \
                        isinstance(arg.dtype, dt.DecimalType):
                    # the column holds unscaled decimals: scale the default
                    default = LV(arg.dtype, default).physical_value()
                d, v = wink.shift(ctx, arg, int(opts["offset"]), default)
            elif f == "nth_value":
                d, v = wink.nth(ctx, arg, int(opts["n"]),
                                _range_peer(ctx, s), s.frame_lower,
                                s.frame_upper)
            else:
                d, v = self._framed_window(ctx, s, arg, src_dict)
            tdt = physical_torch_dtype(s.out_dtype)
            name = _col_name(n_in + j)
            out_cols[name] = Column(d.to(tdt), v, s.out_dtype)
            if out_dict is not None:
                out_dicts[name] = out_dict
        return HostBatch(DeviceBatch(out_cols, sel), out_dicts)

    def _framed_window(self, ctx, s: pn.WindowSpec, arg: Optional[Column],
                       dictionary: Optional[pa.Array]):
        f = s.function
        inverse = None
        if f in ("min", "max") and dictionary is not None and \
                len(dictionary) > 0:
            # strings compare by VALUE: ranks in, the code of the rank out
            rank_of, inverse = self._dict_order(dictionary)
            arg = Column(rank_of[arg.data.long()], arg.validity,
                         dt.IntegerType())
        d, v = wink.framed_agg(ctx, arg, f, s.frame_lower, s.frame_upper,
                               _range_peer(ctx, s),
                               bool(dict(s.options).get("ignore_nulls")))
        if inverse is not None:
            d = inverse[torch.clamp(d, 0, len(dictionary) - 1).long()]
        if f == "avg" and isinstance(arg.dtype, dt.DecimalType):
            d = d / (10.0 ** arg.dtype.scale)
        return d, v

    # -- union ----------------------------------------------------------------
    def _exec_UnionExec(self, p: pn.UnionExec) -> HostBatch:
        """UNION ALL: the branches' rows one after another. String columns
        merge their dictionaries and remap each branch's codes on the
        device; nested columns concatenate their arrays and move each
        branch's codes past the earlier ones'; numeric columns take the
        union's physical type. (UNION
        DISTINCT, INTERSECT and EXCEPT resolve to an aggregate or a
        semi/anti join above this.)"""
        parts = [self.run(c) for c in p.inputs]
        cols, dicts = {}, {}
        for i, f in enumerate(p.schema):
            key = _col_name(i)
            branch = [b.device.columns[key] for b in parts]
            if any(key in b.dicts for b in parts) and isinstance(
                    f.dtype, (dt.ArrayType, dt.MapType, dt.StructType)):
                # nested values: the branches' arrays one after another,
                # each branch's positional codes moved past the earlier
                at = ai.spec_type_to_arrow(f.dtype)
                pieces, datas, off = [], [], 0
                for b, c in zip(parts, branch):
                    d = b.dicts.get(key)
                    d = pa.array([], type=at) if d is None else d.cast(at)
                    datas.append(c.data.to(torch.int32) + off)
                    pieces.append(d)
                    off += len(d)
                dicts[key] = pa.concat_arrays(pieces)
            elif any(key in b.dicts for b in parts):
                from ..plan.compiler import _merge_dicts
                merged, remaps = _merge_dicts([b.dicts.get(key)
                                               for b in parts])
                datas = [torch.from_numpy(rm).to(self.device)[c.data.long()]
                         if len(rm) else torch.zeros_like(c.data,
                                                          dtype=torch.int32)
                         for rm, c in zip(remaps, branch)]
                dicts[key] = merged
            else:
                tdt = physical_torch_dtype(f.dtype)
                datas = [c.data.to(tdt) for c in branch]
            cols[key] = Column(torch.cat(datas), _cat_validity(branch),
                               f.dtype)
        sel = torch.cat([b.device.sel for b in parts])
        return HostBatch(DeviceBatch(cols, sel), dicts)

    # -- joins ----------------------------------------------------------------
    def _exec_JoinExec(self, p: pn.JoinExec) -> HostBatch:
        left, right, rtf = self._run_join_inputs(p)
        jt = p.join_type
        if jt == "anti" and p.null_aware:
            return self._null_aware_anti(p, left, right)
        if jt in ("cross", "inner") and not p.left_keys:
            out = self._cross_join(p, left, right)
            if p.residual is not None:
                keep = self._eval_mask(p.residual, out, _combined(p))
                out = HostBatch(out.device.with_sel(out.device.sel & keep),
                                out.dicts)
            return out
        if jt == "right":
            flipped = pn.JoinExec(p.right, p.left, "left", p.right_keys,
                                  p.left_keys,
                                  _flip_residual(p.residual, len(p.left.schema),
                                                 len(p.right.schema)))
            out = self._join(flipped, right, left)
            return _reorder_right(out, len(p.right.schema), len(p.left.schema))
        return self._join(p, left, right, rtf=rtf)

    def _null_aware_anti(self, p: pn.JoinExec, left: HostBatch,
                         right: HostBatch) -> HostBatch:
        """NOT IN (subquery) anti join.

        The IN key is the last key pair; earlier pairs are correlation
        keys. NOT IN over an empty set is TRUE; any NULL build key makes
        every membership test unknown (no rows); NULL probe keys are
        excluded while the build side is non-empty.
        """
        rcomp = self._compiler(right.dicts, p.right.schema)
        _, rval = rcomp.compile(p.right_keys[-1]).fn(self._cols(right))
        rsel = right.device.sel
        null_build = rsel & ~_full(rval, rsel.shape[0]) if rval is not None \
            else torch.zeros_like(rsel)
        n_build, n_null = (int(x) for x in
                           torch.stack([rsel.sum(), null_build.sum()]).cpu())
        if n_build == 0:
            return left
        # Residual conjuncts are per-row correlation too: the membership set
        # differs per probe row, so the global NULL shortcuts don't apply.
        correlated = len(p.left_keys) > 1 or p.residual is not None
        if n_null:
            if correlated:
                raise NotImplementedError(
                    "correlated NOT IN with NULL subquery keys")
            return HostBatch(
                left.device.with_sel(torch.zeros_like(left.device.sel)),
                left.dicts)
        out = self._join(p, left, right)
        lcomp = self._compiler(left.dicts, p.left.schema)
        _, lval = lcomp.compile(p.left_keys[-1]).fn(self._cols(left))
        if lval is not None:
            lval = _full(lval, left.capacity)
            if bool((left.device.sel & ~lval).any()):
                if correlated:
                    raise NotImplementedError(
                        "correlated NOT IN with NULL probe keys")
                out = HostBatch(out.device.with_sel(out.device.sel & lval),
                                out.dicts)
        return out

    # -- runtime join filters (sideways information passing) ---------------
    def _run_join_inputs(self, p: pn.JoinExec):
        """Run a join's children. For runtime-filter-annotated inner/semi
        joins the estimated-SMALLER side runs first; a filter derived
        from its keys is pushed into the other subtree's annotated scans
        before that side executes, and a bloom mask is handed to ``_join``
        for the filtered side's selection. Forward = build (right) filters
        probe; reverse = probe (left) filters build."""
        conf = self._rtf_conf()
        use = (conf.enabled and p.runtime_filters and p.left_keys
               and p.join_type in ("inner", "semi") and not p.null_aware)
        if not use:
            return self.run(p.left), self.run(p.right), None
        est_l, est_r = _rtf_est_rows(p.left), _rtf_est_rows(p.right)
        reverse = est_l < est_r and \
            any(t.side == "build" for t in p.runtime_filters)
        if reverse:
            left = self.run(p.left)
            rtf, build_plan = self._rtf_prepare(p, left, conf, True,
                                                est_l, est_r)
            right = self.run(build_plan)
        else:
            right = self.run(p.right)
            rtf, probe_plan = self._rtf_prepare(p, right, conf, False,
                                                est_r, est_l)
            left = self.run(probe_plan)
        return left, right, rtf

    def _rtf_conf(self) -> _RtfConf:
        """The session's spark.sail.join.runtimeFilter.* over the app
        config's join.runtime_filter.* (a value that does not parse falls
        back to the default)."""
        def setting(spark_key: str, app_key: str, cast=str):
            key = "join.runtime_filter." + app_key
            v = self.config.get("spark.sail.join.runtimeFilter." + spark_key)
            try:
                return cast(config_get(key) if v is None else v)
            except (TypeError, ValueError):
                return cast(config_defaults[key])

        return _RtfConf(
            enabled=truthy_value(setting("enabled", "enabled")),
            min_build_rows=setting("minBuildRows", "min_build_rows", int),
            max_bits=max(1024, setting("maxBits", "max_bits", int)),
            in_list_max=setting("inListMax", "in_list_max", int),
            ndv_ratio=setting("ndvRatio", "ndv_ratio", float),
            min_selectivity=setting("minSelectivity", "min_selectivity",
                                    float))

    @staticmethod
    def _rtf_history_key(p: pn.JoinExec, reverse: bool):
        # the verdict must be specific to THIS query's join, not just its
        # key/schema shape: the same `fact JOIN dim` with a different
        # WHERE on dim has a completely different selectivity, so the
        # fingerprint folds in every filter condition and scan identity
        # reachable in both subtrees
        def fingerprint(node: pn.PlanNode):
            out = []
            for n in pn.walk_plan(node):
                if isinstance(n, pn.FilterExec):
                    out.append(n.condition)
                elif isinstance(n, pn.ScanExec):
                    out.append((n.table_name, n.paths,
                                id(n.source) if n.source is not None
                                else None))
            return tuple(out)

        key = ("rtf_hist", reverse, p.left_keys, p.right_keys,
               tuple((f.name, f.dtype) for f in p.left.schema),
               tuple((f.name, f.dtype) for f in p.right.schema),
               fingerprint(p.left), fingerprint(p.right))
        try:
            hash(key)
            return key
        except TypeError:
            return None

    def _rtf_prepare(self, p: pn.JoinExec, src: HostBatch, conf: _RtfConf,
                     reverse: bool, est_src: float, est_tgt: float):
        """Build the runtime filter from the materialized SOURCE side
        (build side forward, probe side reverse) and push value conjuncts
        into the other subtree's annotated scans. Returns
        (rtf-or-None, rewritten target subtree)."""
        src_node = p.left if reverse else p.right
        src_keys = p.left_keys if reverse else p.right_keys
        target_plan = p.right if reverse else p.left
        wanted_side = "build" if reverse else "probe"
        targets = tuple(t for t in p.runtime_filters if t.side == wanted_side)

        hkey = self._rtf_history_key(p, reverse)
        if hkey is not None:
            past = self.rtf_history.get(hkey)
            if past is not None and past < conf.min_selectivity:
                return None, target_plan  # observed useless: skip
        # a filter only pays when its source side is smaller than the
        # side it prunes
        if est_src >= est_tgt:
            return None, target_plan
        comp = self._compiler(src.dicts, src_node.schema)
        compiled = [comp.compile(k) for k in src_keys]
        # eligible key ordinals: device-hashable physical types whose key
        # bits agree across sides WITHOUT dictionary unification (string
        # keys use per-side code spaces, so they cannot ride the filter).
        # The filter keys carry the LEFT key's type, the join's own
        # convention (_join_key_columns), so both sides' key bits agree.
        ordinals = tuple(
            i for i, (c, lk) in enumerate(zip(compiled, p.left_keys))
            if c.dictionary is None
            and getattr(rx.rex_type(lk), "physical_dtype", None)
            in hashk._KEY_BITS)
        if not ordinals:
            return None, target_plan
        scols, ssel = self._cols(src), src.device.sel
        n = ssel.shape[0]
        kcols = []
        usable = ssel
        for i in ordinals:
            d, v = compiled[i].fn(scols)
            v = None if v is None else _full(v, n)
            kcols.append(Column(_full(d, n), v, rx.rex_type(p.left_keys[i])))
            if v is not None:
                usable = usable & v
        res = rtfk.build(kcols, ssel, conf.max_bits)
        # scan conjuncts need integer bounds (and, for a small source, its
        # key values): one transfer with the filter's own counts
        int_ords = [oi for oi, c in enumerate(kcols)
                    if not c.data.is_floating_point()
                    and c.data.dtype != torch.bool]
        parts = [res.n_build.reshape(1), res.ndv.reshape(1)]
        for oi in int_ords:
            parts.extend(b.to(torch.int64).reshape(1) for b in
                         rtfk.column_bounds(kcols[oi].data, usable))
        fetch_values = n <= (1 << 17)
        if fetch_values:
            parts.append(usable.to(torch.int64))
            parts.extend(kcols[oi].data.to(torch.int64) for oi in int_ords)
        fetched = torch.cat(parts).cpu().numpy()
        n_build, ndv = int(fetched[0]), int(fetched[1])
        if n_build < conf.min_build_rows:
            return None, target_plan
        # a filter cannot prune much when the source's distinct keys
        # rival the filtered side's row count (the PK→PK shape)
        if n_build > 0 and ndv >= conf.ndv_ratio * est_tgt:
            return None, target_plan
        nb = 2 + 2 * len(int_ords)
        bounds_by_ord = {ordinals[oi]: (1, 0) if n_build == 0 else
                         (int(fetched[2 + 2 * j]), int(fetched[3 + 2 * j]))
                         for j, oi in enumerate(int_ords)}
        values_by_ord: Dict[int, np.ndarray] = {}
        if fetch_values:
            u = fetched[nb: nb + n].astype(bool)
            for j, oi in enumerate(int_ords):
                vals = np.unique(fetched[nb + n * (j + 1): nb + n * (j + 2)][u])
                if vals.size <= conf.in_list_max:
                    values_by_ord[ordinals[oi]] = vals
        pushed = 0
        for t in targets:
            if t.key not in bounds_by_ord:
                continue
            scan = rtfp.find_scan_by_fid(target_plan, t.fid)
            if scan is None or scan.source is None:
                continue
            field = scan.schema[t.column]
            if not rtfp.supports_bounds(field.dtype):
                continue
            lo, hi = bounds_by_ord[t.key]
            try:
                conjs = rtfp.bounds_conjuncts(t.column, field, lo, hi,
                                              values_by_ord.get(t.key))
            except (OverflowError, ValueError):
                continue  # out-of-range literal (exotic date values)
            new_scan = dataclasses.replace(
                scan, runtime_predicates=scan.runtime_predicates + conjs)
            target_plan = _replace_node(target_plan, scan, new_scan)
            pushed += 1
        rtf = _Rtf(res=res, ordinals=ordinals,
                   fids=tuple(t.fid for t in targets), history_key=hkey,
                   pushed=pushed, reverse=reverse)
        return rtf, target_plan

    def _rtf_finish(self, rtf: _Rtf, before: int, after: int,
                    scan_stats: Dict[int, Tuple[int, int]]) -> None:
        """Post-join accounting: the adaptive history and the log. Only
        SCAN-site pruning counts towards the verdict, as in the reference:
        a filter whose conjuncts never landed at a scan stops rebuilding.
        ``scan_stats``: fid → (rows before, rows after) at its scan."""
        ratio = 0.0
        measured = False
        for fid in rtf.fids:
            st = scan_stats.get(fid)
            if st is not None and st[0] > 0:
                measured = True
                ratio = max(ratio, (st[0] - st[1]) / st[0])
        if rtf.history_key is not None and (measured or rtf.pushed == 0):
            while len(self.rtf_history) > 256:
                self.rtf_history.pop(next(iter(self.rtf_history)))
            self.rtf_history[rtf.history_key] = ratio
        self.runtime_filters.append(dict(
            reverse=rtf.reverse, pushed=rtf.pushed,
            scan_rows=[list(scan_stats[f]) for f in rtf.fids
                       if f in scan_stats],
            mask_rows=[before, after]))

    # -- equi-join ----------------------------------------------------------
    def _join_key_columns(self, p: pn.JoinExec, left: HostBatch,
                          right: HostBatch):
        """Both sides' key columns. String keys compare through one
        unified dictionary (per-side code lookup tables); every key pair
        carries the LEFT key's type, so the two sides' key bits agree."""
        lcomp = self._compiler(left.dicts, p.left.schema)
        rcomp = self._compiler(right.dicts, p.right.schema)
        lcols, rcols = self._cols(left), self._cols(right)
        nl, nr = left.capacity, right.capacity
        lkeys, rkeys = [], []
        for lk, rk in zip(p.left_keys, p.right_keys):
            lc, rc = lcomp.compile(lk), rcomp.compile(rk)
            ktype = rx.rex_type(lk)
            (ld, lv), (rd, rv) = lc.fn(lcols), rc.fn(rcols)
            if lc.dictionary is not None or rc.dictionary is not None:
                _, ra, rb = ai.unify_dictionaries(lc.dictionary,
                                                  rc.dictionary)
                ld = torch.from_numpy(ra).to(self.device)[ld.long()]
                rd = torch.from_numpy(rb).to(self.device)[rd.long()]
                ktype = dt.IntegerType()
            lkeys.append(Column(_full(ld, nl),
                                None if lv is None else _full(lv, nl), ktype))
            rkeys.append(Column(_full(rd, nr),
                                None if rv is None else _full(rv, nr), ktype))
        return lkeys, rkeys

    def _join(self, p: pn.JoinExec, left: HostBatch, right: HostBatch,
              rtf: Optional[_Rtf] = None) -> HostBatch:
        jt = p.join_type
        lkeys, rkeys = self._join_key_columns(p, left, right)
        lsel, rsel = left.device.sel, right.device.sel
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        rtf_before = rtf_after = zero
        fids = []
        if rtf is not None:
            # mask the filtered side's selection with the source side's
            # bloom before the build/probe. Forward masks the probe;
            # reverse masks the build (a masked build row's key has no
            # probe partner, so it could never match).
            if rtf.reverse:
                masked = rtfk.apply(rtf.res, [rkeys[i] for i in rtf.ordinals],
                                    rsel)
                rtf_before, rtf_after, rsel = rsel.sum(), masked.sum(), masked
            else:
                masked = rtfk.apply(rtf.res, [lkeys[i] for i in rtf.ordinals],
                                    lsel)
                rtf_before, rtf_after, lsel = lsel.sum(), masked.sum(), masked
            fids = [f for f in rtf.fids if f in self._rtf_scan_stats]
        for seed in range(4):
            bt = joink.build_side(rkeys, rsel, seed)
            ambiguous = zero if bt.exact else \
                joink.hash_ambiguous(bt, rkeys).to(torch.int64)
            ranges = joink.probe_ranges(
                bt, lkeys, lsel, build_key_cols=None if bt.exact else rkeys)
            # one transfer for every host decision value: each separate
            # read would be a round trip to the device
            fetched = torch.stack(
                [joink.has_duplicate_build_keys(bt).to(torch.int64),
                 ambiguous, joink.join_output_count(ranges, lsel, "inner"),
                 rtf_before, rtf_after] +
                [self._rtf_scan_stats[f][1] for f in fids]).cpu().tolist()
            has_dup, ambiguous, inner_total = fetched[:3]
            if bt.exact or not ambiguous:
                break
        else:
            raise RuntimeError("could not build an unambiguous hash join "
                               "in 4 seeds")
        if rtf is not None:
            self._rtf_finish(rtf, fetched[3], fetched[4], {
                f: (self._rtf_scan_stats[f][0], after)
                for f, after in zip(fids, fetched[5:])})
        merged_dicts = dict(left.dicts)
        n_left = len(p.left.schema)
        # right columns renamed to their combined positions
        r_dev_cols = {}
        for i in range(len(p.right.schema)):
            r_dev_cols[_col_name(n_left + i)] = \
                right.device.columns[_col_name(i)]
            if _col_name(i) in right.dicts:
                merged_dicts[_col_name(n_left + i)] = right.dicts[_col_name(i)]
        build_payload = DeviceBatch(r_dev_cols, right.device.sel)
        build_names = list(r_dev_cols) if jt not in ("semi", "anti") else []
        # full outer always takes the expanding path (it appends unmatched
        # build rows, which the unique fast path cannot express)
        if not has_dup and p.residual is None and jt != "full":
            out_dev = joink.join_unique(bt, ranges, left.device,
                                        build_payload, jt, build_names)
            return HostBatch(out_dev, merged_dicts
                             if jt not in ("semi", "anti") else left.dicts)
        return self._join_expand(p, left, bt, ranges, build_payload,
                                 merged_dicts, inner_total)

    def _join_expand(self, p: pn.JoinExec, left: HostBatch, bt, ranges,
                     build_payload: DeviceBatch, merged_dicts,
                     total: int) -> HostBatch:
        jt = p.join_type
        n_left = len(p.left.schema)
        res = joink.join_expand(bt, ranges, left.device, build_payload,
                                "inner", list(build_payload.columns), total)
        exp_batch, pi = res.batch, res.probe_index
        ok = exp_batch.sel
        if p.residual is not None:
            ok = ok & self._eval_mask(p.residual,
                                      HostBatch(exp_batch, merged_dicts),
                                      _combined(p))
        if jt == "inner":
            return HostBatch(exp_batch.with_sel(ok), merged_dicts)
        probe_cap = left.capacity
        # probe rows with >= 1 surviving match
        matched_probe = torch.zeros(probe_cap, dtype=torch.int32,
                                    device=self.device).index_add_(
            0, pi, ok.to(torch.int32)) > 0
        if jt == "semi":
            return HostBatch(left.device.with_sel(left.device.sel
                                                  & matched_probe),
                             left.dicts)
        if jt == "anti":
            return HostBatch(left.device.with_sel(left.device.sel
                                                  & ~matched_probe),
                             left.dicts)
        if jt not in ("left", "full"):
            raise NotImplementedError(f"join type {jt!r}")
        # surviving inner rows + unmatched probe rows with null build cols
        unmatched = left.device.sel & ~matched_probe
        cols = {}
        for i in range(n_left):
            key = _col_name(i)
            ec, lc = exp_batch.columns[key], left.device.columns[key]
            cols[key] = Column(torch.cat([ec.data, lc.data]),
                               _cat_validity([ec, lc]), ec.dtype)
        for key in build_payload.columns:
            ec = exp_batch.columns[key]
            cols[key] = Column(
                torch.cat([ec.data, torch.zeros(probe_cap,
                                                dtype=ec.data.dtype,
                                                device=self.device)]),
                torch.cat([_validity(ec), torch.zeros(
                    probe_cap, dtype=torch.bool, device=self.device)]),
                ec.dtype)
        out = DeviceBatch(cols, torch.cat([ok, unmatched]))
        if jt == "full":
            out = self._append_unmatched_build(out, p, bt, ranges, left,
                                               build_payload, ok,
                                               res.build_index)
        return HostBatch(out, merged_dicts)

    def _append_unmatched_build(self, out: DeviceBatch, p: pn.JoinExec, bt,
                                ranges, left: HostBatch,
                                build_payload: DeviceBatch, ok, bix
                                ) -> DeviceBatch:
        bcap = build_payload.sel.shape[0]
        if p.residual is not None:
            # A build row counts as matched only if at least one of its
            # expanded rows survived the residual filter
            matched_build = torch.zeros(bcap, dtype=torch.int32,
                                        device=self.device).index_add_(
                0, bix, ok.to(torch.int32)) > 0
        else:
            matched_build = joink.build_matched_mask(bt, ranges,
                                                     left.device.sel)
        unmatched = build_payload.sel & ~matched_build
        cols = {}
        for i in range(len(p.left.schema)):
            c = out.columns[_col_name(i)]
            cols[_col_name(i)] = Column(
                torch.cat([c.data, torch.zeros(bcap, dtype=c.data.dtype,
                                               device=self.device)]),
                torch.cat([_validity(c), torch.zeros(
                    bcap, dtype=torch.bool, device=self.device)]), c.dtype)
        for key, c in build_payload.columns.items():
            oc = out.columns[key]
            cols[key] = Column(torch.cat([oc.data, c.data]),
                               _cat_validity([oc, c]), c.dtype)
        return DeviceBatch(cols, torch.cat([out.sel, unmatched]))

    def _cross_join(self, p: pn.JoinExec, left: HostBatch,
                    right: HostBatch) -> HostBatch:
        lc, rc = sortk.compact(left.device), sortk.compact(right.device)
        n_right = rc.capacity
        total = lc.capacity * n_right
        idx = torch.arange(total, device=self.device)
        li, ri = idx // max(n_right, 1), idx % max(n_right, 1)
        cols = {}
        n_left = len(p.left.schema)
        for i in range(n_left):
            cols[_col_name(i)] = sortk.take_column(lc.columns[_col_name(i)],
                                                   li)
        dicts = dict(left.dicts)
        for i in range(len(p.right.schema)):
            cols[_col_name(n_left + i)] = sortk.take_column(
                rc.columns[_col_name(i)], ri)
            if _col_name(i) in right.dicts:
                dicts[_col_name(n_left + i)] = right.dicts[_col_name(i)]
        return HostBatch(DeviceBatch(cols, torch.ones(
            total, dtype=torch.bool, device=self.device)), dicts)


def _direct_domains(agg: pn.AggregateExec, dicts) -> Optional[List[int]]:
    """Each group key's domain where the aggregate bins its rows directly
    (every key a dictionary code or a boolean, at most 4096 bins with a
    NULL slot each), else None: the grouping sorts (or it is keyless)."""
    if not agg.group_indices:
        return None
    schema = agg.input.schema
    domains = []
    total = 1
    for gi in agg.group_indices:
        name = _col_name(gi)
        if name in dicts:
            domains.append(len(dicts[name]))
        elif isinstance(schema[gi].dtype, dt.BooleanType):
            domains.append(2)
        else:
            return None
        total *= domains[-1] + 1
    return domains if total <= 4096 else None


def _group_sort_sinks(agg: pn.AggregateExec, filters, frags, dicts):
    """K18's (outputs, sort keys, nulls_first) for a sorted grouping over a
    chain whose top has ``frags``: the group keys' columns and the
    aggregates' arguments stored or passed through (no other column: the
    grouping reads none), each group key's word in ascending order, NULLs
    first and canonical. None where the grouping does not sort (keyless,
    direct) or no chain computes below it (K3 over its columns)."""
    if not agg.group_indices or _direct_domains(agg, dicts) is not None:
        return None
    if not filters and all(f is not None and f.op == "col" for f in frags):
        return None
    keys = [frags[gi] for gi in agg.group_indices]
    if any(f is None or f.dtype not in chainop.TYPE_CODE for f in keys):
        return None
    needed = set(agg.group_indices) | {a.arg for a in agg.aggs
                                       if a.arg is not None}
    outputs = [f if i in needed else None for i, f in enumerate(frags)]
    return outputs, [chainop.SortKey(f, canonical=True) for f in keys], \
        [True] * len(keys)


def _agg_sinks(agg: pn.AggregateExec, frags, dicts, schema):
    """K17's direct keys (fragment, domain) and aggregates for ``agg`` over
    a chain whose top has ``frags``; None where the aggregate is not
    K17's: a grouping that is not keyless or direct (every key a
    dictionary code or a boolean, at most 4096 bins), or an aggregate that
    is not a COUNT, SUM, MIN or MAX of a non-string value without DISTINCT
    or FILTER."""
    if not stages.agg_absorbs_chain(agg):
        return None
    for a in agg.aggs:
        if a.fn not in ("count", "sum", "min", "max") or \
                a.filter is not None:
            return None
        if a.arg is not None and (
                _col_name(a.arg) in dicts or frags[a.arg] is None or
                isinstance(schema[a.arg].dtype, (dt.StringType,
                                                 dt.BinaryType))):
            return None
    keys = []
    total = 1
    for gi in agg.group_indices:
        f = frags[gi]
        if f is None:
            return None
        if _col_name(gi) in dicts and f.dtype == torch.int32:
            dom = len(dicts[_col_name(gi)])
        elif isinstance(schema[gi].dtype, dt.BooleanType) and \
                f.dtype == torch.bool:
            dom = 2
        else:
            return None
        if dom == 0:
            return None
        total *= dom + 1
        keys.append((f, dom))
    if total > 4096:
        return None
    sinks = []
    for a in agg.aggs:
        if a.arg is None:
            sinks.append(chainop.AggSink("count", None))
            continue
        f = frags[a.arg]
        if a.fn == "sum":
            f = chainop.conv(f, physical_torch_dtype(a.out_dtype))
        sinks.append(chainop.AggSink(a.fn, f))
    return keys, sinks


def _describe(r: rx.Rex) -> str:
    """A short name of an expression, for the route report."""
    if isinstance(r, rx.RCall):
        return f"{r.fn}({', '.join(type(a.dtype).__name__ for a in r.args)})"
    if isinstance(r, rx.RCast):
        return f"cast({type(rx.rex_type(r.child)).__name__} as " \
               f"{type(r.dtype).__name__})"
    if isinstance(r, rx.BoundRef):
        return f"column {r.name} ({type(r.dtype).__name__})"
    return type(r).__name__


def _range_peer(ctx, s: pn.WindowSpec):
    """The peer ends a RANGE frame that ends at the current row reads
    (None for ROWS frames and unbounded RANGE frames)."""
    if s.frame_type != "range":
        return None
    if s.frame_lower is None and s.frame_upper == 0:
        return ctx.peer_end
    if s.frame_lower is None and s.frame_upper is None:
        return None
    raise NotImplementedError(
        "RANGE frames with value offsets are not supported yet")


def _positional(hb: HostBatch) -> HostBatch:
    """Rename columns to positional keys c0..cn."""
    dev = hb.device
    cols = {}
    dicts = {}
    for i, (name, col) in enumerate(dev.columns.items()):
        cols[_col_name(i)] = col
        if name in hb.dicts:
            dicts[_col_name(i)] = hb.dicts[name]
    return HostBatch(DeviceBatch(cols, dev.sel), dicts)



def _combined(p: pn.JoinExec) -> pn.Schema:
    """The schema a join's residual binds to: left ++ right."""
    return tuple(p.left.schema) + tuple(p.right.schema)


def _validity(c: Column) -> torch.Tensor:
    return c.validity if c.validity is not None else \
        torch.ones(c.data.shape[0], dtype=torch.bool, device=c.data.device)


def _cat_validity(cols: List[Column]) -> Optional[torch.Tensor]:
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([_validity(c) for c in cols])


def _rtf_est_rows(p: pn.PlanNode) -> float:
    """Runtime-filter direction estimate: join_reorder's cardinality
    model, except cross joins count as the cartesian PRODUCT (the
    ordering model's max would make a large cross product look like its
    smaller side, steering the filter the wrong way)."""
    obs = jr.observed_rows(p)
    if obs is not None:
        return obs
    if isinstance(p, pn.JoinExec):
        lr, rr = _rtf_est_rows(p.left), _rtf_est_rows(p.right)
        if p.join_type in ("semi", "anti"):
            return lr * 0.5
        if p.join_type == "cross" or not p.left_keys:
            return lr * rr
        return max(lr, rr)
    if isinstance(p, pn.FilterExec):
        return _rtf_est_rows(p.input) * jr._conjunct_selectivity(p.condition)
    if isinstance(p, pn.AggregateExec):
        return max(_rtf_est_rows(p.input) * 0.1, 1.0)
    if isinstance(p, pn.UnionExec):
        return sum(_rtf_est_rows(c) for c in p.inputs)
    if isinstance(p, pn.ScanExec):
        return jr._scan_rows(p)
    child = getattr(p, "input", None)
    if isinstance(child, pn.PlanNode):
        return _rtf_est_rows(child)
    return jr._DEFAULT_ROWS


def _replace_node(plan: pn.PlanNode, target: pn.PlanNode,
                  replacement: pn.PlanNode) -> pn.PlanNode:
    if plan is target:
        return replacement
    if isinstance(plan, pn.JoinExec):
        return dataclasses.replace(
            plan, left=_replace_node(plan.left, target, replacement),
            right=_replace_node(plan.right, target, replacement))
    if isinstance(plan, pn.UnionExec):
        return dataclasses.replace(plan, inputs=tuple(
            _replace_node(c, target, replacement) for c in plan.inputs))
    if getattr(plan, "input", None) is not None:
        return dataclasses.replace(
            plan, input=_replace_node(plan.input, target, replacement))
    return plan


def _flip_residual(r: Optional[rx.Rex], n_left: int, n_right: int
                   ) -> Optional[rx.Rex]:
    if r is None:
        return None

    def flip(x: rx.Rex) -> rx.Rex:
        if isinstance(x, rx.BoundRef):
            if x.index < n_left:
                return dataclasses.replace(x, index=x.index + n_right)
            return dataclasses.replace(x, index=x.index - n_left)
        if isinstance(x, rx.RCall):
            return dataclasses.replace(x, args=tuple(flip(a) for a in x.args))
        if isinstance(x, rx.RCast):
            return dataclasses.replace(x, child=flip(x.child))
        if isinstance(x, rx.RCase):
            return dataclasses.replace(
                x, branches=tuple((flip(c), flip(v)) for c, v in x.branches),
                else_value=None if x.else_value is None else flip(x.else_value))
        return x

    return flip(r)


def _reorder_right(hb: HostBatch, n_right: int, n_left: int) -> HostBatch:
    """After executing a flipped right join (as left join with sides
    swapped), restore the original column order: right-output cols
    [0..n_right) move after the left cols."""
    dev = hb.device
    cols = {}
    dicts = {}
    for i in range(n_left):
        src = _col_name(n_right + i)
        cols[_col_name(i)] = dev.columns[src]
        if src in hb.dicts:
            dicts[_col_name(i)] = hb.dicts[src]
    for i in range(n_right):
        src = _col_name(i)
        cols[_col_name(n_left + i)] = dev.columns[src]
        if src in hb.dicts:
            dicts[_col_name(n_left + i)] = hb.dicts[src]
    return HostBatch(DeviceBatch(cols, dev.sel), dicts)


def _node_rex(p: pn.PlanNode):
    """The expressions of one plan node (where scalar subqueries sit)."""
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
