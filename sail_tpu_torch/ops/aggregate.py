"""Grouped aggregation over tensors: group ids + segmented reductions.

The PyTorch counterpart of ``sail_tpu/ops/aggregate.py``. Rows get a
segment id per group — by sorting the keys (``group_rows``) or, for keys
with small known domains, directly from their codes (``group_rows_direct``,
kernel K2 on the card) — and every aggregate is a segmented reduction
over those ids, kernel K1 on the card. Sorted groups reduce each group's
run of the sort order, reading values through the permutation
(``seg_reduce_runs``); binned ids reduce in row order (``seg_reduce``).

NULL semantics follow Spark: null group keys form their own group; null
values are skipped by aggregates; COUNT(*) counts rows, COUNT(x) counts
non-null x; SUM over an all-null group is NULL; MIN/MAX ignore nulls.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import csrc
from ..columnar.batch import Column, physical_torch_dtype
from ..spec import data_type as dt
from .sort import order_keys

# ---------------------------------------------------------------------------
# K1: segmented reduction
# ---------------------------------------------------------------------------

_KINDS = {"sum": 0, "min": 1, "max": 2}
# the types K1 reduces in (narrower inputs widen exactly and narrow back)
_K1_TYPE = {torch.int32: (0, ctypes.c_int), torch.int64: (1, ctypes.c_longlong),
            torch.float64: (2, ctypes.c_double)}
_K1_WIDEN = {torch.bool: torch.int32, torch.int8: torch.int32,
             torch.int16: torch.int32, torch.float32: torch.float64}
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _identity(dtype: torch.dtype, kind: str):
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def seg_reduce_plain(vals: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, kind: str,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[s] = sum/min/max of vals[i] over seg_ids[i] == s where valid[i];
    ids outside [0, num_segments) are dropped and an empty segment holds
    the identity, as ``jax.ops.segment_*`` give. Rows are sorted by id and
    combined by a segmented Hillis-Steele scan (log2(n) elementwise
    passes); integer sums wrap, min/max propagate NaN."""
    out = torch.full((num_segments,), _identity(vals.dtype, kind),
                     dtype=vals.dtype, device=vals.device)
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    if valid is not None:
        keep = keep & valid
    seg, order = torch.sort(seg_ids[keep].to(torch.int64), stable=True)
    v = vals[keep][order]
    n = v.shape[0]
    if n == 0:
        return out
    op = _COMBINE[kind]
    d = 1
    while d < n:
        same = seg[d:] == seg[:-d]
        v = torch.cat([v[:d], torch.where(same, op(v[:-d], v[d:]), v[d:])])
        d *= 2
    last = torch.ones(n, dtype=torch.bool, device=v.device)
    last[:-1] = seg[1:] != seg[:-1]
    out[seg[last]] = v[last]
    return out


def _k1_work(vals: torch.Tensor, name: str) -> torch.Tensor:
    """The values in a type K1 reduces in (narrower types widen exactly)."""
    work = vals.to(_K1_WIDEN.get(vals.dtype, vals.dtype)).contiguous()
    if work.dtype not in _K1_TYPE:
        raise TypeError(f"{name}: unsupported value type {vals.dtype}")
    return work


def _same_rows(name: str, n: int, device: torch.device, **tensors) -> None:
    for label, t in tensors.items():
        if t is not None and (t.dim() != 1 or t.shape[0] != n or
                              t.device != device):
            raise TypeError(f"{name}: {label} must be 1-D with {n} rows on "
                            f"{device}, got {tuple(t.shape)} on {t.device}")


def seg_reduce(vals: torch.Tensor, seg_ids: torch.Tensor,
               num_segments: int, kind: str,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1's binned entry point: ``seg_reduce_plain`` as a kernel on the
    card, for ids in row order (direct and keyless grouping), into at most
    ``BINNED_MAX`` segments.

    Replaces ``sail_tpu/ops/aggregate.py`` ``_seg_reduce``; the kernel's
    source (csrc/seg_reduce.cu) states its bound and design. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    float64 sums come out in an order that varies between runs."""
    if vals.device.type == "cpu":
        return seg_reduce_plain(vals, seg_ids, num_segments, kind, valid)
    if num_segments > BINNED_MAX:
        raise ValueError(f"seg_reduce: {num_segments} segments; the binned "
                         f"kernel takes at most {BINNED_MAX} (sort-based "
                         f"grouping reduces through seg_reduce_runs)")
    if seg_ids.dtype != torch.int32 or (valid is not None and
                                        valid.dtype != torch.bool):
        raise TypeError(f"seg_reduce: needs int32 ids and a bool validity, "
                        f"got {seg_ids.dtype} and "
                        f"{None if valid is None else valid.dtype}")
    n = vals.shape[0]
    _same_rows("seg_reduce", n, vals.device, vals=vals, ids=seg_ids,
               valid=valid)
    work = _k1_work(vals, "seg_reduce")
    code, ctype = _K1_TYPE[work.dtype]
    identity = ctype(_identity(work.dtype, kind))
    out = torch.full((num_segments,), identity.value, dtype=work.dtype,
                     device=work.device)
    if n and num_segments:
        seg_ids = seg_ids.contiguous()
        valid = None if valid is None else valid.contiguous()
        with torch.cuda.device(work.device):
            csrc.check(csrc.entry("seg_reduce.cu", "sail_seg_reduce")(
                work.data_ptr(), seg_ids.data_ptr(),
                None if valid is None else valid.data_ptr(), n, num_segments,
                code, _KINDS[kind], ctypes.addressof(identity),
                out.data_ptr(), csrc.grid_for(n, work.device),
                csrc.stream_ptr(work.device)), "seg_reduce")
        seg_reduce.launches += 1
    return out.to(vals.dtype)


seg_reduce.launches = 0
# the most segments the binned kernel holds in shared memory (kBinnedMax in
# seg_reduce.cu); direct grouping makes at most 4096 bins
BINNED_MAX = 4097


def seg_reduce_runs_plain(ids: torch.Tensor, perm: torch.Tensor,
                          n_live: torch.Tensor, num_segments: int,
                          kind: Optional[str], vals: Optional[torch.Tensor]
                          = None, valid: Optional[torch.Tensor] = None,
                          counts: bool = False
                          ) -> Tuple[Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """(out, count) over the live prefix of a sort-based grouping: for
    i < n_live, out[ids[i]] = kind over value(perm[i]) and count[ids[i]]
    the rows that contributed, where value(p) is vals[p] (p itself when
    vals is None) and rows with valid[p] false are skipped. out is None
    when kind is None, count unless ``counts``. The live rows' values are
    gathered in sorted order, then reduced by ``seg_reduce_plain``."""
    n = int(n_live)
    p = perm[:n]
    seg = ids[:n]
    if valid is not None:
        seg = torch.where(valid[p], seg, num_segments)
    out = cnt = None
    if kind is not None:
        out = seg_reduce_plain(p if vals is None else vals[p], seg,
                               num_segments, kind)
    if counts:
        cnt = seg_reduce_plain(torch.ones(n, dtype=torch.int64,
                                          device=ids.device),
                               seg, num_segments, "sum")
    return out, cnt


def seg_reduce_runs(ids: torch.Tensor, perm: torch.Tensor,
                    n_live: torch.Tensor, num_segments: int,
                    kind: Optional[str], vals: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None, counts: bool = False
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K1's runs entry point: ``seg_reduce_runs_plain`` as a kernel on the
    card, for sort-based grouping (ids sorted, values read through perm).

    Replaces ``sail_tpu/ops/aggregate.py`` ``_seg_reduce`` as the sorted
    aggregates use it; the kernel's source (csrc/seg_reduce.cu) states its
    bound and design. n_live stays on the card (no host sync); dead rows
    are never read. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (two launches: the grid, then one block over its
    records) or raises. float64 sums come out the same in every run."""
    if ids.device.type == "cpu":
        return seg_reduce_runs_plain(ids, perm, n_live, num_segments, kind,
                                     vals, valid, counts)
    if ids.dtype != torch.int32 or perm.dtype != torch.int64 or \
            n_live.dtype != torch.int64 or n_live.numel() != 1 or \
            (valid is not None and valid.dtype != torch.bool):
        raise TypeError(
            f"seg_reduce_runs: needs int32 ids, an int64 perm and n_live "
            f"and a bool validity, got {ids.dtype}, {perm.dtype}, "
            f"{n_live.dtype}{tuple(n_live.shape)} and "
            f"{None if valid is None else valid.dtype}")
    n, dev = ids.shape[0], ids.device
    _same_rows("seg_reduce_runs", n, dev, perm=perm, vals=vals, valid=valid)
    if n_live.device != dev:
        raise TypeError("seg_reduce_runs: n_live must be on the ids' device")
    out_dtype = torch.int64 if vals is None else vals.dtype
    if vals is not None:
        vals = _k1_work(vals, "seg_reduce_runs")
    work = torch.int64 if vals is None else vals.dtype
    code, ctype = _K1_TYPE[work]
    identity = ctype(_identity(work, kind or "sum"))
    out = None if kind is None else \
        torch.empty(num_segments, dtype=work, device=dev)
    cnt = torch.empty(num_segments, dtype=torch.int64, device=dev) \
        if counts else None
    if n == 0:
        if out is not None:
            out.fill_(identity.value)
        if cnt is not None:
            cnt.zero_()
    elif (out is not None or cnt is not None) and num_segments:
        ids, perm = _aligned(ids), _aligned(perm)
        n_live = n_live.reshape(1).contiguous()
        valid = None if valid is None else valid.contiguous()
        grid = csrc.grid_for(n, dev, blocks_per_sm=4, block=_RUNS_TILE)
        scratch = torch.empty(2 * grid * 20, dtype=torch.uint8, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("seg_reduce.cu", "sail_seg_reduce_runs")(
                ids.data_ptr(), perm.data_ptr(), n_live.data_ptr(),
                ptr(vals), ptr(valid), num_segments, code,
                _KINDS[kind or "sum"], ctypes.addressof(identity), ptr(out),
                ptr(cnt), scratch.data_ptr(), grid, csrc.stream_ptr(dev)),
                "seg_reduce_runs")
        seg_reduce_runs.launches += 1
    return None if out is None else out.to(out_dtype), cnt


seg_reduce_runs.launches = 0
# rows a block of the runs kernel takes at a time (kTile in seg_reduce.cu)
_RUNS_TILE = 1024


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned for the kernel's vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# K2: direct group ids
# ---------------------------------------------------------------------------

def direct_group_ids_plain(codes: Sequence[torch.Tensor],
                           validities: Sequence[Optional[torch.Tensor]],
                           domains: Sequence[int], sel: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gid int32[n], counts int64[g_total]): gid is the mixed-radix
    number of the key codes over domain + 1 slots each (codes clipped to
    [0, domain - 1], NULL in the extra slot), g_total for rows outside
    ``sel``; counts[g] is the number of live rows in group g."""
    gid = torch.zeros(sel.shape[0], dtype=torch.int32, device=sel.device)
    g_total = 1
    for code, validity, dom in zip(codes, validities, domains):
        code = torch.clamp(code.to(torch.int32), 0, dom - 1)
        if validity is not None:
            code = torch.where(validity, code, dom)
        gid = gid * (dom + 1) + code
        g_total *= dom + 1
    seg = torch.where(sel, gid, g_total).to(torch.int32)
    counts = seg_reduce_plain(sel.to(torch.int64), seg, g_total, "sum")
    return seg, counts


def direct_group_ids(codes: Sequence[torch.Tensor],
                     validities: Sequence[Optional[torch.Tensor]],
                     domains: Sequence[int], sel: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``direct_group_ids_plain`` as one kernel pass on the card.

    Replaces ``sail_tpu/ops/aggregate.py`` ``group_rows_direct``'s id and
    count computation; the kernel's source (csrc/direct_group.cu) states
    its bound and design. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if sel.device.type == "cpu":
        return direct_group_ids_plain(codes, validities, domains, sel)
    g_total = 1
    for dom in domains:
        g_total *= dom + 1
    nkeys = len(codes)
    if not 1 <= nkeys <= 8 or g_total > 4096:
        raise ValueError(f"direct_group_ids: {nkeys} keys over {g_total} "
                         f"groups (the kernel takes 1-8 keys, <= 4096 groups)")
    n = sel.shape[0]
    keep = []  # tensors whose pointers the launch uses
    ptrs, vptrs, widths = [], [], []
    for code, validity in zip(codes, validities):
        if code.dtype == torch.bool:
            code, width = code.contiguous().view(torch.uint8), 1
        elif code.dtype == torch.int32:
            code, width = code.contiguous(), 4
        else:
            raise TypeError(f"direct_group_ids: codes must be int32 or bool, "
                            f"got {code.dtype}")
        if code.shape != (n,) or code.device != sel.device:
            raise TypeError("direct_group_ids: codes must match sel")
        keep.append(code)
        ptrs.append(code.data_ptr())
        widths.append(width)
        if validity is None:
            vptrs.append(None)
        else:
            validity = validity.contiguous()
            keep.append(validity)
            vptrs.append(validity.data_ptr())
    sel = sel.contiguous()
    gid = torch.empty(n, dtype=torch.int32, device=sel.device)
    counts = torch.zeros(g_total, dtype=torch.int64, device=sel.device)
    if n:
        arr_p = ctypes.c_void_p * nkeys
        arr_i = ctypes.c_int * nkeys
        with torch.cuda.device(sel.device):
            csrc.check(csrc.entry("direct_group.cu")(
                arr_p(*ptrs), arr_p(*vptrs), arr_i(*widths),
                arr_i(*domains), nkeys, sel.data_ptr(), n, g_total,
                gid.data_ptr(), counts.data_ptr(),
                csrc.grid_for(n, sel.device), csrc.stream_ptr(sel.device)),
                "direct_group_ids")
        direct_group_ids.launches += 1
    return gid, counts


direct_group_ids.launches = 0


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------

class GroupContext:
    """The rows' groups, shared by all aggregate columns of one aggregation.

    Three modes, each reduced by one of K1's two entry points:
    - sort-based (group_rows): ``perm`` orders the live rows by key, dead
      rows last; ``sorted_ids`` holds the dense group ids in that order
      (dead rows: max_groups) and ``n_live`` the live rows, a 0-d tensor
      on the rows' device. K1's runs entry point reduces through perm.
    - direct-binned (group_rows_direct): ``seg_ids`` is each row's packed
      dictionary code, in row order, no sort; bins may be sparse and
      ``group_mask`` marks the live ones.
    - keyless (group_rows without keys): ``seg_ids`` is 0 for every live
      row.
    Both binned modes give dead rows the id max_groups, which K1's binned
    entry point drops before loading the value.

    The rows each group counts depend only on a value's validity, so the
    context keeps the counts it has made, by validity (None: every live
    row; in direct mode K2's counts), and a SUM and a COUNT of one column
    (as AVG makes them) share one launch's counts.
    """

    def __init__(self, alive, num_groups, max_groups, seg_ids=None,
                 group_mask=None, counts=None, perm=None, sorted_ids=None,
                 n_live=None):
        self.alive = alive            # bool[n], row order
        self.num_groups = num_groups  # int or 0-d tensor
        self.max_groups = max_groups
        self.seg_ids = seg_ids        # int32[n] (binned modes)
        self.group_mask = group_mask  # bool[max_groups] (direct mode)
        self.perm = perm              # int64[n] (sort mode)
        self.sorted_ids = sorted_ids  # int32[n] (sort mode)
        self.n_live = n_live          # 0-d int64 (sort mode)
        # [(validity, int64[max_groups] counts)], matched by identity
        self._counts = [] if counts is None else [(None, counts)]

    def counts_for(self, valid: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """The counts already made for ``valid``, or None."""
        return next((c for v, c in self._counts if v is valid), None)

    def keep_counts(self, valid: Optional[torch.Tensor],
                    counts: torch.Tensor) -> torch.Tensor:
        self._counts.append((valid, counts))
        return counts


def _group_sort_perm(key_cols: Sequence[Column], sel) -> torch.Tensor:
    """Sort permutation grouping equal keys together, dead rows last."""
    n = sel.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=sel.device)
    for c in reversed(list(key_cols)):
        bits = order_keys(c.data)
        perm = perm[torch.sort(bits[perm], stable=True).indices]
        if c.validity is not None:
            perm = perm[torch.sort(c.validity[perm].to(torch.uint8),
                                   stable=True).indices]
    dead = (~sel).to(torch.uint8)
    return perm[torch.sort(dead[perm], stable=True).indices]


def _keys_equal_adjacent(sorted_keys: Sequence[Column]) -> torch.Tensor:
    """eq[i] = row i has the same group key as row i-1 (eq[0] = False)."""
    n = sorted_keys[0].data.shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=sorted_keys[0].data.device)
    for c in sorted_keys:
        prev = torch.roll(c.data, 1)
        same = c.data == prev
        if c.data.is_floating_point():
            # Spark groups all NaNs together (and -0.0 with 0.0; == covers it)
            same = same | (torch.isnan(c.data) & torch.isnan(prev))
        if c.validity is not None:
            prev_v = torch.roll(c.validity, 1)
            same = (same & c.validity & prev_v) | (~c.validity & ~prev_v)
        eq = eq & same
    eq[:1] = False  # (no row 0 when there are no rows)
    return eq


def group_rows(key_cols: Sequence[Column], sel,
               max_groups: int) -> Tuple[GroupContext, List[Column]]:
    """Group rows by key; returns (context, key columns in ORIGINAL order).

    The sort derives dense group ids in key order (adjacent-equal
    detection); the aggregates then reduce each group's run of the sorted
    order, reading values through the permutation, so no id goes back to
    row order and no dead row is read."""
    if not key_cols:
        seg = torch.where(sel, 0, max_groups).to(torch.int32)
        return GroupContext(sel, 1, max_groups, seg_ids=seg), []
    perm = _group_sort_perm(key_cols, sel)
    sorted_keys = [Column(c.data[perm],
                          None if c.validity is None else c.validity[perm],
                          c.dtype) for c in key_cols]
    alive = sel[perm]
    new_group = alive & ~_keys_equal_adjacent(sorted_keys)
    seg_sorted = torch.cumsum(new_group.to(torch.int64), 0) - 1
    seg_sorted = torch.where(alive, torch.clamp(seg_sorted, 0, max_groups),
                             max_groups).to(torch.int32)
    # the ids never decrease, so the rows with an id below max_groups (the
    # live rows of groups that fit) are a prefix
    n_live = torch.searchsorted(seg_sorted,
                                seg_sorted.new_full((1,), max_groups))[0]
    ctx = GroupContext(sel, new_group.sum(), max_groups, perm=perm,
                       sorted_ids=seg_sorted, n_live=n_live)
    return ctx, list(key_cols)


def group_rows_direct(key_cols: Sequence[Column], domains: Sequence[int],
                      sel) -> Tuple[GroupContext, List[Column]]:
    """Sort-free grouping for low-cardinality keys with known domains
    (dictionary codes, booleans): segment id = packed code, through K2.
    Each key gets domain_i + 1 slots (the extra one encodes NULL)."""
    seg, counts = direct_group_ids([c.data for c in key_cols],
                                   [c.validity for c in key_cols],
                                   domains, sel)
    g_total = counts.shape[0]
    ctx = GroupContext(sel, g_total, g_total, seg_ids=seg,
                       group_mask=counts > 0, counts=counts)
    return ctx, list(key_cols)


def group_key_output(ctx: GroupContext, keys: Sequence[Column]) -> List[Column]:
    """Representative key values per group (its first row)."""
    n = ctx.alive.shape[0]
    if not keys:
        return []
    if n == 0:  # no rows, so no live group: the values are never read
        return [Column(c.data.new_zeros(ctx.max_groups), None, c.dtype)
                for c in keys]
    if ctx.perm is not None:
        # the sort is stable, so a group's smallest row index is its first
        first_idx, _ = seg_reduce_runs(ctx.sorted_ids, ctx.perm, ctx.n_live,
                                       ctx.max_groups, "min")
    else:
        first_idx = seg_reduce(_row_index(ctx), ctx.seg_ids, ctx.max_groups,
                               "min")
    first_idx = torch.clamp(first_idx, 0, n - 1).to(torch.int64)
    return [Column(c.data[first_idx],
                   None if c.validity is None else c.validity[first_idx],
                   c.dtype) for c in keys]


def group_sel(ctx: GroupContext) -> torch.Tensor:
    if ctx.group_mask is not None:
        return ctx.group_mask
    return torch.arange(ctx.max_groups, device=ctx.alive.device) < \
        ctx.num_groups


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------

def _row_index(ctx: GroupContext) -> torch.Tensor:
    n = ctx.alive.shape[0]
    return torch.arange(n, dtype=torch.int32, device=ctx.alive.device)


def _runs(ctx: GroupContext, kind: Optional[str],
          vals: Optional[torch.Tensor] = None,
          valid: Optional[torch.Tensor] = None):
    """(out, count) of a sort-mode context from one runs launch; the
    launch makes the counts only where the context has none for
    ``valid``."""
    cnt = ctx.counts_for(valid)
    out, new = seg_reduce_runs(ctx.sorted_ids, ctx.perm, ctx.n_live,
                               ctx.max_groups, kind, vals, valid,
                               counts=cnt is None)
    return out, cnt if cnt is not None else ctx.keep_counts(valid, new)


def _group_counts(ctx: GroupContext, value: Optional[Column]) -> torch.Tensor:
    """int64[max_groups]: live rows per group where ``value`` is non-null
    (every live row when value is None)."""
    valid = None if value is None else value.validity
    if ctx.perm is not None:
        return _runs(ctx, None, valid=valid)[1]
    cnt = ctx.counts_for(valid)
    if cnt is None:
        ones = torch.ones(ctx.alive.shape[0], dtype=torch.int64,
                          device=ctx.alive.device)
        cnt = ctx.keep_counts(valid, seg_reduce(ones, ctx.seg_ids,
                                                ctx.max_groups, "sum", valid))
    return cnt


def agg_count(ctx: GroupContext, value: Optional[Column]) -> Column:
    """COUNT(*) when value is None, else COUNT(value)."""
    return Column(_group_counts(ctx, value), None, dt.LongType())


def agg_sum(ctx: GroupContext, value: Column, out_type: dt.DataType) -> Column:
    vals = value.data.to(physical_torch_dtype(out_type))
    if ctx.perm is not None:
        out, cnt = _runs(ctx, "sum", vals, value.validity)
        return Column(out, cnt > 0, out_type)
    out = seg_reduce(vals, ctx.seg_ids, ctx.max_groups, "sum", value.validity)
    return Column(out, _group_counts(ctx, value) > 0, out_type)


def agg_min_max(ctx: GroupContext, value: Column, is_min: bool) -> Column:
    vals = value.data
    if vals.dtype == torch.bool:
        vals = vals.to(torch.int8)
    kind = "min" if is_min else "max"
    if ctx.perm is not None:
        out, cnt = _runs(ctx, kind, vals, value.validity)
        has = cnt > 0
    else:
        out = seg_reduce(vals, ctx.seg_ids, ctx.max_groups, kind,
                         value.validity)
        has = _group_counts(ctx, value) > 0
    if value.data.dtype == torch.bool:
        out = out.to(torch.bool)
    return Column(out, has, value.dtype)


def agg_first_last(ctx: GroupContext, value: Column, is_first: bool,
                   ignore_nulls: bool = True) -> Column:
    n = ctx.alive.shape[0]
    valid = value.validity if ignore_nulls else None
    kind = "min" if is_first else "max"
    if ctx.perm is not None:
        # a group's rows keep their input order in the stable sort, so the
        # min (max) of their row indices is its first (last) row
        pos, cnt = _runs(ctx, kind, valid=valid)
        has = cnt > 0
    else:
        # an empty bin keeps the identity: int32 max (min), outside [0, n)
        pos = seg_reduce(_row_index(ctx), ctx.seg_ids, ctx.max_groups, kind,
                         valid)
        has = (pos < n) if is_first else (pos >= 0)
    if n == 0:  # no rows: every group is NULL
        return Column(value.data.new_zeros(ctx.max_groups), has, value.dtype)
    pos = torch.clamp(pos, 0, n - 1).to(torch.int64)
    validity = has
    if value.validity is not None:
        validity = validity & value.validity[pos]
    return Column(value.data[pos], validity, value.dtype)
