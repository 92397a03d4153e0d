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
A DISTINCT aggregate reduces the rows ``distinct_rows`` keeps: one of
each (group, value) pair.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import csrc
from ..columnar.batch import Column, physical_torch_dtype
from ..spec import data_type as dt
from .sort import order_keys, order_keys_plain, sort_words

# ---------------------------------------------------------------------------
# K1: segmented reduction
# ---------------------------------------------------------------------------

_KINDS = {"sum": 0, "min": 1, "max": 2, "and": 3, "or": 4, "xor": 5}
# the bit folds (bit_and, bit_or, bit_xor): integers only
_BIT_KINDS = ("and", "or", "xor")
# the types K1 reduces in (narrower inputs widen exactly and narrow back)
_K1_TYPE = {torch.int32: (0, ctypes.c_int), torch.int64: (1, ctypes.c_longlong),
            torch.float64: (2, ctypes.c_double)}
_K1_WIDEN = {torch.bool: torch.int32, torch.int8: torch.int32,
             torch.int16: torch.int32, torch.float32: torch.float64}
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
            "and": torch.bitwise_and, "or": torch.bitwise_or,
            "xor": torch.bitwise_xor}


def _identity(dtype: torch.dtype, kind: str):
    if kind in ("sum", "or", "xor"):
        return 0
    if kind == "and":
        return -1
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def seg_reduce_plain(vals: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, kind: str,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[s] = sum/min/max (or the bit fold and/or/xor, of integers) of
    vals[i] over seg_ids[i] == s where valid[i]; ids outside
    [0, num_segments) are dropped and an empty segment holds the identity,
    as ``jax.ops.segment_*`` give. Rows are sorted by id and
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


def k1_work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type K1 reduces ``dtype`` values in."""
    return _K1_WIDEN.get(dtype, dtype)


def _k1_work(vals: torch.Tensor, name: str) -> torch.Tensor:
    """The values in a type K1 reduces in (narrower types widen exactly)."""
    work = vals.to(_K1_WIDEN.get(vals.dtype, vals.dtype)).contiguous()
    if work.dtype not in _K1_TYPE:
        raise TypeError(f"{name}: unsupported value type {vals.dtype}")
    return work


class _Launches:
    """A launch count of its own: K1's bit kinds are counted by kind too,
    in ``BIT_LAUNCHES`` (beside the entry point's count)."""

    def __init__(self):
        self.launches = 0


BIT_LAUNCHES = {k: _Launches() for k in _BIT_KINDS}


def _count_kind(kind: str) -> None:
    if kind in BIT_LAUNCHES:
        BIT_LAUNCHES[kind].launches += 1


def _check_kind(kind: str, dtype: torch.dtype, name: str) -> None:
    if kind not in _KINDS or (kind in _BIT_KINDS and
                              dtype.is_floating_point):
        raise TypeError(f"{name}: no {kind!r} reduction of {dtype} values")


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
    _check_kind(kind, work.dtype, "seg_reduce")
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
        _count_kind(kind)
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
    _check_kind(kind or "sum", work, "seg_reduce_runs")
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
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("seg_reduce.cu", "sail_seg_reduce_runs")(
                ids.data_ptr(), perm.data_ptr(), n_live.data_ptr(),
                _ptr(vals), _ptr(valid), num_segments, code,
                _KINDS[kind or "sum"], ctypes.addressof(identity), _ptr(out),
                _ptr(cnt), scratch.data_ptr(), grid, csrc.stream_ptr(dev)),
                "seg_reduce_runs")
        seg_reduce_runs.launches += 1
        _count_kind(kind)
    return None if out is None else out.to(out_dtype), cnt


seg_reduce_runs.launches = 0
# rows a block of the runs kernel takes at a time (kTile in seg_reduce.cu)
_RUNS_TILE = 1024


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
        self.sort_form = None         # "packed" or "passes" (sort mode)
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


def group_rows(key_cols: Sequence[Column], sel, max_groups: int,
               words=None, ext=None) -> Tuple[GroupContext, List[Column]]:
    """Group rows by key; returns (context, key columns in ORIGINAL order).

    ``words``: each key's K3 word (int64) and validity, as K18 writes
    them beside ``ext``, their extremes over the live non-null rows
    (int64[k, 2]); None: K3 here, and the extremes over all rows.

    Where the keys fit in one word (``ops/sort.py`` ``sort_words``, a
    NULL key canonical in it): one pack pass and one stable sort, as the
    reference's ``_group_sort_perm`` packs its keys (``can_pack``); a
    group starts where the sorted word changes among the live rows (those
    below the dead bit). Otherwise the reference's passes (a
    sort a key, a validity and the dead rows), and adjacent-equal
    detection over each key gathered into sorted order. Either way the
    ids are dense and in key order (NULLs first); the aggregates reduce
    each group's run of the sorted order, reading values through the
    permutation, so no id goes back to row order and no dead row is
    read. ``ctx.sort_form`` says which form ran."""
    if not key_cols:
        seg = torch.where(sel, 0, max_groups).to(torch.int32)
        return GroupContext(sel, 1, max_groups, seg_ids=seg), []
    if words is None:
        words = [(order_keys(c.data), c.validity) for c in key_cols]
    keys = [(w, v, True) for w, v in words]
    srt = sort_words(keys, sel, ext, canonical=True)
    perm = srt.perm
    if srt.layout is not None:
        alive = srt.word < (1 << srt.layout.dead_shift)
        new_group = alive.clone()
        new_group[1:] &= srt.word[1:] != srt.word[:-1]
    else:
        sorted_keys = [Column(c.data[perm],
                              None if c.validity is None else
                              c.validity[perm], c.dtype) for c in key_cols]
        alive = sel[perm]
        new_group = alive & ~_keys_equal_adjacent(sorted_keys)
    seg_sorted = torch.cumsum(new_group.to(torch.int64), 0) - 1
    seg_sorted = torch.where(alive, torch.clamp(seg_sorted, 0, max_groups),
                             max_groups).to(torch.int32)
    # the ids never decrease, so the rows with an id below max_groups (the
    # live rows of groups that fit: packed, those before the dead bit) are
    # a prefix
    n_live = torch.searchsorted(seg_sorted,
                                seg_sorted.new_full((1,), max_groups))[0]
    ctx = GroupContext(sel, new_group.sum(), max_groups, perm=perm,
                       sorted_ids=seg_sorted, n_live=n_live)
    ctx.sort_form = srt.form
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


def direct_key_columns(domains: Sequence[int], dtypes: Sequence[torch.dtype],
                       nullable: Sequence[bool], types: Sequence[dt.DataType],
                       device) -> List[Column]:
    """The key columns of every bin of a direct grouping, decoded from the
    bin number as ``direct_group_ids`` makes it (the first key most
    significant, ``domain + 1`` slots a key, the last one NULL): for
    K17, which reads no row of a group's. A bin's code is the one every
    live row of it has (K2 clips a code into its domain, so an
    out-of-range code decodes as the clipped one)."""
    g = torch.arange(int(np.prod([d + 1 for d in domains])),
                     dtype=torch.int64, device=device)
    out: List[Column] = []
    for dom, dtype, null, t in reversed(list(zip(domains, dtypes, nullable,
                                                 types))):
        digit = g % (dom + 1)
        g = g // (dom + 1)
        ok = digit < dom
        code = torch.where(ok, digit, 0)
        data = code.to(torch.bool) if dtype == torch.bool else \
            code.to(torch.int32)
        out.append(Column(data, ok if null else None, t))
    return out[::-1]


def chain_agg_columns(words: torch.Tensor,
                      aggs: Sequence[Tuple[str, Optional[torch.dtype]]],
                      slots: Sequence[Tuple[int, int]],
                      types: Sequence[dt.DataType]) -> List[Column]:
    """K17's per-bin partials (int64 words[bins, slots]: slot 0 the live
    rows of each bin, then each aggregate's value and, where its argument
    is nullable, its count of non-null rows) as the columns agg_count,
    agg_sum and agg_min_max give. ``aggs``: (fn, the dtype of the values
    reduced: SUM's output type, MIN/MAX's argument type); ``slots``: each
    aggregate's (value slot, count slot)."""
    out = []
    for (fn, dtype), (slot, cnt), t in zip(aggs, slots, types):
        counts = words[:, cnt]
        if fn == "count":
            out.append(Column(counts, None, dt.LongType()))
            continue
        w = words[:, slot]
        if dtype.is_floating_point:
            vals = w.view(torch.float64).to(dtype)
        elif fn == "sum":
            vals = w.to(dtype)
        else:
            work = k1_work_dtype(torch.int8 if dtype == torch.bool
                                 else dtype)
            vals = w.to(work).to(torch.int8 if dtype == torch.bool
                                 else dtype)
            if dtype == torch.bool:
                vals = vals.to(torch.bool)
        out.append(Column(vals, counts > 0, t))
    return out


def agg_bool(ctx: GroupContext, value: Column, is_any: bool) -> Column:
    """bool_or (``is_any``) or bool_and of a boolean column: K1's max or
    min over it as int8, NULL where a group has no non-null value."""
    return agg_min_max(ctx, value, is_min=not is_any)


def distinct_rows(ctx: GroupContext, value: Column,
                  more: Sequence[Column] = ()) -> torch.Tensor:
    """bool[n] in row order: True at one row of each distinct (group,
    value) pair among the live rows whose value is non-null.

    A DISTINCT aggregate is the plain aggregate of its argument with this
    as the validity: every row that repeats its pair counts as null (the
    reference's ``_host_agg_one`` drops nulls, then dedupes the values of
    a group). The rows sort by (group id, value): the value's K3 order
    keys, in the grouping's order (``perm`` in sort mode, row order
    otherwise), then a stable sort by group id. A row is kept where its
    pair differs from its neighbour's: the first of its pair in that
    order, which is row order within a group. Values compare by their
    order keys, so all NaNs are one value and -0.0 is 0.0, as Spark's
    keys are. ``more``: further fields of a struct argument (a NULL one
    equal to another NULL), deduplicated with the value as one tuple; a
    literal field (0-d) is the same in every row. No host sync; dead and
    null rows carry the dead id and sort last."""
    n = ctx.alive.shape[0]
    dev = ctx.alive.device
    ids, rows = positions(ctx)
    if rows is None:
        rows = torch.arange(n, device=dev)
    dead = ctx.max_groups
    keep = ids < dead
    if value.validity is not None:
        keep = keep & value.validity[rows]
    ids = torch.where(keep, ids, dead)
    keys = [order_keys(value.data)[rows]]
    for c in more:
        if c.data.dim() == 0:
            continue
        bits = order_keys(c.data)[rows]
        if c.validity is not None:
            ok = c.validity[rows]
            keys += [torch.where(ok, bits, 0), ok.to(torch.int64)]
        else:
            keys.append(bits)
    order = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        order = order[torch.sort(k[order], stable=True).indices]
    order = order[torch.sort(ids[order], stable=True).indices]
    ids = ids[order]
    first = ids < dead
    differs = ids[1:] != ids[:-1]
    for k in keys:
        k = k[order]
        differs |= k[1:] != k[:-1]
    first[1:] &= differs
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[rows[order]] = first
    return out


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


# ---------------------------------------------------------------------------
# the host aggregates' families (sail_tpu/functions/host_aggregates.py),
# each over a GroupContext in its three modes. A context's positions are
# the sort's order in sort mode (position i reads row perm[i]) and the
# rows themselves in the binned modes; ``positions`` gives each one's
# group (a dead position's is max_groups) and row. Each family reduces
# into ``slots`` groups (``output_slots``): in sort mode the groups there
# are, in the binned modes every bin.
# ---------------------------------------------------------------------------

def positions(ctx: GroupContext
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(int32 group id of each position, int64 row of each position or
    None where position i is row i)."""
    if ctx.perm is not None:
        return ctx.sorted_ids, ctx.perm
    return ctx.seg_ids, None


def output_slots(ctx: GroupContext) -> int:
    """The groups a host aggregate writes: every bin of a binned context,
    the groups of a sorted one (read to the host: one wait)."""
    if ctx.perm is None:
        return ctx.max_groups
    return int(ctx.num_groups)


def at_rows(t: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """A row-order tensor read at each position."""
    return t if rows is None else t[rows]


# -- K19: segment moments ------------------------------------------------------

class Operand(NamedTuple):
    """A column a statistical aggregate reads as float64: int32 or int64
    values (a decimal's unscaled ones, ``scale`` its scale) or float64."""

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    scale: int = 0


_OPERAND_TYPE = {torch.int32: 0, torch.int64: 1, torch.float64: 2}


def _operand(x: Operand) -> Operand:
    """x in a type K19 loads (narrower types widen exactly)."""
    data = x.data
    if data.dtype in (torch.bool, torch.int8, torch.int16):
        data = data.to(torch.int32)
    elif data.dtype == torch.float32:
        data = data.to(torch.float64)
    if data.dtype not in _OPERAND_TYPE:
        raise TypeError(f"seg_moments: unsupported operand {data.dtype}")
    return Operand(data.contiguous(), None if x.validity is None else
                   x.validity.contiguous(), x.scale)


def _as_float(x: Operand, rows: Optional[torch.Tensor]) -> torch.Tensor:
    v = at_rows(x.data, rows).to(torch.float64)
    return v / float(10 ** x.scale) if x.scale else v


def _from_order_word(w: torch.Tensor) -> torch.Tensor:
    """The float64 of K3's order word of a float64 (the word's inverse)."""
    return torch.where(w < 0, w ^ 0x7FFFFFFFFFFFFFFF, w).view(torch.float64)


def _pair_ok(ids, rows, num_segments, a: Operand, b: Optional[Operand]):
    keep = (ids >= 0) & (ids < num_segments)
    for x in (a, b):
        if x is not None and x.validity is not None:
            keep = keep & at_rows(x.validity, rows)
    return keep


def seg_moments_plain(ids: torch.Tensor, rows: Optional[torch.Tensor],
                      num_segments: int, a: Operand,
                      b: Optional[Operand] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K19's first pass: (count int64[S], sums float64[S, 2] of a and b,
    extremes float64[S, 4]: min a, max a, min b, max b) over the positions
    of groups [0, S) where a and b are both valid. Sums in position order
    (``index_add_``); an empty group's extremes are NaN, as the kernel's
    identity words read."""
    keep = _pair_ok(ids, rows, num_segments, a, b)
    g = ids[keep].to(torch.int64)
    dev = ids.device
    count = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    count.index_add_(0, g, torch.ones_like(g))
    sums = torch.zeros(num_segments, 2, dtype=torch.float64, device=dev)
    ext = torch.zeros(num_segments, 4, dtype=torch.float64, device=dev)
    for j, x in enumerate((a, b)):
        if x is None:
            continue
        v = _as_float(x, rows)[keep]
        sums[:, j].index_add_(0, g, v)
        for k, how in enumerate(("amin", "amax")):
            col = torch.zeros(num_segments, dtype=torch.float64, device=dev)
            ext[:, 2 * j + k] = col.scatter_reduce(0, g, v, how,
                                                   include_self=False)
    ext[count == 0] = float("nan")
    return count, sums, ext


def seg_moments(ids: torch.Tensor, rows: Optional[torch.Tensor],
                num_segments: int, a: Operand, b: Optional[Operand] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K19's first pass: ``seg_moments_plain`` as a kernel on the card.

    Replaces the per-group sums of ``sail_tpu/functions/host_aggregates.py``
    ``_corr``, ``_covar``, ``_skew_kurt`` and ``_regr``; the kernel's
    source (csrc/seg_moments.cu) states its bound and design. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    float64 sums come out in an order that varies between runs."""
    if ids.device.type == "cpu":
        return seg_moments_plain(ids, rows, num_segments, a, b)
    dev = ids.device
    count = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    sums = torch.zeros(num_segments, 2, dtype=torch.float64, device=dev)
    words = torch.tensor([_MAX64, _MIN64, _MAX64, _MIN64], dtype=torch.int64,
                         device=dev).repeat(num_segments, 1)
    _launch_moments(1, ids, rows, num_segments, a, b, 0, None, count, sums,
                    words)
    return count, sums, _from_order_word(words)


_MAX64 = (1 << 63) - 1
_MIN64 = -(1 << 63)


def seg_centred_plain(ids: torch.Tensor, rows: Optional[torch.Tensor],
                      num_segments: int, a: Operand, b: Optional[Operand],
                      means: torch.Tensor, mask: int) -> torch.Tensor:
    """K19's second pass: float64[S, 5], the sums over each group's rows
    (those of ``seg_moments_plain``) of (a - ma)^2, (b - mb)^2,
    (a - ma)(b - mb), (a - ma)^3 and (a - ma)^4 for the bits of ``mask``
    (zero elsewhere), ``means`` [S, 2] each group's (ma, mb)."""
    keep = _pair_ok(ids, rows, num_segments, a, b)
    g = ids[keep].to(torch.int64)
    out = torch.zeros(num_segments, 5, dtype=torch.float64,
                      device=ids.device)
    dx = _as_float(a, rows)[keep] - means[g, 0]
    dy = _as_float(b, rows)[keep] - means[g, 1] if b is not None else \
        torch.zeros_like(dx)
    dx2 = dx * dx
    terms = (dx2, dy * dy, dx * dy, dx2 * dx, dx2 * dx2)
    for k, t in enumerate(terms):
        if mask >> k & 1:
            out[:, k].index_add_(0, g, t)
    return out


def seg_centred(ids: torch.Tensor, rows: Optional[torch.Tensor],
                num_segments: int, a: Operand, b: Optional[Operand],
                means: torch.Tensor, mask: int) -> torch.Tensor:
    """K19's second pass: ``seg_centred_plain`` as a kernel on the card
    (the same kernel as ``seg_moments``, whose launches it counts)."""
    if ids.device.type == "cpu":
        return seg_centred_plain(ids, rows, num_segments, a, b, means, mask)
    out = torch.zeros(num_segments, 5, dtype=torch.float64,
                      device=ids.device)
    _launch_moments(2, ids, rows, num_segments, a, b, mask,
                    means.to(torch.float64).contiguous(), None, out, None)
    return out


def _launch_moments(pass_, ids, rows, num_segments, a, b, mask, means,
                    count, sums, ext) -> None:
    n, dev = ids.shape[0], ids.device
    if ids.dtype != torch.int32 or (rows is not None and
                                    rows.dtype != torch.int64):
        raise TypeError(f"seg_moments: needs int32 ids and int64 rows, got "
                        f"{ids.dtype} and {None if rows is None else rows.dtype}")
    a = _operand(a)
    b = None if b is None else _operand(b)
    nrows = n if rows is None else a.data.shape[0]
    _same_rows("seg_moments", n, dev, rows=rows)
    for x in (a, b):
        if x is not None:
            _same_rows("seg_moments", nrows, dev, data=x.data,
                       valid=x.validity)
            if x.validity is not None and x.validity.dtype != torch.bool:
                raise TypeError("seg_moments: validity must be bool")
    if n == 0 or num_segments == 0:
        return
    ids = ids.contiguous()
    rows = None if rows is None else rows.contiguous()

    def operand(x):
        if x is None:
            return None, None, 0, 1.0
        return (x.data.data_ptr(), _ptr(x.validity),
                _OPERAND_TYPE[x.data.dtype], float(10 ** x.scale))
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("seg_moments.cu")(
            pass_, ids.data_ptr(), _ptr(rows), n, num_segments, *operand(a),
            *operand(b), mask, _ptr(means), _ptr(count), sums.data_ptr(),
            _ptr(ext), csrc.grid_for(n, dev), csrc.stream_ptr(dev)),
            "seg_moments")
    seg_moments.launches += 1


seg_moments.launches = 0

# the centred sums of K19's second pass, by bit of its mask
CENTRED = {"aa": 1, "bb": 2, "ab": 4, "aaa": 8, "aaaa": 16}


def agg_moments(ctx: GroupContext, slots: int, a: Operand,
                b: Optional[Operand], mask: int) -> dict:
    """Family A (the statistical aggregates): K19's two passes over the
    context's positions into ``slots`` groups. Returns each group's
    ``count``, the sums ``sa``/``sb`` and the centred sums the ``mask``
    asks for (``aa``, ``bb``, ``ab``, ``aaa``, ``aaaa``), each float64[S].
    A group whose values of an operand are all equal and finite (its
    minimum equals its maximum) is centred on that value, so its centred
    sums of that operand are exactly 0, whatever order the first pass
    summed in."""
    ids, rows = positions(ctx)
    count, sums, ext = seg_moments(ids, rows, slots, a, b)
    out = {"count": count, "sa": sums[:, 0], "sb": sums[:, 1]}
    if mask:
        n = count.clamp_min(1).to(torch.float64)
        means = sums / n[:, None]
        for j in range(2):
            lo, hi = ext[:, 2 * j], ext[:, 2 * j + 1]
            constant = (lo == hi) & torch.isfinite(lo)
            means[:, j] = torch.where(constant, lo, means[:, j])
        centred = seg_centred(ids, rows, slots, a, b, means, mask)
        for name, bit in CENTRED.items():
            out[name] = centred[:, bit.bit_length() - 1]
    return out


# -- K20: segment arg-extreme --------------------------------------------------

def seg_pick_plain(ids: torch.Tensor, rows: Optional[torch.Tensor],
                   num_segments: int, keys: torch.Tensor,
                   valid: Optional[torch.Tensor], is_max: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best int64[S], index int64[S]): over the positions of groups
    [0, S) whose row r is valid, best[g] the largest (``is_max``) or
    smallest key keys[r], index[g] the least r whose key is best[g]. A
    group without a row holds INT64_MIN (or INT64_MAX) and INT64_MAX."""
    keep = (ids >= 0) & (ids < num_segments)
    r = torch.arange(ids.shape[0], device=ids.device) if rows is None \
        else rows
    if valid is not None:
        keep = keep & valid[r]
    g, r = ids[keep].to(torch.int64), r[keep]
    k = keys[r]
    best = torch.full((num_segments,), _MIN64 if is_max else _MAX64,
                      dtype=torch.int64, device=ids.device)
    best.scatter_reduce_(0, g, k, "amax" if is_max else "amin")
    index = torch.full((num_segments,), _MAX64, dtype=torch.int64,
                       device=ids.device)
    at_best = k == best[g]
    index.scatter_reduce_(0, g[at_best], r[at_best], "amin")
    return best, index


def seg_pick(ids: torch.Tensor, rows: Optional[torch.Tensor],
             num_segments: int, keys: torch.Tensor,
             valid: Optional[torch.Tensor], is_max: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K20: ``seg_pick_plain`` as a kernel on the card (two launches).

    Replaces the per-group ``max``/``min`` of
    ``sail_tpu/functions/host_aggregates.py`` (max_by, min_by) and
    ``_mode``/``_mode_ordered``'s pick; the kernel's source
    (csrc/seg_pick.cu) states its bound and design. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if ids.device.type == "cpu":
        return seg_pick_plain(ids, rows, num_segments, keys, valid, is_max)
    n, dev = ids.shape[0], ids.device
    if ids.dtype != torch.int32 or keys.dtype != torch.int64 or \
            (rows is not None and rows.dtype != torch.int64) or \
            (valid is not None and valid.dtype != torch.bool):
        raise TypeError("seg_pick: needs int32 ids, int64 keys and rows and "
                        "a bool validity")
    _same_rows("seg_pick", n, dev, rows=rows)
    _same_rows("seg_pick", keys.shape[0], dev, valid=valid)
    best = torch.full((num_segments,), _MIN64 if is_max else _MAX64,
                      dtype=torch.int64, device=dev)
    index = torch.full((num_segments,), _MAX64, dtype=torch.int64,
                       device=dev)
    if n and num_segments:
        ids, keys = ids.contiguous(), keys.contiguous()
        rows = None if rows is None else rows.contiguous()
        valid = None if valid is None else valid.contiguous()
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("seg_pick.cu")(
                ids.data_ptr(), _ptr(rows), n, num_segments, keys.data_ptr(),
                _ptr(valid), 1 if is_max else 0, best.data_ptr(),
                index.data_ptr(), csrc.grid_for(n, dev),
                csrc.stream_ptr(dev)), "seg_pick")
        seg_pick.launches += 1
    return best, index


seg_pick.launches = 0


def agg_pick(ctx: GroupContext, slots: int, keys: torch.Tensor,
             valid: torch.Tensor, is_max: bool) -> torch.Tensor:
    """Family B (max_by, min_by): each group's row whose key (an int64
    order word, by row) is the largest (smallest) among its rows where
    ``valid``, the first row of a tie; int64[S], INT64_MAX where the group
    has no such row."""
    ids, rows = positions(ctx)
    return seg_pick(ids, rows, slots, keys, valid, is_max)[1]


# -- ranks: a sort of each group's values ------------------------------------

class GroupSorted(NamedTuple):
    """The eligible positions of a context, grouped: ``rows`` each one's
    row, in (group, then the words', then row) order; ``ids`` each one's
    group; ``offsets`` int64[S + 1], group g's rows at
    [offsets[g], offsets[g + 1])."""

    rows: torch.Tensor
    ids: torch.Tensor
    offsets: torch.Tensor


def group_sorted(ctx: GroupContext, slots: int, eligible: torch.Tensor,
                 words: Sequence = ()) -> GroupSorted:
    """Each group's eligible rows (``eligible``: bool by row), ordered by
    the K3 ``words`` (each (int64 word by row, validity by row or None,
    nulls_first)), ties in row order: one stable sort of (group id, the
    words) through ``ops/sort.py`` ``sort_words`` (one sort of one packed
    word where they fit in 63 bits, else the passes). A sort context with
    no words needs no sort: its positions are already its groups' rows in
    row order. The eligible count is read to the host (one wait)."""
    ids, rows = positions(ctx)
    ok = (ids < slots) & at_rows(eligible, rows)
    m = int(ok.sum())
    if rows is not None and not words:
        pos = torch.nonzero(ok).squeeze(1)
    else:
        keys = [(ids.to(torch.int64), None, True)] + \
            [(at_rows(w, rows), None if v is None else at_rows(v, rows), nf)
             for w, v, nf in words]
        pos = sort_words(keys, ok).perm[:m]
    g = ids[pos]
    offsets = torch.searchsorted(
        g, torch.arange(slots + 1, dtype=torch.int32, device=g.device))
    return GroupSorted(pos if rows is None else rows[pos], g, offsets)


def group_counts(srt: GroupSorted) -> torch.Tensor:
    return srt.offsets[1:] - srt.offsets[:-1]


def pick_at(srt: GroupSorted, index: torch.Tensor) -> torch.Tensor:
    """The row at each group's ``index`` (int64[S], within the group's
    rows; clipped into them, so an empty group reads some row)."""
    pos = srt.offsets[:-1] + index
    top = max(srt.rows.shape[0] - 1, 0)
    pos = pos.clamp(0, top)
    return srt.rows[pos] if srt.rows.shape[0] else pos


def agg_mode(ctx: GroupContext, slots: int, srt: GroupSorted,
             words: torch.Tensor) -> torch.Tensor:
    """Family B over family C's sort (mode): ``srt`` each group's rows
    sorted by value, ``words`` the values' order words by row. A run of
    equal words is one value; K20 over the runs (their count read to the
    host: one wait) picks each group's longest, a tie to the earliest (the
    first value in the sort's order). Returns the row of that run's first
    element, int64[S] (any row for an empty group)."""
    m = srt.rows.shape[0]
    dev = srt.rows.device
    if m == 0:
        return torch.zeros(slots, dtype=torch.int64, device=dev)
    w = words[srt.rows]
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = (srt.ids[1:] != srt.ids[:-1]) | (w[1:] != w[:-1])
    first = torch.nonzero(start).squeeze(1)
    length = torch.diff(first, append=first.new_full((1,), m))
    _, run = seg_pick(srt.ids[first].to(torch.int32), None, slots, length,
                      None, True)
    return srt.rows[first[run.clamp(0, first.shape[0] - 1)]]


# -- exact sums, bit folds, product -------------------------------------------

def agg_exact_sum(ctx: GroupContext, value: Column
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Family D (try_sum, try_avg of integers): the exact sum of each
    group's integers as two K1 sums of their 32-bit halves (each exact in
    int64 below 2^31 rows a group), combined: (hi, lo, count) with the
    total hi * 2^32 + lo, lo in [0, 2^32), over ``ctx.max_groups``
    slots."""
    v = value.data.to(torch.int64)
    hi = Column(v >> 32, value.validity, dt.LongType())
    lo = Column(v & 0xFFFFFFFF, value.validity, dt.LongType())
    s_hi = agg_sum(ctx, hi, dt.LongType()).data
    s_lo = agg_sum(ctx, lo, dt.LongType()).data
    count = _group_counts(ctx, value)
    return s_hi + (s_lo >> 32), s_lo & 0xFFFFFFFF, count


def agg_bit(ctx: GroupContext, value: Column, kind: str) -> Column:
    """Family E: bit_and, bit_or or bit_xor (``kind`` and/or/xor) of an
    integer column, K1's bit kinds; NULL where a group has no non-null
    value."""
    vals = value.data
    if ctx.perm is not None:
        out, cnt = _runs(ctx, kind, vals, value.validity)
        has = cnt > 0
    else:
        out = seg_reduce(vals, ctx.seg_ids, ctx.max_groups, kind,
                         value.validity)
        has = _group_counts(ctx, value) > 0
    return Column(out.to(vals.dtype), has, value.dtype)


def agg_product(ctx: GroupContext, slots: int, value: Operand
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Family E: product (float64) of each group's non-null values,
    ``scatter_reduce_`` with "prod"; (product, count)."""
    ids, rows = positions(ctx)
    keep = _pair_ok(ids, rows, slots, value, None)
    g = ids[keep].to(torch.int64)
    out = torch.ones(slots, dtype=torch.float64, device=ids.device)
    out.scatter_reduce_(0, g, _as_float(value, rows)[keep], "prod")
    count = torch.zeros(slots, dtype=torch.int64, device=ids.device)
    count.index_add_(0, g, torch.ones_like(g))
    return out, count
