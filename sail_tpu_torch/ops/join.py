"""Equi-join kernels (sort + binary-search probe) over tensors.

The PyTorch counterpart of ``sail_tpu/ops/join.py``. The build side is
sorted by its 64-bit key (``ops/hash.join_keys``, kernel K4); probes
binary-search the sorted keys (``probe_ranges``, kernel K5); a
many-to-many match expands into index triples (``join_expand``, kernel
K6). Null join keys never match (SQL equi-join semantics).

Multi-column keys pack losslessly into 64 bits when they fit; otherwise a
64-bit hash orders the build side and each match range is verified
against the true key columns (exact given an unambiguous build: see
``hash_ambiguous``).

Keys are int64 with the reference's uint64 key XOR ``1 << 63``, so the
reference's sentinel ``KEY_MAX`` (uint64 all-ones) is int64 max here. Torch
batches have exact row counts: the build side may be empty, and the code
below never gathers from an empty tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import csrc
from ..columnar.batch import Column, DeviceBatch
from .hash import join_keys

_KEY_MAX = torch.iinfo(torch.int64).max


def _values_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Key-value equality with Spark semantics (NaN == NaN; -0.0 == 0.0)."""
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq


def _verify_eq(build_cols, probe_cols, bidx, valid):
    """Exact key equality check for the hashed path."""
    ok = valid
    for bc, pc in zip(build_cols, probe_cols):
        ok = ok & _values_eq(bc.data[bidx], pc.data)
    return ok


class BuildTable(NamedTuple):
    """Sorted build side, shareable across probes."""

    perm: torch.Tensor         # int64[bn]: usable rows first, in key order
    sorted_keys: torch.Tensor  # int64[bn]; positions >= num_valid hold KEY_MAX
    exact: bool
    num_valid: torch.Tensor    # int64 device scalar: usable build rows
    seed: int = 0              # hash seed (hashed path; bumped on ambiguity)


def build_side(build_key_cols: Sequence[Column], build_sel: torch.Tensor,
               seed: int = 0) -> BuildTable:
    keys, usable, exact = join_keys(build_key_cols, build_sel, seed)
    # Sort usable rows to a prefix in key order (two stable passes), then
    # overwrite the suffix with KEY_MAX so the array stays globally sorted.
    # A *real* key equal to KEY_MAX lives in the prefix; probe ranges clip
    # against num_valid, so the sentinel suffix can never produce a match.
    perm = torch.sort(keys, stable=True).indices
    perm = perm[torch.sort((~usable[perm]).to(torch.uint8),
                           stable=True).indices]
    num_valid = usable.sum()
    pos = torch.arange(keys.shape[0], device=keys.device)
    sorted_keys = torch.where(pos < num_valid, keys[perm],
                              torch.full_like(keys, _KEY_MAX))
    return BuildTable(perm, sorted_keys, exact, num_valid, seed)


def hash_ambiguous(bt: BuildTable, build_key_cols: Sequence[Column]
                   ) -> torch.Tensor:
    """Device scalar: two adjacent usable build rows share a 64-bit hash but
    differ in true key — probing by hash ranges would be wrong. The executor
    re-builds with seed+1 until unambiguous. Only meaningful when
    ``bt.exact`` is False."""
    n = bt.sorted_keys.shape[0]
    if n < 2:
        return torch.zeros((), dtype=torch.bool, device=bt.perm.device)
    pos = torch.arange(n - 1, device=bt.perm.device)
    both_valid = (pos + 1) < bt.num_valid
    same_hash = (bt.sorted_keys[1:] == bt.sorted_keys[:-1]) & both_valid
    diff_key = torch.zeros(n - 1, dtype=torch.bool, device=bt.perm.device)
    a, b = bt.perm[:-1], bt.perm[1:]
    for c in build_key_cols:
        neq = ~_values_eq(c.data[a], c.data[b])
        if c.validity is not None:
            neq = neq | (c.validity[a] != c.validity[b])
        diff_key = diff_key | neq
    return (same_hash & diff_key).any()


class MatchRanges(NamedTuple):
    lo: torch.Tensor      # int32[pn] first matching sorted-build position
                          # (0 on rows that are not usable)
    cnt: torch.Tensor     # int32[pn] number of matches (0 if none)
    usable: torch.Tensor  # bool[pn] probe row alive with non-null key


# keys of K5's splitter table in shared memory (csrc/join_probe.cu
# kTableMax): the wrapper allocates the scratch the table is staged in
PROBE_TABLE_MAX = 16384


def probe_ranges_plain(sorted_keys: torch.Tensor, num_valid: torch.Tensor,
                       keys: torch.Tensor, usable: torch.Tensor):
    """(lo, cnt) int32: the reference's two searchsorted calls, hi clipped
    at num_valid; lo and cnt are 0 on rows that are not usable.

    The reference also searches the keys of unusable rows and keeps that
    lo; every consumer reads lo only where cnt > 0 or where the build
    columns come out NULL (``_first_candidate`` in ``join_unique`` and
    the hashed check, ``expand_indices``, ``build_matched_mask``), so the
    answers are the same and K5 need not search those rows."""
    lo = torch.searchsorted(sorted_keys, keys, side="left")
    hi = torch.minimum(torch.searchsorted(sorted_keys, keys, side="right"),
                       num_valid)
    cnt = torch.where(usable, torch.clamp(hi - lo, min=0), 0)
    return torch.where(usable, lo, 0).to(torch.int32), cnt.to(torch.int32)


def probe_ranges_kernel(sorted_keys: torch.Tensor, num_valid: torch.Tensor,
                        keys: torch.Tensor, usable: torch.Tensor):
    """K5: ``probe_ranges_plain`` as a kernel on the card.

    Replaces the searches of ``sail_tpu/ops/join.py`` ``probe_ranges``;
    the kernel's source (csrc/join_probe.cu) states its bound. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if keys.device.type == "cpu":
        return probe_ranges_plain(sorted_keys, num_valid, keys, usable)
    if sorted_keys.dtype != torch.int64 or keys.dtype != torch.int64 or \
            usable.dtype != torch.bool or usable.shape != keys.shape or \
            sorted_keys.device != keys.device:
        raise TypeError("probe_ranges: needs int64 keys and bool usable "
                        "flags of one length, on one device")
    n, nb = keys.shape[0], sorted_keys.shape[0]
    if nb >= 2**31:
        raise ValueError("probe_ranges: int32 positions need a build of "
                         "fewer than 2**31 rows")
    dev = keys.device
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        sorted_keys = sorted_keys.contiguous()
        nv = num_valid.to(torch.int64).reshape(1)
        keys, usable = keys.contiguous(), usable.contiguous()
        splitters = torch.empty(min(nb, PROBE_TABLE_MAX) + 1,
                                dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("join_probe.cu")(
                sorted_keys.data_ptr(), nb, nv.data_ptr(), keys.data_ptr(),
                usable.data_ptr(), n, splitters.data_ptr(),
                splitters.shape[0], lo.data_ptr(), cnt.data_ptr(),
                csrc.stream_ptr(dev)), "probe_ranges")
        probe_ranges_kernel.launches += 1
    return lo, cnt


probe_ranges_kernel.launches = 0


def probe_ranges(bt: BuildTable, probe_key_cols: Sequence[Column], probe_sel,
                 build_key_cols: Optional[Sequence[Column]] = None
                 ) -> MatchRanges:
    pkeys, pusable, _ = join_keys(probe_key_cols, probe_sel, bt.seed)
    lo, cnt = probe_ranges_kernel(bt.sorted_keys, bt.num_valid, pkeys,
                                  pusable)
    if not bt.exact and bt.perm.shape[0]:
        # Hashed path: given an ambiguity-free build (see hash_ambiguous),
        # each hash range holds exactly one distinct true key, so verifying
        # the first candidate decides the whole range exactly. Torch ops
        # after K5, on every probe row.
        assert build_key_cols is not None
        cap = bt.sorted_keys.shape[0]
        cand = bt.perm[torch.clamp(lo.to(torch.int64), 0, cap - 1)]
        ok = _verify_eq(build_key_cols, probe_key_cols, cand, cnt > 0)
        cnt = torch.where(ok, cnt, 0)
    return MatchRanges(lo, cnt, pusable)


def _gather_build(c: Column, bidx: torch.Tensor, matched: torch.Tensor
                  ) -> Column:
    """Build column ``c`` at rows ``bidx``, NULL where not ``matched``."""
    if c.data.shape[0] == 0:  # empty build side: nothing ever matches
        return Column(torch.zeros(bidx.shape, dtype=c.data.dtype,
                                  device=bidx.device),
                      torch.zeros(bidx.shape, dtype=torch.bool,
                                  device=bidx.device), c.dtype)
    validity = matched if c.validity is None else matched & c.validity[bidx]
    return Column(c.data[bidx], validity, c.dtype)


def _first_candidate(bt: BuildTable, lo: torch.Tensor) -> torch.Tensor:
    cap = bt.perm.shape[0]
    if cap == 0:
        return torch.zeros(lo.shape, dtype=torch.int64, device=lo.device)
    return bt.perm[torch.clamp(lo.to(torch.int64), 0, cap - 1)]


def join_unique(bt: BuildTable, ranges: MatchRanges, probe: DeviceBatch,
                build_payload: DeviceBatch, join_type: str,
                build_names: Sequence[str]) -> DeviceBatch:
    """Join assuming ≤1 build match per probe row (PK-FK). Output capacity =
    probe capacity. join_type ∈ {inner, left, semi, anti}."""
    matched = ranges.cnt > 0
    if join_type == "semi":
        return probe.with_sel(probe.sel & matched)
    if join_type == "anti":
        return probe.with_sel(probe.sel & ~matched)
    bidx = _first_candidate(bt, ranges.lo)
    cols = dict(probe.columns)
    for name in build_names:
        cols[name] = _gather_build(build_payload.columns[name], bidx, matched)
    if join_type == "inner":
        sel = probe.sel & matched
    elif join_type == "left":
        sel = probe.sel
    else:
        raise ValueError(join_type)
    return DeviceBatch(cols, sel)


def _effective_counts(cnt: torch.Tensor, probe_sel: torch.Tensor,
                      join_type: str) -> torch.Tensor:
    cnt = cnt.to(torch.int64)
    if join_type in ("left", "full"):
        cnt = torch.clamp(cnt, min=1)
    return torch.where(probe_sel, cnt, 0)


def join_output_count(ranges: MatchRanges, probe_sel, join_type: str
                      ) -> torch.Tensor:
    """Total output rows for the expanding join (int64 device scalar)."""
    return _effective_counts(ranges.cnt, probe_sel, join_type).sum()


# probe rows + output slots per piece of K6's work (csrc/join_expand.cu
# kPiece): the wrapper allocates the scratch of the pieces' first rows
EXPAND_PIECE = 2048


def expand_indices_plain(eff, offsets, cnt, lo, perm, total: int):
    """(probe_index, build_index, is_match) of the ``total`` output rows:
    output row j = offsets[i] + k (k < eff[i]) comes from probe row i, is a
    match when k < cnt[i], and reads build row perm[lo[i] + k] (clipped)."""
    dev = eff.device
    pi = torch.repeat_interleave(torch.arange(eff.shape[0], device=dev), eff,
                                 output_size=total)
    k = torch.arange(total, device=dev) - offsets[pi]
    is_match = k < cnt[pi]
    nb = perm.shape[0]
    if nb == 0:
        return pi, torch.zeros_like(pi), is_match
    bpos = torch.clamp(lo[pi].to(torch.int64) + torch.where(is_match, k, 0),
                       0, nb - 1)
    return pi, perm[bpos], is_match


def expand_indices(eff, offsets, cnt, lo, perm, total: int):
    """K6: ``expand_indices_plain`` as a kernel on the card.

    Replaces the index arithmetic of ``sail_tpu/ops/join.py``
    ``join_expand``; the kernel's source (csrc/join_expand.cu) states its
    bound. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if eff.device.type == "cpu":
        return expand_indices_plain(eff, offsets, cnt, lo, perm, total)
    n = eff.shape[0]
    if eff.dtype != torch.int64 or offsets.dtype != torch.int64 or \
            cnt.dtype != torch.int32 or lo.dtype != torch.int32 or \
            perm.dtype != torch.int64 or \
            not (offsets.shape == cnt.shape == lo.shape == (n,)):
        raise TypeError("join_expand: needs int64 eff/offsets/perm and "
                        "int32 cnt/lo of one length")
    dev = eff.device
    pi = torch.empty(total, dtype=torch.int64, device=dev)
    bi = torch.empty(total, dtype=torch.int64, device=dev)
    is_match = torch.empty(total, dtype=torch.bool, device=dev)
    if n and total:
        offsets = offsets.contiguous()
        cnt, lo, perm = cnt.contiguous(), lo.contiguous(), perm.contiguous()
        # each piece's first probe row, written by the kernel's pre-pass
        split = torch.empty(-(-(n + total) // EXPAND_PIECE) + 1,
                            dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("join_expand.cu")(
                offsets.data_ptr(), cnt.data_ptr(), lo.data_ptr(), n, total,
                perm.data_ptr(), perm.shape[0], split.data_ptr(),
                split.shape[0], pi.data_ptr(), bi.data_ptr(),
                is_match.data_ptr(), csrc.stream_ptr(dev)), "join_expand")
        expand_indices.launches += 1
    return pi, bi, is_match


expand_indices.launches = 0


class ExpandResult(NamedTuple):
    batch: DeviceBatch
    probe_index: torch.Tensor  # int64[total] originating probe row
    is_match: torch.Tensor     # bool[total] row is a key match
    build_index: torch.Tensor  # int64[total] originating build row


def join_expand(bt: BuildTable, ranges: MatchRanges, probe: DeviceBatch,
                build_payload: DeviceBatch, join_type: str,
                build_names: Sequence[str], total: int) -> ExpandResult:
    """Materialize a many-to-many join into a batch of exactly ``total``
    rows (``join_output_count``, fetched by the caller).

    join_type ∈ {inner, left}."""
    eff = _effective_counts(ranges.cnt, probe.sel, join_type)
    offsets = torch.cumsum(eff, 0) - eff  # exclusive prefix sum
    pi, bidx, is_match = expand_indices(eff, offsets, ranges.cnt, ranges.lo,
                                        bt.perm, total)
    cols = {}
    for name, c in probe.columns.items():
        cols[name] = Column(c.data[pi],
                            None if c.validity is None else c.validity[pi],
                            c.dtype)
    for name in build_names:
        cols[name] = _gather_build(build_payload.columns[name], bidx,
                                   is_match)
    out_sel = torch.ones(total, dtype=torch.bool, device=pi.device)
    return ExpandResult(DeviceBatch(cols, out_sel), pi, is_match, bidx)


def build_matched_mask(bt: BuildTable, ranges: MatchRanges, probe_sel
                       ) -> torch.Tensor:
    """bool[build_capacity]: build rows matched by ≥1 probe row (for right/
    full outer). A range-increment difference array over sorted build
    positions, mapped back through the sort permutation."""
    bn = bt.sorted_keys.shape[0]
    dev = bt.perm.device
    active = (ranges.cnt > 0) & probe_sel
    lo = torch.where(active, ranges.lo.to(torch.int64), 0)
    hi = torch.where(active, (ranges.lo + ranges.cnt).to(torch.int64), 0)
    diff = torch.zeros(bn + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, lo, active.to(torch.int64))
    diff.index_add_(0, hi, -active.to(torch.int64))
    covered_sorted = torch.cumsum(diff[:bn], 0) > 0
    matched = torch.zeros(bn, dtype=torch.bool, device=dev)
    matched[bt.perm] = covered_sorted
    return matched


def has_duplicate_build_keys(bt: BuildTable) -> torch.Tensor:
    """Device scalar: any two usable build rows share a key (→ the unique
    fast path is invalid and the executor must expand)."""
    k = bt.sorted_keys
    pos = torch.arange(max(k.shape[0] - 1, 0), device=k.device)
    dup = (k[1:] == k[:-1]) & ((pos + 1) < bt.num_valid)
    return dup.any()
