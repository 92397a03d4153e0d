"""Window functions over tensors: one sort, then segmented passes.

The PyTorch counterpart of ``sail_tpu/ops/window.py``. One sort by
(partition keys, order keys) gives every window of that key its row
order. Where the keys' K3 bits, less each key's least value, fit in 63
bits beside the dead-row bit and the null ranks, they are packed into one
int64 word a row (``window_pack``) and one stable ``torch.sort`` of it
gives the order; otherwise one stable pass a key (``lexsort_keys``). K8
(``window_bounds``) then marks, for each sorted position, its segment's
and its peer group's first and last positions and its dense rank, in two
passes over the keys in sorted order: the sort's own sorted word, or each
key gathered into sorted order once. The window functions read those
bounds:

- K9 (``window_ranks``): the rank family, each output selected by the
  caller, in one elementwise pass;
- K10 (``window_scan``, ``window_frame``): segmented scans (sum, count,
  min, max; forward or backward) and the frame evaluation of sum, count,
  avg and the running extremes;
- K11 (``window_extreme``): MIN/MAX, and float SUM/AVG, over ROWS
  frames whose two offsets are finite;
- lag and lead: the return to row order itself, reading each sorted
  value at its shifted position (``window_unpermute`` with a ``Shift``);
  nth_value, first and last: torch reads at the frame bounds.

Every window function works in sorted order, as the reference's do. The
context's int32 ``inv_perm`` is built once (``window_inverse``). A value
column and its validity go into sorted order once per context
(``window_gather``, a scatter from row order through ``inv_perm``,
cached by ``WindowContext.sorted_values``); the scans, frames, extremes,
ranks and lag/lead/nth/first/last read and write contiguous sorted
arrays, and each output goes back to row order in one pass, as the
reference's ``_unsort`` does: a scatter through perm of K10's and K11's
records, of a value column and its validity, or of lag/lead's shifted
reads (``window_unpermute``; K9 gathers its records of one word an
output through ``inv_perm``). The inverse, the gather and the unpermute
are one engine on the card, a two-pass partitioned scatter
(csrc/window_perm.cu). Every row is written: dead rows (``sel`` false;
they sort last) get 0, invalid where the output has a validity.

Each kernel's wrapper takes the ``*_plain`` version for a CPU tensor; a
CUDA tensor launches the kernel or raises. Each keeps a ``.launches``
count. The live-row count stays on the device; the sort reads its keys'
extremes to the host, once a context.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import csrc
from ..columnar.batch import Column
from .sort import (MAX_KEYS, PACK_BITS, Key, PackLayout,  # noqa: F401
                   _check_rows, _contiguous, _ptr, lexsort_keys, order_keys,
                   pack_layout, window_pack, window_pack_plain)

# kernels' limits (window.cuh: kMaxKeys, in ops/sort.py, kTile;
# window_scan.cu: kScanTile; window_extreme.cu: kNarrowMax)
TILE = 1024
SCAN_TILE = 2048
NARROW_MAX = 1025

_RANKS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
          "ntile")
_SCAN_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
_FRAME_FNS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 3}
_EXTREME_FNS = {"max": 0, "min": 1, "sum": 2, "avg": 3}
# value types the scan and extreme kernels read (window.cuh: DType)
_VALUE_TYPES = {torch.int32: 1, torch.int64: 2, torch.float32: 3,
                torch.float64: 4}


class WindowContext:
    """Sorted row order + segment and peer-group bounds, shared by all
    windows with the same (partition_by, order_by). Positions are sorted
    positions; the bounds are int32[n]. Peer groups are those of the order
    keys the context was built with."""

    def __init__(self, perm, n_live, seg_start, seg_end, peer_start,
                 peer_end, dense, packed: bool = False,
                 inv_perm: Optional[torch.Tensor] = None):
        self.perm = perm              # int64[n] sorted order, live rows first
        self.packed = packed          # sorted by one packed word (K8's input)
        self.n_live = n_live          # 0-d int64: the live rows (on device)
        self.seg_start = seg_start    # first position of the row's segment
        self.seg_end = seg_end        # last (live) position of its segment
        self.peer_start = peer_start  # first position of its peer group
        self.peer_end = peer_end      # last position of its peer group
        self.dense = dense            # peer groups of its segment up to it
        self._counts: Dict[int, tuple] = {}  # id(validity) → (it, its scan)
        self._sorted: Dict[int, tuple] = {}  # id(column) → (it, sorted)
        self._inv_perm = inv_perm

    @property
    def alive(self) -> torch.Tensor:
        """bool[n]: sorted position i holds a live row."""
        return _positions(self.perm) < self.n_live

    @property
    def seg_len(self) -> torch.Tensor:
        return torch.clamp(self.seg_end - self.seg_start + 1, min=0)

    @property
    def pos(self) -> torch.Tensor:
        """0-based position of each sorted row in its segment."""
        return (_positions(self.perm) - self.seg_start).to(torch.int32)

    @property
    def inv_perm(self) -> torch.Tensor:
        """int32[n]: the sorted position of each live row, -1 for a dead
        row (``window_inverse``), built once, for ``window_unpermute``."""
        if self._inv_perm is None:
            self._inv_perm = window_inverse(self.perm, self.n_live)
        return self._inv_perm

    def _cached(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        hit = None if t is None else self._sorted.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else None

    def sorted_values(self, vals: Optional[torch.Tensor],
                      valid: Optional[torch.Tensor]):
        """(vals_s, valid_s): a value column and its validity (row order;
        either may be None) in sorted order, the form K10 and K11 read.
        Each tensor is gathered once per context (one ``window_gather``
        through ``inv_perm`` for what is not cached yet) and kept, by
        identity, as long as the context lives."""
        todo = [t if t is not None and self._cached(t) is None else None
                for t in (vals, valid)]
        if todo[0] is not None or todo[1] is not None:
            for t, s in zip(todo, window_gather(self.inv_perm, *todo)):
                if t is not None:
                    self._sorted[id(t)] = (t, s)
        return self._cached(vals), self._cached(valid)

    def count_scan(self, valid: Optional[torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """K10's count scan of ``valid`` (row order) in sorted order, made
        once per validity; None when every live row counts."""
        if valid is None:
            return None
        hit = self._counts.get(id(valid))
        if hit is None or hit[0] is not valid:
            _, valid_s = self.sorted_values(None, valid)
            hit = (valid, window_scan(self, None, valid_s, "count"))
            self._counts[id(valid)] = hit
        return hit[1]


def _positions(like: torch.Tensor) -> torch.Tensor:
    return torch.arange(like.shape[0], dtype=torch.int64, device=like.device)


def _scatter(perm: torch.Tensor, sorted_vals: torch.Tensor) -> torch.Tensor:
    """out[perm[i]] = sorted_vals[i]."""
    out = torch.empty_like(sorted_vals)
    out[perm] = sorted_vals
    return out


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t contiguous from a 16 B-aligned address (K10's scan loads 16 B at
    a time); a view that starts elsewhere is copied."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_n_live(name: str, n_live: torch.Tensor, dev) -> torch.Tensor:
    if n_live.dtype != torch.int64 or n_live.numel() != 1 or \
            n_live.device != dev:
        raise TypeError(f"{name}: n_live must be one int64 on {dev}, got "
                        f"{n_live.dtype}{tuple(n_live.shape)} on "
                        f"{n_live.device}")
    return n_live.reshape(1).contiguous()


# ---------------------------------------------------------------------------
# the context's sort and K8: segment and peer-group bounds
# ---------------------------------------------------------------------------

# K8's tile (window_bounds.cu: kBTile)
BOUNDS_TILE = 2048

# a word K8 reads in sorted order: (int64 word, its partition mask as a
# signed int64, its validity or None)
Word = Tuple[torch.Tensor, int, Optional[torch.Tensor]]


class SortedKeys(NamedTuple):
    """The window's sort (``sort_window_keys``): perm, K8's words in sorted
    order, whether the keys were packed, and the inverse permutation where
    the sort built one (the general path), else None."""
    perm: torch.Tensor
    words: List[Word]
    packed: bool
    inv_perm: Optional[torch.Tensor]


def sort_window_keys(keys: Sequence[Key], n_part: int, sel: torch.Tensor,
                     n_live: torch.Tensor, packed: Optional[bool] = None
                     ) -> SortedKeys:
    """The window's sort and K8's inputs in sorted order. ``keys`` as for
    ``pack_layout``.

    Where they fit in one word (``pack_layout``; ``packed`` True insists,
    False refuses): the pack pass and one stable ``torch.sort`` of the
    word, whose indices are perm and whose values are K8's one word, with
    the mask of the dead bit and the partition fields. Otherwise
    ``lexsort_keys`` (one stable pass a key, a validity and the dead rows),
    the inverse permutation (``window_inverse``), and each key with its
    validity gathered into sorted order once through it (``window_gather``),
    masked all ones (a partition key) or 0. Both give one perm: rows by
    (dead, each key's null rank and bits), ties in row order."""
    layout = None if packed is False else pack_layout(keys, n_part)
    if packed and layout is None:
        raise ValueError("sort_window_keys: the keys do not fit in one word")
    if layout is not None:
        srt = torch.sort(window_pack(keys, sel, layout), stable=True)
        return SortedKeys(srt.indices, [(srt.values, layout.part_mask, None)],
                          True, None)
    if not keys:
        raise ValueError("sort_window_keys: no keys to gather")
    perm = lexsort_keys(keys, sel)
    inv = window_inverse(perm, n_live)
    words = []
    for j, (key, valid, _) in enumerate(keys):
        key_s, valid_s = window_gather(inv, key, valid)
        words.append((key_s, -1 if j < n_part else 0, valid_s))
    return SortedKeys(perm, words, False, inv)


def window_bounds_plain(n_live: torch.Tensor, words: Sequence[Word]
                        ) -> Tuple[torch.Tensor, ...]:
    """(seg_start, seg_end, peer_start, peer_end, dense), int32[n] over
    sorted positions, from ``words`` in sorted order. Over the live
    prefix (i < n_live): a segment starts where a word's masked bits
    differ from the previous position's, or the validity of a word with a
    mask does; a peer group where a segment starts or any word or
    validity differs; ends are the next start - 1 (at most n_live - 1);
    dense counts the peer groups of the segment up to the row. A dead row
    i: seg_start = peer_start = peer_end = i, seg_end = n_live - 1 (an
    empty segment), dense 0."""
    first = words[0][0]
    n = first.shape[0]
    idx = _positions(first)
    live = idx < n_live
    new_seg = torch.zeros(n, dtype=torch.bool, device=first.device)
    new_peer = torch.zeros_like(new_seg)
    for word, mask, valid in words:
        x = word[1:] ^ word[:-1]
        new_seg[1:] |= (x & mask) != 0
        new_peer[1:] |= x != 0
        if valid is not None:
            vd = valid[1:] != valid[:-1]
            new_peer[1:] |= vd
            if mask:
                new_seg[1:] |= vd
    new_seg[:1] = True
    new_peer = (new_seg | new_peer) & live
    new_seg &= live
    big = torch.full_like(idx, n)

    def starts(flags):
        return torch.cummax(torch.where(flags, idx, 0), 0).values

    def ends(flags):
        # the next start after i, minus 1; n_live - 1 after the last
        nxt = torch.where(flags, idx, big)
        nxt = torch.cat([nxt[1:], big[:1]])
        nxt = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
        return torch.minimum(nxt - 1, n_live - 1)

    seg_start, peer_start = starts(new_seg), starts(new_peer)
    seg_end, peer_end = ends(new_seg), ends(new_peer)
    cnt = torch.cumsum(new_peer.to(torch.int64), 0)
    dense = cnt - cnt[seg_start] + 1
    dead_end = (n_live - 1).expand(n)
    out = (torch.where(live, seg_start, idx),
           torch.where(live, seg_end, dead_end),
           torch.where(live, peer_start, idx),
           torch.where(live, peer_end, idx),
           torch.where(live, dense, 0))
    return tuple(t.to(torch.int32) for t in out)


def window_bounds(n_live: torch.Tensor, words: Sequence[Word]
                  ) -> Tuple[torch.Tensor, ...]:
    """K8: ``window_bounds_plain`` as a kernel on the card.

    Replaces the segment and peer-group arithmetic of
    ``sail_tpu/ops/window.py`` ``build_window_context`` (:52-78),
    ``_peer_group_start`` and ``peer_group_end``; the kernel's source
    (csrc/window_bounds.cu) states its bound and design. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (two
    single-pass scans) or raises."""
    if not words or len(words) > MAX_KEYS:
        raise TypeError(f"window_bounds: 1 to {MAX_KEYS} words, got "
                        f"{len(words)}")
    first = words[0][0]
    if first.device.type == "cpu":
        return window_bounds_plain(n_live, words)
    n, dev = first.shape[0], first.device
    n_live = _check_n_live("window_bounds", n_live, dev)
    words = [(_contiguous(w), mask, _contiguous(v)) for w, mask, v in words]
    for w, mask, v in words:
        if w.dtype != torch.int64 or (v is not None and v.dtype != torch.bool) \
                or not -(1 << 63) <= mask < (1 << 63):
            raise TypeError("window_bounds: int64 words with signed int64 "
                            "masks and bool validities")
        _check_rows("window_bounds", n, dev, word=w, validity=v)
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in range(5))
    if n == 0:
        return outs
    tiles = -(-n // BOUNDS_TILE)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    scratch = torch.empty(2 + 12 * tiles, dtype=torch.int32, device=dev)
    word_ptrs = (ctypes.c_void_p * MAX_KEYS)(*[w.data_ptr()
                                               for w, _, _ in words])
    masks = (ctypes.c_ulonglong * MAX_KEYS)(*[m & ((1 << 64) - 1)
                                              for _, m, _ in words])
    valid_ptrs = (ctypes.c_void_p * MAX_KEYS)(*[_ptr(v) for _, _, v in words])
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_bounds.cu", "sail_window_bounds")(
            n_live.data_ptr(), n, ctypes.addressof(word_ptrs),
            ctypes.addressof(masks), ctypes.addressof(valid_ptrs), len(words),
            *[o.data_ptr() for o in outs], flags.data_ptr(),
            scratch.data_ptr(), csrc.stream_ptr(dev)), "window_bounds")
    window_bounds.launches += 1
    return outs


window_bounds.launches = 0


def build_window_context(partition_cols: Sequence[Column],
                         order_keys_: Sequence[Tuple], sel) -> WindowContext:
    """order_keys_: (data, validity, dtype, ascending, nulls_first) tuples.
    One sort (K3 keys, then ``sort_window_keys``: the pack pass and one
    stable ``torch.sort`` where the keys fit in one word, else one stable
    pass a key), then one K8 call over the sorted words."""
    keys = [(c.data, c.validity, True, None) for c in partition_cols]
    keys += [(d, v, asc, nf) for d, v, _dt, asc, nf in order_keys_]
    bits = [(order_keys(d, asc), v, asc if nf is None else nf)
            for d, v, asc, nf in keys]
    n_live = sel.sum()
    srt = sort_window_keys(bits, len(partition_cols), sel, n_live)
    return WindowContext(srt.perm, n_live, *window_bounds(n_live, srt.words),
                         packed=srt.packed, inv_perm=srt.inv_perm)


# ---------------------------------------------------------------------------
# K9: the rank family
# ---------------------------------------------------------------------------

_RANK_CODES = {name: code for code, name in enumerate(_RANKS)}
_FLOAT_RANKS = ("percent_rank", "cume_dist")


def _rank_values(ctx: WindowContext, wanted: Sequence[str], n_tiles: int
                 ) -> List[torch.Tensor]:
    """Each function of ``wanted`` at the sorted positions (int64, or
    float64 for percent_rank and cume_dist), 0 at the dead ones."""
    live = ctx.alive
    ss = ctx.seg_start.to(torch.int64)
    seg_len = ctx.seg_end.to(torch.int64) - ss + 1
    pos = _positions(ss) - ss
    out = []
    for name in wanted:
        if name == "row_number":
            v = pos + 1
        elif name == "rank":
            v = ctx.peer_start.to(torch.int64) - ss + 1
        elif name == "dense_rank":
            v = ctx.dense.to(torch.int64)
        elif name == "percent_rank":
            r = (ctx.peer_start.to(torch.int64) - ss).to(torch.float64)
            denom = torch.clamp(seg_len - 1, min=1).to(torch.float64)
            v = torch.where(seg_len > 1, r / denom, 0.0)
        elif name == "cume_dist":
            v = (ctx.peer_end.to(torch.int64) - ss + 1).to(torch.float64) \
                / torch.clamp(seg_len, min=1).to(torch.float64)
        elif name == "ntile":
            sl = torch.clamp(seg_len, min=1)
            base = sl // n_tiles
            rem = sl % n_tiles
            big = rem * (base + 1)  # the first `rem` tiles have base+1 rows
            tile = torch.where(pos < big,
                               pos // torch.clamp(base + 1, min=1),
                               rem + (pos - big) // torch.clamp(base, min=1))
            v = torch.clamp(tile, 0, n_tiles - 1) + 1
        else:
            raise ValueError(f"window_ranks: unknown rank function {name!r}")
        out.append(torch.where(live, v, 0))
    return out


def window_ranks_plain(ctx: WindowContext, wanted: Sequence[str],
                       n_tiles: int = 1) -> Dict[str, torch.Tensor]:
    """The rank functions in ``wanted`` (int64, or float64 for
    percent_rank and cume_dist), in row order; 0 at dead rows. Each is
    computed at the sorted positions, then goes to row order as K9's
    records: one int64 word an output (a float as its bits) a position,
    gathered through ``ctx.inv_perm``."""
    vals = _rank_values(ctx, wanted, n_tiles)
    if not vals:
        return {}
    recs = torch.stack([v.view(torch.int64) for v in vals], 1)
    inv = ctx.inv_perm.to(torch.int64)
    rows = torch.where((inv >= 0)[:, None], recs[torch.clamp(inv, min=0)], 0)
    return {w: rows[:, j].contiguous().view(v.dtype)
            for j, (w, v) in enumerate(zip(wanted, vals))}


def window_ranks(ctx: WindowContext, wanted: Sequence[str],
                 n_tiles: int = 1) -> Dict[str, torch.Tensor]:
    """K9: ``window_ranks_plain`` as one kernel launch for every function
    in ``wanted``, computed at the sorted positions into one record of an
    8 B word an output a position, and one unpermute pass through
    ``ctx.inv_perm`` (built here where the context has none yet).

    Replaces ``sail_tpu/ops/window.py`` ``row_number`` (:108), ``rank``
    (:112), ``dense_rank`` (:117), ``percent_rank`` (:137), ``cume_dist``
    (:144) and ``ntile`` (:156); csrc/window_ranks.cu states its bound.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels or raises."""
    bad = [w for w in wanted if w not in _RANKS]
    if bad or n_tiles < 1:
        raise ValueError(f"window_ranks: unknown {bad} or n_tiles "
                         f"{n_tiles}")
    perm = ctx.perm
    if perm.device.type == "cpu":
        return window_ranks_plain(ctx, wanted, n_tiles)
    n, dev = perm.shape[0], perm.device
    n_live = _check_n_live("window_ranks", ctx.n_live, dev)
    k = len(wanted)
    out = torch.empty((k, n), dtype=torch.int64, device=dev)
    if n and k:
        rec = torch.empty((n, k), dtype=torch.int64, device=dev)
        inv = ctx.inv_perm
        codes = (ctypes.c_int * k)(*[_RANK_CODES[w] for w in wanted])
        with torch.cuda.device(dev):
            csrc.check(csrc.entry("window_ranks.cu", "sail_window_ranks")(
                n_live.data_ptr(), n, ctx.seg_start.data_ptr(),
                ctx.seg_end.data_ptr(), ctx.peer_start.data_ptr(),
                ctx.peer_end.data_ptr(), ctx.dense.data_ptr(), n_tiles,
                ctypes.addressof(codes), k, rec.data_ptr(),
                csrc.grid_for(n, dev), csrc.stream_ptr(dev)), "window_ranks")
            csrc.check(csrc.entry("window_ranks.cu",
                                  "sail_window_ranks_unpermute")(
                inv.data_ptr(), n, rec.data_ptr(), k, out.data_ptr(),
                csrc.stream_ptr(dev)), "window_ranks")
        window_ranks.launches += 1
    return {w: out[j].view(torch.float64) if w in _FLOAT_RANKS else out[j]
            for j, w in enumerate(wanted)}


window_ranks.launches = 0


def row_number(ctx: WindowContext) -> torch.Tensor:
    return window_ranks(ctx, ("row_number",))["row_number"]


def rank(ctx: WindowContext, order_key_bits=None) -> torch.Tensor:
    """``order_key_bits`` keeps the reference's signature: the peer groups
    are the context's, which K8 drew from the same order keys."""
    return window_ranks(ctx, ("rank",))["rank"]


def dense_rank(ctx: WindowContext, order_key_bits=None) -> torch.Tensor:
    return window_ranks(ctx, ("dense_rank",))["dense_rank"]


def peer_group_end(ctx: WindowContext, order_key_bits=None) -> torch.Tensor:
    """Last sorted position of each row's peer group (for RANGE frames)."""
    return ctx.peer_end


def percent_rank(ctx: WindowContext, order_key_bits=None) -> torch.Tensor:
    return window_ranks(ctx, ("percent_rank",))["percent_rank"]


def cume_dist(ctx: WindowContext, order_key_bits=None) -> torch.Tensor:
    return window_ranks(ctx, ("cume_dist",))["cume_dist"]


def ntile(ctx: WindowContext, n_tiles: int) -> torch.Tensor:
    return window_ranks(ctx, ("ntile",), n_tiles)["ntile"]


# ---------------------------------------------------------------------------
# between row order and sorted order: the inverse, the gather, the unpermute
# ---------------------------------------------------------------------------

# a placing block's tile in shared memory, the inverse's, the gather's and
# the unpermute's (``_slot_bytes`` a position); csrc/window_perm.cu:
# kMaxTileBytes is the most a wrapper may ask. A bucket holds
# MOVE_CLUSTER tiles (kCluster).
MOVE_TILE_BYTES = 160 * 1024
MOVE_TILE_MAX = 200 * 1024
MOVE_CLUSTER = 8
# window_perm.cu: a tile holds 2^4 to 2^24 positions
_MOVE_BITS = (4, 24)


def _slot_bytes(width: int, valid: bool) -> int:
    """A placing block's tile bytes a position (window_perm.cu
    ``slot_bytes``): a value of ``width`` bytes (0: none), a validity, or
    both side by side in twice the value's width."""
    return 2 * width if width and valid else width or 1


def _move_scratch(n: int, row_bytes: int, entry_bytes: int,
                  tile_bytes: int, dev) -> Tuple[int, torch.Tensor]:
    """(bits, scratch) of one partitioned scatter over n positions: a
    placing block's tile holds 2^bits of them, the most that fit in
    ``tile_bytes`` at ``row_bytes`` a position (the value and the
    validity), and a bucket MOVE_CLUSTER tiles; the scratch holds a cursor
    a bucket (padded to 256 B), then each bucket's run of staging records
    of ``entry_bytes``."""
    if not 16 <= tile_bytes <= MOVE_TILE_MAX:
        raise ValueError(f"a move's tile takes 16 to {MOVE_TILE_MAX} "
                         f"bytes, got {tile_bytes}")
    bits = min(max((tile_bytes // row_bytes).bit_length() - 1,
                   _MOVE_BITS[0]), _MOVE_BITS[1])
    bucket = MOVE_CLUSTER << bits
    buckets = -(-n // bucket)
    scratch = torch.empty(-(-4 * buckets // 256) * 256
                          + buckets * bucket * entry_bytes,
                          dtype=torch.uint8, device=dev)
    return bits, scratch


def window_inverse_plain(perm: torch.Tensor, n_live: torch.Tensor
                         ) -> torch.Tensor:
    """int32 inv: inv[perm[i]] = i for the live positions i < n_live, -1
    for the dead rows."""
    idx = _positions(perm)
    inv = torch.full_like(perm, -1, dtype=torch.int32)
    inv[perm] = torch.where(idx < n_live, idx, -1).to(torch.int32)
    return inv


def window_inverse(perm: torch.Tensor, n_live: torch.Tensor,
                   tile_bytes: int = MOVE_TILE_BYTES) -> torch.Tensor:
    """``window_inverse_plain`` as a two-pass partitioned scatter: the
    live positions binned by destination into buckets of consecutive
    rows, then each bucket placed in the shared memory of a cluster of
    blocks, a tile each, and stored in order.

    Replaces ``sail_tpu/ops/window.py`` ``build_window_context``'s
    ``inv_perm`` (:78); csrc/window_perm.cu states its bound and design.
    ``tile_bytes``: a placing block's tile (4 B a row). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or
    raises."""
    n, dev = perm.shape[0], perm.device
    if n > torch.iinfo(torch.int32).max:
        raise ValueError(f"window_inverse: {n} rows do not fit int32")
    if dev.type == "cpu":
        return window_inverse_plain(perm, n_live)
    if perm.dtype != torch.int64:
        raise TypeError("window_inverse: an int64 perm")
    n_live = _check_n_live("window_inverse", n_live, dev)
    perm = perm.contiguous()
    inv = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return inv
    bits, scratch = _move_scratch(n, 4, 8, tile_bytes, dev)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_perm.cu", "sail_window_inverse")(
            perm.data_ptr(), n_live.data_ptr(), n, inv.data_ptr(), bits,
            scratch.data_ptr(), scratch.numel(), csrc.stream_ptr(dev)),
            "window_inverse")
    window_inverse.launches += 1
    return inv


window_inverse.launches = 0


def window_gather_plain(inv: torch.Tensor, vals: Optional[torch.Tensor],
                        valid: Optional[torch.Tensor]):
    """(vals_s, valid_s) in sorted order: vals_s[inv[r]] = vals[r] for the
    live rows r (inv[r] >= 0), 0 and false at the other positions; None
    where not given. With inv the context's ``inv_perm``, vals_s[i] =
    vals[perm[i]] at the live positions."""
    n = inv.shape[0]
    dest = torch.where(inv >= 0, inv.to(torch.int64), n)  # n: a dead row

    def scatter(t):
        out = torch.zeros(n + 1, dtype=t.dtype, device=t.device)
        out[dest] = t
        return out[:n]
    return tuple(None if t is None else scatter(t) for t in (vals, valid))


def window_gather(inv: torch.Tensor, vals: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor],
                  tile_bytes: int = MOVE_TILE_BYTES):
    """``window_gather_plain`` on the inverse's engine, a two-pass
    partitioned scatter that reads the rows in order, value and validity
    moved together.

    Replaces ``sail_tpu/ops/window.py`` ``framed_agg``'s value gathers
    (:219-220) and those of ``shift``, ``nth`` and first/last (:169-204,
    :280-288); csrc/window_perm.cu states its bound. Values of 1, 2, 4 or
    8 bytes; ``tile_bytes``: a placing block's tile (value and validity a
    position). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernels or raises."""
    if inv.device.type == "cpu":
        return window_gather_plain(inv, vals, valid)
    n, dev = inv.shape[0], inv.device
    if inv.dtype != torch.int32 or (vals is not None and vals.element_size()
                                    not in (1, 2, 4, 8)) \
            or (valid is not None and valid.dtype != torch.bool):
        raise TypeError("window_gather: an int32 inv_perm, values of 1, 2, "
                        "4 or 8 bytes and a bool validity")
    _check_rows("window_gather", n, dev, inv=inv, vals=vals, valid=valid)
    inv, vals, valid = (_contiguous(t) for t in (inv, vals, valid))
    vals_s = None if vals is None else torch.empty_like(vals)
    valid_s = None if valid is None else torch.empty_like(valid)
    if n == 0 or (vals is None and valid is None):
        return vals_s, valid_s
    width = 0 if vals is None else vals.element_size()
    bits, scratch = _move_scratch(n, _slot_bytes(width, valid is not None),
                                  16 if width == 8 else 8, tile_bytes, dev)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_perm.cu", "sail_window_gather")(
            inv.data_ptr(), n, _ptr(vals), width, _ptr(valid),
            _ptr(vals_s), _ptr(valid_s), bits, scratch.data_ptr(),
            scratch.numel(), csrc.stream_ptr(dev)), "window_gather")
    window_gather.launches += 1
    return vals_s, valid_s


window_gather.launches = 0


# a record's words read as integers (its ok word is 0 or 1)
_WORDS = {4: torch.int32, 8: torch.int64}
# window_perm.cu's sources of the unpermute (Kind)
_UNPERMUTE_KINDS = {"records": 0, "arrays": 1, "shift": 2}


class Shift(NamedTuple):
    """lag/lead as ``window_unpermute``'s source: sorted position i takes
    the value at i - ``offset`` (lag looks back, offset > 0; lead forward)
    where that position is in the row's segment, else ``default`` (valid)
    or 0 and invalid where there is none."""
    offset: int
    default: object = None


def pack_records(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """[n, 2] records {value, ok} of 4- or 8-byte values, as K10's frame
    evaluation and K11 write them in sorted order (window.cuh ``Rec``)."""
    words = torch.stack([vals.view(_WORDS[vals.element_size()]),
                         ok.to(_WORDS[vals.element_size()])], 1)
    return words.view(vals.dtype)


def _shift_fill(dtype: torch.dtype, default) -> torch.Tensor:
    """The default as a 0-d tensor of ``dtype`` on the host (0 where
    None), cast through the 4- or 8-byte type a narrower value widens to
    (int32, float32), as a record of it would hold it."""
    if default is None:
        return torch.zeros((), dtype=dtype)
    wide = dtype
    if torch.empty((), dtype=dtype).element_size() < 4:
        wide = torch.float32 if dtype.is_floating_point else torch.int32
    return torch.full((), default, dtype=wide).to(dtype)


def _shifted(t: torch.Tensor, offset: int, fill) -> torch.Tensor:
    """s[i] = t[i - offset] where 0 <= i - offset < n, else ``fill``."""
    n = t.shape[0]
    k = min(abs(offset), n)
    pad = t.new_full((k,), fill)
    return torch.cat((pad, t[:n - k]) if offset >= 0 else (t[k:], pad))


def _shift_plain(ctx: WindowContext, vals: torch.Tensor,
                 valid: Optional[torch.Tensor], shift: Shift):
    """(data, ok) in sorted order of ``shift`` over the sorted ``vals`` and
    ``valid`` (None: all valid): the reference's ``shift``
    (sail_tpu/ops/window.py:169), its default of the value's type."""
    in_seg = _shifted(ctx.seg_start, shift.offset, -1) == ctx.seg_start
    fill = _shift_fill(vals.dtype, shift.default).to(vals.device)
    data = torch.where(in_seg, _shifted(vals, shift.offset, 0), fill)
    if valid is not None:
        ok = _shifted(valid, shift.offset, False)
        ok = ok & in_seg if shift.default is None else ok | ~in_seg
    else:
        ok = in_seg if shift.default is None else torch.ones_like(in_seg)
    return data, ok


def window_unpermute_plain(ctx: WindowContext, src: torch.Tensor,
                           ok: Optional[torch.Tensor] = None,
                           shift: Optional[Shift] = None):
    """(out, validity) in row order from a source in sorted order: [n, 2]
    records {value, ok} (``pack_records``); n values and their validity
    ``ok`` (None: no validity, and None comes back); or, with ``shift``,
    lag/lead over the sorted values ``src`` and validity ``ok`` (None: all
    valid). A dead row gets 0 and invalid."""
    if shift is not None:
        src, ok = _shift_plain(ctx, src, ok, shift)
    elif src.dim() == 2:
        words = src.view(_WORDS[src.element_size()])
        src, ok = src[:, 0], words[:, 1] != 0
    live = ctx.alive
    out = _scatter(ctx.perm, torch.where(live, src, src.new_zeros(())))
    return out, None if ok is None else _scatter(ctx.perm, ok & live)


def window_unpermute(ctx: WindowContext, src: torch.Tensor,
                     ok: Optional[torch.Tensor] = None,
                     shift: Optional[Shift] = None,
                     tile_bytes: int = MOVE_TILE_BYTES):
    """``window_unpermute_plain`` as one partitioned scatter through perm
    on the inverse's engine: the live sorted positions read in order, each
    value with its validity binned by its row, then each bucket placed in
    a cluster's shared memory and stored in order, value and validity
    columns each written once.

    Replaces ``sail_tpu/ops/window.py`` ``_unsort`` (:82) for K10's frame
    evaluation, K11, nth_value and first/last, and with a ``Shift``
    ``shift`` (:169) whole; csrc/window_perm.cu states its bound. Records
    of 4- or 8-byte values; value columns of 1, 2, 4 or 8 bytes.
    ``tile_bytes``: a placing block's tile (value and validity a row). A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises."""
    perm = ctx.perm
    if perm.device.type == "cpu":
        return window_unpermute_plain(ctx, src, ok, shift)
    n, dev = perm.shape[0], perm.device
    records = src.dim() == 2
    width = src.element_size()
    if records:
        kind = "records"
        bad = width not in _WORDS or src.shape[1] != 2 or ok is not None \
            or shift is not None
    else:
        kind = "arrays" if shift is None else "shift"
        bad = src.dim() != 1 or width not in (1, 2, 4, 8) or \
            (ok is not None and ok.dtype != torch.bool)
    if bad or src.shape[0] != n or src.device != dev:
        raise TypeError(f"window_unpermute: {n} values of 1, 2, 4 or 8 bytes "
                        f"with a bool validity, or [n, 2] records of 4 or 8 "
                        f"bytes, on {dev}; got {src.dtype}{tuple(src.shape)} "
                        f"on {src.device}")
    _check_rows("window_unpermute", n, dev, ok=ok)
    n_live = _check_n_live("window_unpermute", ctx.n_live, dev)
    src, ok = _contiguous(src), _contiguous(ok)
    seg_start, default_bits = None, 0
    if shift is not None:
        seg_start = ctx.seg_start
        if seg_start.dtype != torch.int32:
            raise TypeError("window_unpermute: an int32 seg_start")
        seg_start = _contiguous(seg_start)
        fill = _shift_fill(src.dtype, shift.default).reshape(1)
        default_bits = int(fill.view({1: torch.uint8, 2: torch.int16,
                                      4: torch.int32, 8: torch.int64}[width])
                           [0]) & ((1 << (8 * width)) - 1)
    out = torch.empty(n, dtype=src.dtype, device=dev)
    with_ok = records or ok is not None or shift is not None
    ok_out = torch.empty(n, dtype=torch.bool, device=dev) if with_ok else None
    if n == 0:
        return out, ok_out
    bits, scratch = _move_scratch(n, _slot_bytes(width, with_ok),
                                  16 if width == 8 else 8, tile_bytes, dev)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_perm.cu", "sail_window_unpermute")(
            perm.data_ptr(), n_live.data_ptr(), n, _UNPERMUTE_KINDS[kind],
            src.data_ptr(), width, _ptr(ok), _ptr(seg_start),
            0 if shift is None else shift.offset,
            int(shift is not None and shift.default is not None),
            default_bits, out.data_ptr(), _ptr(ok_out), bits,
            scratch.data_ptr(), scratch.numel(), csrc.stream_ptr(dev)),
            "window_unpermute")
    window_unpermute.launches += 1
    return out, ok_out


window_unpermute.launches = 0


# ---------------------------------------------------------------------------
# lag/lead, nth_value, first and last: in sorted order, then one unpermute
# ---------------------------------------------------------------------------

def _at(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """t[src], src clamped into t (sorted positions)."""
    return t[torch.clamp(src, 0, max(t.shape[0] - 1, 0))]


def shift(ctx: WindowContext, value: Column, offset: int, default=None):
    """lag (offset > 0 looks back) / lead (negative looks forward): in
    sorted order, the value ``offset`` positions back where that position
    is in the row's segment (its segment start is the row's), else the
    default (valid) or 0 and invalid; then to row order.

    Replaces ``sail_tpu/ops/window.py`` ``shift`` (:169): the value
    gathered into sorted order once per context (``ctx.sorted_values``),
    then one ``window_unpermute`` that reads it at the shifted positions
    (``Shift``)."""
    vals, valid = ctx.sorted_values(value.data, value.validity)
    return window_unpermute(ctx, vals, valid, Shift(offset, default))


def nth(ctx: WindowContext, value: Column, n_th: int, peer_end=None,
        lower: Optional[int] = None, upper: Optional[int] = 0):
    """nth_value: the value at the n-th row of each row's frame [lower,
    upper] (``framed_agg``'s frames: None unbounded, ``peer_end`` with
    upper 0 ends a RANGE frame at the current row's last peer; by default
    the partition start to the current row), NULL where the frame holds
    fewer than n rows. In sorted order, read at the frame's first
    position + n - 1, then to row order.

    Replaces ``sail_tpu/ops/window.py`` ``nth`` (:188), in its shape; the
    reference counts from the partition start whatever the frame."""
    vals, valid = ctx.sorted_values(value.data, value.validity)
    lo, hi = _frame_bounds(ctx, lower, upper, peer_end)
    src = lo + (n_th - 1)
    return _read_sorted(ctx, vals, valid, src, src <= hi)


def _read_sorted(ctx: WindowContext, vals: torch.Tensor,
                 valid: Optional[torch.Tensor], src: torch.Tensor,
                 ok: torch.Tensor):
    """(data, validity) in row order of the sorted values read at sorted
    positions ``src`` where ``ok``; 0 and invalid elsewhere: the value
    column and its validity unpermuted together."""
    data = torch.where(ok, _at(vals, src), vals.new_zeros(()))
    if valid is not None:
        ok = ok & _at(valid, src)
    return window_unpermute(ctx, data, ok)


# ---------------------------------------------------------------------------
# K10: segmented scans and the frame evaluation
# ---------------------------------------------------------------------------

def _identity(dtype: torch.dtype, op: str):
    if op in ("sum", "count"):
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _hs_scan(vals: torch.Tensor, start: torch.Tensor, op: str
             ) -> torch.Tensor:
    """out[i] = op over vals[start[i]..i] (start[i] > i: vals[i] alone):
    a Hillis–Steele doubling scan, log2(n) passes."""
    n = vals.shape[0]
    idx = _positions(vals)
    ident = torch.full_like(vals, _identity(vals.dtype, op))
    out = vals
    step = 1
    while step < n:
        prev = torch.where(idx - step >= start, torch.roll(out, step), ident)
        if op in ("sum", "count"):
            out = out + prev
        else:
            out = torch.minimum(out, prev) if op == "min" else \
                torch.maximum(out, prev)
        step *= 2
    return out


def _scan_values(ctx: WindowContext, vals: Optional[torch.Tensor],
                 valid: Optional[torch.Tensor], op: str) -> torch.Tensor:
    """The scan's inputs (sorted order): the values, the identity where a
    row is dead or invalid."""
    mask = ctx.alive
    if valid is not None:
        mask = mask & valid
    if op == "count":
        return mask.to(torch.int64)
    v = vals
    if op == "sum":
        v = v.to(torch.float64 if v.is_floating_point() else torch.int64)
    return torch.where(mask, v, torch.full_like(v, _identity(v.dtype, op)))


def window_scan_plain(ctx: WindowContext, vals: Optional[torch.Tensor],
                      valid: Optional[torch.Tensor], op: str,
                      backward: bool = False) -> torch.Tensor:
    """Segmented inclusive scan in sorted order of ``vals`` (sorted
    order, ``ctx.sorted_values``; None for count) over live rows where
    ``valid`` (sorted order): forward, out[i] = op over [seg_start[i],
    i]; backward, over [i, seg_end[i]]. sum is int64 (ints, unscaled
    decimals) or float64; count int64; min/max keep the value type (NaN
    propagates). Dead rows hold the identity."""
    v = _scan_values(ctx, vals, valid, op)
    if not backward:
        return _hs_scan(v, ctx.seg_start.to(torch.int64), op)
    n = v.shape[0]
    # reversed, a segment [s, e] becomes [n-1-e, n-1-s]; a dead row's
    # reversed start lies past it, so it holds its identity
    start = (n - 1 - ctx.seg_end.to(torch.int64)).flip(0)
    return _hs_scan(v.flip(0), start, op).flip(0)


def window_scan(ctx: WindowContext, vals: Optional[torch.Tensor],
                valid: Optional[torch.Tensor], op: str,
                backward: bool = False) -> torch.Tensor:
    """K10's scan: ``window_scan_plain`` as a kernel on the card.

    Replaces ``sail_tpu/ops/window.py`` ``_segmented_scan`` (:328), the
    global ``cumsum`` of ``framed_agg`` (:207) and ``_segment_count``
    (:321); csrc/window_scan.cu states its bound and design. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (one
    single-pass scan with decoupled look-back) or raises."""
    perm = ctx.perm
    if perm.device.type == "cpu":
        return window_scan_plain(ctx, vals, valid, op, backward)
    n, dev = perm.shape[0], perm.device
    if op not in _SCAN_OPS or (vals is None) != (op == "count"):
        raise TypeError(f"window_scan: op {op!r} with "
                        f"{'no ' if vals is None else ''}values")
    n_live = _check_n_live("window_scan", ctx.n_live, dev)
    code = 0
    if vals is not None:
        code = _VALUE_TYPES.get(vals.dtype)
        if code is None:
            raise TypeError(f"window_scan: values of {vals.dtype}")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError("window_scan: the validity must be bool")
    _check_rows("window_scan", n, dev, vals=vals, valid=valid)
    vals, valid = _aligned(vals), _aligned(valid)
    bound = _aligned(ctx.seg_end if backward else ctx.seg_start)
    if op == "count":
        out_dtype = torch.int64
    elif op == "sum":
        out_dtype = torch.float64 if vals.is_floating_point() else torch.int64
    else:
        out_dtype = vals.dtype
    out = torch.empty(n, dtype=out_dtype, device=dev)
    if n == 0:
        return out
    scratch = torch.empty(3 * -(-n // SCAN_TILE) + 1, dtype=torch.int64,
                          device=dev)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_scan.cu", "sail_window_scan")(
            n_live.data_ptr(), n, _ptr(vals), _ptr(valid), bound.data_ptr(),
            code, _SCAN_OPS[op], int(backward), out.data_ptr(),
            scratch.data_ptr(), csrc.stream_ptr(dev)), "window_scan")
    window_scan.launches += 1
    return out


window_scan.launches = 0


def _frame_bounds(ctx: WindowContext, lower: Optional[int],
                  upper: Optional[int], peer_end=None):
    """(lo, hi) sorted positions of each row's frame, clipped to its
    segment; peer_end (with upper 0) ends the frame at the last peer."""
    idx = _positions(ctx.perm)
    ss = ctx.seg_start.to(torch.int64)
    se = ctx.seg_end.to(torch.int64)
    lo = ss if lower is None else torch.maximum(idx + lower, ss)
    if peer_end is not None and upper == 0:
        hi = torch.minimum(peer_end.to(torch.int64), se)
    else:
        hi = se if upper is None else torch.minimum(idx + upper, se)
    return lo, hi


def _range_of(prefix: torch.Tensor, lo, hi, ss) -> torch.Tensor:
    """prefix[hi] - prefix[lo - 1] inside a segment (prefix restarts at
    each segment start)."""
    n = prefix.shape[0]
    top = max(n - 1, 0)
    before = prefix[torch.clamp(lo - 1, 0, top)]
    return prefix[torch.clamp(hi, 0, top)] - torch.where(
        lo > ss, before, torch.zeros_like(before))


def _range_back(suffix: torch.Tensor, lo, hi, se) -> torch.Tensor:
    """suffix[lo] - suffix[hi + 1] inside a segment (a backward scan,
    restarting at each segment end)."""
    n = suffix.shape[0]
    top = max(n - 1, 0)
    after = suffix[torch.clamp(hi + 1, 0, top)]
    return suffix[torch.clamp(lo, 0, top)] - torch.where(
        hi < se, after, torch.zeros_like(after))


def window_frame_plain(ctx: WindowContext, scan: Optional[torch.Tensor],
                       counts: Optional[torch.Tensor], fn: str,
                       lower: Optional[int], upper: Optional[int],
                       peer_end=None, backward: bool = False):
    """(out, validity) in row order of ``fn`` over each row's frame, from
    K10's scans (sorted order): sum, avg from the sum scan (and count), as
    the difference of the scan at the frame's two ends; count from the count
    scan (None: every live row counts); min, max from the running extreme
    at hi (forward scan, frame from the segment start) or at lo (backward
    scan, frame to the segment end). validity: the frame holds a counted
    row (None for count). 0, invalid at dead rows.

    The difference is exact for integer sums. For a float sum it reads
    the scan outside the frame, where a NaN or an infinity would make it
    NaN: ``framed_agg`` gives it only frames that start at the segment
    start (forward) or end at the segment end (backward)."""
    lo, hi = _frame_bounds(ctx, lower, upper, peer_end)
    ss = ctx.seg_start.to(torch.int64)
    live = ctx.alive
    empty = (hi < lo) | ~live
    cnt = hi - lo + 1 if counts is None else _range_of(counts, lo, hi, ss)
    cnt = torch.where(empty, 0, cnt)
    ok = cnt > 0
    if fn == "count":
        return _scatter(ctx.perm, cnt), None
    if fn in ("sum", "avg"):
        out = _range_back(scan, lo, hi, ctx.seg_end.to(torch.int64)) \
            if backward else _range_of(scan, lo, hi, ss)
        if fn == "avg":
            out = out.to(torch.float64) / torch.clamp(cnt, min=1)
    else:
        at = lo if backward else hi
        out = scan[torch.clamp(at, 0, max(scan.shape[0] - 1, 0))]
    out = torch.where(ok, out, torch.zeros_like(out))
    return _scatter(ctx.perm, out), _scatter(ctx.perm, ok)


def window_frame(ctx: WindowContext, scan: Optional[torch.Tensor],
                 counts: Optional[torch.Tensor], fn: str,
                 lower: Optional[int], upper: Optional[int],
                 peer_end=None, backward: bool = False):
    """K10's frame evaluation: ``window_frame_plain`` as a kernel, which
    writes sorted order, and ``window_unpermute`` back to row order.

    Replaces the frame arithmetic of ``sail_tpu/ops/window.py``
    ``framed_agg`` (:207); csrc/window_scan.cu states its bound. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    perm = ctx.perm
    if perm.device.type == "cpu":
        return window_frame_plain(ctx, scan, counts, fn, lower, upper,
                                  peer_end, backward)
    n, dev = perm.shape[0], perm.device
    if fn not in _FRAME_FNS or (scan is None) != (fn == "count"):
        raise TypeError(f"window_frame: {fn!r} with "
                        f"{'no ' if scan is None else ''}scan")
    n_live = _check_n_live("window_frame", ctx.n_live, dev)
    code = 0 if scan is None else _VALUE_TYPES.get(scan.dtype)
    if code is None or (counts is not None and counts.dtype != torch.int64):
        raise TypeError("window_frame: scans of int32, int64, float32 or "
                        "float64 and an int64 count scan")
    use_peer = peer_end is not None and upper == 0
    _check_rows("window_frame", n, dev, scan=scan, counts=counts,
                peer_end=peer_end if use_peer else None)
    scan, counts = _contiguous(scan), _contiguous(counts)
    peer_end = _contiguous(peer_end) if use_peer else None
    if fn == "count":
        recs = torch.empty(n, dtype=torch.int64, device=dev)
    else:
        recs = torch.empty((n, 2), dtype=torch.float64 if fn == "avg"
                           else scan.dtype, device=dev)
    if n == 0:
        return window_unpermute(ctx, recs)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_scan.cu", "sail_window_frame")(
            n_live.data_ptr(), n, ctx.seg_start.data_ptr(),
            ctx.seg_end.data_ptr(), _ptr(peer_end),
            _ptr(scan), _ptr(counts), code, _FRAME_FNS[fn], int(backward),
            0 if lower is None else lower, 0 if upper is None else upper,
            int(lower is not None), int(upper is not None), recs.data_ptr(),
            csrc.grid_for(n, dev), csrc.stream_ptr(dev)), "window_frame")
    window_frame.launches += 1
    return window_unpermute(ctx, recs)


window_frame.launches = 0


# ---------------------------------------------------------------------------
# K11: MIN/MAX and float SUM/AVG over ROWS frames with two finite offsets
# ---------------------------------------------------------------------------

def _range_extreme(vals, lo, hi, n: int, is_min: bool, fill):
    """Per-row extreme of vals[lo[i]..hi[i]] (sorted order) via a sparse
    table: st[k, i] = extreme(vals[i : i + 2^k]); a query of length m
    takes the two overlapping power-of-two blocks at lo and hi - 2^k + 1.
    Only the levels the longest query needs are built."""
    ex = torch.minimum if is_min else torch.maximum
    if n == 0:
        return vals
    top = n - 1
    lo_c = torch.clamp(lo, 0, top)
    hi_c = torch.clamp(hi, 0, top)
    length = torch.clamp(hi_c - lo_c + 1, min=1)
    levels = max(1, int(length.max()).bit_length())
    tables = [vals]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = tables[-1]
        shifted = torch.cat([prev[half:], torch.full(
            (min(half, n),), fill, dtype=prev.dtype, device=prev.device)])
        tables.append(ex(prev, shifted[:n]))
    st = torch.stack(tables)  # [levels, n]
    # floor(log2(length)), exact: the float estimate corrected both ways
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    k = k + ((torch.ones_like(k) << (k + 1)) <= length).to(torch.int64)
    k = k - ((torch.ones_like(k) << k) > length).to(torch.int64)
    k = torch.clamp(k, 0, levels - 1)
    block = torch.ones_like(k) << k
    a = st[k, lo_c]
    b = st[k, torch.clamp(hi_c - block + 1, 0, top)]
    return ex(a, b)


def _segment_count(valid, ctx: WindowContext, lo, hi, n: int):
    """Rows of [lo, hi] (sorted) where ``valid`` (sorted) holds."""
    ccnt = torch.cumsum(valid.to(torch.int64), 0)
    top = max(n - 1, 0)
    before = ccnt[torch.clamp(lo - 1, 0, top)]
    return ccnt[torch.clamp(hi, 0, top)] - torch.where(
        lo > 0, before, torch.zeros_like(before))


def _segmented_scan(vals, seg_start, is_min: bool):
    """Segmented running min/max over sorted values:
    out[i] = extreme(vals[seg_start[i]..i])."""
    return _hs_scan(vals, seg_start.to(torch.int64),
                    "min" if is_min else "max")


def _frame_sum(masked: torch.Tensor, lo, hi, lower: int, upper: int
               ) -> torch.Tensor:
    """Sum of masked[lo[i]..hi[i]] (sorted order; [lo, hi] within [i +
    lower, i + upper]), added in frame order: one pass an offset."""
    idx = _positions(masked)
    top = max(masked.shape[0] - 1, 0)
    out = torch.zeros_like(masked)
    for k in range(lower, upper + 1):
        p = idx + k
        take = (p >= lo) & (p <= hi)
        out = out + torch.where(take, masked[torch.clamp(p, 0, top)], 0.0)
    return out


def window_extreme_plain(ctx: WindowContext, vals: torch.Tensor,
                         valid: Optional[torch.Tensor],
                         counts: Optional[torch.Tensor], lower: int,
                         upper: int, fn: str):
    """(out, validity) in row order: ``fn`` of ``vals`` (sorted order,
    ``ctx.sorted_values``; ``valid`` too) over the ROWS frame [i + lower,
    i + upper] clipped to the row's segment. fn: "min", "max" (the value
    type; NaN propagates), or "sum", "avg" of float64 values (added over
    the frame alone, so a NaN or an infinity outside it does not reach
    it). Valid where the frame holds a counted row (``counts``: K10's
    count scan of ``valid``; None when every live row counts). 0, invalid
    at dead rows."""
    if fn not in _EXTREME_FNS or (fn in ("sum", "avg") and
                                  vals.dtype != torch.float64):
        raise TypeError(f"window_extreme: {fn!r} of {vals.dtype}")
    lo, hi = _frame_bounds(ctx, lower, upper)
    ss = ctx.seg_start.to(torch.int64)
    empty = (hi < lo) | ~ctx.alive
    cnt = hi - lo + 1 if counts is None else _range_of(counts, lo, hi, ss)
    ok = ~empty & (cnt > 0)
    if fn in ("min", "max"):
        masked = _scan_values(ctx, vals, valid, fn)
        out = _range_extreme(masked, lo, hi, masked.shape[0], fn == "min",
                             _identity(vals.dtype, fn))
    else:
        out = _frame_sum(_scan_values(ctx, vals, valid, "sum"), lo, hi,
                         lower, upper)
        if fn == "avg":
            out = out / torch.clamp(cnt, min=1)
    out = torch.where(ok, out, torch.zeros_like(out))
    return _scatter(ctx.perm, out), _scatter(ctx.perm, ok)


def window_extreme(ctx: WindowContext, vals: torch.Tensor,
                   valid: Optional[torch.Tensor],
                   counts: Optional[torch.Tensor], lower: int, upper: int,
                   fn: str):
    """K11: ``window_extreme_plain`` as a kernel on the card, which
    writes sorted order, and ``window_unpermute`` back to row order.

    Replaces ``sail_tpu/ops/window.py`` ``_range_extreme`` (:293), whose
    sparse table holds ceil(log2 n) + 1 levels of n values, and the
    prefix difference ``framed_agg`` (:207) takes of a float frame's sum;
    csrc/window_extreme.cu states its bound and design. Frames up to
    ``NARROW_MAX`` rows wide take one launch; wider ones two and 2n +
    n/1024 values of scratch; then the unpermute. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    perm = ctx.perm
    if perm.device.type == "cpu":
        return window_extreme_plain(ctx, vals, valid, counts, lower, upper,
                                    fn)
    n, dev = perm.shape[0], perm.device
    code = _VALUE_TYPES.get(vals.dtype)
    if code is None or (valid is not None and valid.dtype != torch.bool) \
            or (counts is not None and counts.dtype != torch.int64) \
            or fn not in _EXTREME_FNS or (fn in ("sum", "avg") and
                                          vals.dtype != torch.float64):
        raise TypeError(f"window_extreme: {fn!r} of {vals.dtype}, a bool "
                        f"validity and an int64 count scan")
    n_live = _check_n_live("window_extreme", ctx.n_live, dev)
    _check_rows("window_extreme", n, dev, vals=vals, valid=valid,
                counts=counts)
    vals, valid, counts = (_contiguous(t) for t in (vals, valid, counts))
    recs = torch.empty((n, 2), dtype=vals.dtype, device=dev)
    if n == 0:
        return window_unpermute(ctx, recs)
    wide = upper - lower + 1 > NARROW_MAX
    chunks = -(-n // TILE)
    scratch = torch.empty(2 * n + chunks if wide else 0, dtype=vals.dtype,
                          device=dev)
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_extreme.cu")(
            n_live.data_ptr(), n, vals.data_ptr(), _ptr(valid),
            ctx.seg_start.data_ptr(), ctx.seg_end.data_ptr(),
            _ptr(counts), code, _EXTREME_FNS[fn], lower, upper,
            recs.data_ptr(), scratch.data_ptr() if wide else None,
            csrc.stream_ptr(dev)), "window_extreme")
    window_extreme.launches += 1
    return window_unpermute(ctx, recs)


window_extreme.launches = 0


# ---------------------------------------------------------------------------
# framed aggregates
# ---------------------------------------------------------------------------

def _kernel_values(vals: torch.Tensor) -> torch.Tensor:
    """Values in a type the scan and extreme kernels read (bool, int8 and
    int16 widen to int32; the caller casts the result back)."""
    return vals.to(torch.int32) if vals.dtype in (
        torch.bool, torch.int8, torch.int16) else vals


def _nearest_valid(valid: torch.Tensor, at: torch.Tensor, forward: bool
                   ) -> torch.Tensor:
    """The first position >= ``at`` (``forward``) or the last <= ``at``
    where ``valid`` (sorted order) holds; len(valid) or -1 where none."""
    n = valid.shape[0]
    pos = _positions(valid)
    if forward:
        nxt = torch.where(valid, pos, n).flip(0).cummin(0).values.flip(0)
        return torch.where(at < n, _at(nxt, at), n)
    prv = torch.where(valid, pos, -1).cummax(0).values
    return torch.where(at >= 0, _at(prv, at), -1)


def framed_agg(ctx: WindowContext, value: Optional[Column], fn: str,
               lower: Optional[int], upper: Optional[int],
               peer_end=None, ignore_nulls: bool = False):
    """Aggregate over a frame [lower, upper] relative to the current row
    (None = unbounded), in row order. ROWS semantics by default; passing
    ``peer_end`` (from peer_group_end) with upper 0 gives RANGE semantics
    for the unbounded-preceding..current-row frame (it extends to the
    last peer). Where both offsets are finite, min, max and a float sum
    or avg go to K11, which combines the frame's own rows. Otherwise K10:
    its frame evaluation of its scans, forward where the frame starts at
    the segment start, backward where it ends at the segment end (a float
    sum then subtracts nothing, so no NaN or infinity from outside the
    frame reaches it). count: K10's count scan; first and last: the
    sorted values read at the frame's first or last position (with
    ``ignore_nulls``, its first or last non-null one). The values
    and their validity go into sorted order once per context
    (``ctx.sorted_values``): MIN and MAX of one column, and every
    lag/lead/nth/first/last over it, share them."""
    valid = None if value is None else value.validity
    if fn in ("first", "last"):
        lo, hi = _frame_bounds(ctx, lower, upper, peer_end)
        vals, valid = ctx.sorted_values(value.data, valid)
        at = lo if fn == "first" else hi
        if ignore_nulls and valid is not None:
            at = _nearest_valid(valid, at, fn == "first")
        return _read_sorted(ctx, vals, valid, at,
                            (hi >= lo) & (at >= lo) & (at <= hi))
    if fn == "count":
        return window_frame(ctx, None, ctx.count_scan(valid), "count", lower,
                            upper, peer_end)
    vals, valid = ctx.sorted_values(value.data, valid)
    counts = ctx.count_scan(value.validity)
    vals = _kernel_values(vals)
    bounded = lower is not None and upper is not None
    backward = lower is not None and upper is None
    if fn in ("sum", "avg"):
        if bounded and vals.is_floating_point():
            return window_extreme(ctx, vals.to(torch.float64), valid, counts,
                                  lower, upper, fn)
        scan = window_scan(ctx, vals, valid, "sum", backward)
        return window_frame(ctx, scan, counts, fn, lower, upper, peer_end,
                            backward)
    if fn in ("min", "max"):
        if bounded:
            out, ok = window_extreme(ctx, vals, valid, counts, lower, upper,
                                     fn)
        else:
            scan = window_scan(ctx, vals, valid, fn, backward)
            out, ok = window_frame(ctx, scan, counts, fn, lower, upper,
                                   peer_end, backward)
        return out.to(value.data.dtype), ok
    raise NotImplementedError(f"window aggregate {fn!r}")

