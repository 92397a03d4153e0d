"""Sort / permutation kernels over tensors.

The PyTorch counterpart of ``sail_tpu/ops/sort.py``. Every key column is
mapped to an order-preserving int64 key (``order_keys``, kernel K3 on the
card; K18, the chain's kernel, writes the same words where a sort's keys
are computed in a chain, ``ops/chain.py``). Where the keys, less each
key's least value, fit in 63 bits beside their null ranks and the dead
bit, one pack pass (``window_pack``) makes one int64 word a row and one
stable ``torch.sort`` of it gives the order (``packed_perm``), as the
reference's grouping sort packs its keys (``sail_tpu/ops/aggregate.py``
``_group_sort_perm``, ``can_pack``); otherwise one stable ``torch.sort``
pass per key column, plus stable passes for null placement and dead rows
(``lexsort_keys``), gives the reference's total order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import csrc
from ..columnar.batch import Column, DeviceBatch

_MIN64 = torch.iinfo(torch.int64).min  # the bit pattern 1 << 63
_DTYPE_CODES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
                torch.int64: 4, torch.float32: 5, torch.float64: 6}


def _normalize_float(data: torch.Tensor) -> torch.Tensor:
    """Spark key semantics: -0.0 keys equal 0.0, and all NaNs are one value."""
    data = data + 0.0  # -0.0 + 0.0 == +0.0
    return torch.where(torch.isnan(data), torch.full_like(data, float("nan")),
                       data)


def order_keys_plain(data: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """int64 keys whose signed order is the value order: the reference's
    uint64 order bits XOR (1 << 63). Descending is the bitwise NOT."""
    if data.dtype == torch.bool:
        key = data.to(torch.int64) ^ _MIN64
    elif data.dtype == torch.float32:
        b = _normalize_float(data).view(torch.int32).to(torch.int64) \
            & 0xFFFFFFFF
        neg = (b >> 31) != 0
        key = torch.where(neg, ~b & 0xFFFFFFFF, b | 0x80000000) ^ _MIN64
    elif data.dtype == torch.float64:
        b = _normalize_float(data).view(torch.int64)
        key = torch.where(b < 0, ~b, b | _MIN64) ^ _MIN64
    elif data.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        key = data.to(torch.int64)
    else:
        raise TypeError(data.dtype)
    return key if ascending else ~key


def order_keys(data: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """K3: ``order_keys_plain`` as a kernel on the card.

    Replaces ``sail_tpu/ops/sort.py`` ``order_bits``; the kernel's source
    (csrc/order_keys.cu) states its bound. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if data.device.type == "cpu":
        return order_keys_plain(data, ascending)
    code = _DTYPE_CODES.get(data.dtype)
    if code is None or data.dim() != 1:
        raise TypeError(f"order_keys: unsupported input {data.dtype}, "
                        f"shape {tuple(data.shape)}")
    data = data.contiguous()
    n = data.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=data.device)
    if n == 0:
        return out
    with torch.cuda.device(data.device):
        csrc.check(csrc.entry("order_keys.cu")(
            data.data_ptr(), code, n, 0 if ascending else 1, out.data_ptr(),
            csrc.grid_for(n, data.device), csrc.stream_ptr(data.device)),
            "order_keys")
    order_keys.launches += 1
    return out


order_keys.launches = 0


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices


def lexsort_perm(keys, sel=None) -> torch.Tensor:
    """Stable lexicographic sort permutation.

    ``keys``: sequence of (data, validity, dtype, ascending, nulls_first),
    most significant first. Spark null ordering (default nulls first when
    ascending, last when descending). Dead rows (sel == False) always sort
    last. Returns the int64 permutation of row indices: K3's keys, then
    ``packed_perm``.
    """
    if not keys:
        return lexsort_keys([], sel)
    if sel is None:
        sel = torch.ones(keys[0][0].shape[0], dtype=torch.bool,
                         device=keys[0][0].device)
    return packed_perm([(order_keys(data, asc), validity,
                         asc if nf is None else nf)
                        for data, validity, _d, asc, nf in keys], sel)


def lexsort_keys(keys, sel=None) -> torch.Tensor:
    """``lexsort_perm`` over keys already mapped to K3 order keys by the
    reference's passes: ``keys`` is a sequence of (int64 key, validity,
    nulls_first), most significant first."""
    n = keys[0][0].shape[0] if keys else sel.shape[0]
    device = keys[0][0].device if keys else sel.device
    perm = torch.arange(n, dtype=torch.int64, device=device)
    for bits, validity, nulls_first in reversed(list(keys)):
        perm = perm[_stable_argsort(bits[perm])]
        if validity is not None:
            null_rank = (validity if nulls_first else ~validity).to(torch.uint8)
            perm = perm[_stable_argsort(null_rank[perm])]
    if sel is not None:
        dead = (~sel).to(torch.uint8)
        perm = perm[_stable_argsort(dead[perm])]
    return perm


# ---------------------------------------------------------------------------
# the packed sort: one word a row, one stable sort
# ---------------------------------------------------------------------------

# a packed sort word is a non-negative int64; the pack kernel takes at most
# this many keys (window.cuh kMaxKeys)
PACK_BITS = 63
MAX_KEYS = 16
_MAX64 = torch.iinfo(torch.int64).max

# a key as K3 made it: (int64 key, validity or None, nulls_first)
Key = Tuple[torch.Tensor, Optional[torch.Tensor], bool]


class PackLayout(NamedTuple):
    """Where ``window_pack`` puts each key's fields in the sort word: per
    key, its least K3 bits (``lo``), the shift of its bits minus ``lo``
    and that of its null rank (-1: no validity); the dead bit's shift; the
    mask of the dead bit and the partition fields. ``dead_only``: a dead
    row is the dead bit alone (the extremes are the live rows');
    ``canonical``: a NULL key is packed as its null rank alone, so all
    NULLs of a key are one value (a grouping's)."""
    lo: Tuple[int, ...]
    shift: Tuple[int, ...]
    vshift: Tuple[int, ...]
    dead_shift: int
    part_mask: int
    dead_only: bool = False
    canonical: bool = False


def pack_layout(keys: Sequence[Key], n_part: int, ext=None,
                canonical: bool = False) -> Optional[PackLayout]:
    """The packed word's layout, or None where the keys do not fit in it.

    ``keys``: most significant first, the ``n_part`` partition keys first.
    ``ext``: each key's (least, greatest) K3 word over the live rows, as
    host integers (a sort's, or with ``canonical`` a grouping's over the
    live non-null rows; K18 or ``key_extremes`` makes them); None: over
    all rows (a window's: the sort orders the dead rows by their keys
    too), read here, the keys' extremes in one copy to the host, the
    context's one host sync. A key takes bit_length(max - min) bits (in
    Python integers: the difference of two int64 may pass INT64_MAX; none
    where it has no row in ``ext``), and one more for its null rank where
    it has a validity; they fit where they and the dead bit come to
    PACK_BITS or fewer, with at most MAX_KEYS keys."""
    if len(keys) > MAX_KEYS:
        return None
    dead_only = ext is not None
    if ext is None:
        n = keys[0][0].shape[0] if keys else 0
        ext = torch.stack([torch.stack(torch.aminmax(k)) for k, _, _ in keys]
                          ).tolist() if keys and n else [(0, 0)] * len(keys)
    lo, shift, vshift = [0] * len(keys), [0] * len(keys), [-1] * len(keys)
    at = order_bits = 0
    for j in reversed(range(len(keys))):  # the least significant first
        if j == n_part - 1:
            order_bits = at
        lo[j], hi = ext[j]
        if hi < lo[j]:  # no row to hold
            lo[j] = hi = 0
        shift[j] = at
        at += (hi - lo[j]).bit_length()
        if keys[j][1] is not None:
            vshift[j] = at
            at += 1
    if n_part == 0:
        order_bits = at
    if at + 1 > PACK_BITS:
        return None
    return PackLayout(tuple(lo), tuple(shift), tuple(vshift), at,
                      ((1 << (at + 1)) - 1) ^ ((1 << order_bits) - 1),
                      dead_only, canonical)


def window_pack_plain(keys: Sequence[Key], sel: torch.Tensor,
                      layout: PackLayout) -> torch.Tensor:
    """The sort word of each row: the dead bit (``sel`` false) at
    ``layout.dead_shift``; per key its K3 bits minus ``lo`` at its shift
    and its null rank (the validity where nulls sort first, its negation
    where they sort last) above them. A null row's bits are packed as
    they are (the sort orders null rows by them, as the passes do), or as
    0 in a ``canonical`` layout; a dead row of a ``dead_only`` layout is
    the dead bit alone."""
    word = (~sel).to(torch.int64) << layout.dead_shift
    for (key, valid, nulls_first), lo, shift, vshift in zip(
            keys, layout.lo, layout.shift, layout.vshift):
        bits = key - lo
        if valid is not None and layout.canonical:
            bits = torch.where(valid, bits, 0)
        if layout.dead_only:
            bits = torch.where(sel, bits, 0)
        word |= bits << shift
        if valid is not None:
            rank = (valid if nulls_first else ~valid).to(torch.int64)
            if layout.dead_only:
                rank = torch.where(sel, rank, 0)
            word |= rank << vshift
    return word


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def _check_rows(name: str, n: int, dev: torch.device, **tensors) -> None:
    for label, t in tensors.items():
        if t is not None and (t.dim() != 1 or t.shape[0] != n or
                              t.device != dev):
            raise TypeError(f"{name}: {label} must be 1-D with {n} rows on "
                            f"{dev}, got {tuple(t.shape)} on {t.device}")


def window_pack(keys: Sequence[Key], sel: torch.Tensor,
                layout: PackLayout) -> torch.Tensor:
    """K8's pack pass: ``window_pack_plain`` as one kernel pass over the
    keys in row order (csrc/window_bounds.cu ``sail_window_pack``).

    Replaces the stable passes of ``sail_tpu/ops/sort.py`` ``lexsort_perm``
    (:65-74, a sort and a gather a key, a validity and the dead rows) as
    ``build_window_context`` (:47) and the sort call them, and the packed
    word of ``sail_tpu/ops/aggregate.py`` ``_group_sort_perm`` (:36-50):
    one stable ``torch.sort`` of the word orders the rows as they do; the
    kernel's source states its bound. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if sel.device.type == "cpu":
        return window_pack_plain(keys, sel, layout)
    n, dev = sel.shape[0], sel.device
    if len(keys) > MAX_KEYS or sel.dtype != torch.bool:
        raise TypeError(f"window_pack: at most {MAX_KEYS} keys and a bool "
                        f"sel, got {len(keys)} and {sel.dtype}")
    keys = [(_contiguous(k), _contiguous(v), nf) for k, v, nf in keys]
    for k, v, _ in keys:
        if k.dtype != torch.int64 or (v is not None and v.dtype != torch.bool):
            raise TypeError("window_pack: keys must be int64 (K3 order keys) "
                            "with bool validities")
        _check_rows("window_pack", n, dev, key=k, validity=v)
    sel = sel.contiguous()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    flags = [int(nf) | int(layout.canonical) << 1 for _, _, nf in keys]
    arrays = [(ctypes.c_void_p * MAX_KEYS)(*[k.data_ptr()
                                             for k, _, _ in keys]),
              (ctypes.c_void_p * MAX_KEYS)(*[_ptr(v) for _, v, _ in keys]),
              (ctypes.c_longlong * MAX_KEYS)(*layout.lo),
              (ctypes.c_int * MAX_KEYS)(*layout.shift),
              (ctypes.c_int * MAX_KEYS)(*layout.vshift),
              (ctypes.c_int * MAX_KEYS)(*flags)]
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("window_bounds.cu", "sail_window_pack")(
            *[ctypes.addressof(a) for a in arrays], len(keys),
            layout.dead_shift, int(layout.dead_only), sel.data_ptr(), n,
            out.data_ptr(), csrc.grid_for(n, dev), csrc.stream_ptr(dev)),
            "window_pack")
    window_pack.launches += 1
    return out


window_pack.launches = 0


def key_extremes(keys: Sequence[Key], sel: torch.Tensor,
                 canonical: bool = False) -> torch.Tensor:
    """int64[len(keys), 2]: each key's least and greatest K3 word over the
    live rows (with ``canonical``, its live non-null rows), on the keys'
    device; (INT64_MAX, INT64_MIN) where it has none. K18 writes the same
    beside its words."""
    rows = []
    for key, valid, _ in keys:
        live = sel if not canonical or valid is None else sel & valid
        rows.append(torch.stack([torch.where(live, key, _MAX64).amin(),
                                 torch.where(live, key, _MIN64).amax()])
                    if key.shape[0] else
                    torch.tensor([_MAX64, _MIN64], device=key.device))
    return torch.stack(rows)


class SortedWords(NamedTuple):
    """A sort's outcome (``sort_words``): its permutation; where the keys
    were packed, the packed words in sorted order and their layout (else
    None: the passes)."""
    perm: torch.Tensor
    word: Optional[torch.Tensor]
    layout: Optional[PackLayout]

    @property
    def form(self) -> str:
        return "passes" if self.layout is None else "packed"


def sort_words(keys: Sequence[Key], sel: torch.Tensor, ext=None,
               canonical: bool = False) -> SortedWords:
    """Rows by (dead, each key's null rank and K3 word), ties in row order.

    ``ext``: the keys' extremes over the live rows (``key_extremes``'
    int64[k, 2], on the card where K18 wrote them), read to the host in
    one copy; None: over all rows (``pack_layout``). ``canonical``: a
    grouping's order, in which the NULLs of a key are one value. Where the
    keys fit in one word: the pack pass and one stable ``torch.sort``,
    whose values are the sorted words; else the passes
    (``lexsort_keys``). The form follows from the layout, not from a
    failed kernel."""
    if ext is not None and not isinstance(ext, list):
        ext = ext.tolist()
    layout = pack_layout(keys, 0, ext, canonical)
    if layout is None:
        if canonical:  # a NULL's data may not split its key's NULLs
            keys = [(k if v is None else torch.where(v, k, 0), v, nf)
                    for k, v, nf in keys]
        return SortedWords(lexsort_keys(keys, sel), None, None)
    srt = torch.sort(window_pack(keys, sel, layout), stable=True)
    return SortedWords(srt.indices, srt.values, layout)


def packed_perm(words: Sequence[Key], sel: torch.Tensor, ext=None
                ) -> torch.Tensor:
    """The sort permutation of K3 ``words`` ((int64 word, validity,
    nulls_first), most significant first) and ``sel``: one pack pass and
    one stable sort where they fit in 63 bits, else the passes
    (``sort_words``). The counterpart of ``sail_tpu/ops/sort.py``
    ``lexsort_perm``: its live prefix is the reference's, and with no
    ``ext`` so is the order of the dead rows. A NULL row keeps its data
    bits in the word, so NULLs of a key order by them before the next key
    decides, as the reference's passes order them."""
    return sort_words(words, sel, ext).perm


def take_column(col: Column, perm: torch.Tensor) -> Column:
    validity = None if col.validity is None else col.validity[perm]
    return Column(col.data[perm], validity, col.dtype)


def take_batch(batch: DeviceBatch, perm: torch.Tensor) -> DeviceBatch:
    cols = {n: take_column(c, perm) for n, c in batch.columns.items()}
    return DeviceBatch(cols, batch.sel[perm])


def compact_perm(sel: torch.Tensor) -> torch.Tensor:
    """Permutation moving live rows to the front, preserving order."""
    return _stable_argsort((~sel).to(torch.uint8))


def compact(batch: DeviceBatch) -> DeviceBatch:
    """The live rows only, in order."""
    idx = torch.nonzero(batch.sel).squeeze(1)
    return take_batch(batch, idx)


def limit(batch: DeviceBatch, n: int, offset: int = 0) -> DeviceBatch:
    """LIMIT/OFFSET over live rows (compacts first)."""
    out = compact(batch)
    return take_batch(out, torch.arange(min(offset, out.capacity),
                                        min(out.capacity, offset + n),
                                        device=out.device))
