"""Runtime join-filter kernels (blocked bloom + min/max key bounds).

The PyTorch counterpart of ``sail_tpu/ops/runtime_filter.py``. After the
source side of an inner/semi join materializes, a bloom filter over its
join keys (``ops/hash.join_keys``, the join's own key derivation, so the
filter never yields a false negative) masks the other side's selection
before the build/probe. Bit positions follow the reference exactly; the
bits are kept in int32 words (bit p is word p >> 5, bit p & 31) where the
reference keeps a bool per bit. Building and applying the filter is
kernel K7 on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import csrc
from .hash import _mix, join_keys, shr, umod
from .sort import _MIN64

_KEY_MAX = torch.iinfo(torch.int64).max
_KEY_MIN = torch.iinfo(torch.int64).min


def _positions(keys: torch.Tensor, num_bits: int):
    """Three bit positions per key (K4 keys) from independent slices of
    the reference key's mix."""
    m = _mix(keys ^ _MIN64)
    return umod(m, num_bits), umod(shr(m, 17), num_bits), \
        umod(shr(m, 34), num_bits)


def _num_words(num_bits: int) -> int:
    return (num_bits + 31) // 32


def bloom_build_plain(keys: torch.Tensor, usable: torch.Tensor,
                      num_bits: int) -> torch.Tensor:
    """int32 words with the three bits of every usable key set."""
    bits = torch.zeros(_num_words(num_bits) * 32, dtype=torch.bool,
                       device=keys.device)
    for p in _positions(keys[usable], num_bits):
        bits[p] = True
    weights = torch.ones(32, dtype=torch.int64, device=keys.device) << \
        torch.arange(32, device=keys.device)
    words = (bits.view(-1, 32).to(torch.int64) * weights).sum(1)
    return words.to(torch.int32)  # keeps the low 32 bits


def bloom_apply_plain(words: torch.Tensor, num_bits: int, kmin, kmax,
                      keys: torch.Tensor, usable: torch.Tensor,
                      sel: torch.Tensor) -> torch.Tensor:
    """sel ∧ usable ∧ member ∧ kmin ≤ key ≤ kmax."""
    member = torch.ones_like(sel)
    for p in _positions(keys, num_bits):
        member = member & (((words[p >> 5] >> (p & 31)) & 1) != 0)
    return sel & usable & member & (keys >= kmin) & (keys <= kmax)


def _check_keys(keys, usable, num_bits):
    if keys.dtype != torch.int64 or usable.dtype != torch.bool or \
            usable.shape != keys.shape or not 0 < num_bits < 2 ** 31:
        raise TypeError("bloom: needs int64 keys, bool usable flags of one "
                        "length and 0 < num_bits < 2**31")


def bloom_build(keys: torch.Tensor, usable: torch.Tensor,
                num_bits: int) -> torch.Tensor:
    """K7 build: ``bloom_build_plain`` as a kernel on the card.

    Replaces the bit-array scatter of ``sail_tpu/ops/runtime_filter.py``
    ``build``; the kernel's source (csrc/bloom.cu) states its bound. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if keys.device.type == "cpu":
        return bloom_build_plain(keys, usable, num_bits)
    _check_keys(keys, usable, num_bits)
    words = torch.zeros(_num_words(num_bits), dtype=torch.int32,
                        device=keys.device)
    n = keys.shape[0]
    if n:
        keys, usable = keys.contiguous(), usable.contiguous()
        with torch.cuda.device(keys.device):
            csrc.check(csrc.entry("bloom.cu", "sail_bloom_build")(
                keys.data_ptr(), usable.data_ptr(), n, num_bits,
                words.data_ptr(), csrc.grid_for(n, keys.device),
                csrc.stream_ptr(keys.device)), "bloom_build")
        bloom_build.launches += 1
    return words


bloom_build.launches = 0


def bloom_apply(words: torch.Tensor, num_bits: int, kmin: torch.Tensor,
                kmax: torch.Tensor, keys: torch.Tensor, usable: torch.Tensor,
                sel: torch.Tensor) -> torch.Tensor:
    """K7 apply: ``bloom_apply_plain`` as a kernel on the card.

    Replaces ``sail_tpu/ops/runtime_filter.py`` ``apply``; the kernel's
    source (csrc/bloom.cu) states its bound. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if keys.device.type == "cpu":
        return bloom_apply_plain(words, num_bits, kmin, kmax, keys, usable,
                                 sel)
    _check_keys(keys, usable, num_bits)
    if sel.shape != keys.shape or words.dtype != torch.int32 or \
            words.shape != (_num_words(num_bits),):
        raise TypeError("bloom_apply: sel of the keys' length and "
                        "int32[ceil(num_bits / 32)] words needed")
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n:
        lo = kmin.to(torch.int64).reshape(1)
        hi = kmax.to(torch.int64).reshape(1)
        keys, usable, sel = keys.contiguous(), usable.contiguous(), \
            sel.contiguous()
        with torch.cuda.device(keys.device):
            csrc.check(csrc.entry("bloom.cu", "sail_bloom_apply")(
                words.data_ptr(), num_bits, lo.data_ptr(), hi.data_ptr(),
                keys.data_ptr(), usable.data_ptr(), sel.data_ptr(), n,
                out.data_ptr(), csrc.grid_for(n, keys.device),
                csrc.stream_ptr(keys.device)), "bloom_apply")
        bloom_apply.launches += 1
    return out


bloom_apply.launches = 0


class BuildResult(NamedTuple):
    words: torch.Tensor    # int32[ceil(num_bits / 32)] membership bits
    num_bits: int
    kmin: torch.Tensor     # int64 scalar: min K4 key over usable rows
    kmax: torch.Tensor     # int64 scalar: max K4 key over usable rows
    n_build: torch.Tensor  # int64 scalar: usable build rows
    ndv: torch.Tensor      # int64 scalar: distinct keys among usable rows
    exact: bool            # keys are lossless packs (no hash aliasing)


def build(key_cols: Sequence, sel: torch.Tensor, num_bits: int,
          seed: int = 0) -> BuildResult:
    """Build the filter from source-side key columns.

    Dead/null-key rows are excluded: an equi-join key with any NULL part
    never matches, so the filter may reject such rows outright."""
    keys, usable, exact = join_keys(key_cols, sel, seed)
    words = bloom_build(keys, usable, num_bits)
    kmin = torch.where(usable, keys, _KEY_MAX).amin() if keys.numel() \
        else torch.tensor(_KEY_MAX, device=keys.device)
    kmax = torch.where(usable, keys, _KEY_MIN).amax() if keys.numel() \
        else torch.tensor(_KEY_MIN, device=keys.device)
    n_build = usable.sum()
    # distinct count over the usable prefix of the sorted keys
    skeys = torch.sort(torch.where(usable, keys, _KEY_MAX)).values
    first = torch.ones_like(usable)
    first[1:] = skeys[1:] != skeys[:-1]
    pos = torch.arange(keys.shape[0], device=keys.device)
    ndv = (first & (pos < n_build)).sum()
    return BuildResult(words, num_bits, kmin, kmax, n_build, ndv, exact)


def apply(res: BuildResult, key_cols: Sequence, sel: torch.Tensor,
          seed: int = 0) -> torch.Tensor:
    """Selection mask: keep rows whose key may be in the source set. Rows
    with NULL key parts are rejected (they cannot equi-match). Sound for
    inner/semi sides only — never apply to a side whose unmatched rows
    survive (left/anti probes, outer builds)."""
    keys, usable, _ = join_keys(key_cols, sel, seed)
    return bloom_apply(res.words, res.num_bits, res.kmin, res.kmax, keys,
                       usable, sel)


def column_bounds(data: torch.Tensor, usable: torch.Tensor):
    """(min, max) of one key column over usable rows, in the column's
    physical dtype. With zero usable rows min > max."""
    if data.is_floating_point():
        lo, hi = float("-inf"), float("inf")
    elif data.dtype == torch.bool:
        lo, hi = False, True
    else:
        info = torch.iinfo(data.dtype)
        lo, hi = info.min, info.max
    if data.numel() == 0:
        return (torch.tensor(hi, dtype=data.dtype, device=data.device),
                torch.tensor(lo, dtype=data.dtype, device=data.device))
    return torch.where(usable, data, hi).amin(), \
        torch.where(usable, data, lo).amax()
