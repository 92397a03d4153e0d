"""Runtime join-filter kernels (blocked bloom + min/max key bounds).

The PyTorch counterpart of ``sail_tpu/ops/runtime_filter.py``. After the
source side of an inner/semi join materializes, a bloom filter over its
join keys (``ops/hash.join_keys``, the join's own key derivation, so the
filter never yields a false negative) masks the other side's selection
before the build/probe. Bit positions follow the reference exactly; the
bits are kept in int32 words (bit p is word p >> 5, bit p & 31) where the
reference keeps a bool per bit. Building and applying the filter is
kernel K7 on the card, one pass each over the key columns
(``filter_build``, ``apply``); ``bloom_build_plain`` and
``bloom_apply_plain`` are the bit-level halves of their plain versions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import csrc
from .hash import _mix, join_keys_plain, key_spec, shr, umod
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


def divisor(num_bits: int) -> Tuple[int, int]:
    """(num_bits, mu): the constants with which K7 reduces a 64-bit m
    modulo num_bits on the card. mu = 0 when num_bits is a power of two
    (a mask), else floor(2**64 / num_bits) (a Barrett step, see
    ``reduce_plain``). Needs 0 < num_bits < 2**31."""
    if not 0 < num_bits < 2 ** 31:
        raise ValueError(f"bloom: needs 0 < num_bits < 2**31, got {num_bits}")
    if num_bits & (num_bits - 1) == 0:
        return num_bits, 0
    return num_bits, (1 << 64) // num_bits


def reduce_plain(m: int, d: int, mu: int) -> int:
    """The card's ``m % d`` (csrc/bloom.cu ``reduce``) for a 64-bit m, in
    Python integers: q = umulhi(m, mu) is m // d or one less, so one
    subtraction finishes it."""
    if mu == 0:
        return m & (d - 1)
    r = m - ((m * mu) >> 64) * d
    return r - d if r >= d else r


# filters of up to this many bits are built and probed in shared memory
# (192 KB of words), larger ones in global memory: csrc/bloom.cu's
# kSharedBitsMax, named here for the tests that cross it
SHARED_BITS_MAX = 192 * 1024 * 8


class Built(NamedTuple):
    """One pass of K7's build over the source side's key columns."""
    keys: torch.Tensor     # int64 K4 keys of every row
    usable: torch.Tensor   # bool: selected, no NULL key part
    exact: bool            # keys are lossless packs (no hash aliasing)
    words: torch.Tensor    # int32[ceil(num_bits / 32)] membership bits
    kmin: torch.Tensor     # int64 scalar: min key over usable rows
    kmax: torch.Tensor     # int64 scalar: max key over usable rows
    n_build: torch.Tensor  # int64 scalar: usable rows


def filter_build_plain(key_cols: Sequence, sel: torch.Tensor,
                       num_bits: int, seed: int = 0) -> Built:
    """K4's keys, the bloom's words and the key bounds and count of the
    usable rows (int64 max, int64 min and 0 when there are none)."""
    keys, usable, exact = join_keys_plain(key_cols, sel, seed)
    words = bloom_build_plain(keys, usable, num_bits)
    kmin = torch.where(usable, keys, _KEY_MAX).amin() if keys.numel() \
        else torch.tensor(_KEY_MAX, device=keys.device)
    kmax = torch.where(usable, keys, _KEY_MIN).amax() if keys.numel() \
        else torch.tensor(_KEY_MIN, device=keys.device)
    return Built(keys, usable, exact, words, kmin, kmax, usable.sum())


def _launch(name: str, spec, held, *args) -> None:
    dev = held[0].device
    with torch.cuda.device(dev):
        csrc.check(csrc.entry("bloom.cu", name)(
            ctypes.addressof(spec), held[0].data_ptr(), *args,
            csrc.stream_ptr(dev)), name)


def filter_build(key_cols: Sequence, sel: torch.Tensor, num_bits: int,
                 seed: int = 0) -> Built:
    """K7 build: ``filter_build_plain`` as one kernel pass on the card.

    Replaces ``sail_tpu/ops/runtime_filter.py`` ``build`` but its ndv
    sort; the kernel's source (csrc/bloom.cu) states its bound. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if sel.device.type == "cpu":
        return filter_build_plain(key_cols, sel, num_bits, seed)
    d, mu = divisor(num_bits)
    spec, held, exact = key_spec(key_cols, sel)
    n, dev = sel.shape[0], sel.device
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    usable = torch.empty(n, dtype=torch.bool, device=dev)
    words = torch.zeros(_num_words(num_bits), dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    _launch("sail_bloom_build", spec, held, n,
            0 if exact else 1, ctypes.c_ulonglong(seed), d,
            ctypes.c_ulonglong(mu), keys.data_ptr(), usable.data_ptr(),
            words.data_ptr(), stats.data_ptr())
    if n:
        filter_build.launches += 1
    return Built(keys, usable, exact, words, stats[0], stats[1], stats[2])


filter_build.launches = 0


class BuildResult(NamedTuple):
    words: torch.Tensor    # int32[ceil(num_bits / 32)] membership bits
    num_bits: int
    kmin: torch.Tensor     # int64 scalar: min K4 key over usable rows
    kmax: torch.Tensor     # int64 scalar: max K4 key over usable rows
    n_build: torch.Tensor  # int64 scalar: usable build rows
    ndv: torch.Tensor      # int64 scalar: distinct keys among usable rows
    exact: bool            # keys are lossless packs (no hash aliasing)


def filter_apply_plain(res: BuildResult, key_cols: Sequence,
                       sel: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """K4's keys of the target rows, then ``bloom_apply_plain``."""
    keys, usable, _ = join_keys_plain(key_cols, sel, seed)
    return bloom_apply_plain(res.words, res.num_bits, res.kmin, res.kmax,
                             keys, usable, sel)


def build(key_cols: Sequence, sel: torch.Tensor, num_bits: int,
          seed: int = 0) -> BuildResult:
    """Build the filter from source-side key columns.

    Dead/null-key rows are excluded: an equi-join key with any NULL part
    never matches, so the filter may reject such rows outright."""
    b = filter_build(key_cols, sel, num_bits, seed)
    # distinct count over the usable prefix of the sorted keys
    skeys = torch.sort(torch.where(b.usable, b.keys, _KEY_MAX)).values
    first = torch.ones_like(b.usable)
    first[1:] = skeys[1:] != skeys[:-1]
    pos = torch.arange(b.keys.shape[0], device=b.keys.device)
    ndv = (first & (pos < b.n_build)).sum()
    return BuildResult(b.words, num_bits, b.kmin, b.kmax, b.n_build, ndv,
                       b.exact)


def apply(res: BuildResult, key_cols: Sequence, sel: torch.Tensor,
          seed: int = 0) -> torch.Tensor:
    """Selection mask: keep rows whose key may be in the source set. Rows
    with NULL key parts are rejected (they cannot equi-match). Sound for
    inner/semi sides only — never apply to a side whose unmatched rows
    survive (left/anti probes, outer builds).

    K7 apply: ``filter_apply_plain`` as one kernel pass on the card,
    reading the key columns and writing the mask only. Replaces
    ``sail_tpu/ops/runtime_filter.py`` ``apply``; the kernel's source
    (csrc/bloom.cu) states its bound. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if sel.device.type == "cpu":
        return filter_apply_plain(res, key_cols, sel, seed)
    d, mu = divisor(res.num_bits)
    spec, held, exact = key_spec(key_cols, sel)
    n, dev = sel.shape[0], sel.device
    words = res.words.contiguous()
    kmin = res.kmin.to(device=dev, dtype=torch.int64).reshape(1)
    kmax = res.kmax.to(device=dev, dtype=torch.int64).reshape(1)
    if words.dtype != torch.int32 or words.device != dev or \
            words.shape != (_num_words(d),):
        raise TypeError(f"bloom apply: needs int32[{_num_words(d)}] words "
                        f"on {dev}, got {words.dtype}{tuple(words.shape)} "
                        f"on {words.device}")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch("sail_bloom_apply", spec, held, n, 0 if exact else 1,
                ctypes.c_ulonglong(seed), words.data_ptr(), d,
                ctypes.c_ulonglong(mu), kmin.data_ptr(), kmax.data_ptr(),
                out.data_ptr())
        apply.launches += 1
    return out


apply.launches = 0


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
