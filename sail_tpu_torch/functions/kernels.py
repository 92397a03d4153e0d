"""Elementwise kernels with Spark null semantics, over tensors.

The PyTorch counterpart of ``sail_tpu/functions/kernels.py``. A column
value is ``CV = (data, validity)`` where validity is None for
non-nullable. Literals are 0-d tensors that broadcast against columns.

Most kernels are "strict" (null in → null out); AND/OR implement Kleene
logic; null-handling functions (coalesce, nullif, …) are explicit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .numeric import saturating_long

CV = Tuple[torch.Tensor, Optional[torch.Tensor]]


def merge_validity(*vs) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x, dtype=torch.bool)


# -- logic -------------------------------------------------------------------

def kleene_and(a: CV, b: CV) -> CV:
    av, bv = a[1], b[1]
    ad, bd = a[0].bool(), b[0].bool()
    if av is None and bv is None:
        return ad & bd, None
    a_false = ~ad if av is None else (av & ~ad)
    b_false = ~bd if bv is None else (bv & ~bd)
    valid = a_false | b_false | (
        (_ones(ad) if av is None else av) & (_ones(bd) if bv is None else bv))
    return ad & bd & ~a_false & ~b_false, valid


def kleene_or(a: CV, b: CV) -> CV:
    av, bv = a[1], b[1]
    ad, bd = a[0].bool(), b[0].bool()
    if av is None and bv is None:
        return ad | bd, None
    a_true = ad if av is None else (av & ad)
    b_true = bd if bv is None else (bv & bd)
    valid = a_true | b_true | (
        (_ones(ad) if av is None else av) & (_ones(bd) if bv is None else bv))
    return a_true | b_true, valid


def not_(a: CV) -> CV:
    return ~a[0].bool(), a[1]


def isnull(a: CV) -> CV:
    if a[1] is None:
        return torch.zeros_like(a[0], dtype=torch.bool), None
    return ~a[1], None


def isnotnull(a: CV) -> CV:
    if a[1] is None:
        return _ones(a[0]), None
    return a[1], None


# -- null handling -------------------------------------------------------------

def coalesce(*args: CV) -> CV:
    """First non-null argument; NULL only when every argument is NULL."""
    data = args[-1][0]
    for d, v in reversed(args[:-1]):
        if v is None:
            data = torch.broadcast_to(d.to(data.dtype),
                                      torch.broadcast_shapes(d.shape, data.shape))
        else:
            data = torch.where(v, d.to(data.dtype), data)
    if any(v is None for _, v in args):
        return data, None
    validity = args[0][1]
    for _, v in args[1:]:
        validity = validity | v
    return data, validity


def nullif(a: CV, b: CV) -> CV:
    eq = a[0] == b[0]
    eq_valid = merge_validity(a[1], b[1])
    make_null = eq if eq_valid is None else (eq & eq_valid)
    validity = _ones(make_null) if a[1] is None else a[1]
    return a[0], validity & ~make_null


def if_(cond: CV, t: CV, f: CV) -> CV:
    c = cond[0].bool()
    if cond[1] is not None:
        c = c & cond[1]
    data = torch.where(c, t[0].to(f[0].dtype), f[0])
    if t[1] is None and f[1] is None:
        return data, None
    tv = t[1] if t[1] is not None else _ones(c)
    fv = f[1] if f[1] is not None else _ones(c)
    return data, torch.where(c, tv, fv)


def eq_null_safe(a: CV, b: CV) -> CV:
    """<=> : null <=> null is true, null <=> x is false."""
    eq = _nan_eq(a[0], b[0])
    av = a[1] if a[1] is not None else _ones(a[0])
    bv = b[1] if b[1] is not None else _ones(b[0])
    return (av & bv & eq) | (~av & ~bv), None


def _nan_eq(x, y):
    eq = x == y
    if x.is_floating_point():
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return eq


# -- arithmetic ------------------------------------------------------------------

def div(a: CV, b: CV) -> CV:
    """Spark division: x/0 → NULL (non-ANSI)."""
    bd = b[0]
    zero = bd == 0
    safe = torch.where(zero, torch.ones_like(bd), bd)
    data = a[0] / safe
    validity = merge_validity(a[1], b[1])
    nz = ~zero
    return data, nz if validity is None else (validity & nz)


def int_div(a: CV, b: CV) -> CV:
    bd = b[0]
    zero = bd == 0
    safe = torch.where(zero, torch.ones_like(bd), bd)
    if a[0].is_floating_point():
        # the quotient to a long as Spark casts a double (the chain's F2I)
        data = saturating_long(a[0] / safe)
    else:
        data = torch.div(a[0], safe.to(a[0].dtype), rounding_mode="trunc")
    validity = merge_validity(a[1], b[1])
    nz = ~zero
    return data, nz if validity is None else (validity & nz)


def mod(a: CV, b: CV) -> CV:
    bd = b[0]
    zero = bd == 0
    safe = torch.where(zero, torch.ones_like(bd), bd)
    data = torch.fmod(a[0], safe.to(a[0].dtype))
    validity = merge_validity(a[1], b[1])
    nz = ~zero
    return data, nz if validity is None else (validity & nz)


def pmod(a: CV, b: CV) -> CV:
    d, v = mod(a, b)
    fixed = torch.where((d != 0) & ((d < 0) != (b[0] < 0)),
                        d + b[0].to(d.dtype), d)
    return fixed, v


def greatest(*args: CV) -> CV:
    """Spark greatest: skips nulls, null only if all null."""
    return _extreme(args, is_max=True)


def least(*args: CV) -> CV:
    return _extreme(args, is_max=False)


def _extreme(args: Sequence[CV], is_max: bool) -> CV:
    acc_d, acc_v = args[0]
    for d, v in args[1:]:
        pick_new = (d > acc_d) if is_max else (d < acc_d)
        if v is not None:
            use_new = v & (pick_new if acc_v is None else (~acc_v | pick_new))
        else:
            use_new = pick_new if acc_v is None else (~acc_v | pick_new)
        acc_d = torch.where(use_new, d.to(acc_d.dtype), acc_d)
        if acc_v is not None or v is not None:
            av = acc_v if acc_v is not None else _ones(use_new)
            vv = v if v is not None else _ones(use_new)
            acc_v = av | vv
    return acc_d, acc_v
