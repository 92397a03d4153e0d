"""Shared pieces of the port's window and union tests.

Comparison rule against the reference: integer, decimal, date, string and
bool columns exactly; float64 within ``atol = 1e-12 * sum(|v|)`` over the
column plus ``rtol = 1e-12``: the reference takes a frame's sum as the
difference of two prefixes of one global float64 ``cumsum``, the port
scans each segment, so the two round at different magnitudes. Row order
only where the query has an ORDER BY.
"""

import numpy as np
import pyarrow as pa
import torch

from torch_tpch_common import _sorted_rows

FLOAT_RTOL = 1e-12
FLOAT_SUM_ATOL = 1e-12


def assert_window_result(got: pa.Table, want: pa.Table, ordered: bool = True):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    if not ordered:
        got, want = _sorted_rows(got), _sorted_rows(want)
    for i, name in enumerate(want.column_names):
        g, w = got.column(i), want.column(i)
        if pa.types.is_floating(w.type):
            gv, wv = g.to_numpy(), w.to_numpy()
            scale = np.nansum(np.abs(wv[np.isfinite(wv)]))
            np.testing.assert_allclose(gv, wv, rtol=FLOAT_RTOL,
                                       atol=FLOAT_SUM_ATOL * scale,
                                       err_msg=name)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def run_both(port, ref, sql: str, ordered: bool = True) -> pa.Table:
    """Run ``sql`` through both sessions and hold the port's answer to the
    reference's; returns the port's."""
    got = port.sql(sql).toArrow()
    assert_window_result(got, ref.sql(sql).toArrow(), ordered)
    return got


def identical(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal, NaN where the other is NaN."""
    if got.is_floating_point():
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            return False
        got, want = torch.nan_to_num(got), torch.nan_to_num(want)
    return torch.equal(got, want)


def close(got: torch.Tensor, want: torch.Tensor, scale_from=None) -> None:
    """A kernel's result against its plain version's: integers exactly;
    floats NaN where the other is, else within FLOAT_RTOL plus
    FLOAT_SUM_ATOL times the sum of |scale_from| (the values summed)."""
    if got.dtype.is_floating_point:
        ok = torch.isnan(got) == torch.isnan(want)
        assert bool(ok.all())
        keep = ~torch.isnan(want)
        g, w = got[keep].double(), want[keep].double()
        scale = 0.0 if scale_from is None else \
            float(scale_from.double().abs().nan_to_num().sum())
        assert bool(((g == w) | ((g - w).abs() <= FLOAT_RTOL * w.abs()
                                 + FLOAT_SUM_ATOL * scale)).all())
    else:
        assert torch.equal(got, want)


def bounds_through_perm(perm, n_live, part_keys, order_keys):
    """K8's five bounds computed from the keys in row order, each K3 key
    and validity read through ``perm``: an oracle apart from the sorted
    words K8 reads. ``part_keys``, ``order_keys``: (K3 key, validity or
    None). Over the live prefix a segment starts where a partition key or
    its validity differs from the previous sorted row's, a peer group where
    a segment starts or an order key or its validity differs; a dead row i
    gets seg_start = peer_start = peer_end = i, seg_end = n_live - 1 and
    dense 0."""
    n = perm.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=perm.device)
    live = idx < n_live

    def changed(keys):
        ch = torch.zeros(n, dtype=torch.bool, device=perm.device)
        for key, valid in keys:
            s = key[perm]
            ch[1:] |= s[1:] != s[:-1]
            if valid is not None:
                v = valid[perm]
                ch[1:] |= v[1:] != v[:-1]
        return ch

    new_seg = changed(part_keys)
    new_seg[:1] = True
    new_peer = (new_seg | changed(order_keys)) & live
    new_seg &= live
    big = torch.full_like(idx, n)

    def starts(flags):
        return torch.cummax(torch.where(flags, idx, 0), 0).values

    def ends(flags):
        nxt = torch.where(flags, idx, big)
        nxt = torch.cat([nxt[1:], big[:1]])
        nxt = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
        return torch.minimum(nxt - 1, n_live - 1)

    seg_start, peer_start = starts(new_seg), starts(new_peer)
    cnt = torch.cumsum(new_peer.to(torch.int64), 0)
    dense = cnt - cnt[seg_start] + 1
    out = (torch.where(live, seg_start, idx),
           torch.where(live, ends(new_seg), (n_live - 1).expand(n)),
           torch.where(live, peer_start, idx),
           torch.where(live, ends(new_peer), idx),
           torch.where(live, dense, 0))
    return tuple(t.to(torch.int32) for t in out)
