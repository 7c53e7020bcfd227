"""Blocked Compressed Storage (BCS, paper §4.3 Fig 4): packing a block-pruned
weight into the kernel's uniform-padded CSC layout, with the Fig 4 row
reordering for load balance.

The unit the executor skips is a whole (bk, bn) weight block.  Packing runs
as tensor ops on the weight's own device, so full-width layers pack on the
card in milliseconds; only the per-column degree list crosses to the host
(it sets the padded bin degrees, which are shapes).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout


def _alive_t(mask, Kb, bk, Nb, bn):
    """(K, N) mask -> (Nb, Kb) bool block liveness, transposed (CSC order)."""
    m = mask if mask.dtype == torch.bool else mask != 0
    return m.reshape(Kb, bk, Nb, bn).any(dim=3).any(dim=1).t()


def pack_csc(w, mask, block):
    """Pack the masked weight ``w * mask`` (K, N) column-major: for each
    block COLUMN j, its live K-blocks in ascending K order (the reference's
    CSC order, ``np.nonzero`` of the transposed liveness), zero-padded to
    the max column degree ``Lmax``.  A block is live iff any mask entry in
    it is nonzero; live blocks keep their interior zeros.

    Returns (values (Nb, Lmax, bk, bn), k_idx (Nb, Lmax) int32, nnz (Nb,)
    int32, density).  Padding slots point at K-block 0 with zero values."""
    K, N = w.shape
    bk, bn = block
    assert K % bk == 0 and N % bn == 0, (w.shape, block)
    Kb, Nb = K // bk, N // bn
    dev = w.device
    alive_t = _alive_t(mask, Kb, bk, Nb, bn)                  # (Nb, Kb)
    cnt = alive_t.sum(dim=1, dtype=torch.int32)
    nnzb = int(cnt.sum())
    Lmax = max(1, int(cnt.max()) if cnt.numel() else 1)
    # stable sort puts each column's live rows first, in ascending order
    rows = torch.argsort((~alive_t).to(torch.uint8), dim=1,
                         stable=True)[:, :Lmax]
    live = torch.arange(Lmax, device=dev)[None, :] < cnt[:, None]
    kidx = torch.where(live, rows, 0).to(torch.int32)
    wm = w * mask.to(w.dtype)
    wcsc = wm.reshape(Kb, bk, Nb, bn).permute(2, 0, 1, 3)    # (Nb, Kb, bk, bn)
    cols = torch.arange(Nb, device=dev)[:, None]
    vals = wcsc[cols, kidx.long()]                           # (Nb, Lmax, ...)
    vals = vals.masked_fill(~live[:, :, None, None], 0)
    return vals, kidx, cnt, nnzb / (Kb * Nb)


def bin_bounds(nb: int, n_bins: int) -> tuple:
    """Contiguous (start, end) ranges splitting ``nb`` sorted block columns
    into ``n_bins`` near-equal bins.  Depends only on (nb, n_bins), so every
    slice of a stacked layer axis gets identical bin sizes."""
    n_bins = max(1, min(n_bins, nb))
    edges = np.linspace(0, nb, n_bins + 1).round().astype(int)
    return tuple((int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])
                 if b > a)


def pack_csc_reordered(w, mask, block, n_bins=4):
    """Degree-sorted, binned CSC packing — the paper's Fig 4 row reordering
    for load balance, applied to the kernel's work rows (block columns).

    Columns are sorted by descending degree (stable) and split into
    ``n_bins`` contiguous bins, each padded only to its own max degree, so
    the executed degree drops toward the mean.  Within a column the K-block
    order is untouched, so per-output accumulation order — and therefore
    the result — is bit-identical to the unreordered layout.

    Returns a ``PackedLayout`` with per-bin values/k_idx, ``perm`` (layout
    position -> original column) and ``inv_perm``."""
    vals, kidx, cnt, _ = pack_csc(w, mask, block)
    Nb = cnt.shape[0]
    order = torch.argsort(-cnt.long(), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(Nb, device=order.device)
    vs = vals[order]
    ks = kidx[order]
    cnt_sorted = cnt[order]
    deg = cnt_sorted.tolist()
    bin_values, bin_kidx = [], []
    for s, e in bin_bounds(Nb, n_bins):
        Lb = max(1, max(deg[s:e]))
        bin_values.append(vs[s:e, :Lb].contiguous())
        bin_kidx.append(ks[s:e, :Lb].contiguous())
    return PackedLayout(values=tuple(bin_values), k_idx=tuple(bin_kidx),
                        nnz=cnt_sorted, perm=order.to(torch.int32),
                        inv_perm=inv.to(torch.int32), block=tuple(block),
                        shape=tuple(w.shape))
