"""Blocked Compressed Storage (BCS, paper §4.3 Fig 4): packing a block-pruned
weight into the kernel's uniform-padded CSC layout, with the Fig 4 row
reordering for load balance; the im2col lowering of conv weights
(``conv_lower``, ``conv_tap_table``) and the tap lowering of
pattern/connectivity-pruned convs into a ``TapLayout`` (``pattern_lower``).

The unit the executor skips is a whole (bk, bn) weight block.  Packing runs
as tensor ops on the weight's own device, so full-width layers pack on the
card in milliseconds; only the per-column degree list crosses to the host
(it sets the padded bin degrees, which are shapes).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout, TapLayout


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


def conv_lower(w):
    """Im2col lowering of a conv weight: (P, Q, Kh, Kw) -> (Kh*Kw*Q, P).

    Row order is (kh, kw, q) — tap-major, channel-minor — matching
    ``kernels.ops.im2col``, so ``patches @ lowered`` is the convolution.
    Works on masks too.  A block-punched group (kernel block (bp, bq),
    position (m, n)) becomes a contiguous (bq, bp) zero tile of the
    lowered GEMM: a whole dead block under packing block (bq, bp)."""
    P, Q, Kh, Kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(Kh * Kw * Q, P).contiguous()


def conv_gemm_block(kernel_block, conv_shape):
    """Packing block for the lowered conv GEMM from the paper's kernel-block
    choice (bp over filters P, bq over channels Q): (bk, bn) = (bq, bp).
    Returns (None, reason) when the block cannot tile the layer."""
    bp, bq = kernel_block
    P, Q, Kh, Kw = conv_shape
    if Q % bq or P % bp:
        return None, (f"kernel block {tuple(kernel_block)} does not divide "
                      f"(P={P}, Q={Q})")
    return (bq, bp), None


def conv_tap_table(kh, kw, c, bk):
    """Static K-block -> (dy, dx, c0) table for the implicit conv: lowered
    row r = (dy*Kw + dx)*C + c; with bk | C every K-block of ``bk`` rows
    lies inside one tap and covers channels [c0, c0 + bk).  A hashable
    tuple of triples."""
    if c % bk:
        raise ValueError(f"implicit conv needs the packing block bk={bk} to "
                         f"divide Cin={c} so K-blocks never straddle taps")
    out = []
    for kb in range(kh * kw * c // bk):
        r0 = kb * bk
        t = r0 // c
        out.append((t // kw, t % kw, r0 % c))
    return tuple(out)


def pattern_lower(w, mask, *, group=1, n_bins=4, reorder=True, n_shards=0):
    """Tap lowering of a pattern/connectivity-pruned conv (paper §2.1.1)
    into a ``TapLayout``: per group of ``group`` consecutive filters, the
    rows of the im2col band any filter of the group survives at, in
    ascending row order; with ``reorder`` the groups are sorted by
    descending degree (stable) and split into ``n_bins`` bins, each padded
    to its own max.  Rows dead for every group leave the ``alive`` band.
    Runs as tensor ops on the weight's device; the degree list crosses to
    the host (it sets the padded shapes)."""
    if n_shards:
        raise NotImplementedError("pattern_lower(n_shards > 0): "
                                  "tensor-parallel layouts are not ported "
                                  "yet")
    if w.ndim != 4:
        raise ValueError(f"pattern_lower needs a (P, Q, Kh, Kw) conv "
                         f"weight, got {tuple(w.shape)}")
    mask = mask.expand(w.shape) if mask.ndim < 4 else mask
    P = w.shape[0]
    if P % group:
        raise ValueError(f"group {group} does not divide P={P}")
    dev = w.device
    wl = conv_lower(w * mask.to(w.dtype))               # (K, P)
    ml = conv_lower(mask) != 0
    K = wl.shape[0]
    G = P // group
    galive = ml.reshape(K, G, group).any(dim=2)         # (K, G)
    alive = torch.nonzero(galive.any(dim=1)).reshape(-1)
    if alive.numel() == 0:
        alive = torch.zeros(1, dtype=torch.int64, device=dev)
    ga = galive[alive]                                  # (R, G)
    cnt = ga.sum(dim=0, dtype=torch.int64)              # taps per group
    if reorder:
        order = torch.argsort(-cnt, stable=True)
        bounds = bin_bounds(G, n_bins)
    else:
        order = torch.arange(G, device=dev)
        bounds = ((0, G),)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(G, device=dev)
    cnt_sorted = cnt[order]
    deg = cnt_sorted.tolist()
    Lmax = max(1, max(deg))
    # live rows of each group first, ascending (stable sort of ~live)
    ga_t = ga.t()[order]                                # (G, R) layout order
    rows = torch.argsort((~ga_t).to(torch.uint8), dim=1,
                         stable=True)[:, :Lmax]
    live = torch.arange(Lmax, device=dev)[None, :] < cnt_sorted[:, None]
    tidx = torch.where(live, rows, 0)
    wg = wl[alive].reshape(-1, G, group).permute(1, 0, 2)[order]  # (G,R,g)
    vals = wg[torch.arange(G, device=dev)[:, None], tidx]  # (G, Lmax, g)
    vals = vals.masked_fill(~live[:, :, None], 0)
    kfull = alive[tidx]
    bin_values, bin_tidx, bin_kfull = [], [], []
    for s, e in bounds:
        Lb = max(1, max(deg[s:e]) if e > s else 1)
        bin_values.append(vals[s:e, :Lb].contiguous())
        bin_tidx.append(tidx[s:e, :Lb].to(torch.int32).contiguous())
        bin_kfull.append(kfull[s:e, :Lb].to(torch.int32).contiguous())
    return TapLayout(values=tuple(bin_values), t_idx=tuple(bin_tidx),
                     k_full=tuple(bin_kfull),
                     nnz=cnt_sorted.to(torch.int32),
                     alive=alive.to(torch.int32),
                     perm=order.to(torch.int32) if reorder else None,
                     inv_perm=inv.to(torch.int32) if reorder else None,
                     group=group, shape=(K, P))
