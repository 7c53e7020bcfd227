"""Blocked Compressed Storage (BCS, paper §4.3 Fig 4): the ``BCS`` format
itself (CSR of blocks with hierarchical column-index compression, its
uniform-padded row and column layouts and the ``load_imbalance`` metric
that row reordering evens out); packing a block-pruned weight straight
into the kernel's uniform-padded CSC layout, with the Fig 4 row
reordering for load balance; the im2col lowering of conv weights
(``conv_lower``, ``conv_tap_table``) and the tap lowering of
pattern/connectivity-pruned convs into a ``TapLayout`` (``pattern_lower``).

``shard_columns`` spreads block columns (or filter groups) over
tensor-parallel shards by degree; ``n_shards`` > 0 makes either producer
emit the sharded layout.

The unit the executor skips is a whole (bk, bn) weight block.  Packing runs
as tensor ops on the weight's own device, so full-width layers pack on the
card in milliseconds; only the per-column degree list crosses to the host
(it sets the padded bin degrees, which are shapes).  The ``*_loop``
versions are the plain per-row references the vectorized ones are held to.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.packed import PackedLayout, TapLayout


@dataclass
class BCS:
    """A masked (K, N) weight as CSR of (bk, bn) blocks (paper Fig 4).
    Tensors on the weight's device; int32 indices."""
    shape: tuple              # dense (K, N)
    block: tuple              # (bk, bn)
    values: torch.Tensor      # (nnzb, bk, bn) surviving blocks, row-major
    col_idx: torch.Tensor     # (nnzb,) int32 block column of each block
    row_ptr: torch.Tensor     # (Kb + 1,) int32 CSR pointers over block rows
    # hierarchical column compression: the distinct per-row column lists
    # (int64 tensors, first-occurrence order) and each row's pattern id
    patterns: list
    occurrence: torch.Tensor  # (Kb,) int32

    @property
    def nnzb(self) -> int:
        return self.col_idx.numel()

    @property
    def density(self) -> float:
        Kb = self.shape[0] // self.block[0]
        Nb = self.shape[1] // self.block[1]
        return self.nnzb / (Kb * Nb)

    def index_bytes(self) -> int:
        """Metadata bytes under hierarchical compression (patterns,
        occurrence, row pointers)."""
        pat = sum(p.numel() for p in self.patterns)
        return 4 * (pat + self.occurrence.numel() + self.row_ptr.numel())

    def csr_index_bytes(self) -> int:
        """Metadata bytes of plain CSR (column indices, row pointers)."""
        return 4 * (self.col_idx.numel() + self.row_ptr.numel())


def _blockify(w, mask, block):
    """((Kb, Nb, bk, bn) block view of the masked weight, (Kb, Nb) bool
    liveness): a block is live iff any mask entry in it is nonzero."""
    K, N = w.shape
    bk, bn = block
    if K % bk or N % bn:
        raise ValueError(f"block {tuple(block)} does not divide "
                         f"{tuple(w.shape)}")
    Kb, Nb = K // bk, N // bn
    wm = w * mask.to(w.dtype)
    return (wm.reshape(Kb, bk, Nb, bn).permute(0, 2, 1, 3),
            _alive_t(mask, Kb, bk, Nb, bn).t())


def _row_ptr(counts):
    """(Kb + 1,) int32 CSR pointers of per-row counts."""
    out = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                      device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def from_dense(w, mask, block) -> BCS:
    """Pack ``w * mask`` (K, N) into BCS on the weight's device.  A block
    is stored iff any weight in it survives; stored blocks keep their
    interior zeros.  The per-row liveness patterns are deduplicated in
    first-occurrence order (``torch.unique`` sorts them, so its ids are
    renumbered by each pattern's first row)."""
    wblk, alive = _blockify(w, mask, block)
    Kb = alive.shape[0]
    rows, cols = torch.nonzero(alive, as_tuple=True)   # row-major = CSR
    uniq, inv = torch.unique(alive.to(torch.uint8), dim=0,
                             return_inverse=True)
    first = torch.full((uniq.shape[0],), Kb, dtype=torch.int64,
                       device=alive.device)
    first.scatter_reduce_(0, inv, torch.arange(Kb, device=alive.device),
                          "amin")
    order = torch.argsort(first)                       # by first row
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    pat = uniq[order].bool()
    patterns = list(torch.split(torch.nonzero(pat, as_tuple=True)[1],
                                pat.sum(dim=1).tolist()))
    return BCS(shape=tuple(w.shape), block=tuple(block),
               values=wblk[rows, cols], col_idx=cols.to(torch.int32),
               row_ptr=_row_ptr(alive.sum(dim=1)), patterns=patterns,
               occurrence=rank[inv].to(torch.int32))


def from_dense_loop(w, mask, block) -> BCS:
    """Plain per-row reference of ``from_dense``: a loop over block rows on
    the host, a dict of column lists for the patterns."""
    wblk, alive = _blockify(w, mask, block)
    dev = w.device
    col_idx, row_ptr, rows = [], [0], []
    patterns, lookup, occurrence = [], {}, []
    for i, live in enumerate(alive.cpu().tolist()):
        cols = [j for j, a in enumerate(live) if a]
        col_idx += cols
        rows += [i] * len(cols)
        row_ptr.append(len(col_idx))
        key = tuple(cols)
        if key not in lookup:
            lookup[key] = len(patterns)
            patterns.append(torch.tensor(cols, dtype=torch.int64,
                                         device=dev))
        occurrence.append(lookup[key])
    r = torch.tensor(rows, dtype=torch.int64, device=dev)
    c = torch.tensor(col_idx, dtype=torch.int64, device=dev)
    return BCS(shape=tuple(w.shape), block=tuple(block), values=wblk[r, c],
               col_idx=c.to(torch.int32),
               row_ptr=torch.tensor(row_ptr, dtype=torch.int32, device=dev),
               patterns=patterns,
               occurrence=torch.tensor(occurrence, dtype=torch.int32,
                                       device=dev))


def _row_of(bcs):
    """(nnzb,) int64 block row of each stored block."""
    Kb = bcs.row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(Kb, device=bcs.row_ptr.device),
        torch.diff(bcs.row_ptr).long())


def to_dense(bcs: BCS) -> torch.Tensor:
    """The dense (K, N) weight a BCS stores (zeros where no block is)."""
    K, N = bcs.shape
    bk, bn = bcs.block
    out = torch.zeros((K // bk, N // bn, bk, bn), dtype=bcs.values.dtype,
                      device=bcs.values.device)
    out[_row_of(bcs), bcs.col_idx.long()] = bcs.values
    return out.permute(0, 2, 1, 3).reshape(K, N)


def pad_to_uniform(bcs: BCS):
    """Uniform per-ROW layout: every block row gets ``Lmax`` slots, padding
    slots zero blocks at column 0.  Returns (values (Kb, Lmax, bk, bn),
    col_idx (Kb, Lmax) int32, nnz (Kb,) int32)."""
    bk, bn = bcs.block
    Kb = bcs.row_ptr.numel() - 1
    nnz = torch.diff(bcs.row_ptr)
    Lmax = max(1, int(nnz.max()) if Kb else 1)
    dev = bcs.values.device
    vals = torch.zeros((Kb, Lmax, bk, bn), dtype=bcs.values.dtype,
                       device=dev)
    cols = torch.zeros((Kb, Lmax), dtype=torch.int32, device=dev)
    rows = _row_of(bcs)
    slot = (torch.arange(bcs.nnzb, device=dev)
            - bcs.row_ptr[:-1].long()[rows])
    vals[rows, slot] = bcs.values
    cols[rows, slot] = bcs.col_idx
    return vals, cols, nnz.to(torch.int32)


def pad_to_uniform_csc(bcs: BCS):
    """Uniform per-COLUMN layout, what kernel 1's raw entry
    (``kernels.bsr_matmul.bsr_matmul``) takes: for each block column j its
    live K-blocks in ascending order, zero-padded to the max column degree
    ``Lmax``.  Returns (values (Nb, Lmax, bk, bn), k_idx (Nb, Lmax) int32,
    nnz (Nb,) int32); padding slots read K-block 0 with zero values.
    Vectorized: a stable sort of ``col_idx`` groups the blocks by column
    in row order, and one scatter places every block at its slot."""
    K, N = bcs.shape
    bk, bn = bcs.block
    Nb = N // bn
    dev = bcs.values.device
    col = bcs.col_idx.long()
    order = torch.argsort(col, stable=True)
    cnt = torch.bincount(col, minlength=Nb)
    Lmax = max(1, int(cnt.max()) if Nb else 1)
    col_ptr = torch.cumsum(cnt, 0) - cnt                  # first slot
    slot = torch.empty_like(order)
    slot[order] = torch.arange(bcs.nnzb, device=dev) - col_ptr[col[order]]
    dest = col * Lmax + slot
    vals = torch.zeros((Nb * Lmax, bk, bn), dtype=bcs.values.dtype,
                       device=dev)
    kidx = torch.zeros(Nb * Lmax, dtype=torch.int32, device=dev)
    vals[dest] = bcs.values
    kidx[dest] = _row_of(bcs).to(torch.int32)
    return (vals.reshape(Nb, Lmax, bk, bn), kidx.reshape(Nb, Lmax),
            cnt.to(torch.int32))


def pad_to_uniform_csc_loop(bcs: BCS):
    """Plain reference of ``pad_to_uniform_csc``: the column lists built by
    a loop over block rows on the host, then one gather of the blocks."""
    K, N = bcs.shape
    bk, bn = bcs.block
    Nb = N // bn
    dev = bcs.values.device
    row_ptr, col_idx = bcs.row_ptr.tolist(), bcs.col_idx.tolist()
    cols = [[] for _ in range(Nb)]
    for i in range(len(row_ptr) - 1):
        for t in range(row_ptr[i], row_ptr[i + 1]):
            cols[col_idx[t]].append((i, t))
    nnz = [len(c) for c in cols]
    Lmax = max([1] + nnz)
    vals = torch.zeros((Nb, Lmax, bk, bn), dtype=bcs.values.dtype,
                       device=dev)
    kidx = torch.zeros((Nb, Lmax), dtype=torch.int32, device=dev)
    js, ls, ts, ks = [], [], [], []
    for j in range(Nb):
        for slot, (i, t) in enumerate(cols[j]):
            js.append(j)
            ls.append(slot)
            ts.append(t)
            ks.append(i)
    if ts:
        j, s = (torch.tensor(a, device=dev) for a in (js, ls))
        vals[j, s] = bcs.values[torch.tensor(ts, device=dev)]
        kidx[j, s] = torch.tensor(ks, dtype=torch.int32, device=dev)
    return vals, kidx, torch.tensor(nnz, dtype=torch.int32, device=dev)


def load_imbalance(bcs: BCS) -> float:
    """max / mean surviving blocks per block row: what the degree binning
    of ``pack_csc_reordered`` evens out (1.0 when no block survives)."""
    nnz = torch.diff(bcs.row_ptr).double()
    mean = float(nnz.mean()) if nnz.numel() else 0.0
    if mean == 0:
        return 1.0
    return float(nnz.max()) / max(mean, 1e-9)


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


def shard_columns(cnt, n_shards):
    """Degree-balanced assignment of block columns to tensor-parallel
    shards: greedy LPT with an exact capacity.  Columns are visited in
    descending-degree order (stable) and each goes to the least-loaded
    shard that still has room, so every shard owns exactly Nb / n_shards
    columns while its total degree (the work it executes) is equalized.

    ``cnt`` is the (Nb,) degree list (numpy or a tensor).  Returns an
    (n_shards, Nb // n_shards) int32 numpy array of ORIGINAL column ids,
    each shard's row in descending-degree order.  Raises ValueError unless
    n_shards >= 1 divides Nb."""
    cnt = np.asarray(cnt.cpu() if isinstance(cnt, torch.Tensor) else cnt)
    Nb = cnt.shape[0]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if Nb % n_shards:
        raise ValueError(
            f"n_shards={n_shards} does not divide Nb={Nb} block columns")
    cap = Nb // n_shards
    order = np.argsort(-cnt, kind="stable")
    load = np.zeros(n_shards, np.int64)
    fill = np.zeros(n_shards, np.int64)
    out = np.empty((n_shards, cap), np.int32)
    for j in order:
        open_ = fill < cap
        s = int(np.flatnonzero(open_)[np.argmin(load[open_])])
        out[s, fill[s]] = j
        fill[s] += 1
        load[s] += cnt[j]
    return out


def shard_balance(nnz, bin_sizes) -> float:
    """max / mean executed blocks per shard were each shard padded to its
    OWN bin maxima — the straggler factor ``shard_columns`` minimizes.
    ``nnz`` is the layout-order degree array (..., S, Nb_s), ``bin_sizes``
    the per-bin column counts of a shard.  1.0 = perfect."""
    n = np.asarray(nnz.cpu() if isinstance(nnz, torch.Tensor) else nnz)
    if n.ndim < 2:
        return 1.0
    flat = n.reshape(-1, n.shape[-2], n.shape[-1])   # (slices, S, Nb_s)
    per_shard = np.zeros(flat.shape[:2], np.float64)
    start = 0
    for sz in bin_sizes:
        seg = flat[..., start:start + sz]
        per_shard += sz * np.maximum(seg.max(axis=-1), 1)
        start += sz
    mean = per_shard.mean(axis=-1)
    ratio = per_shard.max(axis=-1) / np.maximum(mean, 1e-9)
    return float(ratio.max())


def _shard_order(cnt, n_shards):
    """(assign (S, n/S) int32 numpy, layout order (n,) int64 tensor,
    inverse (n,) int64 tensor) of ``shard_columns`` over ``cnt``: the
    layout order is shard-major, and the inverse maps an original column
    to its shard-major position."""
    assign = shard_columns(cnt, n_shards)
    order = torch.from_numpy(assign.reshape(-1).astype(np.int64)).to(
        cnt.device)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return assign, order, inv


def pack_csc_reordered(w, mask, block, n_bins=4, n_shards=0):
    """Degree-sorted, binned CSC packing — the paper's Fig 4 row reordering
    for load balance, applied to the kernel's work rows (block columns).

    Columns are sorted by descending degree (stable) and split into
    ``n_bins`` contiguous bins, each padded only to its own max degree, so
    the executed degree drops toward the mean.  Within a column the K-block
    order is untouched, so per-output accumulation order — and therefore
    the result — is bit-identical to the unreordered layout.

    Returns a ``PackedLayout`` with per-bin values/k_idx, ``perm`` (layout
    position -> original column) and ``inv_perm``.

    ``n_shards`` > 0 gives the tensor-parallel layout: ``shard_columns``
    spreads the columns over the shards, each shard is binned on its own,
    and every bin is padded to the CROSS-shard max degree, so the per-bin
    leaves stack with a leading shard axis: ``values[b]`` (S, nb_b, L_b,
    bk, bn), ``nnz`` and ``perm`` (S, Nb_s) (``perm`` of original column
    ids), ``inv_perm`` flat (Nb,) (original column -> shard-major
    position)."""
    vals, kidx, cnt, _ = pack_csc(w, mask, block)
    Nb = cnt.shape[0]
    if n_shards:
        assign, order, inv = _shard_order(cnt, n_shards)
        S, Nbs = assign.shape
        vs = vals[order].reshape((S, Nbs) + vals.shape[1:])
        ks = kidx[order].reshape(S, Nbs, -1)
        cnt_sh = cnt[order].reshape(S, Nbs)
        deg = cnt_sh.cpu().numpy()
        bin_values, bin_kidx = [], []
        for s, e in bin_bounds(Nbs, n_bins):
            Lb = max(1, int(deg[:, s:e].max()))         # cross-shard max
            bin_values.append(vs[:, s:e, :Lb].contiguous())
            bin_kidx.append(ks[:, s:e, :Lb].contiguous())
        return PackedLayout(values=tuple(bin_values), k_idx=tuple(bin_kidx),
                            nnz=cnt_sh.contiguous(),
                            perm=torch.from_numpy(assign).to(w.device),
                            inv_perm=inv.to(torch.int32),
                            block=tuple(block), shape=tuple(w.shape),
                            n_shards=S)
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
    the host (it sets the padded shapes).

    ``n_shards`` > 0 (implies ``reorder``): the filter groups are spread
    over the shards by ``shard_columns`` and binned per shard, each bin
    padded to the cross-shard max; per-bin leaves gain a leading shard
    axis, ``nnz`` and ``perm`` become (S, G_s), ``inv_perm`` stays flat
    (G,) and ``alive`` global (every shard gathers the same band)."""
    if n_shards and not reorder:
        raise ValueError("n_shards > 0 requires reorder=True (the "
                         "degree-balanced shard assignment IS a reorder)")
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
    assign = None
    if n_shards:
        assign, order, inv = _shard_order(cnt, n_shards)
    else:
        order = (torch.argsort(-cnt, stable=True) if reorder
                 else torch.arange(G, device=dev))
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
    if n_shards:
        S, Gs = assign.shape
        vals, tidx, kfull = (t.reshape((S, Gs) + t.shape[1:])
                             for t in (vals, tidx, kfull))
        deg_sh = np.asarray(deg).reshape(S, Gs)
        bounds = bin_bounds(Gs, n_bins)
        degrees = [max(1, int(deg_sh[:, a:b].max())) for a, b in bounds]
    else:
        bounds = bin_bounds(G, n_bins) if reorder else ((0, G),)
        degrees = [max(1, max(deg[a:b]) if b > a else 1) for a, b in bounds]
    bin_values, bin_tidx, bin_kfull = [], [], []
    for (a, b), Lb in zip(bounds, degrees):
        bin_values.append(vals[..., a:b, :Lb, :].contiguous())
        bin_tidx.append(tidx[..., a:b, :Lb].to(torch.int32).contiguous())
        bin_kfull.append(kfull[..., a:b, :Lb].to(torch.int32).contiguous())
    if n_shards:
        nnz = cnt_sorted.reshape(S, Gs)
        perm = torch.from_numpy(assign).to(dev)
    else:
        nnz, perm = cnt_sorted, order if reorder else None
    return TapLayout(values=tuple(bin_values), t_idx=tuple(bin_tidx),
                     k_full=tuple(bin_kfull),
                     nnz=nnz.to(torch.int32).contiguous(),
                     alive=alive.to(torch.int32),
                     perm=None if perm is None else perm.to(torch.int32),
                     inv_perm=inv.to(torch.int32) if reorder else None,
                     group=group, shape=(K, P), n_shards=n_shards)
