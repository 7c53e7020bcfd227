"""Pruning regularities (paper §2.1.1 + §4.1) as mask generators, for the
conv schemes the serving path packs: block-punched (§4.1.2) and
pattern-based with connectivity pruning (§2.1.1).

Conventions as in the reference: CONV weights are (P, Q, Kh, Kw) =
(filters, in_channels, kh, kw); masks are float32 {0, 1} of the weight
shape.  Selection here is by ``rate`` (prune the ``rate``-fraction of
groups with the smallest L2 norms, through a linear-interpolated quantile
over the whole leaf); the reweighted ``threshold`` mode and the FC /
unstructured / structured schemes come with the training slice.
"""
from __future__ import annotations

import torch

SCHEMES = ("none", "unstructured", "structured_row", "structured_col",
           "pattern", "block", "block_row", "block_col", "block_punched")


def quantile(x, q: float):
    """``jnp.quantile(x, q)`` over all of ``x`` (method "linear"), with the
    reference's float32 interpolation arithmetic."""
    v = torch.sort(x.reshape(-1).float()).values
    n = v.numel()
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(
        float(n - 1), dtype=torch.float32)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    hw = pos - lo
    lw = torch.tensor(1.0, dtype=torch.float32) - hw
    lo_i = int(min(max(int(lo), 0), n - 1))
    hi_i = int(min(max(int(hi), 0), n - 1))
    return v[lo_i] * lw.to(v.device) + v[hi_i] * hw.to(v.device)


def _select(sqnorms, rate=None, threshold=None):
    """Keep-mask over groups: ``rate`` prunes the smallest-``rate``
    fraction (quantile over all of ``sqnorms``)."""
    if threshold is not None:
        raise NotImplementedError(
            "threshold selection (the reweighted automatic-rate mode) "
            "comes with port slice 6")
    if rate is None:
        raise ValueError("_select needs a rate")
    return sqnorms > quantile(sqnorms, rate)


def block_punched_mask(w, block, rate=None, threshold=None):
    """Block-punched pruning for CONV (§4.1.2): weights at the same (m, n)
    kernel location across ALL kernels of a (bp x bq)-kernel block are
    pruned together.  w: (P, Q, Kh, Kw)."""
    bp, bq = block
    P, Q, Kh, Kw = w.shape
    if P % bp or Q % bq:
        raise ValueError(f"kernel block {block} does not tile (P={P}, "
                         f"Q={Q})")
    sq = torch.square(w.float()).reshape(P // bp, bp, Q // bq, bq, Kh, Kw)
    g = sq.sum(dim=(1, 3))                        # (Pb, Qb, Kh, Kw)
    keep = _select(g, rate, threshold)
    keep = keep[:, None, :, None].expand(P // bp, bp, Q // bq, bq, Kh, Kw)
    return keep.reshape(P, Q, Kh, Kw).float()


# -- pattern-based (3x3 CONV only) -------------------------------------------

# The canonical 8-pattern set (paper §2.1.1): center + 3 of the 4
# edge-adjacent cells, and the 4 corner variants, in the reference's order.
_PATTERN_CELLS = (
    ((1, 1), (0, 1), (1, 0), (1, 2)),   # T-up
    ((1, 1), (2, 1), (1, 0), (1, 2)),   # T-down
    ((1, 1), (0, 1), (2, 1), (1, 0)),   # T-left
    ((1, 1), (0, 1), (2, 1), (1, 2)),   # T-right
    ((1, 1), (0, 0), (0, 1), (1, 0)),   # corner NW
    ((1, 1), (0, 1), (0, 2), (1, 2)),   # corner NE
    ((1, 1), (1, 0), (2, 0), (2, 1)),   # corner SW
    ((1, 1), (1, 2), (2, 1), (2, 2)),   # corner SE
)
PATTERN_SET = torch.zeros((8, 3, 3), dtype=torch.float32)
for _i, _cells in enumerate(_PATTERN_CELLS):
    for _r, _c in _cells:
        PATTERN_SET[_i, _r, _c] = 1.0


def connectivity_mask(w, rate=None, threshold=None):
    """Connectivity pruning alone: whole (p, q) kernels with the smallest
    L2 norms die, any kernel size.  w: (P, Q, Kh, Kw)."""
    sq = torch.square(w.float())
    g = sq.sum(dim=(-1, -2))                      # (P, Q)
    keep = _select(g, rate, threshold)
    return keep[..., None, None].expand(w.shape).float()


def pattern_mask(w, connectivity_rate=0.0):
    """Kernel-pattern pruning (+ optional connectivity pruning) for 3x3
    CONV: each kernel gets the pattern of the 8-set that keeps the most
    magnitude (the first one on a tie); connectivity pruning then removes
    whole kernels.  w: (P, Q, 3, 3)."""
    if tuple(w.shape[-2:]) != (3, 3):
        raise ValueError("pattern-based pruning is 3x3-only (§2.1.1), got "
                         f"kernel {tuple(w.shape[-2:])}")
    sq = torch.square(w.float())
    pats = PATTERN_SET.to(w.device)
    scores = torch.einsum("pqhw,khw->pqk", sq, pats)     # (P, Q, 8)
    best = torch.argmax(scores, dim=-1)                   # (P, Q)
    mask = pats[best]                                     # (P, Q, 3, 3)
    if connectivity_rate > 0:
        knorm = sq.sum(dim=(-1, -2))                      # (P, Q)
        mask = mask * (knorm > quantile(knorm, connectivity_rate))[
            ..., None, None]
    return mask.float()


def make_mask(w, scheme, block=(64, 128), rate=None, threshold=None,
              connectivity_rate=0.0):
    """The scheme dispatch of the reference, for the schemes this slice
    serves."""
    if scheme == "none":
        return torch.ones(w.shape, dtype=torch.float32, device=w.device)
    if scheme == "block_punched":
        return block_punched_mask(w, block, rate, threshold)
    if scheme == "pattern":
        return pattern_mask(w, connectivity_rate)
    if scheme in SCHEMES:
        raise NotImplementedError(
            f"scheme {scheme!r} masks come with port slice 6 (pruning, "
            f"mapping and training)")
    raise ValueError(scheme)
