"""Pruning regularities (paper §2.1.1 + §4.1) as mask generators, every
scheme of the reference:

  - unstructured                (Fig 1 a,b)       — any-location magnitude
  - structured row / column     (Fig 1 c,d)       — whole-matrix granularity
  - pattern-based               (Fig 1 e)         — 3x3 CONV only: 4-entry
      kernel patterns from a fixed 8-pattern set + connectivity pruning
  - block-based                 (Fig 1 g, §4.1.1) — FC: independent row/col
      pruning inside equal (p x q) blocks
  - block-punched               (Fig 1 f, §4.1.2) — CONV: same intra-kernel
      positions pruned across all kernels of a (p x q)-kernel block

Conventions as in the reference: FC weights are (..., in, out) with any
leading batch dims (layer stacks, expert dims); CONV weights are (P, Q,
Kh, Kw) = (filters, in_channels, kh, kw); masks are float32 {0, 1} of the
weight shape.  Two selection modes everywhere:

  rate=r        prune the r-fraction of groups with the smallest L2 norms
                (a linear-interpolated quantile over the whole leaf)
  threshold=t   prune groups with squared norm < t (the reweighted
                algorithm's automatic-rate mode, §4.2)
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


# ---------------------------------------------------------------------------
# Block partitioning helpers (last-2-dims blocks, leading dims = batch)
# ---------------------------------------------------------------------------

def _to_blocks(w, bp, bq):
    """(..., P, Q) -> (..., Pb, Qb, bp, bq).  A block that does not tile
    the leaf raises ``AssertionError``, the reference's class for it."""
    *lead, Pd, Qd = w.shape
    if Pd % bp or Qd % bq:
        raise AssertionError((tuple(w.shape), bp, bq))
    w = w.reshape(*lead, Pd // bp, bp, Qd // bq, bq)
    return w.movedim(-3, -2)            # (..., Pb, Qb, bp, bq)


def _from_blocks(wb):
    """inverse of _to_blocks"""
    *lead, Pb, Qb, bp, bq = wb.shape
    wb = wb.movedim(-2, -3)             # (..., Pb, bp, Qb, bq)
    return wb.reshape(*lead, Pb * bp, Qb * bq)


def _select(sqnorms, rate=None, threshold=None):
    """Keep-mask over groups: ``threshold`` keeps sqnorm >= t (compared in
    float32, as a weakly typed scalar is in the reference); ``rate``
    prunes the smallest-``rate`` fraction (quantile over all of
    ``sqnorms``)."""
    if threshold is not None:
        return sqnorms >= torch.tensor(threshold, dtype=sqnorms.dtype,
                                       device=sqnorms.device)
    if rate is None:
        raise ValueError("_select needs a rate or a threshold")
    return sqnorms > quantile(sqnorms, rate)


# ---------------------------------------------------------------------------
# Schemes
# ---------------------------------------------------------------------------

def unstructured_mask(w, rate=None, threshold=None):
    sq = torch.square(w.float())
    return _select(sq, rate, threshold).float()


def structured_mask(w, rate=None, threshold=None, axis="row"):
    """Whole-matrix row (output-filter) / column pruning — Fig 1(c,d).
    'row' prunes along P (second-to-last dim), 'col' along Q (last dim)."""
    sq = torch.square(w.float())
    if axis == "row":
        keep = _select(sq.sum(dim=-1), rate, threshold)       # (..., P)
        return keep[..., :, None].expand(w.shape).float()
    keep = _select(sq.sum(dim=-2), rate, threshold)           # (..., Q)
    return keep[..., None, :].expand(w.shape).float()


def _both_rate(rate):
    """Each of the row and column selections of mode 'both' prunes
    1 - sqrt(1 - rate), so that together ~rate of the weights die."""
    return 1 - (1 - rate) ** 0.5 if rate is not None else None


def block_mask(w, block, rate=None, threshold=None, mode="both"):
    """Block-based pruning for FC (§4.1.1): independent row + column
    pruning per (bp x bq) block.  mode in {'row', 'col', 'both'}.  Group
    sq-norms are per-block rows / cols; the kept set is chosen globally
    in the layer."""
    bp, bq = block
    wb = _to_blocks(w, bp, bq)                    # (..., Pb, Qb, bp, bq)
    sq = torch.square(wb.float())
    keep = torch.ones(wb.shape, dtype=torch.float32, device=w.device)
    if mode in ("row", "both"):
        r = rate if mode == "row" else _both_rate(rate)
        k = _select(sq.sum(dim=-1), r, threshold)   # (..., Pb, Qb, bp)
        keep = keep * k[..., :, None].float()
    if mode in ("col", "both"):
        r = rate if mode == "col" else _both_rate(rate)
        k = _select(sq.sum(dim=-2), r, threshold)   # (..., Pb, Qb, bq)
        keep = keep * k[..., None, :].float()
    return _from_blocks(keep)


def block_punched_mask(w, block, rate=None, threshold=None):
    """Block-punched pruning for CONV (§4.1.2): weights at the same (m, n)
    kernel location across ALL kernels of a (bp x bq)-kernel block are
    pruned together.  w: (P, Q, Kh, Kw).  A kernel block that does not
    tile (P, Q) raises ``AssertionError``, the reference's class."""
    bp, bq = block
    P, Q, Kh, Kw = w.shape
    if P % bp or Q % bq:
        raise AssertionError(f"kernel block {block} does not tile (P={P}, "
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


# ---------------------------------------------------------------------------
# Dispatch + stats
# ---------------------------------------------------------------------------

def make_mask(w, scheme, block=(64, 128), rate=None, threshold=None,
              connectivity_rate=0.0):
    if scheme == "none":
        return torch.ones(w.shape, dtype=torch.float32, device=w.device)
    if scheme == "unstructured":
        return unstructured_mask(w, rate, threshold)
    if scheme == "structured_row":
        return structured_mask(w, rate, threshold, "row")
    if scheme == "structured_col":
        return structured_mask(w, rate, threshold, "col")
    if scheme == "block":
        return block_mask(w, block, rate, threshold, "both")
    if scheme == "block_row":
        return block_mask(w, block, rate, threshold, "row")
    if scheme == "block_col":
        return block_mask(w, block, rate, threshold, "col")
    if scheme == "block_punched":
        return block_punched_mask(w, block, rate, threshold)
    if scheme == "pattern":
        return pattern_mask(w, connectivity_rate)
    raise ValueError(scheme)


def density(mask) -> float:
    return float(torch.mean(mask.float()))


def compression_rate(mask) -> float:
    return 1.0 / max(density(mask), 1e-9)


def legal_blocks(P, Q, menu=((4, 4), (8, 16), (16, 32), (32, 64), (64, 128),
                             (128, 32), (128, 64), (128, 128), (128, 256),
                             (256, 256))):
    """The block-size menu restricted to divisors of the layer dims."""
    return [(p, q) for (p, q) in menu if P % p == 0 and Q % q == 0]
