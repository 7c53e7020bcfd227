"""Scheme choices and the masks they give: whole blocks of FC weights
(paper §4.2's structured collapse, magnitude or random), block-punched
conv kernels (§4.1.2), pattern/connectivity conv masks (§2.1.1), every
scheme of ``core.regularity`` through ``masks_for_spec`` (at a rate, or at
one global threshold over the reweighted penalty's groups, §4.2), and
the per-layer sparsity report; and the reweighted group-lasso penalty
of the paper's Eq. (1) that training adds (``ReweightedConfig``,
``init_alphas``, ``update_alphas``, ``penalty``):

    R(alpha, W) = sum_g alpha_g * ||group_g(W)||_F^2,
    alpha_g = 1 / (||group_g(W)||_F^2 + eps), re-estimated every T steps.

A prune spec is an ordered list of (path-regex, SchemeChoice); the first
match wins and non-matching leaves are never pruned.  Mask trees mirror the
param tree: a {0, 1} mask for each pruned leaf (bool for whole FC blocks,
float32 for conv masks, as in the reference), a scalar 1.0 sentinel
elsewhere (so ``train.trainer.apply_masks`` is a plain tree map).
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass

import torch

from repro_torch.core import regularity as R
from repro_torch.core.regularity import quantile  # noqa: F401 (re-export)
from repro_torch.models import module as M


@dataclass(frozen=True)
class SchemeChoice:
    scheme: str = "block"
    block: tuple = (64, 128)
    rate: float | None = None        # target rate for one-shot mode
    connectivity: float = 0.0        # pattern-based extra kernel pruning
    value_dtype: str | None = None   # serving precision pick (None = keep
    #                                  float values; "int8" = quantized
    #                                  packed values, see core.quant)


@dataclass(frozen=True)
class ReweightedConfig:
    spec: tuple                      # PruneSpec as a tuple (hashable)
    lam: float = 1e-4
    eps: float = 1e-4
    reweight_every: int = 20


def match(spec, path: str) -> SchemeChoice | None:
    for pat, choice in spec:
        if re.search(pat, path):
            return choice
    return None


def _sentinel(leaf):
    return torch.ones((), dtype=torch.float32, device=leaf.device)


def _leaves(tree, path=""):
    """(path_str, leaf) of every non-dict leaf of a nested dict, in the
    tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _iter_prunable(params, spec):
    """(path, leaf, choice) of every leaf the reweighted penalty groups:
    matched by a rule whose scheme is neither "none" nor "pattern"
    (pattern is assigned one-shot), at least 2-D."""
    for s, leaf in _leaves(params):
        choice = match(spec, s)
        if choice is not None and choice.scheme not in ("none", "pattern") \
                and leaf.ndim >= 2:
            yield s, leaf, choice


def group_sqnorms(w, choice: SchemeChoice) -> dict:
    """{group_kind: sqnorm tensor} of the penalty groups of ``w`` (fp32)."""
    sq = torch.square(w.float())
    sch = choice.scheme
    if sch == "unstructured":
        return {"w": sq}
    if sch == "structured_row":
        return {"row": sq.sum(dim=-1)}
    if sch == "structured_col":
        return {"col": sq.sum(dim=-2)}
    if sch in ("block", "block_row", "block_col"):
        bp, bq = choice.block
        wb = R._to_blocks(sq, bp, bq)             # (..., Pb, Qb, bp, bq)
        out = {}
        if sch in ("block", "block_row"):
            out["row"] = wb.sum(dim=-1)           # (..., Pb, Qb, bp)
        if sch in ("block", "block_col"):
            out["col"] = wb.sum(dim=-2)           # (..., Pb, Qb, bq)
        return out
    if sch == "block_punched":
        bp, bq = choice.block
        P, Q, Kh, Kw = w.shape
        return {"punch": sq.reshape(P // bp, bp, Q // bq, bq, Kh, Kw).sum(
            dim=(1, 3))}
    raise ValueError(sch)


def init_alphas(params, spec):
    """{path: {group kind: ones}} for every penalised leaf (fp32)."""
    return {path: {k: torch.ones_like(v)
                   for k, v in group_sqnorms(leaf, choice).items()}
            for path, leaf, choice in _iter_prunable(params, spec)}


def update_alphas(params, cfg: ReweightedConfig):
    """alpha = 1 / (||group||_F^2 + eps), from the current params (no
    gradient flows through them)."""
    with torch.no_grad():
        return {path: {k: 1.0 / (v + cfg.eps)
                       for k, v in group_sqnorms(leaf, choice).items()}
                for path, leaf, choice in _iter_prunable(params, cfg.spec)}


def penalty(params, alphas, cfg: ReweightedConfig):
    """Eq. (1)'s regularisation term: sum over penalised leaves and their
    groups of alpha * ||group||_F^2 (alphas held constant), an fp32
    scalar; leaves without alphas add nothing."""
    return sum((torch.sum(alphas[path][k] * sq)
                for path, leaf, choice in _iter_prunable(params, cfg.spec)
                if path in alphas
                for k, sq in group_sqnorms(leaf, choice).items()),
               torch.zeros(()))


def normalised_groups(params, spec):
    """Every penalised group's sqnorm divided by the mean of its leaf's
    groups of that kind, in one flat fp32 tensor (empty without any)."""
    return torch.cat([(sq / (torch.mean(sq) + 1e-30)).reshape(-1)
                      for _, leaf, choice in _iter_prunable(params, spec)
                      for sq in group_sqnorms(leaf, choice).values()]
                     or [torch.zeros(0)])


def global_threshold(params, spec, target_rate: float) -> float:
    """One threshold tau over ALL group norms such that ~target_rate of
    groups fall below it.  Each leaf's group sqnorms are divided by their
    mean first (scale invariance: layers at different init scales compete
    on relative group importance); ``masks_for_spec(threshold=tau)``
    scales tau back by each leaf's mean.  The sort runs on the leaves'
    device (it is exact, so the value does not depend on where)."""
    rel = normalised_groups(params, spec)
    if not rel.numel():
        return 0.0
    return float(R.quantile(rel, target_rate))


def block_masks_from(params, spec, block, keep_fn):
    """Shared scaffold for whole-(bk, bn)-block mask trees: spec matching,
    sentinel handling, block-tiling guard, and block->element expansion.
    ``keep_fn(path_str, leaf, (*lead, Pb, Qb) grid shape) -> bool keep
    grid``.  ``block=None`` uses each matched rule's own ``choice.block``."""

    def build(s, leaf):
        choice = match(spec, s)
        if choice is None or leaf.ndim < 2:
            return _sentinel(leaf)
        bk, bn = block if block is not None else choice.block
        *lead, P, Q = leaf.shape
        if P % bk or Q % bn:     # block must tile the leaf
            return _sentinel(leaf)
        keep = keep_fn(s, leaf, (*lead, P // bk, Q // bn))
        return keep.repeat_interleave(bk, -2).repeat_interleave(bn, -1)

    return M.tree_map_with_path(build, params)


def magnitude_block_masks(params, spec, block=(16, 16), rate=0.5):
    """One-shot magnitude pruning at whole-block granularity: the
    ``rate``-fraction of blocks with the smallest L2 norms die outright.
    The quantile runs over the WHOLE stacked leaf (all layers together).
    ``block=None`` prunes each matched leaf at its rule's own block."""

    def keep_fn(s, leaf, grid):
        *lead, P, Q = leaf.shape
        bk, bn = P // grid[-2], Q // grid[-1]
        # block norms one (P, Q) slice at a time: an fp32 square of a whole
        # expert stack would copy it twice over (7.5 GB each at mixtral's
        # 4 x 8 x 4096 x 14336); the sums are the same numbers
        g = torch.stack([
            torch.square(w.float()).reshape(P // bk, bk, Q // bn, bn).sum(
                dim=(-3, -1)) for w in leaf.reshape(-1, P, Q)])
        g = g.reshape(*lead, P // bk, Q // bn)
        return g > quantile(g, rate)

    return block_masks_from(params, spec, block, keep_fn)


def random_block_masks(params, spec, block=(16, 16), keep_prob=0.5, seed=0):
    """Bernoulli whole-block masks on spec-matched leaves, scalar sentinels
    elsewhere: each leaf's blocks are drawn from a ``torch.Generator``
    seeded with crc32(path) + seed (not ``hash()``), so the outcome is
    stable across calls and processes.  The draws are torch's, not the
    reference's PRNG."""

    def keep_fn(s, leaf, grid):
        g = torch.Generator(device=leaf.device)
        g.manual_seed((zlib.crc32(s.encode()) + seed) % (2 ** 31))
        return torch.rand(grid, generator=g, device=leaf.device) < keep_prob

    return block_masks_from(params, spec, block, keep_fn)


def masks_for_spec(params, spec, threshold=None, default_rate=None):
    """Full-structure mask tree: float32 {0, 1} masks for prunable leaves,
    scalar sentinels elsewhere.  A ``pattern`` choice gives 3x3 conv
    kernels ``pattern_mask`` (with the choice's connectivity), other 4-D
    kernels ``connectivity_mask`` when ``connectivity > 0``, and leaves
    the rest unpruned; other schemes go through ``regularity.make_mask``:
    with ``threshold`` (``global_threshold``'s, on mean-normalised group
    sqnorms) at that threshold times the leaf's mean group sqnorm (its
    first group kind's), else at ``choice.rate`` (else
    ``default_rate``)."""

    def build(s, leaf):
        choice = match(spec, s)
        if choice is None or choice.scheme == "none" or leaf.ndim < 2:
            return _sentinel(leaf)
        if choice.scheme == "pattern":
            if leaf.ndim == 4 and tuple(leaf.shape[-2:]) == (3, 3):
                return R.pattern_mask(leaf, choice.connectivity)
            if leaf.ndim == 4 and choice.connectivity > 0:
                return R.connectivity_mask(leaf, rate=choice.connectivity)
            return _sentinel(leaf)
        if threshold is not None:
            sq1 = next(iter(group_sqnorms(leaf, choice).values()))
            mean_sq = float(torch.mean(sq1))
            return R.make_mask(leaf, choice.scheme, choice.block,
                               threshold=threshold * (mean_sq + 1e-30))
        rate = choice.rate if choice.rate is not None else default_rate
        return R.make_mask(leaf, choice.scheme, choice.block, rate=rate,
                           connectivity_rate=choice.connectivity)

    return M.tree_map_with_path(build, params)


def punched_conv_masks(params, spec, block=(8, 8), rate=0.5):
    """One-shot magnitude block-punched masks (§4.1.2) on spec-matched 4-D
    (P, Q, Kh, Kw) conv leaves, scalar sentinels elsewhere.  ``block=None``
    punches each leaf at its matched rule's own ``choice.block``.  Leaves
    the block cannot tile (e.g. a 3-channel stem) stay unpruned."""

    def build(s, leaf):
        choice = match(spec, s)
        if choice is None or leaf.ndim != 4:
            return _sentinel(leaf)
        bp, bq = block if block is not None else choice.block
        P, Q = leaf.shape[:2]
        if P % bp or Q % bq:
            return _sentinel(leaf)
        return R.block_punched_mask(leaf, (bp, bq), rate=rate)

    return M.tree_map_with_path(build, params)


def sparsity_report(params, masks) -> dict:
    """Per-layer + overall density/compression: a row per masked leaf
    (the mask at the leaf's path), sentinel leaves counted dense in
    ``__overall__``."""
    rep, tot_w, tot_kept = {}, 0, 0.0
    for s, p in _leaves(params):
        m = masks
        for k in s.split("/"):
            m = m[k]
        if m.ndim == 0:     # sentinel
            tot_w += p.numel()
            tot_kept += p.numel()
            continue
        kept = float(torch.sum(m.float()))
        rep[s] = {"density": kept / m.numel(),
                  "compression": m.numel() / max(kept, 1.0)}
        tot_w += p.numel()
        tot_kept += kept
    rep["__overall__"] = {"density": tot_kept / tot_w,
                          "compression": tot_w / max(tot_kept, 1.0)}
    return rep
