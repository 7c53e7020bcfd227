"""Scheme choices and the one-shot masks the serving paths use: whole
blocks of FC weights (paper §4.2's structured collapse), block-punched
conv kernels (§4.1.2) and pattern/connectivity conv masks (§2.1.1).

A prune spec is an ordered list of (path-regex, SchemeChoice); the first
match wins and non-matching leaves are never pruned.  Mask trees mirror the
param tree: a {0, 1} mask for each pruned leaf (bool for whole FC blocks,
float32 for conv masks, as in the reference), a scalar 1.0 sentinel
elsewhere (so ``train.trainer.apply_masks`` is a plain tree map).
"""
from __future__ import annotations

import re
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


def match(spec, path: str) -> SchemeChoice | None:
    for pat, choice in spec:
        if re.search(pat, path):
            return choice
    return None


def _sentinel(leaf):
    return torch.ones((), dtype=torch.float32, device=leaf.device)


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


def masks_for_spec(params, spec, threshold=None, default_rate=None):
    """Full-structure mask tree: float32 {0, 1} masks for prunable leaves,
    scalar sentinels elsewhere.  A ``pattern`` choice gives 3x3 conv
    kernels ``pattern_mask`` (with the choice's connectivity), other 4-D
    kernels ``connectivity_mask`` when ``connectivity > 0``, and leaves
    the rest unpruned; other schemes go through ``regularity.make_mask``
    at ``choice.rate`` (else ``default_rate``)."""
    if threshold is not None:
        raise NotImplementedError(
            "masks_for_spec(threshold=...) (group_sqnorms / "
            "global_threshold) comes with port slice 6")

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
