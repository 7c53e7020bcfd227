"""Scheme choices and the one-shot whole-block masks (paper §4.2's
structured collapse, as the serving path uses it).

A prune spec is an ordered list of (path-regex, SchemeChoice); the first
match wins and non-matching leaves are never pruned.  Mask trees mirror the
param tree: a bool mask for each pruned leaf, a scalar 1.0 sentinel
elsewhere (so ``train.trainer.apply_masks`` is a plain tree map).
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.models import module as M


@dataclass(frozen=True)
class SchemeChoice:
    scheme: str = "block"
    block: tuple = (64, 128)
    rate: float | None = None        # target rate for one-shot mode


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


def magnitude_block_masks(params, spec, block=(16, 16), rate=0.5):
    """One-shot magnitude pruning at whole-block granularity: the
    ``rate``-fraction of blocks with the smallest L2 norms die outright.
    The quantile runs over the WHOLE stacked leaf (all layers together).
    ``block=None`` prunes each matched leaf at its rule's own block."""

    def keep_fn(s, leaf, grid):
        *lead, P, Q = leaf.shape
        bk, bn = P // grid[-2], Q // grid[-1]
        sq = torch.square(leaf.float())
        g = sq.reshape(*lead, P // bk, bk, Q // bn, bn).sum(dim=(-3, -1))
        return g > quantile(g, rate)

    return block_masks_from(params, spec, block, keep_fn)
