"""Masked-dense training semantics: pruning masks multiply the params
before the forward pass (the serving path packs them instead)."""
from __future__ import annotations

from repro_torch.models import module as M


def apply_masks(params, masks):
    """masks is a full-structure tree: {0,1} tensors for prunable leaves,
    scalar sentinels elsewhere (see ``core.reweighted``)."""
    if masks is None:
        return params
    return M.tree_map2(
        lambda p, m: p if m.ndim == 0 else p * m.to(p.dtype), params, masks)
