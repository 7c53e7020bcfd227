"""Layer-fusion decisions (paper §4.3 + Appendix A.1), ported from the
reference.

What a compiler-aware pruning framework owns beyond elementwise fusion:
  * QKV fusion: wq/wk/wv share the input activation — fusing them into one
    (D, (H+2KV)*hd) block-sparse GEMM reads x from memory once.
  * gate/up fusion: the same for the SwiGLU pair.
  * epilogue fusion: bias + activation + dequant folded into the kernel's
    epilogue (kernel 1 already does this) instead of a second pass.
Fusion legality for *pruned* layers: fused weights must share the pruning
block grid along the shared (input) dimension — enforced here.  Nothing
applies the plan in the compile path yet, as in the reference."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.reweighted import match


@dataclass(frozen=True)
class FusionPlan:
    groups: tuple          # tuple of tuples of param paths fused together
    saved_hbm_reads: int   # activation bytes saved per application


def plan_fusions(cfg, tokens: int) -> FusionPlan:
    D = cfg.d_model
    groups = []
    if cfg.n_heads:
        groups.append(("attn/wq/w", "attn/wk/w", "attn/wv/w"))
    if cfg.d_ff:
        groups.append(("ffn/gate/w", "ffn/up/w"))
    saved = tokens * D * 2 * (len(groups))
    return FusionPlan(groups=tuple(groups), saved_hbm_reads=saved)


def fusion_legal(spec, paths) -> bool:
    """Fused members must share block row-granularity on the K dim."""
    choices = [match(spec, p) for p in paths]
    if any(c is None for c in choices):
        return False
    bks = {c.block[0] for c in choices if c.scheme.startswith("block")}
    return len(bks) <= 1


def fuse_weights(ws) -> torch.Tensor:
    """Concatenate along the output dim: (K, N1+N2+...)."""
    return torch.cat(list(ws), dim=-1)
