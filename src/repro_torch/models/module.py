"""Parameter init and nested-dict tree helpers.

Models are plain functions over nested-dict param trees (the reference's
layout, so the tests compare like with like); leaves are tensors, or a
``core.packed.PackedLayout`` under a ``"packed"`` key once
``serve.compile.compile_model`` has run.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; a CUDA
    device without a card is an error, never a silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev


def dense_init(shape, generator, dtype=torch.bfloat16, device="cpu",
               scale: float | None = None):
    """Truncated-normal (fan-in) init used for all projection matrices:
    a standard normal truncated to [-2, 2], times ``fan_in ** -0.5``.
    Drawn in fp32 one leading slice at a time (bounds the fp32 temporary
    at full width), then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for s in flat:
        tmp = torch.empty(s.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        s.copy_(tmp * scale)
    return out


def embed_init(shape, generator, dtype=torch.bfloat16, device="cpu"):
    """Normal(0, 0.02) embedding table."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)


def path_str(path) -> str:
    """'/'-joined key path, the reference's naming for leaves."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, path=()):
    """Apply ``fn(path_str, leaf)`` to every non-dict leaf of a nested
    dict, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path_str(path), tree)


def tree_map(fn, tree, *rest):
    """``fn(x, *ys)`` over nested dicts of ``tree``'s structure (the
    others may hold more keys), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def take_layer(tree, i):
    """Slice stack index ``i`` out of every leaf (tensors and packed
    layouts; a ``DegradedLayer`` marker retires its whole stack and is
    its own slice) — one layer of a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: take_layer(v, i) for k, v in tree.items()}
    if hasattr(tree, "layer"):
        return tree.layer(i)
    return tree[i]
