"""Parameter init and nested-dict tree helpers.

Models are plain functions over nested-dict param trees (the reference's
layout, so the tests compare like with like); leaves are tensors, or a
``core.packed.PackedLayout`` under a ``"packed"`` key once
``serve.compile.compile_model`` has run.

Sharding is assigned by path-pattern rules (``spec_from_rules``) to ``P``
partition specs, the port's own counterpart of JAX's ``PartitionSpec``;
``P.placements`` turns one into ``torch.distributed.tensor`` placements
on a named ``DeviceMesh``.
"""
from __future__ import annotations

import re

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
    if out.is_meta:                 # shapes alone: nothing to draw
        return out
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for s in flat:
        tmp = torch.empty(s.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        s.copy_(tmp * scale)
    return out


def embed_init(shape, generator, dtype=torch.bfloat16, device="cpu"):
    """Normal(0, 0.02) embedding table."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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


# -- Path-rule sharding --------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of axis names (the dim split over them,
    the first the outermost; one name alone stands for itself, as in
    JAX's ``PartitionSpec``).  A tuple, so specs compare by value."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"

    def axes(self) -> dict:
        """Mesh axis name -> the tensor dim it shards."""
        out = {}
        for dim, entry in enumerate(self):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    out[name] = dim
        return out

    def placements(self, mesh) -> tuple:
        """``torch.distributed.tensor`` placements of this spec on a
        ``DeviceMesh`` with named dims: ``Shard(d)`` on each mesh dim that
        shards tensor dim d, ``Replicate()`` on the rest.  A split over a
        mesh dim of size 1 is no split: it is ``Replicate()`` too, so the
        one-rank mesh runs every op on whole tensors."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = self.axes()
        unknown = set(by_axis) - set(mesh.mesh_dim_names)
        if unknown:
            raise ValueError(f"spec {self} names axes {sorted(unknown)} the "
                             f"mesh {mesh.mesh_dim_names} does not have")
        return tuple(Shard(by_axis[name])
                     if name in by_axis and mesh.size(i) > 1 else Replicate()
                     for i, name in enumerate(mesh.mesh_dim_names))


def spec_from_rules(params, rules, default=P()):
    """A ``P`` tree matching ``params`` from (regex, spec) rules: the
    first rule whose pattern ``re.search``-es a leaf's path wins; a spec
    is right-aligned to the leaf's rank (``P("data", "model")`` on a
    rank-3 stacked leaf is ``P(None, "data", "model")``), a spec longer
    than the rank keeps its trailing entries; no match gives
    ``default``, right-aligned the same way."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def assign(path, leaf):
        nd = len(leaf.shape)
        for pat, spec in compiled:
            if pat.search(path):
                pad = nd - len(spec)
                if pad < 0:          # as the reference's: trim the front
                    return P(*spec[-nd:])
                return P(*([None] * pad + list(spec)))
        pad = nd - len(default)
        return P(*([None] * max(pad, 0) + list(default)))

    return tree_map_with_path(assign, params)
