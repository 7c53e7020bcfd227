"""The benchmark's own weights and masks for a decoder LM, drawn on the
device from the seed.

Every value comes from here, none from the port's ``init_lm`` or its mask
functions.  The tree has the port's layout (layer leaves stacked on a
leading dim: ``layers/{ln1, attn/{wq,wk,wv,wo}, ln2, ffn/{gate,up,down}}``
or ``moe/{router, gate, up, down}`` with an expert dim), because the port's
``compile_model`` takes it; the reference reads the same tensors.

- Projections: N(0, 1) times fan_in ** -0.5, drawn in bf16 (the served
  type), one call a stacked leaf.  The router is fp32, as the port serves
  it.  Embedding and head: N(0, 0.02).  Norm scales: ones.
- Masks: one-shot magnitude pruning at whole blocks.  The blocks of a
  stacked leaf whose squared L2 norms are at or below the ``rate``
  quantile of the whole leaf die; the weights are zeroed in place, so the
  tree holds the masked weights.
"""
from __future__ import annotations

import re

import torch


def _leaves(tree, path=""):
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _set(tree, path, value):
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def draw(conf, seed, device):
    """(params, masks, live) for ``conf`` (the configuration file's
    ``model`` and ``scheme``) from ``seed``: the masked weights, the
    element masks of the pruned leaves (the port's mask tree: other leaves
    absent), and for each pruned leaf its live blocks per slice (a
    (layers,) or (layers, experts) int64 tensor on the host) with its
    (K, N) and block."""
    m = conf["model"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    bf = torch.bfloat16
    n, d, hd = m["num_hidden_layers"], m["hidden_size"], m["head_dim"]
    q, kv = m["num_attention_heads"] * hd, m["num_key_value_heads"] * hd
    ff, V = m["intermediate_size"], m["vocab_size"]

    def proj(*shape, dtype=bf):
        t = torch.randn((n,) + shape, generator=gen, dtype=dtype, device=dev)
        return {"w": t.mul_(shape[-2] ** -0.5)}

    def ones():
        return {"scale": torch.ones((n, d), dtype=bf, device=dev)}

    layers = {"ln1": ones(),
              "attn": {"wq": proj(d, q), "wk": proj(d, kv),
                       "wv": proj(d, kv), "wo": proj(q, d)},
              "ln2": ones()}
    E = m.get("num_local_experts", 0)
    if E:
        layers["moe"] = {"router": proj(d, E, dtype=torch.float32),
                         "gate": proj(E, d, ff), "up": proj(E, d, ff),
                         "down": proj(E, ff, d)}
    else:
        layers["ffn"] = {"gate": proj(d, ff), "up": proj(d, ff),
                         "down": proj(ff, d)}

    def table():
        t = torch.randn((V, d), generator=gen, dtype=bf, device=dev)
        return {"table": t.mul_(0.02)}
    params = {"embed": table(), "head": table(),
              "norm_f": {"scale": torch.ones((d,), dtype=bf, device=dev)},
              "layers": layers}
    masks, live = prune(params, conf["scheme"])
    return params, masks, live


def prune(params, scheme):
    """Zero the dead blocks of every leaf ``scheme["targets"]`` matches, in
    place; returns (element masks, live block counts) as ``draw`` does."""
    bk, bn = scheme["block"]
    rate = float(scheme["rate"])
    pat = re.compile(scheme["targets"])
    masks, live = {}, {}
    for path, w in list(_leaves(params)):
        if not pat.search(path):
            continue
        *lead, K, N = w.shape
        flat = w.view(-1, K, N)
        # block norms a slice at a time: an fp32 square of a whole expert
        # stack would be several GB
        g = torch.stack([s.float().square().reshape(K // bk, bk, N // bn, bn)
                         .sum(dim=(1, 3)) for s in flat])
        k = max(1, int(round(rate * g.numel())))
        thresh = torch.kthvalue(g.reshape(-1), k).values
        keep = g > thresh                                  # (S, Kb, Nb)
        mask = keep.repeat_interleave(bk, 1).repeat_interleave(bn, 2)
        flat.mul_(mask.to(w.dtype))
        _set(masks, path, mask.view(w.shape))
        live[path] = {"blocks": keep.sum(dim=(1, 2)).view(lead).cpu(),
                      "shape": (K, N), "block": (bk, bn)}
    return masks, live
