"""Plain float32 reference of a block-pruned decoder LM as the engine
serves it: a llama-style dense decoder (yi-9b) or a top-k mixture of
experts (mixtral-8x7b), on the masked weights the benchmark drew.

It runs one full forward over each prompt with its served tokens and
returns the logits at the positions that produced them.  It states the
served path's two rules as the program does:

- The decode window is the prompt length.  A request's ring holds as many
  positions as its prompt, and each decoded token overwrites the oldest,
  so the token at position q sees the keys at positions q - P < k <= q (P
  the prompt length; the model's own sliding window, where it is
  shorter, too).  For the prompt itself that is plain causal attention.
- Experts have a capacity in the prompt.  The prompt's tokens are routed
  in groups of min(group, P) (P a whole number of groups); an expert keeps
  the first C = min(Sg, max(4, int(Sg * top_k / E * capacity_factor)))
  tokens of a group that pick it, in position order, and drops the rest
  (their gate weight is lost, the others are not renormalised).  Decoded
  tokens are routed one by one and never dropped.

Layer by layer over every sequence, each layer's weights cast to float32
once, attention in blocks of query rows, so that it fits beside nothing
else on the card.
"""
from __future__ import annotations

import torch

QUERY_BLOCK = 512


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (S, heads, hd) at positions 0..S-1; half-split rotation."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window):
    """q (S, H, hd), k / v (S, KV, hd): key k seen by query q iff
    q - window < k <= q."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        s = torch.einsum("qhe,khe->hqk", q[a:b], k) * hd ** -0.5
        qp = pos[a:b, None]
        seen = (pos[None, :] <= qp) & (pos[None, :] > qp - window)
        s = s.masked_fill(~seen, float("-inf"))
        out[a:b] = torch.einsum("hqk,khe->qhe", torch.softmax(s, -1), v)
    return out


def _swiglu(h, gate, up, down):
    return (torch.nn.functional.silu(h @ gate) * (h @ up)) @ down


def _moe(h, P, lw, m):
    """Top-k experts of every token; the first P tokens (the prompt) under
    the capacity rule, the rest dropless."""
    S = h.shape[0]
    E, k = m["num_local_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(h @ lw["router"], dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)                       # (S, k)
    top = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(top, dtype=torch.bool)
    Sg = min(int(m["moe_group"]), P)
    if P % Sg:
        raise ValueError(f"a prompt of {P} tokens is no whole number of "
                         f"groups of {Sg}")
    C = min(Sg, max(4, int(Sg * k / E * float(m["capacity_factor"]))))
    for g0 in range(0, P, Sg):
        for e in range(E):
            # rank of each pick of expert e among the group's, in order
            picks = idx[g0:g0 + Sg] == e                          # (Sg, k)
            rank = torch.cumsum(picks.any(-1).long(), 0) - 1
            keep[g0:g0 + Sg] &= ~(picks & (rank[:, None] >= C))
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], lw["gate"][e], lw["up"][e], lw["down"][e])
        out.index_add_(0, tok, y * top[tok, slot][:, None])
    assert out.shape[0] == S
    return out


def _layer(params, i, m):
    """Layer ``i``'s weights in float32."""
    L = params["layers"]
    f32 = {"ln1": L["ln1"]["scale"][i].float(),
           "ln2": L["ln2"]["scale"][i].float()}
    for p in ("wq", "wk", "wv", "wo"):
        f32[p] = L["attn"][p]["w"][i].float()
    ff = L["moe"] if "moe" in L else L["ffn"]
    for p in ff:
        f32[p] = ff[p]["w"][i].float()
    return f32


def logits(params, m, seqs):
    """``seqs``: (token ids (S,) int64 on the card, prompt length P) of
    each request, its prompt followed by every served token but the last.
    Returns, a sequence, the float32 logits (S - P + 1, V) at positions
    P - 1 .. S - 1: the ones that chose each served token."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(params, m, seqs)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@torch.no_grad()
def _logits(params, m, seqs):
    eps, theta = float(m["rms_norm_eps"]), float(m["rope_theta"])
    H, KV, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    sw = int(m.get("sliding_window") or 0)
    table = params["embed"]["table"]
    xs = [table[t].float() for t, _ in seqs]
    for i in range(m["num_hidden_layers"]):
        lw = _layer(params, i, m)
        for j, (t, P) in enumerate(seqs):
            x = xs[j]
            S = x.shape[0]
            h = _rmsnorm(x, lw["ln1"], eps)
            q = _rope((h @ lw["wq"]).view(S, H, hd), theta)
            k = _rope((h @ lw["wk"]).view(S, KV, hd), theta)
            v = (h @ lw["wv"]).view(S, KV, hd)
            window = min(P, sw) if sw else P
            x = x + _attention(q, k, v, window).reshape(S, H * hd) @ lw["wo"]
            h = _rmsnorm(x, lw["ln2"], eps)
            if "router" in lw:
                x = x + _moe(h, P, lw, m)
            else:
                x = x + _swiglu(h, lw["gate"], lw["up"], lw["down"])
            xs[j] = x
        del lw
    head = params["head"]["table"].float()
    norm = params["norm_f"]["scale"].float()
    return [_rmsnorm(x[P - 1:], norm, eps) @ head.t()
            for x, (_, P) in zip(xs, seqs)]
