"""Mixture-of-Experts FFN with capacity-based one-hot dispatch (GShard-style),
as in the reference (``repro.models.moe``).

Tokens are regrouped into G groups of Sg; each group routes its tokens in
fp32 (softmax, top-k, renormalised gates), gives each chosen (token,
expert) pair a slot by a cumulative sum, and drops the pairs past the
expert's capacity C.  The one-hot dispatch and combine einsums are plain
torch (XLA's work in the reference, and small: G x Sg x E x C).

Sparse serving: when ``serve.compile.compile_model`` installs a
``core.packed.PackedLayout`` next to an expert weight
(``params[name]["packed"]``, leading expert axis on every leaf), the three
expert GEMMs (gate/up/down) run through ``kernels.ops.
sparse_expert_linear``: one launch of the BCS kernel over every expert and
every degree bin.  silu fuses into the gate projection's epilogue as in
``layers.ffn``.

The router stays dense and fp32 (never packed: the paper's "don't prune
tiny, sensitive layers" rule, §5.2.4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packed import DegradedLayer
from repro_torch.kernels import ops
from repro_torch.models import module as M


def moe_init(d_model, d_ff, n_experts, generator, n=None,
             dtype=torch.bfloat16, device="cpu"):
    """Router (d_model, E) in fp32 whatever ``dtype``; expert weights
    (E, d_model, d_ff) / (E, d_ff, d_model); each leaf gets a leading
    ``n`` (layer) dim when ``n`` is given."""
    lead = () if n is None else (n,)

    def w(*shape, dt=dtype):
        return {"w": M.dense_init(lead + shape, generator, dt, device)}
    return {"router": w(d_model, n_experts, dt=torch.float32),
            "gate": w(n_experts, d_model, d_ff),
            "up": w(n_experts, d_model, d_ff),
            "down": w(n_experts, d_ff, d_model)}


def _dispatch_tensors(logits, top_k, capacity):
    """logits (G, S, E) -> (dispatch (G, S, E, C), combine (G, S, E, C),
    aux), all fp32.  Logits are routed in fp32 whatever their dtype; a
    (token, expert) pair past the expert's ``capacity`` is dropped; aux is
    the Switch load-balance loss E * sum(frac_tokens * frac_probs)."""
    logits = logits.float()
    G, S, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, top_k, dim=-1)          # (G, S, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    oh = F.one_hot(idx, E).float()                              # (G,S,K,E)
    se_oh = oh.sum(2)                                           # (G, S, E)
    pos = torch.cumsum(se_oh, dim=1) * se_oh - 1.0              # slot index
    keep = (pos >= 0) & (pos < capacity)
    # one_hot of an out-of-range slot is all zeros, as jax.nn.one_hot's
    disp = F.one_hot(pos.long().clamp(0, capacity - 1), capacity).float()
    disp = disp * keep[..., None]
    weight_se = torch.einsum("gske,gsk->gse", oh, gate_vals)
    combine = disp * weight_se[..., None]
    frac_tokens = se_oh.mean(dim=(0, 1)) / top_k
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return disp, combine, aux


def _expert_linear(p, x, mask=None, act="none"):
    """Per-expert projection: x (G, E, C, din) @ w (E, din, dout) ->
    (G, E, C, dout).  A packed expert stack (``p["packed"]``) runs the BCS
    kernel once over all experts, ``act`` fused into its epilogue;
    otherwise the dense masked einsum, ``act`` after it (under bf16 the
    fused path rounds once instead of twice, as in ``layers.ffn``).  A
    ``DegradedLayer`` marker runs the dense einsum."""
    packed = p.get("packed")
    if isinstance(packed, DegradedLayer):
        packed = None                # retired: masked-dense on w
    if packed is not None:
        G, E, C, din = x.shape
        # (E, G*C, din), contiguous: the kernel needs 16-byte row pitches
        xe = x.permute(1, 0, 2, 3).reshape(E, G * C, din).contiguous()
        ye = ops.sparse_expert_linear(xe, packed, act=act)
        return ye.reshape(E, G, C, -1).permute(1, 0, 2, 3)
    w = p["w"]
    if mask is not None:
        w = w * mask.to(w.dtype)
    y = torch.einsum("gecd,edf->gecf", x, w)
    if act == "silu":
        y = F.silu(y)
    return y


def moe(params, x, *, top_k, capacity_factor=1.25, group=1024, masks=None):
    """x (B, S, D) -> ((B, S, D), aux loss).  Tokens are regrouped into
    groups of ``group`` to bound the dispatch tensor to (G, group, E, C)."""
    m = masks or {}
    B, S, D = x.shape
    E = params["router"]["w"].shape[-1]
    T = B * S
    Sg = min(group, T)
    G = T // Sg
    xt = x.reshape(G, Sg, D)
    # routed in fp32, the router promoted as the reference's einsum of an
    # fp32 x with a (possibly bf16) router promotes it
    logits = torch.einsum("gsd,de->gse", xt.float(),
                          params["router"]["w"].float())
    # the group-size clamp stays OUTSIDE the floor of 4: a group of fewer
    # than 4 tokens gets no more slots than tokens
    C = min(Sg, max(4, int(Sg * top_k / E * capacity_factor)))
    disp, combine, aux = _dispatch_tensors(logits, top_k, C)

    dt = x.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", disp.to(dt), xt)
    g = _expert_linear(params["gate"], expert_in, m.get("gate"), act="silu")
    u = _expert_linear(params["up"], expert_in, m.get("up"))
    expert_out = _expert_linear(params["down"], g * u, m.get("down"))
    out = torch.einsum("gecd,gsec->gsd", expert_out, combine.to(dt))
    return out.reshape(B, S, D), aux
