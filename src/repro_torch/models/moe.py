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
from repro_torch.kernels.bsr_matmul import local_layout, placed_layout
from repro_torch.models import layers as L
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


def _expert_linear(p, x, mask=None, act="none", dist=None):
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
        if dist is not None:
            # a stack placed on the experts runs each rank's own; any
            # other runs whole (every expert) on every rank
            by_expert = placed_layout(packed) and \
                local_layout(packed)[2] is not None
            dims = (1,) if by_expert else ("b",)
            return dist.local_map(
                lambda xl: (_expert_linear(p, xl, mask, act),), dims,
                dims)(x)[0]
        G, E, C, din = x.shape
        # (E, G*C, din), contiguous: the kernel needs 16-byte row pitches
        xe = x.permute(1, 0, 2, 3).reshape(E, G * C, din).contiguous()
        ye = ops.sparse_expert_linear(xe, packed, act=act)
        return ye.reshape(E, G, C, -1).permute(1, 0, 2, 3)
    w = p["w"]
    if mask is not None:
        w = w * mask.to(w.dtype)
    if hasattr(x, "placements"):
        return _expert_local(x, w, act)
    y = torch.einsum("gecd,edf->gecf", x, w)
    if act == "silu":
        y = F.silu(y)
    return y


def _expert_local(x, w, act):
    """The dense expert einsum of a placed x (G, E, C, din) on each rank's
    own experts: x keeps its group (dim 0) and expert (dim 1) splits and
    is gathered over the rest, w is gathered whole and cut to the same
    experts (a w placed on those experts already is: no gather); the
    result is placed like x.  DTensor's einsum folds the sharded expert
    dim into a batch dim it cannot reshape back."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    want = tuple(pl if pl.is_shard(0) or pl.is_shard(1) else Replicate()
                 for pl in x.placements)
    xl = x.redistribute(mesh, want).to_local()
    split = tuple(Shard(0) if pl.is_shard(1) else Replicate() for pl in want)
    if hasattr(w, "placements"):
        wl = w.redistribute(mesh, split).to_local()
    else:
        coord, wl = mesh.get_coordinate(), w
        for i, pl in enumerate(split):
            if pl.is_shard():
                wl = torch.chunk(wl, mesh.size(i), dim=0)[coord[i]]
    y = torch.einsum("gecd,edf->gecf", xl, wl)
    if act == "silu":
        y = F.silu(y)
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    return DTensor.from_local(y, mesh, want, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def moe(params, x, *, top_k, capacity_factor=1.25, group=1024, masks=None,
        dist=None):
    """x (B, S, D) -> ((B, S, D), aux loss).  Tokens are regrouped into
    groups of ``group`` to bound the dispatch tensor to (G, group, E, C).
    Under a mesh the dispatch (top-k, cumsum, one-hot, capacity drop) runs
    on the whole logits on every rank (``sharding.replicated``: DTensor
    has no rule for it), and the dispatched (G, E, C, D) takes
    ``shard_experts``."""
    m = masks or {}
    B, S, D = x.shape
    if dist is not None:
        x = L.unseq(x)              # token groups cut across the sequence
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
    if dist is None:
        disp, combine, aux = _dispatch_tensors(logits, top_k, C)
    else:
        disp, combine, aux = dist.replicated(_dispatch_tensors)(
            logits, top_k, C)

    dt = x.dtype
    if dist is None:
        expert_in = _dispatch_in(disp.to(dt), xt)[0]
    else:
        expert_in = dist.local_map(_dispatch_in, ("b", "b"), ("b",))(
            disp.to(dt), xt)[0]
        expert_in = dist.shard_experts(expert_in)
    g = _expert_linear(params["gate"], expert_in, m.get("gate"), act="silu",
                       dist=dist)
    u = _expert_linear(params["up"], expert_in, m.get("up"), dist=dist)
    expert_out = _expert_linear(params["down"], g * u, m.get("down"),
                                dist=dist)
    if dist is None:
        out = _combine(expert_out, combine.to(dt))[0]
    elif dist.expert_sharded:
        # each rank combines its own experts; the sum over experts is
        # reduced over the model axis
        out = dist.local_map(_combine, (1, 2), ("partial",))(
            expert_out, combine.to(dt))[0]
        out = dist._c(out, None, None, None)
    else:
        out = dist.local_map(_combine, ("b", "b"), ("b",))(
            expert_out, combine.to(dt))[0]
    return out.reshape(B, S, D), aux


def _dispatch_in(disp, xt):
    """The tokens of each (expert, capacity slot): (G, E, C, D)."""
    return torch.einsum("gsec,gsd->gecd", disp, xt),


def _combine(expert_out, combine):
    """Each token's gate-weighted sum of its experts' outputs."""
    return torch.einsum("gecd,gsec->gsd", expert_out, combine),
