"""Shared layer primitives: RMSNorm, rotary embeddings, linear (dense,
masked, or packed BCS-sparse), embedding tables, the token cross-entropy,
SwiGLU FFN, and the depthwise causal conv1d of the SSM mixers."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packed import DegradedLayer
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import module as M


# -- RMSNorm ----------------------------------------------------------------

def rmsnorm_init(dim, dtype=torch.bfloat16, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    """fp32 math, one rounding back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params["scale"].float()).to(dt)


# -- Rotary -----------------------------------------------------------------

def rotary_freqs(head_dim, theta=10000.0, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def replicated_like(t, x):
    """``t`` as a replicated ``DTensor`` on ``x``'s mesh when ``x`` is
    placed (a plain operand the backward pass reads must be placed too:
    autograd replays the op outside the forward's implicit replication);
    ``t`` itself otherwise."""
    if not SH.is_placed(x) or SH.is_placed(t):
        return t
    return SH.place(t, x.device_mesh, ())


def apply_rotary(x, positions, theta=10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    (not interleaved) rotation in fp32."""
    hd = x.shape[-1]
    freqs = rotary_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., seq, hd/2)
    cos = replicated_like(torch.cos(angles)[..., :, None, :], x)
    sin = replicated_like(torch.sin(angles)[..., :, None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- Linear (dense, masked-sparse, or packed BCS-sparse) ---------------------

def linear_init(in_dim, out_dim, generator, n=None, dtype=torch.bfloat16,
                device="cpu"):
    shape = (in_dim, out_dim) if n is None else (n, in_dim, out_dim)
    return {"w": M.dense_init(shape, generator, dtype, device)}


def _apply_act(y, act):
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return torch.clamp_min(y, 0)
    return y


def unseq(x):
    """A placed (B, S, D) x with its sequence dim gathered (the all-gather
    of Megatron's sequence parallelism before a projection): DTensor's
    matmul folds (B, S) into one dim, which a sequence split cannot
    survive.  Anything else as it is."""
    return SH.unsplit(x, 1) if x.dim() == 3 else x


class _GradAsValue(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    value's own placements (a partial sum's taken as replicated)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        ctx.mesh = y.device_mesh
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl
                               for pl in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if SH.is_placed(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_as_value(y):
    """``y``, with its gradient brought to ``y``'s placements before the
    op that made ``y`` sees it: a matmul's backward flattens (B, S) of
    its gradient, which a sequence split there (the next layer's
    ``shard_residual``) cannot survive.  A plain ``y`` as it is."""
    if not SH.is_placed(y) or not torch.is_grad_enabled() or \
            not y.requires_grad:
        return y
    return _GradAsValue.apply(y)


def linear(params, x, mask=None, act="none"):
    """y = act(x @ W + b) through whichever executor applies.

    A layer carrying a packed layout (``params["packed"]``, installed by
    ``serve.compile.compile_model``) runs the BCS kernel — one launch per
    projection over all its degree bins (int8 values dequantized in the
    same launch), bias + activation fused into its epilogue; any ``mask``
    is ignored there (it was baked in at pack time).  Otherwise a dense
    matmul runs, with an optional pruning ``mask``.  A ``DegradedLayer``
    marker (a layout that failed validation) runs the dense matmul on the
    retained ``w``, whose pruning zeros are baked in."""
    packed = params.get("packed")
    if isinstance(packed, DegradedLayer):
        packed = None                # retired: masked-dense on w
    if packed is not None:
        return ops.sparse_linear(x, packed=packed, bias=params.get("b"),
                                 act=act)
    w = params["w"]
    if mask is not None:
        w = w * mask.to(w.dtype)
    y = grad_as_value(torch.matmul(unseq(x), w))
    if "b" in params:
        y = y + params["b"]
    return _apply_act(y, act)


# -- Embedding ---------------------------------------------------------------

def embedding_init(vocab, dim, generator, dtype=torch.bfloat16,
                   device="cpu"):
    return {"table": M.embed_init((vocab, dim), generator, dtype, device)}


def embed(params, tokens):
    """The table's rows (``F.embedding``: a placed table keeps DTensor's
    vocab-parallel rule)."""
    return F.embedding(tokens, params["table"])


def unembed(params, x):
    """Logits against the (separate) output head table: (..., d) ->
    (..., vocab)."""
    return grad_as_value(torch.matmul(unseq(x), params["table"].t()))


# -- Loss ---------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32: logsumexp minus the gold logit,
    averaged over every token, or over the tokens where ``mask`` is
    nonzero (at least one)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# -- SwiGLU FFN ---------------------------------------------------------------

def ffn_init(d_model, d_ff, generator, n=None, dtype=torch.bfloat16,
             device="cpu"):
    return {
        "gate": linear_init(d_model, d_ff, generator, n, dtype, device),
        "up": linear_init(d_model, d_ff, generator, n, dtype, device),
        "down": linear_init(d_ff, d_model, generator, n, dtype, device),
    }


def ffn(params, x, masks=None):
    """SwiGLU with silu requested as the gate projection's epilogue, so the
    packed path fuses it into the kernel's final store.  Under bf16 the
    fused path applies silu to the fp32 accumulator before the one
    rounding, so packed and dense outputs may differ by ~1 bf16 ulp; in
    fp32 they agree tightly."""
    m = masks or {}
    g = linear(params["gate"], x, m.get("gate"), act="silu")
    u = linear(params["up"], x, m.get("up"))
    return linear(params["down"], g * u, m.get("down"))


# -- Depthwise causal conv1d (mamba/hymba mixers; never pruned, §5.2.4) -------

def conv1d_init(channels, width, generator, n=None, dtype=torch.bfloat16,
                device="cpu"):
    """Weight (width, C) (``n`` stacked layers: (n, width, C)), the
    truncated normal at scale ``width ** -0.5``, as the reference's."""
    shape = (width, channels) if n is None else (n, width, channels)
    return {"w": M.dense_init(shape, generator, dtype, device,
                              scale=width ** -0.5)}


def causal_conv1d(params, x):
    """x (batch, seq, C) -> (batch, seq, C), depthwise and causal: tap i
    reads position t - (width - 1) + i.  Taps are summed in the
    reference's order (tap 0 first), each product and sum in x's dtype."""
    w = params["w"]                              # (width, C)
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def conv1d_step(params, state, x_t):
    """One decode step.  state (batch, width - 1, C) holds the last inputs,
    x_t (batch, C) the new one.  Returns (new state, output (batch, C)):
    the window's taps summed in fp32 and rounded once to x's dtype, as
    the reference's einsum contracts them."""
    w = params["w"]
    window = torch.cat([state, x_t[:, None, :]], dim=1)   # (b, width, C)
    out = (window.float() * w.float()).sum(dim=1).to(x_t.dtype)
    return window[:, 1:, :], out
