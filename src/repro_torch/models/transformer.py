"""Model assembly for the dense and MoE decoder families.

Per-layer params are stacked on a leading layer dim, as in the reference;
where the reference scans over that dim, the port loops over the layer
index in Python and hands each layer its slice (``module.take_layer``).
Packed layouts are sliced too, never re-packed, so every layer executes
the stack's padded slots.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models.moe import moe, moe_init

FAMILIES = ("dense", "moe")


def init_lm(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
            device="cuda"):
    """Random LM params from ``seed`` (a ``torch.Generator`` on the
    device), layer leaves stacked on a leading ``n_layers`` dim; an MoE
    layer's FFN is ``{"moe": ...}`` (router in fp32) in place of
    ``{"ffn": ...}``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = M.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, d = cfg.n_layers, cfg.d_model
    kw = dict(dtype=dtype, device=dev)
    layers = {
        "ln1": {"scale": torch.ones((n, d), **kw)},
        "attn": A.attn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, gen,
                            n=n, **kw),
        "ln2": {"scale": torch.ones((n, d), **kw)},
    }
    if cfg.family == "moe":
        layers["moe"] = moe_init(d, cfg.d_ff, cfg.n_experts, gen, n=n, **kw)
    else:
        layers["ffn"] = L.ffn_init(d, cfg.d_ff, gen, n=n, **kw)
    return {
        "embed": L.embedding_init(cfg.vocab, d, gen, **kw),
        "head": L.embedding_init(cfg.vocab, d, gen, **kw),
        "norm_f": L.rmsnorm_init(d, **kw),
        "layers": layers,
    }


def n_layers(params) -> int:
    return params["layers"]["ln1"]["scale"].shape[0]


def layer_params(params) -> list:
    """Per-layer slices of the stacked layer tree.  A decode loop slices
    once and reuses the list for every step (slicing is host work that
    would otherwise repeat per token)."""
    return [M.take_layer(params["layers"], i) for i in range(n_layers(params))]


def _ffn(p, h, cfg: ArchConfig):
    """The layer's FFN on its normed input: SwiGLU, or the MoE experts
    (their aux loss is a training quantity, dropped when serving)."""
    if cfg.family == "moe":
        return moe(p["moe"], h, top_k=cfg.top_k, group=cfg.moe_group)[0]
    return L.ffn(p["ffn"], h)


def _layer_fwd(p, x, positions, cfg: ArchConfig):
    """One layer.  Returns (x, (k, v)) with the layer's roped KV."""
    h = L.rmsnorm(p["ln1"], x)
    att, kv = A.mha(p["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads,
                    cfg.hd, window=cfg.sliding_window,
                    rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk)
    x = x + att
    x = x + _ffn(p, L.rmsnorm(p["ln2"], x), cfg)
    return x, kv


def forward(params, cfg: ArchConfig, tokens, positions=None):
    """tokens (B, S) -> logits (B, S, vocab)."""
    _, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    for lp in layer_params(params):
        x, _ = _layer_fwd(lp, x, positions, cfg)
    x = L.rmsnorm(params["norm_f"], x)
    return L.unembed(params["head"], x)


def init_cache(params, cfg: ArchConfig, batch, seq, dtype=torch.bfloat16):
    """Fixed-shape KV caches, stacked on the layer dim as in the
    reference: k/v (n_layers, B, S, KV, hd), pos (n_layers, S); the same
    for both families."""
    eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    dev = params["embed"]["table"].device
    n = n_layers(params)
    shape = (n, batch, eff, cfg.n_kv_heads, cfg.hd)
    pos = torch.arange(eff, dtype=torch.int32, device=dev)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev),
                   "pos": pos.expand(n, eff).contiguous()}}


def decode_step(params, cfg: ArchConfig, token, cache, pos, layers=None):
    """token (B, 1) int; pos (B, 1) int current position; returns
    (logits (B, 1, V), cache) — the cache is updated in place.  ``layers``
    is ``layer_params(params)`` when the caller already has it."""
    x = L.embed(params["embed"], token)
    if layers is None:
        layers = layer_params(params)
    for i, lp in enumerate(layers):
        c = M.take_layer(cache["kv"], i)          # views into the stack
        att, _ = A.mha_decode(lp["attn"], L.rmsnorm(lp["ln1"], x), c, pos,
                              cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              window=cfg.sliding_window,
                              rope_theta=cfg.rope_theta)
        x = x + att
        x = x + _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg)
    x = L.rmsnorm(params["norm_f"], x)
    return L.unembed(params["head"], x), cache


def decode_loop(params, cfg: ArchConfig, tok, cache, start_pos, n_new):
    """Greedy-generate ``n_new`` tokens: ``n_new`` decode steps, each
    feeding back its argmax.  tok (B, 1) is the first token to emit and
    start_pos (B, 1) its position.  Returns (tokens (B, n_new), cache);
    tok itself is the first output token, as in the reference."""
    toks = []
    layers = layer_params(params)
    for i in range(n_new):
        toks.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache, start_pos + i,
                                    layers)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(tok.dtype)
    return torch.cat(toks, dim=1), cache
