"""Model assembly for the dense, MoE, SSM and hybrid decoder families.

Per-layer params are stacked on a leading layer dim, as in the reference;
where the reference scans over that dim, the port loops over the layer
index in Python and hands each layer its slice (``module.take_layer``).
Packed layouts are sliced too, never re-packed, so every layer executes
the stack's padded slots.  An ``ssm`` layer is a mamba2 mixer on the
normed residual; a ``hybrid`` (hymba) layer runs attention and the mixer
in parallel on the same normed input, averages them, then the FFN.

``forward_aux`` is the training forward: the logits and the MoE aux loss
summed over the layers, each layer checkpointed (recomputed in the
backward pass) when ``cfg.remat == "full"``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import ssm as S
from repro_torch.models.moe import moe, moe_init

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def init_lm(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
            device="cuda"):
    """Random LM params from ``seed`` (a ``torch.Generator`` on the
    device), layer leaves stacked on a leading ``n_layers`` dim, as the
    reference's ``_layer_init`` lays them out by family: dense
    {ln1, attn, ln2, ffn}; moe {ln1, attn, ln2, moe} (router in fp32);
    ssm {ln1, ssm}; hybrid {ln1, attn, ssm, ln2, ffn}.  The mixer's
    A_log, D and dt_bias stay fp32."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = M.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, d = cfg.n_layers, cfg.d_model
    kw = dict(dtype=dtype, device=dev)
    fam = cfg.family
    attn = fam != "ssm"
    # drawn in the reference's order: attention, mixer, FFN
    layers = {"ln1": {"scale": torch.ones((n, d), **kw)}}
    if attn:
        layers["attn"] = A.attn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                     gen, n=n, **kw)
    if fam in ("ssm", "hybrid"):
        layers["ssm"] = S.ssm_init(d, cfg.ssm_state, gen,
                                   headdim=cfg.ssm_headdim,
                                   expand=cfg.ssm_expand, n=n, **kw)
    if attn:
        layers["ln2"] = {"scale": torch.ones((n, d), **kw)}
        if fam == "moe":
            layers["moe"] = moe_init(d, cfg.d_ff, cfg.n_experts, gen, n=n,
                                     **kw)
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


def _ffn(p, h, cfg: ArchConfig, group=None):
    """The layer's FFN on its normed input: SwiGLU, or the MoE experts in
    dispatch groups of ``group`` tokens (default ``cfg.moe_group``).
    Returns (out, aux): the MoE load-balance loss, None for SwiGLU."""
    if cfg.family == "moe":
        return moe(p["moe"], h, top_k=cfg.top_k,
                   group=cfg.moe_group if group is None else group)
    return L.ffn(p["ffn"], h), None


def _layer_fwd(p, x, positions, cfg: ArchConfig):
    """One layer.  Returns (x, (k, v), ssm state, aux): the layer's roped
    KV (None for ``ssm``), its mixer's decode state (None for dense and
    moe), both from this one run, and its MoE aux loss (None outside the
    moe family).  The hybrid state is the mixer's on the layer's normed
    INPUT, the same input its output came from."""
    h = L.rmsnorm(p["ln1"], x)
    kv = st = None
    if cfg.family == "ssm":
        sm, st = S.ssm(p["ssm"], h)
        return x + sm, kv, st, None
    att, kv = A.mha(p["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads,
                    cfg.hd, window=cfg.sliding_window,
                    rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk)
    if cfg.family == "hybrid":
        sm, st = S.ssm(p["ssm"], h)
        att = (att + sm) * 0.5
    x = x + att
    f, aux = _ffn(p, L.rmsnorm(p["ln2"], x), cfg)
    return x + f, kv, st, aux


def forward_aux(params, cfg: ArchConfig, tokens, positions=None):
    """tokens (B, S) -> (logits (B, S, vocab), aux): the reference's
    ``forward``, with the MoE load-balance loss summed over the layers
    (fp32; 0 outside the moe family).  With ``cfg.remat == "full"`` and
    autograd recording, each layer runs under ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint``): only its input is kept, and the
    backward pass runs it again."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (encdec and vlm "
            f"come with ROADMAP queue 1 item 6)")
    _, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in layer_params(params):
        if remat:
            x, _, _, a = checkpoint(_layer_fwd, lp, x, positions, cfg,
                                    use_reentrant=False)
        else:
            x, _, _, a = _layer_fwd(lp, x, positions, cfg)
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["norm_f"], x)
    return L.unembed(params["head"], x), aux


def forward(params, cfg: ArchConfig, tokens, positions=None):
    """tokens (B, S) -> logits (B, S, vocab)."""
    return forward_aux(params, cfg, tokens, positions)[0]


def init_cache(params, cfg: ArchConfig, batch, seq, dtype=torch.bfloat16):
    """Fixed-shape caches, stacked on the layer dim as in the reference:
    "kv" (dense, moe, hybrid) k/v (n_layers, B, S, KV, hd), pos
    (n_layers, S), S cut to the attention window; "ssm" (ssm, hybrid)
    the zero mixer state, h (n_layers, B, H, P, N) fp32 and conv
    (n_layers, B, width - 1, conv_dim)."""
    dev = params["embed"]["table"].device
    n = n_layers(params)
    cache = {}
    if cfg.family != "ssm":
        eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        shape = (n, batch, eff, cfg.n_kv_heads, cfg.hd)
        pos = torch.arange(eff, dtype=torch.int32, device=dev)
        cache["kv"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev),
                       "pos": pos.expand(n, eff).contiguous()}
    if cfg.family in ("ssm", "hybrid"):
        one = S.ssm_state_init(M.take_layer(params["layers"]["ssm"], 0),
                               batch, dtype)
        cache["ssm"] = {k: v.expand((n,) + v.shape).contiguous()
                        for k, v in one.items()}
    return cache


def _decode(params, cfg: ArchConfig, token, cache, layers, attn,
            moe_group=None):
    """The decode step's layer loop.  ``attn(lp, hn, kv_cache)`` is the
    attention of one layer on its normed input and that layer's KV views;
    every cache write is in place."""
    x = L.embed(params["embed"], token)
    if layers is None:
        layers = layer_params(params)
    fam = cfg.family
    for i, lp in enumerate(layers):
        hn = L.rmsnorm(lp["ln1"], x)
        if fam in ("ssm", "hybrid"):
            sm, st = S.ssm_decode(lp["ssm"], hn,
                                  M.take_layer(cache["ssm"], i))
            for k, v in st.items():
                cache["ssm"][k][i] = v
        if fam == "ssm":
            x = x + sm
            continue
        # the layer's KV views into the stack
        att = attn(lp, hn, M.take_layer(cache["kv"], i))
        if fam == "hybrid":
            att = (att + sm) * 0.5
        x = x + att
        x = x + _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg, moe_group)[0]
    x = L.rmsnorm(params["norm_f"], x)
    return L.unembed(params["head"], x), cache


def decode_step(params, cfg: ArchConfig, token, cache, pos, layers=None):
    """token (B, 1) int; pos (B, 1) int current position; returns
    (logits (B, 1, V), cache) — the cache is updated in place.  ``layers``
    is ``layer_params(params)`` when the caller already has it."""
    def attn(lp, hn, c):
        return A.mha_decode(lp["attn"], hn, c, pos, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd,
                            window=cfg.sliding_window,
                            rope_theta=cfg.rope_theta)[0]
    return _decode(params, cfg, token, cache, layers, attn)


def decode_step_ragged(params, cfg: ArchConfig, token, cache, pos, cap,
                       layers=None):
    """Continuous-batching decode step: ONE forward over every slot of the
    ``serve.kvcache`` slot cache.

    token (B, 1) int per-slot current tokens; pos (B, 1) int per-slot
    positions; cap (B,) int per-slot ring capacities (a free slot runs as
    pos = 0 / cap = 1 padding whose outputs the engine discards).
    Returns (logits (B, 1, V), cache), the cache updated in place.

    Per slot it computes what ``decode_step`` at B = 1 computes: the
    ragged attention masks by per-entry positions, every other op is
    row-wise, and MoE dispatches with ``group=1`` so batch occupancy can
    never change a token's expert-capacity outcome (at B = 1 the group
    clamp makes ``group`` irrelevant).  No host sync and no host-to-card
    copy, so the engine captures it in a CUDA graph; admission and
    eviction rewrite cache rows, never shapes."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not served by the continuous-"
            f"batching engine ({'/'.join(FAMILIES)} only)")

    def attn(lp, hn, c):
        return A.mha_decode_ragged(lp["attn"], hn, c, pos, cap, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd,
                                   window=cfg.sliding_window,
                                   rope_theta=cfg.rope_theta)[0]
    return _decode(params, cfg, token, cache, layers, attn, moe_group=1)


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
