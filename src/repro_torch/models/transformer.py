"""Model assembly for every architecture family: the decoder-only dense,
MoE, SSM and hybrid stacks, the encoder-decoder (encdec) and the vision LM
with gated cross-attention layers (vlm).

Per-layer params are stacked on a leading layer dim, as in the reference;
where the reference scans over that dim, the port loops over the layer
index in Python and hands each layer its slice (``module.take_layer``).
Packed layouts are sliced too, never re-packed, so every layer executes
the stack's padded slots.  An ``ssm`` layer is a mamba2 mixer on the
normed residual; a ``hybrid`` (hymba) layer runs attention and the mixer
in parallel on the same normed input, averages them, then the FFN.

encdec (seamless) runs a bidirectional encoder ``enc`` over the frontend
embeddings, normed by ``norm_e`` into the memory, then the decoder ``dec``
of ``xdec`` layers (self-attention, cross-attention over the memory,
FFN).  vlm (llama-vision) stacks ``groups``: each group is
``cross_attn_interval - 1`` dense layers (``selfs``, leaves (G, k - 1,
...)) and one ``cross`` layer (cross-attention over the image patches
scaled by tanh of its fp32 ``gate``, then its own FFN; leaves (G, ...)).

``forward_aux`` is the training forward: the logits and the MoE aux loss
summed over the layers, each layer checkpointed (recomputed in the
backward pass) when ``cfg.remat == "full"``.

Every forward and decode step takes ``dist`` (``distributed.sharding.
Dist``): the activations, residual stream and logits take the
reference's placements on its mesh (``shard_activations``,
``shard_residual``, ``shard_logits``), and the model runs under
``dist.region()``, where the plain tensors it makes meet placed ones as
replicated.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import ssm as S
from repro_torch.models.moe import moe, moe_init

# one stack of decoder layers under params["layers"]; the continuous-
# batching engine serves these
DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid")
FAMILIES = DECODER_FAMILIES + ("encdec", "vlm")


def _stack_init(cfg: ArchConfig, kind, n, gen, kw):
    """Stacked (n, ...) leaves of ``n`` layers of ``kind``, drawn in the
    reference's order: attention, cross-attention / mixer, FFN."""
    d = cfg.d_model
    ones = {"scale": torch.ones((n, d), **kw)}

    def attn():
        return A.attn_init(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, gen, n=n,
                           **kw)
    if kind == "cross":
        return {"ln1": ones, "xattn": attn(),
                "gate": torch.zeros((n, 1), dtype=torch.float32,
                                    device=kw["device"]),
                "ln2": {"scale": ones["scale"].clone()},
                "ffn": L.ffn_init(d, cfg.d_ff, gen, n=n, **kw)}
    layers = {"ln1": ones}
    if kind != "ssm":
        layers["attn"] = attn()
    if kind == "xdec":
        layers["lnx"] = {"scale": ones["scale"].clone()}
        layers["xattn"] = attn()
    if kind in ("ssm", "hybrid"):
        layers["ssm"] = S.ssm_init(d, cfg.ssm_state, gen,
                                   headdim=cfg.ssm_headdim,
                                   expand=cfg.ssm_expand, n=n, **kw)
    if kind != "ssm":
        layers["ln2"] = {"scale": ones["scale"].clone()}
        if kind == "moe":
            layers["moe"] = moe_init(d, cfg.d_ff, cfg.n_experts, gen, n=n,
                                     **kw)
        else:
            layers["ffn"] = L.ffn_init(d, cfg.d_ff, gen, n=n, **kw)
    return layers


def init_lm(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
            device="cuda"):
    """Random LM params from ``seed`` (a ``torch.Generator`` on the
    device), laid out as the reference's ``init_lm``: layer leaves stacked
    on a leading dim, by family dense {ln1, attn, ln2, ffn}; moe {ln1,
    attn, ln2, moe} (router in fp32); ssm {ln1, ssm}; hybrid {ln1, attn,
    ssm, ln2, ffn} under "layers"; encdec "enc" (dense layers), "dec"
    {ln1, attn, lnx, xattn, ln2, ffn} and "norm_e"; vlm "groups" {selfs
    (G, k - 1, ...), cross {ln1, xattn, gate, ln2, ffn} (G, ...)}.  The
    mixer's A_log, D and dt_bias and the cross gate (zero, as the
    reference's) stay fp32.  ``device="meta"`` builds the shapes alone
    (what the spec functions read), drawing nothing."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(fam)
    dev = M.resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=dev)
    # the layer stacks are drawn first, then the embedding and head
    if fam in DECODER_FAMILIES:
        stacks = {"layers": _stack_init(cfg, fam, cfg.n_layers, gen, kw)}
    elif fam == "encdec":
        stacks = {"enc": _stack_init(cfg, "dense", cfg.n_enc_layers, gen,
                                     kw),
                  "dec": _stack_init(cfg, "xdec", cfg.n_layers, gen, kw),
                  "norm_e": L.rmsnorm_init(cfg.d_model, **kw)}
    else:
        k = cfg.cross_attn_interval
        G = cfg.n_layers // k
        selfs = _stack_init(cfg, "dense", G * (k - 1), gen, kw)
        stacks = {"groups": {
            "selfs": M.tree_map(
                lambda t: t.reshape((G, k - 1) + tuple(t.shape[1:])), selfs),
            "cross": _stack_init(cfg, "cross", G, gen, kw)}}
    return {"embed": L.embedding_init(cfg.vocab, cfg.d_model, gen, **kw),
            "head": L.embedding_init(cfg.vocab, cfg.d_model, gen, **kw),
            "norm_f": L.rmsnorm_init(cfg.d_model, **kw), **stacks}


def _stack_len(tree) -> int:
    """Length of a stacked tree's leading dim (its first leaf's)."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return (tree.nnz if hasattr(tree, "nnz") else tree).shape[0]


def n_layers(params, stack="layers") -> int:
    return _stack_len(params[stack])


def layer_params(params, stack="layers") -> list:
    """Per-layer slices of the stacked tree ``params[stack]``: the decoder
    "layers", encdec's "enc" and "dec", vlm's "groups" (each group's
    "selfs" slice again: a group's tree keeps the (k - 1, ...) self
    stack), tensors and packed layouts alike.  A decode loop slices once
    and reuses the list for every step (slicing is host work that would
    otherwise repeat per token)."""
    return [M.take_layer(params[stack], i)
            for i in range(n_layers(params, stack))]


def decode_layers(params, cfg: ArchConfig) -> list:
    """What ``decode_step``'s ``layers`` takes: ``layer_params`` of the
    decoder stack, and for vlm one (self layers, cross layer) pair a
    group."""
    if cfg.family == "encdec":
        return layer_params(params, "dec")
    if cfg.family == "vlm":
        return [(layer_params(g, "selfs"), g["cross"])
                for g in layer_params(params, "groups")]
    return layer_params(params)


def _region(dist):
    """``dist.region()``, or nothing without a mesh."""
    return contextlib.nullcontext() if dist is None else dist.region()


def _residual(x, dist):
    return x if dist is None else dist.shard_residual(x)


def _ffn(p, h, cfg: ArchConfig, group=None, dist=None):
    """The layer's FFN on its normed input: SwiGLU, or the MoE experts in
    dispatch groups of ``group`` tokens (default ``cfg.moe_group``).
    Returns (out, aux): the MoE load-balance loss, None for SwiGLU."""
    if cfg.family == "moe":
        return moe(p["moe"], h, top_k=cfg.top_k,
                   group=cfg.moe_group if group is None else group,
                   dist=dist)
    return L.ffn(p["ffn"], h), None


def _layer_fwd(p, x, positions, cfg: ArchConfig, kind=None, memory=None,
               dist=None):
    """One layer of ``kind`` (default ``cfg.family``).  Returns (x, kv,
    ssm state, aux): the layer's attention cache from this one run (the
    roped self (k, v); xdec's (k, v, xk, xv) with the cross keys and
    values of the memory; a cross layer's (xk, xv); None for ``ssm``),
    its mixer's decode state (None but for ssm and hybrid) and its MoE
    aux loss (None outside the moe family).  The hybrid state is the
    mixer's on the layer's normed INPUT, the same input its output came
    from.  Under ``dist`` the output takes ``shard_residual``."""
    kind = kind or cfg.family
    h = L.rmsnorm(p["ln1"], x)
    kv = st = None
    sh = dict(dist=dist, shard=cfg.attn_shard)
    if kind == "ssm":
        sm, st = S.ssm(p["ssm"], h, dist=dist)
        return _residual(x + sm, dist), kv, st, None
    if kind == "cross":
        xa, kv = A.mha(p["xattn"], h, positions, cfg.n_heads,
                       cfg.n_kv_heads, cfg.hd, memory=memory, **sh)
        x = x + torch.tanh(p["gate"]).to(x.dtype) * xa
        x = x + L.ffn(p["ffn"], L.rmsnorm(p["ln2"], x))
        return _residual(x, dist), kv, None, None
    att, kv = A.mha(p["attn"], h, positions, cfg.n_heads, cfg.n_kv_heads,
                    cfg.hd, window=cfg.sliding_window,
                    rope_theta=cfg.rope_theta, kv_chunk=cfg.kv_chunk, **sh)
    if kind == "hybrid":
        sm, st = S.ssm(p["ssm"], h, dist=dist)
        att = (att + sm) * 0.5
    x = x + att
    if kind == "xdec":
        xa, xkv = A.mha(p["xattn"], L.rmsnorm(p["lnx"], x), positions,
                        cfg.n_heads, cfg.n_kv_heads, cfg.hd, memory=memory,
                        **sh)
        x = x + xa
        kv = kv + xkv
    f, aux = _ffn(p, L.rmsnorm(p["ln2"], x), cfg, dist=dist)
    return _residual(x + f, dist), kv, st, aux


def _enc_layer(p, h, positions, cfg: ArchConfig, dist=None):
    """One bidirectional encoder layer (no causal mask; the reference's
    default rope theta and KV chunk)."""
    att, _ = A.mha(p["attn"], L.rmsnorm(p["ln1"], h), positions,
                   cfg.n_heads, cfg.n_kv_heads, cfg.hd, causal=False,
                   dist=dist, shard=cfg.attn_shard)
    h = h + att
    return _residual(h + L.ffn(p["ffn"], L.rmsnorm(p["ln2"], h)), dist)


def _run(remat, fn, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, cfg: ArchConfig, frontend, dtype, remat=False,
           dist=None):
    """encdec's memory: the encoder over the frontend embeddings (B, T, D)
    cast to ``dtype``, then ``norm_e``."""
    h = frontend.to(dtype)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for lp in layer_params(params, "enc"):
        h = _run(remat, _enc_layer, lp, h, pos, cfg, dist)
    return L.rmsnorm(params["norm_e"], h)


def forward_aux(params, cfg: ArchConfig, tokens, positions=None,
                frontend=None, dist=None):
    """tokens (B, S) -> (logits (B, S, vocab), aux): the reference's
    ``forward``, with the MoE load-balance loss summed over the layers
    (fp32; 0 outside the moe family).  ``frontend`` (B, T, D) is encdec's
    audio-frame and vlm's image-patch embedding stand-in.  With
    ``cfg.remat == "full"`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): only
    its input is kept, and the backward pass runs it again.  Under
    ``dist`` the logits (and the aux loss) come back placed."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(fam)
    with _region(dist):
        return _forward_aux(params, cfg, tokens, positions, frontend, dist)


def _forward_aux(params, cfg, tokens, positions, frontend, dist):
    fam = cfg.family
    _, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    if dist is not None:
        x = dist.shard_activations(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    if fam in DECODER_FAMILIES:
        for lp in layer_params(params):
            x, _, _, a = _run(remat, _layer_fwd, lp, x, positions, cfg,
                              None, None, dist)
            if a is not None:
                aux = aux + a
    elif fam == "encdec":
        memory = encode(params, cfg, frontend, x.dtype, remat, dist)
        for lp in layer_params(params, "dec"):
            x = _run(remat, _layer_fwd, lp, x, positions, cfg, "xdec",
                     memory, dist)[0]
    else:
        memory = frontend.to(x.dtype)
        for g in layer_params(params, "groups"):
            for lp in layer_params(g, "selfs"):
                x = _run(remat, _layer_fwd, lp, x, positions, cfg,
                         "dense", None, dist)[0]
            x = _run(remat, _layer_fwd, g["cross"], x, positions, cfg,
                     "cross", memory, dist)[0]
    x = L.rmsnorm(params["norm_f"], x)
    logits = L.unembed(params["head"], x)
    if dist is not None:
        logits = dist.shard_logits(logits)
    return logits, aux


def forward(params, cfg: ArchConfig, tokens, positions=None, frontend=None,
            dist=None):
    """tokens (B, S) -> logits (B, S, vocab); placed under ``dist``."""
    return forward_aux(params, cfg, tokens, positions, frontend, dist)[0]


def init_cache(params, cfg: ArchConfig, batch, seq, dtype=torch.bfloat16):
    """Fixed-shape caches, stacked on the layer dim as in the reference:
    "kv" (dense, moe, hybrid, encdec's decoder) k/v (n_layers, B, S, KV,
    hd), pos (n_layers, S), S cut to the attention window; vlm's
    "kv_self" the same over its G * (k - 1) self layers; "ssm" (ssm,
    hybrid) the zero mixer state, h (n_layers, B, H, P, N) fp32 and conv
    (n_layers, B, width - 1, conv_dim); the cross caches "xk"/"xv" of
    encdec (n_layers, B, T, KV, hd) and vlm (G, B, T, KV, hd), T =
    ``cfg.n_frontend_tokens``."""
    dev = params["embed"]["table"].device
    fam = cfg.family

    def kv(n):
        eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        shape = (n, batch, eff, cfg.n_kv_heads, cfg.hd)
        pos = torch.arange(eff, dtype=torch.int32, device=dev)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos": pos.expand(n, eff).contiguous()}

    def cross(n):
        shape = (n, batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
        return {"xk": torch.zeros(shape, dtype=dtype, device=dev),
                "xv": torch.zeros(shape, dtype=dtype, device=dev)}

    if fam == "encdec":
        return {"kv": kv(n_layers(params, "dec")),
                **cross(n_layers(params, "dec"))}
    if fam == "vlm":
        G = n_layers(params, "groups")
        return {"kv_self": kv(G * (cfg.cross_attn_interval - 1)),
                **cross(G)}
    n = n_layers(params)
    cache = {}
    if fam != "ssm":
        cache["kv"] = kv(n)
    if fam in ("ssm", "hybrid"):
        one = S.ssm_state_init(M.take_layer(params["layers"]["ssm"], 0),
                               batch, dtype)
        cache["ssm"] = {k: v.expand((n,) + v.shape).contiguous()
                        for k, v in one.items()}
    return cache


def _decode(params, cfg: ArchConfig, token, cache, layers, attn,
            moe_group=None, dist=None):
    """The decode step's layer loop.  ``attn(lp, hn, kv_cache)`` is the
    self-attention of one layer on its normed input and that layer's KV
    views; every cache write is in place (the caches stay whole on every
    rank under a mesh)."""
    with _region(dist):
        return _decode_layers(params, cfg, token, cache, layers, attn,
                              moe_group, dist)


def _decode_layers(params, cfg, token, cache, layers, attn, moe_group, dist):
    x = L.embed(params["embed"], token)
    if dist is not None:
        x = dist.shard_activations(x)
    if layers is None:
        layers = decode_layers(params, cfg)
    fam = cfg.family
    if fam == "encdec":
        for i, lp in enumerate(layers):
            x = x + attn(lp, L.rmsnorm(lp["ln1"], x),
                         M.take_layer(cache["kv"], i))
            x = x + A.cross_decode(lp["xattn"], L.rmsnorm(lp["lnx"], x),
                                   cache["xk"][i], cache["xv"][i],
                                   cfg.n_heads, cfg.n_kv_heads, cfg.hd)
            x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["ln2"], x))
    elif fam == "vlm":
        i = 0
        for g, (selfs, cp) in enumerate(layers):
            for lp in selfs:
                x = x + attn(lp, L.rmsnorm(lp["ln1"], x),
                             M.take_layer(cache["kv_self"], i))
                x = x + L.ffn(lp["ffn"], L.rmsnorm(lp["ln2"], x))
                i += 1
            xa = A.cross_decode(cp["xattn"], L.rmsnorm(cp["ln1"], x),
                                cache["xk"][g], cache["xv"][g], cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd)
            x = x + torch.tanh(cp["gate"]).to(x.dtype) * xa
            x = x + L.ffn(cp["ffn"], L.rmsnorm(cp["ln2"], x))
    else:
        for i, lp in enumerate(layers):
            hn = L.rmsnorm(lp["ln1"], x)
            if fam in ("ssm", "hybrid"):
                sm, st = S.ssm_decode(lp["ssm"], hn,
                                      M.take_layer(cache["ssm"], i),
                                      dist=dist)
                for k, v in st.items():
                    cache["ssm"][k][i] = v if dist is None else \
                        dist.gather(v)
            if fam == "ssm":
                x = x + sm
                continue
            # the layer's KV views into the stack
            att = attn(lp, hn, M.take_layer(cache["kv"], i))
            if fam == "hybrid":
                att = (att + sm) * 0.5
            x = x + att
            x = x + _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg, moe_group,
                         dist)[0]
    x = L.rmsnorm(params["norm_f"], x)
    logits = L.unembed(params["head"], x)
    if dist is not None:
        logits = dist.shard_logits(logits)
    return logits, cache


def decode_step(params, cfg: ArchConfig, token, cache, pos, layers=None,
                dist=None):
    """token (B, 1) int; pos (B, 1) int current position; returns
    (logits (B, 1, V), cache) — the cache is updated in place.  ``layers``
    is ``decode_layers(params, cfg)`` when the caller already has it.
    encdec's and vlm's self-attention is unwindowed, as the reference's;
    their cross-attention reads the prefill's cross cache."""
    window = cfg.sliding_window if cfg.family in DECODER_FAMILIES else 0

    def attn(lp, hn, c):
        return A.mha_decode(lp["attn"], hn, c, pos, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd, window=window,
                            rope_theta=cfg.rope_theta, dist=dist)[0]
    return _decode(params, cfg, token, cache, layers, attn, dist=dist)


def decode_step_ragged(params, cfg: ArchConfig, token, cache, pos, cap,
                       layers=None, dist=None):
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
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not served by the continuous-"
            f"batching engine ({'/'.join(DECODER_FAMILIES)} only)")

    def attn(lp, hn, c):
        return A.mha_decode_ragged(lp["attn"], hn, c, pos, cap, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.hd,
                                   window=cfg.sliding_window,
                                   rope_theta=cfg.rope_theta, dist=dist)[0]
    return _decode(params, cfg, token, cache, layers, attn, moe_group=1,
                   dist=dist)


def sample(logits, temperature=0.0, generator=None):
    """(B, V) logits -> (B, 1) next tokens: the argmax at temperature 0,
    else a draw from softmax(logits / temperature) (fp32) by
    ``generator``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1)[:, None]


def decode_loop(params, cfg: ArchConfig, tok, cache, start_pos, n_new,
                temperature=0.0, generator=None, dist=None):
    """Generate ``n_new`` tokens: ``n_new`` decode steps, each feeding back
    its ``sample`` (greedy at temperature 0, else drawn by
    ``generator``).  tok (B, 1) is the first token to emit and start_pos
    (B, 1) its position.  Returns (tokens (B, n_new), cache); tok itself
    is the first output token, as in the reference.  Under ``dist`` each
    step's logits are gathered whole before the sample, so every rank
    feeds back the same tokens."""
    toks = []
    layers = decode_layers(params, cfg)
    for i in range(n_new):
        toks.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache, start_pos + i,
                                    layers, dist)
        if dist is not None:
            logits = dist.gather(logits)
        tok = sample(logits[:, -1, :], temperature, generator).to(tok.dtype)
    return torch.cat(toks, dim=1), cache
