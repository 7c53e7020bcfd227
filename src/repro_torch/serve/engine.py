"""Serving: ``prefill`` (a forward pass that also emits the per-layer KV
caches and SSM states) and ``generate`` (prefill, then the greedy decode
loop).  Works with dense, masked, and ``compile_model``-packed params
alike."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.module import resolve_device
from repro_torch.models import transformer as T


def _window_kv(k, v, S_len, window):
    if window and window < S_len:
        pos = torch.arange(S_len - window, S_len, dtype=torch.int32,
                           device=k.device)
        return k[:, S_len - window:], v[:, S_len - window:], pos
    return k, v, torch.arange(S_len, dtype=torch.int32, device=k.device)


def prefill(params, cfg: ArchConfig, tokens):
    """tokens (B, S) -> (last-token logits (B, 1, V), cache).  The KV
    cache (dense, moe, hybrid) is exactly as long as the prompt, cut to
    the attention window (a ring stacked on the layer dim like
    ``models.transformer.init_cache``); the ssm and hybrid families add
    each layer's mixer state, stacked the same way.

    The hybrid state is the one the layer's own mixer run computed on the
    layer's normed input.  The reference (``repro.serve.engine.prefill``)
    runs the mixer a second time on the layer's OUTPUT ("recompute state
    cheaply"), so its decode continues from a state no ``forward`` ever
    had; the port does not copy that, and saves the second run."""
    _, Sq = tokens.shape
    positions = torch.arange(Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed(params["embed"], tokens)
    kvs, states = [], []
    for lp in T.layer_params(params):
        x, kv, st = T._layer_fwd(lp, x, positions, cfg)
        if kv is not None:
            kvs.append(_window_kv(*kv, Sq, cfg.sliding_window))
        if st is not None:
            states.append(st)
    cache = {}
    if kvs:
        k, v, pos = zip(*kvs)
        cache["kv"] = {"k": torch.stack(k), "v": torch.stack(v),
                       "pos": torch.stack(pos)}
    if states:
        cache["ssm"] = {name: torch.stack([st[name] for st in states])
                        for name in states[0]}
    x = L.rmsnorm(params["norm_f"], x[:, -1:, :])
    return L.unembed(params["head"], x), cache


def generate(params, cfg: ArchConfig, tokens, n_new, device="cuda"):
    """Greedy generation: prefill, then ``n_new`` decode steps.  Returns
    (B, n_new) int32 tokens; the first is the prefill's argmax.  Decoding
    past the prompt overwrites the ring slot of the oldest position, as
    the reference does."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    B, Sq = tokens.shape
    logits, cache = prefill(params, cfg, tokens)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    start = torch.full((B, 1), Sq, dtype=torch.int32, device=dev)
    toks, _ = T.decode_loop(params, cfg, tok, cache, start, n_new)
    return toks
