"""Slot cache for the continuous-batching engine (the port's copy of
``repro.serve.kvcache``).

The cache is one fixed-capacity tree of tensors shared by every live
request: each request owns one *slot* (a batch row) of every leaf, so
admitting or evicting a request is a row write, never a reshape, and the
engine's decode step keeps the shapes (and, on the card, the addresses
its CUDA graph was captured with) for the engine's whole lifetime.

Layout per family (``L`` = layer-stack dim, ``B`` = slot count, ``S`` =
slot sequence capacity):

* attention families (dense / moe / hybrid): ``k``/``v`` slot tensors
  ``(L, B, S, KV, hd)`` plus a per-entry position map ``pos (L, B, S)``
  int32.  Entries never written hold :data:`INVALID_POS`, which fails the
  ``k_pos <= q_pos`` decode mask for every real query position, so a
  slot's empty (or evicted) region can never attend.
* SSM families (ssm / hybrid): the per-layer decode state (``h (L, B, H,
  P, N)`` fp32 + ``conv (L, B, W-1, C)``), one batch row per slot.

Ring rule: a request whose prefill produced ``cap`` cache entries keeps
position ``p`` at ring index ``p % cap`` of its row (``slot_capacity``
gives ``cap``; ``models.attention.ring_slot`` the index), the rule
``serve.engine.prefill`` / ``generate`` follow, so each slot decodes as a
B = 1 ``generate`` of its request does.

Every write below is IN PLACE into the tensors ``init_slots`` allocated:
a captured CUDA graph reads them by address, so rebinding a leaf would
leave the graph reading stale memory.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import module as M
from repro_torch.models import ssm as S

# Sentinel for cache entries never written (or invalidated by eviction):
# larger than any reachable token position, so the decode mask
# ``k_pos <= q_pos`` always rejects it.
INVALID_POS = 1 << 30


def slot_capacity(cfg: ArchConfig, prompt_len: int) -> int:
    """Ring capacity of a request's prefill cache: the sliding window when
    it is shorter than the prompt, else the full prompt.  The one rule
    ``serve.engine.prefill`` (the cache ``generate`` decodes over) and the
    engine's slots share."""
    W = cfg.sliding_window
    if W and W < prompt_len:
        return W
    return prompt_len


def init_slots(params, cfg: ArchConfig, n_slots: int, seq_cap: int,
               dtype=torch.bfloat16):
    """Allocate the engine's slot cache on the params' device: all-zero KV
    with every position :data:`INVALID_POS` (nothing attends), zero SSM
    state."""
    fam = cfg.family
    if fam not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {fam!r} has no slot-cache layout (the serving engine "
            "covers dense/moe/ssm/hybrid)")
    dev = params["embed"]["table"].device
    n = cfg.n_layers
    cache = {}
    if fam != "ssm":
        shape = (n, n_slots, seq_cap, cfg.n_kv_heads, cfg.hd)
        cache["kv"] = {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.full((n, n_slots, seq_cap), INVALID_POS,
                              dtype=torch.int32, device=dev)}
    if fam in ("ssm", "hybrid"):
        one = S.ssm_state_init(M.take_layer(params["layers"]["ssm"], 0),
                               n_slots, dtype)
        cache["ssm"] = {k: v.expand((n,) + v.shape).contiguous()
                        for k, v in one.items()}
    return cache


def write_prefill(cache, slot: int, request_cache):
    """Graft one request's ``serve.engine.prefill`` cache (batch 1) into
    row ``slot``, in place: KV ``k/v (L, 1, cap, KV, hd)`` and ``pos
    (L, cap)`` into the row's first ``cap`` entries, the rest of the row
    zeroed and its positions invalidated, so nothing of a previous
    occupant survives; SSM state leaves ``(L, 1, ...)`` over the whole
    row.  Returns ``cache``."""
    if "kv" in cache:
        kv, rkv = cache["kv"], request_cache["kv"]
        cap = rkv["pos"].shape[1]
        for name in ("k", "v"):
            row = kv[name][:, slot]
            row.zero_()
            row[:, :cap].copy_(rkv[name][:, 0])
        pos = kv["pos"][:, slot]
        pos.fill_(INVALID_POS)
        pos[:, :cap].copy_(rkv["pos"])
    if "ssm" in cache:
        for name, st in cache["ssm"].items():
            st[:, slot].copy_(request_cache["ssm"][name][:, 0])
    return cache


def clear_slot(cache, slot: int):
    """Evict row ``slot``: invalidate every position, so the dead history
    can never attend into the slot's next occupant (admission also
    zero-fills the row).  SSM state needs no invalidation: admission
    overwrites it whole and a free slot's outputs are never read.
    Returns ``cache``."""
    if "kv" in cache:
        cache["kv"]["pos"][:, slot].fill_(INVALID_POS)
    return cache


def poison_slot(cache, slot: int, value=float("nan")):
    """Fault injector: overwrite every FLOAT leaf of row ``slot`` with
    ``value``, so the next decode step gives non-finite logits for THAT
    slot only (slots share weights, never activations).  Integer leaves
    (the positions) are left alone; admission rewrites the whole row.
    Returns ``cache``."""
    for group in cache.values():
        for t in group.values():
            if t.is_floating_point():
                t[:, slot].fill_(value)
    return cache
