"""GQA attention: KV-chunked online softmax for prefill (self-attention,
or cross-attention over an encoder's memory or image patches), the direct
cached step for decode (one shared position for the batch, or ragged: one
per slot of the continuous-batching engine).  All four projections
(wq/wk/wv/wo) go through ``layers.linear``, so layers compiled by
``serve.compile`` run on the BCS kernel transparently.  The attention math
itself is plain PyTorch, as the reference leaves it to XLA.

The decode steps neither synchronise with the host nor move host data to
the card, so the engine can capture them in a CUDA graph.

Given a ``dist`` (``distributed.sharding.Dist``), q, k and v take the
reference's head or sequence placements (``shard_attn_q`` /
``shard_attn_kv``) and a decode step's cache its sequence placement
(``shard_cache``); each rank then attends with its own heads (or its own
query block against every key) through ``Dist.local_map``.  The caches
stay whole on every rank: a step's new k and v are gathered before the
in-place write (PERF.md §6 lists what each gather costs)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


def _proj(params, name, x, masks):
    return L.linear(params[name], x, masks.get(name))


def _heads(t, B, S, n, hd):
    """(B, S, n * hd) -> (B, S, n, hd).  A placed t whose feature dim is
    split in a way the head split cannot carry (over several mesh dims,
    or not along whole heads) is gathered on that dim first."""
    pls = getattr(t, "placements", None)
    if pls is not None:
        cut = [i for i, pl in enumerate(pls) if pl.is_shard(t.dim() - 1)]
        ways = 1
        for i in cut:
            ways *= t.device_mesh.size(i)
        if len(cut) > 1 or (cut and n % ways):
            from torch.distributed.tensor import Replicate
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in cut else pl for i, pl in enumerate(pls)])
    return t.reshape(B, S, n, hd)


def attn_init(d_model, n_heads, n_kv, head_dim, generator, n=None,
              dtype=torch.bfloat16, device="cpu"):
    kw = dict(n=n, dtype=dtype, device=device)
    return {
        "wq": L.linear_init(d_model, n_heads * head_dim, generator, **kw),
        "wk": L.linear_init(d_model, n_kv * head_dim, generator, **kw),
        "wv": L.linear_init(d_model, n_kv * head_dim, generator, **kw),
        "wo": L.linear_init(n_heads * head_dim, d_model, generator, **kw),
    }


def _grouped(q, n_kv):
    """(B,S,H,hd) -> (B,S,KV,G,hd): head h reads KV head h // G."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _expand_kv(k, n_heads):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each KV head G times."""
    B, S, KV, hd = k.shape
    G = n_heads // KV
    if G == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, KV, G, hd).reshape(
        B, S, n_heads, hd)


def _mask(q_pos, k_pos, causal, window):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attend(q, k, v, q_pos, k_pos, causal=True, window=0, kv_chunk=1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd) (KV already expanded);
    positions int.  Returns (B, Sq, H, hd).  A single chunk
    (kv_chunk >= Sk) is a direct softmax."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = hd ** -0.5
    kv_chunk = min(kv_chunk, Sk)
    n_chunks = Sk // kv_chunk
    assert Sk % kv_chunk == 0, (Sk, kv_chunk)
    qf = q.float() * scale

    if n_chunks == 1:
        s = torch.einsum("bqhe,bshe->bhqs", qf, k.float())
        s = torch.where(_mask(q_pos, k_pos, causal, window), s,
                        torch.tensor(NEG_INF, device=s.device))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqs,bshe->bqhe", p, v.float())
        return out.to(q.dtype)

    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        s = torch.einsum("bqhe,bshe->bhqs", qf, k[:, sl].float())
        s = torch.where(_mask(q_pos, k_pos[sl], causal, window), s,
                        torch.tensor(NEG_INF, device=s.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqs,bshe->bhqe", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                  # (B,Sq,H,hd)


def attend_cached(q, k_cache, v_cache, q_pos, k_pos, window=0):
    """Single-token decode over a KV cache.

    q: (B, Q, KV, G, hd); caches: (B, Sk, KV, hd).  Positions come either
    batch-shared (``q_pos (Q,)``, ``k_pos (Sk,)``: ``generate``) or per
    slot (``q_pos (B, Q)``, ``k_pos (B, Sk)``: the engine, where every
    slot holds its own history; never-written entries carry
    ``serve.kvcache.INVALID_POS``).  Entries whose position is after the
    query's fail the causal mask; the masked softmax is the same
    elementwise either way."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float() * hd ** -0.5,
                     k_cache.float())
    if k_pos.dim() == 1:
        kp, qp = k_pos[None, :], q_pos[:, None]                 # (Q, Sk)
    else:
        kp, qp = k_pos[:, None, :], q_pos[:, :, None]           # (B, Q, Sk)
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    if k_pos.dim() == 2:
        mask = mask[:, None, None]                              # (B,1,1,Q,Sk)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v_cache.float())
    return out.to(q.dtype)


def _whole(t, dist):
    """A step's new k or v whole on this rank, for the in-place write
    into the cache every rank holds whole (a gather over the mesh)."""
    return t if dist is None else dist.gather(t)


def _cache_views(cache, dist):
    """The layer's k / v caches as the step attends over them: placed on
    the sequence axis (``shard_cache``) under a mesh."""
    if dist is None:
        return cache["k"], cache["v"]
    return dist.shard_cache(cache["k"]), dist.shard_cache(cache["v"])


def _attend_step(q, kc, vc, q_pos, k_pos, window, dist):
    """``attend_cached`` of a decode step; under a mesh each rank attends
    with its own KV heads (``Dist.local_map``: the S-placed caches are
    redistributed to a head split), per-slot positions split with the
    batch."""
    if dist is None:
        return attend_cached(q, kc, vc, q_pos, k_pos, window=window)
    pos_dim = "b" if k_pos.dim() == 2 else None
    return dist.local_map(
        lambda *a: (attend_cached(*a, window=window),),
        (2, 2, 2, pos_dim, pos_dim), (2,))(q, kc, vc, q_pos, k_pos)[0]


def mha(params, x, positions, n_heads, n_kv, head_dim, *, causal=True,
        window=0, rope_theta=10000.0, masks=None, memory=None,
        kv_chunk=1024, dist=None, shard="heads"):
    """Full-sequence attention (prefill).  Returns (out, (k, v)) with k, v
    the (B, Sk, KV, hd) keys and values the cache keeps.

    Self-attention ropes q and k at ``positions``.  Given ``memory``
    (B, T, D), it is cross-attention: k and v are projected from the
    memory, neither q nor k is roped, the keys sit at positions 0..T-1
    and nothing is masked."""
    m = masks or {}
    B, S, _ = x.shape
    q = _heads(_proj(params, "wq", x, m), B, S, n_heads, head_dim)
    src = x if memory is None else memory
    Sk = src.shape[1]
    k = _heads(_proj(params, "wk", src, m), B, Sk, n_kv, head_dim)
    v = _heads(_proj(params, "wv", src, m), B, Sk, n_kv, head_dim)
    if memory is None:
        q = L.apply_rotary(q, positions, rope_theta)
        k = L.apply_rotary(k, positions, rope_theta)
        k_pos = positions
    else:
        k_pos = torch.arange(Sk, dtype=torch.int32, device=x.device)
        causal = False
    if dist is not None:
        # k, v placed in their compact KV form before the head expansion
        k = dist.shard_attn_kv(k, shard, n_kv)
        v = dist.shard_attn_kv(v, shard, n_kv)
    kf, vf = _expand_kv(k, n_heads), _expand_kv(v, n_heads)
    def run(q, kf, vf, q_pos, k_pos):
        return attend(q, kf, vf, q_pos, k_pos, causal=causal, window=window,
                      kv_chunk=kv_chunk),
    if dist is None:
        out, = run(q, kf, vf, positions, k_pos)
    else:
        q = dist.shard_attn_q(q, shard)
        heads = dist.mode != "fsdp" and shard == "heads"
        if heads:
            kf = dist.shard_attn_q(kf, shard)
            vf = dist.shard_attn_q(vf, shard)
        # each rank attends with its own heads, or its own query block
        # against every key (``Dist.local_map``)
        dims = ((2, 2, 2, None, None), (2,)) if heads else \
            ((1, "b", "b", 0, None), (1,))
        out, = dist.local_map(run, *dims)(q, kf, vf, positions, k_pos)
    out = out.reshape(B, S, n_heads * head_dim)
    return _proj(params, "wo", out, m), (k, v)


def cross_decode(params, x, xk, xv, n_heads, n_kv, head_dim):
    """One-token cross-attention over a prefill's compact cross cache
    ``xk``/``xv`` (B, T, KV, hd): only wq and wo run; the query sits after
    every key (position 2**30), so nothing is masked."""
    B = x.shape[0]
    q = L.linear(params["wq"], x).reshape(B, 1, n_heads, head_dim)
    q_pos = torch.full((1,), 1 << 30, dtype=torch.int32, device=x.device)
    k_pos = torch.arange(xk.shape[1], dtype=torch.int32, device=x.device)
    o = attend_cached(_grouped(q, n_kv), xk, xv, q_pos, k_pos)
    return L.linear(params["wo"], o.reshape(B, 1, n_heads * head_dim))


def mha_decode(params, x, cache, pos, n_heads, n_kv, head_dim, *,
               window=0, rope_theta=10000.0, masks=None, dist=None):
    """One-token decode.  cache = dict(k=(B,S,KV,hd), v=..., pos=(S,)).
    The new token overwrites ring slot ``pos % S`` (the oldest position
    once the ring is full) and then attends over the cache.  The cache
    tensors are updated IN PLACE (no per-step copy of the cache); the
    returned dict holds the same tensors."""
    m = masks or {}
    B = x.shape[0]
    q = _heads(_proj(params, "wq", x, m), B, 1, n_heads, head_dim)
    k = _heads(_proj(params, "wk", x, m), B, 1, n_kv, head_dim)
    v = _heads(_proj(params, "wv", x, m), B, 1, n_kv, head_dim)
    q = L.apply_rotary(q, pos, rope_theta)
    k = L.apply_rotary(k, pos, rope_theta)

    S = cache["k"].shape[1]
    k, v, wpos = _whole(k, dist), _whole(v, dist), _whole(pos, dist)
    slot = torch.remainder(wpos[0, :1], S).long()            # (1,)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slot, wpos[0, :1].to(cache["pos"].dtype))

    kc, vc = _cache_views(cache, dist)
    out = _attend_step(_grouped(q, n_kv), kc, vc, pos[0, 0:1], cache["pos"],
                       window, dist)
    out = out.reshape(B, 1, n_heads * head_dim)
    return _proj(params, "wo", out, m), cache


def mha_decode_ragged(params, x, cache, pos, cap, n_heads, n_kv, head_dim,
                      *, window=0, rope_theta=10000.0, masks=None,
                      dist=None):
    """One-token decode across RAGGED slot histories (continuous batching).

    Each slot ``b`` carries its own position ``pos[b]`` ((B, 1) int) and
    ring capacity ``cap[b]`` ((B,) int: its request's prefill length,
    ``serve.kvcache.slot_capacity``).  cache = dict(k=(B, S, KV, hd),
    v=..., pos=(B, S)) slot tensors; the new token overwrites ring index
    ``pos[b] % max(cap[b], 1)`` of row ``b``, the drop-oldest rule of
    ``mha_decode`` per slot, with one scatter by a device index (no host
    loop, no sync), IN PLACE.  Entries past a slot's capacity keep
    ``INVALID_POS``.  Returns (out, cache)."""
    m = masks or {}
    B = x.shape[0]
    q = _heads(_proj(params, "wq", x, m), B, 1, n_heads, head_dim)
    k = _heads(_proj(params, "wk", x, m), B, 1, n_kv, head_dim)
    v = _heads(_proj(params, "wv", x, m), B, 1, n_kv, head_dim)
    q = L.apply_rotary(q, pos, rope_theta)
    k = L.apply_rotary(k, pos, rope_theta)

    rows = torch.arange(B, device=x.device)
    k, v = _whole(k, dist), _whole(v, dist)
    wpos, wcap = _whole(pos, dist), _whole(cap, dist)
    slots = torch.remainder(wpos[:, 0], torch.clamp_min(wcap, 1)).long()
    cache["k"].index_put_((rows, slots), k[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((rows, slots), v[:, 0].to(cache["v"].dtype))
    cache["pos"].index_put_((rows, slots), wpos[:, 0].to(cache["pos"].dtype))

    kc, vc = _cache_views(cache, dist)
    out = _attend_step(_grouped(q, n_kv), kc, vc, pos, cache["pos"], window,
                       dist)
    out = out.reshape(B, 1, n_heads * head_dim)
    return _proj(params, "wo", out, m), cache
