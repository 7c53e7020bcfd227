"""Deterministic synthetic data pipeline (the reference's
``repro.data.pipeline``, drawn with torch's generators).

Batches are a pure function of (seed, step, shard), so any host can
recompute any shard: no data-loader state to checkpoint, and a replacement
host joining mid-run reproduces exactly the shard it inherits.

The task is a noisy learned-bigram language: token_{t+1} = perm[token_t]
with probability 1 - noise, else uniform.  Models drive the loss well
below the uniform entropy quickly, which gives pruning a real accuracy
signal.  The draws are torch's (per device), not the reference's PRNG.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import module as M


def _generator(device, *key):
    """A ``torch.Generator`` on ``device`` seeded from ``key`` (numpy's
    ``SeedSequence`` mixes the integers)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0] >> np.uint64(1)))
    return g


def bigram_perm(vocab, seed=7, device="cuda"):
    """The task's successor permutation of ``range(vocab)``."""
    dev = M.resolve_device(device)
    return torch.randperm(vocab, generator=_generator(dev, seed), device=dev)


def synthetic_batch(seed, step, batch, seq, vocab, noise=0.3, shard=0,
                    frontend_tokens=0, d_model=0, device="cuda"):
    """{'tokens': (B, S) int64, 'labels': (B, S)}: B chains of S + 1
    tokens, the labels the tokens shifted by one."""
    if frontend_tokens:
        raise NotImplementedError(
            "frontend embeddings (encdec / vlm) come with ROADMAP queue 1 "
            "item 6")
    dev = M.resolve_device(device)
    g = _generator(dev, seed, step, shard)
    perm = bigram_perm(vocab, device=dev)
    tok = torch.randint(0, vocab, (batch,), generator=g, device=dev)
    rnd = torch.randint(0, vocab, (seq, batch), generator=g, device=dev)
    use_rnd = torch.rand((seq, batch), generator=g, device=dev) < noise
    toks = [tok]
    for t in range(seq):
        tok = torch.where(use_rnd[t], rnd[t], perm[tok])
        toks.append(tok)
    toks = torch.stack(toks, dim=1)                      # (B, S + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_shard(global_batch, n_hosts, host_id):
    """(start, size) of this host's contiguous slice of the global
    batch."""
    per = global_batch // n_hosts
    return host_id * per, per
