"""Deterministic synthetic data pipeline (the reference's
``repro.data.pipeline``, drawn with torch's generators).

Batches are a pure function of (seed, step, shard), so any host can
recompute any shard: no data-loader state to checkpoint, and a replacement
host joining mid-run reproduces exactly the shard it inherits.

The task is a noisy learned-bigram language: token_{t+1} = perm[token_t]
with probability 1 - noise, else uniform.  Models drive the loss well
below the uniform entropy quickly, which gives pruning a real accuracy
signal.  The draws are torch's, not the reference's PRNG, and always come
from torch's CPU generator (MT19937): the batch is drawn on the host and
then moved to the requested device, so the same (seed, step, shard) gives
the same tensors on the CPU and on the card (the CUDA generator is a
different algorithm, Philox) and a resumed run on either sees the batches
of the run it resumes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import module as M


def _generator(*key):
    """A CPU ``torch.Generator`` seeded from ``key`` (numpy's
    ``SeedSequence`` mixes the integers)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0] >> np.uint64(1)))
    return g


def bigram_perm(vocab, seed=7, device="cuda"):
    """The task's successor permutation of ``range(vocab)``, drawn on the
    host and moved to ``device``."""
    dev = M.resolve_device(device)
    return torch.randperm(vocab, generator=_generator(seed)).to(dev)


def synthetic_batch(seed, step, batch, seq, vocab, noise=0.3, shard=0,
                    frontend_tokens=0, d_model=0, device="cuda"):
    """{'tokens': (B, S) int64, 'labels': (B, S)}: B chains of S + 1
    tokens, the labels the tokens shifted by one; with ``frontend_tokens``
    also 'frontend' (B, frontend_tokens, d_model) bf16 standard normals,
    encdec's and vlm's embedding stand-in, drawn after the tokens.  Drawn
    on the host, then moved to ``device``."""
    dev = M.resolve_device(device)
    g = _generator(seed, step, shard)
    perm = bigram_perm(vocab, device="cpu")
    tok = torch.randint(0, vocab, (batch,), generator=g)
    rnd = torch.randint(0, vocab, (seq, batch), generator=g)
    use_rnd = torch.rand((seq, batch), generator=g) < noise
    toks = [tok]
    for t in range(seq):
        tok = torch.where(use_rnd[t], rnd[t], perm[tok])
        toks.append(tok)
    toks = torch.stack(toks, dim=1).to(dev)              # (B, S + 1)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frontend_tokens:
        out["frontend"] = torch.randn(
            (batch, frontend_tokens, d_model), generator=g).to(
                torch.bfloat16).to(dev)
    return out


def host_shard(global_batch, n_hosts, host_id):
    """(start, size) of this host's contiguous slice of the global
    batch."""
    per = global_batch // n_hosts
    return host_id * per, per
