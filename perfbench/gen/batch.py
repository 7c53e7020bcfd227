"""An offline backlog: the harness keeps the engine's queue filled, so a
slot is refilled the step it frees.

Mix keys: ``prompt`` and ``output`` (``perfbench.draw`` length specs),
``block`` (requests a stratified block), ``requests`` (the backlog's
length, in whole blocks)."""
from __future__ import annotations

import numpy as np

from perfbench import draw


def requests(mix, seed, vocab):
    rng = np.random.default_rng(seed)
    block = int(mix["block"])
    n_blocks = -(-int(mix["requests"]) // block)
    plen = draw.permuted_blocks(draw.lengths(mix["prompt"], block),
                                n_blocks, rng)
    olen = draw.permuted_blocks(draw.lengths(mix["output"], block),
                                n_blocks, rng)
    prompts = draw.token_ids(rng, plen, vocab)
    return [draw.Request(p, int(o)) for p, o in zip(prompts, olen)]
