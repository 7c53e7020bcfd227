"""Seeded request streams: what every traffic generator shares.

A mix gives each length as a clipped lognormal (``mean``, ``sigma``,
``min``, ``max``): the mean its source states.  The lengths are drawn
stratified, not at random: a block of ``block`` requests takes the
distribution's quantiles at (i + 1/2) / block, and the seed only permutes
them within each block.
So every seed serves the same multiset of sizes in every block, in
another order, with other token ids: two seeds differ in what the engine
is handed, not in how much work it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Request:
    """One request as the generator hands it to the harness: its prompt
    token ids and its output budget (greedy, no stop token)."""
    prompt: np.ndarray
    max_new: int


def clip(v, spec):
    """A length rounded up to a whole token within [min, max]."""
    return min(max(int(math.ceil(v)), int(spec["min"])), int(spec["max"]))


def lengths(spec, block):
    """The ``block`` stratified quantiles of the clipped lognormal
    ``spec``, in ascending order.  ``mean`` is the unclipped lognormal's:
    its median is mean * exp(-sigma**2 / 2)."""
    s = float(spec["sigma"])
    mu = math.log(spec["mean"]) - s * s / 2.0
    z = [NormalDist().inv_cdf((i + 0.5) / block) for i in range(block)]
    return [clip(math.exp(mu + s * zi), spec) for zi in z]


def shapes(spec, block):
    """Every length a mix of ``block``-request blocks can send."""
    return sorted(set(lengths(spec, block)))


def permuted_blocks(values, n_blocks, rng):
    """``n_blocks`` copies of ``values``, each in its own seeded order."""
    return np.concatenate([rng.permutation(values) for _ in range(n_blocks)])


def token_ids(rng, lens, vocab):
    """One prompt of uniform token ids in [0, vocab) a length."""
    flat = rng.integers(0, vocab, size=int(sum(lens)), dtype=np.int64)
    return np.split(flat.astype(np.int32), np.cumsum(lens)[:-1])
