"""Seeded traffic: the same seed gives the same requests; other seeds give
the same sizes in each block, in another order, with other token ids."""
import math
from collections import Counter

import numpy as np
import pytest

from perfbench import draw

SEEDS = (7, 2**31 + 5)
MIXES = ["decode-batch"]


def _requests(bench, mix_name, seed):
    mix = bench.mix(mix_name)
    return mix, bench.generator(mix["kind"]).requests(mix, seed, 64000)


@pytest.mark.parametrize("mix_name", MIXES)
def test_same_seed_same_requests(bench, mix_name):
    _, a = _requests(bench, mix_name, SEEDS[1])
    _, b = _requests(bench, mix_name, SEEDS[1])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.max_new == y.max_new
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix_name", MIXES)
def test_seeds_permute_the_same_sizes(bench, mix_name):
    mix, a = _requests(bench, mix_name, SEEDS[0])
    _, b = _requests(bench, mix_name, SEEDS[1])
    block = mix["block"]
    n = min(len(a), len(b)) // block * block
    assert n >= block
    for i in range(0, n, block):
        pa = Counter(len(r.prompt) for r in a[i:i + block])
        pb = Counter(len(r.prompt) for r in b[i:i + block])
        oa = Counter(r.max_new for r in a[i:i + block])
        ob = Counter(r.max_new for r in b[i:i + block])
        assert pa == pb and oa == ob
    assert [len(r.prompt) for r in a[:block]] != \
        [len(r.prompt) for r in b[:block]]
    assert not np.array_equal(a[0].prompt[:4], b[0].prompt[:4])


@pytest.mark.parametrize("mix_name", MIXES)
def test_lengths_within_the_mix(bench, mix_name):
    mix, reqs = _requests(bench, mix_name, SEEDS[0])
    shapes = set(draw.shapes(mix["prompt"], mix["block"]))
    for r in reqs:
        assert len(r.prompt) in shapes
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 64000
    # the port's prefill takes prompts over 1024 only in whole 1024s
    assert all(n <= 1024 or n % 1024 == 0 for n in shapes)


def test_batch_mix_keeps_its_source_means(bench):
    """The stated means of the source hold before the clip, and the clip
    takes off little of them."""
    mix = bench.mix("decode-batch")
    for key in ("prompt", "output"):
        spec = mix[key]
        unclipped = dict(spec, min=1, max=10**9)
        lens = draw.lengths(unclipped, 4096)
        assert np.mean(lens) == pytest.approx(spec["mean"], rel=0.03)
        clipped = np.mean(draw.lengths(spec, mix["block"]))
        assert 0.85 * spec["mean"] < clipped <= 1.02 * spec["mean"]


def test_clip_and_mean_rules():
    spec = {"min": 4, "max": 1024}
    assert draw.clip(1, spec) == 4
    assert draw.clip(16.2, spec) == 17
    assert draw.clip(9999, spec) == 1024
    # the median of a lognormal of mean m and sigma s is m * exp(-s**2 / 2)
    out = {"min": 1, "max": 10**9, "sigma": 0.5}
    lens = draw.lengths({**out, "mean": 100 * math.exp(0.125)}, 63)
    assert lens == sorted(lens) and lens[31] == 100
