"""The benchmark's CPU tests: ``python -m pytest perfbench/tests`` from the
repository root.  They import the harness and the port from the checkout
and shrink the configurations to widths a CPU run holds."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # tiny widths gain nothing from threads, and test workers that each
    # take every core slow one another's measured windows to a crawl
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped where there is none")


TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=256)
# the reference's expert path (a mixtral-style layer: top-2 of 4 experts,
# the port's capacity dispatch in groups of 64)
TINY_MOE = dict(num_local_experts=4, num_experts_per_tok=2, moe_group=64,
                capacity_factor=1.25, sliding_window=0)


def tiny_conf(bench, name, limit=1.0, moe=False):
    """Configuration ``name`` at CPU widths: (16, 16) blocks still leave 4
    block columns.  ``moe`` gives its layers 4 experts, top-2."""
    conf = copy.deepcopy(bench.config(name))
    conf["model"].update(TINY)
    if moe:
        conf["model"].update(TINY_MOE)
    conf["check"]["limit"] = limit
    return conf


def tiny_mix(bench, name, **kw):
    """Mix ``name`` cut to 4 slots, prompts 16-64, outputs 4-32."""
    mix = copy.deepcopy(bench.mix(name))
    mix.update(n_slots=4, block=16, requests=48)
    mix["prompt"] = dict(mean=29, sigma=0.6, min=16, max=64)
    mix["output"] = dict(mean=14, sigma=0.6, min=4, max=32)
    mix.update(kw)
    return mix


@pytest.fixture(scope="session")
def bench():
    from perfbench import spec
    return spec.Bench()
