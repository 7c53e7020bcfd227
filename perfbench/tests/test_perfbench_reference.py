"""The plain reference against the port at CPU widths, in float32: the
prompt's last logits against the port's forward, and the tokens the port's
engine serves past the prompt against the reference's argmax.  Each of the
two stated rules is shown to matter: without the prompt-length window, or
without the capacity drop, the reference leaves the port."""
import copy

import numpy as np
import pytest
import torch

from perfbench import harness, weights

from conftest import tiny_conf

PROMPTS = (32, 64)          # whole groups of 32 (the expert layers below)
NEW = 24


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _served(conf, params, masks, seed):
    """The port's engine over the compiled float32 weights: each prompt's
    served tokens (prompt lengths ``PROMPTS``)."""
    from repro_torch.core.reweighted import SchemeChoice
    from repro_torch.serve.compile import CompileSpec, compile_model
    from repro_torch.serve.engine import ServingEngine
    sch = conf["scheme"]
    exec_p, _ = compile_model(
        params, masks, [(sch["targets"], SchemeChoice("block", (16, 16)))],
        device="cpu", spec=CompileSpec(keep_dense=False))
    cfg = harness.arch_config(conf)
    eng = ServingEngine(exec_p, cfg, n_slots=2, seq_cap=max(PROMPTS),
                        device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPTS]
    rids = [eng.submit(p.tolist(), NEW) for p in prompts]
    eng.run()
    return cfg, exec_p, prompts, [eng.requests[r].tokens for r in rids]


def _reference(bench, conf, params, prompts, served):
    seqs = [(torch.as_tensor(np.concatenate([p, s[:-1]]), dtype=torch.long),
             len(p)) for p, s in zip(prompts, served)]
    return bench.reference(conf["reference"]).logits(params, conf["model"],
                                                     seqs)


def _setup(bench, kind, **model):
    conf = tiny_conf(bench, "yi-9b", moe=kind == "moe")
    conf["model"].update(model)
    params, masks, _ = weights.draw(conf, 2**31 + 99, "cpu")
    params = _f32(params)
    return conf, params, masks


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_reference_follows_the_served_path(bench, kind):
    conf, params, masks = _setup(bench, kind, moe_group=32)
    cfg, exec_p, prompts, served = _served(conf, params, masks, 5)
    ref = _reference(bench, conf, params, prompts, served)
    from repro_torch.models import transformer as T
    for p, s, lg in zip(prompts, served, ref):
        # the prompt's last position against the port's forward
        full = T.forward(exec_p, cfg, torch.as_tensor(p[None]))[0, -1]
        assert torch.allclose(lg[0], full.float(), atol=2e-4, rtol=1e-4)
        # every served token is the reference's argmax (float32 both)
        t = torch.as_tensor(s)
        gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        assert float(gap.max()) < 1e-4


def test_the_window_rule_matters(bench):
    """A reference with the whole history in view leaves the port from the
    first decoded token on: the ring has dropped position 0 by then."""
    conf, params, masks = _setup(bench, "dense")
    cfg, exec_p, prompts, served = _served(conf, params, masks, 6)
    ref = _reference(bench, conf, params, prompts, served)
    from repro_torch.models import transformer as T
    for p, s, lg in zip(prompts, served, ref):
        seq = torch.as_tensor(np.concatenate([p, s[:-1]]))[None]
        whole = T.forward(exec_p, cfg, seq)[0, len(p) - 1:].float()
        assert torch.allclose(lg[0], whole[0], atol=2e-4, rtol=1e-4)
        assert float((lg[1:] - whole[1:]).abs().max()) > 1e-2


def test_the_capacity_rule_matters(bench):
    """Without the capacity drop (a capacity factor no group can fill) the
    reference's prompt logits leave the port's."""
    conf, params, masks = _setup(bench, "moe", moe_group=32)
    cfg, exec_p, prompts, served = _served(conf, params, masks, 7)
    dropless = copy.deepcopy(conf)
    dropless["model"]["capacity_factor"] = 100.0
    ref = _reference(bench, conf, params, prompts, served)
    free = _reference(bench, dropless, params, prompts, served)
    from repro_torch.models import transformer as T
    worst = 0.0
    for p, lg, lf in zip(prompts, ref, free):
        full = T.forward(exec_p, cfg, torch.as_tensor(p[None]))[0, -1]
        assert torch.allclose(lg[0], full.float(), atol=2e-4, rtol=1e-4)
        worst = max(worst, float((lf[0] - full.float()).abs().max()))
    assert worst > 1e-2
