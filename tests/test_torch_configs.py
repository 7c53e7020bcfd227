"""The configs the port gained with the scheme mapping (granite-8b,
minitron-8b, phi3-medium-14b, kimi-k2-1t-a32b) against the reference's:
the published and SMOKE widths field for field, the alias table, and at
SMOKE (fp32) the dense params' logits and greedy tokens, then a compile at
the largest block ``legal_blocks`` gives every projection (phi3's d_model
60 and head_dim 12 leave (4, 4)): layouts leaf for leaf, logits and
greedy tokens.  kimi-k2 SMOKE is a MoE of 8 experts, top-2, dispatch
groups of 64 tokens: it runs the MoE path of ``test_torch_moe.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import regularity as R  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import (SPEC_RE, assert_layout_equal,  # noqa: E402
                                  to_port)

NEW = ("granite-8b", "minitron-8b", "phi3-medium-14b", "kimi-k2-1t-a32b")
TOL = 1e-5               # fp32 SMOKE logits, dense params
RTOL = ATOL = 2e-4       # fp32 logits of compiled params (test_torch_model)


def _shared_fields(port, ref):
    names = {f.name for f in dataclasses.fields(port)}
    return ({n: getattr(port, n) for n in names},
            {n: getattr(ref, n) for n in names})


@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_configs_match_reference(arch):
    """Every field the port's ``ArchConfig`` carries equals the
    reference's, published and SMOKE (the sharding, optimizer and remat
    fields are the reference's alone)."""
    for smoke in (False, True):
        got, want = _shared_fields(configs.get(arch, smoke=smoke),
                                   ref_configs.get(arch, smoke=smoke))
        assert got == want
    assert configs.ALIASES[arch] == ref_configs.ALIASES[arch]


def test_aliases_hold_the_ported_families_only():
    """Every architecture of the reference is ported, all six families;
    a name the table does not hold is refused."""
    assert set(NEW) <= set(configs.ALIASES)
    assert configs.ALIASES == ref_configs.ALIASES
    assert {configs.get(a).family for a in configs.ALIASES} == {
        "dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    with pytest.raises(KeyError, match="not ported"):
        configs.get("gpt-2")
    assert configs.get("phi3_medium_14b", smoke=True).hd == 12


_MODELS: dict = {}


def _model(arch):
    """(reference cfg, port cfg, reference fp32 SMOKE params), once."""
    if arch not in _MODELS:
        rcfg = ref_configs.get(arch, smoke=True)
        _MODELS[arch] = (rcfg, configs.get(arch, smoke=True),
                         ref_module.cast_tree(ref_T.init_lm(
                             jax.random.PRNGKey(0), rcfg), jnp.float32))
    return _MODELS[arch]


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(B, S))


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_and_tokens_match_reference(arch):
    rcfg, pcfg, rp = _model(arch)
    tokens = _tokens(rcfg, 2, 16, seed=1)
    want, _ = ref_T.forward(rp, rcfg, jnp.asarray(tokens))
    got = T.forward(to_port(rp), pcfg, torch.from_numpy(tokens))
    assert tuple(got.shape) == (2, 16, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    prompt = _tokens(rcfg, 2, 8, seed=2)
    want_tok = np.asarray(ref_engine.generate(rp, rcfg, jnp.asarray(prompt),
                                              10))
    got_tok = engine.generate(to_port(rp), pcfg, prompt, 10, device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def _legal_block(rp):
    """The largest block of ``legal_blocks``' menu that tiles every
    projection the serving spec matches."""
    shapes = set()

    def walk(t, path=""):
        for k, v in t.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            elif k == "w" and ref_RW.match([(SPEC_RE, 0)], p) is not None:
                shapes.add(tuple(v.shape[-2:]))
    walk(rp)
    common = set.intersection(*(set(R.legal_blocks(*s)) for s in shapes))
    return max(common, key=lambda b: b[0] * b[1])


@pytest.mark.parametrize("arch", NEW)
def test_smoke_compiled_at_a_legal_block_matches_reference(arch):
    """Magnitude block masks at rate 0.6 and ``compile_model`` at the
    largest legal block: every layout leaf equal to the reference's; the
    packed port model's logits within the LM bound of the reference's
    masked-dense model (plain XLA, not its interpret-mode kernels), and
    greedy tokens identical."""
    rcfg, pcfg, rp = _model(arch)
    block = _legal_block(rp)
    if arch == "phi3-medium-14b":
        assert block == (4, 4)
    rspec = [(SPEC_RE, ref_RW.SchemeChoice("block", block))]
    pspec = [(SPEC_RE, RW.SchemeChoice("block", block))]
    rmasks = ref_RW.magnitude_block_masks(rp, rspec, None, rate=0.6)
    rpm = ref_apply_masks(rp, rmasks)
    rexec, _ = ref_compile.compile_model(
        rpm, rmasks, rspec, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(
        to_port(rpm), to_port(rmasks), pspec,
        spec=C.CompileSpec(keep_dense=False), device="cpu")
    assert len(prep.packed) == 7
    groups = ("attn", "moe" if pcfg.family == "moe" else "ffn")
    for group in groups:
        for name, node in pexec["layers"][group].items():
            if "packed" in node:
                assert_layout_equal(node["packed"],
                                    rexec["layers"][group][name]["packed"])
    tokens = _tokens(rcfg, 2, 16, seed=3)
    want, _ = ref_T.forward(rpm, rcfg, jnp.asarray(tokens))
    got = T.forward(pexec, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    prompt = _tokens(rcfg, 2, 8, seed=4)
    want_tok = np.asarray(ref_engine.generate(rpm, rcfg, jnp.asarray(prompt),
                                              10))
    got_tok = engine.generate(pexec, pcfg, prompt, 10, device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
