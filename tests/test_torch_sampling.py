"""Temperature sampling in ``generate`` / ``decode_loop`` (the reference's
``temperature=`` path; its JAX PRNG cannot be reproduced, so the tests
hold the distribution and the seeding, not the tokens): temperature 0 is
the greedy path, the first token is the prefill's argmax at any
temperature, one generator seed gives one token sequence, each step draws
from softmax(logits / T) by the generator, and over many draws at fixed
logits the token frequencies pass a chi-square test against
softmax(logits / T), as the reference's ``jax.random.categorical`` draws
do."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCHS = ("yi-9b", "seamless-m4t-large-v2")
B, S, N_NEW = 2, 8, 10
P_MIN = 1e-3             # chi-square p-value a sound sampler passes
DRAWS = 20000


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = configs.get(arch, smoke=True)
    params = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab, size=(B, S))
    frontend = (torch.from_numpy(rng.randn(
        B, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32))
        if cfg.family == "encdec" else None)
    return cfg, params, tokens, frontend


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _generate(arch, **kw):
    cfg, params, tokens, frontend = _model(arch)
    return engine.generate(params, cfg, tokens, N_NEW, device="cpu",
                           frontend=frontend, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_temperature_zero_is_greedy(arch):
    cfg, params, tokens, frontend = _model(arch)
    greedy = _generate(arch)
    assert torch.equal(_generate(arch, temperature=0.0,
                                 generator=_gen(5)), greedy)
    assert torch.equal(engine.generate_python(
        params, cfg, tokens, N_NEW, device="cpu", frontend=frontend), greedy)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.7, 5.0])
def test_first_token_is_the_prefill_argmax(arch, temperature):
    cfg, params, tokens, frontend = _model(arch)
    logits, _ = engine.prefill(params, cfg, torch.from_numpy(tokens),
                               frontend=frontend)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    for seed in range(3):
        toks = _generate(arch, temperature=temperature,
                         generator=_gen(seed))
        assert toks.dtype == torch.int32 and toks.shape == (B, N_NEW)
        assert torch.equal(toks[:, 0], first)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_seed_gives_one_sequence(arch):
    a = _generate(arch, temperature=2.0, generator=_gen(3))
    assert torch.equal(a, _generate(arch, temperature=2.0,
                                    generator=_gen(3)))
    assert not torch.equal(a, _generate(arch, temperature=2.0,
                                        generator=_gen(4)))
    # no generator: one seeded with 0
    assert torch.equal(_generate(arch, temperature=2.0),
                       _generate(arch, temperature=2.0, generator=_gen(0)))
    assert not torch.equal(a, _generate(arch))


def test_each_step_draws_from_the_tempered_softmax():
    """``decode_loop`` step i: ``decode_step``'s logits, softmax(logits /
    T) in fp32, one draw a row by the generator, fed back."""
    cfg, params, tokens, _ = _model("yi-9b")
    temperature = 1.5
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    start = torch.full((B, 1), S, dtype=torch.int32)
    _, cache = engine.prefill(params, cfg, torch.from_numpy(tokens))
    _, cache2 = engine.prefill(params, cfg, torch.from_numpy(tokens))
    got, _ = T.decode_loop(params, cfg, tok, cache, start, N_NEW,
                           temperature, _gen(9))
    g, want, t = _gen(9), [tok], tok
    for i in range(N_NEW - 1):
        logits, cache2 = T.decode_step(params, cfg, t, cache2, start + i)
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        t = torch.multinomial(probs, 1, generator=g).to(torch.int32)
        want.append(t)
    assert torch.equal(got, torch.cat(want, dim=1))


def _logits(V=16, seed=0):
    return np.random.RandomState(seed).randn(V).astype(np.float32) * 2


def _chi2_p(counts, logits, temperature):
    z = logits.astype(np.float64) / temperature
    p = np.exp(z - z.max())
    p /= p.sum()
    return stats.chisquare(counts, p * counts.sum()).pvalue


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_frequencies_pass_chi_square(temperature):
    """``sample`` over DRAWS rows of one logit vector: the frequencies
    pass against softmax(logits / T) and fail against another
    temperature's."""
    logits = _logits()
    rows = torch.from_numpy(logits).expand(DRAWS, -1)
    toks = T.sample(rows, temperature, _gen(11))
    assert toks.shape == (DRAWS, 1)
    counts = np.bincount(toks[:, 0].numpy(), minlength=logits.size)
    assert _chi2_p(counts, logits, temperature) > P_MIN
    assert _chi2_p(counts, logits, temperature * 2) < 1e-12
    # bf16 logits are sampled in fp32
    toks16 = T.sample(rows.to(torch.bfloat16), temperature, _gen(11))
    counts16 = np.bincount(toks16[:, 0].numpy(), minlength=logits.size)
    assert _chi2_p(counts16, logits, temperature) > P_MIN


@pytest.mark.parametrize("temperature", [0.5, 2.0])
def test_reference_draws_the_same_distribution(temperature):
    """The reference's ``jax.random.categorical(key, logits / T)`` passes
    the same test: both packages sample softmax(logits / T)."""
    logits = _logits()
    draws = jax.random.categorical(
        jax.random.PRNGKey(0),
        jnp.broadcast_to(jnp.asarray(logits), (DRAWS, logits.size))
        / temperature)
    counts = np.bincount(np.asarray(draws), minlength=logits.size)
    assert _chi2_p(counts, logits, temperature) > P_MIN
    port = T.sample(torch.from_numpy(logits).expand(DRAWS, -1), temperature,
                    _gen(1))
    pc = np.bincount(port[:, 0].numpy(), minlength=logits.size)
    # the two samples are draws of one distribution (2 x V contingency,
    # over the tokens either drew)
    table = np.stack([counts, pc])
    table = table[:, table.sum(0) > 0]
    assert stats.chi2_contingency(table).pvalue > P_MIN
