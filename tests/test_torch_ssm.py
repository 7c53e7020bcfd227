"""The port's SSM and hybrid families against the reference, at mamba2-1.3b
and hymba-1.5b SMOKE size, fp32 unless stated: the conv1d helpers, the
SSD scan and its segment sums, the mixer (``ssm``) and its O(1) decode
step, the in/out projection layouts ``compile_model`` packs, and
``forward`` / ``prefill`` logits, caches and greedy tokens for dense and
compiled (``keep_dense=False``) params.  Inputs come from numpy seeds and
cross as numpy; the reference runs as its own tests run it (Pallas kernels
in interpret mode).

The hybrid prefill state deliberately differs from the reference's: the
port takes it from the mixer's run on the layer's input, the reference
recomputes it on the layer's output (``repro/serve/engine.py:55-58``), a
state no ``forward`` ever had.  The hybrid tests hold the port to the
reference's ``forward`` and to its ``decode_loop`` fed the state built
from the layer input; ``test_reference_hybrid_prefill_state_is_taken_
from_the_layer_output`` pins the reference's behaviour."""
import functools
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import ssm as ref_S  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import (_flat_structure,  # noqa: E402
                                  assert_layout_equal, to_port)

TOL = 1e-5               # fp32, relative to the reference's max |value|
CONV_TOL = 1e-6          # fp32 conv1d outputs
ARCHS = ("mamba2-1.3b", "hymba-1.5b")
ROOT = Path(__file__).resolve().parents[1]


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_rel(port, ref, tol=TOL):
    """max |port - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """fp32 reference params of ``arch`` SMOKE masked at rate 0.6 under
    the serving spec ((16, 8) blocks on the SSM projections, (16, 16) on
    attention and FFN), both packages' compiled params (``keep_dense=
    False``) and reports; built once per arch for the module."""
    rcfg = ref_configs.get(arch, smoke=True)
    pcfg = configs.get(arch, smoke=True)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    rexec, rrep = ref_compile.compile_model(
        rpm, rmasks, REF_SPEC, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(to_port(rpm), to_port(rmasks), SPARSE_SPEC,
                                  spec=C.CompileSpec(keep_dense=False),
                                  device="cpu")
    return dict(rcfg=rcfg, pcfg=pcfg, rparams=rparams, rpm=rpm, rexec=rexec,
                rrep=rrep, pexec=pexec, prep=prep, pdense=to_port(rpm))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def mamba():
    return _model("mamba2-1.3b")


@pytest.fixture(scope="module")
def hymba():
    return _model("hymba-1.5b")


def _mixer(seed=0):
    """One fp32 reference mixer at mamba2 SMOKE widths (d_model 64, state
    16, headdim 16: 8 heads) with a non-trivial dt_bias and D."""
    rp = ref_module.cast_tree(
        ref_S.ssm_init(jax.random.PRNGKey(seed), 64, 16, headdim=16),
        jnp.float32)
    rp = dict(rp, dt_bias=jnp.asarray(_np(seed + 1, 8, scale=0.5)),
              D=jnp.asarray(1 + _np(seed + 2, 8, scale=0.1)))
    return rp, to_port(rp)


# -- conv1d and the SSD scan -------------------------------------------------

def test_causal_conv1d_and_step_match_reference():
    w, x = _np(0, 4, 24), _np(1, 2, 7, 24)
    state = _np(2, 2, 3, 24)
    want = ref_L.causal_conv1d({"w": jnp.asarray(w)}, jnp.asarray(x))
    got = L.causal_conv1d({"w": _t(w)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CONV_TOL,
                               atol=CONV_TOL)
    r_st, r_out = ref_L.conv1d_step({"w": jnp.asarray(w)}, jnp.asarray(state),
                                    jnp.asarray(x[:, 0]))
    p_st, p_out = L.conv1d_step({"w": _t(w)}, _t(state), _t(x[:, 0]))
    np.testing.assert_array_equal(p_st.numpy(), np.asarray(r_st))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out),
                               rtol=CONV_TOL, atol=CONV_TOL)


def test_conv1d_init_is_scaled_by_width():
    gen = torch.Generator().manual_seed(0)
    w = L.conv1d_init(160, 4, gen, n=3, dtype=torch.float32)["w"]
    assert tuple(w.shape) == (3, 4, 160)
    assert w.abs().max() <= 2.0 * 4 ** -0.5 + 1e-6


def test_segsum_matches_reference():
    x = _np(3, 2, 3, 8)
    want = np.asarray(ref_S._segsum(jnp.asarray(x)))
    got = S._segsum(_t(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 28
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    assert torch.equal(torch.exp(S._segsum(_t(x)))[..., 0, 1],
                       torch.zeros(2, 3))


def test_ssd_scan_over_four_chunks_matches_reference():
    """S = 16 in chunks of 4: the inter-chunk recurrence runs 4 steps."""
    B, Sq, H, P, N = 2, 16, 3, 5, 4
    xh, Bm, Cm = _np(4, B, Sq, H, P), _np(5, B, Sq, H, N), _np(6, B, Sq, H, N)
    dt = np.log1p(np.exp(_np(7, B, Sq, H)))
    A = -np.exp(_np(8, H, scale=0.5))
    y_r, h_r = ref_S._ssd_scan(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                               chunk=4)
    y_p, h_p = S._ssd_scan(*map(_t, (xh, dt, A, Bm, Cm)), chunk=4)
    assert y_p.dtype == h_p.dtype == torch.float32
    _close_rel(y_p, y_r)
    _close_rel(h_p, h_r)
    # one chunk of 16 computes the same function
    y_1, h_1 = S._ssd_scan(*map(_t, (xh, dt, A, Bm, Cm)), chunk=16)
    _close_rel(y_1, y_r)
    _close_rel(h_1, h_r)


def test_ssd_scan_refuses_a_ragged_chunk():
    """Past one chunk (S > 64) S must be a multiple of it, as in the
    reference; the port raises rather than asserts."""
    x, bc = torch.zeros(1, 72, 2, 4), torch.zeros(1, 72, 2, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S._ssd_scan(x, torch.zeros(1, 72, 2), torch.zeros(2), bc, bc)


@pytest.mark.parametrize("Sq", [16, 2])
def test_ssm_matches_reference(Sq):
    """Output and decode state {h, conv} at S = 16, and at S = 2 < width
    - 1, where the conv tail is zero-padded in front."""
    rp, pp = _mixer()
    x = _np(9, 2, Sq, 64)
    want, r_st = ref_S.ssm(rp, jnp.asarray(x))
    got, p_st = S.ssm(pp, _t(x))
    _close_rel(got, want)
    _close_rel(p_st["h"], r_st["h"])
    assert tuple(p_st["conv"].shape) == np.asarray(r_st["conv"]).shape
    _close_rel(p_st["conv"], r_st["conv"])
    if Sq == 2:
        assert not p_st["conv"][:, 0].any()


def test_ssm_decode_chain_equals_ssm():
    """``ssm_decode`` token by token from ``ssm_state_init`` gives the
    full-sequence mixer's outputs and final state; one step also equals
    the reference's step."""
    rp, pp = _mixer(seed=3)
    x = _np(10, 2, 12, 64)
    full, st_full = S.ssm(pp, _t(x))
    st = S.ssm_state_init(pp, 2, torch.float32)
    outs = []
    for t in range(12):
        y, st = S.ssm_decode(pp, _t(x[:, t:t + 1]), st)
        outs.append(y)
    _close_rel(torch.cat(outs, 1), full.numpy())
    _close_rel(st["h"], st_full["h"].numpy())
    assert torch.equal(st["conv"], st_full["conv"])
    r_st = ref_S.ssm_state_init(rp, 2, 64, jnp.float32)
    r_y, r_st = ref_S.ssm_decode(rp, jnp.asarray(x[:, :1]), r_st)
    p_y, p_st = S.ssm_decode(pp, _t(x[:, :1]),
                             S.ssm_state_init(pp, 2, torch.float32))
    _close_rel(p_y, r_y)
    _close_rel(p_st["h"], r_st["h"])


# -- params, packing and caches ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_crosses_with_bf16_bits(arch):
    """The reference's own bf16 init (A_log, D, dt_bias fp32) crosses whole
    into the structure, shapes and dtypes the port's ``init_lm`` builds,
    every bf16 leaf bit for bit."""
    rcfg = ref_configs.get(arch, smoke=True)
    rparams = ref_T.init_lm(jax.random.PRNGKey(0), rcfg)
    crossed = to_port(rparams)
    own = T.init_lm(configs.get(arch, smoke=True), seed=0, device="cpu")
    assert _flat_structure(crossed) == _flat_structure(own)
    assert own["layers"]["ssm"]["A_log"].dtype == torch.float32
    assert own["layers"]["ssm"]["in_proj"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(
        own["layers"]["ssm"]["A_log"],
        torch.log(torch.linspace(1, 16, own["layers"]["ssm"]["D"].shape[-1]))
        .expand_as(own["layers"]["ssm"]["A_log"]))
    r_in = np.asarray(rparams["layers"]["ssm"]["in_proj"]["w"])
    np.testing.assert_array_equal(
        crossed["layers"]["ssm"]["in_proj"]["w"].view(torch.int16).numpy(),
        r_in.view(np.int16))


def test_projection_layouts_match_reference(model):
    """in/out_proj pack with (16, 8) blocks to the reference's leaves bit
    for bit; conv1d stays dense (no scheme mapped); report rows agree;
    ``_dims`` reads the geometry from the layouts once "w" is dropped."""
    p_ssm = model["pexec"]["layers"]["ssm"]
    r_ssm = model["rexec"]["layers"]["ssm"]
    for name in ("in_proj", "out_proj"):
        assert "w" not in p_ssm[name]
        assert p_ssm[name]["packed"].block == (16, 8)
        assert_layout_equal(p_ssm[name]["packed"], r_ssm[name]["packed"])

    def rows(rep):
        return sorted((r.path, r.packed, r.reason, r.L, r.L_reordered, r.Kb,
                       r.layers) for r in rep)
    assert rows(model["prep"]) == rows(model["rrep"])
    by_path = {r.path: r for r in model["prep"]}
    assert by_path["layers/ssm/conv/w"].packed is False
    lp = T.layer_params(model["pexec"])[0]["ssm"]
    cfg = model["pcfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    assert S._dims(lp) == (d_inner, d_inner // cfg.ssm_headdim,
                           cfg.ssm_headdim, cfg.ssm_state)
    assert S._dims(lp) == ref_S._dims(
        jax.tree_util.tree_map(lambda a: a[0], model["rexec"]["layers"]
                               ["ssm"]), cfg.d_model)


def test_init_cache_matches_reference_layout(model):
    rcfg, pcfg = model["rcfg"], model["pcfg"]
    want = ref_T.init_cache(model["rpm"], rcfg, 3, 40)
    got = T.init_cache(model["pdense"], pcfg, 3, 40)
    assert sorted(got) == sorted(want)
    for group in got:
        for name, t in got[group].items():
            r = np.asarray(want[group][name])
            assert tuple(t.shape) == r.shape
            np.testing.assert_array_equal(t.float().numpy(),
                                          r.astype(np.float32))
    assert got["ssm"]["h"].dtype == torch.float32
    assert got["ssm"]["conv"].dtype == torch.bfloat16


# -- whole model ---------------------------------------------------------------

def test_forward_logits_match_reference(model):
    """fp32 logits of ``forward``, dense and compiled, within 1e-5 of max
    |logit|."""
    tokens = _tokens(model["rcfg"].vocab, 2, 16, seed=1)
    want = ref_T.forward(model["rpm"], model["rcfg"], jnp.asarray(tokens))[0]
    for params in (model["pdense"], model["pexec"]):
        got = T.forward(params, model["pcfg"], torch.from_numpy(tokens))
        _close_rel(got, want)


def test_mamba_prefill_matches_reference(mamba):
    """The ssm family's prefill takes the state from the mixer's own run,
    as the reference's does: logits and every layer's state agree."""
    tokens = _tokens(mamba["rcfg"].vocab, 2, 16, seed=2)
    r_logits, r_cache = ref_engine.prefill(mamba["rpm"], mamba["rcfg"],
                                           jnp.asarray(tokens))
    for params in (mamba["pdense"], mamba["pexec"]):
        p_logits, p_cache = engine.prefill(params, mamba["pcfg"],
                                           torch.from_numpy(tokens))
        assert sorted(p_cache) == ["ssm"]
        _close_rel(p_logits, r_logits)
        _close_rel(p_cache["ssm"]["h"], r_cache["ssm"]["h"])
        _close_rel(p_cache["ssm"]["conv"], r_cache["ssm"]["conv"])


def test_mamba_generate_tokens_identical_to_reference(mamba):
    """Greedy tokens equal the reference's ``generate``, dense and packed."""
    rcfg, pcfg = mamba["rcfg"], mamba["pcfg"]
    tokens = _tokens(rcfg.vocab, 2, 8, seed=4)
    for rp, pp in ((mamba["rpm"], mamba["pdense"]),
                   (mamba["rexec"], mamba["pexec"])):
        want = np.asarray(ref_engine.generate(rp, rcfg, jnp.asarray(tokens),
                                              10))
        got = engine.generate(pp, pcfg, tokens, 10, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _ref_layer_inputs_and_states(rparams, rcfg, tokens):
    """Per layer of the reference's own ``_layer_fwd`` chain: the layer
    input, and the mixer's state on its normed input (what ``forward``
    computed) and on its normed output (what the reference's hybrid
    prefill recomputes)."""
    positions = jnp.arange(tokens.shape[1], dtype=jnp.int32)
    x = ref_L.embed(rparams["embed"], jnp.asarray(tokens))
    on_in, on_out = [], []
    for i in range(rcfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], rparams["layers"])
        on_in.append(ref_S.ssm(lp["ssm"], ref_L.rmsnorm(lp["ln1"], x))[1])
        x, _, _ = ref_T._layer_fwd(lp, x, positions, rcfg, "hybrid")
        on_out.append(ref_S.ssm(lp["ssm"], ref_L.rmsnorm(lp["ln1"], x))[1])

    def stack(sts):
        return {k: jnp.stack([s[k] for s in sts]) for k in sts[0]}
    return stack(on_in), stack(on_out)


@pytest.mark.parametrize("Sq", [16, 40])
def test_hymba_prefill_cache_matches_reference(hymba, Sq):
    """Logits and the windowed KV equal the reference's prefill (S = 40 is
    past SMOKE's window of 32); every layer's SSM state equals the
    reference's mixer on the layer INPUT."""
    rcfg, pcfg = hymba["rcfg"], hymba["pcfg"]
    tokens = _tokens(rcfg.vocab, 2, Sq, seed=5)
    r_logits, r_cache = ref_engine.prefill(hymba["rpm"], rcfg,
                                           jnp.asarray(tokens))
    on_in, _ = _ref_layer_inputs_and_states(hymba["rpm"], rcfg, tokens)
    for params in (hymba["pdense"], hymba["pexec"]):
        p_logits, p_cache = engine.prefill(params, pcfg,
                                           torch.from_numpy(tokens))
        _close_rel(p_logits, r_logits)
        np.testing.assert_array_equal(p_cache["kv"]["pos"].numpy(),
                                      np.asarray(r_cache["kv"]["pos"]))
        assert p_cache["kv"]["k"].shape[2] == min(Sq, 32)
        for name in ("k", "v"):
            _close_rel(p_cache["kv"][name], r_cache["kv"][name])
        _close_rel(p_cache["ssm"]["h"], on_in["h"])
        _close_rel(p_cache["ssm"]["conv"], on_in["conv"])


def test_reference_hybrid_prefill_state_is_taken_from_the_layer_output(
        hymba):
    """The reference's fault, pinned: its hybrid prefill state is the
    mixer's on the layer OUTPUT, which is not the port's (layer input)."""
    rcfg, pcfg = hymba["rcfg"], hymba["pcfg"]
    tokens = _tokens(rcfg.vocab, 2, 15, seed=6)
    _, r_cache = ref_engine.prefill(hymba["rpm"], rcfg, jnp.asarray(tokens))
    _, on_out = _ref_layer_inputs_and_states(hymba["rpm"], rcfg, tokens)
    np.testing.assert_allclose(np.asarray(r_cache["ssm"]["h"]),
                               np.asarray(on_out["h"]), rtol=1e-5,
                               atol=1e-6)
    _, p_cache = engine.prefill(hymba["pdense"], pcfg,
                                torch.from_numpy(tokens))
    gap = np.abs(p_cache["ssm"]["h"].numpy()
                 - np.asarray(r_cache["ssm"]["h"])).max()
    assert gap > 100 * TOL * np.abs(np.asarray(r_cache["ssm"]["h"])).max()


@pytest.mark.parametrize("Sq", [16, 40])
def test_hymba_generate_tokens_identical_to_reference(hymba, Sq):
    """Greedy tokens, dense and packed, equal the reference's
    ``decode_loop`` started from its prefill cache with the ``ssm`` entry
    replaced by the mixer's state on each layer's input; prompts shorter
    and longer than SMOKE's window of 32."""
    rcfg, pcfg = hymba["rcfg"], hymba["pcfg"]
    tokens = _tokens(rcfg.vocab, 2, Sq, seed=7)
    n_new = 10
    for rp, pp in ((hymba["rpm"], hymba["pdense"]),
                   (hymba["rexec"], hymba["pexec"])):
        logits, cache = ref_engine.prefill(rp, rcfg, jnp.asarray(tokens))
        cache["ssm"], _ = _ref_layer_inputs_and_states(rp, rcfg, tokens)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        want, _ = ref_T.decode_loop(rp, rcfg, tok, cache,
                                    jnp.full((2, 1), Sq, jnp.int32), n_new)
        got = engine.generate(pp, pcfg, tokens, n_new, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grow_ring(cache, pos):
    """The prefill cache with its KV ring grown by one free slot, so the
    next decode step (at ``pos``) evicts no position."""
    kv = cache.get("kv")
    if kv is not None:
        kv["k"] = torch.cat([kv["k"], torch.zeros_like(kv["k"][:, :, :1])], 2)
        kv["v"] = torch.cat([kv["v"], torch.zeros_like(kv["v"][:, :, :1])], 2)
        kv["pos"] = torch.cat([kv["pos"],
                               torch.full_like(kv["pos"][:, :1], pos)], 1)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_forward(arch):
    """``decode_step`` at position S - 1 after ``prefill`` of S - 1 tokens
    (the hybrid's KV ring grown by one slot, so no position is evicted)
    gives ``forward``'s logits at S - 1 (fp32): the chunked scan and the
    O(1) step agree, and the hybrid's state is the one ``forward`` had."""
    m = _model(arch)
    pcfg, params = m["pcfg"], m["pexec"]
    tokens = torch.from_numpy(_tokens(pcfg.vocab, 2, 24, seed=8))
    want = T.forward(params, pcfg, tokens)[:, -1]
    _, cache = engine.prefill(params, pcfg, tokens[:, :-1])
    got, _ = T.decode_step(params, pcfg, tokens[:, -1:], _grow_ring(cache, 23),
                           torch.full((2, 1), 23, dtype=torch.int32))
    _close_rel(got[:, 0], want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_cli_serves_smoke_on_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--sparse", "--device", "cpu", "--new-tokens", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "pack layers/ssm/in_proj/w" in out.stdout
    assert "pack layers/ssm/out_proj/w" in out.stdout
    assert "skip layers/ssm/conv/w" in out.stdout
    assert "generated (4, 4)" in out.stdout
