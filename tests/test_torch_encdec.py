"""The encoder-decoder family (seamless-m4t-large-v2 SMOKE) against the
reference, fp32 on the CPU: the params tree, ``forward`` (dense and
compiled), ``prefill``'s logits and caches (the decoder's self "kv", the
cross "xk"/"xv" of the encoder's memory), one ``decode_step``,
``init_cache``, greedy ``generate`` tokens (dense and packed), the
compiled layouts leaf for leaf, ``forward_aux``'s loss and grads under
``make_loss_fn``, and ``lm_layers`` with its dead cross-attention rule.

The weights are the reference's ``init_lm`` trees crossed through
``convert.params_from_numpy``; the frontend (the audio-frame stand-in)
comes from numpy with a seed.  The helpers here also drive
``test_torch_vlm.py`` (llama-3.2-vision-90b SMOKE, its cross gates set to
1.0 so the cross-attention reaches the logits)."""
import functools
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.core.mapper_rule import lm_layers as ref_lm_layers  # noqa: E402
from repro.data import pipeline as ref_data  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import mapper_rule as MR  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

from test_torch_reference import (SPEC_RE, assert_layout_equal,  # noqa: E402
                                  packed_nodes, ref_to_numpy, to_port)

ARCH = "seamless-m4t-large-v2"
RTOL = ATOL = 2e-4       # the bound tests/test_torch_model.py uses
LOSS_TOL = 1e-5          # loss (relative) and grads (of each leaf's max |g|)
B, S, N_NEW = 2, 8, 6


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def model(arch):
    """The SMOKE model of ``arch`` both ways, built once: reference cfg,
    port cfg, reference fp32 params (a vlm's cross gates set to 1.0),
    the serving CLI's (16, 16) block masks at rate 0.6 and the masked
    params, both packages' ``compile_model(keep_dense=False)`` trees and
    reports, the prompts and the numpy frontend (B, T, D)."""
    rcfg = ref_configs.get(arch, smoke=True)
    pcfg = configs.get(arch, smoke=True)
    rp = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0), rcfg),
                              jnp.float32)
    if rcfg.family == "vlm":
        cross = dict(rp["groups"]["cross"])
        cross["gate"] = jnp.ones_like(cross["gate"])
        rp = dict(rp, groups=dict(rp["groups"], cross=cross))
    spec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    masks = ref_RW.magnitude_block_masks(rp, spec, None, rate=0.6)
    rpm = ref_trainer.apply_masks(rp, masks)
    rexec, rrep = ref_compile.compile_model(
        rpm, masks, spec, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(
        to_port(rpm), to_port(masks),
        [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))],
        spec=C.CompileSpec(keep_dense=False), device="cpu")
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, rcfg.vocab, size=(B, S))
    frontend = rng.randn(B, rcfg.n_frontend_tokens,
                         rcfg.d_model).astype(np.float32)
    return dict(rcfg=rcfg, pcfg=pcfg, rp=rp, masks=masks, rpm=rpm,
                rexec=rexec, rrep=rrep, pexec=pexec, prep=prep,
                tokens=tokens, frontend=frontend)


@functools.lru_cache(maxsize=None)
def _ref_forward(rcfg):
    return jax.jit(lambda p, t, f: ref_T.forward(p, rcfg, t, frontend=f))


@functools.lru_cache(maxsize=None)
def _ref_prefill(rcfg):
    return jax.jit(lambda p, t, f: ref_engine.prefill(p, rcfg, t,
                                                      frontend=f))


def _inputs(m):
    """(reference (tokens, frontend), port (tokens, frontend))."""
    return ((jnp.asarray(m["tokens"]), jnp.asarray(m["frontend"])),
            (torch.from_numpy(m["tokens"]), torch.from_numpy(m["frontend"])))


def structure(arch):
    """The reference's tree crosses into the structure, shapes and dtypes
    of the port's own ``init_lm``."""
    rcfg = ref_configs.get(arch, smoke=True)
    crossed = _flat(to_port(jax.jit(ref_T.init_lm, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)))
    own = _flat(T.init_lm(configs.get(arch, smoke=True), seed=0,
                          device="cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in crossed.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in own.items()}
    return own


def forward_matches(arch):
    m = model(arch)
    (rt, rf), (pt, pf) = _inputs(m)
    want, _ = _ref_forward(m["rcfg"])(m["rpm"], rt, rf)
    dense = T.forward(to_port(m["rpm"]), m["pcfg"], pt, frontend=pf)
    packed = T.forward(m["pexec"], m["pcfg"], pt, frontend=pf)
    for got in (dense, packed):
        _close(got, want)
    return want


def prefill_matches(arch, cache_keys):
    """Logits and every cache leaf; positions equal."""
    m = model(arch)
    (rt, rf), (pt, pf) = _inputs(m)
    for params, pparams in ((m["rpm"], to_port(m["rpm"])),
                            (m["rexec"], m["pexec"])):
        r_logits, r_cache = _ref_prefill(m["rcfg"])(params, rt, rf)
        p_logits, p_cache = engine.prefill(pparams, m["pcfg"], pt,
                                           frontend=pf)
        _close(p_logits, r_logits)
        assert set(p_cache) == set(r_cache) == set(cache_keys)
        r_flat, p_flat = _flat(r_cache), _flat(p_cache)
        assert set(r_flat) == set(p_flat)
        for k, r in r_flat.items():
            r = np.asarray(r)
            assert tuple(p_flat[k].shape) == r.shape, k
            if k.endswith("pos"):
                np.testing.assert_array_equal(p_flat[k].numpy(), r)
            else:
                _close(p_flat[k], r)
    return p_cache


def decode_step_matches(arch):
    """One decode step after the prefill (position S), logits and the
    self cache written in place."""
    m = model(arch)
    (rt, rf), (pt, pf) = _inputs(m)
    _, r_cache = _ref_prefill(m["rcfg"])(m["rexec"], rt, rf)
    _, p_cache = engine.prefill(m["pexec"], m["pcfg"], pt, frontend=pf)
    tok = np.array([[3], [7]], np.int32)
    pos = np.full((B, 1), S, np.int32)
    r_logits, r_cache = jax.jit(ref_T.decode_step, static_argnums=1)(
        m["rexec"], m["rcfg"], jnp.asarray(tok), r_cache, jnp.asarray(pos))
    p_logits, p_cache = T.decode_step(m["pexec"], m["pcfg"],
                                      torch.from_numpy(tok), p_cache,
                                      torch.from_numpy(pos))
    _close(p_logits, r_logits)
    r_flat, p_flat = _flat(r_cache), _flat(p_cache)
    for k, r in r_flat.items():
        if k.endswith("pos"):
            np.testing.assert_array_equal(p_flat[k].numpy(), np.asarray(r))
        else:
            _close(p_flat[k], r)


def init_cache_matches(arch):
    m = model(arch)
    want = _flat(ref_T.init_cache(m["rp"], m["rcfg"], 3, 10))
    got = _flat(T.init_cache(to_port(m["rp"]), m["pcfg"], 3, 10))
    assert set(got) == set(want)
    for k, r in want.items():
        r = np.asarray(r)
        assert tuple(got[k].shape) == r.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      r.astype(np.float32))
    return got


def generate_matches(arch):
    """Greedy tokens identical to the reference's, dense and packed, and
    packed == dense in the port."""
    m = model(arch)
    (rt, rf), _ = _inputs(m)
    got = {}
    for name, rparams, pparams in (("dense", m["rpm"], to_port(m["rpm"])),
                                   ("packed", m["rexec"], m["pexec"])):
        want = np.asarray(ref_engine.generate(rparams, m["rcfg"], rt, N_NEW,
                                              frontend=rf))
        got[name] = engine.generate(pparams, m["pcfg"], m["tokens"], N_NEW,
                                    device="cpu", frontend=m["frontend"])
        assert got[name].shape == (B, N_NEW)
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), want)
    assert torch.equal(got["packed"], got["dense"])
    oracle = engine.generate_python(m["pexec"], m["pcfg"], m["tokens"],
                                    N_NEW, device="cpu",
                                    frontend=m["frontend"])
    assert torch.equal(oracle, got["packed"])
    return got["packed"]


def layouts_match(arch, n_packed):
    """Every packed projection's layout leaf for leaf, and the report rows
    equal as JSON."""
    m = model(arch)
    got, want = packed_nodes(m["pexec"]), packed_nodes(m["rexec"])
    assert set(got) == set(want) and len(got) == n_packed
    for path in want:
        assert_layout_equal(got[path], want[path])
    rows = {r.path: r.to_json() for r in m["prep"]}
    ref_rows = {r.path: r.to_json() for r in m["rrep"]}
    assert rows == ref_rows
    return got


def loss_and_grads_match(arch):
    """``make_loss_fn`` under autograd against ``jax.value_and_grad`` of
    the reference's, on the reference's synthetic batch (its bf16
    frontend crossed bit for bit); ``remat="full"`` gives the same loss
    and grads bitwise."""
    m = model(arch)
    rcfg = m["rcfg"]
    batch = {k: np.asarray(v) for k, v in ref_data.synthetic_batch(
        0, 0, B, S, rcfg.vocab, frontend_tokens=rcfg.n_frontend_tokens,
        d_model=rcfg.d_model).items()}
    assert batch["frontend"].dtype.name == "bfloat16"
    (want, want_ce), want_g = jax.jit(jax.value_and_grad(
        ref_trainer.make_loss_fn(rcfg), has_aux=True))(
            m["rp"], {k: jnp.asarray(v) for k, v in batch.items()})
    (got, got_ce), got_g = trainer.value_and_grad(trainer.make_loss_fn(
        m["pcfg"]))(to_port(m["rp"]),
                    {k: tensor_from_numpy(v, "cpu")
                     for k, v in batch.items()})
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(got_ce) == pytest.approx(float(want_ce), rel=LOSS_TOL)
    # every encoder, decoder, self and cross layer checkpointed: the same
    # loss and grads, bit for bit
    (remat, _), remat_g = trainer.value_and_grad(trainer.make_loss_fn(
        m["pcfg"].replace(remat="full")))(
            to_port(m["rp"]), {k: tensor_from_numpy(v, "cpu")
                               for k, v in batch.items()})
    assert torch.equal(remat, got)
    for k, v in _flat(remat_g).items():
        assert torch.equal(v, _flat(got_g)[k]), k
    g, w = _flat(got_g), _flat(ref_to_numpy(want_g))
    assert set(g) == set(w)
    for k in w:
        wk = np.asarray(w[k], np.float32)
        np.testing.assert_allclose(
            g[k].float().numpy(), wk, rtol=0,
            atol=LOSS_TOL * max(np.abs(wk).max(), 1e-30), err_msg=k)
    return g


def lm_layers_match(arch, tokens=128):
    rows = MR.lm_layers(configs.get(arch), tokens)
    want = ref_lm_layers(ref_configs.get(arch), tokens)
    assert [vars(r) for r in rows] == [vars(r) for r in want]
    return rows


def first_rule(rows, path):
    """Index of the first row whose pattern ``match`` (re.search) finds in
    ``path``, as ``core.reweighted.match`` takes a spec's rules."""
    return next((i for i, r in enumerate(rows) if re.search(r.path, path)),
                None)


def xattn_rule_is_dead(arch):
    """The reference's cross-attention rule matches every cross-attention
    wq / wo leaf, yet no leaf of the model takes it: the self-attention
    rules come first and match the same paths (``attn/wq/w`` is a
    substring of ``xattn/wq/w``), and ``match`` takes the first."""
    rows = lm_layers_match(arch)
    xi = next(i for i, r in enumerate(rows) if r.path.startswith("xattn"))
    paths = [p for p in _flat(model(arch)["pexec"]) if "xattn" in p]
    leaves = [p for p in _flat(to_port(model(arch)["rp"]))
              if p.endswith("/w") or p.endswith("table")]
    hit = [p for p in leaves if re.search(rows[xi].path, p)]
    assert hit and all("xattn/w" in p for p in hit)
    assert all(first_rule(rows, p) != xi for p in leaves)
    assert all(first_rule(rows, p) is not None for p in hit)
    assert {rows[first_rule(rows, p)].path for p in hit} == {
        r"attn/wq/w", r"attn/wo/w"}
    # the same choice through the port's own match, rule by rule
    spec = [(r.path, RW.SchemeChoice("block", (16, 16 * (i + 1))))
            for i, r in enumerate(rows)]
    for p in hit:
        assert RW.match(spec, p).block[1] != 16 * (xi + 1)
    assert paths


def robustness_walks(arch, tmp_path):
    """``validate_tree``, ``bitflip_packed_leaf`` + ``degrade_invalid_layers``
    and the artifact store walk the family's trees: every packed stack
    validates, the seeded fault hits the reference's layer and its stack
    alone retires (the degraded forward stays the reference's), and a
    warm start from the store gives the cold compile's layouts and
    logits."""
    from repro.testing import faults as ref_F
    from repro_torch.core import validate as V
    from repro_torch.testing import faults as F
    m = model(arch)
    assert V.validate_tree(m["pexec"]) == len(packed_nodes(m["pexec"]))
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))]
    kd, rep = C.compile_model(to_port(m["rpm"]), to_port(m["masks"]), pspec,
                              device="cpu")
    rkd, _ = ref_compile.compile_model(
        m["rpm"], m["masks"], [(SPEC_RE, ref_RW.SchemeChoice("block",
                                                             (16, 16)))])
    bad, rec = F.bitflip_packed_leaf(kd, seed=0)
    assert rec.target == ref_F.bitflip_packed_leaf(rkd, seed=0)[1].target
    tree, rep, degraded = C.degrade_invalid_layers(bad, report=rep)
    assert [p for p, _ in degraded] == [rec.target]
    assert [r.path for r in rep if r.degraded] == [rec.target + "/w"]
    (rt, rf), (pt, pf) = _inputs(m)
    want, _ = _ref_forward(m["rcfg"])(m["rpm"], rt, rf)
    _close(T.forward(tree, m["pcfg"], pt, frontend=pf), want)
    cold, _ = C.compile_model(to_port(m["rpm"]), to_port(m["masks"]), pspec,
                              spec=C.CompileSpec(keep_dense=False),
                              device="cpu", artifact_dir=tmp_path)
    warm, _ = C.compile_model(to_port(m["rpm"]), to_port(m["masks"]), pspec,
                              spec=C.CompileSpec(keep_dense=False),
                              device="cpu", artifact_dir=tmp_path)
    a, b = packed_nodes(cold), packed_nodes(warm)
    assert set(a) == set(b) == set(packed_nodes(m["pexec"]))
    for k in a:
        for x, y in zip(a[k].values + a[k].k_idx + (a[k].nnz, a[k].perm),
                        b[k].values + b[k].k_idx + (b[k].nnz, b[k].perm)):
            assert torch.equal(x, y), k
    assert torch.equal(T.forward(warm, m["pcfg"], pt, frontend=pf),
                       T.forward(cold, m["pcfg"], pt, frontend=pf))


# -- tests ---------------------------------------------------------------------

def test_params_tree_matches_port_init_structure():
    own = structure(ARCH)
    assert own["enc/attn/wq/w"].shape == (2, 64, 64)
    assert own["dec/xattn/wk/w"].shape == (2, 64, 64)
    assert {k.split("/")[0] for k in own} == {
        "embed", "head", "norm_f", "enc", "dec", "norm_e"}


def test_forward_logits_match_reference_dense_and_compiled():
    forward_matches(ARCH)


def test_the_memory_reaches_the_logits():
    """A different frontend changes the logits: the decoder reads the
    encoder through its cross-attention."""
    m = model(ARCH)
    pt = torch.from_numpy(m["tokens"])
    pf = torch.from_numpy(m["frontend"])
    a = T.forward(m["pexec"], m["pcfg"], pt, frontend=pf)
    b = T.forward(m["pexec"], m["pcfg"], pt, frontend=pf.flip(1))
    assert (a - b).abs().max() > 1e-3 * a.abs().max()


def test_prefill_logits_and_caches_match_reference():
    cache = prefill_matches(ARCH, ("kv", "xk", "xv"))
    assert tuple(cache["xk"].shape) == (2, B, 32, 4, 16)
    assert tuple(cache["kv"]["k"].shape) == (2, B, S, 4, 16)
    assert cache["kv"]["pos"].tolist() == [list(range(S))] * 2


def test_decode_step_matches_reference():
    decode_step_matches(ARCH)


def test_init_cache_matches_reference_layout():
    got = init_cache_matches(ARCH)
    assert set(got) == {"kv/k", "kv/v", "kv/pos", "xk", "xv"}


def test_generate_tokens_identical_to_reference():
    generate_matches(ARCH)


def test_compiled_layouts_equal_reference_leaf_for_leaf():
    """Every enc / dec attention, cross-attention and FFN projection
    packs: 7 encoder and 11 decoder stacks."""
    got = layouts_match(ARCH, 18)
    assert got["dec/xattn/wq"].nnz.shape[0] == 2


def test_forward_aux_loss_and_grads_match_reference():
    g = loss_and_grads_match(ARCH)
    assert float(g["enc/attn/wk/w"].abs().max()) > 0
    assert float(g["norm_e/scale"].abs().max()) > 0


def test_lm_layers_rows_equal_reference():
    rows = lm_layers_match(ARCH)
    assert [r.path for r in rows][-3:] == [
        r"xattn/wq/w|xattn/wo/w", r"head/table", r"embed/table"]


def test_the_reference_cross_attention_rule_is_dead_and_copied():
    xattn_rule_is_dead(ARCH)


def test_validate_faults_and_artifacts_walk_the_tree(tmp_path):
    robustness_walks(ARCH, tmp_path)
