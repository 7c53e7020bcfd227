"""The paper's scheme mapping (§5) in the port against the reference, on
the CPU: the latency model (exact Python floats), the rule mapper's picks
and reports on every ported config at full width and SMOKE, on V4, V5E
and V5P, the search mapper (its decoders exact; the LSTM policy's
log-probability and gradient on the reference's weights within 1e-5;
sampling and REINFORCE on torch's own generator), the mask functions the
picks feed (bit-equal to the reference on fp32 leaves), and the served
composition map_rules -> masks -> compile_model at SMOKE (layouts leaf for
leaf, logits, greedy tokens).  Three tests pin faults of the reference
that the served path steps round (ROADMAP queue 3).  The reference runs
as its own tests run it (Pallas kernels in interpret mode); inputs come
from numpy with a seed.  ``chip_smoke.py``'s mapped phase serves the same
composition at full width on the card."""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import latency_model as ref_LM  # noqa: E402
from repro.core import mapper_rule as ref_MR  # noqa: E402
from repro.core import mapper_search as ref_MS  # noqa: E402
from repro.core import pruner as ref_pruner  # noqa: E402
from repro.core import regularity as ref_R  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.models import convnet as ref_CN  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import latency_model as LM  # noqa: E402
from repro_torch.core import mapper_rule as MR  # noqa: E402
from repro_torch.core import mapper_search as MS  # noqa: E402
from repro_torch.core import regularity as R  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

from test_torch_reference import (assert_layout_equal,  # noqa: E402
                                  assert_tap_layout_equal, packed_nodes,
                                  ref_to_numpy, to_port)

TARGETS = ("V4", "V5E", "V5P")
LM_RTOL = LM_ATOL = 2e-4     # fp32 LM logits (test_torch_model.py)
CONV_TOL = 1e-5              # the reference's conv bound
GRAD_RTOL = 1e-5


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _spec_eq(port, ref):
    """Two prune specs rule for rule, ``SchemeChoice`` field for field."""
    return ([(p, dataclasses.astuple(c)) for p, c in port]
            == [(p, dataclasses.astuple(c)) for p, c in ref])


def _both_specs(rules):
    """(port spec, reference spec) of [(path, scheme, block, kwargs)]."""
    return ([(p, RW.SchemeChoice(s, b, **kw)) for p, s, b, kw in rules],
            [(p, ref_RW.SchemeChoice(s, b, **kw)) for p, s, b, kw in rules])


# -- the latency model: pure Python floats, equal to 0 ulp ------------------

def test_targets_and_helpers_match_reference():
    for name in TARGETS:
        assert dataclasses.astuple(getattr(LM, name)) == \
            dataclasses.astuple(getattr(ref_LM, name))
    for scheme in ("none", "unstructured", "structured_row",
                   "structured_col", "pattern", "block", "block_row",
                   "block_col", "block_punched"):
        for block in ((4, 4), (64, 128), (128, 128), (256, 256)):
            assert LM._util(scheme, block) == ref_LM._util(scheme, block)
    with pytest.raises(ValueError):
        LM._util("diagonal", (4, 4))
    for conn, taps in itertools.product((0.0, 0.3, 5 / 9), (1, 4, 9)):
        assert LM.pattern_executed_frac(conn, taps) == \
            ref_LM.pattern_executed_frac(conn, taps)
    for taps, imp in itertools.product((0, 1, 9, 25), (True, False)):
        assert LM.im2col_x_frac(taps, imp) == ref_LM.im2col_x_frac(taps,
                                                                   imp)
    assert LM.conv_as_gemm(14, 64, 128, 3, 3, 8) == \
        ref_LM.conv_as_gemm(14, 64, 128, 3, 3, 8)
    for comp in (1, 2.5, 8):
        assert LM.structured_baseline(128, 4096, 11008, comp) == \
            ref_LM.structured_baseline(128, 4096, 11008, comp)


@pytest.mark.parametrize("scheme", ["none", "unstructured", "structured_row",
                                    "structured_col", "pattern", "block",
                                    "block_row", "block_col",
                                    "block_punched"])
def test_matmul_latency_matches_reference_exactly(scheme):
    """Every scheme over ``build_table``'s block menu, compressions 1-16,
    int8 or float values, the executed-tap fraction and the conv x
    traffic set and unset, on three targets and three GEMM shapes."""
    blocks = ((4, 4), (8, 16), (16, 32), (32, 64), (64, 128), (128, 128),
              (128, 256))
    n = 0
    for (M, K, N), comp, vb, ef, xf, tn in itertools.product(
            ((4, 4096, 512), (128, 4096, 11008), (65536, 576, 64)),
            (1, 2, 2.5, 4, 8, 12, 16), (None, 1), (None, 0.3),
            (None, LM.im2col_x_frac(9)), TARGETS):
        for b in blocks if scheme.startswith("block") else ((128, 128),):
            kw = dict(scheme=scheme, block=b, compression=comp,
                      value_bytes=vb, executed_frac=ef, x_frac=xf)
            got = LM.matmul_latency(M, K, N, target=getattr(LM, tn), **kw)
            want = ref_LM.matmul_latency(M, K, N, target=getattr(ref_LM, tn),
                                         **kw)
            assert got == want, (M, K, N, kw, tn)
            n += 1
    assert n >= 3 * 7 * 2 * 2 * 2 * 3


@pytest.mark.parametrize("target", TARGETS)
def test_build_table_matches_reference(target):
    got = LM.build_table(getattr(LM, target))
    want = ref_LM.build_table(getattr(ref_LM, target))
    assert got == want and len(got) > 500


def test_calibrate_matches_reference():
    for kw in (dict(), dict(measured_flops_per_s=2.5e14),
               dict(measured_bytes_per_s=2.4e11),
               dict(measured_flops_per_s=2.5e14,
                    measured_bytes_per_s=2.4e11)):
        got = LM.calibrate(LM.V5E, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(
            ref_LM.calibrate(ref_LM.V5E, **kw))
    assert LM.calibrate(LM.V5E, measured_bytes_per_s=1e12).hbm_bw == 1e12


# -- the rule mapper ---------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(configs.ALIASES))
def test_map_rules_matches_reference_on_every_ported_config(arch, smoke):
    """Picks (``SchemeChoice`` field for field) and reports (modelled
    latencies to 0 ulp) at tokens 1, 4, 128, 32768, dataset hard and
    easy, on V4, V5E and V5P."""
    cfg, rcfg = configs.get(arch, smoke=smoke), ref_configs.get(arch,
                                                                smoke=smoke)
    for tokens, hard, tn in itertools.product((1, 4, 128, 32768),
                                              (True, False), TARGETS):
        layers = MR.lm_layers(cfg, tokens)
        assert [dataclasses.astuple(ld) for ld in layers] == \
            [dataclasses.astuple(ld) for ld in ref_MR.lm_layers(rcfg,
                                                                tokens)]
        spec, report = MR.map_rules(layers, dataset_hard=hard,
                                    target=getattr(LM, tn))
        rspec, rreport = ref_MR.map_rules(ref_MR.lm_layers(rcfg, tokens),
                                          dataset_hard=hard,
                                          target=getattr(ref_LM, tn))
        assert _spec_eq(spec, rspec) and report == rreport
        assert MR.total_latency(report) == ref_MR.total_latency(rreport)


def test_map_rules_served_picks_at_full_width_and_mamba2_in_proj():
    """The picks the card serves (``chip_smoke.py``: B x S = 128 tokens,
    compression 2.5, V5E): (256, 256) int8 on every yi-9b projection;
    mamba2's in_proj maps to "none" (pruning would slow its
    MXU-unfriendly width), its out_proj to (256, 256) int8."""
    spec, report = MR.map_rules(MR.lm_layers(configs.get("yi-9b"), 128),
                                dataset_hard=True, compression=2.5)
    for r in report:
        if r["kind"] == "fc":
            assert (r["scheme"], r["block"], r["value_dtype"]) == \
                ("block", (256, 256), "int8"), r
    _, rep = MR.map_rules(MR.lm_layers(configs.get("mamba2-1.3b"), 128),
                          dataset_hard=True, compression=2.5)
    by = {r["path"]: r for r in rep}
    assert by["ssm/in_proj/w"]["scheme"] == "none"
    assert (by["ssm/out_proj/w"]["block"],
            by["ssm/out_proj/w"]["value_dtype"]) == ((256, 256), "int8")
    assert by["ssm/conv"]["scheme"] == "none"


def test_lm_layers_refuses_a_family_not_ported():
    """A family neither package defines: the reference's ``lm_layers``
    refuses nothing and lists the head and the embedding only, and so does
    the port (every family the reference defines is ported)."""
    cfg = configs.get("yi-9b", smoke=True).replace(family="foo")
    rows = MR.lm_layers(cfg, 4)
    want = ref_MR.lm_layers(ref_configs.get("yi-9b", smoke=True).replace(
        family="foo"), 4)
    assert [vars(r) for r in rows] == [vars(r) for r in want]
    assert [r.path for r in rows] == [r"head/table", r"embed/table"]


def _conv_specs(arch, hw):
    """(name, feat, Cin, Cout, kh, kw, dw) of a conv arch at an hw x hw
    input, feat the output side (halved at each stride-2 layer)."""
    out, feat, cin = [], hw, 3
    for (name, cout, kh, kw, stride, dw) in arch:
        feat //= stride
        out.append((name, feat, cin, cout, kh, kw, dw))
        cin = cin if dw else cout
    return out


@pytest.mark.parametrize("arch", ["VGG_TINY", "MOBILE_TINY"])
def test_map_rules_on_conv_layers_matches_reference(arch):
    specs = _conv_specs(getattr(CN, arch), 32)
    assert specs == _conv_specs(getattr(ref_CN, arch), 32)
    for hard, comp, tn in itertools.product((True, False), (2.0, 5.0, 8.0),
                                            TARGETS):
        layers = MR.conv_layers(specs)
        assert [dataclasses.astuple(ld) for ld in layers] == \
            [dataclasses.astuple(ld) for ld in ref_MR.conv_layers(specs)]
        spec, report = MR.map_rules(layers, dataset_hard=hard,
                                    compression=comp, target=getattr(LM, tn))
        rspec, rreport = ref_MR.map_rules(
            ref_MR.conv_layers(specs), dataset_hard=hard, compression=comp,
            target=getattr(ref_LM, tn))
        assert _spec_eq(spec, rspec) and report == rreport


def test_vgg_tiny_picks_served_on_the_card():
    """VGG_TINY's picks at compression 2 on V5E, as the reference gives
    them: in the mapper's GEMM coordinates (K = Cin*kh*kw, N = Cout)."""
    layers = MR.conv_layers(_conv_specs(CN.VGG_TINY, 32))
    _, hard = MR.map_rules(layers, dataset_hard=True, compression=2.0)
    _, easy = MR.map_rules(layers, dataset_hard=False, compression=2.0)
    assert [(r["scheme"], r["value_dtype"]) for r in hard] == [
        ("pattern", "int8"), ("pattern", None), ("pattern", None),
        ("pattern", None), ("block", "int8"), ("pattern", None)]
    assert [(r["scheme"], r["block"], r["value_dtype"]) for r in easy] == [
        ("block_punched", (27, 32), "int8"), ("block_punched", (32, 64), None),
        ("block_punched", (32, 64), None),
        ("block_punched", (64, 128), "int8"), ("block", (64, 128), "int8"),
        ("block_punched", (128, 128), "int8")]


def test_select_block_size_pick_precision_total_latency_match_reference():
    for (M, K, N), comp, beta, menu, xf, tn in itertools.product(
            ((4, 4096, 4096), (128, 4096, 512), (4096, 60, 60),
             (1024, 576, 64), (128, 27, 32)),
            (2.0, 8.0), (0.05, 0.2, 3.0),
            (None, ((8, 16), (64, 128), (128, 128))),
            (None, LM.im2col_x_frac(9)), TARGETS):
        got = MR.select_block_size(M, K, N, comp, beta, getattr(LM, tn),
                                   menu=menu, x_frac=xf)
        want = ref_MR.select_block_size(M, K, N, comp, beta,
                                        getattr(ref_LM, tn), menu=menu,
                                        x_frac=xf)
        assert got == want
    for scheme, block in (("block", (256, 256)), ("block", (16, 16)),
                          ("pattern", (64, 128)),
                          ("block_punched", (32, 64))):
        for M, ef in ((4, None), (65536, 0.3)):
            kw = dict(M=M, K=4096, N=4096, compression=2.5,
                      executed_frac=ef, x_frac=None)
            t0 = LM.matmul_latency(M, 4096, 4096, scheme=scheme, block=block,
                                   compression=2.5)
            got = MR._pick_precision(RW.SchemeChoice(scheme, block), t0,
                                     target=LM.V5E, **kw)
            want = ref_MR._pick_precision(ref_RW.SchemeChoice(scheme, block),
                                          t0, target=ref_LM.V5E, **kw)
            assert (dataclasses.astuple(got[0]), got[1]) == \
                (dataclasses.astuple(want[0]), want[1])
    rep = [{"latency_s": 1e-5 * (i + 1), "count": i} for i in range(5)]
    assert MR.total_latency(rep) == ref_MR.total_latency(rep)


# -- the search mapper --------------------------------------------------------

def _search_layers():
    """LM and conv layers of every kind, for the search mapper's parity."""
    return (MR.lm_layers(configs.get("hymba-1.5b"), 128)
            + MR.conv_layers(_conv_specs(CN.MOBILE_TINY, 16))
            + MR.conv_layers([("k5", 8, 16, 32, 5, 5, False)]))


def test_menus_applicable_features_actions_to_spec_match_reference():
    assert (MS.KINDS, MS.SCHEME_MENU, MS.BLOCK_MENU, MS.PRECISION_MENU,
            MS._QUANTIZABLE) == (ref_MS.KINDS, ref_MS.SCHEME_MENU,
                                 ref_MS.BLOCK_MENU, ref_MS.PRECISION_MENU,
                                 ref_MS._QUANTIZABLE)
    for kind in MS.KINDS:
        np.testing.assert_array_equal(MS.applicable(kind),
                                      ref_MS.applicable(kind))
    layers = _search_layers()
    np.testing.assert_array_equal(MS.layer_features(layers),
                                  ref_MS.layer_features(layers))
    rng = np.random.RandomState(0)
    for _ in range(20):
        a_s = rng.randint(0, len(MS.SCHEME_MENU), len(layers))
        a_b = rng.randint(0, len(MS.BLOCK_MENU), len(layers))
        a_p = rng.randint(0, len(MS.PRECISION_MENU), len(layers))
        for ap, rate in ((a_p, None), (None, 0.5)):
            assert _spec_eq(MS.actions_to_spec(layers, a_s, a_b, ap, rate),
                            ref_MS.actions_to_spec(layers, a_s, a_b, ap,
                                                   rate))
        # torch action tensors decode as the numpy ones
        assert _spec_eq(MS.actions_to_spec(layers, torch.from_numpy(a_s),
                                           torch.from_numpy(a_b),
                                           torch.from_numpy(a_p)),
                        ref_MS.actions_to_spec(layers, a_s, a_b, a_p))


def test_mapping_latency_matches_reference_exactly():
    layers = _search_layers()
    rng = np.random.RandomState(1)
    for i in range(30):
        a_s = rng.randint(0, len(MS.SCHEME_MENU), len(layers))
        a_b = rng.randint(0, len(MS.BLOCK_MENU), len(layers))
        a_p = rng.randint(0, len(MS.PRECISION_MENU), len(layers))
        tn, comp = TARGETS[i % 3], (2.0, 8.0)[i % 2]
        for ap in (a_p, None):
            assert MS.mapping_latency(
                layers, a_s, a_b, ap, comp, getattr(LM, tn)) == \
                ref_MS.mapping_latency(layers, a_s, a_b, ap, comp,
                                       getattr(ref_LM, tn))


def _policy_pair(hidden=16, seed=0):
    """The reference's ``policy_init`` weights and the same tensors for
    the port, with the layers' features and masks."""
    layers = _search_layers()
    feats = ref_MS.layer_features(layers)
    app = np.stack([ref_MS.applicable(ld.kind) for ld in layers])
    rp = ref_MS.policy_init(jax.random.PRNGKey(seed), feats.shape[1], hidden)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return layers, feats, app, rp, pp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mapping_logp_and_its_gradient_match_reference(seed):
    """On the reference's weights: ``mapping_logp`` of given actions
    within 1e-5, and its gradient (torch autograd against ``jax.grad``)
    within 1e-5 of each leaf's largest entry."""
    layers, feats, app, rp, pp = _policy_pair(seed=seed)
    assert {k: tuple(v.shape) for k, v in pp.items()} == {
        k: tuple(v.shape) for k, v in MS.policy_init(
            torch.Generator().manual_seed(0), feats.shape[1], 16).items()}
    rng = np.random.RandomState(seed)
    a_s = np.array([rng.choice(np.flatnonzero(m)) for m in app])
    a_b = rng.randint(0, len(MS.BLOCK_MENU), len(layers))
    a_p = rng.randint(0, len(MS.PRECISION_MENU), len(layers))
    want = float(ref_MS.mapping_logp(rp, jnp.asarray(feats), jnp.asarray(app),
                                     a_s, a_b, a_p))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    got = MS.mapping_logp(leaves, feats, app, a_s, a_b, a_p)
    assert abs(got.item() - want) <= 1e-5 * max(1.0, abs(want))
    adv = 0.37
    (-adv * got).backward()
    grads = jax.grad(lambda p: -adv * ref_MS.mapping_logp(
        p, jnp.asarray(feats), jnp.asarray(app), a_s, a_b, a_p))(rp)
    for k, g in grads.items():
        g = np.asarray(g)
        err = np.abs(leaves[k].grad.numpy() - g).max()
        assert err <= GRAD_RTOL * max(np.abs(g).max(), 1e-12), k


def test_sample_mapping_respects_masks_and_scores_its_draws():
    """Draws from an explicit generator (the same seed, the same draws),
    never a scheme the layer cannot take, and a ``logp`` equal to
    ``mapping_logp`` of the drawn actions.  Draws are not compared with
    the reference's: torch's RNG is not JAX's PRNG."""
    layers, feats, app, _, p = _policy_pair()
    seen = set()
    for seed in range(8):
        a_s, a_b, a_p, logp = MS.sample_mapping(
            p, feats, app, torch.Generator().manual_seed(seed))
        again = MS.sample_mapping(p, feats, app,
                                  torch.Generator().manual_seed(seed))
        assert all(torch.equal(u, v) for u, v in zip((a_s, a_b, a_p),
                                                      again[:3]))
        assert a_s.shape == a_b.shape == a_p.shape == (len(layers),)
        assert all(app[i, int(s)] for i, s in enumerate(a_s))
        for i, ld in enumerate(layers):
            if ld.kind in ("dw", "frozen"):
                assert MS.SCHEME_MENU[int(a_s[i])] == "none"
        torch.testing.assert_close(
            logp, MS.mapping_logp(p, feats, app, a_s, a_b, a_p),
            rtol=1e-6, atol=1e-6)
        seen.add(tuple(a_s.tolist()))
    assert len(seen) > 1


def test_search_raises_the_mean_reward():
    """REINFORCE on a toy problem where one scheme is strictly better
    learns to prefer it (the reference's own check,
    ``tests/test_mappers.py``), with torch autograd and generator."""
    layers = MR.conv_layers([("c1", 14, 64, 64, 3, 3, False)] * 3)

    def evaluate(spec):
        return float(np.mean([c.scheme == "block" for _, c in spec]))

    best, hist = MS.search(layers, evaluate, iters=60, samples=8, lr=0.15,
                           latency_weight=0.0,
                           generator=torch.Generator().manual_seed(0))
    assert len(hist) == 60
    assert np.mean(hist[-5:]) > np.mean(hist[:5])
    assert evaluate(best) >= 2 / 3


# -- the masks the picks feed -------------------------------------------------

_PARAMS: dict = {}


def _ref_lm(arch="yi-9b"):
    """(reference cfg, port cfg, reference fp32 params) of an LM SMOKE
    config, built once."""
    if arch not in _PARAMS:
        rcfg = ref_configs.get(arch, smoke=True)
        _PARAMS[arch] = (rcfg, configs.get(arch, smoke=True),
                         ref_module.cast_tree(ref_T.init_lm(
                             jax.random.PRNGKey(0), rcfg), jnp.float32))
    return _PARAMS[arch]


def _ref_vgg():
    if "vgg" not in _PARAMS:
        _PARAMS["vgg"] = ref_CN.convnet_init(jax.random.PRNGKey(0),
                                             ref_CN.VGG_TINY,
                                             dtype=jnp.float32)
    return _PARAMS["vgg"]


def _fc_leaves():
    """fp32 FC leaves of yi-9b SMOKE (layer stacks): wq (2, 64, 64), wk
    (2, 64, 32), gate (2, 64, 128), down (2, 128, 64)."""
    _, _, rp = _ref_lm()
    lay = rp["layers"]
    return {"wq": lay["attn"]["wq"]["w"], "wk": lay["attn"]["wk"]["w"],
            "gate": lay["ffn"]["gate"]["w"], "down": lay["ffn"]["down"]["w"]}


@pytest.mark.parametrize("mode", ["row", "col", "both"])
@pytest.mark.parametrize("leaf,block", [("wq", (16, 16)), ("wk", (32, 16)),
                                        ("gate", (64, 128)),
                                        ("down", (32, 64))])
def test_block_mask_matches_reference_bitwise(leaf, block, mode):
    """Row / column pruning inside (bp, bq) blocks at a rate and at a
    threshold (the leaf's median group sqnorm: a tie there is kept by
    ``>=`` in both packages)."""
    w = _fc_leaves()[leaf]
    wt = _t(w)
    for rate in (0.3, 0.6):
        np.testing.assert_array_equal(
            R.block_mask(wt, block, rate=rate, mode=mode).numpy(),
            np.asarray(ref_R.block_mask(w, block, rate=rate, mode=mode)))
    thr = float(np.median(np.asarray(w, np.float32) ** 2) * block[1])
    np.testing.assert_array_equal(
        R.block_mask(wt, block, threshold=thr, mode=mode).numpy(),
        np.asarray(ref_R.block_mask(w, block, threshold=thr, mode=mode)))


@pytest.mark.parametrize("leaf", ["wq", "down"])
def test_unstructured_and_structured_masks_match_reference_bitwise(leaf):
    w = _fc_leaves()[leaf]
    wt = _t(w)
    for rate in (0.25, 0.6):
        np.testing.assert_array_equal(
            R.unstructured_mask(wt, rate=rate).numpy(),
            np.asarray(ref_R.unstructured_mask(w, rate=rate)))
        for axis in ("row", "col"):
            np.testing.assert_array_equal(
                R.structured_mask(wt, rate=rate, axis=axis).numpy(),
                np.asarray(ref_R.structured_mask(w, rate=rate, axis=axis)))
    np.testing.assert_array_equal(
        R.unstructured_mask(wt, threshold=1e-3).numpy(),
        np.asarray(ref_R.unstructured_mask(w, threshold=1e-3)))


@pytest.mark.parametrize("scheme", ref_R.SCHEMES)
def test_make_mask_serves_every_scheme_as_reference(scheme):
    """The whole dispatch, on an FC leaf and (for the conv schemes) a
    VGG_TINY conv weight; none raises."""
    assert R.SCHEMES == ref_R.SCHEMES
    if scheme in ("pattern", "block_punched"):
        w = _ref_vgg()["c3"]["w"]
        kw = dict(block=(16, 16), rate=0.5, connectivity_rate=0.4)
    else:
        w = _fc_leaves()["gate"]
        kw = dict(block=(32, 64), rate=0.5)
    got = R.make_mask(_t(w), scheme, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_R.make_mask(w, scheme,
                                                             **kw)))
    assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
    assert R.density(got) == ref_R.density(jnp.asarray(got.numpy()))
    assert R.compression_rate(got) == ref_R.compression_rate(
        jnp.asarray(got.numpy()))
    with pytest.raises(ValueError):
        R.make_mask(_t(w), "diagonal")


def test_legal_blocks_match_reference():
    for P, Q in ((60, 60), (64, 32), (4096, 512), (11008, 4096), (27, 32),
                 (576, 64)):
        assert R.legal_blocks(P, Q) == ref_R.legal_blocks(P, Q)
    assert R.legal_blocks(60, 60) == [(4, 4)]      # phi3 SMOKE's block


# a prune spec of every scheme on yi-9b SMOKE's leaves
MIXED = [(r"attn/wq/w", "block", (16, 32), {}),
         (r"attn/wk/w", "block_row", (16, 16), {}),
         (r"attn/wv/w", "block_col", (16, 16), {"rate": 0.3}),
         (r"attn/wo/w", "structured_row", (16, 16), {}),
         (r"ffn/gate/w", "structured_col", (16, 16), {}),
         (r"ffn/up/w", "unstructured", (16, 16), {}),
         (r"ffn/down/w", "block", (32, 64), {}),
         (r"embed/table", "none", (16, 16), {})]


def test_masks_for_spec_default_rate_matches_reference_bitwise():
    _, _, rp = _ref_lm()
    pspec, rspec = _both_specs(MIXED)
    want = ref_to_numpy(ref_RW.masks_for_spec(rp, rspec, default_rate=0.5))
    got = RW.masks_for_spec(to_port(rp), pspec, default_rate=0.5)

    def walk(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        assert g.dtype == torch.float32, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    walk(got, want)
    assert got["layers"]["attn"]["wq"]["w"].ndim == 3
    assert got["embed"]["table"].ndim == 0


def test_group_sqnorms_and_global_threshold_match_reference():
    """Group sqnorms of every penalty scheme within 1e-6 (a float32 sum
    over a group runs in XLA's order or torch's); the global threshold
    within 1e-5 (each leaf's float32 mean over up to 16384 sqnorms, summed
    in either order, moves all its normalised norms together by a few
    1e-6); masks at a threshold bit-equal.  The reference's tau is a
    quantile of those normalised norms, so it lands ON one group, whose
    keep is then a coin flip on the mean's last bits: the masks are
    compared at the midpoint of the first gap above tau wider than 1e-4
    relative, where no group comes near a tie."""
    _, _, rp = _ref_lm()
    pp = to_port(rp)
    pspec, rspec = _both_specs(MIXED)
    for (path, pc), (_, rc) in zip(pspec, rspec):
        if pc.scheme == "none":
            continue
        name = path.split("/")[1]
        group = "attn" if name.startswith("w") else "ffn"
        w = rp["layers"][group][name]["w"]
        got = RW.group_sqnorms(_t(w), pc)
        want = ref_RW.group_sqnorms(w, rc)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0)
    punch = ref_RW.SchemeChoice("block_punched", (8, 8))
    cw = _ref_vgg()["c2"]["w"]
    np.testing.assert_allclose(
        RW.group_sqnorms(_t(cw), RW.SchemeChoice("block_punched", (8, 8)))[
            "punch"].numpy(), np.asarray(ref_RW.group_sqnorms(cw, punch)[
                "punch"]), rtol=1e-6)
    with pytest.raises(ValueError):
        RW.group_sqnorms(_t(cw), RW.SchemeChoice("pattern"))
    for rate in (0.3, 0.7):
        tau = ref_RW.global_threshold(rp, rspec, rate)
        assert RW.global_threshold(pp, pspec, rate) == pytest.approx(
            tau, rel=1e-5)
        rel = np.sort(np.concatenate([
            (np.asarray(sq) / np.asarray(sq).mean()).ravel()
            for _, leaf, c in ref_RW._iter_prunable(rp, rspec)
            for sq in ref_RW.group_sqnorms(leaf, c).values()]))
        rel = rel[rel >= tau]
        i = int(np.flatnonzero(rel[1:] > rel[:-1] * (1 + 1e-4))[0])
        mid = float((rel[i] + rel[i + 1]) / 2)
        want = ref_to_numpy(ref_RW.masks_for_spec(rp, rspec, threshold=mid))
        got = RW.masks_for_spec(pp, pspec, threshold=mid)
        for path, _, _ in ref_RW._iter_prunable(rp, rspec):
            keys = path.split("/")
            g, w = got, want
            for k in keys:
                g, w = g[k], w[k]
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    assert RW.global_threshold(pp, [], 0.5) == 0.0


def test_sparsity_report_matches_reference():
    _, _, rp = _ref_lm()
    pspec, rspec = _both_specs(MIXED)
    rmasks = ref_RW.masks_for_spec(rp, rspec, default_rate=0.5)
    got = RW.sparsity_report(to_port(rp), to_port(rmasks))
    want = ref_RW.sparsity_report(rp, rmasks)
    assert got == want
    assert 1.0 < got["__overall__"]["compression"] < 2.0


def test_random_block_masks_structure():
    """torch's draws, not the reference's: whole blocks only, the keep
    fraction within 3 sigma of ``keep_prob``, the same draws on a second
    call and in another process (crc32 keys, not ``hash()``), other draws
    for another path or seed; sentinels off the spec."""
    _, _, rp = _ref_lm()
    pp = to_port(rp)
    spec = [(r"(attn/w[qo]|ffn/(gate|up|down))/w",
             RW.SchemeChoice("block", (16, 16)))]
    a = RW.random_block_masks(pp, spec, (16, 16), keep_prob=0.4, seed=3)
    b = RW.random_block_masks(pp, spec, (16, 16), keep_prob=0.4, seed=3)
    c = RW.random_block_masks(pp, spec, (16, 16), keep_prob=0.4, seed=4)
    n_blocks, kept = 0, 0
    for name in ("gate", "up", "down"):
        m = a["layers"]["ffn"][name]["w"]
        assert torch.equal(m, b["layers"]["ffn"][name]["w"])
        grid = m.reshape(2, m.shape[1] // 16, 16, m.shape[2] // 16, 16)
        first = grid[:, :, :1, :, :1]
        assert bool((grid == first).all()), name       # whole blocks
        n_blocks += first.numel()
        kept += int(first.sum())
    assert not torch.equal(a["layers"]["ffn"]["gate"]["w"],
                           c["layers"]["ffn"]["gate"]["w"])
    assert not torch.equal(a["layers"]["ffn"]["gate"]["w"],
                           a["layers"]["ffn"]["up"]["w"])
    sigma = (0.4 * 0.6 / n_blocks) ** 0.5
    assert abs(kept / n_blocks - 0.4) <= 3 * sigma
    assert a["layers"]["attn"]["wk"]["w"].ndim == 0
    assert a["embed"]["table"].ndim == 0
    code = ("import torch\n"
            "from repro_torch.core import reweighted as RW\n"
            "t = {'a': {'w': torch.zeros(2, 64, 128)}}\n"
            "m = RW.random_block_masks(t, [('a/w', RW.SchemeChoice("
            "'block', (16, 16)))], (16, 16), keep_prob=0.4, seed=3)\n"
            "print(''.join(str(int(v)) for v in m['a']['w'][:, ::16, "
            "::16].flatten().tolist()))\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"),
               PYTHONHASHSEED="123")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    here = RW.random_block_masks({"a": {"w": torch.zeros(2, 64, 128)}},
                                 [("a/w", RW.SchemeChoice("block",
                                                          (16, 16)))],
                                 (16, 16), keep_prob=0.4, seed=3)
    assert out == "".join(str(int(v)) for v in here["a"]["w"][
        :, ::16, ::16].flatten().tolist())


# -- the served composition at SMOKE: map_rules -> masks -> compile_model -----

def _rows(rep):
    """A compile report's rows as a set (the reference lists layers in
    sorted-key order, the port in insertion order)."""
    return {(r.path, r.packed, r.kind, r.scheme, r.reason, r.block, r.L,
             r.L_reordered, r.value_dtype) for r in rep}


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b", "granite-8b"])
def test_served_lm_mapping_matches_reference(arch):
    """``map_rules`` at 128 tokens (dataset_hard, compression 2.5) ->
    ``magnitude_block_masks(spec, None, 0.6)`` (each rule at its own block)
    -> ``compile_model(keep_dense=False)``, each layer quantized as picked,
    in both packages: the same masks, the report rows as sets, every
    layout leaf for leaf (int8 scales too), fp32 logits within the LM
    bound and identical greedy tokens.  The picks tile the SMOKE dims (no
    snapping): wq / wo pack at (32, 64) int8; the FFN's picks leave one
    block column, so those skip for no saving, in both."""
    rcfg, pcfg, rp = _ref_lm(arch)
    spec, report = MR.map_rules(MR.lm_layers(pcfg, 128), dataset_hard=True,
                                compression=2.5)
    rspec, rreport = ref_MR.map_rules(ref_MR.lm_layers(rcfg, 128),
                                      dataset_hard=True, compression=2.5)
    assert _spec_eq(spec, rspec) and report == rreport
    rmasks = ref_RW.magnitude_block_masks(rp, rspec, None, rate=0.6)
    masks = RW.magnitude_block_masks(to_port(rp), spec, None, rate=0.6)
    np.testing.assert_array_equal(
        masks["layers"]["attn"]["wq"]["w"].numpy(),
        np.asarray(rmasks["layers"]["attn"]["wq"]["w"]))
    rpm = ref_apply_masks(rp, rmasks)
    rexec, rrep = ref_compile.compile_model(
        rpm, rmasks, rspec, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(
        apply_masks(to_port(rp), masks), masks, spec,
        spec=C.CompileSpec(keep_dense=False), device="cpu")
    assert _rows(prep) == _rows(rrep)
    got, want = packed_nodes(pexec), packed_nodes(rexec)
    assert sorted(got) == sorted(want) == ["layers/attn/wo",
                                           "layers/attn/wq"]
    for path, lay in got.items():
        assert (lay.block, lay.value_dtype) == ((32, 64), "int8")
        assert_layout_equal(lay, want[path])
    assert {r.value_dtype for r in prep.packed} == {"int8"}
    tokens = np.random.RandomState(1).randint(0, rcfg.vocab, size=(2, 8))
    want_logits, _ = ref_T.forward(rexec, rcfg, jnp.asarray(tokens))
    got_logits = T.forward(pexec, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=LM_RTOL, atol=LM_ATOL)
    want_tok = np.asarray(ref_engine.generate(rexec, rcfg,
                                              jnp.asarray(tokens), 6))
    got_tok = engine.generate(pexec, pcfg, tokens, 6, device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def _dense_of(lay, w):
    """The (P, Q, kh, kw) weight a conv layout holds (int8 values
    dequantized), from its im2col-lowered (kh*kw*Q, P) form."""
    P, Q, kh, kw = w.shape
    return lay.to_dense().reshape(kh, kw, Q, P).permute(3, 2, 0, 1).numpy()


def _vgg_masks(RWmod, params, spec, rate=0.5):
    """The masks the reference's serving callers build for a mapped
    VGG_TINY (as ``chip_smoke.py`` builds them): pattern rules through
    ``masks_for_spec``, block-punched rules through ``punched_conv_masks``
    at each rule's own block; other layers unpruned."""
    pat = RWmod.masks_for_spec(params, [r for r in spec
                                        if r[1].scheme == "pattern"])
    pun = RWmod.punched_conv_masks(
        params, [r for r in spec if r[1].scheme == "block_punched"], None,
        rate=rate)
    return {name: {k: (pat[name][k] if pat[name][k].ndim
                       else pun[name][k]) for k in node}
            for name, node in params.items()}


@pytest.mark.parametrize("hard", [True, False])
def test_served_vgg_mapping_matches_reference(hard):
    """VGG_TINY under ``map_rules``' picks (compression 2, V5E): the same
    masks, report rows, layouts leaf for leaf (taps per filter, int8 on
    c1 under dataset_hard; c3 at GEMM block (64, 32) and c6 at (128, 128)
    int8 otherwise), and the packed port net's logits within 1e-5 of the
    reference's masked-dense net on the dequantized weights (its plain
    XLA convs; the layouts already pin its packed ones)."""
    specs = _conv_specs(CN.VGG_TINY, 32)
    spec, _ = MR.map_rules(MR.conv_layers(specs), dataset_hard=hard,
                           compression=2.0)
    rspec, _ = ref_MR.map_rules(ref_MR.conv_layers(specs),
                                dataset_hard=hard, compression=2.0)
    rp = _ref_vgg()
    rmasks = _vgg_masks(ref_RW, rp, rspec)
    masks = _vgg_masks(RW, to_port(rp), spec)
    for name, node in masks.items():
        np.testing.assert_array_equal(node["w"].numpy(),
                                      np.asarray(rmasks[name]["w"]))
    rpm = ref_apply_masks(rp, rmasks)
    rexec, rrep = ref_compile.compile_model(
        rpm, rmasks, rspec, spec=ref_compile.CompileSpec(keep_dense=False))
    pexec, prep = C.compile_model(
        apply_masks(to_port(rp), masks), masks, spec,
        spec=C.CompileSpec(keep_dense=False), device="cpu")
    assert _rows(prep) == _rows(rrep)
    got, want = packed_nodes(pexec), packed_nodes(rexec)
    assert sorted(got) == sorted(want)
    if hard:
        assert sorted(got) == ["c1", "c2", "c3", "c4", "c6"]
        assert [got[n].scales is not None for n in sorted(got)] == [
            True, False, False, False, False]
        for path, lay in got.items():
            assert_tap_layout_equal(lay, want[path])
    else:
        assert {n: (lay.block, lay.scales is not None)
                for n, lay in got.items()} == {"c3": ((64, 32), False),
                                               "c6": ((128, 128), True)}
        for path, lay in got.items():
            assert_layout_equal(lay, want[path])
    deq = {n: dict(node, w=jnp.asarray(_dense_of(got[n], node["w"])))
           if n in got else node for n, node in rpm.items()}
    x = _np(14, 2, 16, 16, 3)
    want_logits = np.asarray(ref_CN.convnet_apply(deq, jnp.asarray(x),
                                                  ref_CN.VGG_TINY))
    got_logits = CN.convnet_apply(pexec, _t(x), CN.VGG_TINY)
    np.testing.assert_allclose(got_logits.numpy(), want_logits,
                               rtol=CONV_TOL, atol=CONV_TOL)


# -- faults of the reference, pinned (ROADMAP queue 3) ------------------------

@pytest.mark.parametrize("case", ["yi-9b head/table", "VGG_TINY c5"])
def test_reference_masks_for_spec_raises_on_the_unfiltered_mapping(case):
    """``masks_for_spec`` on ``map_rules``' whole spec asserts in the
    reference: the head/table rule prices the GEMM as (D, vocab) with
    block (64, 128) while the leaf is stored (vocab, D) = (256, 64); VGG
    c5 gets an FC ``block`` (64, 128) on a (128, 128, 1, 1) weight, whose
    last two dims (1, 1) it cannot tile.  The port raises the same class.
    The served paths build their masks from the rules they pack."""
    if case.startswith("yi"):
        rcfg, pcfg, rp = _ref_lm()
        pspec, _ = MR.map_rules(MR.lm_layers(pcfg, 128), dataset_hard=True,
                                compression=2.5)
        rspec, _ = ref_MR.map_rules(ref_MR.lm_layers(rcfg, 128),
                                    dataset_hard=True, compression=2.5)
        alone = "head/table"
    else:
        rp = _ref_vgg()
        specs = _conv_specs(CN.VGG_TINY, 32)
        pspec, _ = MR.map_rules(MR.conv_layers(specs), dataset_hard=True,
                                compression=2.0)
        rspec, _ = ref_MR.map_rules(ref_MR.conv_layers(specs),
                                    dataset_hard=True, compression=2.0)
        alone = "c5"
    pp = to_port(rp)
    with pytest.raises(AssertionError):
        ref_RW.masks_for_spec(rp, rspec, default_rate=0.5)
    with pytest.raises(AssertionError):
        RW.masks_for_spec(pp, pspec, default_rate=0.5)
    # that one rule alone raises; the spec without it does not
    with pytest.raises(AssertionError):
        ref_RW.masks_for_spec(rp, [r for r in rspec if r[0] == alone],
                              default_rate=0.5)
    with pytest.raises(AssertionError):
        RW.masks_for_spec(pp, [r for r in pspec if r[0] == alone],
                          default_rate=0.5)
    ref_RW.masks_for_spec(rp, [r for r in rspec if r[0] != alone],
                          default_rate=0.5)
    RW.masks_for_spec(pp, [r for r in pspec if r[0] != alone],
                      default_rate=0.5)


def test_reference_one_shot_of_a_block_mapping_packs_nothing():
    """``pruner.one_shot(params, spec, 0.6)`` is ``masks_for_spec`` at a
    default rate: the paper's "block" scheme prunes rows and columns
    INSIDE each block, so no whole block dies and ``compile_model`` skips
    every layer for no saving.  The port (whose one-shot pruner comes with
    training) gives the same masks and the same skips; the served path
    takes whole-block masks (``magnitude_block_masks``) instead."""
    rcfg, pcfg, rp = _ref_lm()
    pspec, _ = MR.map_rules(MR.lm_layers(pcfg, 128), dataset_hard=True,
                            compression=2.5)
    rspec, _ = ref_MR.map_rules(ref_MR.lm_layers(rcfg, 128),
                                dataset_hard=True, compression=2.5)
    served = [r for r in pspec if r[0] not in ("head/table", "embed/table")]
    rserved = [r for r in rspec if r[0] not in ("head/table",
                                                "embed/table")]
    rmasks = ref_pruner.one_shot(rp, rserved, 0.6)
    masks = RW.masks_for_spec(to_port(rp), served, default_rate=0.6)
    np.testing.assert_array_equal(
        masks["layers"]["attn"]["wq"]["w"].numpy(),
        np.asarray(rmasks["layers"]["attn"]["wq"]["w"]))
    _, rrep = ref_compile.compile_model(ref_apply_masks(rp, rmasks), rmasks,
                                        rserved)
    _, prep = C.compile_model(apply_masks(to_port(rp), masks), masks, served,
                              device="cpu")
    assert not rrep.packed and not prep.packed
    assert _rows(prep) == _rows(rrep)
    reasons = {r.reason for r in prep.rows}
    assert any(s.startswith("no effective saving") for s in reasons)
    # the whole-block masks of the same mapping do pack
    wb = RW.magnitude_block_masks(to_port(rp), served, None, rate=0.6)
    _, wrep = C.compile_model(apply_masks(to_port(rp), wb), wb, served,
                              device="cpu")
    assert {r.path for r in wrep.packed} == {"layers/attn/wq/w",
                                             "layers/attn/wo/w"}


def test_reference_conv_picks_in_gemm_coordinates_leave_layers_unpruned():
    """The mapper's conv picks are (K = Cin*kh*kw, N = Cout) blocks of the
    lowered GEMM; ``punched_conv_masks(block=None)`` and
    ``block_punched_mask`` read a rule's block as (filters, channels).
    Under dataset_hard=False that leaves c1 (27, 32), c2 (32, 64) and c4
    (64, 128) unpruned in both packages, while c3 and c6 are punched (c3's
    (32, 64) read as 32 filters x 64 channels, GEMM block (64, 32))."""
    specs = _conv_specs(CN.VGG_TINY, 32)
    spec, _ = MR.map_rules(MR.conv_layers(specs), dataset_hard=False,
                           compression=2.0)
    rspec, _ = ref_MR.map_rules(ref_MR.conv_layers(specs),
                                dataset_hard=False, compression=2.0)
    punched = [r for r in spec if r[1].scheme == "block_punched"]
    rpunched = [r for r in rspec if r[1].scheme == "block_punched"]
    rp = _ref_vgg()
    got = RW.punched_conv_masks(to_port(rp), punched, None, rate=0.5)
    want = ref_RW.punched_conv_masks(rp, rpunched, None, rate=0.5)
    unpruned = [n for n in ("c1", "c2", "c3", "c4", "c5", "c6")
                if got[n]["w"].ndim == 0]
    assert unpruned == [n for n in ("c1", "c2", "c3", "c4", "c5", "c6")
                        if np.asarray(want[n]["w"]).ndim == 0]
    assert unpruned == ["c1", "c2", "c4", "c5"]
    for n in ("c3", "c6"):
        np.testing.assert_array_equal(got[n]["w"].numpy(),
                                      np.asarray(want[n]["w"]))
