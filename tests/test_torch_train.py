"""The port's prune-and-train pipeline against the reference, on the CPU
at SMOKE sizes, fp32 unless stated: the losses (``cross_entropy``,
``classify_loss``), the training forward's logits and MoE aux, the
reweighted penalty (alphas and ``penalty`` for every scheme), the loss
and its gradients at four families, the optimizers on identical grads,
whole train steps, ``reweighted_prune``'s masks and reports, the
synthetic data, the train CLI, and the quickstart pipeline through
``compile_model``.  Inputs come from numpy seeds (torch cannot draw
JAX's PRNG) and cross as numpy; the reference runs as its own tests run
it (jitted train steps on the CPU)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import pruner as ref_pruner  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.core.mapper_rule import lm_layers as ref_lm_layers  # noqa: E402
from repro.core.mapper_rule import map_rules as ref_map_rules  # noqa: E402
from repro.data import pipeline as ref_data  # noqa: E402
from repro.models import convnet as ref_CN  # noqa: E402
from repro.models import layers as ref_L  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.optim import adamw as ref_opt  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import pruner  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.distributed.elastic import StragglerMonitor  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as opt  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

from test_torch_reference import packed_nodes, ref_to_numpy, to_port  # noqa: E402,E501

LOSS_TOL = 1e-6          # fp32 losses, logits, aux, alphas, penalty (rel)
GRAD_TOL = 1e-5          # of each leaf's max |g|
# the SSD decay parameter's grads sum every (batch, position, head, state)
# term of the scan and cancel: at hymba SMOKE both packages' fp32 A_log
# grads sit 1.3e-5 / 1.4e-5 of max |g| from a float64 run of the port's
# code (every other leaf within 3e-6), so the two are held to the sum
A_LOG_TOL = 3e-5
OPT_TOL = 1e-6           # optimizer outputs on identical grads
STEP_LOSS_TOL = 1e-4     # losses of whole train steps
FC_RE = r"(attn/w[qkvo]|(ffn|moe)/(gate|up|down))/w"
# every penalised leaf at a block that tiles SMOKE widths: (8, 16) on the
# attention and FFN / expert projections and the head, (16, 8) on the SSM
# mixers' in/out_proj (mamba2's in_proj has 296 = 37 x 8 columns)
RULES = [(FC_RE, "block", (8, 16)), (r"ssm/(in|out)_proj/w", "block", (16, 8)),
         (r"head/table", "block", (8, 16))]
ARCHS = ("yi-9b", "mixtral-8x7b", "mamba2-1.3b", "hymba-1.5b")


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _specs(rules):
    """(port spec, reference spec) of [(path, scheme, block)]."""
    return ([(p, RW.SchemeChoice(s, b)) for p, s, b in rules],
            [(p, ref_RW.SchemeChoice(s, b)) for p, s, b in rules])


def _flat(tree, path=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _assert_tree_close(port, ref, rtol, atol=0.0):
    p, r = _flat(port), _flat(ref_to_numpy(ref))
    assert set(p) == set(r)
    for k in r:
        np.testing.assert_allclose(p[k].detach().float().numpy(),
                                   np.asarray(r[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _lm(arch):
    """(reference cfg, port cfg, reference fp32 params) at SMOKE."""
    rcfg = ref_configs.get(arch, smoke=True)
    return rcfg, configs.get(arch, smoke=True), ref_module.cast_tree(
        ref_T.init_lm(jax.random.PRNGKey(0), rcfg), jnp.float32)


def _batch(cfg, B=2, S=16, step=0):
    """The reference's synthetic batch, as numpy."""
    b = ref_data.synthetic_batch(0, step, B, S, cfg.vocab)
    return {k: np.asarray(v) for k, v in b.items()}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# -- losses and the training forward -----------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_reference(with_mask):
    logits = _np(0, 3, 7, 50, scale=3.0)
    labels = np.random.RandomState(1).randint(0, 50, (3, 7))
    mask = (np.random.RandomState(2).rand(3, 7) < 0.6).astype(np.float32) \
        if with_mask else None
    want = ref_L.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = L.cross_entropy(_t(logits), _t(labels),
                          None if mask is None else _t(mask))
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)


def test_classify_loss_matches_reference_on_vgg_tiny():
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(0), ref_CN.VGG_TINY,
                                  dtype=jnp.float32)
    x = _np(3, 4, 16, 16, 3)
    y = np.random.RandomState(4).randint(0, 10, (4,))
    want = jax.jit(ref_CN.classify_loss)(rparams,
                                         (jnp.asarray(x), jnp.asarray(y)))
    got = CN.classify_loss(to_port(rparams), (_t(x), _t(y)))
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)


def test_training_forward_logits_and_aux_match_reference():
    """mixtral SMOKE: the logits and the MoE aux summed over both layers;
    ``forward`` (serving) returns the same logits."""
    rcfg, pcfg, rp = _lm("mixtral-8x7b")
    tokens = _batch(rcfg)["tokens"]
    want, want_aux = jax.jit(ref_T.forward, static_argnums=1)(
        rp, rcfg, jnp.asarray(tokens))
    got, aux = T.forward_aux(to_port(rp), pcfg, torch.from_numpy(tokens))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOSS_TOL * scale)
    assert float(aux) == pytest.approx(float(want_aux), rel=LOSS_TOL)
    assert float(aux) > 0
    assert torch.equal(T.forward(to_port(rp), pcfg, torch.from_numpy(tokens)),
                       got)
    _, dense_aux = T.forward_aux(to_port(_lm("yi-9b")[2]), _lm("yi-9b")[1],
                                 torch.from_numpy(tokens))
    assert float(dense_aux) == 0.0


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
def test_remat_full_equals_none_bitwise(arch):
    """Layers checkpointed (run again in the backward pass) give the same
    loss and grads, bit for bit."""
    _, pcfg, rp = _lm(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    outs = []
    for remat in ("none", "full"):
        f = trainer.value_and_grad(trainer.make_loss_fn(
            pcfg.replace(remat=remat)))
        outs.append(f(to_port(rp), batch))
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert torch.equal(l0, l1)
    for k, v in _flat(g0).items():
        assert torch.equal(v, _flat(g1)[k]), k


def test_training_forward_refuses_unported_families():
    """A family neither package defines: ``forward`` raises ValueError in
    both, as the reference's does (every family it defines is ported)."""
    tokens = np.zeros((1, 4), np.int32)
    rcfg, pcfg, rp = _lm("yi-9b")
    with pytest.raises(ValueError, match="foo"):
        ref_T.forward(rp, rcfg.replace(family="foo"), jnp.asarray(tokens))
    with pytest.raises(ValueError, match="foo"):
        T.forward_aux(to_port(rp), pcfg.replace(family="foo"),
                      torch.from_numpy(tokens))
    assert set(T.FAMILIES) == {"dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"}


# -- the reweighted penalty --------------------------------------------------

SCHEMES = [("unstructured", (8, 16)), ("structured_row", (8, 16)),
           ("structured_col", (8, 16)), ("block", (8, 16)),
           ("block_row", (16, 8)), ("block_col", (8, 8)),
           ("block_punched", (4, 4))]


def _scheme_tree():
    """fp32 leaves for every scheme: a layer stack (2, 32, 48), a plain
    (48, 32) matrix, a (8, 16, 3, 3) conv kernel, a vector and a table
    no rule matches."""
    return {"stack": {"w": _np(10, 2, 32, 48)}, "fc": {"w": _np(11, 48, 32)},
            "conv": {"w": _np(12, 8, 16, 3, 3)}, "bias": _np(13, 32),
            "other": {"w": _np(14, 16, 16)}}


@pytest.mark.parametrize("scheme,block", SCHEMES)
def test_alphas_and_penalty_match_reference(scheme, block):
    tree = _scheme_tree()
    paths = (r"conv/w",) if scheme == "block_punched" else \
        (r"stack/w", r"fc/w", r"bias")
    pspec, rspec = _specs([(p, scheme, block) for p in paths])
    rcfg = ref_RW.ReweightedConfig(spec=tuple(rspec), lam=1e-3)
    pcfg = RW.ReweightedConfig(spec=tuple(pspec), lam=1e-3)
    rtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ptree = to_port(tree)
    ones = RW.init_alphas(ptree, pspec)
    _assert_tree_close(ones, ref_RW.init_alphas(rtree, rspec), rtol=0)
    ralphas = ref_RW.update_alphas(rtree, rcfg)
    palphas = RW.update_alphas(ptree, pcfg)
    assert set(palphas) == set(ralphas)
    _assert_tree_close(palphas, ralphas, rtol=LOSS_TOL)
    for alphas, want_alphas in ((ones, ref_RW.init_alphas(rtree, rspec)),
                                (palphas, ralphas)):
        want = ref_RW.penalty(rtree, want_alphas, rcfg)
        got = RW.penalty(ptree, alphas, pcfg)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    # a leaf without alphas adds nothing
    some = {k: v for k, v in palphas.items() if k != next(iter(palphas))}
    want = ref_RW.penalty(rtree, {k: ralphas[k] for k in some}, rcfg)
    assert float(RW.penalty(ptree, some, pcfg)) == pytest.approx(
        float(want), rel=LOSS_TOL)


def test_global_threshold_on_smoke_params_matches_reference():
    """The quantile over every penalised group of yi-9b and mixtral SMOKE
    equals the reference's (within each leaf's fp32 mean's sum order)."""
    for arch, rates in (("yi-9b", (0.25, 0.6)), ("mixtral-8x7b", (0.6,))):
        _, _, rp = _lm(arch)
        pspec, rspec = _specs(RULES)
        pp = to_port(rp)
        for rate in rates:
            tau = RW.global_threshold(pp, pspec, rate)
            assert tau == pytest.approx(
                ref_RW.global_threshold(rp, rspec, rate), rel=1e-5)


# -- the loss and its gradients ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _masks_and_alphas(arch):
    """Masks at rate 0.5 and alphas from the SMOKE params, as numpy: made
    by the port (``masks_for_spec`` is bit-equal to the reference's,
    ``update_alphas`` held to it above) and fed to both packages."""
    pp = to_port(_lm(arch)[2])
    pspec = _specs(RULES)[0]
    return (_to_np(RW.masks_for_spec(pp, pspec, default_rate=0.5)),
            _to_np(RW.update_alphas(pp, RW.ReweightedConfig(
                spec=tuple(pspec)))))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch):
    """{"masks" | "alphas": ((total, ce), grads)} of the reference's loss
    at ``arch`` SMOKE, both under one jit."""
    rcfg, _, rp = _lm(arch)
    masks, alphas = _masks_and_alphas(arch)
    vg = jax.value_and_grad(ref_trainer.make_loss_fn(
        rcfg, reweighted=ref_RW.ReweightedConfig(
            spec=tuple(_specs(RULES)[1]), lam=1e-3)), has_aux=True)
    out = jax.jit(lambda p, b, m, a: {"masks": vg(p, b, m, None),
                                      "alphas": vg(p, b, None, a)})(
        rp, _both(_batch(rcfg))[0], _jnp(masks), _jnp(alphas))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_", ["masks", "alphas"])
def test_loss_and_grads_match_reference(arch, with_):
    """``make_loss_fn`` under autograd against ``jax.value_and_grad`` of
    the reference's: loss within 1e-6 relative, every leaf's grads within
    1e-5 of its max |g| (A_log: A_LOG_TOL); with masks, the pruned
    entries' grads exactly 0 (the penalty, on the unmasked params, runs
    with alphas)."""
    rcfg, pcfg, rp = _lm(arch)
    masks, alphas = _masks_and_alphas(arch)
    args = (to_port(masks), None) if with_ == "masks" else \
        (None, to_port(alphas))
    (want, want_ce), want_g = _ref_loss_and_grads(arch)[with_]
    (got, got_ce), got_g = trainer.value_and_grad(trainer.make_loss_fn(
        pcfg, reweighted=RW.ReweightedConfig(spec=tuple(_specs(RULES)[0]),
                                             lam=1e-3)))(
        to_port(rp), _both(_batch(rcfg))[1], *args)
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    assert float(got_ce) == pytest.approx(float(want_ce), rel=LOSS_TOL)
    if with_ == "alphas":
        assert float(got) > float(got_ce) + 1.0     # the penalty is in
    g, w = _flat(got_g), _flat(want_g)
    assert set(g) == set(w)
    for k in w:
        gk, wk = g[k].numpy(), np.asarray(w[k])
        tol = A_LOG_TOL if k.endswith("ssm/A_log") else GRAD_TOL
        np.testing.assert_allclose(gk, wk, rtol=0,
                                   atol=tol * max(np.abs(wk).max(), 1e-30),
                                   err_msg=k)
    if with_ == "masks":
        m = _flat(masks)
        pruned = [k for k in m if m[k].ndim and (m[k] == 0).any()]
        assert pruned
        for k in pruned:
            assert (g[k].numpy()[m[k] == 0] == 0).all(), k


# -- the optimizers on identical grads ---------------------------------------

def test_cosine_schedule_is_bit_equal():
    for lr in (3e-3, 3e-4):
        for step in (0, 50, 99, 100, 5000, 10000):
            want = np.asarray(ref_opt.cosine_schedule(step, lr))
            got = opt.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                      lr)
            assert got.dtype == torch.float32
            assert got.numpy().view(np.int32) == want.view(np.int32), (lr,
                                                                      step)


def _opt_tree(seed, dtype=np.float32):
    """A stacked (2, 8, 12) leaf, a (12, 6) matrix and a vector."""
    return {"s": {"w": _np(seed, 2, 8, 12).astype(dtype)},
            "m": {"w": _np(seed + 1, 12, 6).astype(dtype)},
            "b": _np(seed + 2, 6).astype(dtype)}


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = jax.tree_util.tree_map(lambda a: a * scale, _opt_tree(20))
    want, want_n = ref_opt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g))
    got, got_n = opt.clip_by_global_norm(to_port(g))
    assert float(got_n) == pytest.approx(float(want_n), rel=OPT_TOL)
    _assert_tree_close(got, want, rtol=OPT_TOL, atol=OPT_TOL)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_steps_on_identical_grads_match_reference(kind):
    """Three steps fed the same numpy grads: params and state to 1e-6."""
    r_init, r_upd = ref_opt.make_optimizer(kind)
    p_init, p_upd = opt.make_optimizer(kind)
    params = _opt_tree(30)
    rp, pp = jax.tree_util.tree_map(jnp.asarray, params), to_port(params)
    rs, ps = r_init(rp), p_init(pp)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda a: a * 0.1, _opt_tree(40 + i))
        lr = 1e-2 / (i + 1)
        rp, rs = r_upd(jax.tree_util.tree_map(jnp.asarray, g), rs, rp, lr)
        pp, ps = p_upd(to_port(g), ps, pp, lr)
        _assert_tree_close(pp, rp, rtol=OPT_TOL, atol=OPT_TOL)
        state = {k: v for k, v in ps.items() if k != "step"}
        _assert_tree_close(state, {k: v for k, v in rs.items()
                                   if k != "step"}, rtol=OPT_TOL,
                           atol=OPT_TOL)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
    with pytest.raises(ValueError):
        opt.make_optimizer("sgd")


def test_optimizer_keeps_each_param_dtype():
    pp = to_port(_opt_tree(50))
    pp["m"]["w"] = pp["m"]["w"].to(torch.bfloat16)
    for kind in ("adamw", "adafactor"):
        init, upd = opt.make_optimizer(kind)
        new, _ = upd(pp, init(pp), pp, 1e-3)
        assert new["m"]["w"].dtype == torch.bfloat16
        assert new["b"].dtype == torch.float32


# -- whole train steps -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(grad_accum):
    """The reference's jitted yi-9b SMOKE train step (lr 3e-3, RULES'
    penalty at lam 1e-3)."""
    init, step = ref_trainer.make_train_step(
        _lm("yi-9b")[0], lr=3e-3, reweighted=ref_RW.ReweightedConfig(
            spec=tuple(_specs(RULES)[1]), lam=1e-3), grad_accum=grad_accum)
    return init, jax.jit(step)


@pytest.mark.parametrize("grad_accum,with_", [(1, "alphas"), (2, "masks")])
def test_train_steps_match_reference(grad_accum, with_):
    """Three steps of yi-9b SMOKE on the reference's batches (B = 4,
    S = 16): each step's loss within 1e-4; the optimizer's step count."""
    rcfg, pcfg, rp = _lm("yi-9b")
    masks, alphas = _masks_and_alphas("yi-9b")
    r_init, r_step = _ref_step(grad_accum)
    p_init, p_step = trainer.make_train_step(
        pcfg, lr=3e-3, reweighted=RW.ReweightedConfig(
            spec=tuple(_specs(RULES)[0]), lam=1e-3), grad_accum=grad_accum)
    pp = to_port(rp)
    rs, ps = r_init(rp), p_init(pp)
    r_args = (_jnp(masks), None) if with_ == "masks" else \
        (None, _jnp(alphas))
    p_args = (to_port(masks), None) if with_ == "masks" else \
        (None, to_port(alphas))
    for step in range(3):
        rb, pb = _both(_batch(rcfg, B=4, step=step))
        rp, rs, rm = r_step(rp, rs, rb, *r_args)
        pp, ps, pm = p_step(pp, ps, pb, *p_args)
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  abs=STEP_LOSS_TOL)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    assert int(ps["step"]) == 3


# -- reweighted_prune --------------------------------------------------------

def _stub_update(params, k):
    """The stub's deterministic numpy step: every leaf shrinks by a
    step-dependent factor and a ripple of its own values."""
    return {key: (_stub_update(v, k) if isinstance(v, dict) else
                  (v * (1 - 0.02 * (1 + k % 3))
                   + 0.01 * np.cos(v * (k + 1))).astype(np.float32))
            for key, v in params.items()}


def _stub(to_np, from_np, log):
    """A train step shared by both packages: the numpy update above, the
    alphas' per-leaf sums and whether masks came, logged.  opt_state is
    the step count."""
    def step_fn(params, opt_state, batch, masks, alphas):
        log.append((masks is not None, None if alphas is None else
                    {p: {k: float(np.asarray(v, np.float64).sum())
                         for k, v in a.items()} for p, a in
                     alphas.items()}))
        return (from_np(_stub_update(to_np(params), opt_state)),
                opt_state + 1, {"loss": np.float32(opt_state)})
    return step_fn


def _rel_norms(rp, rspec):
    return np.sort(np.concatenate([
        (np.asarray(sq) / (np.asarray(sq).mean() + 1e-30)).ravel()
        for _, leaf, c in ref_RW._iter_prunable(rp, rspec)
        for sq in ref_RW.group_sqnorms(leaf, c).values()]))


def test_reweighted_prune_with_a_shared_stub_matches_reference():
    """The schedule (alphas re-estimated at steps 3 and 6, the threshold
    after 8 steps, 3 fine-tune steps with the masks), the masks leaf for
    leaf and the report equal.  The target rate puts tau midway in the
    widest gap of the normalised norms between 55 % and 65 %, so no
    group sits at the threshold (each package sums a leaf's mean in its
    own order, a few 1e-7 apart)."""
    _, _, rp = _lm("yi-9b")
    pspec, rspec = _specs(RULES)
    np_params = ref_to_numpy(rp)
    at_threshold = np_params
    for k in range(8):
        at_threshold = _stub_update(at_threshold, k)
    rel = _rel_norms(jax.tree_util.tree_map(jnp.asarray, at_threshold),
                     rspec)
    n = rel.size
    lo = int(0.55 * n)
    i = lo + int(np.argmax(rel[lo + 1:int(0.65 * n) + 1]
                           / rel[lo:int(0.65 * n)]))
    assert rel[i + 1] > rel[i] * (1 + 1e-5)
    rate = (i + 0.5) / (n - 1)
    kw = dict(lam=1e-3, steps=8, reweight_every=3, target_rate=rate,
              finetune_steps=3)
    rlog, plog = [], []
    rres = ref_pruner.reweighted_prune(
        jax.tree_util.tree_map(jnp.asarray, np_params), 0, rspec,
        _stub(ref_to_numpy, lambda t: jax.tree_util.tree_map(jnp.asarray, t),
              rlog), lambda s: None, **kw)
    pres = pruner.reweighted_prune(
        to_port(np_params), 0, pspec,
        _stub(_to_np, to_port, plog), lambda s: None, **kw)
    assert [m for m, _ in plog] == [m for m, _ in rlog] == \
        [False] * 8 + [True] * 3
    for (_, pa), (_, ra) in zip(plog, rlog):
        assert (pa is None) == (ra is None)
        if pa is not None:
            assert pa.keys() == ra.keys()
            for p in ra:
                for k in ra[p]:
                    assert pa[p][k] == pytest.approx(ra[p][k], rel=1e-5)
    pm, rm = _flat(pres.masks), _flat(ref_to_numpy(rres.masks))
    assert pm.keys() == rm.keys()
    for k in rm:
        np.testing.assert_array_equal(pm[k].numpy(), rm[k], err_msg=k)
    assert pres.report.keys() == rres.report.keys()
    for k, v in rres.report.items():
        assert pres.report[k] == pytest.approx(v, rel=1e-12), k
    _assert_tree_close(pres.params, rres.params, rtol=1e-6, atol=1e-7)


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.numpy()


@functools.lru_cache(maxsize=None)
def _quickstart():
    """examples/quickstart.py's pipeline in both packages, shortened to
    6 reweighted + 3 fine-tune steps: yi-9b SMOKE (fp32), ``map_rules``
    at 512 tokens and compression 4, pruned blocks snapped to (8, 16),
    lam 2e-3, lr 3e-3, target rate 0.5, the reference's batches (B = 8,
    S = 32).  Returns the specs, both results and each package's params
    at the threshold (those of the first step given masks)."""
    rcfg, pcfg, rp = _lm("yi-9b")
    spec_r, _ = ref_map_rules(ref_lm_layers(rcfg, tokens=512),
                              dataset_hard=False, compression=4.0)
    spec_r = [(p, ref_RW.SchemeChoice(c.scheme, (8, 16))
               if c.scheme != "none" else c) for p, c in spec_r]
    spec_p = train_cli.snapped_spec(pcfg, 512, 0.75)
    init_r, step_r = ref_trainer.make_train_step(
        rcfg, lr=3e-3, reweighted=ref_RW.ReweightedConfig(
            spec=tuple(spec_r), lam=2e-3))
    init_p, step_p = trainer.make_train_step(
        pcfg, lr=3e-3, reweighted=RW.ReweightedConfig(spec=tuple(spec_p),
                                                      lam=2e-3))
    seen = {}

    def capture(name, step_fn):
        def f(params, state, batch, masks, alphas):
            if masks is not None and name not in seen:
                seen[name] = params
            return step_fn(params, state, batch, masks, alphas)
        return f
    batches = [_batch(rcfg, B=8, S=32, step=s) for s in range(9)]
    kw = dict(lam=2e-3, steps=6, reweight_every=3, target_rate=0.5,
              finetune_steps=3)
    rres = ref_pruner.reweighted_prune(
        rp, init_r(rp), spec_r, capture("ref", jax.jit(step_r)),
        lambda s: _both(batches[s])[0], **kw)
    pp = to_port(rp)
    pres = pruner.reweighted_prune(
        pp, init_p(pp), spec_p, capture("port", step_p),
        lambda s: _both(batches[s])[1], **kw)
    return dict(spec_p=spec_p, spec_r=spec_r, pres=pres, rres=rres,
                p_at=seen["port"], r_at=seen["ref"], prompts=batches[0][
                    "tokens"][:2])


def test_reweighted_prune_with_real_steps_differs_only_at_ties():
    """Real steps diverge in the last bits (each framework's sums, Adam's
    first steps moving a near-zero gradient's weight by +-lr), so a group
    whose normalised norm sits within 1e-3 relative of tau may fall on
    either side: every element whose two masks differ lies in such a
    group, they are few, and every other mask entry is equal.  A block
    scheme's element keeps iff its block row and block column both do,
    each against tau times the leaf's mean row-group norm."""
    q = _quickstart()
    pspec, rspec, pres, rres = q["spec_p"], q["spec_r"], q["pres"], q["rres"]
    tau_p = RW.global_threshold(q["p_at"], pspec, 0.5)
    tau_r = ref_RW.global_threshold(q["r_at"], rspec, 0.5)
    assert tau_p == pytest.approx(tau_r, rel=1e-3)
    pm, rm = _flat(pres.masks), _flat(ref_to_numpy(rres.masks))
    assert pm.keys() == rm.keys()
    near_groups = total_groups = 0
    for path, leaf, c in ref_RW._iter_prunable(q["r_at"], rspec):
        assert c.scheme == "block"
        bk, bn = c.block
        sq = ref_RW.group_sqnorms(leaf, c)
        psq = RW.group_sqnorms(_flat(q["p_at"])[path],
                               RW.SchemeChoice(c.scheme, c.block))
        near = {}
        for kind in ("row", "col"):
            r_rel = np.asarray(sq[kind]) / np.asarray(sq["row"]).mean()
            p_rel = (psq[kind] / psq["row"].mean()).numpy()
            near[kind] = (np.abs(r_rel - tau_r) <= 1e-3 * tau_r) | \
                (np.abs(p_rel - tau_p) <= 1e-3 * tau_p)
            near_groups += int(near[kind].sum())
            total_groups += near[kind].size
        # element (i, j) of block (I, J) is decided by that block's row
        # group i and column group j
        *lead, P, Q = leaf.shape
        rows = np.repeat(near["row"][..., :, None], bn, -1)
        cols = np.repeat(near["col"][..., None, :], bk, -2)
        tied = np.swapaxes(rows | cols, -3, -2).reshape(leaf.shape)
        differ = pm[path].numpy() != rm[path]
        assert not (differ & ~tied).any(), path
    assert near_groups <= 0.01 * total_groups, (near_groups, total_groups)
    for k in rm:
        assert pm[k].ndim == rm[k].ndim, k
        if rm[k].ndim:                  # pruned weights are exactly zero
            assert (_flat(pres.params)[k].numpy()[pm[k].numpy() == 0]
                    == 0).all(), k
    assert pres.report["__overall__"]["density"] == pytest.approx(
        rres.report["__overall__"]["density"], abs=1e-3)


def test_one_shot_matches_reference():
    _, _, rp = _lm("yi-9b")
    pspec, rspec = _specs(RULES)
    got, want = _flat(pruner.one_shot(to_port(rp), pspec, 0.5)), \
        _flat(ref_to_numpy(ref_pruner.one_shot(rp, rspec, 0.5)))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# -- data --------------------------------------------------------------------

def test_synthetic_batch_is_a_noisy_bigram_chain():
    """A pure function of (seed, step, shard); labels are the tokens
    shifted by one; the share of transitions that follow the permutation
    is within 3 sigma of 1 - noise + noise / V."""
    V, B, S, noise = 64, 32, 64, 0.3
    a = data.synthetic_batch(0, 5, B, S, V, noise=noise, device="cpu")
    b = data.synthetic_batch(0, 5, B, S, V, noise=noise, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    for other in (data.synthetic_batch(0, 6, B, S, V, device="cpu"),
                  data.synthetic_batch(1, 5, B, S, V, device="cpu"),
                  data.synthetic_batch(0, 5, B, S, V, shard=1,
                                       device="cpu")):
        assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (B, S)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < V
    perm = data.bigram_perm(V, device="cpu")
    assert torch.equal(torch.sort(perm).values, torch.arange(V))
    follows = (perm[a["tokens"]] == a["labels"]).double().mean().item()
    p = 1 - noise + noise / V
    assert abs(follows - p) <= 3 * (p * (1 - p) / (B * S)) ** 0.5
    assert data.host_shard(64, 4, 3) == ref_data.host_shard(64, 4, 3)
    # encdec's / vlm's frontend: bf16 standard normals drawn after the
    # tokens, so the tokens are those of the batch without it
    f = data.synthetic_batch(0, 5, B, S, V, frontend_tokens=8, d_model=16,
                             device="cpu")
    assert torch.equal(f["tokens"], a["tokens"])
    assert f["frontend"].shape == (B, 8, 16)
    assert f["frontend"].dtype == torch.bfloat16
    assert torch.equal(f["frontend"], data.synthetic_batch(
        0, 5, B, S, V, frontend_tokens=8, d_model=16,
        device="cpu")["frontend"])
    assert abs(f["frontend"].float().std().item() - 1) < 0.15
    assert "frontend" not in a


def test_straggler_monitor_matches_reference():
    from repro.distributed.elastic import StragglerMonitor as RefMonitor
    times = [1.0, 1.1, 0.9, 1.0, 1.2, 5.0, 1.0, 3.5, 0.8, 9.0]
    got, want = StragglerMonitor(), RefMonitor()
    assert [got.observe(t) for t in times] == \
        [want.observe(t) for t in times]


# -- the train CLI and the quickstart pipeline -------------------------------

def test_train_cli_prunes_and_returns_masked_params(capsys):
    params, masks = train_cli.main(["--arch", "yi-9b", "--smoke", "--steps",
                                    "6", "--prune", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 3: pruned -> density" in out and "final loss" in out
    m = _flat(masks)
    pruned = [k for k, v in m.items() if v.ndim and (v == 0).any()]
    assert pruned
    for k in pruned:
        assert (_flat(params)[k][m[k] == 0] == 0).all(), k
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            train_cli.main(["--arch", "yi-9b", "--smoke", "--steps", "1"])
        else:
            raise RuntimeError("CUDA available")


def test_quickstart_pipeline_packs_the_reference_layers():
    """The shortened quickstart (``_quickstart``): ``compile_model`` of
    each package's pruned result packs the same layers, the spec is the
    train CLI's, and the compiled model's greedy tokens equal its
    masked-dense ones."""
    q = _quickstart()
    pcfg = _lm("yi-9b")[1]
    assert [(p, c.scheme, c.block) for p, c in q["spec_p"]] == \
        [(p, c.scheme, c.block) for p, c in q["spec_r"]]
    _, rrep = ref_compile.compile_model(q["rres"].params, q["rres"].masks,
                                        q["spec_r"])
    pexec, prep = C.compile_model(q["pres"].params, q["pres"].masks,
                                  q["spec_p"], device="cpu")
    assert [r.path for r in prep.packed]
    assert sorted(r.path for r in prep.packed) == \
        sorted(r.path for r in rrep.packed)
    assert set(packed_nodes(pexec)) == {r.path.rsplit("/", 1)[0]
                                        for r in prep.packed}
    got = engine.generate(pexec, pcfg, q["prompts"], 8, device="cpu")
    want = engine.generate(q["pres"].params, pcfg, q["prompts"], 8,
                           device="cpu")
    assert got.shape == (2, 8) and torch.equal(got, want)
