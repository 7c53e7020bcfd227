"""The port's MoE family against the reference, at mixtral-8x7b SMOKE size
(d_model 64, d_ff 128, 4 experts, top-2, window 32), fp32 unless stated:
dispatch tensors and ``moe()`` (one group, several groups, a group of
fewer than 4 tokens), the expert layouts ``compile_model`` packs, the
plain version of the batched expert product against the reference's
(its Pallas kernel in interpret mode, as its own tests run it), and
``forward`` logits and greedy ``generate`` tokens for dense and compiled
params.  Inputs come from numpy seeds and cross as numpy."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import (SPEC_RE, assert_layout_equal,  # noqa: E402
                                  ref_to_numpy, to_port)

ARCH = "mixtral-8x7b"
TOL = 1e-5               # fp32 moe() outputs and aux vs the reference
RTOL = ATOL = 2e-4       # fp32 logits (the bound tests/test_sparse_exec.py
#                          holds its dense-vs-packed MoE logits to, 2e-5,
#                          widened as test_torch_model.py does for two
#                          frameworks' fp32 sum orders)
BF16_TOL = 5e-2          # the reference's own bf16 MoE bound
EXPERTS = ("gate", "up", "down")


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


def _cfgs(**over):
    return (ref_configs.get(ARCH, smoke=True).replace(**over),
            configs.get(ARCH, smoke=True).replace(**over))


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(B, S))


@functools.lru_cache(maxsize=None)
def _model(dtype_name):
    """Reference params in ``dtype_name`` masked at rate 0.6 with (16, 16)
    blocks, both packages' compiled params (``keep_dense=False``) and
    reports; built once per dtype for the module."""
    dtype = getattr(jnp, dtype_name)
    rcfg, pcfg = _cfgs()
    rparams = ref_module.cast_tree(
        ref_T.init_lm(jax.random.PRNGKey(0), rcfg), dtype)
    spec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    rmasks = ref_RW.magnitude_block_masks(rparams, spec, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    rexec, rrep = ref_compile.compile_model(
        rpm, rmasks, spec, spec=ref_compile.CompileSpec(keep_dense=False))
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))]
    pexec, prep = C.compile_model(to_port(rpm), to_port(rmasks), pspec,
                                  spec=C.CompileSpec(keep_dense=False),
                                  device="cpu")
    return dict(dtype=dtype_name, rcfg=rcfg, pcfg=pcfg, rparams=rparams,
                rpm=rpm, rexec=rexec, rrep=rrep, pexec=pexec, prep=prep,
                rmasks=rmasks)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def fp32():
    return _model("float32")


# -- dispatch and moe() ------------------------------------------------------

@pytest.mark.parametrize("G,S,E,k,C", [(1, 16, 4, 2, 10), (3, 8, 4, 2, 5),
                                       (2, 12, 8, 2, 3), (1, 2, 4, 2, 2),
                                       (2, 6, 4, 1, 4)])
def test_dispatch_tensors_match_reference(G, S, E, k, C):
    """Slots past capacity dropped, gates renormalised, the Switch aux
    loss; logits from a seed (no ties)."""
    logits = _np(G * 100 + S, G, S, E) * 2
    got = moe._dispatch_tensors(torch.from_numpy(logits), k, C)
    want = ref_moe._dispatch_tensors(jnp.asarray(logits), k, C)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_dispatch_routes_bf16_logits_in_fp32():
    logits = torch.from_numpy(_np(7, 1, 8, 4)).to(torch.bfloat16)
    d_bf, c_bf, _ = moe._dispatch_tensors(logits, 2, 4)
    d_32, c_32, _ = moe._dispatch_tensors(logits.float(), 2, 4)
    assert d_bf.dtype == torch.float32
    assert torch.equal(d_bf, d_32) and torch.equal(c_bf, c_32)


@pytest.mark.parametrize("group,B,S", [(1024, 2, 16), (8, 2, 16), (2, 1, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(group, B, S, dtype, monkeypatch):
    """One group, G = 4 groups of 8, and a group of 2 tokens, whose
    capacity is clamped to the group size (not the floor of 4).  bf16
    params cast the router to bf16 too, as the reference's tests do: the
    port routes ``x.float() @ router.float()`` like the reference's
    promotion, so aux agrees to fp32 rounding in both dtypes."""
    D, F, E = 64, 128, 4
    rp = ref_moe.moe_init(jax.random.PRNGKey(0), D, F, E, dtype=jnp.float32)
    rp = ref_module.cast_tree(rp, getattr(jnp, dtype))
    x = _np(1, B, S, D)
    want, want_aux = ref_moe.moe(rp, jnp.asarray(x).astype(dtype), top_k=2,
                                 group=group)
    seen = []
    orig = moe._dispatch_tensors
    monkeypatch.setattr(moe, "_dispatch_tensors",
                        lambda lg, k, cap: seen.append(cap) or
                        orig(lg, k, cap))
    pp = to_port(rp)
    got, aux = moe.moe(pp, torch.from_numpy(x).to(getattr(torch, dtype)),
                       top_k=2, group=group)
    Sg = min(group, B * S)
    assert seen == [min(Sg, max(4, int(Sg * 2 / E * 1.25)))]
    if group == 2:
        assert seen == [2]
    assert got.shape == (B, S, D) and got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(got, want, rtol=tol, atol=tol)
    _close(aux, want_aux)


# -- expert layouts ----------------------------------------------------------

def test_expert_layouts_match_reference(model):
    """Every (layers, experts, K, N) stack packs to the reference's leaves
    bit for bit; the router is skipped as excluded; report rows agree
    (``layers`` counts layers x experts, as the reference's)."""
    pexec, rexec = model["pexec"], model["rexec"]
    for name in EXPERTS:
        lay = pexec["layers"]["moe"][name]["packed"]
        assert "w" not in pexec["layers"]["moe"][name]
        assert tuple(lay.nnz.shape[:-1]) == (2, 4)
        assert_layout_equal(lay, rexec["layers"]["moe"][name]["packed"])
    for name in ("wq", "wk", "wv", "wo"):
        assert_layout_equal(pexec["layers"]["attn"][name]["packed"],
                            rexec["layers"]["attn"][name]["packed"])

    def rows(rep):
        return sorted((r.path, r.packed, r.reason, r.L, r.L_reordered, r.Kb,
                       r.layers) for r in rep)
    assert rows(model["prep"]) == rows(model["rrep"])
    by_path = {r.path: r for r in model["prep"]}
    assert by_path["layers/moe/router/w"].reason == "excluded"
    assert by_path["layers/moe/gate/w"].layers == 2 * 4
    assert len(model["prep"].packed) == 7


def test_expert_layout_crosses_from_numpy(model):
    """A stacked expert layout and the fp32 router cross from numpy
    unchanged (``convert`` takes any leading dims)."""
    rlay = model["rexec"]["layers"]["moe"]["down"]["packed"]
    crossed = to_port({"packed": rlay})["packed"]
    assert_layout_equal(crossed, rlay)
    router = to_port(model["rpm"])["layers"]["moe"]["router"]["w"]
    assert tuple(router.shape) == (2, 64, 4)
    assert router.dtype == getattr(torch, model["dtype"])


@pytest.mark.parametrize("act,bias", [("silu", True), ("none", False)])
def test_sparse_expert_linear_plain_matches_reference(act, bias):
    """(E, M, K) @ an (E, K, N) expert stack, reordered into 4 bins: the
    port's plain version against the reference's vmapped Pallas kernel
    (interpret mode)."""
    E, M, K, N = 4, 5, 64, 128
    rng = np.random.RandomState(2)
    w = rng.randn(E, K, N).astype(np.float32)
    live = rng.rand(E, K // 16, N // 16) < 0.5
    mask = np.repeat(np.repeat(live, 16, 1), 16, 2).astype(np.float32)
    rlay, _ = ref_compile._pack_stacked(w * mask, mask, (16, 16),
                                        reorder=True, n_bins=4)
    play, _ = C._pack_stacked(torch.from_numpy(w * mask),
                              torch.from_numpy(mask), (16, 16),
                              reorder=True, n_bins=4)
    assert_layout_equal(play, rlay)
    x = _np(3, E, M, K)
    b = _np(4, E, N) if bias else None
    want = ref_ops.sparse_expert_linear(
        jnp.asarray(x), rlay, bias=None if b is None else jnp.asarray(b),
        act=act, interpret=True)
    got = ops.sparse_expert_linear(torch.from_numpy(x), play,
                                   bias=None if b is None else
                                   torch.from_numpy(b), act=act)
    assert got.shape == (E, M, N)
    _close(got, want)
    # expert e is the unstacked product with expert e's layout slice
    for e in range(E):
        one = ops.sparse_linear(torch.from_numpy(x[e]), play.layer(e),
                                bias=None if b is None else
                                torch.from_numpy(b[e]), act=act)
        assert torch.equal(got[e], one)


def test_sparse_expert_linear_rejects_a_layer_stack(model):
    lay = model["pexec"]["layers"]["moe"]["gate"]["packed"]   # (L, E, ...)
    with pytest.raises(ValueError, match="stack"):
        ops.sparse_expert_linear(torch.zeros(4, 3, 64), lay)


def test_moe_packed_matches_masked_dense(fp32):
    """One layer's moe() on packed and on masked-dense params, same input:
    the router is the same, so is the routing, and the experts agree."""
    model = fp32
    lp_exec = T.layer_params(model["pexec"])[1]["moe"]
    lp_dense = T.layer_params(to_port(model["rpm"]))[1]["moe"]
    x = torch.from_numpy(_np(5, 2, 16, 64))
    a, aux_a = moe.moe(lp_exec, x, top_k=2, group=8)
    b, aux_b = moe.moe(lp_dense, x, top_k=2, group=8)
    assert torch.equal(aux_a, aux_b)
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


# -- whole model -------------------------------------------------------------

def test_forward_logits_match_reference(model):
    """Dense and compiled params, one dispatch group and (``moe_group``
    8) four; fp32 to the stated bound, bf16 to the reference's 5e-2."""
    tokens = _tokens(model["rcfg"], 2, 16, seed=1)
    tol = (RTOL, ATOL) if model["dtype"] == "float32" else (0, BF16_TOL)
    for group in (1024, 8):
        rcfg = model["rcfg"].replace(moe_group=group)
        pcfg = model["pcfg"].replace(moe_group=group)
        want, _ = ref_T.forward(model["rpm"], rcfg, jnp.asarray(tokens))
        for params in (to_port(model["rpm"]), model["pexec"]):
            got = T.forward(params, pcfg, torch.from_numpy(tokens))
            assert got.dtype == getattr(torch, model["dtype"])
            _close(got, want, *tol)


def test_generate_tokens_identical_to_reference(fp32):
    """Greedy tokens equal the reference's for dense params and for
    ``compile_model(keep_dense=False)`` params (fp32); decode runs dispatch
    groups of B tokens (capacity clamped to 2 at B = 2)."""
    model = fp32
    rcfg, pcfg = model["rcfg"], model["pcfg"]
    tokens = _tokens(rcfg, 2, 8, seed=4)
    want_dense = np.asarray(ref_engine.generate(model["rpm"], rcfg,
                                                jnp.asarray(tokens), 12))
    want_sparse = np.asarray(ref_engine.generate(model["rexec"], rcfg,
                                                 jnp.asarray(tokens), 12))
    got_dense = engine.generate(to_port(model["rpm"]), pcfg, tokens, 12,
                                device="cpu")
    got_sparse = engine.generate(model["pexec"], pcfg, tokens, 12,
                                 device="cpu")
    assert got_sparse.shape == (2, 12) and got_sparse.dtype == torch.int32
    np.testing.assert_array_equal(got_dense.numpy(), want_dense)
    np.testing.assert_array_equal(got_sparse.numpy(), want_sparse)
    np.testing.assert_array_equal(got_sparse.numpy(), got_dense.numpy())


def test_init_lm_moe_tree_and_cache(model):
    """The port's own MoE init: router fp32 in a bf16 model, experts
    stacked (layers, experts, ...); the cache is the dense family's."""
    pcfg = model["pcfg"]
    p = T.init_lm(pcfg, seed=0, device="cpu")
    m = p["layers"]["moe"]
    assert m["router"]["w"].dtype == torch.float32
    assert tuple(m["router"]["w"].shape) == (2, 64, 4)
    assert tuple(m["gate"]["w"].shape) == (2, 4, 64, 128)
    assert tuple(m["down"]["w"].shape) == (2, 4, 128, 64)
    assert m["gate"]["w"].dtype == torch.bfloat16
    cache = T.init_cache(p, pcfg, 3, 40)
    assert tuple(cache["kv"]["k"].shape) == (2, 3, 32, 2, 16)


def test_masks_of_the_expert_stack_match_reference(model):
    """Whole-stack quantile over (layers, experts, Kb, Nb) block norms."""
    rmasks = ref_to_numpy(model["rmasks"])
    pmasks = RW.magnitude_block_masks(
        to_port(model["rparams"]),
        [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))], None, rate=0.6)
    for name in EXPERTS:
        np.testing.assert_array_equal(
            pmasks["layers"]["moe"][name]["w"].numpy() != 0,
            rmasks["layers"]["moe"][name]["w"] != 0)


def test_block_masks_of_a_stack_equal_the_whole_stack_square():
    """``magnitude_block_masks`` sums the block norms one (K, N) slice at a
    time (a whole-stack fp32 square would copy a full-width expert stack
    twice); the masks are bitwise those of the whole-stack sum."""
    from repro_torch.core.regularity import quantile
    leaf = torch.from_numpy(_np(9, 2, 4, 64, 128)).to(torch.bfloat16)
    got = RW.magnitude_block_masks(
        {"w": leaf}, [(r"w$", RW.SchemeChoice("block", (16, 16)))], None,
        rate=0.6)["w"]
    g = torch.square(leaf.float()).reshape(2, 4, 4, 16, 8, 16).sum(
        dim=(-3, -1))
    keep = g > quantile(g, 0.6)
    want = keep.repeat_interleave(16, -2).repeat_interleave(16, -1)
    assert got.dtype == want.dtype and torch.equal(got, want)
