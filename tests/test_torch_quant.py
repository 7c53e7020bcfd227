"""The port's int8 value path against the reference, on the CPU:
``core.quant`` bit for bit (values and scales, single, stacked and tap
layouts, both granularities, the same refusals), the plain versions
against the reference's int8 kernels (interpret mode, as
``tests/test_quant.py`` runs them), ``compile_model(value_dtype="int8")``
on yi-9b and mixtral SMOKE and on VGG_TINY under both mappings (every
layout leaf, logits and greedy tokens), the reference's quantized params
crossed into the port, and the per-layer precision pick.  The CUDA
kernels' int8 branches are held against these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import bcs as ref_BCS  # noqa: E402
from repro.core import quant as ref_Q  # noqa: E402
from repro.core import regularity as ref_R  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import convnet as ref_CN  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import (SPEC_RE, assert_layout_equal,  # noqa: E402
                                  assert_tap_layout_equal, packed_nodes,
                                  to_port)

TOL = dict(rtol=1e-5, atol=1e-5)   # the reference's own (test_quant.py)
RTOL = ATOL = 2e-4                 # fp32 logits (test_torch_model.py)
GRANS = ("block", "out")
CONV_RE = r"(^|/)(c|pw|dw)\d+/w"


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _block_case(lead, K, N, block=(16, 16), seed=0, keep=0.5):
    """Seeded (w * mask, mask) of shape lead + (K, N), whole (16, 16)
    blocks dead."""
    rng = np.random.RandomState(seed)
    bk, bn = block
    live = rng.rand(*lead, K // bk, N // bn) < keep
    mask = np.repeat(np.repeat(live, bk, -2), bn, -1).astype(np.float32)
    w = rng.randn(*lead, K, N).astype(np.float32) * 0.1
    return w * mask, mask


def _conv_case(P=32, Q=16, k=3, seed=6):
    w = _np(seed, P, Q, k, k, scale=0.1)
    mask = np.asarray(ref_R.block_punched_mask(jnp.asarray(w), (8, 8),
                                               rate=0.5))
    return w * mask, mask


def _pattern_case(P=16, Q=12, k=3, seed=8):
    w = _np(seed, P, Q, k, k, scale=0.1)
    mask = np.asarray(ref_R.pattern_mask(jnp.asarray(w),
                                         connectivity_rate=0.4))
    return w * mask, mask


# -- core.quant ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gran", GRANS)
def test_quantize_layout_matches_reference_bitwise(gran, dtype):
    """One packed layout: int8 values and fp32 scales bit-equal to the
    reference's, and ``to_dense`` the same dequantized weight."""
    wm, mask = _block_case((), 128, 96)
    wm = np.asarray(jnp.asarray(wm, getattr(jnp, dtype)))
    fp = ref_ops.pack(wm, mask, (16, 16), reorder=True, use_cache=False)
    want = ref_Q.quantize_layout(fp, scale_granularity=gran)
    got = Q.quantize_layout(ops.pack(_t(wm), _t(mask), (16, 16),
                                     reorder=True),
                            scale_granularity=gran)
    assert got.value_dtype == "int8" and got.scale_granularity == gran
    assert_layout_equal(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(), want.to_dense())
    # ops.pack(value_dtype=...) is the float pack quantized
    assert_layout_equal(ops.pack(_t(wm), _t(mask), (16, 16), reorder=True,
                                 value_dtype="int8",
                                 scale_granularity=gran), want)


@pytest.mark.parametrize("gran", GRANS)
def test_quantize_stacked_layers_and_experts_matches_reference(gran):
    """A (layers, experts) stack quantized as a whole; ``layer(i)`` slices
    the scales with the other leaves, down to one expert's dense weight."""
    wm, mask = _block_case((2, 3), 64, 48, seed=1)
    want, _ = ref_compile._pack_stacked(wm, mask, (16, 16),
                                        value_dtype="int8",
                                        scale_granularity=gran)
    got, _ = C._pack_stacked(_t(wm), _t(mask), (16, 16),
                             value_dtype="int8", scale_granularity=gran)
    assert_layout_equal(got, want)
    one = got.layer(1).layer(2)
    for s, full in zip(one.scales, got.scales):
        assert torch.equal(s, full[1, 2])
    ref_one = ref_ops.pack(wm[1, 2], mask[1, 2], (16, 16), reorder=True,
                           value_dtype="int8", scale_granularity=gran,
                           use_cache=False)
    np.testing.assert_array_equal(one.to_dense().numpy(),
                                  ref_one.to_dense())


@pytest.mark.parametrize("gran", GRANS)
def test_quantize_tap_layout_matches_reference(gran):
    wm, mask = _pattern_case()
    want = ref_ops.pack_taps(wm, mask, value_dtype="int8",
                             scale_granularity=gran, use_cache=False)
    got = ops.pack_taps(_t(wm), _t(mask), value_dtype="int8",
                        scale_granularity=gran)
    assert got.scale_granularity == gran
    assert_tap_layout_equal(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(), want.to_dense())


def test_quantize_rejections_match_reference():
    wm, mask = _block_case((), 64, 32, seed=2)
    fp = ops.pack(_t(wm), _t(mask), (16, 16))
    q8 = Q.quantize_layout(fp)
    with pytest.raises(ValueError, match="already quantized"):
        Q.quantize_layout(q8)
    with pytest.raises(ValueError, match="value_dtype"):
        Q.quantize_layout(fp, value_dtype="int4")
    with pytest.raises(ValueError, match="scale_granularity"):
        Q.quantize_layout(fp, scale_granularity="tensor")
    with pytest.raises(TypeError, match="not a packable layout"):
        Q.quantize_layout(torch.zeros(4, 4))
    assert Q.QMAX == ref_Q.QMAX and Q.GRANULARITIES == ref_Q.GRANULARITIES


def test_all_zero_groups_store_scale_zero():
    wm, mask = _block_case((), 64, 32, seed=3)
    wm[:, :16] = 0.0                       # a dead block column, live mask
    mask[:, :16] = 1.0
    for gran in GRANS:
        lay = ops.pack(_t(wm), _t(mask), (16, 16), value_dtype="int8",
                       scale_granularity=gran)
        s = lay.scales[0]
        assert torch.all(s[0] == 0) and torch.all(lay.values[0][0] == 0)


# -- the plain versions against the reference's int8 kernels ------------------

@pytest.mark.parametrize("gran", GRANS)
def test_int8_linear_matches_reference_kernel(gran):
    wm, mask = _block_case((), 64, 96, seed=2)
    x = _np(3, 32, 64)
    rq = ref_ops.pack(wm, mask, (16, 16), reorder=True, value_dtype="int8",
                      scale_granularity=gran, use_cache=False)
    pq = ops.pack(_t(wm), _t(mask), (16, 16), reorder=True,
                  value_dtype="int8", scale_granularity=gran)
    want = np.asarray(ref_ops.sparse_linear(jnp.asarray(x), packed=rq))
    np.testing.assert_allclose(ops.sparse_linear(_t(x), packed=pq).numpy(),
                               want, **TOL)


def test_int8_moe_stack_matches_reference_kernel():
    wm, mask = _block_case((3,), 32, 48, seed=4)
    x = _np(5, 3, 8, 32)
    rq, _ = ref_compile._pack_stacked(wm, mask, (16, 16), value_dtype="int8")
    pq, _ = C._pack_stacked(_t(wm), _t(mask), (16, 16), value_dtype="int8")
    want = np.asarray(ref_ops.sparse_expert_linear(jnp.asarray(x), rq))
    np.testing.assert_allclose(ops.sparse_expert_linear(_t(x), pq).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("implicit", [False, True])
def test_int8_conv_matches_reference_kernel(implicit):
    wm, mask = _conv_case()
    Qc = wm.shape[1]
    gemm_block, why = ref_BCS.conv_gemm_block((8, 8), wm.shape)
    assert gemm_block is not None, why
    rq = ref_ops.pack(ref_BCS.conv_lower(wm), ref_BCS.conv_lower(mask),
                      gemm_block, reorder=True, conv=(3, 3, Qc),
                      value_dtype="int8", use_cache=False)
    pq = ops.pack(BCS.conv_lower(_t(wm)), BCS.conv_lower(_t(mask)),
                  gemm_block, reorder=True, conv=(3, 3, Qc),
                  value_dtype="int8")
    x = _np(7, 2, 8, 8, Qc)
    want = np.asarray(ref_ops.sparse_conv2d(jnp.asarray(x), rq, kh=3, kw=3,
                                            implicit=implicit))
    got = ops.sparse_conv2d(_t(x), pq, kh=3, kw=3, implicit=implicit)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("gran", GRANS)
def test_int8_tap_matches_reference_kernel(gran, implicit):
    wm, mask = _pattern_case()
    rq = ref_ops.pack_taps(wm, mask, value_dtype="int8",
                           scale_granularity=gran, use_cache=False)
    pq = ops.pack_taps(_t(wm), _t(mask), value_dtype="int8",
                       scale_granularity=gran)
    x = _np(9, 2, 7, 7, 12)
    want = np.asarray(ref_ops.sparse_conv2d_pattern(
        jnp.asarray(x), rq, kh=3, kw=3, implicit=implicit))
    got = ops.sparse_conv2d_pattern(_t(x), pq, kh=3, kw=3,
                                    implicit=implicit)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- compile_model(value_dtype="int8") ----------------------------------------

def _lm(arch, gran):
    """An LM SMOKE config's reference params (fp32) masked at rate 0.6 in
    (16, 16) blocks, and both packages' int8 compiles of them."""
    rcfg = ref_configs.get(arch, smoke=True)
    pcfg = configs.get(arch, smoke=True)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    spec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    rmasks = ref_RW.magnitude_block_masks(rparams, spec, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    rexec, _ = ref_compile.compile_model(
        rpm, rmasks, spec, spec=ref_compile.CompileSpec(
            keep_dense=False, value_dtype="int8", scale_granularity=gran))
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16)))]
    pexec, prep = C.compile_model(
        to_port(rpm), to_port(rmasks), pspec,
        spec=C.CompileSpec(keep_dense=False, value_dtype="int8",
                           scale_granularity=gran), device="cpu")
    return rcfg, pcfg, rexec, pexec, prep


@pytest.mark.parametrize("arch,gran", [("yi-9b", "block"), ("yi-9b", "out"),
                                       ("mixtral-8x7b", "block")])
def test_compile_int8_lm_matches_reference(arch, gran):
    """Every int8 layout leaf equal to the reference's compile of the same
    params and masks; fp32 logits within the port's LM bound and greedy
    tokens identical."""
    rcfg, pcfg, rexec, pexec, prep = _lm(arch, gran)
    got, want = packed_nodes(pexec), packed_nodes(rexec)
    assert sorted(got) == sorted(want) and len(got) == 7
    for path, lay in got.items():
        assert lay.value_dtype == "int8" and lay.scale_granularity == gran
        assert_layout_equal(lay, want[path])
    assert {r.value_dtype for r in prep.packed} == {"int8"}
    assert "values=int8" in C.compiled_summary(prep)
    tokens = np.random.RandomState(1).randint(0, rcfg.vocab, size=(2, 8))
    want_logits, _ = ref_T.forward(rexec, rcfg, jnp.asarray(tokens))
    got_logits = T.forward(pexec, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    want_tok = np.asarray(ref_engine.generate(rexec, rcfg,
                                              jnp.asarray(tokens), 6))
    got_tok = engine.generate(pexec, pcfg, tokens, 6, device="cpu")
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


def test_reference_int8_params_cross_whole():
    """The reference's quantized exec params through ``params_from_numpy``
    are the port's own int8 compile, leaf for leaf, and run to the same
    logits bit for bit."""
    rcfg, pcfg, rexec, pexec, _ = _lm("yi-9b", "block")
    crossed = to_port(rexec)
    for path, lay in packed_nodes(crossed).items():
        assert lay.scales is not None
        assert_layout_equal(lay, packed_nodes(rexec)[path])
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, rcfg.vocab, size=(2, 8)))
    assert torch.equal(T.forward(crossed, pcfg, tokens),
                       T.forward(pexec, pcfg, tokens))


@pytest.mark.parametrize("mapping", ["punched", "pattern"])
def test_compile_int8_vgg_tiny_matches_reference(mapping):
    """VGG_TINY compiled int8 under either mapping (tap layouts always per
    filter): the layouts and the logits of the reference's int8 net."""
    choice = (("block_punched", dict(block=(8, 8))) if mapping == "punched"
              else ("pattern", dict(connectivity=0.5)))
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(0), ref_CN.VGG_TINY)
    rspec = [(CONV_RE, ref_RW.SchemeChoice(choice[0], **choice[1]))]
    pspec = [(CONV_RE, RW.SchemeChoice(choice[0], **choice[1]))]
    if mapping == "punched":
        rmasks = ref_RW.punched_conv_masks(rparams, rspec, (8, 8), rate=0.5)
    else:
        rmasks = ref_RW.masks_for_spec(rparams, rspec)
    rpm = ref_apply_masks(rparams, rmasks)
    rexec, _ = ref_compile.compile_model(
        rpm, rmasks, rspec, spec=ref_compile.CompileSpec(
            keep_dense=False, value_dtype="int8"))
    pexec, _ = C.compile_model(
        to_port(rpm), to_port(rmasks), pspec,
        spec=C.CompileSpec(keep_dense=False, value_dtype="int8"),
        device="cpu")
    got, want = packed_nodes(pexec), packed_nodes(rexec)
    assert sorted(got) == sorted(want) and got
    for path, lay in got.items():
        if mapping == "pattern":
            assert lay.scale_granularity == "out"
            assert_tap_layout_equal(lay, want[path])
        else:
            assert lay.scale_granularity == "block"
            assert_layout_equal(lay, want[path])
    x = _np(14, 2, 16, 16, 3)
    want_logits = np.asarray(ref_CN.convnet_apply(rexec, jnp.asarray(x),
                                                  ref_CN.VGG_TINY))
    got_logits = CN.convnet_apply(pexec, _t(x), CN.VGG_TINY)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, **TOL)


def test_scheme_choice_value_dtype_overrides_the_spec():
    """A layer's ``SchemeChoice.value_dtype`` wins over the spec's, as in
    the reference: int8 projections beside float ones in one model."""
    rcfg = ref_configs.get("yi-9b", smoke=True)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    base = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    rmasks = ref_RW.magnitude_block_masks(rparams, base, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    mapping = [(r"attn/wq/w", dict(value_dtype="int8")),
               (SPEC_RE, dict(value_dtype=None))]
    rspec = [(p, ref_RW.SchemeChoice("block", (16, 16), **kw))
             for p, kw in mapping]
    pspec = [(p, RW.SchemeChoice("block", (16, 16), **kw))
             for p, kw in mapping]
    rexec, rrep = ref_compile.compile_model(rpm, rmasks, rspec)
    pexec, prep = C.compile_model(to_port(rpm), to_port(rmasks), pspec,
                                  device="cpu")
    got, want = packed_nodes(pexec), packed_nodes(rexec)
    for path, lay in got.items():
        assert_layout_equal(lay, want[path])
        assert (lay.value_dtype == "int8") == ("wq" in path)

    def rows(rep):
        return sorted((r.path, r.value_dtype) for r in rep.packed)
    assert rows(prep) == rows(rrep)
    # a spec of int8 and a choice of None: the spec holds
    pexec2, _ = C.compile_model(
        to_port(rpm), to_port(rmasks), [(SPEC_RE, RW.SchemeChoice(
            "block", (16, 16)))], spec=C.CompileSpec(value_dtype="int8"),
        device="cpu")
    assert {lay.value_dtype for lay in packed_nodes(pexec2).values()} == {
        "int8"}


def test_unsupported_choice_value_dtype_is_skipped_as_reference():
    rcfg = ref_configs.get("yi-9b", smoke=True)
    rparams = ref_module.cast_tree(ref_T.init_lm(jax.random.PRNGKey(0),
                                                 rcfg), jnp.float32)
    base = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16)))]
    rmasks = ref_RW.magnitude_block_masks(rparams, base, None, rate=0.6)
    rspec = [(SPEC_RE, ref_RW.SchemeChoice("block", (16, 16),
                                           value_dtype="int4"))]
    pspec = [(SPEC_RE, RW.SchemeChoice("block", (16, 16),
                                       value_dtype="int4"))]
    _, rrep = ref_compile.compile_model(rparams, rmasks, rspec)
    _, prep = C.compile_model(to_port(rparams), to_port(rmasks), pspec,
                              device="cpu")
    assert not prep.packed

    def reasons(rep):
        return sorted((r.path, r.reason) for r in rep if not r.packed)
    assert reasons(prep) == reasons(rrep)


@pytest.mark.parametrize("kw", [dict(value_dtype="int4"),
                                dict(value_dtype="float16"),
                                dict(scale_granularity="tensor"),
                                dict(scale_granularity=None)])
def test_compile_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        ref_compile.CompileSpec(**kw)
    with pytest.raises(ValueError) as got:
        C.CompileSpec(**kw)
    assert str(got.value) == str(want.value)
    for ok in (dict(value_dtype="int8"), dict(value_dtype=None),
               dict(value_dtype="int8", scale_granularity="out")):
        assert dataclasses.asdict(C.CompileSpec(**ok))["value_dtype"] == \
            ok["value_dtype"]
