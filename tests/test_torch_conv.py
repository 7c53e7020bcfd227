"""The block-punched conv path of the port against the reference: masks,
the im2col lowering and its tap table, packed conv layouts leaf for leaf,
``sparse_conv2d`` in both x-operand modes, and the whole conv nets
(``VGG_TINY``, ``MOBILE_TINY``) under the block-punched and the pattern
mappings, compiled with and without the dense weights.  The reference
runs as its own tests run it (Pallas kernels in interpret mode); inputs
come from numpy with a seed.  The CUDA kernels themselves are held against
their plain versions on the card in ``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bcs as ref_BCS  # noqa: E402
from repro.core import regularity as ref_R  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.kernels import bsr_matmul as ref_bsr  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import convnet as ref_CN  # noqa: E402
from repro.serve import compile as ref_compile  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch.convert import layout_from_numpy, tensor_from_numpy  # noqa: E402,E501
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import regularity as R  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convnet as CN  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

from test_torch_reference import (assert_layout_equal,  # noqa: E402
                                  assert_tap_layout_equal, ref_to_numpy,
                                  to_port)

TOL = 1e-5        # the reference's own conv bound (test_conv_sparse.py)
CONV_RE = r"(^|/)(c|pw|dw)\d+/w"
MAPPINGS = {
    "punched": ("block_punched", {"block": (8, 8)}),
    "pattern": ("pattern", {"connectivity": 0.5}),
}
ARCHS = {"vgg": "VGG_TINY", "mobile": "MOBILE_TINY"}


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def conv_case(P, Q, kh, kw, rate=0.5, block=(8, 8), seed=0):
    """Seeded (w * mask, mask) with the reference's block-punched mask."""
    w = _np(seed, P, Q, kh, kw, scale=0.1)
    mask = np.asarray(ref_R.block_punched_mask(jnp.asarray(w), block,
                                               rate=rate))
    return w * mask, mask


def _both_layouts(wm, mask, block=(8, 8), **kw):
    """The reference's packed conv layout and the port's of the same
    lowered weight."""
    P, Q, kh, kwd = wm.shape
    ref = ref_ops.pack(ref_BCS.conv_lower(wm), ref_BCS.conv_lower(mask),
                       block, conv=(kh, kwd, Q), use_cache=False, **kw)
    port = ops.pack(BCS.conv_lower(_t(wm)), BCS.conv_lower(_t(mask)), block,
                    conv=(kh, kwd, Q), **kw)
    return ref, port


# -- masks --------------------------------------------------------------------

@pytest.mark.parametrize("P,Q,k,block,rate", [
    (32, 16, 3, (8, 8), 0.5), (64, 32, 5, (8, 8), 0.7),
    (16, 8, 1, (4, 4), 0.3), (32, 16, 3, (16, 8), 0.5)])
def test_block_punched_mask_matches_reference(P, Q, k, block, rate):
    w = _np(1, P, Q, k, k)
    want = np.asarray(ref_R.block_punched_mask(jnp.asarray(w), block,
                                               rate=rate))
    got = R.block_punched_mask(_t(w), block, rate=rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_punched_conv_masks_match_reference(arch):
    ref_arch = getattr(ref_CN, ARCHS[arch])
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(3), ref_arch,
                                  dtype=jnp.float32)
    spec = [(CONV_RE, ref_RW.SchemeChoice("block_punched", (8, 8)))]
    pspec = [(CONV_RE, RW.SchemeChoice("block_punched", (8, 8)))]
    want = ref_to_numpy(ref_RW.punched_conv_masks(rparams, spec, (8, 8),
                                                  rate=0.5))
    got = RW.punched_conv_masks(to_port(rparams), pspec, (8, 8), rate=0.5)
    for name in want:
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      want[name]["w"])
        assert got[name]["b"].ndim == 0          # sentinel


def test_make_mask_dispatch():
    """Every scheme of the dispatch on a conv weight, at a rate and (the
    block-punched groups) at a threshold, bit-equal to the reference."""
    w = _t(_np(2, 16, 8, 3, 3))
    wj = jnp.asarray(w.numpy())
    assert torch.equal(R.make_mask(w, "none"), torch.ones(w.shape))
    for scheme, kw in [("block_punched", dict(block=(8, 8), rate=0.5)),
                       ("block_punched", dict(block=(8, 8), threshold=0.1)),
                       ("unstructured", dict(rate=0.5)),
                       ("structured_row", dict(rate=0.5)),
                       ("block", dict(block=(3, 3), rate=0.5)),
                       ("pattern", dict(connectivity_rate=0.5))]:
        np.testing.assert_array_equal(
            R.make_mask(w, scheme, **kw).numpy(),
            np.asarray(ref_R.make_mask(wj, scheme, **kw)), err_msg=scheme)


# -- lowering -----------------------------------------------------------------

@pytest.mark.parametrize("P,Q,kh,kw", [(4, 3, 2, 2), (32, 16, 3, 3),
                                       (8, 8, 5, 5), (16, 8, 1, 1)])
def test_conv_lower_matches_reference(P, Q, kh, kw):
    w = _np(4, P, Q, kh, kw)
    np.testing.assert_array_equal(BCS.conv_lower(_t(w)).numpy(),
                                  ref_BCS.conv_lower(w))


@pytest.mark.parametrize("kh,kw,c,bk", [(2, 3, 8, 4), (3, 3, 32, 8),
                                        (5, 5, 16, 16), (1, 1, 64, 8)])
def test_conv_tap_table_matches_reference(kh, kw, c, bk):
    assert BCS.conv_tap_table(kh, kw, c, bk) == \
        ref_BCS.conv_tap_table(kh, kw, c, bk)


def test_conv_tap_table_and_gemm_block_refuse_straddling_blocks():
    with pytest.raises(ValueError, match="straddle"):
        BCS.conv_tap_table(3, 3, 8, 6)
    shape = (32, 3, 3, 3)
    got = BCS.conv_gemm_block((8, 8), shape)
    want = ref_BCS.conv_gemm_block((8, 8), shape)
    assert got == want and got[0] is None
    assert BCS.conv_gemm_block((16, 8), (32, 16, 3, 3)) == \
        ref_BCS.conv_gemm_block((16, 8), (32, 16, 3, 3)) == ((8, 16), None)


@pytest.mark.parametrize("reorder,n_bins", [(False, 4), (True, 1),
                                            (True, 4), (True, 8)])
@pytest.mark.parametrize("P,Q,k", [(32, 16, 3), (64, 32, 5), (32, 16, 1)])
def test_packed_conv_layout_matches_reference(P, Q, k, reorder, n_bins):
    """Integer leaves and ``conv_taps`` equal, values bit-equal."""
    wm, mask = conv_case(P, Q, k, k, seed=P + k)
    ref, port = _both_layouts(wm, mask, reorder=reorder, n_bins=n_bins)
    assert_layout_equal(port, ref)
    np.testing.assert_array_equal(port.to_dense().numpy(), ref.to_dense())


def test_layout_crosses_with_conv_taps():
    wm, mask = conv_case(32, 16, 3, 3)
    ref, port = _both_layouts(wm, mask, reorder=True)
    crossed = layout_from_numpy(ref_to_numpy(ref), "cpu")
    assert_layout_equal(crossed, ref)
    assert torch.equal(crossed.conv_taps_t, port.conv_taps_t)
    assert tuple(port.conv_taps_t.shape) == (port.Kb, 3)


# -- geometry and the conv executors ------------------------------------------

@pytest.mark.parametrize("H,W,k,s,padding", [
    (32, 32, 3, 2, "SAME"), (9, 13, 3, 2, "SAME"), (16, 16, 1, 1, "SAME"),
    (4, 4, 5, 1, "SAME"), (10, 10, 3, 1, "VALID"), (11, 7, 5, 1, "VALID")])
def test_conv_geometry_and_im2col_match_reference(H, W, k, s, padding):
    assert K.conv_geometry(H, W, k, k, s, padding) == \
        ref_bsr.conv_geometry(H, W, k, k, s, padding)
    x = _np(5, 2, H, W, 4)
    np.testing.assert_array_equal(
        ops.im2col(_t(x), k, k, s, padding).numpy(),
        np.asarray(ref_ops.im2col(jnp.asarray(x), k, k, s, padding)))
    assert ops.patch_bytes(_t(x), k, k, s, padding) == \
        ref_ops.patch_bytes(jnp.asarray(x), k, k, s, padding)


def test_same_padding_is_asymmetric():
    """XLA SAME at an even input and stride 2 pads (0, 1)."""
    assert K._same_pads(32, 3, 2) == (0, 1)
    assert K._same_pads(32, 3, 1) == (1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        K.conv_geometry(4, 4, 5, 5, 1, "VALID")


@pytest.mark.parametrize("shape,k,bk,implicit", [
    ((1, 8, 8, 16), 3, 8, None), ((8, 64, 64, 64), 3, 8, None),
    ((8, 64, 64, 64), 1, 8, None), ((8, 64, 64, 64), 3, 48, None),
    ((1, 8, 8, 16), 3, 8, True), ((1, 8, 8, 16), 3, 8, False),
    ((8, 64, 64, 64), 3, None, None)])
def test_pick_implicit_matches_reference(shape, k, bk, implicit):
    """The port picks as the reference does, except that it has no patch
    floor (the card's timings: implicit wins at every kh*kw > 1 shape):
    under auto it also goes implicit where the reference's 1 MiB floor
    keeps a small patch materialized."""
    x = torch.zeros(shape)
    got = ops._pick_implicit(implicit, x, k, k, 1, "SAME", bk=bk)
    want = ref_ops._pick_implicit(implicit, jnp.zeros(shape), k, k, 1,
                                  "SAME", bk=bk)
    below_floor = (implicit is None and k * k > 1
                   and (bk is None or shape[-1] % bk == 0)
                   and ref_ops.patch_bytes(jnp.zeros(shape), k, k, 1,
                                           "SAME") < 1 << 20)
    assert got == (True if below_floor else want)


def test_pick_implicit_has_no_image_cap_and_refuses_straddling():
    """The reference never auto-picks implicit past a TPU core's image
    size; the port gathers from global memory and has no such cap."""
    huge = torch.zeros((1, 600, 600, 128))
    assert ops._pick_implicit(None, huge, 3, 3, 1, "SAME", bk=8)
    with pytest.raises(ValueError, match="straddle"):
        ops._pick_implicit(True, huge, 3, 3, 1, "SAME", bk=48)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("P,Q,k,stride,H,W,padding", [
    (32, 16, 3, 1, 12, 12, "SAME"), (64, 32, 5, 2, 12, 12, "SAME"),
    (32, 16, 1, 1, 12, 12, "SAME"), (32, 16, 3, 2, 12, 12, "SAME"),
    (16, 8, 3, 1, 10, 10, "VALID"), (16, 8, 3, 2, 9, 13, "SAME"),
    (16, 8, 5, 1, 11, 7, "VALID"), (16, 8, 5, 1, 4, 4, "SAME")])
def test_sparse_conv2d_matches_reference(P, Q, k, stride, H, W, padding,
                                         implicit):
    wm, mask = conv_case(P, Q, k, k)
    ref, port = _both_layouts(wm, mask, reorder=True, n_bins=4)
    x, b = _np(6, 2, H, W, Q), _np(7, P)
    want = ref_ops.sparse_conv2d(jnp.asarray(x), ref, kh=k, kw=k,
                                 stride=stride, padding=padding,
                                 bias=jnp.asarray(b), act="relu",
                                 implicit=implicit)
    K.reset_launches()
    got = ops.sparse_conv2d(_t(x), port, kh=k, kw=k, stride=stride,
                            padding=padding, bias=_t(b), act="relu",
                            implicit=implicit)
    assert sum(K.LAUNCHES.values()) == 0        # CPU: plain versions only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("P,Q,k,stride", [(32, 16, 3, 1), (64, 32, 5, 2),
                                          (32, 16, 3, 2), (16, 8, 1, 1)])
def test_implicit_equals_materialized_bitwise(P, Q, k, stride):
    """The implicit plain version gathers through ``conv_taps`` from the
    padded image and sums like the materialized one: equal bits."""
    wm, mask = conv_case(P, Q, k, k)
    _, port = _both_layouts(wm, mask, reorder=True)
    x, b = _t(_np(8, 2, 11, 9, Q)), _t(_np(9, P))
    for act in ("none", "relu", "silu"):
        y_imp = ops.sparse_conv2d(x, port, kh=k, kw=k, stride=stride,
                                  bias=b, act=act, implicit=True)
        y_mat = ops.sparse_conv2d(x, port, kh=k, kw=k, stride=stride,
                                  bias=b, act=act, implicit=False)
        assert torch.equal(y_imp, y_mat)


@pytest.mark.parametrize("implicit", [False, True])
def test_reordered_equals_unreordered_bitwise(implicit):
    wm, mask = conv_case(64, 32, 3, 3, rate=0.7, seed=3)
    x, b = _t(_np(10, 2, 9, 9, 32)), _t(_np(11, 64))
    ys = []
    for kw in ({"reorder": False}, {"reorder": True, "n_bins": 1},
               {"reorder": True, "n_bins": 2},
               {"reorder": True, "n_bins": 4}):
        _, port = _both_layouts(wm, mask, **kw)
        ys.append(ops.sparse_conv2d(x, port, kh=3, kw=3, stride=2, bias=b,
                                    act="relu", implicit=implicit))
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_implicit_never_builds_patches(monkeypatch):
    wm, mask = conv_case(32, 16, 3, 3)
    _, port = _both_layouts(wm, mask)
    x = _t(_np(12, 1, 8, 8, 16))
    y = ops.sparse_conv2d(x, port, kh=3, kw=3, implicit=False)

    def boom(*a, **kw):
        raise AssertionError("patch tensor materialized")
    monkeypatch.setattr(ops, "im2col", boom)
    assert torch.equal(ops.sparse_conv2d(x, port, kh=3, kw=3, implicit=True),
                       y)
    with pytest.raises(AssertionError, match="materialized"):
        ops.sparse_conv2d(x, port, kh=3, kw=3, implicit=False)


def test_implicit_derives_taps_for_a_layout_without_them():
    import dataclasses
    wm, mask = conv_case(32, 16, 3, 3)
    _, port = _both_layouts(wm, mask, reorder=True)
    bare = dataclasses.replace(port, conv_taps=None)
    x = _t(_np(13, 2, 8, 8, 16))
    assert torch.equal(
        ops.sparse_conv2d(x, bare, kh=3, kw=3, implicit=True),
        ops.sparse_conv2d(x, port, kh=3, kw=3, implicit=True))


def test_conv_wrappers_refuse_other_devices_and_bad_shapes():
    wm, mask = conv_case(32, 16, 3, 3)
    ref, _ = _both_layouts(wm, mask)
    meta = layout_from_numpy(ref_to_numpy(ref), "meta")
    x = torch.zeros((1, 8, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.bsr_conv2d_implicit(x, meta, kh=3, kw=3)
    with pytest.raises(ValueError, match="kh\\*kw\\*Cin"):
        ops.sparse_conv2d(torch.zeros(1, 8, 8, 8), meta, kh=3, kw=3)
    # a tap table of another geometry (9 taps as 1x9, not 3x3) is refused
    # before any kernel reads the image at its offsets
    wm, mask = conv_case(32, 16, 1, 9)
    _, lay19 = _both_layouts(wm, mask)
    import dataclasses
    swapped = dataclasses.replace(
        lay19, conv_taps=BCS.conv_tap_table(3, 3, 16, 8))
    with pytest.raises(ValueError, match="conv_taps do not match"):
        ops.sparse_conv2d(torch.zeros(1, 8, 8, 16), swapped, kh=1, kw=9,
                          implicit=True)


# -- whole conv nets, both archs, both mappings --------------------------------

def _ref_net(arch, mapping, keep_dense):
    """The reference's seeded net, masks, compiled params and report."""
    ref_arch = getattr(ref_CN, ARCHS[arch])
    scheme, kw = MAPPINGS[mapping]
    spec = [(CONV_RE, ref_RW.SchemeChoice(scheme, **kw))]
    params = ref_CN.convnet_init(jax.random.PRNGKey(0), ref_arch,
                                 dtype=jnp.float32)
    masks = (ref_RW.punched_conv_masks(params, spec, (8, 8), rate=0.5)
             if mapping == "punched" else ref_RW.masks_for_spec(params, spec))
    pm = ref_apply_masks(params, masks)
    exec_p, report = ref_compile.compile_model(
        pm, masks, spec, spec=ref_compile.CompileSpec(keep_dense=keep_dense))
    return params, masks, pm, exec_p, report


def _port_net(rparams, arch, mapping, keep_dense):
    scheme, kw = MAPPINGS[mapping]
    spec = [(CONV_RE, RW.SchemeChoice(scheme, **kw))]
    params = to_port(rparams)
    masks = (RW.punched_conv_masks(params, spec, (8, 8), rate=0.5)
             if mapping == "punched" else RW.masks_for_spec(params, spec))
    pm = apply_masks(params, masks)
    exec_p, report = C.compile_model(
        pm, masks, spec, spec=C.CompileSpec(keep_dense=keep_dense),
        device="cpu")
    return masks, pm, exec_p, report


_NETS: dict = {}
_REF_LOGITS: dict = {}


def _nets(arch, mapping, keep_dense):
    """Both packages' nets and the reference's logits on one seeded batch,
    built once per case; the reference's interpret-mode forward (the slow
    part) runs once per (arch, mapping), on its keep_dense=True net."""
    key = (arch, mapping, keep_dense)
    if key not in _NETS:
        rparams, rmasks, rpm, rexec, rrep = _ref_net(arch, mapping,
                                                     keep_dense)
        masks, pm, exec_p, rep = _port_net(rparams, arch, mapping,
                                           keep_dense)
        x = _np(14, 2, 16, 16, 3)
        if (arch, mapping) not in _REF_LOGITS:
            ref_arch = getattr(ref_CN, ARCHS[arch])
            _REF_LOGITS[arch, mapping] = np.asarray(ref_CN.convnet_apply(
                rexec, jnp.asarray(x), ref_arch))
        _NETS[key] = dict(rmasks=rmasks, rexec=rexec, rrep=rrep, masks=masks,
                          pm=pm, exec_p=exec_p, rep=rep, x=_t(x),
                          want=_REF_LOGITS[arch, mapping])
    return _NETS[key]


@pytest.mark.parametrize("keep_dense", [True, False])
@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_compile_report_rows_match_reference(arch, mapping, keep_dense):
    n = _nets(arch, mapping, keep_dense)

    def rows(rep):      # jax tree maps sort dict keys: compare by path
        return sorted((r.path, r.packed, r.kind, r.L, r.L_reordered,
                       r.reason, r.patch_b_per_pos) for r in rep)
    assert rows(n["rep"]) == rows(n["rrep"])
    for name, node in n["exec_p"].items():
        assert ("w" in node) == (keep_dense or "packed" not in node)


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_masks_and_layouts_of_the_net_match_reference(arch, mapping):
    n = _nets(arch, mapping, True)
    rmasks = ref_to_numpy(n["rmasks"])
    rexec = n["rexec"]
    for name, node in n["exec_p"].items():
        np.testing.assert_array_equal(n["masks"][name]["w"].numpy(),
                                      rmasks[name]["w"])
        if "packed" in node:
            if mapping == "pattern":
                assert_tap_layout_equal(node["packed"],
                                        rexec[name]["packed"])
            else:
                assert_layout_equal(node["packed"], rexec[name]["packed"])


@pytest.mark.parametrize("keep_dense", [True, False])
@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_convnet_logits_match_reference(arch, mapping, keep_dense):
    """The compiled port net against the reference's compiled net, and
    against the port's own masked-dense run of the same weights."""
    n = _nets(arch, mapping, keep_dense)
    port_arch = getattr(CN, ARCHS[arch])
    got = CN.convnet_apply(n["exec_p"], n["x"], port_arch)
    np.testing.assert_allclose(got.numpy(), n["want"], rtol=TOL, atol=TOL)
    dense = CN.convnet_apply(n["pm"], n["x"], port_arch)
    torch.testing.assert_close(got, dense, rtol=TOL, atol=TOL)
    forced = CN.convnet_apply(n["exec_p"], n["x"], port_arch, implicit=True)
    torch.testing.assert_close(forced, got, rtol=0, atol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dense_convnet_matches_reference(arch):
    """The unpruned net (``F.conv2d`` with XLA's SAME halo, depthwise as a
    grouped conv) and the accuracy helper."""
    ref_arch = getattr(ref_CN, ARCHS[arch])
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(5), ref_arch,
                                  dtype=jnp.float32)
    x = _np(15, 3, 16, 16, 3)
    want = np.asarray(ref_CN.convnet_apply(rparams, jnp.asarray(x),
                                           ref_arch))
    params = to_port(rparams)
    port_arch = getattr(CN, ARCHS[arch])
    got = CN.convnet_apply(params, _t(x), port_arch)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    labels = np.argmax(want, -1)
    labels[0] = (labels[0] + 1) % 10
    acc = CN.accuracy(params, (_t(x), torch.from_numpy(labels)), port_arch)
    assert acc.item() == pytest.approx(2 / 3)


def test_compile_skip_reasons_match_reference():
    """Depthwise, a conv scheme on a 2-D weight, and an indivisible kernel
    block skip with the reference's reasons."""
    rng = np.random.RandomState(16)
    tree = {"dw": {"w": rng.randn(8, 1, 3, 3).astype(np.float32)},
            "fc": {"w": rng.randn(16, 16).astype(np.float32)},
            "c1": {"w": rng.randn(32, 3, 3, 3).astype(np.float32)},
            "pf": {"w": rng.randn(16, 16).astype(np.float32)}}
    mapping = [(r"(dw|fc|c1)/w", ("block_punched", (8, 8))),
               (r"pf/w", ("pattern", (64, 128)))]
    want = ref_compile.compile_model(
        {k: {"w": jnp.asarray(v["w"])} for k, v in tree.items()}, None,
        [(p, ref_RW.SchemeChoice(s, b)) for p, (s, b) in mapping])[1]
    _, got = C.compile_model(
        {k: {"w": _t(v["w"])} for k, v in tree.items()}, None,
        [(p, RW.SchemeChoice(s, b)) for p, (s, b) in mapping],
        device="cpu")
    assert [(r.path, r.packed, r.reason) for r in got] == \
        [(r.path, r.packed, r.reason) for r in want]
    assert "depthwise" in got.rows[0].reason
    assert "implicit_avoids" not in C.compiled_summary(got)


def test_synthetic_images_shape_and_seed():
    g = torch.Generator().manual_seed(0)
    x, y = CN.synthetic_images(g, 5, size=32)
    assert tuple(x.shape) == (5, 32, 32, 3) and x.dtype == torch.float32
    assert tuple(y.shape) == (5,) and int(y.max()) < 10
    x2, y2 = CN.synthetic_images(torch.Generator().manual_seed(0), 5,
                                 size=32)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    xh, _ = CN.synthetic_images(torch.Generator().manual_seed(0), 5,
                                hard=True)
    assert tuple(xh.shape) == (5, 16, 16, 3)


def test_convnet_init_is_seeded_and_scaled():
    a = CN.convnet_init(CN.MOBILE_TINY, seed=1, device="cpu")
    b = CN.convnet_init(CN.MOBILE_TINY, seed=1, device="cpu")
    assert torch.equal(a["c4"]["w"], b["c4"]["w"])
    assert tuple(a["dw2"]["w"].shape) == (32, 1, 3, 3)
    assert tuple(a["c4"]["w"].shape) == (128, 128, 5, 5)
    assert a["c4"]["w"].abs().max() <= 2.0 * (128 * 25) ** -0.5 + 1e-6
    assert tuple(a["fc"]["w"].shape) == (128, 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CN.convnet_init(CN.VGG_TINY)
