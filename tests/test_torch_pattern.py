"""The pattern/connectivity conv path of the port against the reference:
``pattern_mask`` / ``connectivity_mask`` / ``masks_for_spec``, the tap
lowering (``pattern_lower`` / ``pack_taps``) leaf for leaf, the
``TapLayout`` helpers, and ``sparse_conv2d_pattern`` in both x-operand
modes.  In the port, the tap path is bitwise invariant to the binning and
to the mode (every output sums its group's slots in slot order); against
the reference it is held to fp32 tolerance.  The reference runs as its own
tests run it (Pallas kernels in interpret mode)."""
import dataclasses

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
from repro_torch.convert import layout_from_numpy, tensor_from_numpy  # noqa: E402,E501
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import regularity as R  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.core.packed import TapLayout  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from test_torch_reference import (assert_tap_layout_equal,  # noqa: E402
                                  ref_to_numpy, to_port)

TOL = 1e-5        # the reference's own bound (test_pattern_sparse.py:101)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def pattern_case(P, Q, k=3, connectivity=0.0, seed=0):
    """Seeded (w * mask, mask) with the reference's masks: 4-of-9 patterns
    (+ connectivity) on 3x3 kernels, connectivity alone otherwise."""
    w = jnp.asarray(_np(seed, P, Q, k, k, scale=0.1))
    mask = (ref_R.pattern_mask(w, connectivity_rate=connectivity) if k == 3
            else ref_R.connectivity_mask(w, rate=connectivity))
    return np.asarray(w * mask), np.asarray(mask)


def _both(wm, mask, **kw):
    """The reference's TapLayout and the port's of the same weight."""
    ref = ref_ops.pack_taps(wm, mask, use_cache=False, **kw)
    port = ops.pack_taps(_t(wm), _t(mask), **kw)
    return ref, port


# -- masks --------------------------------------------------------------------

def test_pattern_set_matches_reference():
    np.testing.assert_array_equal(R.PATTERN_SET.numpy(),
                                  np.asarray(ref_R.PATTERN_SET))
    assert (R.PATTERN_SET.sum(dim=(1, 2)) == 4).all()


@pytest.mark.parametrize("connectivity", [0.0, 0.3, 0.5])
@pytest.mark.parametrize("P,Q", [(16, 8), (32, 3), (64, 32)])
def test_pattern_mask_matches_reference(P, Q, connectivity):
    w = _np(P + Q, P, Q, 3, 3)
    want = np.asarray(ref_R.pattern_mask(jnp.asarray(w), connectivity))
    got = R.pattern_mask(_t(w), connectivity)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pattern_mask_takes_the_first_best_pattern():
    """A kernel whose magnitude is uniform ties all 8 patterns: the first
    (T-up) wins, as ``jnp.argmax`` picks it."""
    w = torch.ones(2, 2, 3, 3)
    m = R.pattern_mask(w)
    assert torch.equal(m[0, 0], R.PATTERN_SET[0])
    with pytest.raises(ValueError, match="3x3"):
        R.pattern_mask(torch.ones(2, 2, 5, 5))


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("P,Q,k", [(32, 16, 5), (16, 8, 3), (64, 64, 1)])
def test_connectivity_mask_matches_reference(P, Q, k, rate):
    w = _np(k, P, Q, k, k)
    want = np.asarray(ref_R.connectivity_mask(jnp.asarray(w), rate=rate))
    np.testing.assert_array_equal(
        R.connectivity_mask(_t(w), rate=rate).numpy(), want)


@pytest.mark.parametrize("arch,connectivity", [
    ("VGG_TINY", 0.5), ("MOBILE_TINY", 0.5), ("MOBILE_TINY", 0.0)])
def test_masks_for_spec_matches_reference(arch, connectivity):
    """Pattern on 3x3, connectivity on 1x1 / 5x5 (sentinel when
    connectivity is 0), sentinels on unmatched leaves."""
    rparams = ref_CN.convnet_init(jax.random.PRNGKey(7),
                                  getattr(ref_CN, arch), dtype=jnp.float32)
    re_ = r"(^|/)(c|pw|dw)\d+/w"
    want = ref_to_numpy(ref_RW.masks_for_spec(
        rparams, [(re_, ref_RW.SchemeChoice("pattern",
                                            connectivity=connectivity))]))
    got = RW.masks_for_spec(
        to_port(rparams),
        [(re_, RW.SchemeChoice("pattern", connectivity=connectivity))])
    for name, node in want.items():
        for leaf, m in node.items():
            assert got[name][leaf].shape == m.shape, (name, leaf)
            np.testing.assert_array_equal(got[name][leaf].numpy(), m)


def test_masks_for_spec_rate_path_and_refusals():
    w = _np(3, 16, 8, 3, 3)
    tree = {"c1": {"w": w}, "c2": {"w": w}}
    spec = [(r"c1/w", ("block_punched", (8, 8), 0.5)),
            (r"c2/w", ("none", (8, 8), None))]
    want = ref_to_numpy(ref_RW.masks_for_spec(
        {k: {"w": jnp.asarray(v["w"])} for k, v in tree.items()},
        [(p, ref_RW.SchemeChoice(s, b, r)) for p, (s, b, r) in spec]))
    got = RW.masks_for_spec(
        {k: {"w": _t(v["w"])} for k, v in tree.items()},
        [(p, RW.SchemeChoice(s, b, r)) for p, (s, b, r) in spec])
    for name in tree:
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      want[name]["w"])
    # the threshold path: one global threshold over the punched groups.
    # Both packages divide each leaf's group sqnorms by their float32 mean,
    # summed in another order by XLA than by torch (1 ulp apart at most
    # here), so tau agrees to 1e-6 and not bit for bit.  tau is a quantile
    # of those norms: it lands ON one group, whose keep is then a coin
    # flip on the mean's last bit; the masks are compared at the midpoint
    # of the gap above tau instead, where no group ties.
    rspec = [(p, ref_RW.SchemeChoice(s, b, r)) for p, (s, b, r) in spec]
    pspec = [(p, RW.SchemeChoice(s, b, r)) for p, (s, b, r) in spec]
    rtree = {k: {"w": jnp.asarray(v["w"])} for k, v in tree.items()}
    ptree = {k: {"w": _t(v["w"])} for k, v in tree.items()}
    tau = ref_RW.global_threshold(rtree, rspec, 0.5)
    assert RW.global_threshold(ptree, pspec, 0.5) == pytest.approx(
        tau, rel=1e-6)
    g = np.asarray(ref_RW.group_sqnorms(rtree["c1"]["w"],
                                        rspec[0][1])["punch"]).ravel()
    rel = np.sort(g / g.mean())
    mid = float((rel[rel > tau * (1 + 1e-5)][0] + tau) / 2)
    want = ref_to_numpy(ref_RW.masks_for_spec(rtree, rspec, threshold=mid))
    got = RW.masks_for_spec(ptree, pspec, threshold=mid)
    np.testing.assert_array_equal(got["c1"]["w"].numpy(), want["c1"]["w"])
    assert 0 < got["c1"]["w"].mean() < 1 and got["c2"]["w"].ndim == 0


# -- tap lowering -------------------------------------------------------------

@pytest.mark.parametrize("connectivity,group,n_bins,reorder", [
    (0.0, 1, 4, True), (0.5, 1, 4, True), (0.5, 1, 1, True),
    (0.5, 1, 8, True), (0.5, 4, 4, True), (0.5, 4, 8, True),
    (0.5, 1, 4, False), (0.5, 4, 1, False)])
def test_pattern_lower_matches_reference(connectivity, group, n_bins,
                                         reorder):
    """Integer leaves (t_idx, k_full, nnz, alive, perm, inv_perm) equal,
    values bit-equal, the same dense round trip."""
    wm, mask = pattern_case(16, 8, connectivity=connectivity, seed=2)
    ref_lay = ref_BCS.pattern_lower(wm, mask, group=group, n_bins=n_bins,
                                    reorder=reorder)
    port = BCS.pattern_lower(_t(wm), _t(mask), group=group, n_bins=n_bins,
                             reorder=reorder)
    assert_tap_layout_equal(port, ref_lay)
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  ref_lay.to_dense())
    np.testing.assert_array_equal(port.to_dense().numpy(),
                                  ref_BCS.conv_lower(wm))


@pytest.mark.parametrize("P,Q,k,conn", [
    (32, 16, 3, 0.0), (32, 16, 3, 0.5), (64, 32, 5, 0.5), (32, 3, 3, 0.0),
    (64, 64, 1, 0.5)])
@pytest.mark.parametrize("n_bins", [1, 4, 8])
def test_pack_taps_matches_reference(P, Q, k, conn, n_bins):
    wm, mask = pattern_case(P, Q, k, connectivity=conn)
    ref_lay, port = _both(wm, mask, n_bins=n_bins)
    assert_tap_layout_equal(port, ref_lay)


def test_pattern_lower_drops_globally_dead_rows_as_reference():
    wm, mask = pattern_case(8, 8, seed=3)
    mask = mask.copy()
    mask[:, 2] = 0.0                              # channel 2 dead everywhere
    wm = wm * mask
    ref_lay, port = _both(wm, mask)
    assert_tap_layout_equal(port, ref_lay)
    assert port.n_alive <= port.shape[0] - 9
    empty = np.zeros_like(mask)                   # a fully pruned layer
    ref_lay, port = _both(wm * empty, empty)
    assert_tap_layout_equal(port, ref_lay)
    assert port.n_alive == 1 and port.L_max == 1


def test_tap_layout_stats_and_helpers_match_reference():
    wm, mask = pattern_case(64, 32, connectivity=0.5, seed=4)
    ref_lay, port = _both(wm, mask, n_bins=8)
    for attr in ("n_groups", "n_alive", "n_bins", "bin_sizes",
                 "bin_degrees", "L_max", "executed_taps", "nnz_taps"):
        assert getattr(port, attr) == getattr(ref_lay, attr), attr
    for attr in ("L_effective", "flops_saved", "density",
                 "padding_overhead"):
        assert getattr(port, attr) == pytest.approx(getattr(ref_lay, attr))
    b = _np(5, 64)
    for p, r in zip(port.bin_bias(_t(b)), ref_lay.bin_bias(jnp.asarray(b))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(port.permute_bias(_t(b)).numpy(),
                                  np.asarray(ref_lay.permute_bias(
                                      jnp.asarray(b))))
    y = _np(6, 3, 64)
    np.testing.assert_array_equal(
        port.unpermute_cols(_t(y)).numpy(),
        np.asarray(ref_lay.unpermute_cols(jnp.asarray(y))))
    for p, r in zip(port.bin_k_full(), ref_lay.bin_k_full()):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    cols = torch.cat(port.bin_cols)
    assert torch.equal(cols, port.perm)
    bare = dataclasses.replace(port, k_full=None)
    for p, q in zip(bare.bin_k_full(), port.k_full):
        assert torch.equal(p.to(torch.int32), q)


def test_tap_layout_crosses_and_refuses_what_is_not_ported():
    wm, mask = pattern_case(32, 16, connectivity=0.5)
    ref_lay, _ = _both(wm, mask)
    crossed = layout_from_numpy(ref_to_numpy(ref_lay), "cpu")
    assert isinstance(crossed, TapLayout)
    assert_tap_layout_equal(crossed, ref_lay)
    # tensor-parallel tap layouts are ported (tests/test_torch_sharding.py);
    # what both packages refuse is a shard split without the reorder
    with pytest.raises(ValueError, match="reorder"):
        BCS.pattern_lower(_t(wm), _t(mask), n_shards=2, reorder=False)
    with pytest.raises(ValueError, match="reorder"):
        ref_BCS.pattern_lower(wm, mask, n_shards=2, reorder=False)


# -- the tap executors ----------------------------------------------------------

@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("P,Q,k,stride,conn", [
    (32, 16, 3, 1, 0.0), (32, 16, 3, 2, 0.5), (64, 32, 5, 2, 0.5),
    (32, 3, 3, 1, 0.0), (32, 16, 1, 1, 0.5)])
def test_sparse_conv2d_pattern_matches_reference(P, Q, k, stride, conn,
                                                 implicit):
    wm, mask = pattern_case(P, Q, k, connectivity=conn)
    ref_lay, port = _both(wm, mask, n_bins=4)
    x, b = _np(1, 2, 11, 9, Q), _np(7, P)
    want = ref_ops.sparse_conv2d_pattern(
        jnp.asarray(x), ref_lay, kh=k, kw=k, stride=stride,
        bias=jnp.asarray(b), act="relu", implicit=implicit)
    K.reset_launches()
    got = ops.sparse_conv2d_pattern(_t(x), port, kh=k, kw=k, stride=stride,
                                    bias=_t(b), act="relu",
                                    implicit=implicit)
    assert sum(K.LAUNCHES.values()) == 0        # CPU: plain versions only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_tap_gather_matches_reference_kernel_per_bin():
    """One bin of the materialized tap kernel: the port's plain version
    against the reference's Pallas kernel on the same band."""
    wm, mask = pattern_case(32, 16, connectivity=0.5, seed=8)
    ref_lay, port = _both(wm, mask, n_bins=2)
    band = _np(9, 40, port.n_alive)
    for b_idx in range(port.n_bins):
        bias = _np(10 + b_idx, port.bin_sizes[b_idx])
        want = ref_bsr.tap_gather_conv(
            jnp.asarray(band), ref_lay.values[b_idx], ref_lay.t_idx[b_idx],
            bias=jnp.asarray(bias), act="silu")
        got = ref.tap_gather_ref(_t(band), port.values[b_idx],
                                 port.t_idx[b_idx], bias=_t(bias),
                                 act="silu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("P,Q,k,stride,conn", [
    (32, 16, 3, 1, 0.0), (32, 16, 3, 2, 0.5), (64, 32, 5, 2, 0.5),
    (32, 16, 1, 1, 0.5)])
def test_implicit_equals_materialized_bitwise(P, Q, k, stride, conn):
    wm, mask = pattern_case(P, Q, k, connectivity=conn)
    _, port = _both(wm, mask)
    x, b = _t(_np(11, 2, 11, 9, Q)), _t(_np(12, P))
    for act in ("none", "relu", "silu"):
        assert torch.equal(
            ops.sparse_conv2d_pattern(x, port, kh=k, kw=k, stride=stride,
                                      bias=b, act=act, implicit=True),
            ops.sparse_conv2d_pattern(x, port, kh=k, kw=k, stride=stride,
                                      bias=b, act=act, implicit=False))


@pytest.mark.parametrize("implicit", [False, True])
def test_bin_count_and_reorder_are_bitwise_invariant(implicit):
    """The cases the reference fails (``test_pattern_sparse.py``
    ``reorder_bit_identity[4]`` and ``default_bins_shrink_connectivity_
    padding``) hold bitwise in the port: unreordered == 1, 2, 4 and 8
    bins."""
    wm, mask = pattern_case(128, 64, connectivity=0.5, seed=9)
    x, b = _t(_np(13, 2, 9, 9, 64)), _t(_np(14, 128))
    lays = [ops.pack_taps(_t(wm), _t(mask), reorder=False)]
    lays += [ops.pack_taps(_t(wm), _t(mask), n_bins=n) for n in (1, 2, 4, 8)]
    assert lays[-1].padding_overhead < lays[3].padding_overhead
    ys = [ops.sparse_conv2d_pattern(x, lay, kh=3, kw=3, stride=2, bias=b,
                                    act="relu", implicit=implicit)
          for lay in lays]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_tap_wrappers_refuse_other_devices_and_bad_shapes():
    wm, mask = pattern_case(32, 16, connectivity=0.5)
    ref_lay, port = _both(wm, mask)
    meta = layout_from_numpy(ref_to_numpy(ref_lay), "meta")
    band = torch.zeros((4, meta.n_alive), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.tap_gather_conv_packed(band, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        K.tap_gather_conv_implicit(torch.zeros((1, 8, 8, 16),
                                               device="meta"), meta,
                                   kh=3, kw=3)
    with pytest.raises(ValueError, match="alive rows"):
        K.tap_gather_conv_packed(torch.zeros((4, port.n_alive + 1)), port)
    with pytest.raises(ValueError, match="kh\\*kw\\*Cin"):
        ops.sparse_conv2d_pattern(torch.zeros((1, 8, 8, 8)), port, kh=3,
                                  kw=3)
