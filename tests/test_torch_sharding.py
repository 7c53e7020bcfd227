"""Tensor-parallel layouts of the port (``n_shards``, ``CompileSpec.tp``,
the shard wrappers of ``kernels.bsr_matmul``) against the reference's, on
the CPU: the green cases of the reference's ``tests/test_sharding.py``
(its mesh placement and tensor-parallel engine need several devices:
the port's run across gloo ranks in ``tests/test_torch_dist_exec.py``),
each run on the same numpy inputs in both packages, S in {2, 4}.

- layouts (block and tap, float and int8) equal the reference's leaf for
  leaf: integer leaves equal, values bit-equal;
- the port's sharded plain outputs are bit-equal to its unsharded ones
  and within fp32-accumulation tolerance of the reference's sharded
  outputs (the pattern conv too: the reference's tap path is not
  bin-invariant, ROADMAP queue 3);
- ``shard_columns`` / ``shard_balance`` equal the reference's;
- ``compile_model`` at tp = 2 and 4 of yi-9b and mixtral-8x7b SMOKE gives
  the reference's report rows (``shards``, the moe exemption, the
  non-dividing fallback), digest and greedy tokens;
- sharded stores cross between the packages; ``core.validate`` rejects
  every cross-shard corruption with the reference's class.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bcs as ref_BCS  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.core import validate as ref_V  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro.serve import artifacts as ref_ART  # noqa: E402
from repro.serve import compile as ref_C  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.serve import artifacts as ART  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_reference import (assert_layout_equal,  # noqa: E402
                                  assert_tap_layout_equal, to_port)

SHARDS = (2, 4)
ATOL = RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_fixture(seed=0, K=64, N=128, bk=8, bn=8, keep=0.5):
    rng = _rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    mask = np.kron(rng.random((K // bk, N // bn)) < keep,
                   np.ones((bk, bn), bool))
    return w, mask, (bk, bn)


def _skewed_block_fixture(seed=0, K=128, N=256, bk=8, bn=8):
    """A few dense block columns and a long sparse tail."""
    rng = _rng(seed)
    Kb, Nb = K // bk, N // bn
    mb = np.zeros((Kb, Nb), bool)
    for j in range(Nb):
        deg = Kb if j % 8 == 0 else 1 + int(rng.integers(0, 3))
        mb[rng.permutation(Kb)[:deg], j] = True
    w = rng.standard_normal((K, N)).astype(np.float32)
    return w, np.kron(mb, np.ones((bk, bn), bool)), (bk, bn)


def _conv_fixture(seed=0, P=16, Q=8, k=3):
    rng = _rng(seed)
    w = rng.standard_normal((P, Q, k, k)).astype(np.float32)
    mask = rng.random((P, Q, k, k)) < 0.4
    mask[0] = True
    return w, mask


def _both_packs(w, mask, block, S, **kw):
    """(port layout, reference layout) of the same weight."""
    return (ops.pack(_t(w), _t(mask), block, n_shards=S, **kw),
            ref_ops.pack(w, mask, block, n_shards=S, use_cache=False, **kw))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# -- layouts and parity with the unsharded oracle ----------------------------

class TestShardedParity:
    @pytest.mark.parametrize("S", SHARDS)
    @pytest.mark.parametrize("value_dtype", [None, "int8"])
    def test_layouts_equal_reference(self, S, value_dtype):
        """Block layouts leaf for leaf (the shard axis in front of each
        bin's, the cross-shard padding, perm (S, Nb_s), flat inv_perm)."""
        w, mask, block = _block_fixture(seed=S)
        port, ref = _both_packs(w, mask, block, S, value_dtype=value_dtype)
        assert port.n_shards == S and port.perm.shape == (S, port.Nb // S)
        assert port.inv_perm.shape == (port.Nb,)
        assert_layout_equal(port, ref)
        assert port.executed_blocks == ref.executed_blocks
        assert port.Nb_shard == ref.Nb_shard
        assert port.shard_balance == ref.shard_balance

    @pytest.mark.parametrize("S", SHARDS)
    def test_tap_layouts_equal_reference(self, S):
        w, mask = _conv_fixture(seed=10 + S)
        port = ops.pack_taps(_t(w), _t(mask), n_shards=S)
        ref = ref_ops.pack_taps(w, mask, n_shards=S, use_cache=False)
        assert_tap_layout_equal(port, ref)
        assert port.n_groups_shard == ref.n_groups_shard
        assert port.executed_taps == ref.executed_taps
        assert port.shard_balance == ref.shard_balance

    @pytest.mark.parametrize("S", SHARDS)
    def test_linear_bit_identical(self, S):
        """Sharded ``sparse_linear`` == unsharded bitwise (bias + silu),
        and within fp32 tolerance of the reference's sharded output."""
        w, mask, block = _block_fixture()
        x = _rng(1).standard_normal((4, w.shape[0])).astype(np.float32)
        bias = _rng(2).standard_normal(w.shape[1]).astype(np.float32)
        port, ref = _both_packs(w, mask, block, S)
        unsharded = ops.pack(_t(w), _t(mask), block, reorder=True)
        got = ops.sparse_linear(_t(x), packed=port, bias=_t(bias),
                                act="silu")
        want = ops.sparse_linear(_t(x), packed=unsharded, bias=_t(bias),
                                 act="silu")
        assert torch.equal(got, want)
        _close(got, ref_ops.sparse_linear(jnp.asarray(x), packed=ref,
                                          bias=jnp.asarray(bias),
                                          act="silu"))

    @pytest.mark.parametrize("S", SHARDS)
    def test_linear_int8_bit_identical(self, S):
        w, mask, block = _block_fixture(seed=3)
        x = _rng(4).standard_normal((3, w.shape[0])).astype(np.float32)
        port, ref = _both_packs(w, mask, block, S, value_dtype="int8")
        unsharded = ops.pack(_t(w), _t(mask), block, reorder=True,
                             value_dtype="int8")
        got = ops.sparse_linear(_t(x), packed=port)
        assert torch.equal(got, ops.sparse_linear(_t(x), packed=unsharded))
        _close(got, ref_ops.sparse_linear(jnp.asarray(x), packed=ref))

    @pytest.mark.parametrize("S", SHARDS)
    def test_conv_bit_identical(self, S):
        """The materialized BCS conv over a sharded layout (im2col, then
        the shard wrapper) == the unsharded materialized conv bitwise;
        ``implicit=True`` on a sharded layout raises."""
        w, mask = _conv_fixture()
        wl, ml = BCS.conv_lower(_t(w)), BCS.conv_lower(_t(mask))
        gemm_block, _ = BCS.conv_gemm_block((4, 4), w.shape)
        x = _rng(5).standard_normal((2, 10, 10, w.shape[1])).astype(
            np.float32)
        kh, kw = w.shape[2:]
        conv = (kh, kw, w.shape[1])
        lay = ops.pack(wl, ml, gemm_block, n_shards=S, conv=conv)
        want = ops.sparse_conv2d(
            _t(x), ops.pack(wl, ml, gemm_block, reorder=True, conv=conv),
            kh=kh, kw=kw, implicit=False)
        got = ops.sparse_conv2d(_t(x), lay, kh=kh, kw=kw)
        assert torch.equal(got, want)
        rlay = ref_ops.pack(ref_BCS.conv_lower(w), ref_BCS.conv_lower(mask),
                            gemm_block, n_shards=S, conv=conv,
                            use_cache=False)
        assert_layout_equal(lay, rlay)
        _close(got, ref_ops.sparse_conv2d(jnp.asarray(x), rlay, kh=kh,
                                          kw=kw))
        with pytest.raises(ValueError, match="sharded"):
            ops.sparse_conv2d(_t(x), lay, kh=kh, kw=kw, implicit=True)

    @pytest.mark.parametrize("S", SHARDS)
    def test_pattern_conv_bit_identical(self, S):
        """The tap conv over a sharded TapLayout == unsharded bitwise in
        the port; the reference's to a tolerance (its tap path is not
        bin-invariant)."""
        w, mask = _conv_fixture(seed=6)
        x = _rng(7).standard_normal((2, 9, 9, w.shape[1])).astype(
            np.float32)
        kh, kw = w.shape[2:]
        lay = ops.pack_taps(_t(w), _t(mask), n_shards=S)
        got = ops.sparse_conv2d_pattern(_t(x), lay, kh=kh, kw=kw)
        want = ops.sparse_conv2d_pattern(_t(x), ops.pack_taps(_t(w),
                                                              _t(mask)),
                                         kh=kh, kw=kw)
        assert torch.equal(got, want)
        ref = ref_ops.sparse_conv2d_pattern(
            jnp.asarray(x), ref_ops.pack_taps(w, mask, n_shards=S,
                                              use_cache=False), kh=kh, kw=kw)
        _close(got, ref)
        with pytest.raises(ValueError, match="sharded"):
            ops.sparse_conv2d_pattern(_t(x), lay, kh=kh, kw=kw,
                                      implicit=True)

    @pytest.mark.parametrize("S", SHARDS)
    def test_to_dense_roundtrip(self, S):
        w, mask, block = _block_fixture(seed=9)
        pl = ops.pack(_t(w), _t(mask), block, n_shards=S)
        assert torch.equal(pl.to_dense(), _t(w * mask))
        wc, mc = _conv_fixture(seed=10)
        tl = ops.pack_taps(_t(wc), _t(mc), n_shards=S)
        assert torch.equal(tl.to_dense(),
                           BCS.conv_lower(_t(wc)) * BCS.conv_lower(_t(mc)))

    @pytest.mark.parametrize("S", SHARDS)
    def test_bias_and_merge_equal_reference(self, S):
        """``permute_bias`` / ``bin_bias`` give (S, ...) slices and
        ``merge_shards`` undoes the shard-major order, as the
        reference's."""
        w, mask, block = _block_fixture(seed=11)
        port, ref = _both_packs(w, mask, block, S)
        b = _rng(3).standard_normal(w.shape[1]).astype(np.float32)
        np.testing.assert_array_equal(port.permute_bias(_t(b)).numpy(),
                                      np.asarray(ref.permute_bias(
                                          jnp.asarray(b))))
        for p, r in zip(port.bin_bias(_t(b)), ref.bin_bias(jnp.asarray(b))):
            np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        y = _rng(4).standard_normal((S, 3, w.shape[1] // S)).astype(
            np.float32)
        np.testing.assert_array_equal(port.merge_shards(_t(y)).numpy(),
                                      np.asarray(ref.merge_shards(
                                          jnp.asarray(y))))

    def test_column_sharding_never_reaches_expert_kernel(self):
        """An expert stack is never column-sharded: a sharded stack given
        to ``sparse_expert_linear`` raises, as the reference asserts."""
        w, mask, block = _block_fixture()
        pk = ops.pack(_t(w), _t(mask), block, n_shards=2)

        def stack(t):
            return None if t is None else torch.stack([t, t])
        stacked = dataclasses.replace(
            pk, values=tuple(stack(v) for v in pk.values),
            k_idx=tuple(stack(k) for k in pk.k_idx), nnz=stack(pk.nnz),
            perm=stack(pk.perm), inv_perm=stack(pk.inv_perm))
        x = torch.zeros((2, 3, w.shape[0]))
        with pytest.raises(ValueError, match="expert"):
            ops.sparse_expert_linear(x, stacked)
        with pytest.raises(ValueError, match="stack dims"):
            K.bsr_matmul_sharded(x[0], stacked)
        rpk = ref_ops.pack(w, mask, block, n_shards=2, use_cache=False)
        rstacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), rpk)
        with pytest.raises(AssertionError, match="expert"):
            ref_ops.sparse_expert_linear(jnp.zeros((2, 3, w.shape[0])),
                                         rstacked)


# -- degree-balanced shard assignment ----------------------------------------

class TestShardBalance:
    @pytest.mark.parametrize("S", SHARDS)
    def test_shard_columns_equal_reference(self, S):
        w, mask, block = _skewed_block_fixture(seed=11)
        cnt = mask[::block[0], ::block[1]].sum(axis=0).astype(np.int64)
        got = BCS.shard_columns(cnt, S)
        want = ref_BCS.shard_columns(cnt, S)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        loads = cnt[got].sum(axis=1)
        assert loads.max() <= loads.mean() + cnt.max()   # the LPT bound

    @pytest.mark.parametrize("S", SHARDS)
    def test_skewed_fixture_within_gate(self, S):
        """The straggler factor on the skewed fixture: within 1.15, never
        worse than contiguous column chunks, the reference's value."""
        w, mask, block = _skewed_block_fixture(seed=12)
        port, ref = _both_packs(w, mask, block, S)
        assert port.shard_balance == ref.shard_balance <= 1.15
        cnt = mask[::block[0], ::block[1]].sum(axis=0)
        naive = cnt.reshape(S, -1).sum(axis=1)
        assert port.shard_balance <= naive.max() / naive.mean() + 1e-9
        assert BCS.shard_balance(port.nnz, port.bin_sizes) == \
            ref_BCS.shard_balance(np.asarray(ref.nnz), ref.bin_sizes)

    def test_shard_columns_rejects_bad_counts(self):
        for S, msg in ((3, "divide"), (0, ">= 1")):
            with pytest.raises(ValueError, match=msg):
                BCS.shard_columns(np.ones(10, np.int64), S)
            with pytest.raises(ValueError, match=msg):
                ref_BCS.shard_columns(np.ones(10, np.int64), S)

    def test_equal_shard_widths(self):
        w, mask, block = _skewed_block_fixture(seed=13)
        for S in SHARDS:
            pl = ops.pack(_t(w), _t(mask), block, n_shards=S)
            assert tuple(pl.perm.shape) == (S, pl.Nb // S)
            assert torch.equal(torch.sort(pl.perm.reshape(-1)).values,
                               torch.arange(pl.Nb, dtype=torch.int32))


# -- compile_model at tp > 1 -------------------------------------------------

def _smoke(arch):
    """(reference cfg, port cfg, reference masked fp32 params, masks)."""
    rcfg = ref_configs.get(arch, smoke=True)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        ref_T.init_lm(jax.random.PRNGKey(0), rcfg))
    masks = ref_RW.magnitude_block_masks(params, REF_SPEC, None, rate=0.6)
    return rcfg, configs.get(arch, smoke=True), \
        ref_apply_masks(params, masks), masks


def _rows(report):
    return sorted(json.dumps(r.to_json(), sort_keys=True) for r in report)


@pytest.mark.parametrize("arch,tp", [("yi-9b", 2), ("yi-9b", 4),
                                     ("mixtral-8x7b", 2)])
def test_compile_tp_matches_reference(arch, tp):
    """Report rows equal as sets (``shards``; moe/ paths exempt; at tp = 4
    wk / wv, of 2 block columns, stay unsharded), every layout leaf for
    leaf, the digest, and (tp = 2) the greedy tokens."""
    rcfg, pcfg, rpm, rmasks = _smoke(arch)
    rspec = ref_C.CompileSpec(keep_dense=False, tp=tp)
    pspec = C.CompileSpec(keep_dense=False, tp=tp)
    rexec, rrep = ref_C.compile_model(rpm, rmasks, REF_SPEC, spec=rspec)
    ppm, pmasks = to_port(rpm), to_port(rmasks)
    pexec, prep = C.compile_model(ppm, pmasks, SPARSE_SPEC, spec=pspec,
                                  device="cpu")
    assert _rows(prep) == _rows(rrep)
    shards = {r.path: r.shards for r in prep.packed}
    assert tp in shards.values()
    assert all(s is None for p, s in shards.items() if "/moe/" in p)
    if tp == 4:
        assert shards["layers/attn/wk/w"] is None
    assert ("tp=%d" % tp) in C.compiled_summary(prep)
    for r in prep.packed:
        g, n = r.path.split("/")[1:3]
        assert_layout_equal(pexec["layers"][g][n]["packed"],
                            rexec["layers"][g][n]["packed"])
    assert ART.model_digest(ppm, pmasks, SPARSE_SPEC, spec=pspec) == \
        ref_ART.model_digest(rpm, rmasks, REF_SPEC, spec=rspec)
    if tp == 2:
        prompts = np.random.RandomState(0).randint(1, rcfg.vocab, (2, 8))
        want = np.asarray(ref_engine.generate(
            rexec, rcfg, jnp.asarray(prompts, jnp.int32), 4))
        got = engine.generate(pexec, pcfg, prompts, 4, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


# -- the artifact store ------------------------------------------------------

SMALL_SPEC = [(r"ffn/(gate|up)/w", ref_RW.SchemeChoice("block", (16, 16)))]


def _small_model():
    params = {"blk": {"ffn": {
        "gate": {"w": jax.random.normal(jax.random.PRNGKey(0), (64, 96),
                                        jnp.float32)},
        "up": {"w": jax.random.normal(jax.random.PRNGKey(1), (64, 96),
                                      jnp.float32)}}}}
    masks = ref_RW.random_block_masks(params, SMALL_SPEC, (16, 16),
                                      keep_prob=0.4)
    return ref_apply_masks(params, masks), masks


def _port_spec():
    from repro_torch.core import reweighted as RW
    return [(r"ffn/(gate|up)/w", RW.SchemeChoice("block", (16, 16)))]


class TestShardedArtifacts:
    def test_roundtrip_preserves_shards(self, tmp_path, monkeypatch):
        """A tp = 2 store warm-starts with its shards and no packing
        (``pack_csc_reordered`` counted), decoding bit-identically."""
        pm, masks = _small_model()
        ppm, pmasks = to_port(pm), to_port(masks)
        cs = C.CompileSpec(tp=2)
        e1, _ = C.compile_model(ppm, pmasks, _port_spec(), spec=cs,
                                device="cpu", artifact_dir=tmp_path)
        calls = []
        real = BCS.pack_csc_reordered
        monkeypatch.setattr(BCS, "pack_csc_reordered",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        e2, _ = C.compile_model(ppm, pmasks, _port_spec(), spec=cs,
                                device="cpu", artifact_dir=tmp_path)
        assert calls == []
        pk1 = e1["blk"]["ffn"]["gate"]["packed"]
        pk2 = e2["blk"]["ffn"]["gate"]["packed"]
        assert pk1.n_shards == pk2.n_shards == 2
        assert V.validate_tree(e2) == 2
        x = torch.randn(3, 64, generator=torch.Generator().manual_seed(2))
        assert torch.equal(ops.sparse_linear(x, packed=pk1),
                           ops.sparse_linear(x, packed=pk2))

    @pytest.mark.parametrize("tp", SHARDS)
    def test_stores_cross_between_the_packages(self, tmp_path, tp):
        """A tp store written by either package loads in the other, leaf
        for leaf, with the same report rows (tp = 4 falls back to
        unsharded layouts in both)."""
        pm, masks = _small_model()
        ppm, pmasks = to_port(pm), to_port(masks)
        rspec, pspec = ref_C.CompileSpec(tp=tp), C.CompileSpec(tp=tp)
        rdir, pdir = tmp_path / "ref", tmp_path / "port"
        ref_C.compile_model(pm, masks, SMALL_SPEC, spec=rspec,
                            artifact_dir=rdir)
        C.compile_model(ppm, pmasks, _port_spec(), spec=pspec, device="cpu",
                        artifact_dir=pdir)
        key = ART.model_digest(ppm, pmasks, _port_spec(), spec=pspec)
        assert key == ref_ART.model_digest(pm, masks, SMALL_SPEC, spec=rspec)
        for d in (rdir, pdir):
            port_layers, port_rep = ART.load_artifact(d, key, device="cpu")
            ref_layers, ref_rep = ref_ART.load_artifact(d, key)
            assert list(port_layers) == list(ref_layers)
            for lpath, lay in port_layers.items():
                # 6 block columns: tp = 4 does not divide them
                assert lay.n_shards == (tp if lay.Nb % tp == 0 else 0)
                assert_layout_equal(lay, ref_layers[lpath])
            assert _rows(port_rep) == _rows(ref_rep)
            assert port_rep.spec == pspec

    def test_tp_in_model_digest(self):
        assert C.CompileSpec(tp=1).digest_fields() != \
            C.CompileSpec(tp=2).digest_fields()
        assert C.CompileSpec(tp=2) == C.CompileSpec(tp=2)
        with pytest.raises(ValueError, match=">= 1"):
            C.CompileSpec(tp=0)


# -- cross-shard invariants ---------------------------------------------------

def _cases():
    w, mask, block = _block_fixture(seed=17)
    wc, mc = _conv_fixture(seed=18)
    return {"packed": (ops.pack(_t(w), _t(mask), block, n_shards=2),
                       ref_ops.pack(w, mask, block, n_shards=2,
                                    use_cache=False)),
            "tap": (ops.pack_taps(_t(wc), _t(mc), n_shards=2),
                    ref_ops.pack_taps(wc, mc, n_shards=2, use_cache=False))}


def _swap_01(a):
    a = np.array(a)
    a[0], a[1] = a[1].copy(), a[0].copy()
    return a


def _dup_col(a):
    a = np.array(a)
    a[0, 0] = a[1, 0]
    return a


# (case, which layouts, the corruption as replace() kwargs built from a
# layout: fn(layout, to) with ``to`` turning numpy into that package's
# array)
CORRUPTIONS = [
    ("nondividing_shard_count", ("packed",),
     lambda lay, to: {"n_shards": 3}),
    ("nondividing_shard_count_tap", ("tap",),
     lambda lay, to: {"n_shards": 7}),
    ("missing_shard_axis_on_values", ("packed", "tap"),
     lambda lay, to: {"values": tuple(v[0] for v in lay.values)}),
    ("nnz_without_shard_axes", ("packed", "tap"),
     lambda lay, to: {"nnz": lay.nnz.reshape(-1)}),
    ("sharded_requires_perm", ("packed", "tap"),
     lambda lay, to: {"perm": None, "inv_perm": None}),
    ("flat_perm", ("packed",),
     lambda lay, to: {"perm": lay.perm.reshape(-1)}),
    ("cross_shard_duplicate_column", ("packed", "tap"),
     lambda lay, to: {"perm": to(_dup_col(lay.perm))}),
    ("inconsistent_inv_perm", ("packed",),
     lambda lay, to: {"inv_perm": to(_swap_01(lay.inv_perm))}),
    ("wrong_shard_count_aux", ("packed",),
     lambda lay, to: {"n_shards": 4}),
]


class TestValidateSharded:
    def test_sharded_layouts_validate(self):
        for port, ref in _cases().values():
            assert V.validate_layout(port) is port
            ref_V.validate_layout(ref)

    @pytest.mark.parametrize("name,kinds,corrupt", CORRUPTIONS,
                             ids=[c[0] for c in CORRUPTIONS])
    def test_corruption_raises_the_references_class(self, name, kinds,
                                                    corrupt):
        for kind, (port, ref) in _cases().items():
            if kind not in kinds:
                continue
            with pytest.raises(ref_V.LayoutError) as ri:
                ref_V.validate_layout(dataclasses.replace(
                    ref, **corrupt(ref, jnp.asarray)))
            with pytest.raises(V.LayoutError) as pi:
                V.validate_layout(dataclasses.replace(
                    port, **corrupt(port, _t)), path="lyr")
            assert pi.value.code == ri.value.code, (kind, name)
            assert pi.value.field == ri.value.field, (kind, name)
            assert pi.value.bin == ri.value.bin, (kind, name)

    def test_validate_tree_finds_sharded_layouts(self):
        packed, _ = _cases()["packed"]
        tree = {"a": {"packed": packed},
                "b": {"packed": dataclasses.replace(
                    packed, nnz=packed.nnz.reshape(-1))}}
        with pytest.raises(V.LayoutStructureError, match="b"):
            V.validate_tree(tree)
        assert V.validate_tree({"a": {"packed": packed}}) == 1

    def test_references_int8_sharded_tap_scales_do_not_validate(self):
        """A fault of the reference (ROADMAP queue 3): its int8 "out"
        scales of a sharded TapLayout come out (S, 1, G_b, group), which
        its own validator rejects; the port's are (S, G_b, 1, group) and
        validate."""
        wc, mc = _conv_fixture(seed=19)
        ref = ref_ops.pack_taps(wc, mc, n_shards=2, value_dtype="int8",
                                scale_granularity="out", use_cache=False)
        assert np.shape(ref.scales[0])[1] == 1
        with pytest.raises(ref_V.LayoutQuantError):
            ref_V.validate_layout(ref)
        port = ops.pack_taps(_t(wc), _t(mc), n_shards=2, value_dtype="int8",
                             scale_granularity="out")
        assert port.scales[0].shape[-2] == 1
        V.validate_layout(port)
        np.testing.assert_array_equal(
            port.scales[0].numpy(),
            np.moveaxis(np.asarray(ref.scales[0]), 1, 2))
