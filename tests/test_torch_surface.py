"""The last of the reference's public surface in the port, against the
reference on the CPU:

- ``core.bcs``'s BCS format (``from_dense`` and its loop, ``to_dense``,
  ``pad_to_uniform(_csc)`` and the loop, ``load_imbalance``, the index
  byte counts), equal to the reference's exactly over a sweep of blocks,
  zero fractions and seeds;
- kernels 1's and 2's raw entries (``bsr_matmul``, ``tap_gather_conv``):
  their plain routes against the reference's kernels in interpret mode,
  float and int8 under both scale shapes, and ``out_dtype``;
- the content-keyed pack cache of ``kernels.ops``: hits, what keeps keys
  apart, the bounds, the eviction log, its environment variables;
- ``serve.compile.resolve_spec`` and the historical compile keywords, and
  ``model_digest`` under both spellings;
- ``generate_python``'s sampling branch against ``generate``;
- ``models.module``'s tree helpers against the reference's;
- the surface check: every top-level ``def`` or ``class`` of each module
  of ``src/repro/`` has a namesake in the port's module of the same path,
  or stands in ``NO_COUNTERPART`` with its reason (the reference is read
  with ``ast``, not imported).
"""
import ast
import logging
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st  # noqa: E402
except ImportError:          # clean container: deterministic example sweep
    from _hypothesis_fallback import given, settings, st  # noqa: E402

from repro.core import bcs as ref_BCS  # noqa: E402
from repro.core import reweighted as ref_RW  # noqa: E402
from repro.kernels import bsr_matmul as ref_K  # noqa: E402
from repro.launch.serve import SPARSE_SPEC as REF_SPEC  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.serve import artifacts as ref_ART  # noqa: E402
from repro.serve import compile as ref_C  # noqa: E402
from repro.train.trainer import apply_masks as ref_apply_masks  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import bcs as BCS  # noqa: E402
from repro_torch.core import reweighted as RW  # noqa: E402
from repro_torch.core import validate as V  # noqa: E402
from repro_torch.kernels import bsr_matmul as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import SPARSE_SPEC  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import artifacts as ART  # noqa: E402
from repro_torch.serve import compile as C  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.testing import faults as FAULTS  # noqa: E402
from repro_torch.train.trainer import apply_masks  # noqa: E402

from test_torch_reference import (block_case, ref_smoke_params,  # noqa: E402
                                  to_port)

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-5          # rtol = atol, plain route vs reference kernel


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- core.bcs: the BCS format -------------------------------------------------

def _bcs_case(K, N, bk, bn, zero_frac, seed):
    """(w, mask): whole dead blocks at ``zero_frac`` plus scattered zeros
    inside live blocks."""
    rng = np.random.RandomState(seed)
    w = rng.randn(K, N).astype(np.float32)
    keep = rng.rand(K // bk, N // bn) >= zero_frac
    mask = np.repeat(np.repeat(keep, bk, 0), bn, 1).astype(np.float32)
    mask *= rng.rand(K, N) > 0.2
    return w, mask


def _assert_bcs_equal(port, ref):
    assert port.shape == tuple(ref.shape) and port.block == tuple(ref.block)
    assert port.values.dtype == torch.float32
    np.testing.assert_array_equal(port.values.numpy(), ref.values)
    for name in ("col_idx", "row_ptr", "occurrence"):
        p, r = getattr(port, name), getattr(ref, name)
        assert p.dtype == torch.int32 and r.dtype == np.int32, name
        np.testing.assert_array_equal(p.numpy(), r)
    assert len(port.patterns) == len(ref.patterns)
    for p, r in zip(port.patterns, ref.patterns):
        np.testing.assert_array_equal(p.numpy(), r)
    assert port.nnzb == ref.nnzb and port.density == ref.density
    assert port.index_bytes() == ref.index_bytes()
    assert port.csr_index_bytes() == ref.csr_index_bytes()
    assert BCS.load_imbalance(port) == ref_BCS.load_imbalance(ref)


def _assert_arrays_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.numpy().dtype == r.dtype and p.shape == r.shape
        np.testing.assert_array_equal(p.numpy(), r)


@settings(max_examples=15, deadline=None)
@given(bk=st.sampled_from([16, 32]), bn=st.sampled_from([32, 64]),
       zf=st.floats(0, 0.9), seed=st.integers(0, 30))
def test_bcs_matches_reference(bk, bn, zf, seed):
    w, mask = _bcs_case(128, 256, bk, bn, zf, seed)
    ref = ref_BCS.from_dense(w, mask, (bk, bn))
    for make in (BCS.from_dense, BCS.from_dense_loop):
        port = make(_t(w), _t(mask), (bk, bn))
        _assert_bcs_equal(port, ref)
        np.testing.assert_array_equal(BCS.to_dense(port).numpy(),
                                      ref_BCS.to_dense(ref))
        _assert_arrays_equal(BCS.pad_to_uniform(port),
                             ref_BCS.pad_to_uniform(ref))
        _assert_arrays_equal(BCS.pad_to_uniform_csc(port),
                             ref_BCS.pad_to_uniform_csc(ref))
        _assert_arrays_equal(BCS.pad_to_uniform_csc_loop(port),
                             ref_BCS.pad_to_uniform_csc_loop(ref))


@pytest.mark.parametrize("case", ["empty", "full", "repeated_rows"])
def test_bcs_edge_masks_match_reference(case):
    """No live block, every block live, and every row one pattern (the
    hierarchical index then beats plain CSR, Fig 4's point)."""
    w, _ = _bcs_case(128, 256, 32, 64, 0.0, 1)
    mask = {"empty": np.zeros_like(w), "full": np.ones_like(w)}.get(case)
    if mask is None:
        mask = np.zeros_like(w)
        mask[:, :64] = mask[:, 128:192] = 1.0
    ref = ref_BCS.from_dense(w, mask, (32, 64))
    port = BCS.from_dense(_t(w), _t(mask), (32, 64))
    _assert_bcs_equal(port, ref)
    _assert_arrays_equal(BCS.pad_to_uniform_csc(port),
                         ref_BCS.pad_to_uniform_csc(ref))
    _assert_arrays_equal(BCS.pad_to_uniform(port),
                         ref_BCS.pad_to_uniform(ref))
    if case == "repeated_rows":
        assert len(port.patterns) == 1
        assert port.index_bytes() < port.csr_index_bytes()


def test_padded_csc_degree_against_the_reordered_layout():
    """``pad_to_uniform_csc`` pads every column to L_max, the binned layout
    of the same weight each bin to its own max; its columns hold the same
    slots (the raw entry's bitwise claim rests on that)."""
    w, mask = block_case(256, 512, (16, 16), seed=3)
    port = BCS.from_dense(_t(w), _t(mask), (16, 16))
    vals, kidx, nnz = BCS.pad_to_uniform_csc(port)
    lay = ops.pack(_t(w), _t(mask), (16, 16), reorder=True, n_bins=4,
                   use_cache=False)
    assert vals.shape[1] == lay.L_max == max(lay.bin_degrees)
    assert lay.executed_blocks < vals.shape[0] * vals.shape[1]
    torch.testing.assert_close(lay.to_dense(), BCS.to_dense(port),
                               rtol=0, atol=0)
    assert torch.equal(nnz, lay.nnz[lay.inv_perm.long()])


# -- kernels 1 and 2: the raw entries -----------------------------------------

def _raw_case(seed, Nb=6, L=5, bk=16, bn=16, Kb=8, int8=False):
    rng = np.random.RandomState(seed)
    kidx = rng.randint(0, Kb, size=(Nb, L)).astype(np.int32)
    if int8:
        vals = rng.randint(-127, 128, size=(Nb, L, bk, bn)).astype(np.int8)
    else:
        vals = rng.randn(Nb, L, bk, bn).astype(np.float32)
    vals[:, -1] = 0                          # a padding slot a column
    kidx[:, -1] = 0
    return vals, kidx, rng


@pytest.mark.parametrize("act", ["none", "silu", "relu"])
@pytest.mark.parametrize("M_", [1, 5, 17])
def test_raw_bsr_matmul_matches_reference(act, M_):
    vals, kidx, rng = _raw_case(M_)
    x = rng.randn(M_, 8 * 16).astype(np.float32)
    b = rng.randn(6 * 16).astype(np.float32)
    want = np.asarray(ref_K.bsr_matmul(jnp.asarray(x), jnp.asarray(vals),
                                       jnp.asarray(kidx), jnp.asarray(b),
                                       act=act))
    got = K.bsr_matmul(_t(x), _t(vals), _t(kidx), _t(b), act=act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("gran", ["block", "out"])
def test_raw_bsr_matmul_int8_matches_reference(gran):
    vals, kidx, rng = _raw_case(7, int8=True)
    scales = (rng.rand(6, 5) if gran == "block" else rng.rand(6)).astype(
        np.float32) * 0.02
    x = rng.randn(9, 8 * 16).astype(np.float32)
    want = np.asarray(ref_K.bsr_matmul(jnp.asarray(x), jnp.asarray(vals),
                                       jnp.asarray(kidx),
                                       scales=jnp.asarray(scales),
                                       act="silu"))
    got = K.bsr_matmul(_t(x), _t(vals), _t(kidx), scales=_t(scales),
                       act="silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_raw_bsr_matmul_out_dtype_keeps_fp32_sums():
    """A bf16 x with out_dtype=float32 stores the fp32 epilogue, as the
    reference's does; casting the bf16 output up is another function."""
    vals, kidx, rng = _raw_case(3)
    x = jnp.asarray(rng.randn(4, 8 * 16), jnp.bfloat16)
    v = jnp.asarray(vals, jnp.bfloat16)
    want = np.asarray(ref_K.bsr_matmul(x, v, jnp.asarray(kidx),
                                       out_dtype=jnp.float32))
    xt = _t(np.asarray(x, np.float32)).bfloat16()
    vt = _t(np.asarray(v, np.float32)).bfloat16()
    got = K.bsr_matmul(xt, vt, _t(kidx), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)
    assert not torch.equal(got, K.bsr_matmul(xt, vt, _t(kidx)).float())


def test_bsr_matmul_packed_out_dtype():
    w, mask = block_case(64, 96, (16, 16), seed=4)
    lay = ops.pack(_t(w).bfloat16(), _t(mask), (16, 16), reorder=True,
                   n_bins=2, use_cache=False)
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    got = K.bsr_matmul_packed(x.bfloat16(), lay, out_dtype=torch.float32)
    dense = (_t(w) * _t(mask)).bfloat16().float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.bfloat16().float() @ dense,
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("scale", [None, "block", "out"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_raw_tap_gather_conv_matches_reference(scale, act):
    rng = np.random.RandomState(11)
    G, L, gp, R, M_ = 5, 7, 2, 20, 13
    tidx = rng.randint(0, R, size=(G, L)).astype(np.int32)
    if scale is None:
        vals = rng.randn(G, L, gp).astype(np.float32)
        sc = None
    else:
        vals = rng.randint(-127, 128, size=(G, L, gp)).astype(np.int8)
        sc = (rng.rand(G, L) if scale == "block"
              else rng.rand(G, 1, gp)).astype(np.float32) * 0.02
    x = rng.randn(M_, R).astype(np.float32)
    b = rng.randn(G * gp).astype(np.float32)
    want = np.asarray(ref_K.tap_gather_conv(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(tidx), jnp.asarray(b),
        None if sc is None else jnp.asarray(sc), act=act))
    got = K.tap_gather_conv(_t(x), _t(vals), _t(tidx), _t(b),
                            None if sc is None else _t(sc), act=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_raw_entries_refuse_bad_shapes():
    vals, kidx, _ = _raw_case(0)
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError):
        K.bsr_matmul(x, _t(vals), _t(kidx[:, :3]))
    with pytest.raises(ValueError):
        K.bsr_matmul(torch.zeros(2, 120), _t(vals), _t(kidx))
    with pytest.raises(ValueError):
        K.bsr_matmul(x, _t(vals), _t(kidx), scales=torch.zeros(6, 4))
    with pytest.raises(ValueError):
        K.tap_gather_conv(x, torch.zeros(3, 4, 2), torch.zeros(
            3, 5, dtype=torch.int32))


# -- kernels.ops: the pack cache ----------------------------------------------

@pytest.fixture
def cache():
    """A cleared cache at the default bounds; the bounds restored after."""
    old = ops.configure_pack_cache()
    ops.clear_pack_cache()
    yield ops
    ops.configure_pack_cache(max_entries=old["max_entries"],
                             max_bytes=old["max_bytes"])
    ops.clear_pack_cache()


def _wm(K_=128, N_=128, seed=6, block=(32, 32)):
    w, mask = block_case(K_, N_, block, seed=seed)
    return _t(w), _t(mask)


def test_pack_cache_hits_and_misses(cache):
    w, mask = _wm()
    s0 = ops.pack_cache_stats()
    p1 = ops.pack(w, mask, (32, 32))
    p2 = ops.pack(w, mask, (32, 32))
    assert p2 is p1                          # the same frozen layout
    s1 = ops.pack_cache_stats()
    assert (s1["hits"] - s0["hits"], s1["misses"] - s0["misses"]) == (1, 1)
    assert s1["entries"] == 1 and s1["bytes"] == M.tree_bytes(p1)
    p3 = ops.pack(w, mask, (32, 32), use_cache=False)
    assert p3 is not p1 and torch.equal(p3.values[0], p1.values[0])
    assert ops.pack_cache_stats()["hits"] == s1["hits"]
    # equal bytes in a fresh tensor hit; one changed bit misses
    assert ops.pack(w.clone(), mask.clone(), (32, 32)) is p1
    w2 = w.clone()
    w2.view(torch.int32)[5, 7] ^= 1
    assert ops.pack(w2, mask, (32, 32)) is not p1
    m2 = mask.clone()
    m2[0, 0] = 1 - m2[0, 0]
    assert ops.pack(w, m2, (32, 32)) is not p1


def test_pack_cache_keys_apart(cache):
    """Every knob that changes the layout is in the key, and so are the
    device and the mask's dtype."""
    w, mask = _wm(seed=7)
    plain = ops.pack(w, mask, (32, 32))
    variants = [ops.pack(w, mask, (32, 32), reorder=True, n_bins=2),
                ops.pack(w, mask, (32, 32), reorder=True, n_bins=4),
                ops.pack(w, mask, (16, 16)),
                ops.pack(w, mask, (32, 32), n_shards=2),
                ops.pack(w, mask, (32, 32), value_dtype="int8"),
                ops.pack(w, mask, (32, 32), value_dtype="int8",
                         scale_granularity="out"),
                ops.pack(w, mask, (32, 32), conv=(1, 1, 128)),
                ops.pack(w, mask.bool(), (32, 32)),
                ops.pack(w.bfloat16(), mask, (32, 32))]
    objs = [plain] + variants
    assert len({id(o) for o in objs}) == len(objs)
    assert ops.pack_cache_stats()["entries"] == len(objs)
    assert variants[3].n_shards == 2 and variants[0].n_bins == 2
    # each variant hits itself
    assert ops.pack(w, mask, (32, 32), reorder=True, n_bins=2) is variants[0]
    assert ops.pack(w, mask, (32, 32), n_shards=2) is variants[3]
    key = ops._digest(w, mask, (32, 32), False, 4)
    assert "'cpu'" in key and key == ops._digest(w.clone(), mask, (32, 32),
                                                  False, 4)
    assert key != ops._digest(w, mask, (32, 32), True, 4)


def test_pack_cache_float_and_int8_do_not_collide(cache):
    """A quantized pack caches its float layout first, then itself under
    its own key (the reference's order; ``tests/test_quant.py:160``)."""
    w, mask = _wm(seed=10, block=(16, 16))
    s0 = ops.pack_cache_stats()
    q8 = ops.pack(w, mask, (16, 16), reorder=True, value_dtype="int8")
    assert ops.pack_cache_stats()["misses"] - s0["misses"] == 2
    fp = ops.pack(w, mask, (16, 16), reorder=True)       # the float hit
    assert ops.pack_cache_stats()["hits"] - s0["hits"] == 1
    assert q8 is not fp and q8.scales is not None and fp.scales is None
    assert ops.pack(w, mask, (16, 16), reorder=True,
                    value_dtype="int8") is q8


def test_pack_taps_cache(cache):
    rng = np.random.RandomState(8)
    w = _t(rng.randn(16, 12, 3, 3).astype(np.float32))
    mask = _t((rng.rand(16, 12, 3, 3) < 0.5).astype(np.float32))
    t1 = ops.pack_taps(w, mask)
    assert ops.pack_taps(w, mask) is t1
    assert ops.pack_taps(w, mask, n_bins=4) is not t1
    q = ops.pack_taps(w, mask, value_dtype="int8", scale_granularity="out")
    assert q is not t1 and q.scales is not None
    # a block pack of the same bytes is another kind
    lay = ops.pack(w.reshape(16, -1), mask.reshape(16, -1), (4, 4))
    assert lay is not t1 and ops.pack_cache_stats()["entries"] == 4


def test_pack_cache_bounds_and_eviction_log(cache, caplog):
    """Entries and bytes bounded LRU, one log line an eviction (the
    reference's ``tests/test_artifacts.py:274``)."""
    ops.configure_pack_cache(max_entries=2)
    e0 = ops.pack_cache_stats()["evictions"]
    with caplog.at_level(logging.INFO, "repro_torch.kernels.ops"):
        lays = [ops.pack(*_wm(32, 32, seed=s, block=(16, 16)), (16, 16))
                for s in range(3)]
    stats = ops.pack_cache_stats()
    assert stats["entries"] == 2 and stats["evictions"] - e0 == 1
    assert caplog.text.count("pack cache evict") == 1
    # the oldest went, LRU: a hit on it misses now, the others hit
    w1, m1 = _wm(32, 32, seed=1, block=(16, 16))
    assert ops.pack(w1, m1, (16, 16)) is lays[1]
    ops.configure_pack_cache(max_entries=256,
                             max_bytes=M.tree_bytes(lays[2]) + 1)
    st_ = ops.pack_cache_stats()
    assert st_["entries"] == 1 and st_["bytes"] == M.tree_bytes(lays[1])
    assert st_["evictions"] - e0 == 2
    # an entry above the byte bound alone still stays (the newest)
    ops.configure_pack_cache(max_bytes=1)
    assert ops.pack_cache_stats()["entries"] == 1


def test_pack_cache_environment_bounds():
    """REPRO_PACK_CACHE_MAX{,_BYTES} set the bounds at import."""
    env = dict(os.environ, REPRO_PACK_CACHE_MAX="7",
               REPRO_PACK_CACHE_MAX_BYTES="12345",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import ops; "
         "c = ops.configure_pack_cache(); "
         "print(c['max_entries'], c['max_bytes'])"],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.split() == ["7", "12345"]


def test_pack_cache_survives_fault_injection(cache):
    """An injected fault corrupts a copy: the cached layout stays valid
    and the next hit returns it."""
    w, mask = _wm(seed=12, block=(16, 16))
    lay = ops.pack(w, mask, (16, 16), reorder=True)
    bad, _ = FAULTS.bitflip_packed_leaf({"blk": {"packed": lay}}, seed=0)
    with pytest.raises(V.LayoutError):
        V.validate_layout(bad["blk"]["packed"])
    hit = ops.pack(w, mask, (16, 16), reorder=True)
    assert hit is lay and V.validate_layout(hit) is hit


def test_compile_twice_hits_every_pack(cache):
    """A second compile of the same weights packs nothing (the
    reference's "a second compile of the same weights is free")."""
    rcfg, pcfg, rparams = ref_smoke_params()
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    pm, masks = to_port(ref_apply_masks(rparams, rmasks)), to_port(rmasks)
    s0 = ops.pack_cache_stats()
    first, _ = C.compile_model(pm, masks, SPARSE_SPEC, device="cpu")
    s1 = ops.pack_cache_stats()
    second, _ = C.compile_model(pm, masks, SPARSE_SPEC, device="cpu")
    s2 = ops.pack_cache_stats()
    n = s1["misses"] - s0["misses"]
    assert n == pcfg.n_layers * 7 and s1["hits"] == s0["hits"]
    assert (s2["hits"] - s1["hits"], s2["misses"] - s1["misses"]) == (n, 0)
    a, b = M.tree_leaves(first), M.tree_leaves(second)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# -- serve.compile: the historical keywords -----------------------------------

def _small():
    rcfg, pcfg, rparams = ref_smoke_params()
    rmasks = ref_RW.magnitude_block_masks(rparams, REF_SPEC, None, rate=0.6)
    rpm = ref_apply_masks(rparams, rmasks)
    return rpm, rmasks, to_port(rpm), to_port(rmasks)


def test_resolve_spec_warnings_and_errors():
    spec = C.CompileSpec(reorder=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert C.resolve_spec(spec) is spec
        assert C.resolve_spec() == C.CompileSpec()
        assert C.resolve_spec(None, reorder=None) == C.CompileSpec()
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert C.resolve_spec(reorder=False, n_bins=2) == C.CompileSpec(
            reorder=False, n_bins=2)
    with pytest.raises(TypeError, match="unknown"):
        C.resolve_spec(tp_degree=2)
    with pytest.raises(TypeError, match="not both"):
        C.resolve_spec(spec, reorder=True)
    with pytest.raises(TypeError, match="CompileSpec"):
        C.resolve_spec({"reorder": False})
    # the reference resolves the same keywords to the same fields
    with pytest.warns(DeprecationWarning):
        ref = ref_C.resolve_spec(keep_dense=False, n_bins=3,
                                 value_dtype="int8")
    with pytest.warns(DeprecationWarning):
        port = C.resolve_spec(keep_dense=False, n_bins=3, value_dtype="int8")
    assert port.digest_fields() == ref.digest_fields()
    assert port.keep_dense is ref.keep_dense is False


def test_compile_model_legacy_keywords():
    rpm, rmasks, pm, masks = _small()
    with pytest.warns(DeprecationWarning):
        old, old_rep = C.compile_model(pm, masks, SPARSE_SPEC, device="cpu",
                                       reorder=False, keep_dense=False)
    new, new_rep = C.compile_model(
        pm, masks, SPARSE_SPEC, device="cpu",
        spec=C.CompileSpec(reorder=False, keep_dense=False))
    assert old_rep.spec == new_rep.spec
    assert [r.to_json() for r in old_rep] == [r.to_json() for r in new_rep]
    assert M.count_params(old) == M.count_params(new)
    for a, b in zip(M.tree_leaves(old), M.tree_leaves(new)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError):
        C.compile_model(pm, masks, SPARSE_SPEC, device="cpu",
                        spec=C.CompileSpec(), reorder=False)


def test_model_digest_both_spellings_equal():
    rpm, rmasks, pm, masks = _small()
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # the digest never warns
        legacy = ART.model_digest(pm, masks, SPARSE_SPEC, reorder=False,
                                  n_bins=2)
    spec = ART.model_digest(pm, masks, SPARSE_SPEC,
                            spec=C.CompileSpec(reorder=False, n_bins=2))
    assert legacy == spec
    assert legacy == ref_ART.model_digest(rpm, rmasks, REF_SPEC,
                                          reorder=False, n_bins=2)
    assert legacy != ART.model_digest(pm, masks, SPARSE_SPEC)


# -- serve.engine: the sampling oracle ----------------------------------------

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("packed", [False, True])
def test_generate_python_samples_as_generate(packed):
    cfg = configs.get("yi-9b", smoke=True)
    params = T.init_lm(cfg, seed=0, dtype=torch.float32, device="cpu")
    if packed:
        masks = RW.magnitude_block_masks(params, SPARSE_SPEC, None, rate=0.6)
        params, report = C.compile_model(apply_masks(params, masks), masks,
                                         SPARSE_SPEC, device="cpu")
        assert report.packed
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, size=(3, 7))
    for temperature in ((0.7,) if packed else (0.7, 3.0)):
        g1, g2 = _gen(4), _gen(4)
        want = engine.generate(params, cfg, tokens, 6, device="cpu",
                               temperature=temperature, generator=g1)
        got = engine.generate_python(params, cfg, tokens, 6, device="cpu",
                                     temperature=temperature, generator=g2)
        assert torch.equal(got, want)
        assert torch.equal(g1.get_state(), g2.get_state())   # draw for draw
    if packed:
        return
    # no generator: both seed theirs with 0
    assert torch.equal(
        engine.generate_python(params, cfg, tokens, 6, device="cpu",
                               temperature=0.7),
        engine.generate(params, cfg, tokens, 6, device="cpu",
                        temperature=0.7))


# -- models.module: the tree helpers ------------------------------------------

def _ref_exec():
    rpm, rmasks, pm, masks = _small()
    rexec, _ = ref_C.compile_model(rpm, rmasks, REF_SPEC)
    pexec, _ = C.compile_model(pm, masks, SPARSE_SPEC, device="cpu")
    return (rpm, pm), (rexec, pexec)


def _assert_leaves_equal(port_tree, ref_tree):
    pl, rl = M.tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        r = np.asarray(r.astype(jnp.float32) if r.dtype == jnp.bfloat16
                       else r)
        assert tuple(p.shape) == r.shape
        np.testing.assert_array_equal(p.float().numpy() if p.dtype ==
                                      torch.bfloat16 else p.numpy(), r)


def test_module_helpers_match_reference():
    for ref_tree, port_tree in _ref_exec():
        assert M.count_params(port_tree) == ref_module.count_params(ref_tree)
        assert M.tree_bytes(port_tree) == ref_module.tree_bytes(ref_tree)
        _assert_leaves_equal(port_tree, ref_tree)
        rc = ref_module.cast_tree(ref_tree, jnp.bfloat16)
        pc = M.cast_tree(port_tree, torch.bfloat16)
        assert M.tree_bytes(pc) == ref_module.tree_bytes(rc)
        _assert_leaves_equal(pc, rc)
        assert all(t.dtype in (torch.bfloat16, torch.int32)
                   for t in M.tree_leaves(pc))


def test_init_helpers_match_reference():
    for port_fn, ref_fn in ((M.zeros_init, ref_module.zeros_init),
                            (M.ones_init, ref_module.ones_init)):
        for dtype, rdt in ((torch.bfloat16, jnp.bfloat16),
                           (torch.float32, jnp.float32)):
            p = port_fn((3, 5), None, dtype)
            r = ref_fn(jax.random.PRNGKey(0), (3, 5), rdt)
            assert p.dtype == dtype and tuple(p.shape) == r.shape
            np.testing.assert_array_equal(p.float().numpy(),
                                          np.asarray(r, np.float32))


def test_tree_leaves_of_layouts_in_reference_order():
    w, mask = _wm(seed=2, block=(16, 16))
    lay = ops.pack(w, mask, (16, 16), reorder=True, n_bins=2,
                   value_dtype="int8", use_cache=False)
    leaves = M.tree_leaves({"b": {"packed": lay}, "a": torch.zeros(2)})
    want = ([torch.zeros(2)] + list(lay.values) + list(lay.k_idx)
            + [lay.nnz, lay.perm, lay.inv_perm] + list(lay.scales))
    assert len(leaves) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(leaves, want))
    cast = M.cast_tree({"packed": lay}, torch.float16)["packed"]
    assert type(cast) is type(lay) and cast is not lay
    assert cast.values[0].dtype == torch.int8
    assert cast.scales[0].dtype == torch.float16
    assert cast.block == lay.block and cast.shape == lay.shape


# -- the surface check --------------------------------------------------------

# (reference module, name) -> why the port has no namesake
NO_COUNTERPART = {
    ("models/module.py", "split_keys"):
        "JAX's key splitting; the port draws from one torch.Generator",
    ("models/transformer.py", "maybe_scan"):
        "lax.scan or its unrolled probe; the port loops over layers",
    ("models/transformer.py", "_scan_stack"):
        "the scan body of maybe_scan",
    ("models/transformer.py", "_layer_init"):
        "per-layer init from split keys; init_lm inlines it",
    ("serve/engine.py", "_cached_jit"):
        "jax.jit caching; the port runs eagerly or in a CUDA graph",
    ("serve/engine.py", "_jit_prefill"): "a jax.jit wrapper",
    ("serve/engine.py", "_jit_decode_step"): "a jax.jit wrapper",
    ("serve/engine.py", "_jit_decode_loop"): "a jax.jit wrapper",
    ("serve/engine.py", "_jit_serving_step"): "a jax.jit wrapper",
    ("kernels/bsr_matmul.py", "_auto_interpret"):
        "Pallas interpret-mode detection; CUDA kernels have no such mode",
    ("kernels/bsr_matmul.py", "_m_tile"):
        "the TPU's M tile; bsr_plan picks the card's",
    ("kernels/bsr_matmul.py", "_tap_kernel"):
        "a Pallas body; csrc/tap_gather.cu's tap_conv_kernel",
    ("kernels/bsr_matmul.py", "_conv_kernel"):
        "a Pallas body; csrc/bsr_matmul.cu's bsr_conv_kernel",
    ("kernels/bsr_matmul.py", "_tap_conv_kernel"):
        "a Pallas body; csrc/tap_gather.cu's tap_conv_kernel",
    ("kernels/bsr_matmul.py", "_conv_implicit_bin"):
        "one Pallas launch a bin; kernel 3 runs every bin in one launch",
    ("kernels/bsr_matmul.py", "_tap_implicit_bin"):
        "one Pallas launch a bin; kernel 4 runs every bin in one launch",
    ("kernels/bsr_matmul.py", "_out_positions"):
        "in-kernel position decode of a Pallas body",
    ("launch/dryrun.py", "collective_bytes"):
        "parses XLA's partitioned HLO; the port's CostCounter counts the "
        "collectives it dispatches",
    ("launch/dryrun.py", "_shape_bytes"): "a helper of the HLO parser",
    ("launch/dryrun.py", "_compile_costs"):
        "XLA's compiled cost analysis; the port counts under FakeTensorMode",
    ("core/bcs.py", "_csc_move"):
        "a jitted XLA gather; pack_csc indexes on the weight's device",
    ("distributed/checkpoint.py", "_flatten"):
        "jax.tree_util flattening; the port walks its dicts inline",
    ("optim/adamw.py", "_map3"): "jax.tree_util mapping over three trees",
    ("serve/artifacts.py", "_copy_dicts"):
        "inlined in the port's graft",
    ("serve/compile.py", "_stack_pad_L"):
        "inlined in _pack_stacked (F.pad of each slice)",
    ("serve/kvcache.py", "_scatter_kv"):
        "JAX's functional .at[].set; the port writes slots in place",
    ("serve/kvcache.py", "_scatter_state"): "the same, for SSM state",
    ("serve/kvcache.py", "_invalidate_kv"): "the same, for positions",
    ("kernels/ops.py", "_entry_bytes"):
        "the port's cache sums models.module.tree_bytes",
}


def _defs(path):
    """Top-level def and class names of a module."""
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _names(path):
    """Every name a module binds at top level (defs, classes, assignments,
    imports)."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def test_every_reference_name_has_a_port_counterpart():
    ref_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing, listed = [], set()
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        port = port_root / rel
        assert port.exists(), f"no port module for {rel}"
        for name in sorted(_defs(path) - _names(port)):
            if (rel, name) in NO_COUNTERPART:
                listed.add((rel, name))
            else:
                missing.append(f"{rel}:{name}")
    assert not missing, f"reference names without a port counterpart: " \
                        f"{missing}"
    # the list holds no stale entry
    assert listed == set(NO_COUNTERPART), sorted(set(NO_COUNTERPART)
                                                 - listed)
